"""Telescope models, beam transfer matrices and the fused simulate -> map round trip."""

from .beamtransfer import BeamTransfer  # noqa: F401
from .core import (  # noqa: F401
    PolarisedCylinderTelescope,
    PolarisedDishArray,
    SimplePolarisedTelescope,
    SimpleUnpolarisedTelescope,
    TransitTelescope,
    UnpolarisedCylinderTelescope,
    UnpolarisedDishArray,
)
