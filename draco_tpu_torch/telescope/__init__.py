"""Telescope models, beam products and the fused simulate -> map round trip."""

from .beamtransfer import BeamTransfer  # noqa: F401
from .core import (  # noqa: F401
    SimplePolarisedTelescope,
    SimpleUnpolarisedTelescope,
    TransitTelescope,
    UnpolarisedDishArray,
)
