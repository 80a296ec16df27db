"""Device placement of the pipeline (one device; the multi-device layer is a
later slice) and the determinism checks."""

from .mesh import get_mesh, shard_array_named, use_mesh  # noqa: F401
from .validate import (  # noqa: F401
    DeterminismError,
    assert_deterministic,
    assert_sharding_invariant,
    check_pipeline_determinism,
    compare_products,
    fingerprint,
)
