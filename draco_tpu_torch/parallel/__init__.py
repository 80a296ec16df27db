"""Parallelism layer: process mesh, named-axis placement, multi-process launch.

Port of ``draco_tpu.parallel``.  The reference stack's MPI backbone
(``caput.mpiarray.MPIArray`` and mpi4py collectives; SURVEY.md section
2.5) becomes a ``torch.distributed`` device mesh with one process per
card: a container dataset's ``distributed_axis`` maps onto a mesh
dimension, and ``redistribute`` gathers and re-splits over the mesh.
"""

from .mesh import (  # noqa: F401
    SHARD_AXIS,
    get_mesh,
    make_hybrid_mesh,
    make_mesh,
    make_mesh2d,
    set_mesh,
    sharding_for_axis,
    sharding_for_named_axes,
    shard_array,
    shard_array_named,
    unshard,
    use_mesh,
)
from . import multihost  # noqa: F401,E402
from .validate import (  # noqa: F401,E402
    DeterminismError,
    assert_deterministic,
    assert_sharding_invariant,
    check_pipeline_determinism,
    compare_products,
    fingerprint,
)
from .dryrun import dryrun_multichip  # noqa: F401,E402
