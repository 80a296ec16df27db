"""Single-device stand-in for ``draco_tpu.parallel.mesh``.

The JAX package shards container datasets over a device mesh.  The port
runs on one device, so there is never a mesh: :func:`get_mesh` is None,
:func:`use_mesh` accepts only None, and :func:`shard_array_named` returns
its array.  A pipeline that asks for more than one device is refused by
the Manager; the multi-device layer (``torch.distributed``) is a later
slice of the port.
"""

from __future__ import annotations

import contextlib

__all__ = ["get_mesh", "use_mesh", "shard_array_named", "MULTI_DEVICE_MESSAGE"]

MULTI_DEVICE_MESSAGE = (
    "draco_tpu_torch runs on one device: the multi-device layer "
    "(parallel/mesh.py, multihost.py and validate.py on torch.distributed, "
    "ROADMAP.md queue 1 item 23) is not ported yet"
)


def get_mesh():
    """The installed mesh: always None on one device."""
    return None


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the body under ``mesh``; only None (one device) is accepted."""
    if mesh is not None:
        raise NotImplementedError(MULTI_DEVICE_MESSAGE)
    yield None


def shard_array_named(arr, axes=None, primary=None):
    """Placement of ``arr`` over the mesh: with one device, ``arr`` itself."""
    return arr
