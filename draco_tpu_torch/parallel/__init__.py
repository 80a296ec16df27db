"""Device placement of the pipeline: one device (the multi-device layer is a later slice)."""

from .mesh import get_mesh, shard_array_named, use_mesh  # noqa: F401
