"""Process mesh and named-axis placement on ``torch.distributed``.

Port of ``draco_tpu.parallel.mesh``.  The JAX package shards every
container dataset over a ``jax.sharding.Mesh``: a dataset distributed
along axis ``i`` is a global array whose ``NamedSharding`` splits dim
``i`` over a mesh axis, and ``redistribute`` is a resharding
``device_put``.  Here:

* a mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
  ranks of the process group, one rank per card, with ``mesh_dim_names``
  in place of the JAX mesh's axis names;
* a ``NamedSharding`` is a list of DTensor placements, one per mesh
  dimension: ``Shard(i)`` where the dataset's axis ``i`` bears the mesh
  dimension's name (or is the dataset's primary axis on the 1-D
  ``"shard"`` mesh), ``Replicate()`` otherwise.  An axis whose length the
  mesh dimension does not divide stays replicated, as in the JAX package:
  DTensor would shard it unevenly;
* a placed array is a :class:`~torch.distributed.tensor.DTensor` made with
  ``DTensor.from_local`` from this rank's block.  Placing a tensor that
  every rank holds in full slices it locally (no communication: every rank
  passes the same value, as every JAX process passes the same host value
  to ``device_put``); gathering and re-placing go through this module's
  own ``all_gather_into_tensor`` calls on each mesh dimension's group.
  DTensor's collectives are not used: on the card, DTensor's gather
  crashed the process under ``gloo`` (torch 2.11), which is the backend
  of two ranks that share one card, while the plain collectives work on
  ``gloo`` and ``nccl`` alike.

If no mesh has been installed (one process, unit tests), everything is a
no-op and tensors are ordinary tensors.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Sequence

import numpy as np
import torch

from ..device import resolve

__all__ = [
    "SHARD_AXIS",
    "make_mesh",
    "make_mesh2d",
    "make_hybrid_mesh",
    "set_mesh",
    "get_mesh",
    "use_mesh",
    "sharding_for_axis",
    "sharding_for_named_axes",
    "shard_array",
    "shard_array_named",
    "unshard",
    "is_placed",
    "place",
    "from_block",
    "local",
    "sum_over_shards",
    "freq_dim",
    "hybrid_grid",
    "most_square",
]

# Name of the default mesh axis that container distributed axes map onto.
SHARD_AXIS = "shard"

# Process-global (a plain module attribute, not thread-local): container
# transfers and task work may run on worker threads, which must see the
# mesh the main thread installed.
_mesh = None


def _dist():
    import torch.distributed as dist

    return dist


def _world_ranks() -> np.ndarray:
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs the process group: call draco_tpu_torch.parallel.multihost.initialize() first"
        )
    return np.arange(dist.get_world_size())


def _device_mesh(grid: np.ndarray, names: Sequence[str]):
    """A DeviceMesh over the rank grid ``grid`` on the process's default device type."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(resolve(None).type, torch.as_tensor(np.asarray(grid)), mesh_dim_names=tuple(names))


def most_square(n: int) -> tuple[int, int]:
    """The most-square factorisation (a, b) of ``n`` with a <= b; (1, n) for primes."""
    first = 1
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            first = d
            break
    return first, n // first


def make_mesh(ranks=None, axis_name: str = SHARD_AXIS):
    """A 1-D mesh over ``ranks`` (default: every rank of the process group)."""
    ranks = _world_ranks() if ranks is None else np.asarray(ranks)
    return _device_mesh(ranks, (axis_name,))


def make_mesh2d(shape: tuple[int, int] | None = None, axis_names: tuple[str, str] = ("freq", "m"), ranks=None):
    """A 2-D mesh whose dimensions are *named after container axes*.

    The production (freq x m) layout: under a mesh with dimensions
    ``("freq", "m")`` every container dataset axis called ``freq`` or ``m``
    is split over the matching mesh dimension, so the SHT stage runs
    frequency-parallel and the per-m stage m-parallel, with the gathers of
    this module between them (the reference's MPI parallel transposes,
    reference draco/synthesis/stream.py:96,119).  ``shape=None`` picks the
    most-square factorisation of the rank count (1-D for primes).
    """
    ranks = _world_ranks() if ranks is None else np.asarray(ranks)
    n = len(ranks)
    shape = most_square(n) if shape is None else tuple(shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not cover the {n} ranks provided")
    return _device_mesh(ranks.reshape(shape), axis_names)


def hybrid_grid(ici_shape: Sequence[int], dcn_shape: Sequence[int], ranks) -> np.ndarray:
    """The rank grid of :func:`make_hybrid_mesh`: each axis's extent is
    ``dcn_shape[i] * ici_shape[i]`` with the dcn factor outermost, so each
    inner (ici) block is a contiguous range of ranks."""
    ranks = np.asarray(ranks)
    if len(ici_shape) != len(dcn_shape):
        raise ValueError(f"ici_shape and dcn_shape must have equal length; got {ici_shape}, {dcn_shape}")
    total = int(np.prod(ici_shape)) * int(np.prod(dcn_shape))
    if total != len(ranks):
        raise ValueError(f"mesh of {total} positions does not cover the {len(ranks)} ranks provided")
    n = len(ici_shape)
    grid = ranks.reshape(*dcn_shape, *ici_shape)
    # interleave (dcn_i, ici_i) for every axis, then merge each pair
    order = [ax for i in range(n) for ax in (i, n + i)]
    return grid.transpose(order).reshape(tuple(d * i for d, i in zip(dcn_shape, ici_shape)))


def make_hybrid_mesh(
    ici_shape: tuple[int, ...],
    dcn_shape: tuple[int, ...],
    axis_names: tuple[str, ...] = ("freq", "m"),
    ranks=None,
):
    """A mesh spanning nodes: the dcn factor outermost, ranks across nodes.

    The JAX package puts the dcn factor across TPU slices and the ici block
    inside one slice.  Here one process drives one card and a launcher
    numbers a node's processes contiguously (``queue``'s script: rank =
    node x ppn + local rank), so the inner block is the cards of one node,
    joined by NVLink, and the outer factor runs across nodes.  Put ``freq``
    on the outer factor: frequencies are independent through the spine, so
    the only traffic across nodes is the first placement and the last
    gather, while the freq <-> m transposes stay inside a node.
    """
    if len(ici_shape) != len(axis_names):
        raise ValueError(
            f"ici_shape, dcn_shape and axis_names must have equal length; got {ici_shape}, {dcn_shape}, {axis_names}"
        )
    ranks = _world_ranks() if ranks is None else np.asarray(ranks)
    return _device_mesh(hybrid_grid(ici_shape, dcn_shape, ranks), axis_names)


def set_mesh(mesh) -> None:
    """Install ``mesh`` as the process-global mesh (None to clear)."""
    global _mesh
    _mesh = mesh


def get_mesh():
    """The installed mesh, or None when running unsharded."""
    return _mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` for the body of a ``with`` block."""
    old = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(old)


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _mesh_axis(mesh) -> str:
    """The mesh dimension that container sharding uses (the first by default)."""
    names = _names(mesh)
    return SHARD_AXIS if SHARD_AXIS in names else names[0]


def _is_named_mesh(mesh) -> bool:
    """True for meshes whose dimensions name container axes."""
    names = _names(mesh)
    return len(names) > 1 or names[0] != SHARD_AXIS


def _size(mesh, name: str) -> int:
    return mesh.size(_names(mesh).index(name))


def _placements(mesh, shard: dict[int, int]) -> list:
    """Placements of ``mesh``: ``Shard(shard[k])`` on mesh dimension k, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(shard[k]) if k in shard else Replicate() for k in range(mesh.ndim)]


def sharding_for_axis(ndim: int, axis: int | None, mesh=None) -> list | None:
    """Placements splitting tensor dim ``axis`` over the mesh's shard
    dimension (``axis=None``: replicated); None when no mesh is active."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    shard = {} if axis is None else {_names(mesh).index(_mesh_axis(mesh)): axis % max(ndim, 1)}
    return _placements(mesh, shard)


def sharding_for_named_axes(axis_names, shape, primary: str | None, mesh=None) -> list | None:
    """Placements of a dataset with labelled axes.

    * 1-D default mesh (dimension ``"shard"``): the dataset's ``primary``
      axis (its ``distributed_axis``) is split over it, the reference's
      one-distributed-axis MPIArray layout;
    * named mesh (e.g. ``("freq", "m")`` from :func:`make_mesh2d`): every
      dataset axis whose *name* matches a mesh dimension is split over that
      dimension, whichever axis is nominally distributed.

    Axes that their mesh dimension does not divide stay replicated.  None
    when no mesh is installed.
    """
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    axis_names, shape = tuple(axis_names), tuple(shape)
    names = _names(mesh)
    shard = {}
    if _is_named_mesh(mesh):
        for k, name in enumerate(names):
            if name in axis_names:
                i = axis_names.index(name)
                if shape[i] % mesh.size(k) == 0:
                    shard[k] = i
    elif primary is not None and primary in axis_names:
        i = axis_names.index(primary)
        k = names.index(_mesh_axis(mesh))
        if shape[i] % mesh.size(k) == 0:
            shard[k] = i
    return _placements(mesh, shard)


def is_placed(x) -> bool:
    """True for a tensor placed over a mesh (a DTensor).

    No DTensor exists before ``torch.distributed.tensor`` is imported, and
    importing it takes seconds: a run with no mesh never pays for it here.
    """
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(x, dtensor.DTensor)


def local(x):
    """This rank's block of a placed tensor; anything else as it is."""
    return x.to_local() if is_placed(x) else x


def _shard_dim(p) -> int | None:
    return p.dim if p.is_shard() else None


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Concatenate every group member's ``x`` along ``dim``, in group-rank order."""
    dist = _dist()
    x = x.movedim(dim, 0).contiguous()
    src = torch.view_as_real(x) if x.is_complex() else x
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    # all_gather_single is all_gather_into_tensor's newer name (torch 2.13)
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(out, src, group=group)
    if x.is_complex():
        out = torch.view_as_complex(out)
    return out.movedim(0, dim).contiguous()


def _relayout(x: torch.Tensor, mesh, cur: list, tgt: list) -> torch.Tensor:
    """This rank's block under placements ``tgt`` from its block ``x`` under ``cur``.

    Mesh dimensions whose placement changes are first gathered (inner
    dimensions first, each over its own group), then split locally (outer
    dimensions first): the block DTensor's chunking gives.
    """
    changed = [cur[k] != tgt[k] for k in range(mesh.ndim)]
    for k in reversed(range(mesh.ndim)):
        d = _shard_dim(cur[k])
        if changed[k] and d is not None and mesh.size(k) > 1:
            x = _all_gather(x, d, mesh.get_group(k), mesh.size(k))
    sliced = False
    for k in range(mesh.ndim):
        d = _shard_dim(tgt[k])
        if changed[k] and d is not None:
            x = x.chunk(mesh.size(k), dim=d)[mesh.get_local_rank(k)]
            sliced = True
    # a block sliced from a larger tensor must not keep the whole alive
    return x.clone(memory_format=torch.contiguous_format) if sliced else x


def from_block(block: torch.Tensor, mesh, placements, shape):
    """The placed tensor of global ``shape`` whose block on this rank is
    ``block`` (no communication)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    return DTensor.from_local(block, mesh, placements, run_check=False, shape=shape, stride=_contiguous_stride(shape))


def place(x, mesh, placements):
    """``x`` (a tensor every rank holds in full, or a placed tensor) under
    ``placements`` of ``mesh``; gathers where a split dimension changes."""
    from torch.distributed.tensor import Replicate

    if is_placed(x):
        if x.device_mesh == mesh and list(x.placements) == list(placements):
            return x
        if x.device_mesh != mesh:
            x = unshard(x)
    if is_placed(x):
        block = _relayout(x.to_local(), mesh, list(x.placements), list(placements))
    else:
        block = _relayout(x, mesh, [Replicate()] * mesh.ndim, list(placements))
    return from_block(block, mesh, placements, x.shape)


def shard_array(arr, axis: int | None):
    """Place ``arr`` with tensor dim ``axis`` split over the mesh's shard
    dimension (replicated where the mesh does not divide it); with no mesh
    a no-op.  The port's ``MPIArray.redistribute``."""
    mesh = get_mesh()
    if mesh is None:
        return arr
    if axis is not None:
        axis = axis % arr.ndim
        if arr.shape[axis] % _size(mesh, _mesh_axis(mesh)) != 0:
            axis = None  # replicate: not evenly divisible
    return place(arr, mesh, sharding_for_axis(arr.ndim, axis, mesh))


def shard_array_named(arr, axis_names, primary: str | None = None):
    """Place ``arr`` by axis *names* (see :func:`sharding_for_named_axes`)."""
    mesh = get_mesh()
    if mesh is None:
        return arr
    return place(arr, mesh, sharding_for_named_axes(tuple(axis_names), tuple(arr.shape), primary, mesh))


def unshard(arr):
    """The whole of a placed tensor, gathered on every rank (a collective:
    every rank of its mesh calls it); anything else as it is."""
    if not is_placed(arr):
        return arr
    from torch.distributed.tensor import Replicate

    mesh = arr.device_mesh
    return _relayout(arr.to_local(), mesh, list(arr.placements), [Replicate()] * mesh.ndim)


def sum_over_shards(t: torch.Tensor, like) -> torch.Tensor:
    """Sum ``t`` (a rank's partial result over its block of ``like``) across
    every mesh dimension that splits ``like``; ``t`` as it is when ``like``
    is not placed.  A collective over those dimensions' groups."""
    if not is_placed(like):
        return t
    dist = _dist()
    mesh = like.device_mesh
    t = t.contiguous()
    for k, p in enumerate(like.placements):
        if p.is_shard() and mesh.size(k) > 1:
            buf = torch.view_as_real(t) if t.is_complex() else t
            dist.all_reduce(buf, group=mesh.get_group(k))
    return t


def freq_dim(mesh) -> int | None:
    """The mesh dimension that splits frequencies: the one named ``freq``, or
    the only dimension of the 1-D shard mesh; None otherwise."""
    if mesh is None:
        return None
    names = _names(mesh)
    if "freq" in names:
        return names.index("freq")
    return 0 if names == (SHARD_AXIS,) else None
