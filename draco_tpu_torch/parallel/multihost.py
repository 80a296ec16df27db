"""Multi-process launch, leader-gated work and sharded container files.

Port of ``draco_tpu.parallel.multihost``.  The reference framework scales
across nodes with mpi4py: every rank runs the same pipeline on its slab of
each distributed array, and HDF5 I/O is collective (SURVEY.md section 2.5).

One process drives one card: PyTorch's model.  The JAX package runs one
process per *host*, which drives every chip of the host
(``draco_tpu/core/pipeline.py:436-442``); here a node with four cards runs
four processes, and each must see only its own card (the ``queue`` script
sets ``CUDA_VISIBLE_DEVICES`` from the launcher's local rank).

* :func:`initialize` joins the process group from the JAX package's
  launcher contract, ``DRACO_TPU_COORDINATOR`` / ``DRACO_TPU_NUM_PROCESSES``
  / ``DRACO_TPU_PROCESS_ID`` (the MPI launcher's rank and size).  The
  backend follows from the launch: ``nccl`` where every rank owns a card of
  its own, ``gloo`` where ranks run on the CPU or share a card (``nccl``
  refuses two ranks on one card).
* :func:`split_local`: this process's (count, offset) slab of an axis.
* :func:`broadcast_from_leader`: a host value loaded by rank 0, shared.
* :func:`save_sharded` / :func:`load_sharded`: one HDF5 part file per
  process, each with only that process's slab of every distributed
  dataset, and their reassembly; any process can read the part set.
"""

from __future__ import annotations

import datetime
import glob
import logging
import os
import re
import socket

import numpy as np

from ..device import resolve

__all__ = [
    "initialize",
    "process_index",
    "process_count",
    "split_local",
    "broadcast_from_leader",
    "is_leader",
    "save_sharded",
    "load_sharded",
]

logger = logging.getLogger(__name__)


def _dist():
    import torch.distributed as dist

    return dist


def _card_identity() -> str:
    """What tells this process's device apart from another process's: the
    host and the card's UUID, or ``cpu``."""
    import torch

    dev = resolve(None)
    if dev.type != "cuda":
        return "cpu"
    return f"{socket.gethostname()}:{torch.cuda.get_device_properties(dev).uuid}"


def _backend(cards: list[str]) -> str:
    """``nccl`` when every rank has a card of its own, ``gloo`` when a rank
    runs on the CPU or shares its card (``nccl`` refuses two ranks on one card)."""
    return "nccl" if "cpu" not in cards and len(set(cards)) == len(cards) else "gloo"


def _store(address: str, world: int, rank: int, timeout: datetime.timedelta):
    """The rendezvous store at ``address``: ``file:///path``, or ``host:port``
    (``tcp://`` optional), served by rank 0."""
    dist = _dist()
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://") :], world)
    host, _, port = address.removeprefix("tcp://").rpartition(":")
    return dist.TCPStore(host or "localhost", int(port), world, rank == 0, timeout=timeout)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout: float = 300.0,
) -> bool:
    """Join the process group; returns True once joined.

    Arguments left out come from ``DRACO_TPU_COORDINATOR``,
    ``DRACO_TPU_NUM_PROCESSES`` and ``DRACO_TPU_PROCESS_ID``.  A no-op
    (False) when no coordinator or process count is configured: the
    pipeline then runs in one process, as before.  A configured launch of
    one process joins a group of one (the path every real launch of one card
    takes).  Each rank publishes its card's identity in the rendezvous
    store, so every rank picks the same backend: ``nccl`` when every rank
    has a card of its own, ``gloo`` otherwise.  A rendezvous or collective
    that does not complete within ``timeout`` seconds raises.
    """
    dist = _dist()
    coordinator_address = coordinator_address or os.environ.get("DRACO_TPU_COORDINATOR")
    if num_processes is None and "DRACO_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DRACO_TPU_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ.get("DRACO_TPU_PROCESS_ID", "0"))
    if not coordinator_address or not num_processes:
        return False
    if dist.is_initialized():
        return True
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside the {num_processes} processes of the launch")

    wait = datetime.timedelta(seconds=timeout)
    store = _store(coordinator_address, num_processes, process_id, wait)
    store.set_timeout(wait)
    ident = _card_identity()
    store.set(f"draco_tpu_torch/card/{process_id}", ident)
    backend = _backend([store.get(f"draco_tpu_torch/card/{r}").decode() for r in range(num_processes)])
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id, timeout=wait)
    logger.info(
        "process %d of %d joined the %s process group (%s)", process_id, num_processes, backend, ident
    )
    return True


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def split_local(n: int, rank: int | None = None, size: int | None = None):
    """(count, offset) of this process's slab of an ``n``-long axis.

    The first ``n % size`` processes carry one extra element: the balanced
    split of the reference's ``mpitools.split_local``.
    """
    if rank is None:
        rank = process_index()
    if size is None:
        size = process_count()
    base, extra = divmod(n, size)
    count = base + (1 if rank < extra else 0)
    offset = rank * base + min(rank, extra)
    return count, offset


def broadcast_from_leader(value):
    """Share a host value loaded by process 0 with every process.

    One process: the value unchanged.  Otherwise the value is pickled and
    broadcast, so any host object works and the other processes may pass
    None (the reference ``comm.bcast`` catalog pattern).
    """
    if process_count() == 1:
        return value
    box = [value if is_leader() else None]
    _dist().broadcast_object_list(box, src=0)
    return box[0]


def is_leader() -> bool:
    """True on process 0 (and in any single-process run).

    Gates side effects such as saving a task's output: in a multi-process
    launch every process runs every task, and an ungated ``save`` would
    have every rank write one HDF5 file at once.
    """
    return process_index() == 0


# ---------------------------------------------------------------------------
# Per-process sharded container files
# ---------------------------------------------------------------------------

def _part_path(path: str, rank: int, size: int) -> str:
    stem, ext = os.path.splitext(path)
    return f"{stem}.part{rank:04d}of{size:04d}{ext or '.h5'}"


def _local_slab(data, ai: int):
    """(slab, offset) of this process's block of a placed tensor along axis
    ``ai``, read from ``DTensor.to_local()``; None unless the mesh splits
    ``ai`` alone, over one mesh dimension whose blocks partition the axis
    across the processes (a dataset replicated over some ranks would
    otherwise write duplicate blocks that the loader concatenates twice)."""
    from ..parallel import mesh as pmesh

    if not pmesh.is_placed(data):
        return None
    mesh = data.device_mesh
    sharded = [(k, p.dim) for k, p in enumerate(data.placements) if p.is_shard()]
    if len(sharded) != 1 or sharded[0][1] != ai or mesh.size(sharded[0][0]) != process_count():
        return None
    k = sharded[0][0]
    block = data.to_local()
    return block, mesh.get_local_rank(k) * block.shape[ai]


def save_sharded(container, path: str, rank: int | None = None, size: int | None = None) -> str:
    """Write this process's slab of ``container`` as an HDF5 part file.

    Every dataset with a ``distributed_axis`` is cut to the process's slab
    along it: the block the mesh placed on this rank where that block is
    the slab (``DTensor.to_local()``, no gather), otherwise the
    :func:`split_local` slab of the whole (a collective gather for a placed
    dataset: every process runs this).  The other datasets, the index maps
    and the attributes are written whole by every part, so each part is
    self-describing.  The part is written by the container's own ``save``,
    in its layout.  Returns the part's path.
    """
    import torch

    from ..core.containers import Dataset
    from ..parallel import mesh as pmesh

    rank = process_index() if rank is None else rank
    size = process_count() if size is None else size
    part = container.__class__.__new__(container.__class__)
    part.__dict__.update(container.__dict__)
    part.attrs = {**container.attrs, "__shard_rank__": rank, "__shard_size__": size}
    part.datasets = {}
    for name, ds in container.datasets.items():
        axis = ds.distributed_axis if ds.distributed else None
        ai = ds.axes.index(axis) if axis in ds.axes else None
        attrs = dict(ds.attrs)
        slab = _local_slab(ds._data, ai) if ai is not None else None
        if slab is not None:
            data, offset = slab
        else:
            data = pmesh.unshard(ds._data)
            if ai is not None:
                count, offset = split_local(data.shape[ai], rank, size)
                sl = [slice(None)] * data.ndim
                sl[ai] = slice(offset, offset + count)
                data = data[tuple(sl)]
        if ai is not None:
            attrs.update(__shard_axis__=axis, __shard_offset__=int(offset))
        if isinstance(data, torch.Tensor):
            data = data.contiguous()
        part.datasets[name] = Dataset(
            name, data, ds.axes, attrs=attrs, distributed=ds.distributed, distributed_axis=ds.distributed_axis,
            spec=ds.spec,
        )
    ppath = _part_path(path, rank, size)
    part.save(ppath)
    return ppath


def load_sharded(path: str, device=None):
    """Reassemble a container from the full set of part files of ``path``.

    Any process may call this.  Stale parts of an earlier launch with
    another process count are ignored: the largest complete set wins.
    Numeric datasets go to ``device`` (:func:`~draco_tpu_torch.device.resolve`).
    """
    import h5py
    import torch

    from ..core.containers import ContainerBase, _as_storage

    stem, ext = os.path.splitext(path)
    parts_all = sorted(glob.glob(f"{glob.escape(stem)}.part*of*{ext or '.h5'}"))
    if not parts_all:
        raise FileNotFoundError(f"no shard parts found for {path!r}")
    by_size: dict = {}
    for p in parts_all:
        m = re.search(r"part(\d+)of(\d+)", p)
        if m:
            by_size.setdefault(int(m.group(2)), []).append(p)
    complete = {n: ps for n, ps in by_size.items() if len(ps) == n}
    if not complete:
        counts = {n: len(ps) for n, ps in by_size.items()}
        raise FileNotFoundError(f"incomplete shard set for {path!r}: present counts {counts}")
    paths = sorted(complete[max(complete)])
    parts = [ContainerBase.from_file(p, device=device) for p in paths]
    # the reader drops "__" attributes: the slabs' axes and offsets are read here
    shards = []
    for p in paths:
        with h5py.File(p, "r") as f:
            shards.append({
                name: (_text(d.attrs["__shard_axis__"]), int(d.attrs["__shard_offset__"]))
                for name, d in f.items() if "__shard_axis__" in getattr(d, "attrs", {})
            })
    cont = parts[0]
    for name, (axis, _) in shards[0].items():
        ai = cont.datasets[name].axes.index(axis)
        blocks = [b for _, b in sorted(((sh[name][1], part.datasets[name]._data) for sh, part in zip(shards, parts)),
                                       key=lambda t: t[0])]
        if isinstance(blocks[0], torch.Tensor):
            cont.datasets[name]._data = torch.cat(blocks, dim=ai)
        else:
            cont.datasets[name]._data = _as_storage(np.concatenate(blocks, axis=ai), cont.device)
    return cont


def _text(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)
