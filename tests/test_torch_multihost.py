"""The multi-device layer on torch.distributed: launch, placements, saves, queue.

Ranks are spawned processes on ``gloo`` on the CPU.  Each launch joins
through a file store under the test's ``tmp_path`` (never a TCP port, so
xdist workers cannot collide) and has a deadline: a hang fails the test.
The rank functions live here, in a module that imports neither JAX nor the
JAX package, so that each spawned rank imports only the port;
``tests/test_torch_spmd.py`` runs its own through :func:`run_ranks`.

The JAX package's multi-process tests are marked slow
(``tests/test_multihost.py``); the port is held against its own
single-process runs, which ``tests/test_torch_spmd.py`` holds against the
JAX package.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback

import numpy as np
import pytest
import torch

from draco_tpu_torch.core import config, containers
from draco_tpu_torch.core.pipeline import Manager, main
from draco_tpu_torch.core.task import ContainerTask, PipelineStopIteration
from draco_tpu_torch.device import default_device
from draco_tpu_torch.parallel import mesh as pmesh
from draco_tpu_torch.parallel import multihost

RANK_TIMEOUT_S = 120


# -- running a function on n ranks --------------------------------------------------


def _rank_entry(fn, rank: int, n: int, store: str, args: tuple, results) -> None:
    try:
        import torch.distributed as dist

        torch.set_num_threads(1)
        with default_device("cpu"):
            assert multihost.initialize(f"file://{store}", n, rank, timeout=RANK_TIMEOUT_S)
            try:
                results.put((rank, "ok", fn(rank, n, *args)))
            finally:
                dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, "err", traceback.format_exc()))


def run_ranks(fn, n: int, tmp_path, *args, timeout: float = RANK_TIMEOUT_S) -> list:
    """``fn(rank, n, *args)`` on ``n`` spawned ranks (gloo, CPU); each rank's
    return value, by rank.  A rank that fails, dies or outlasts ``timeout``
    fails the call, and every rank still running is stopped."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path / f"store-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, n, store, args, results)) for r in range(n)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < n:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                assert not dead, f"ranks {dead} died without a result"
                assert time.monotonic() < deadline, f"{n} ranks did not finish in {timeout} s"
                continue
            assert status == "ok", f"rank {rank} failed:\n{value}"
            got[rank] = value
    finally:
        for p in procs:
            if p.is_alive() and len(got) < n:
                p.terminate()
            p.join(timeout=30)
        assert not any(p.is_alive() for p in procs)
    return [got[r] for r in range(n)]


# -- split_local, initialize, the backend --------------------------------------------


def test_split_local_balanced():
    from draco_tpu.parallel import multihost as jmultihost

    got = [multihost.split_local(10, r, 4) for r in range(4)]
    assert got == [(3, 0), (3, 3), (2, 6), (2, 8)]
    assert got == [jmultihost.split_local(10, r, 4) for r in range(4)]
    assert multihost.split_local(7) == (7, 0)  # one process: the whole axis


def test_initialize_noop_without_config(monkeypatch):
    for var in ("DRACO_TPU_COORDINATOR", "DRACO_TPU_NUM_PROCESSES", "DRACO_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0 and multihost.is_leader()
    assert multihost.broadcast_from_leader({"a": 1}) == {"a": 1}


@pytest.mark.parametrize(
    "cards,backend",
    [(["cpu", "cpu"], "gloo"), (["h:GPU-a", "h:GPU-a"], "gloo"), (["h:GPU-a", "h:GPU-b"], "nccl"),
     (["h:GPU-a"], "nccl"), (["h:GPU-a", "cpu"], "gloo")],
)
def test_backend_follows_the_launch(cards, backend):
    """nccl only where every rank owns a card; ranks on the CPU or sharing a
    card (which nccl refuses) take gloo."""
    assert multihost._backend(cards) == backend


# -- placements on 1-D, named 2-D and hybrid meshes (4 ranks) ----------------------------


def _pl(x) -> str:
    """The placements of a placed tensor (or a placement list), as text."""
    return ", ".join(map(repr, x.placements if pmesh.is_placed(x) else x))


def _placements_on_four_ranks(rank, n):
    import torch.distributed as dist

    full = torch.arange(4 * 3 * 6, dtype=torch.float32).reshape(4, 3, 6)
    fullc = torch.complex(full, -full)
    out = {"backend": dist.get_backend(), "bcast": multihost.broadcast_from_leader({"rank": rank} if rank == 0 else None)}

    # 1-D shard mesh: the primary axis alone is split; an axis the mesh does
    # not divide stays replicated
    m1 = pmesh.make_mesh()
    with pmesh.use_mesh(m1):
        d = pmesh.shard_array_named(fullc, ("freq", "x", "m"), "freq")
        out["1d"] = (_pl(d), tuple(d.to_local().shape), bool(torch.equal(pmesh.unshard(d), fullc)))
        out["1d_m"] = _pl(pmesh.shard_array_named(full, ("freq", "x", "m"), "x"))  # 3 % 4: replicated
        out["1d_axis"] = _pl(pmesh.shard_array(full, -1))  # 6 % 4: replicated
        out["sharding_for_axis"] = _pl(pmesh.sharding_for_axis(3, 0))
    # named 2-D mesh: every axis named after a mesh dimension is split
    m2 = pmesh.make_mesh2d(axis_names=("freq", "m"))
    with pmesh.use_mesh(m2):
        d = pmesh.shard_array_named(full, ("freq", "x", "m"), None)
        out["2d"] = (tuple(m2.shape), _pl(d), tuple(d.to_local().shape))
        r = pmesh.shard_array_named(d, ("x", "freq", "m"), None)  # the freq dim now names no axis of length 4
        out["2d_redist"] = (_pl(r), bool(torch.equal(pmesh.unshard(r), full)))
        # a partial sum over the block, summed over the split dimensions
        s = pmesh.sum_over_shards(d.to_local().sum(dim=(0, 2)), d)
        out["2d_sum"] = bool(torch.allclose(s, full.sum(dim=(0, 2))))
    # hybrid mesh: dcn factor outermost, contiguous inner blocks of ranks
    m3 = pmesh.make_hybrid_mesh((1, 2), (2, 1), ("freq", "m"))
    out["hybrid"] = m3.mesh.tolist()
    with pmesh.use_mesh(m3):
        d = pmesh.shard_array_named(full, ("freq", "x", "m"), None)
        out["hybrid_block"] = d.to_local().tolist()
    return out


def test_placements_on_a_four_rank_mesh(tmp_path):
    res = run_ranks(_placements_on_four_ranks, 4, tmp_path)
    full = torch.arange(4 * 3 * 6, dtype=torch.float32).reshape(4, 3, 6)
    for rank, r in enumerate(res):
        assert r["backend"] == "gloo" and r["bcast"] == {"rank": 0}
        assert r["1d"] == ("Shard(dim=0)", (1, 3, 6), True)
        assert r["1d_m"] == "Replicate()" and r["1d_axis"] == "Replicate()"
        assert r["sharding_for_axis"] == "Shard(dim=0)"
        assert r["2d"] == ((2, 2), "Shard(dim=0), Shard(dim=2)", (2, 3, 3))
        assert r["2d_redist"] == ("Replicate(), Shard(dim=2)", True)
        assert r["2d_sum"]
        assert r["hybrid"] == [[0, 1], [2, 3]]
        f, m = divmod(rank, 2)
        assert r["hybrid_block"] == full[2 * f : 2 * f + 2, :, 3 * m : 3 * m + 3].tolist()


def test_hybrid_grid_keeps_inner_blocks_contiguous():
    grid = pmesh.hybrid_grid((1, 4), (2, 1), np.arange(8))
    assert grid.shape == (2, 4)
    for row in grid:
        assert list(row) == list(range(row[0], row[0] + 4))
    assert grid[1, 0] == grid[0, -1] + 1
    # across nodes on m too: each node's two cards hold neighbouring m blocks
    assert pmesh.hybrid_grid((2, 2), (1, 2), np.arange(8)).tolist() == [[0, 1, 4, 5], [2, 3, 6, 7]]
    with pytest.raises(ValueError):
        pmesh.hybrid_grid((2,), (2, 1), np.arange(4))
    with pytest.raises(ValueError):
        pmesh.hybrid_grid((2, 2), (4, 1), np.arange(8))
    assert pmesh.most_square(12) == (3, 4) and pmesh.most_square(7) == (1, 7)


def test_no_mesh_is_a_no_op():
    x = torch.ones(4, 2)
    assert pmesh.get_mesh() is None
    assert pmesh.shard_array_named(x, ("freq", "x")) is x and pmesh.shard_array(x, 0) is x
    assert pmesh.unshard(x) is x and pmesh.sharding_for_named_axes(("freq",), (4,), None) is None


# -- RandomFreqData -> FrequencyRebin over two processes, saved whole and in parts ----

PIPE_CFG = """
pipeline:
{mesh}
  tasks:
    - type: draco_tpu.util.testing.RandomFreqData
      out: data
      params: {{num_realisation: 1, num_ra: 16, num_base: 6, num_freq: 32, seed: 424242}}
    - type: draco_tpu.analysis.transform.FrequencyRebin
      in: data
      out: rebinned
      params: {{channel_bin: 4, save: true, save_sharded: {sharded}, output_name: "{out}"}}
"""


def _pipelines_on_two_ranks(rank, n, outdir):
    out = {}
    # leader-gated whole file, no mesh: every process runs every task
    Manager.from_yaml_str(PIPE_CFG.format(mesh="", sharded="false", out=f"{outdir}/multi.h5")).run()
    # a 2-process freq mesh: each rank rebins its slab and writes its part
    prods = Manager.from_yaml_str(
        PIPE_CFG.format(mesh="  mesh: {freq: 2}", sharded="true", out=f"{outdir}/sharded.h5")).run()
    vis = prods["rebinned"][0].vis[:]
    out["placed"] = (_pl(vis), tuple(vis.to_local().shape))
    # leader-gated whole file of the placed product
    Manager.from_yaml_str(PIPE_CFG.format(mesh="  mesh: {freq: 2}", sharded="false", out=f"{outdir}/gathered.h5")).run()
    # a mesh that needs more processes than the launch has raises at run
    try:
        Manager.from_yaml_str(PIPE_CFG.format(mesh="  mesh: {freq: 4}", sharded="false", out="unused.h5")).run()
    except config.ConfigError as e:
        out["too_big"] = str(e)
    return out


@pytest.fixture(scope="module")
def two_rank_pipelines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipes")
    res = run_ranks(_pipelines_on_two_ranks, 2, tmp, str(tmp))
    with default_device("cpu"):
        Manager.from_yaml_str(PIPE_CFG.format(mesh="", sharded="false", out=f"{tmp}/single.h5")).run()
    return tmp, res


def _assert_same(a, b):
    assert type(a).__name__ == type(b).__name__
    assert set(a.datasets) == set(b.datasets)
    for name in b.datasets:
        assert torch.equal(a.datasets[name][:], b.datasets[name][:]), name
    for name in b.index_map:
        assert np.array_equal(a.index_map[name], b.index_map[name]), name


def test_two_process_pipeline_matches_single(two_rank_pipelines):
    """Every process runs every task; the leader alone writes, and the file
    is the single process's, also when the product was placed over a mesh."""
    tmp, res = two_rank_pipelines
    single = containers.ContainerBase.from_file(str(tmp / "single.h5"), device="cpu")
    for name in ("multi.h5", "gathered.h5"):
        _assert_same(containers.ContainerBase.from_file(str(tmp / name), device="cpu"), single)
    assert res[0]["placed"] == ("Shard(dim=0)", (4, 6, 16)) == res[1]["placed"]


def test_save_sharded_parts_reassemble_to_the_single_file(two_rank_pipelines):
    import h5py

    tmp, _ = two_rank_pipelines
    parts = sorted(tmp.glob("sharded.part*.h5"))
    assert [p.name for p in parts] == ["sharded.part0000of0002.h5", "sharded.part0001of0002.h5"]
    with h5py.File(parts[1], "r") as f:
        assert f["vis"].shape[0] == 4 and f["vis"].attrs["__shard_offset__"] == 4  # 32 / bin 4 / 2 ranks
    back = multihost.load_sharded(str(tmp / "sharded.h5"), device="cpu")
    _assert_same(back, containers.ContainerBase.from_file(str(tmp / "single.h5"), device="cpu"))
    assert "__shard_rank__" not in back.attrs and "__shard_axis__" not in back.vis.attrs


def test_a_mesh_larger_than_the_launch_raises_at_run(two_rank_pipelines):
    _, res = two_rank_pipelines
    assert all("covers 4 processes but the launch has 2" in r["too_big"] for r in res)


def test_sharded_io_in_one_process(tmp_path):
    """Two writers simulated in one process; a missing part raises."""
    with default_device("cpu"):
        ss = containers.SiderealStream(freq=np.linspace(400.0, 500.0, 4), ra=8, input=3, stack=3, prod=3)
        rng = np.random.Generator(np.random.SFC64(5))
        ss.vis[:] = rng.standard_normal(ss.vis.shape) + 1j * rng.standard_normal(ss.vis.shape)
        ss.weight[:] = rng.random(ss.weight.shape)
        path = str(tmp_path / "stream.h5")
        multihost.save_sharded(ss, path, rank=0, size=2)
        with pytest.raises(FileNotFoundError, match="incomplete"):
            multihost.load_sharded(path)
        multihost.save_sharded(ss, path, rank=1, size=2)
        ss.save(str(tmp_path / "whole.h5"))
        _assert_same(multihost.load_sharded(path), containers.ContainerBase.from_file(str(tmp_path / "whole.h5")))


# -- queue ----------------------------------------------------------------------------


def test_queue_renders_one_process_per_card(tmp_path, capsys):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("cluster: {nodes: 3, ppn: 4, time: 90, name: run1, queue: gpu}\npipeline:\n  tasks:\n"
                   "    - type: draco_tpu.util.testing.DummyTask\n      out: x\n")
    assert main(["queue", str(cfg)]) == 0
    script = capsys.readouterr().out
    for line in ("#SBATCH --nodes=3", "#SBATCH --ntasks-per-node=4", "#SBATCH --gpus-per-node=4",
                 "#SBATCH --time=1:30:00", "#SBATCH --job-name=run1", "#SBATCH --partition=gpu",
                 'export DRACO_TPU_NUM_PROCESSES="$SLURM_NTASKS"', "CUDA_VISIBLE_DEVICES=$SLURM_LOCALID",
                 "DRACO_TPU_PROCESS_ID=$SLURM_PROCID", f"python -m draco_tpu_torch run {cfg}"):
        assert line in script, line
    out = tmp_path / "job.sh"
    assert main(["queue", str(cfg), "--output", str(out)]) == 0
    assert out.read_text() == script and os.access(out, os.X_OK)


# -- the dry run --------------------------------------------------------------------


def test_dryrun_multichip_on_two_ranks():
    """The sharded spine, the fused round trip of a split sky and the
    composite chain under a mesh, each against its unsharded run."""
    from draco_tpu_torch.parallel import dryrun_multichip

    summary = dryrun_multichip(2, device="cpu", timeout=300)
    assert summary["backend"] == "gloo" and summary["mesh"] == {"freq": 1, "m": 2}
    assert summary["fused_mesh"] == {"freq": 2}
    # the spine and the chain are per channel or per m: the same bits as one
    # process; the fused round trip of a sky split over both ranks contracts
    # each slab in its own GEMMs: within test_torch_spmd.py's bound for it
    assert summary["spine_rel"] == 0.0 and summary["composite_rel"] == 0.0
    assert 0.0 <= summary["fused_rel"] <= 1e-5


# -- a source task for the spine runs of tests/test_torch_spmd.py ----------------------


class EmitMap(ContainerTask):
    """One seeded sky Map on the telescope's channels (numpy draw)."""

    seed = config.int_prop(0)
    nside = config.int_prop(8)
    freq = config.list_prop([])

    def process(self):
        if self._count:
            raise PipelineStopIteration()
        m = containers.Map(nside=self.nside, polarisation=False, freq=np.array(self.freq))
        m.map[:] = np.random.Generator(np.random.SFC64(self.seed)).standard_normal(m.map.shape)
        m.attrs["tag"] = "sky"
        return m
