"""A sharded step of the m-mode spine over ``n`` ranks.

Port of ``__graft_entry__.py::dryrun_multichip`` (the analogue of the
reference's ``mpirun -np 4`` CI gate, reference
.github/workflows/main.yaml:84-87).  :func:`dryrun_multichip` starts ``n``
processes, one rank each, on the CPU or sharing the card (``gloo``), joins
them through a file store, and on the most-square (freq, m) mesh runs:

1. the explicit spine: the SHT of each rank's frequency slab, the alm
   split over ``m`` as well, the beam-transfer projection and its adjoint
   on each rank's (freq, m) block, the alm gathered back over ``m``, and the
   synthesis of each frequency slab; held against the unsharded spine;
2. ``fused_simulate_to_map`` of a sky split over a 1-D ``freq`` mesh of
   all ``n`` ranks (on the most-square mesh of 2 ranks the ``freq``
   dimension has size 1 and would split nothing) against the unsharded
   sky, within 1e-4 of the map's scale (the JAX package's bound);
3. the composite simulation (sky -> gains -> noise -> collate -> m-modes ->
   dirty map) through the pipeline Manager under ``pipeline.mesh: {freq:
   -1}``, against the same config with no mesh.

A rank that fails fails the run: the others are stopped and the error
raised.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np

__all__ = ["dryrun_multichip"]

NSIDE = 8
LMAX = 3 * NSIDE - 1  # 23: mmax + 1 = 24 divides over 1, 2, 3, 4, 6 and 8 ranks


def _problem(nfreq: int, device):
    """The JAX dry run's problem: a 2 x 2 dish array over 400-500 MHz at
    nside 8, its beam transfer matrices, and a seeded float32 sky."""
    import torch

    from ..telescope import BeamTransfer, UnpolarisedDishArray

    tel = UnpolarisedDishArray(
        grid_ew=2, grid_ns=2, spacing_ew=5.0, spacing_ns=5.0, latitude=40.0, freq_lower=400.0, freq_upper=500.0,
        num_freq=nfreq, dish_width=5.0, auto_correlations=True, force_lmax=LMAX, force_mmax=LMAX,
    )
    bt = BeamTransfer(tel, nside=NSIDE).generate(device=device)
    rng = np.random.Generator(np.random.SFC64(42))
    sky = torch.as_tensor(rng.standard_normal((nfreq, 1, 12 * NSIDE**2)), dtype=torch.float32, device=device)
    return tel, bt, sky


def _spine(s, bp, bm, sky):
    """Map -> alm -> m-mode visibilities -> dirty alm, on whatever blocks it is given."""
    import torch

    alm = s.analysis(sky).to(bp.dtype)
    vp = torch.einsum("fbplm,fplm->mfb", bp, alm)
    vm = torch.einsum("fbplm,fplm->mfb", bm, alm)
    return torch.einsum("fbplm,mfb->fplm", bp.conj(), vp) + torch.einsum("fbplm,mfb->fplm", bm.conj(), vm)


def _rel(a, b) -> float:
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) / scale


def _composite_config(product_dir: str, tel, mesh: bool) -> dict:
    """The JAX dry run's composite chain (examples/chime_scale.yaml at dry-run
    size), with a generated sky in place of its map file."""
    f = np.asarray(tel.frequencies)
    sky = {"model": "foreground", "nside": NSIDE, "freq_start": float(f[0]),
           "freq_end": float(f[-1] + (f[1] - f[0])), "nfreq": len(f), "seed": 7}
    tasks = [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"],
         "params": {"product_directory": product_dir, "nside": NSIDE}},
        {"type": "draco.synthesis.skymodel.GenerateGaussianSky", "out": "imap", "params": sky},
        {"type": "draco.synthesis.stream.SimulateSidereal", "requires": "btm", "in": "imap", "out": "sstream"},
        {"type": "draco.synthesis.stream.ExpandProducts", "requires": "tel", "in": "sstream", "out": "sstream_full"},
        {"type": "draco.synthesis.noise.ReceiverTemperature", "in": "sstream_full", "out": "sstream_rt",
         "params": {"recv_temp": 50.0}},
        {"type": "draco.synthesis.gain.RandomSiderealGains", "requires": ["tel", "sstream_rt"], "out": "gain_fluc",
         "params": {"seed": 7, "start_time": "2015-10-05 12:15:00", "end_time": "2015-10-06 12:15:00",
                    "sigma_amp": 0.001, "sigma_phase": 0.001}},
        {"type": "draco.analysis.calibration.ApplyGain", "in": ["sstream_rt", "gain_fluc"], "out": "sstream_gain",
         "params": {"inverse": False}},
        {"type": "draco.synthesis.noise.SampleNoise", "in": "sstream_gain", "out": "sstream_noise",
         "params": {"seed": 8, "sample_frac": 1.0e-6}},
        {"type": "draco.analysis.transform.CollateProducts", "requires": "btm", "in": "sstream_noise",
         "out": "sstream_coll"},
        {"type": "draco.analysis.transform.MModeTransform", "requires": "tel", "in": "sstream_coll", "out": "mmodes"},
        {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "btm", "in": "mmodes", "out": "dmap",
         "params": {"nside": NSIDE}},
    ]
    pipeline = {"tasks": tasks, "retain_products": "final"}
    if mesh:
        pipeline["mesh"] = {"freq": -1}
    return {"pipeline": pipeline}


def _run_body(n: int, product_root: str) -> dict:
    """The dry run on this rank (the process group joined, the device set)."""
    import torch
    import torch.distributed as dist

    from ..core.pipeline import Manager
    from ..device import resolve
    from ..ops import sht
    from ..telescope.roundtrip import fused_simulate_to_map
    from . import mesh as pmesh
    from .multihost import is_leader

    device = resolve(None)
    nf, nm = pmesh.most_square(n)
    mesh = pmesh.make_mesh2d((nf, nm), ("freq", "m"))
    nfreq = max(2 * nf, n)  # divides over nf and over n
    tel, bt, sky = _problem(nfreq, device)
    s = sht.get_sht(NSIDE, LMAX)
    summary = {"mesh": {"freq": nf, "m": nm}, "fused_mesh": {"freq": n}, "backend": dist.get_backend(),
               "device": str(device)}

    # 1. the explicit spine, stage by stage on each rank's blocks
    t0 = time.perf_counter()
    with pmesh.use_mesh(mesh):
        sky_p = pmesh.shard_array_named(sky, ("freq", "pol", "pix"))
        alm = s.analysis(sky_p.to_local()).to(bt._bp.dtype)  # freq-parallel SHT
        alm_p = pmesh.from_block(alm, mesh, sky_p.placements, (nfreq,) + tuple(alm.shape[1:]))
        # split m too (a local cut: the freq -> m transpose of the reference)
        alm_fm = pmesh.local(pmesh.shard_array_named(alm_p, ("freq", "pol", "l", "m")))
        bp = pmesh.local(pmesh.shard_array_named(bt._bp, ("freq", "base", "pol", "l", "m")))
        bm = pmesh.local(pmesh.shard_array_named(bt._bm, ("freq", "base", "pol", "l", "m")))
        vp = torch.einsum("fbplm,fplm->mfb", bp, alm_fm)
        vm = torch.einsum("fbplm,fplm->mfb", bm, alm_fm)
        a = torch.einsum("fbplm,mfb->fplm", bp.conj(), vp) + torch.einsum("fbplm,mfb->fplm", bm.conj(), vm)
        a_fm = pmesh.from_block(a, mesh, pmesh.sharding_for_named_axes(("freq", "pol", "l", "m"), alm_p.shape, None),
                                alm_p.shape)
        # m -> freq: gather m back, then the freq-parallel synthesis
        a_f = pmesh.place(a_fm, mesh, sky_p.placements)
        maps = pmesh.unshard(pmesh.from_block(s.synthesis(a_f.to_local()), mesh, sky_p.placements, sky.shape))
    ref = s.synthesis(_spine(s, bt._bp, bt._bm, sky))
    if tuple(maps.shape) != tuple(sky.shape) or not bool(torch.isfinite(maps).all()):
        raise RuntimeError(f"the sharded spine gave a map of shape {tuple(maps.shape)} or non-finite values")
    summary["spine_rel"] = _rel(maps, ref)
    if not summary["spine_rel"] <= 1e-5:
        raise RuntimeError(f"the sharded spine is {summary['spine_rel']:.3e} from the unsharded one (tol 1e-5)")
    summary["spine_s"] = time.perf_counter() - t0

    # 2. the fused round trip of a sky split over every rank by frequency
    t0 = time.perf_counter()
    ref = fused_simulate_to_map(bt, sky, chunk=4)
    fmesh = pmesh.make_mesh(axis_name="freq")
    with pmesh.use_mesh(fmesh):
        sky_f = pmesh.shard_array_named(sky, ("freq", "pol", "pix"))
        if sky_f.to_local().shape[0] != nfreq // n:
            raise RuntimeError(f"the sky's {nfreq} channels did not split over {n} ranks")
        out = pmesh.unshard(fused_simulate_to_map(bt, sky_f, chunk=4))
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("the sharded fused round trip gave non-finite values")
    summary["fused_rel"] = _rel(out, ref)
    if not summary["fused_rel"] < 1e-4:
        raise RuntimeError(f"the sharded fused round trip is {summary['fused_rel']:.3e} from the unsharded (tol 1e-4)")
    summary["fused_s"] = time.perf_counter() - t0

    # 3. the composite chain through the Manager under `mesh: {freq: -1}`
    t0 = time.perf_counter()
    product_dir = os.path.join(product_root, "bt")
    if is_leader():
        bt.save(product_dir)
    dist.barrier()
    dmap = Manager(_composite_config(product_dir, tel, mesh=True)).run()["dmap"][0]
    got = pmesh.unshard(dmap.map[:])
    ref = Manager(_composite_config(product_dir, tel, mesh=False)).run()["dmap"][0].map[:]
    if not (bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0):
        raise RuntimeError("the composite chain under the mesh gave a zero or non-finite map")
    summary["composite_rel"] = _rel(got, ref)
    if not summary["composite_rel"] <= 1e-5:
        raise RuntimeError(f"the composite chain under the mesh is {summary['composite_rel']:.3e} from the "
                           "unsharded run (tol 1e-5)")
    summary["composite_s"] = time.perf_counter() - t0
    return summary


def _rank_main(rank: int, n: int, store: str, device: str | None, product_root: str, results) -> None:
    """One rank of the dry run: join, run, report (ok, summary) or (err, traceback)."""
    try:
        import torch.distributed as dist

        from ..device import default_device
        from . import multihost

        with default_device(device):
            multihost.initialize(f"file://{store}", n, rank, timeout=300.0)
            try:
                results.put((rank, "ok", _run_body(n, product_root)))
            finally:
                dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, "err", traceback.format_exc()))


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0) -> dict:
    """Run the sharded spine on ``n_devices`` ranks; rank 0's summary.

    ``device`` is where every rank computes: None for the card (the ranks
    share it, over ``gloo``), ``"cpu"`` for the CPU.  Raises RuntimeError
    if a rank fails or the run outlasts ``timeout`` seconds.
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, args=(r, n_devices, store, None if device is None else str(device), tmp,
                                                 results))
            for r in range(n_devices)
        ]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        try:
            while len(got) < n_devices:
                try:
                    rank, status, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"ranks {dead} of the dry run exited without a result "
                                           f"(exit codes {[procs[r].exitcode for r in dead]})") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"the dry run on {n_devices} ranks did not finish in {timeout:.0f} s") from None
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} of the dry run failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                if p.is_alive() and len(got) < n_devices:
                    p.terminate()
                p.join(timeout=30)
    return got[0]
