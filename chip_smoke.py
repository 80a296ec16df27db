#!/usr/bin/env python3
"""Smoke run of the draco_tpu_torch slice on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (exit code != 0):

1. set-up: needs a CUDA device; prints the card's name and power limit;
   builds the CUDA kernel from ``draco_tpu_torch/csrc`` with nvcc;
2. the banded-covariance kernel against its plain PyTorch version in
   float64 on the card, on the operands that phase 3's regrid hands it
   (R [2098, 8640] from a Lanczos matrix of one jittered sidereal day,
   Ni [2017, 8640], the time stream's weights with their zero-weight gaps,
   bw 9): the float32 kernel within 1e-5 and the
   float64 kernel within 1e-12 (max|diff| / max|ref|), band-end zeros
   exact, two launches bitwise equal; each timed with CUDA events beside
   the plain version in its type.  At R [300, 1000]: an R with permuted
   columns (every sample window full width) and bw 33, within 1e-5;
3. the slice at the bench headline's width: a time stream from ``--seed``
   (every baseline of the 64-dish array x 8640 samples, with zero-weight
   gaps) -> ``regrid_sidereal`` to
   2048 RA bins -> ``make_marray`` and ``mmode_weights`` (mmax 767) ->
   ``fused_simulate_to_map`` at nside 256 with those weights (chunk 520).
   The kernel launch counts are zeroed just before and read just after;
   the kernel must have launched;
4. accuracy: the same weighted round trip at nside 64 in float32 and
   float64 on the card, within 1e-5 relative error.

The last lines are the kernels' JSON record, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

NSIDE = 256
NSIDE_ACC = 64
NFEED_SIDE = 8
CHUNK = 520
NTIME = 8640
SAMPLES = 2048
KERNEL_WIDTH = 5
EPSILON = 1e-3
TOL_KERNEL = 1e-5
TOL_KERNEL_F64 = 1e-12
TOL_MAP = 1e-5


def log(*args):
    print(*args, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def telescope(nside: int):
    """The bench headline array: 8 x 8 jittered dishes, one frequency, autos."""
    from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedDishArray

    f0 = 299.792458 / 0.6  # MHz
    tel = UnpolarisedDishArray(
        grid_ew=NFEED_SIDE, grid_ns=NFEED_SIDE, spacing_ew=7.0, spacing_ns=7.0,
        jitter=1.0, jitter_seed=1, latitude=45.0, dish_width=5.0, fwhm_factor=1.0,
        freq_lower=f0, freq_upper=f0, num_freq=1, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
    )
    return tel, BeamTransfer(tel, nside=nside)


def time_stream(nfreq: int, nbase: int, ntime: int, seed: int):
    """Seeded irregular samples of one sidereal day with zero-weight gaps.

    Returns (times [ntime] in days, vis [nfreq, nbase, ntime] complex64,
    weight [nfreq, nbase, ntime] float32).
    """
    rng = np.random.Generator(np.random.SFC64(seed))
    times = (np.arange(ntime) + rng.uniform(-0.3, 0.3, ntime)) / ntime
    times[0] = 0.0
    shape = (nfreq, nbase, ntime)
    vis = np.empty(shape, np.complex64)
    vis.real = rng.standard_normal(shape, dtype=np.float32)
    vis.imag = rng.standard_normal(shape, dtype=np.float32)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[..., ntime // 4 : ntime // 4 + 40] = 0.0
    weight[:, ::7, ::97] = 0.0
    return times, vis, weight


def regrid_operands(times: np.ndarray, weight: np.ndarray, samples: int):
    """R and Ni exactly as the slice's ``regrid_sidereal`` hands them to the
    kernel: R [samples + 2 pad, ntime], Ni [nfreq * nbase, ntime]."""
    from draco_tpu_torch.ops import regrid

    pad = 5 * KERNEL_WIDTH
    end = float(times[-1])
    grid = end * np.arange(-pad, samples + pad, dtype=np.float64) / samples
    R = np.ascontiguousarray(regrid.lanczos_forward_matrix(grid, times, KERNEL_WIDTH).T, np.float32)
    Ni = np.ascontiguousarray(weight.reshape(-1, times.size), np.float32)
    return R, Ni


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _rel_err(out, ref) -> tuple[float, float]:
    err = (out.double() - ref).abs().max().item()
    return err, err / ref.abs().max().item()


def _band_end_zeros(out, bw: int) -> bool:
    m = out.shape[-1]
    return all(bool((out[:, d, max(m - d, 0) :] == 0).all()) for d in range(bw + 1))


def check_kernel(device, times, weight, seed: int):
    """Phase 2: the kernel against its plain version on the slice's operands."""
    import torch

    from draco_tpu_torch.ops import banded, cuda_kernels

    bw = 2 * KERNEL_WIDTH - 1
    R_h, Ni_h = regrid_operands(times, weight, SAMPLES)
    R = torch.from_numpy(R_h).to(device)
    Ni = torch.from_numpy(Ni_h).to(device)
    R64, Ni64 = R.double(), Ni.double()
    out = cuda_kernels.banded_covariance_batched(R, Ni, bw)
    again = cuda_kernels.banded_covariance_batched(R, Ni, bw)
    out64 = cuda_kernels.banded_covariance_batched(R64, Ni64, bw)
    torch.cuda.synchronize()
    ref = banded.banded_covariance(R64, Ni64, bw)
    err, rel = _rel_err(out, ref)
    err64, rel64 = _rel_err(out64, ref)
    tail_zero = _band_end_zeros(out, bw) and _band_end_zeros(out64, bw)
    bitwise = torch.equal(out, again)
    log(f"kernel banded_covariance R{tuple(R.shape)} Ni{tuple(Ni.shape)} bw={bw}: "
        f"float32 max_abs_err={err:.3e} rel={rel:.3e}, float64 max_abs_err={err64:.3e} rel={rel64:.3e}, "
        f"band_end_zeros_exact={tail_zero} two_launches_bitwise_equal={bitwise}")
    if not (rel <= TOL_KERNEL and torch.isfinite(out).all()):
        raise RuntimeError(f"float32 banded_covariance kernel disagrees with its plain version: rel {rel:.3e}")
    if not (rel64 <= TOL_KERNEL_F64 and torch.isfinite(out64).all()):
        raise RuntimeError(f"float64 banded_covariance kernel disagrees with its plain version: rel {rel64:.3e}")
    if not (tail_zero and bitwise):
        raise RuntimeError("banded_covariance kernel: band-end zeros not exact or launches not bitwise equal")
    del ref, out, again, out64
    # plain, kernel, kernel, plain, in each type
    times_ms = {}
    for name, (r, ni) in (("f32", (R, Ni)), ("f64", (R64, Ni64))):
        plain1 = cuda_ms(lambda: banded.banded_covariance(r, ni, bw), 3)
        kern1 = cuda_ms(lambda: cuda_kernels.banded_covariance_batched(r, ni, bw), 10)
        kern2 = cuda_ms(lambda: cuda_kernels.banded_covariance_batched(r, ni, bw), 10)
        plain2 = cuda_ms(lambda: banded.banded_covariance(r, ni, bw), 3)
        log(f"kernel banded_covariance {name} ms: kernel {kern1:.4f} {kern2:.4f}, "
            f"plain {plain1:.4f} {plain2:.4f}")
        times_ms[name] = (min(kern1, kern2), min(plain1, plain2))
    check_small_cases(device, seed)
    return {
        "max_abs_err": err, "ms": times_ms["f32"][0], "plain_ms": times_ms["f32"][1],
        "max_abs_err_f64": err64, "ms_f64": times_ms["f64"][0], "plain_ms_f64": times_ms["f64"][1],
    }


def check_small_cases(device, seed: int, m: int = 300, n: int = 1000, batch: int = 64):
    """Phase 2, small shapes: an R whose columns are permuted, and bw 33."""
    import torch

    from draco_tpu_torch.ops import banded, cuda_kernels, regrid

    rng = np.random.Generator(np.random.SFC64(seed))
    samples = np.sort(rng.uniform(0.0, 1.0, n))
    R_h = regrid.lanczos_forward_matrix(np.linspace(0.0, 1.0, m), samples, KERNEL_WIDTH).T
    Ni = torch.from_numpy(rng.uniform(0.5, 2.0, (batch, n)).astype(np.float32)).to(device)
    permuted = torch.from_numpy(np.ascontiguousarray(R_h[:, rng.permutation(n)], np.float32)).to(device)
    # the nonzeros of every tile of rows span the samples: full-width windows
    win = cuda_kernels.tile_windows(permuted, cuda_kernels.tile_rows())
    full = bool(((win[:, 1] - win[:, 0] >= 0.9 * n) | (win[:, 1] <= win[:, 0])).all())
    banded_R = torch.from_numpy(np.ascontiguousarray(R_h, np.float32)).to(device)
    for name, R, bw in (("permuted columns", permuted, 2 * KERNEL_WIDTH - 1), ("bw 33", banded_R, 33)):
        out = cuda_kernels.banded_covariance_batched(R, Ni, bw)
        ref = banded.banded_covariance(R.double(), Ni.double(), bw)
        err, rel = _rel_err(out, ref)
        tail_zero = _band_end_zeros(out, bw)
        log(f"kernel banded_covariance {name} R{tuple(R.shape)} Ni{tuple(Ni.shape)} bw={bw}: "
            f"max_abs_err={err:.3e} rel={rel:.3e} band_end_zeros_exact={tail_zero}"
            + (f" full_width_windows={full}" if name == "permuted columns" else ""))
        if not (rel <= TOL_KERNEL and tail_zero and torch.isfinite(out).all()):
            raise RuntimeError(f"banded_covariance kernel, {name}: rel {rel:.3e} or band-end zeros not exact")
    if not full:
        raise RuntimeError("the permuted R did not give full-width windows")


def run_slice(bt, tel, sky, times, vis, weight, device, samples, chunk):
    """Time-ordered data -> regrid -> m-modes and weights -> weighted round trip."""
    import torch

    from draco_tpu_torch.analysis.transform import mmode_weights, regrid_sidereal
    from draco_tpu_torch.ops import mmode
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    stages = {}
    t0 = _sync_clock(device)
    vis_d = torch.from_numpy(vis).to(device)
    weight_d = torch.from_numpy(weight).to(device)
    sky_d = torch.from_numpy(sky).to(device)
    t1 = _sync_clock(device)
    stages["upload_s"] = t1 - t0
    _, v, ni = regrid_sidereal(
        vis_d, weight_d, times, samples, 0.0, float(times[-1]), KERNEL_WIDTH, EPSILON
    )
    t2 = _sync_clock(device)
    stages["regrid_s"] = t2 - t1
    mvis = mmode.make_marray(v, mmax=tel.mmax)
    w = mmode_weights(ni, tel.mmax)
    t3 = _sync_clock(device)
    stages["mmodes_s"] = t3 - t2
    maps = fused_simulate_to_map(bt, sky_d, chunk=chunk, weight=w)
    t4 = _sync_clock(device)
    stages["roundtrip_s"] = t4 - t3
    return stages, mvis, w, maps


def _sync_clock(device) -> float:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2, help="seed of the time stream and kernel inputs")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    repo = Path(__file__).resolve().parent
    if not (repo / "draco_tpu_torch" / "csrc" / "banded_covariance.cu").is_file():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(repo))

    import draco_tpu_torch  # noqa: F401  (sets the float32 matmul policy)
    from draco_tpu_torch import _build
    from draco_tpu_torch.ops import cuda_kernels, healpix
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    device = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")

    # phase 1: build
    t0 = time.perf_counter()
    _build.load("banded_covariance")
    log(f"build: banded_covariance.cu {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds.get('banded_covariance', 0.0):.2f} s)")

    # phase 2: the kernel at the slice's shape
    tel, bt = telescope(NSIDE)
    nbase = len(tel.uniquepairs)
    times, vis, weight = time_stream(tel.nfreq, nbase, NTIME, seed=args.seed)
    kern = check_kernel(device, times, weight, seed=args.seed + 1)

    # phase 3: the slice at headline width
    rng = np.random.Generator(np.random.SFC64(1))
    sky = rng.standard_normal((tel.nfreq, 1, healpix.npix_of(NSIDE))).astype(np.float32)
    log(f"slice: nside={NSIDE} lmax=mmax={tel.mmax} pairs={nbase} nfreq={tel.nfreq} "
        f"ntime={NTIME} -> {SAMPLES} RA bins, chunk={CHUNK}")
    cuda_kernels.reset_launches()
    stages, mvis, w, maps = run_slice(bt, tel, sky, times, vis, weight, device, SAMPLES, CHUNK)
    launches = dict(cuda_kernels.launches)
    log("slice stages, first run (s): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    log(f"slice kernel launches: {launches}")
    if launches["banded_covariance"] < 1:
        raise RuntimeError("the slice did not launch the banded_covariance kernel")
    for name, x, shape in (
        ("m-modes", mvis, (tel.mmax + 1, 2, tel.nfreq, nbase)),
        ("m-mode weights", w, (tel.mmax + 1, 2, tel.nfreq, nbase)),
        ("map", maps, (tel.nfreq, 1, healpix.npix_of(NSIDE))),
    ):
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"slice {name}: shape {tuple(x.shape)} (want {shape}) or non-finite values")
    if not bool((w > 0).any()):
        raise RuntimeError("slice m-mode weights are all zero")
    # the same slice again, warm: lazy kernel-module loading and the
    # round trip's table build fall in the first run only
    warm = [run_slice(bt, tel, sky, times, vis, weight, device, SAMPLES, CHUNK)[0] for _ in range(2)]
    log("slice stages warm (s): " + json.dumps(
        {k: round(min(run[k] for run in warm), 4) for k in stages}))
    log(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")

    # phase 4: accuracy at nside 64, float32 against float64
    tel64, bt64 = telescope(NSIDE_ACC)
    rng = np.random.Generator(np.random.SFC64(1))
    sky64 = torch.from_numpy(rng.standard_normal((1, 1, healpix.npix_of(NSIDE_ACC)))).to(device)
    w64 = w[: tel64.mmax + 1].double()
    m32 = fused_simulate_to_map(bt64, sky64.float(), chunk=CHUNK, weight=w64.float())
    m64 = fused_simulate_to_map(bt64, sky64, chunk=CHUNK, weight=w64)
    rel = ((m32.double() - m64).abs().max() / m64.abs().max()).item()
    log(f"accuracy nside={NSIDE_ACC}: float32 vs float64 weighted round trip rel err {rel:.3e} (tol {TOL_MAP})")
    if not rel <= TOL_MAP:
        raise RuntimeError(f"round-trip accuracy {rel:.3e} exceeds {TOL_MAP}")

    record = {"kernels": [{
        "name": "banded_covariance",
        "route": "cuda",
        "source": "draco_tpu_torch/csrc/banded_covariance.cu",
        "replaces": "draco_tpu/ops/pallas_kernels.py:57",
        "launches": launches["banded_covariance"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "max_abs_err_f64": kern["max_abs_err_f64"],
        "ms_f64": kern["ms_f64"],
        "plain_ms_f64": kern["plain_ms_f64"],
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
