#!/usr/bin/env python3
"""Time the source-beamforming contraction at the stacking path's shapes.

    python3 scripts/time_beamform.py                    # on the card, this checkout
    python3 scripts/time_beamform.py --repo DIR         # another checkout's package
    python3 scripts/time_beamform.py --ptxas            # also the kernel's registers and shared memory
    python3 scripts/time_beamform.py --device cpu --nsrc 64 --nra 256 --nprod 45   # a rehearsal

Seeded synthetic inputs at ``chip_smoke.py`` phase 18's shapes: one
polarisation's stacks [16, 4096, 1789] (vis complex64, sw and vw float32,
natural weights), u and v of up to 130 and 260 wavelengths, and a catalogue
of 8192 sources at uniform RA and declinations over 0-80 deg, each with an
85-sample track.  ``ops/cuda_kernels.py::beamform_sums`` of the package
under ``--repo`` is timed with CUDA events (the mean of a run of calls after
one warm call, the row plan's bookkeeping included) and the kernel alone
(``chip_smoke.py::kernel_device_ms``, ``torch.profiler``) on three shapes: the catalogue's first 8 batches of
32 sources (the mean a launch), its first 512 sources, and the whole
catalogue in one launch; each against ``chip_smoke.py::beamform_bound`` on
its own windows (this checkout's ``chip_smoke.py``, whichever package is
timed), and each held against the plain version (F, W and Q,
max|diff| / max|ref|; the whole catalogue's plain version in batches of
32, timed with ``--plain``).  One JSON line a shape; the last line printed
is the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def inputs(nfreq, nra, nprod, nsrc, nha, device, seed):
    """Stacks, baselines and the catalogue's tracks (ra_idx int32, a, b float32)."""
    import numpy as np
    import torch

    rng = np.random.Generator(np.random.SFC64(seed))
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (nfreq, nra, nprod)
    vis = torch.randn(shape, generator=g, dtype=torch.complex64, device=device)
    sw = torch.rand(shape, generator=g, device=device) * 1.5 + 0.5
    vw = torch.rand(shape, generator=g, device=device) * 1.5 + 0.5
    u = torch.as_tensor(rng.uniform(-130, 130, (nfreq, nprod)), dtype=torch.float32, device=device)
    v = torch.as_tensor(rng.uniform(-260, 260, (nfreq, nprod)), dtype=torch.float32, device=device)
    transit = rng.integers(0, nra, nsrc)
    side = nha // 2
    ra_idx = ((transit[:, None] + np.arange(-side, side + 1)) % nra).astype(np.int32)
    ha = (np.arange(-side, side + 1) - rng.uniform(-0.5, 0.5, (nsrc, 1))) * 2 * np.pi / nra
    dec = np.radians(rng.uniform(0.0, 80.0, (nsrc, 1)))
    lat = np.radians(49.3)
    a = np.cos(dec) * np.sin(ha)
    b = np.cos(lat) * np.sin(dec) - np.sin(lat) * np.cos(dec) * np.cos(ha)
    return (vis, sw, vw, u, v), ra_idx, a, b


def ptxas_report(repo: Path) -> str:
    """nvcc's resource usage (-Xptxas -v) for csrc/beamform.cu, built apart."""
    from draco_tpu_torch import _build

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(Path(tmp) / "b.so"),
                              str(repo / "draco_tpu_torch" / "csrc" / "beamform.cu")],
                             capture_output=True, text=True, timeout=600)
    return (out.stdout + out.stderr).strip()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent),
                        help="checkout whose draco_tpu_torch is timed")
    parser.add_argument("--device", default="cuda", help="device to run on")
    parser.add_argument("--nfreq", type=int, default=16)
    parser.add_argument("--nra", type=int, default=4096)
    parser.add_argument("--nprod", type=int, default=1789)
    parser.add_argument("--nsrc", type=int, default=8192)
    parser.add_argument("--nha", type=int, default=85)
    parser.add_argument("--seed", type=int, default=10)
    parser.add_argument("--plain", action="store_true", help="also time the plain version")
    parser.add_argument("--ptxas", action="store_true", help="print nvcc's resource usage of the kernel")
    args = parser.parse_args()

    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import numpy as np
    import torch

    from draco_tpu_torch.ops import cuda_kernels, interferometry

    # the bound and the timers of this checkout's smoke, whichever package is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if args.ptxas:
        print(ptxas_report(repo), flush=True)
    stacks, ra_idx, a, b = inputs(args.nfreq, args.nra, args.nprod, args.nsrc, args.nha, device, args.seed)
    vis, sw, vw, u, v = stacks
    rate = chip_smoke.sfu_rate() if on_card else float("nan")

    def call_args(sl):
        as32 = dict(dtype=torch.float32, device=device)
        return (vis, sw, vw, torch.as_tensor(ra_idx[sl], device=device), torch.as_tensor(a[sl], **as32),
                torch.as_tensor(b[sl], **as32), u, v)

    def ms(fn, reps):
        if not on_card:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        return chip_smoke.cuda_ms(fn, reps)

    def errors(got, refs):
        """max|diff| / max|ref| of F, W and Q, refs in batches of 32 over got's sources."""
        worst, scale = np.zeros(3), np.zeros(3)
        for b0, ref in refs:
            for i, (g, r) in enumerate(zip(got, ref)):
                worst[i] = max(worst[i], (g[:, b0 : b0 + 32].double() - r.double()).abs().max().item())
                scale[i] = max(scale[i], r.double().abs().max().item())
        return (worst / scale).tolist()

    nsub = min(512, args.nsrc)
    shapes = {"batch32": [slice(b0, b0 + 32) for b0 in range(0, min(256, args.nsrc), 32)],
              f"sources_{nsub}": [slice(0, nsub)], "catalogue": [slice(0, args.nsrc)]}
    for name, slices in shapes.items():
        launched = [call_args(sl) for sl in slices]
        before = cuda_kernels.launches["beamform"]
        outs = [cuda_kernels.beamform_sums(*x, natural=True) for x in launched]
        row = {"shape": name, "launch_sources": slices[0].stop - slices[0].start, "launches": len(slices),
               "kernel_launches_counted": cuda_kernels.launches["beamform"] - before}
        err = [0.0, 0.0, 0.0]
        for sl, out in zip(slices, outs):
            refs = ((b0, interferometry.beamform_sums_plain(*call_args(slice(sl.start + b0, min(sl.start + b0 + 32,
                                                                                                  sl.stop))),
                                                             natural=True))
                    for b0 in range(0, sl.stop - sl.start, 32))
            err = np.maximum(err, errors(out, refs)).tolist()
        again = cuda_kernels.beamform_sums(*launched[-1], natural=True)
        row["rerun_same_bits"] = all(torch.equal(x, y) for x, y in zip(again, outs[-1]))
        del outs, again
        row["rel_err_F_W_Q"] = err
        reps = 20 if name == "batch32" else 5
        k1 = float(np.mean([ms(lambda x=x: cuda_kernels.beamform_sums(*x, natural=True), reps) for x in launched]))
        row["kernel_ms"] = [k1]
        if args.plain:
            def plain_all(sl=slices[0]):
                for b0 in range(sl.start, sl.stop, 32):
                    interferometry.beamform_sums_plain(*call_args(slice(b0, min(b0 + 32, sl.stop))), natural=True)

            row["plain_ms"] = [float(np.mean([ms(lambda sl=sl: plain_all(sl), 1) for sl in slices]))]
        row["kernel_ms"].append(float(np.mean([ms(lambda x=x: cuda_kernels.beamform_sums(*x, natural=True), reps)
                                               for x in launched])))
        if on_card and hasattr(cuda_kernels, "beamform_plan"):
            row["plan_ms"] = float(np.mean([ms(lambda x=x: cuda_kernels.beamform_plan(x[3], args.nra), reps)
                                            for x in launched]))
        if on_card:
            row["kernel_device_ms"] = float(np.mean([chip_smoke.kernel_device_ms(
                lambda x=x: cuda_kernels.beamform_sums(*x, natural=True), reps, "beamform") for x in launched]))
        bounds = [chip_smoke.beamform_bound(ra_idx[sl], args.nfreq, args.nprod, True, rate) for sl in slices]
        row["bound_ms"] = float(np.mean([bd for bd, _ in bounds]))
        row["bound_by"] = bounds[0][1]
        row["kernel_over_bound"] = min(row["kernel_ms"]) / row["bound_ms"]
        print(json.dumps(row), flush=True)
        del launched
    if on_card:
        print(chip_smoke.gpu_name_and_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
