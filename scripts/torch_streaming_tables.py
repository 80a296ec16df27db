#!/usr/bin/env python3
"""Which band Legendre table puts the streaming task chain inside 1e-5.

    python3 scripts/torch_streaming_tables.py      # on the card
    python3 scripts/torch_streaming_tables.py --device cpu --nside 32   # a rehearsal

On the bench headline's dish array (8 x 8 dishes, 2017 baselines, nside
256, lmax = mmax = 767) and the seeded sky of ``chip_smoke.py`` phase 10,
runs chain B (``SimulateSidereal`` streaming -> ``MModeTransform`` ->
``DirtyMapMaker`` streaming) with the windowed streaming projections
contracting against three band Legendre tables, and prints each map,
divided by the 1535 RA samples, against the float64 fused map
(max|diff| / max|map|):

- ``two-float``: hi float32 + lo bfloat16 from a float64 recurrence (what
  the projections use);
- ``hi only``: the float32 rounding of the float64 recurrence;
- ``single-float``: the recurrence run in float32 (what the JAX package's
  streaming projections use).

The float32 fused map is printed against the same truth.  The last line
is the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

NSIDE = 256
CHUNK = 520
SKY_SEED = 10


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--nside", type=int, default=NSIDE)
    args = parser.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_streaming_tables: no CUDA device is available")
    nside = args.nside
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

    import draco_tpu_torch  # noqa: F401  (sets the float32 matmul policy)
    from draco_tpu_torch.analysis.mapmaker import DirtyMapMaker
    from draco_tpu_torch.analysis.transform import MModeTransform
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.ops.sht_window import WindowedSHT
    from draco_tpu_torch.synthesis.stream import SimulateSidereal
    from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedDishArray
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    device = torch.device(args.device)
    f0 = 299.792458 / 0.6
    tel = UnpolarisedDishArray(
        grid_ew=8, grid_ns=8, spacing_ew=7.0, spacing_ns=7.0, jitter=1.0, jitter_seed=1, latitude=45.0,
        dish_width=5.0, fwhm_factor=1.0, freq_lower=f0, freq_upper=f0, num_freq=1, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
    )
    sky = containers.Map(nside=nside, polarisation=False, freq=tel.frequencies, device=device)
    sky.map[:] = np.random.Generator(np.random.SFC64(SKY_SEED)).standard_normal(sky.map.shape)

    truth = fused_simulate_to_map(BeamTransfer(tel, nside=nside), sky.map[:], chunk=CHUNK)
    fused32 = fused_simulate_to_map(BeamTransfer(tel, nside=nside), sky.map[:].float(), chunk=CHUNK)

    def rel(got):
        return ((got.double() - truth).abs().max() / truth.abs().max()).item()

    two_float = WindowedSHT.lam_band_2f

    def hi_only(win, device=None):
        hi, lo = two_float(win, device)
        return hi, torch.zeros_like(lo)

    def single_float(win, device=None):
        hi = win.lam_band(torch.float32, device)
        return hi, torch.zeros(hi.shape, dtype=torch.bfloat16, device=hi.device)

    def run(task, params, setup, data):
        task.read_config(params)
        task.setup(*setup)
        return task.process(data)

    card = "cpu" if device.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"float32 fused map vs float64 fused map: {rel(fused32):.3e}", flush=True)
    streaming = {"streaming": True, "baseline_chunk": CHUNK}
    for name, table in (("two-float", two_float), ("hi only", hi_only), ("single-float", single_float)):
        WindowedSHT.lam_band_2f = table
        bt = BeamTransfer(tel, nside=nside)
        t0 = time.perf_counter()
        sstream = run(SimulateSidereal(), streaming, (bt,), sky)
        mmodes = run(MModeTransform(), {}, (tel,), sstream)
        dmap = run(DirtyMapMaker(), {"nside": nside, **streaming}, (bt,), mmodes).map[:]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        nra = sstream.vis.shape[-1]
        print(f"chain B with the {name} band table: map / {nra} vs float64 fused map {rel(dmap / nra):.3e} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
