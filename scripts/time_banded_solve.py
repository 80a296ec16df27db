#!/usr/bin/env python3
"""Time the regrid's banded Wiener solve (factor, then the two triangular
solves) at the port's shapes.

    python3 scripts/time_banded_solve.py                    # on the card, this checkout
    python3 scripts/time_banded_solve.py --repo DIR         # another checkout's package
    python3 scripts/time_banded_solve.py --device cpu --scale 16   # a rehearsal

The cases are what ``ops/regrid.py::band_wiener`` solves: a banded
positive-definite band [k, bw + 1, m] float32 (bw = 9, the Lanczos kernel
of width 5) against a complex right-hand side split into two real parts
[2, k, m]:

- ``dish``: the dish slice's regrid, k = 2017 rows, m = 2098 grid samples;
- ``cylinder``: the cylinder slice's, k = 1789, m = 2098;
- ``block``: one block of the stacking path's regrid, k = 57,240 rows
  (8 channels x 7155 stacks), m = 4146.

Each case times ``banded.banded_cholesky`` and
``banded.banded_cholesky_solve`` of the package found under ``--repo``
(default: this checkout) with CUDA events after one warm call, on a fresh
copy of the band each time, and prints one JSON line per case with the
seconds of each repetition and a checksum of the solution, so that two
checkouts run on one card can be compared.  ``--scale k`` divides k and m
by k.  The last line printed is the card's ``nvidia-smi`` name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

CASES = {"dish": (2017, 2098), "cylinder": (1789, 2098), "block": (57240, 4146)}
BW = 9


def band(k: int, m: int, device, seed: int):
    """A diagonally dominant (so positive-definite) band and a right-hand side."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    ab = torch.rand(k, BW + 1, m, generator=g, dtype=torch.float32, device=device) * 2 - 1
    ab[:, 0] = 2 * (BW + 1) + torch.rand(k, m, generator=g, device=device)
    for d in range(1, BW + 1):
        ab[:, d, m - d :] = 0.0
    return ab, torch.randn(2, k, m, generator=g, dtype=torch.float32, device=device)


def timed(fn, device):
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent),
                        help="checkout whose draco_tpu_torch is timed")
    parser.add_argument("--device", default="cuda", help="device to solve on")
    parser.add_argument("--scale", type=int, default=1, help="divide k and m by this")
    parser.add_argument("--reps", type=int, default=2, help="timed repetitions of each case")
    parser.add_argument("--cases", default=",".join(CASES), help="comma-separated subset of " + ", ".join(CASES))
    args = parser.parse_args()

    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    from draco_tpu_torch.ops import banded

    device = torch.device(args.device)
    for name in args.cases.split(","):
        k, m = (max(1, n // args.scale) for n in CASES[name])
        ab, rhs = band(k, m, device, seed=len(name))

        factor_s, solve_s, total = [], [], 0.0
        for rep in range(args.reps + 1):  # the first call warms up, untimed
            lb, t_factor = timed(lambda: banded.banded_cholesky(ab.clone(), BW), device)
            x, t_solve = timed(lambda: banded.banded_cholesky_solve(lb, rhs, BW), device)
            if rep:
                factor_s.append(t_factor)
                solve_s.append(t_solve)
            total = float(x.double().abs().sum())
            del lb, x
        print(json.dumps({"repo": args.repo, "case": name, "k": k, "m": m, "bw": BW, "factor_s": factor_s,
                          "solve_s": solve_s, "sum_abs_x": total}), flush=True)
        del ab, rhs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
    except FileNotFoundError:
        smi = ""
    print(smi.splitlines()[0] if smi else "nvidia-smi: none")
    return 0


if __name__ == "__main__":
    sys.exit(main())
