#!/usr/bin/env python3
"""Run one cell of the benchmark of ``draco_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with an NVIDIA card.  Set-up
builds the cell's driver (the program's state, a warm-up call on the
cell's own shapes); the window then runs whole calls until ``--seconds``
have passed and ends with the last call.  The program builds its CUDA
kernels on first use into ``draco_tpu_torch/_build/`` inside the checkout,
so only a checkout's first run builds them: ``setup_s`` holds that build,
and the result records it apart as ``build_s``.  With ``--trace 0`` the result
line carries the cell's end-to-end metrics; with ``--trace 1`` the window
runs under ``torch.profiler`` and the line carries the per-layer metrics
instead, with the device's busy time and a breakdown.  After the window
the program's state is freed and the plain reference recomputes a sample
of the window's outputs: ``correct`` says whether each compared number is
within its limit.  Each number and its limit are the last lines on
standard error and the last key of the result.

The last line on standard output is the result, one JSON object.  The run
exits non-zero and prints no result without a CUDA card, with fewer
cards than the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "draco_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> tuple[dict, list]:
    """One run of ``cell``: (result without ``correct``, [(name, value, limit)])."""
    import torch

    from portbench import trace as tracing

    drv = cell.driver.Driver(cell.config, cell.traffic, seed, device)
    marks = {}
    prof = span = None

    def on_start():
        nonlocal prof, span
        marks["setup_s"] = process_age_s()
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
            span = record_function(tracing.WINDOW)
            span.__enter__()
        marks["t0"] = time.perf_counter()

    def on_end():
        marks["t1"] = time.perf_counter()
        if trace:
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)

    calls, units, call_s = drv.run_window(seconds, on_start, on_end)
    setup_s, window_s = marks["setup_s"], marks["t1"] - marks["t0"]
    from draco_tpu_torch import _build

    build_s = sum(_build.build_seconds.values())  # nvcc in this process: 0 once the checkout has built
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    # a call that fails raises and ends the run, so a run that prints has none failed
    result = {"attempted": calls, "failed": 0, "metrics": {}, "device": dev, "build_s": build_s}
    if trace:
        tr = tracing.from_profile(prof, {s for _, reader in cell.per_layer for s in getattr(reader, "SPANS", ())})
        del prof
        dev["busy_s"] = tracing.busy_s(tr)
        dev["window_s"] = tr.window_s
        ctx = {"trace": tr, "calls": calls}
        for metric, reader in cell.per_layer:
            value = reader.read(ctx)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        result["breakdown"] = tracing.breakdown(tr)
    else:
        e2e = {"channels_per_s": units / window_s, "peak_gib": peak / 2**30, "setup_s": setup_s}
        for metric in cell.end_to_end:
            result["metrics"][metric["name"]] = {"value": e2e[metric["name"]], "unit": metric["unit"]}
    drv.release()
    t1 = time.perf_counter()
    checks = drv.check()
    print(f"portbench: {cell.name} set-up {setup_s!r} s (kernel build {build_s!r} s), window {window_s!r} s "
          f"({calls} calls: first {call_s[0]!r} s, median {sorted(call_s)[len(call_s) // 2]!r} s, "
          f"last {call_s[-1]!r} s), reduction and release {t1 - marks['t1']:.2f} s, "
          f"check {time.perf_counter() - t1:.2f} s", file=sys.stderr)
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 3
    correct = bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    line = {"correct": correct, **result, "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
