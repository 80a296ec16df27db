#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, at the cell's size.

    python3 portbench/control.py --workload <name> --program-seeds 1-12 --control-seeds 1-3 [--json FILE]

For each program seed: the first window call's inputs of that seed through
the program, compared with the float64 reference as a run compares them
(the lower reading is the largest).  For each control seed: the reference
itself put in the program's place, computed one precision below the
configuration's float32 (float32 with TF32 matmuls), compared the same
way (the upper reading is the smallest).  Set-up is made once for all
seeds.  Not part of any benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    rows = []
    all_seeds = sorted(set(args.program_seeds) | set(args.control_seeds))
    drv = cell.driver.Driver(cell.config, cell.traffic, all_seeds[0], device)
    for seed in all_seeds:
        drv.seed = seed
        row = {"seed": seed}
        if seed in args.program_seeds:
            row.update(drv.reading(program=True))
        if seed in args.control_seeds:
            row.update(drv.reading(program=False))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(device), "rows": rows}
    for key in sorted({k for r in rows for k in r if k != "seed" and not k.endswith("_s")}):
        values = [r[key] for r in rows if key in r]
        summary[key] = {"min": min(values), "max": max(values), "n": len(values)}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(summary, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"control: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
