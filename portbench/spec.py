"""Everything a cell is made of, found by the names in ``BENCHMARK.json``.

A workload names a configuration (its entry in ``configs`` gives the file)
and a traffic mix (``portbench/traffic/<traffic>.json``).  The traffic file
names its driver (``portbench/drivers/<driver>.py``, one kind of entry
into the program).  Each per-layer metric has a reader
(``portbench/layers/<metric>.py``).  Adding a cell is adding such files and
a ``workloads`` entry; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: ModuleType
    end_to_end: list = field(default_factory=list)  # [{"name", "unit", ...}]
    per_layer: list = field(default_factory=list)  # [({"name", "unit", ...}, reader module)]


def load_module(path: Path) -> ModuleType:
    """A module from a file whose name may hold dots (``device.idle_share.py``)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = f"portbench_file_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    # registered, so that a pipeline config can name the file's tasks by module path
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` at ``root``, with the files
    under ``root`` that its names point to."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}; it has {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    driver = load_module(root / "portbench" / "drivers" / f"{traffic['driver']}.py")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, {m["name"] for m in bench["end_to_end"]})]
    e2e_names = {m["name"] for m in e2e}
    layers = [
        (m, load_module(root / "portbench" / "layers" / f"{m['name']}.py"))
        for m in bench["per_layer"] if _reports(m, name, e2e_names)
    ]
    return Cell(name, int(w["chips"]), config, traffic, driver, e2e, layers)
