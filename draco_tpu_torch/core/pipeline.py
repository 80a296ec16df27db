"""YAML-driven pipeline manager and command line.

Port of ``draco_tpu.core.pipeline``, the replacement of
``caput.pipeline.Manager`` (reference usage: ``caput-pipeline run
config.yaml``, reference doc/tutorial.rst:166-168).  The YAML schema is the
JAX package's:

.. code-block:: yaml

    pipeline:
      tasks:
        - type: draco.synthesis.stream.SimulateSidereal
          requires: beamtransfer
          out: sstream
          params: {...}
        - type: draco.analysis.transform.MModeTransform
          in: sstream
          out: mmodes

``requires`` wires one-shot setup inputs, ``in``/``out`` wire per-cycle
dataflow by label, ``params`` bind onto the task's config Properties
(reference doc/tutorial.rst:108-145).  Scheduling is round-robin task
cycling with :class:`PipelineStopIteration` retiring tasks.

Task paths ``draco.X`` and ``draco_tpu.X`` translate to
``draco_tpu_torch.X`` before anything is imported, so a config written
for either package runs here without importing ``draco_tpu`` (or JAX); a
task that the port does not have yet raises and names itself.

``yaml`` is imported only to parse or write YAML text: a mapping runs
without it.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from ..parallel import mesh as pmesh
from . import config as config_mod
from .containers import ContainerBase
from .task import (
    ContainerTask,
    MPILoggedTask,
    PipelineRuntimeError,
    PipelineStopIteration,
)

logger = logging.getLogger(__name__)

# config path prefixes that name this package's modules
_TRANSLATED_PREFIXES = ("draco.", "draco_tpu.")


def _import_yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading or writing YAML text needs the pyyaml package") from e
    return yaml


def dump_config(config_dict) -> str:
    """YAML text of a config mapping; JSON (which YAML parsers read) when
    ``yaml`` is not installed."""
    try:
        import yaml
    except ImportError:
        return json.dumps(config_dict, indent=1, default=str)
    return yaml.safe_dump(config_dict, sort_keys=False)


def _as_list(val) -> list:
    if val is None:
        return []
    if isinstance(val, (list, tuple)):
        return list(val)
    return [val]


def _translate_task_path(path: str) -> str:
    """``draco.X`` and ``draco_tpu.X`` -> ``draco_tpu_torch.X``; other paths as written."""
    for prefix in _TRANSLATED_PREFIXES:
        if path.startswith(prefix):
            return "draco_tpu_torch." + path[len(prefix) :]
    return path


def _resolve_task_class(path: str):
    """Import a task class from its dotted path (translated first).

    A translated path that does not exist in this package names a task
    that is not ported yet: it raises, and never falls back to the JAX
    package.
    """
    target = _translate_task_path(path)
    mod_name, _, cls_name = target.rpartition(".")
    if not mod_name:
        raise PipelineRuntimeError(f"Cannot import task {path!r}: no module in the path")
    translated = target != path
    try:
        mod = importlib.import_module(mod_name)
    except ModuleNotFoundError as e:
        # only the module the path names (or a parent) being absent means
        # "not ported"; a missing dependency inside it is a real error
        if translated and e.name is not None and (mod_name + ".").startswith(e.name + "."):
            raise PipelineRuntimeError(_not_ported(path, target)) from e
        raise PipelineRuntimeError(f"Cannot import task {path!r}: {e}") from e
    except ImportError as e:
        raise PipelineRuntimeError(f"Cannot import task {path!r}: {e}") from e
    try:
        return getattr(mod, cls_name)
    except AttributeError as e:
        if translated:
            raise PipelineRuntimeError(_not_ported(path, target)) from e
        raise PipelineRuntimeError(f"Cannot import task {path!r}: {e}") from e


def _not_ported(path: str, target: str) -> str:
    return (
        f"task {path!r} is not ported to draco_tpu_torch yet (no {target}); "
        "ROADMAP.md lists the slices still to come"
    )


class _TaskRunner:
    """Book-keeping wrapper around one task instance in the pipeline."""

    def __init__(self, spec: dict, index: int, compare_keys: bool = False):
        self.spec = spec
        self.index = index
        self.type_path = spec["type"]
        self.cls = _resolve_task_class(self.type_path)
        self.requires = _as_list(spec.get("requires"))
        self.in_labels = _as_list(spec.get("in"))
        self.out_labels = _as_list(spec.get("out"))
        self.params = spec.get("params") or {}

        self.task = self.cls()
        self.task.read_config(self.params, compare_keys=compare_keys)

        self.queues: list[deque] = [deque() for _ in self.in_labels]
        self.requires_values: list[Any] = [None] * len(self.requires)
        self.requires_filled: list[bool] = [False] * len(self.requires)
        self.setup_done = False
        self.done = False
        self.finished = False
        # per-task wall-clock and call counts (`timing`)
        self.wall_time = 0.0
        self.n_calls = 0

    @property
    def name(self) -> str:
        return f"{self.type_path}[{self.index}]"

    def ready_for_setup(self) -> bool:
        return not self.setup_done and all(self.requires_filled)

    def can_process(self) -> bool:
        return self.setup_done and all(len(q) > 0 for q in self.queues)

    def is_source(self) -> bool:
        return len(self.in_labels) == 0


def _assert_finite_product(task_name: str, label: str, obj) -> None:
    """Raise PipelineRuntimeError if a routed product carries NaN/Inf."""

    def check(path, arr):
        arr = pmesh.unshard(arr)
        if isinstance(arr, torch.Tensor):
            if arr.is_floating_point() or arr.is_complex():
                bad = int((~torch.isfinite(arr)).sum())
            else:
                bad = 0
        else:
            a = np.asarray(arr)
            bad = int((~np.isfinite(a)).sum()) if a.dtype.kind in "fc" else 0
        if bad:
            raise PipelineRuntimeError(f"{task_name} -> '{label}'{path}: {bad} non-finite values")

    if hasattr(obj, "datasets"):
        for name, ds in obj.datasets.items():
            check(f"/{name}", ds[:])
    elif hasattr(obj, "shape"):
        check("", obj)


def _parse_mesh_cfg(cfg):
    """Validate `pipeline.mesh` and return (axes, dcn) or None.

    Syntax only, so that ``lint`` works anywhere; the sizes are checked
    against the launch by :meth:`Manager._build_mesh` at ``run``.
    """
    if cfg is None:
        return None
    if not isinstance(cfg, dict) or not cfg:
        raise config_mod.ConfigError(
            f"pipeline.mesh must be a non-empty mapping of axis name to size, got {cfg!r}"
        )
    axes = cfg.get("axes", None)
    dcn = cfg.get("dcn", None) if axes is not None else None
    if axes is None:
        axes = cfg  # shorthand: the mapping is the axes
    if not isinstance(axes, dict) or not axes:
        raise config_mod.ConfigError(f"pipeline.mesh.axes must be a non-empty mapping, got {axes!r}")
    for name, size in axes.items():
        if not isinstance(name, str) or not isinstance(size, int):
            raise config_mod.ConfigError(
                f"pipeline.mesh axes must map axis names to integer sizes, got {name!r}: {size!r}"
            )
        if size != -1 and size < 1:
            raise config_mod.ConfigError(
                f"pipeline.mesh axis {name!r} size must be a positive integer or -1 (fill), got {size}"
            )
    if sum(1 for s in axes.values() if s == -1) > 1:
        raise config_mod.ConfigError("pipeline.mesh allows at most one -1 (fill) axis size")
    if dcn is not None:
        if not isinstance(dcn, dict):
            raise config_mod.ConfigError(
                f"pipeline.mesh.dcn must be a mapping of axis name to multi-slice factor, got {dcn!r}"
            )
        for name, fac in dcn.items():
            if name not in axes:
                raise config_mod.ConfigError(f"pipeline.mesh.dcn names unknown axis {name!r}")
            if not isinstance(fac, int) or fac < 1:
                raise config_mod.ConfigError(
                    f"pipeline.mesh.dcn factor for {name!r} must be a positive integer, got {fac!r}"
                )
            if axes[name] != -1 and axes[name] % fac != 0:
                raise config_mod.ConfigError(
                    f"pipeline.mesh.dcn factor {fac} does not divide axis {name!r} size {axes[name]}"
                )
    return (dict(axes), dict(dcn) if dcn else None)


class Manager(config_mod.Reader):
    """Round-robin task scheduler driven by a YAML config (or its mapping)."""

    def __init__(self, config_dict: dict, config_yaml: str | None = None):
        if not isinstance(config_dict, dict):
            raise config_mod.ConfigError(
                f"Pipeline config must be a mapping (got {type(config_dict).__name__}: empty file?)"
            )
        self.config_dict = config_dict
        # the provenance text saved with every output
        self.config_yaml = config_yaml if config_yaml is not None else dump_config(config_dict)
        pipeline_cfg = config_dict.get("pipeline")
        if pipeline_cfg is None:
            raise config_mod.ConfigError("Config has no 'pipeline' section")
        task_specs = pipeline_cfg.get("tasks")
        if not task_specs:
            raise config_mod.ConfigError("Pipeline has no tasks")
        self.task_specs = task_specs
        # `cluster:` — the reference YAML's batch-queue block; `lint`
        # checks it, `queue` renders it as a job script, `run` ignores it
        self.cluster = config_dict.get("cluster") or {}
        self.versions = self._collect_versions(pipeline_cfg.get("save_versions", []))
        self._configure_logging(pipeline_cfg.get("logging"))
        self.products: dict[str, list] = {}
        # `timing: true` logs a per-task wall-clock summary after the run;
        # `profile: <dir>` writes a torch.profiler trace of the run there
        self.timing = bool(pipeline_cfg.get("timing", False))
        self.profile_dir = pipeline_cfg.get("profile")
        # `validate_finite: true` checks every routed product for NaN/Inf
        # after the producing task and fails naming the task and dataset
        self.validate_finite = bool(pipeline_cfg.get("validate_finite", False))
        # `retain_products`: what run() keeps (and returns) in memory.
        # "all" (default) every routed product; "final" only labels no
        # task consumes; "none" nothing (long chains write with `save:`)
        self.retain_products = str(pipeline_cfg.get("retain_products", "all"))
        if self.retain_products not in ("all", "final", "none"):
            raise config_mod.ConfigError(
                f"pipeline.retain_products must be one of 'all'/'final'/'none', got {self.retain_products!r}"
            )
        # `mesh:` places the run's containers over a process mesh, so the
        # production (freq x m) layout is chosen in YAML:
        #
        #   pipeline:
        #     mesh:
        #       axes: {freq: 2, m: -1}   # -1 fills the remaining processes
        #       dcn: {freq: 2}           # optional factor across nodes
        #
        # (shorthand: `mesh: {freq: 2, m: 4}`)
        self.mesh_cfg = _parse_mesh_cfg(pipeline_cfg.get("mesh"))
        # `distribute: true` places every routed container over the mesh as
        # it is produced, so each process holds its block of every
        # distributed axis (the reference's per-rank MPIArray slabs); on by
        # default under a mesh
        self.distribute_products = bool(pipeline_cfg.get("distribute", self.mesh_cfg is not None))
        self.task_timing: dict[str, dict] = {}

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_yaml_str(cls, yaml_str: str) -> "Manager":
        return cls(_import_yaml().safe_load(yaml_str), config_yaml=yaml_str)

    @classmethod
    def from_yaml_file(cls, path: str) -> "Manager":
        with open(path) as f:
            text = f.read()
        return cls.from_yaml_str(text)

    # -- helpers ---------------------------------------------------------------
    @staticmethod
    def _collect_versions(modules) -> dict[str, str]:
        versions = {}
        for mod_name in _as_list(modules):
            try:
                mod = importlib.import_module(mod_name)
                versions[mod_name] = getattr(mod, "__version__", "unknown")
            except ImportError:
                versions[mod_name] = "unavailable"
        return versions

    @staticmethod
    def _configure_logging(log_cfg):
        if log_cfg is None:
            return
        if isinstance(log_cfg, str):
            log_cfg = {"root": log_cfg}

        def as_level(v):
            # logging accepts ints (yaml: 20) and names (yaml: info)
            return v if isinstance(v, int) else str(v).upper()

        root = log_cfg.get("root")
        if root is not None:
            logging.basicConfig(level=as_level(root))
        for name, level in log_cfg.items():
            if name != "root":
                logging.getLogger(name).setLevel(as_level(level))

    # -- validation ------------------------------------------------------------
    def lint(self) -> list[str]:
        """Statically validate the pipeline config; returns the problems.

        The equivalent of ``caput-pipeline lint`` (reference CI,
        .github/workflows/main.yaml:90-92).
        """
        problems = []
        produced = set()
        for i, spec in enumerate(self.task_specs):
            if "type" not in spec:
                problems.append(f"task #{i} has no 'type'")
                continue
            try:
                runner = _TaskRunner(spec, i, compare_keys=True)
            except (PipelineRuntimeError, config_mod.ConfigError) as e:
                problems.append(str(e))
                continue
            produced.update(runner.out_labels)
        for i, spec in enumerate(self.task_specs):
            for label in _as_list(spec.get("requires")) + _as_list(spec.get("in")):
                if label not in produced:
                    problems.append(f"task #{i} consumes label {label!r} which no task produces")
        problems.extend(self._lint_cluster())
        return problems

    _CLUSTER_KEYS = {
        "nodes", "ppn", "time", "directory", "venv", "name", "queue",
        "account", "queue_sys", "pernode", "ompnum", "mem",
    }

    def _lint_cluster(self) -> list[str]:
        """Validate the ``cluster:`` stanza (batch-queue job descriptor)."""
        if not isinstance(self.cluster, dict):
            return [f"cluster: must be a mapping, got {self.cluster!r}"]
        problems = [f"cluster: unknown key {key!r}" for key in self.cluster if key not in self._CLUSTER_KEYS]
        for key in ("nodes", "ppn", "pernode", "ompnum"):
            v = self.cluster.get(key)
            if v is not None and (not isinstance(v, int) or v < 1):
                problems.append(f"cluster.{key} must be a positive integer, got {v!r}")
        t = self.cluster.get("time")
        if t is not None and not isinstance(t, (int, float)) and not (
            isinstance(t, str) and t.replace(":", "").isdigit()
        ):
            problems.append(f"cluster.time must be minutes or HH:MM:SS, got {t!r}")
        return problems

    def jobscript(self, config_path: str) -> str:
        """Render the ``cluster:`` stanza as a SLURM launch script.

        One process per card: ``nodes`` nodes of ``ppn`` processes each
        (the reference's ranks-per-node), every process seeing only its own
        card (``CUDA_VISIBLE_DEVICES=$SLURM_LOCALID``), the ranks wired
        through the ``DRACO_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}``
        contract (:mod:`draco_tpu_torch.parallel.multihost`).  The JAX
        package launches one process per host, which drives all its chips,
        and ignores ``ppn``.
        """
        import shlex

        c = self.cluster
        nodes = int(c.get("nodes", 1))
        ppn = int(c.get("ppn", 1))
        t = c.get("time", 60)
        walltime = f"{int(t) // 60:d}:{int(t) % 60:02d}:00" if isinstance(t, (int, float)) else str(t)  # caput: minutes
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name={c.get('name', 'draco-tpu-torch')}",
            f"#SBATCH --nodes={nodes}",
            f"#SBATCH --ntasks-per-node={ppn}",
            f"#SBATCH --gpus-per-node={ppn}",
            f"#SBATCH --time={walltime}",
        ]
        if c.get("queue"):
            lines.append(f"#SBATCH --partition={c['queue']}")
        if c.get("account"):
            lines.append(f"#SBATCH --account={c['account']}")
        if c.get("mem"):
            lines.append(f"#SBATCH --mem={c['mem']}")
        if c.get("directory"):
            lines.append(f"#SBATCH --chdir={shlex.quote(str(c['directory']))}")
        lines += ["", "# one process per card: each sees only its own"]
        if c.get("venv"):
            lines.append(f"source {shlex.quote(str(c['venv']))}/bin/activate")
        cfg = shlex.quote(os.path.abspath(config_path))
        lines += [
            'head=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)',
            'export DRACO_TPU_COORDINATOR="$head:8476"',
            'export DRACO_TPU_NUM_PROCESSES="$SLURM_NTASKS"',
            "srun --export=ALL bash -c "
            "'CUDA_VISIBLE_DEVICES=$SLURM_LOCALID DRACO_TPU_PROCESS_ID=$SLURM_PROCID "
            f"python -m draco_tpu_torch run {cfg}'",
            "",
        ]
        return "\n".join(lines)

    def _build_mesh(self):
        """The configured mesh over the launch's processes (one card each).

        ``-1`` fills the processes the fixed sizes leave; a mesh that does
        not cover the launch exactly raises ``ConfigError`` naming both
        counts.  A mesh of one process in a run with no process group
        splits nothing, and the run goes unsharded.
        """
        if self.mesh_cfg is None:
            return None
        from ..parallel import multihost

        axes, dcn = self.mesh_cfg
        world = multihost.process_count()
        sizes = dict(axes)
        fixed = int(np.prod([n for n in sizes.values() if n != -1]))
        for name, n in sizes.items():
            if n == -1:
                if world % fixed:
                    raise config_mod.ConfigError(
                        f"pipeline.mesh: the fixed axis sizes ({fixed} processes) do not divide "
                        f"the {world} processes of the launch"
                    )
                sizes[name] = world // fixed
        total = int(np.prod(list(sizes.values())))
        if total != world:
            raise config_mod.ConfigError(
                f"pipeline.mesh covers {total} processes but the launch has {world} (one card each)"
            )
        for name, fac in (dcn or {}).items():
            if sizes[name] % fac:
                raise config_mod.ConfigError(
                    f"pipeline.mesh.dcn factor {fac} does not divide the resolved size {sizes[name]} of axis {name!r}"
                )
        if not torch.distributed.is_initialized():
            return None
        names = tuple(sizes)
        # with no dcn factors the hybrid layout is the plain row-major grid
        dcn_shape = tuple((dcn or {}).get(n, 1) for n in names)
        return pmesh.make_hybrid_mesh(tuple(sizes[n] // f for n, f in zip(names, dcn_shape)), dcn_shape, names)

    # -- execution ---------------------------------------------------------------
    def run(self) -> dict[str, list]:
        """Execute the pipeline; returns the products routed by label.

        With ``pipeline.profile: <dir>`` the run is traced by
        ``torch.profiler`` (the card's kernels too, where there is one)
        and the trace written to ``<dir>/trace.json``; with
        ``pipeline.timing: true`` a per-task wall-clock summary is logged.
        ``self.task_timing`` holds each task's wall time and call count
        (with the card synchronised at the end of every call).
        """
        mesh = self._build_mesh()
        if mesh is not None:
            logger.info(
                "pipeline mesh %s over %s",
                dict(zip(mesh.mesh_dim_names, mesh.shape)),
                torch.distributed.get_backend(),
            )
        with pmesh.use_mesh(mesh):
            return self._run_traced()

    def _run_traced(self) -> dict[str, list]:
        if not self.profile_dir:
            return self._run()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            products = self._run()
        os.makedirs(str(self.profile_dir), exist_ok=True)
        prof.export_chrome_trace(os.path.join(str(self.profile_dir), "trace.json"))
        return products

    def _run(self) -> dict[str, list]:
        # compare_keys: a typo'd param silently falling back to the class
        # default would give a wrong result, so run() checks keys as lint does
        runners = [_TaskRunner(spec, i, compare_keys=True) for i, spec in enumerate(self.task_specs)]

        def timed(runner, fn, *args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                # the card runs asynchronously: a task's kernels count in its own time
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                runner.wall_time += time.perf_counter() - t0
                runner.n_calls += 1

        # index consumers by label
        consumers_req: dict[str, list[tuple[_TaskRunner, int]]] = {}
        consumers_in: dict[str, list[tuple[_TaskRunner, int]]] = {}
        for r in runners:
            for j, label in enumerate(r.requires):
                consumers_req.setdefault(label, []).append((r, j))
            for j, label in enumerate(r.in_labels):
                consumers_in.setdefault(label, []).append((r, j))
            if isinstance(r.task, (ContainerTask, MPILoggedTask)):
                r.task._manager = self

        producers: dict[str, list[_TaskRunner]] = {}
        for r in runners:
            for label in r.out_labels:
                producers.setdefault(label, []).append(r)

        # a consumed label with no producer would retire its consumer on
        # the first round with zero items: a silent wrong-result run
        for r in runners:
            missing = [lab for lab in (*r.requires, *r.in_labels) if lab not in producers]
            if missing:
                raise PipelineRuntimeError(
                    f"{r.name}: consumes labels {missing} that no task produces (check the 'out' lists)"
                )

        consumed_labels = set(consumers_req) | set(consumers_in)

        def route(runner: _TaskRunner, output):
            if output is None:
                return
            outs = output if isinstance(output, tuple) and len(runner.out_labels) > 1 else (output,)
            # extra outputs beyond the labelled ones are dropped (the
            # LoadBeamTransfer convention: setup returns (tel, bt, feeds)
            # against `out: [tel, bt]`)
            if len(runner.out_labels) > 0 and len(outs) > len(runner.out_labels):
                outs = outs[: len(runner.out_labels)]
            if len(runner.out_labels) not in (0, len(outs)):
                raise PipelineRuntimeError(
                    f"{runner.name} produced {len(outs)} outputs for {len(runner.out_labels)} labels"
                )
            for label, out in zip(runner.out_labels, outs):
                if self.distribute_products and pmesh.get_mesh() is not None and isinstance(out, ContainerBase):
                    # each process keeps its block of the product
                    out.to_device()
                if self.validate_finite:
                    _assert_finite_product(runner.name, label, out)
                if self.retain_products == "all" or (
                    self.retain_products == "final" and label not in consumed_labels
                ):
                    self.products.setdefault(label, []).append(out)
                for cons, j in consumers_req.get(label, []):
                    if not cons.requires_filled[j]:
                        cons.requires_values[j] = out
                        cons.requires_filled[j] = True
                for cons, j in consumers_in.get(label, []):
                    cons.queues[j].append(out)

        def upstream_done(runner: _TaskRunner) -> bool:
            return all(p.finished for label in runner.in_labels for p in producers.get(label, []))

        def retire(runner: _TaskRunner):
            if runner.finished:
                return
            leftover = sum(len(q) for q in runner.queues)
            if leftover:
                logger.warning(
                    "%s retiring with %d unconsumed queued input item(s): "
                    "its in-label producers emitted unequal item counts",
                    runner.name,
                    leftover,
                )
            runner.done = True
            try:
                route(runner, timed(runner, runner.task.finish))
            finally:
                runner.finished = True

        # Main round-robin loop
        while not all(r.finished for r in runners):
            progress = False
            for r in runners:
                if r.finished:
                    continue
                # Setup when requires are satisfied; a non-None setup return
                # is routed to the out labels (the LoadBeamTransfer
                # convention, reference test/pipe_config.yaml:16-19)
                if r.ready_for_setup():
                    # setup sees whole containers, as every task body does
                    requires = [v.gathered() if isinstance(v, ContainerBase) else v for v in r.requires_values]
                    setup_ret = timed(r, r.task.setup, *requires)
                    r.setup_done = True
                    if setup_ret is not None:
                        route(r, setup_ret)
                    progress = True
                if not r.setup_done:
                    # waiting on requires; an error once every producer of
                    # an unfilled one has finished
                    unmet = [lab for j, lab in enumerate(r.requires) if not r.requires_filled[j]]
                    if unmet and all(p.finished for lab in unmet for p in producers.get(lab, [])):
                        raise PipelineRuntimeError(f"{r.name}: requires {unmet} never produced")
                    continue
                if r.is_source():
                    try:
                        route(r, timed(r, r.task.next))
                    except PipelineStopIteration:
                        retire(r)
                    progress = True
                else:
                    while r.can_process():
                        items = [q.popleft() for q in r.queues]
                        try:
                            route(r, timed(r, r.task.next, *items))
                            progress = True
                        except PipelineStopIteration:
                            retire(r)
                            progress = True
                            break
                    if not r.finished and upstream_done(r) and not r.can_process():
                        retire(r)
                        progress = True
            if not progress:
                stuck = [r.name for r in runners if not r.finished]
                raise PipelineRuntimeError(f"Pipeline deadlocked; unfinished tasks: {stuck}")

        self.task_timing = {r.name: {"wall": r.wall_time, "calls": r.n_calls} for r in runners}
        if self.timing:
            total = sum(r.wall_time for r in runners) or 1.0
            logger.info("Per-task wall-clock summary:")
            for r in sorted(runners, key=lambda x: -x.wall_time):
                logger.info(
                    f"  {r.name:<60s} {r.wall_time:9.3f}s "
                    f"({100 * r.wall_time / total:5.1f}%) in {r.n_calls} calls"
                )
        return self.products


def run(config_path: str) -> dict[str, list]:
    """Run a pipeline YAML file (CLI: ``python -m draco_tpu_torch run``)."""
    return Manager.from_yaml_file(config_path).run()


def lint(config_path: str) -> list[str]:
    """Lint a pipeline YAML file (CLI: ``python -m draco_tpu_torch lint``)."""
    return Manager.from_yaml_file(config_path).lint()


def main(argv=None) -> int:
    """Command line interface: ``python -m draco_tpu_torch {run,lint,queue,verify,makeproducts,makesky} ...``.

    ``run`` and ``lint`` mirror the reference's ``caput-pipeline`` (``run``
    joins the process group of a multi-process launch first);
    ``queue`` prints the ``cluster:`` stanza as a SLURM script (exit 1 if
    the stanza fails lint);
    ``verify`` runs a config several times and demands identical products
    (exit 1 and ``VERIFY FAILED`` otherwise);
    ``makeproducts`` and ``makesky`` re-provide ``drift-makeproducts`` and
    ``cora-makesky`` (reference doc/tutorial.rst:78-119).  ``--platform
    cpu`` makes the CPU the process default device (the card otherwise).
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="draco_tpu_torch",
        description="Run/lint a draco_tpu_torch pipeline; generate telescope products",
    )
    parser.add_argument(
        "--platform",
        default=None,
        choices=("cpu",),
        help="run on the CPU (default: the first CUDA card)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="run a pipeline config")
    p_run.add_argument("configfile")
    p_lint = sub.add_parser("lint", help="validate a pipeline config")
    p_lint.add_argument("configfile", nargs="+")
    p_queue = sub.add_parser("queue", help="render the config's cluster: stanza as a SLURM launch script")
    p_queue.add_argument("configfile")
    p_queue.add_argument("--output", default=None, help="write the job script here (default: stdout)")
    p_verify = sub.add_parser(
        "verify", help="run a pipeline config several times and check that its products are reproducible"
    )
    p_verify.add_argument("configfile")
    p_verify.add_argument("--runs", type=int, default=2)
    p_verify.add_argument(
        "--rtol", type=float, default=0.0, help="relative tolerance (0 = bitwise reproducibility)"
    )
    p_prod = sub.add_parser(
        "makeproducts",
        help="generate beam-transfer products from a product config (drift-makeproducts equivalent)",
    )
    p_prod.add_argument("configfile", help="product config YAML or directory")
    p_prod.add_argument("--regen", action="store_true", help="force regeneration")
    p_prod.add_argument("--output", default=None, help="directory to save products into")
    p_sky = sub.add_parser("makesky", help="generate a Gaussian sky map HDF5 (cora-makesky equivalent)")
    p_sky.add_argument(
        "model", choices=["synchrotron", "pointsource", "freefree", "galacticfreefree", "foreground", "21cm"]
    )
    p_sky.add_argument("output", help="output HDF5 map file")
    p_sky.add_argument("--nside", type=int, default=64)
    p_sky.add_argument("--freq-start", type=float, default=400.0)
    p_sky.add_argument("--freq-end", type=float, default=500.0)
    p_sky.add_argument("--nfreq", type=int, default=32)
    p_sky.add_argument("--seed", type=int, default=0)
    p_sky.add_argument("--pol", action="store_true", help="full-Stokes maps")
    p_sky.add_argument("--lmax", type=int, default=None)

    args = parser.parse_args(argv)

    if args.command == "queue":
        man = Manager.from_yaml_file(args.configfile)
        problems = man._lint_cluster()
        for p in problems:
            print(f"LINT: {p}")
        if problems:
            return 1
        script = man.jobscript(args.configfile)
        if args.output:
            with open(args.output, "w") as f:
                f.write(script)
            os.chmod(args.output, 0o755)
            print(f"job script written to {args.output}")
        else:
            print(script, end="")
        return 0

    from ..device import default_device

    with default_device(args.platform):
        if args.command == "run":
            # a multi-process launch configures DRACO_TPU_COORDINATOR /
            # _NUM_PROCESSES / _PROCESS_ID; a plain run is untouched
            from ..parallel import multihost

            joined = multihost.initialize()
            try:
                run(args.configfile)
            finally:
                if joined:
                    torch.distributed.destroy_process_group()
            return 0
        if args.command == "verify":
            from ..parallel.validate import DeterminismError, check_pipeline_determinism

            with open(args.configfile) as f:
                cfg_text = f.read()
            try:
                summary = check_pipeline_determinism(cfg_text, runs=args.runs, rtol=args.rtol)
            except DeterminismError as e:
                print(f"VERIFY FAILED: {e}")
                return 1
            print(
                f"verify ok: {summary['products']} product labels, "
                f"{summary['arrays']} arrays reproducible over {args.runs} runs"
            )
            return 0
        if args.command == "makeproducts":
            from ..telescope.manager import ProductManager

            man = ProductManager.from_config(args.configfile)
            man.generate(regen=args.regen)
            out_dir = args.output or man.directory
            if out_dir:
                man.save(out_dir)
                print(f"products written to {out_dir}")
            return 0
        if args.command == "makesky":
            from ..synthesis.skymodel import make_sky

            m = make_sky(
                model=args.model,
                nside=args.nside,
                nfreq=args.nfreq,
                freq_start=args.freq_start,
                freq_end=args.freq_end,
                seed=args.seed,
                pol=args.pol,
                lmax=args.lmax,
            )
            m.save(args.output)
            print(f"{args.model} map written to {args.output}")
            return 0
        problems = []
        for f in args.configfile:
            problems.extend(lint(f))
    for p in problems:
        print(f"LINT: {p}")
    return 1 if problems else 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
