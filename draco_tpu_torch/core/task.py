"""Task base classes: the pipeline task lifecycle.

Port of ``draco_tpu.core.task``, the replacement of the reference's
``caput.pipeline.tasklib`` bases (``ContainerTask``, ``MPILoggedTask``,
``group_tasks``, ``tasklib.random.RandomTask``).

A task implements ``setup(*requires)``, ``process(*inputs) -> output`` and
optionally ``process_finish() -> output``; it signals exhaustion by raising
:class:`PipelineStopIteration`.  The YAML-driven
:class:`~draco_tpu_torch.core.pipeline.Manager` drives the lifecycle.

Under a mesh (a multi-process launch, :mod:`draco_tpu_torch.parallel`)
every process runs every task, and no task body receives a placed
(DTensor) dataset: DTensor has no sharding rule for advanced indexing,
slice assignment or the port's own CUDA kernels.  A task that works
channel by channel (``freq_local = True``) receives its rank's frequency
slab as an ordinary container, and its outputs are placed back from the
slabs; every other task receives the whole of its inputs, runs as on one
device, and the Manager places its products again when it routes them
(the JAX package's ``distribute``).  Outputs are saved by the leader, or
as one part file a process (``save_sharded``).
"""

from __future__ import annotations

import inspect
import logging
import os
from typing import ClassVar

import numpy as np
import torch

from ..device import resolve
from ..parallel import mesh as pmesh
from . import config
from .containers import ContainerBase


class PipelineStopIteration(Exception):
    """Raised by a task's process() to signal it has no more output."""


class PipelineRuntimeError(Exception):
    """Raised for invalid pipeline configurations or runtime failures."""


class _Exceptions:
    """Namespace mirroring ``caput.pipeline.exceptions``."""

    PipelineStopIteration = PipelineStopIteration
    PipelineRuntimeError = PipelineRuntimeError


exceptions = _Exceptions()


class MPILoggedTask(config.Reader):
    """Base task with a per-task logger.

    The name keeps the reference API (reference draco/core/io.py:10);
    there is no MPI: logging is process-local.
    """

    log_level = config.str_prop(None)

    def __init__(self):
        self._name = type(self).__name__
        self.log = logging.getLogger(f"draco_tpu_torch.{self._name}")
        self._initialised = True

    def read_config(self, config_dict, compare_keys=False):
        """Read config, then apply the configured log level (tasks are
        constructed before they are configured)."""
        super().read_config(config_dict, compare_keys=compare_keys)
        if self.log_level:
            self.log.setLevel(self.log_level.upper())

    @property
    def name(self) -> str:
        return self._name

    # Lifecycle hooks -------------------------------------------------------
    def setup(self, *args):  # pragma: no cover - trivial default
        """One-shot initialisation with `requires` resources."""

    def next(self, *inputs):
        """One process cycle (simple tasks: delegate to process)."""
        if hasattr(self, "process"):
            return self.process(*inputs)
        raise PipelineStopIteration()

    def finish(self):  # pragma: no cover - trivial default
        """Hook run when the pipeline retires the task."""


class ContainerTask(MPILoggedTask):
    """Task producing containers, with save-to-disk support.

    The reference base-task parameters (``save``, ``output_root`` /
    ``output_name``, ``tag``, ``versions`` provenance; reference
    examples/test.yaml:25-27, test/test_write_metadata.py:16-24).
    """

    save = config.bool_prop(False)
    # multi-process runs: one part file a process, with its slab of every
    # distributed dataset (parallel.multihost.save_sharded), in place of the
    # leader's whole file
    save_sharded = config.bool_prop(False)
    # lossy mantissa truncation of spec-marked datasets on save
    # (draco_tpu_torch.core.truncate)
    truncate = config.bool_prop(False)
    output_root = config.str_prop("")
    output_name = config.str_prop(None)
    tag = config.str_prop(None)
    save_versions = config.Property(default=False)
    save_config = config.bool_prop(True)
    # limit total outputs (None = unlimited)
    limit_outputs = config.int_prop(None)

    # set by the Manager
    _manager = None

    # True for a task whose process() treats every frequency channel on its
    # own, so that under a mesh splitting ``freq`` each rank runs it on its
    # own channels; its outputs' datasets without a freq axis must not
    # depend on the channels
    freq_local: ClassVar[bool] = False

    def _freq_slab_ok(self, nlocal: int) -> bool:
        """Whether process() can run on slabs of ``nlocal`` channels."""
        return True

    def __init__(self):
        super().__init__()
        self._count = 0
        self._save_count = 0
        self.done = False

    # -- lifecycle driven by the Manager ------------------------------------
    def next(self, *inputs):
        """Run one process cycle and post-process the output."""
        if self.limit_outputs is not None and self._count >= self.limit_outputs:
            raise PipelineStopIteration()
        if not hasattr(self, "process"):
            raise PipelineRuntimeError(f"Task {self.name} has no process() method")
        # untagged outputs inherit the tag of the first tagged input (the
        # reference base-task behaviour used for output file naming)
        self._input_tag = None
        for inp in inputs:
            if isinstance(inp, ContainerBase) and "tag" in inp.attrs:
                self._input_tag = inp.attrs["tag"]
                break
        mesh = pmesh.get_mesh()
        local = False
        if mesh is not None:
            inputs, local = self._task_inputs(inputs, mesh)
        output = self.process(*inputs)
        if local and output is not None:
            for out in output if isinstance(output, (tuple, list)) else (output,):
                if isinstance(out, ContainerBase):
                    out.from_freq_slabs(mesh)
        if output is not None:
            # count outputs, not calls: accumulators returning None must
            # not burn through limit_outputs
            self._count += 1
        return self._process_output(output)

    def _task_inputs(self, inputs, mesh) -> tuple[tuple, bool]:
        """(inputs as process() takes them, whether they are frequency slabs).

        A frequency-local task gets every container's slab when the mesh
        splits the freq axis of each of them; otherwise every task gets the
        whole of every container (a gather: each rank runs the same tasks
        in the same order, so the collectives match).
        """
        conts = [x for x in inputs if isinstance(x, ContainerBase)]
        if self.freq_local and conts:
            nloc = {c.freq_split(mesh) for c in conts}
            if None not in nloc and len(nloc) == 1 and self._freq_slab_ok(nloc.pop()):
                return tuple(x.freq_slab(mesh) if isinstance(x, ContainerBase) else x for x in inputs), True
        return tuple(x.gathered() if isinstance(x, ContainerBase) else x for x in inputs), False

    def finish(self):
        """Run process_finish if defined, returning its output."""
        if hasattr(self, "process_finish"):
            output = self.process_finish()
            return self._process_output(output)
        return None

    def _process_output(self, output):
        if output is None:
            return None
        outputs = output if isinstance(output, tuple) else (output,)
        for out in outputs:
            if isinstance(out, ContainerBase):
                self._annotate(out)
                if self.tag is not None:
                    out.attrs["tag"] = self.tag
                elif "tag" not in out.attrs and getattr(self, "_input_tag", None):
                    out.attrs["tag"] = self._input_tag
                if self.save:
                    self._save_output(out)
        return output

    def _annotate(self, out: ContainerBase):
        """Attach provenance history (config + versions) to a container."""
        if self._manager is not None:
            if self.save_config:
                out.history.setdefault("config", self._manager.config_yaml)
            versions = self._manager.versions
            if versions:
                out.history.setdefault("versions", versions)

    def _outfile_name(self, output: ContainerBase) -> str:
        # untagged outputs take a per-file sequence number, so that a
        # finish() output or two untagged outputs of one cycle do not
        # overwrite each other
        tag = output.attrs.get("tag", self._save_count)
        if self.output_name is not None:
            return self.output_name.format(output_root=self.output_root, tag=tag, count=self._save_count)
        base = self.output_root if self.output_root else f"{self.name}_"
        return f"{base}{tag}.h5"

    def _save_output(self, output: ContainerBase):
        from ..parallel import multihost

        fname = self._outfile_name(output)
        self._save_count += 1
        d = os.path.dirname(fname)
        multi = multihost.process_count() > 1
        if multi and self.save_sharded:
            # every process writes only its slab of each distributed dataset
            if d:
                os.makedirs(d, exist_ok=True)
            self.log.info("Saved shard part %s", multihost.save_sharded(output, fname))
            return
        placed = []
        if multi:
            # the leader writes the whole file; gathering is a collective,
            # so every process walks the datasets (gating the whole save on
            # the leader would leave it waiting in the gather)
            placed = [name for name, ds in output.datasets.items() if pmesh.is_placed(ds._data)]
            output.ensure_host()
        if multihost.is_leader():
            if d:
                os.makedirs(d, exist_ok=True)
            self.log.info("Saving output %s", fname)
            output.save(fname, truncate=self.truncate)
        # ensure_host replaced the placed datasets by the whole in place:
        # place them again for the product's consumers
        for name in placed:
            output.datasets[name].to_device()


# Reference-compat alias: the pre-migration name for the container task base.
SingleTask = ContainerTask


class RandomTask(MPILoggedTask):
    """Mixin providing seeded random state.

    ``self.rng`` is a numpy Generator for host-side draws (reference
    ``tasklib.random.RandomTask``, draco/synthesis/noise.py:48,166), and
    :meth:`generator` hands out ``torch.Generator``s for device-side draws,
    each seeded from the task seed and a counter.
    """

    seed = config.int_prop(None)

    _rng = None
    _generator_count = 0

    @property
    def local_seed(self) -> int:
        if self.seed is None:
            # Draw a fresh random seed once, then fix it for reproducibility
            self.seed = int(np.random.SeedSequence().entropy % (2**31))
            self.log.info("Generated random seed: %i", self.seed)
        return self.seed

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            self._rng = np.random.Generator(np.random.SFC64(self.local_seed))
        return self._rng

    def generator(self, device=None) -> torch.Generator:
        """A fresh ``torch.Generator`` on ``device`` (:func:`~draco_tpu_torch.device.resolve`),
        seeded from the task seed and the number of generators handed out."""
        self._generator_count += 1
        seed = np.random.SeedSequence([self.local_seed, self._generator_count]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=resolve(device)).manual_seed(int(seed))

    def row_seeds(self, n: int) -> list[int]:
        """Seeds of the ``n`` rows of one draw, for ``Generator.manual_seed``.

        Row ``i``'s seed comes from the task seed, the number of draws handed
        out (this call counts as one) and ``i`` alone, so a draw made row by
        row does not depend on how its rows are batched.
        """
        self._generator_count += 1
        return [
            int(np.random.SeedSequence([self.local_seed, self._generator_count, i]).generate_state(1, np.uint64)[0])
            for i in range(n)
        ]


def group_tasks(*tasks):
    """Create a task class chaining ``tasks``' process methods.

    Pipeline fusion as the reference uses it (reference
    draco/analysis/ringmapmaker.py:534, draco/analysis/transform.py:795):
    config properties of all member tasks are merged, `setup` feeds each
    member the arguments its signature accepts, and `process` pipes each
    output into the next member.
    """

    class GroupedTask(*tasks):
        _subtask_classes: ClassVar = tasks

        def __init__(self):
            super().__init__()
            self._subtasks = [cls() for cls in self._subtask_classes]

        def read_config(self, cfg, compare_keys=False):
            # the grouped class has the union of member properties, so
            # unknown keys are linted here; members read the merged config
            super().read_config(cfg, compare_keys=compare_keys)
            for t in self._subtasks:
                t.read_config(cfg, compare_keys=False)

        def setup(self, *args):
            for t in self._subtasks:
                params = inspect.signature(t.setup).parameters.values()
                npar = len([p for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])
                if npar == 0:
                    t.setup()  # zero-arg setups still initialise state
                else:
                    t.setup(*args[:npar])
                t._manager = self._manager

        def process(self, *inputs):
            out = inputs
            for t in self._subtasks:
                if not isinstance(out, tuple):
                    out = (out,)
                out = t.process(*out)
                if out is None:
                    return None
            return out

        def finish(self):
            """Retire each member in order, piping its final output through
            the rest of the chain (the members hold the accumulated state)."""
            out_final = None
            for i, t in enumerate(self._subtasks):
                out = t.finish()
                if out is None:
                    continue
                for t2 in self._subtasks[i + 1 :]:
                    if not isinstance(out, tuple):
                        out = (out,)
                    out = t2.process(*out)
                    if out is None:
                        break
                if out is not None:
                    out_final = self._process_output(out)
            return out_final

    GroupedTask.__name__ = "Grouped" + "".join(t.__name__ for t in tasks)
    return GroupedTask


class _TasklibBase:
    """Namespace mirror of ``caput.pipeline.tasklib.base``."""

    ContainerTask = ContainerTask
    MPILoggedTask = MPILoggedTask
    SingleTask = ContainerTask
    group_tasks = staticmethod(group_tasks)


class _TasklibRandom:
    RandomTask = RandomTask


class tasklib:  # noqa: N801 - mirrors the reference import surface
    """Compatibility namespace: ``from draco_tpu_torch.core.task import tasklib``."""

    base = _TasklibBase
    random = _TasklibRandom
