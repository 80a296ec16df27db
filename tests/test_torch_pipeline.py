"""The port's pipeline Manager and CLI: the cases of ``tests/test_pipeline.py``
on draco_tpu_torch, its task-path translation, and its command line.

The Manager runs here on the CPU (the process default device is set to it
for every test).  Products written by ``makeproducts`` load in both
packages.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from draco_tpu.telescope import BeamTransfer as JBeamTransfer
from draco_tpu_torch.core import config, containers
from draco_tpu_torch.core.pipeline import Manager, PipelineRuntimeError, _resolve_task_class, main
from draco_tpu_torch.core.task import ContainerTask, PipelineStopIteration, RandomTask, group_tasks
from draco_tpu_torch.device import default_device
from draco_tpu_torch.telescope import BeamTransfer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


class EmitNumbers(ContainerTask):
    """Source task emitting a few small containers."""

    n_emit = config.Property(proptype=int, default=3)

    def process(self):
        if self._count >= self.n_emit:
            raise PipelineStopIteration()
        c = containers.FrequencyStack(freq=np.array([400.0, 500.0]))
        c.stack[:] = float(self._count)
        c.attrs["tag"] = f"item{self._count}"
        return c


class AddOffset(ContainerTask):
    offset = config.Property(proptype=float, default=0.0)

    def setup(self, base):
        self.base = base.stack[:].clone()

    def process(self, item):
        out = item.copy()
        out.stack[:] = item.stack[:] + self.offset + self.base
        return out


class Accumulate(ContainerTask):
    def __init__(self):
        super().__init__()
        self.total = 0.0

    def process(self, item):
        self.total += float(item.stack[:][0])

    def process_finish(self):
        c = containers.FrequencyStack(freq=np.array([400.0, 500.0]))
        c.stack[:] = self.total
        c.attrs["tag"] = "sum"
        return c


class EmitNaN(ContainerTask):
    def process(self):
        if self._count:
            raise PipelineStopIteration()
        c = containers.FrequencyStack(freq=np.array([400.0, 500.0]))
        c.stack[:] = float("nan")
        return c


def _total(products):
    return float(products["total"][-1].stack[:][0])


def test_pipeline_run_wiring():
    cfg = """
pipeline:
  tasks:
    - type: tests.test_torch_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 4
    - type: tests.test_torch_pipeline.EmitNumbers
      out: base
      params:
        n_emit: 1
    - type: tests.test_torch_pipeline.AddOffset
      requires: base
      in: nums
      out: shifted
      params:
        offset: 10.0
    - type: tests.test_torch_pipeline.Accumulate
      in: shifted
      out: total
"""
    products = Manager.from_yaml_str(cfg).run()
    assert len(products["nums"]) == 4 and len(products["shifted"]) == 4
    # base emits value 0; shifted values are 10, 11, 12, 13 -> total 46
    assert _total(products) == 46.0


def test_pipeline_save_and_history(tmp_path):
    cfg = f"""
pipeline:
  save_versions:
    - numpy
  tasks:
    - type: tests.test_torch_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 1
        save: true
        output_name: "{tmp_path}/out_{{tag}}.h5"
"""
    Manager.from_yaml_str(cfg).run()
    loaded = containers.ContainerBase.from_file(str(tmp_path / "out_item0.h5"))
    assert "EmitNumbers" in loaded.history["config"]
    assert "numpy" in loaded.history["versions"]


def test_config_provenance_with_and_without_yaml(monkeypatch):
    import yaml

    cfg = {"pipeline": {"tasks": [{"type": "tests.test_torch_pipeline.EmitNumbers", "out": "nums"}]}}
    with_yaml = Manager(cfg).config_yaml
    assert with_yaml == yaml.safe_dump(cfg, sort_keys=False)
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml now raises ImportError
    without = Manager(cfg)
    assert json.loads(without.config_yaml) == cfg
    assert without.run()["nums"]  # a mapping runs without yaml
    with pytest.raises(ImportError, match="pyyaml"):
        Manager.from_yaml_str("pipeline: {}")
    monkeypatch.undo()
    assert yaml.safe_load(without.config_yaml) == cfg  # the JSON text reads as YAML


def test_lint_catches_bad_labels_and_params():
    cfg = """
pipeline:
  tasks:
    - type: tests.test_torch_pipeline.AddOffset
      in: missing_label
      params:
        bogus_param: 1
"""
    problems = Manager.from_yaml_str(cfg).lint()
    assert any("missing_label" in p for p in problems)
    assert any("bogus_param" in p for p in problems)


@pytest.mark.parametrize(
    "path,module",
    [
        ("draco.core.io.LoadMaps", "draco_tpu_torch.core.io"),
        ("draco_tpu.analysis.transform.MModeTransform", "draco_tpu_torch.analysis.transform"),
        ("draco.analysis.sidereal.SiderealRegridder", "draco_tpu_torch.analysis.sidereal"),
        ("draco_tpu.telescope.roundtrip.SimulateAndMap", "draco_tpu_torch.telescope.roundtrip"),
        ("draco_tpu_torch.analysis.mapmaker.DirtyMapMaker", "draco_tpu_torch.analysis.mapmaker"),
        ("draco.analysis.transform.CollateProducts", "draco_tpu_torch.analysis.transform"),
        ("draco.analysis.calibration.ApplyGain", "draco_tpu_torch.analysis.calibration"),
        ("draco.synthesis.noise.SampleNoise", "draco_tpu_torch.synthesis.noise"),
        ("draco_tpu.synthesis.gain.RandomSiderealGains", "draco_tpu_torch.synthesis.gain"),
        ("draco_tpu.synthesis.skymodel.GenerateGaussianSky", "draco_tpu_torch.synthesis.skymodel"),
        ("draco.synthesis.mockcatalog.MockCatalogGenerator", "draco_tpu_torch.synthesis.mockcatalog"),
    ],
)
def test_task_path_translation(path, module):
    assert _resolve_task_class(path).__module__ == module


@pytest.mark.parametrize("example", ["simulate.yaml", "chime_scale.yaml"])
def test_every_task_of_the_simulation_examples_resolves(example):
    """Every task of the JAX package's simulation configs has a port."""
    import yaml

    with open(os.path.join(ROOT, "examples", example)) as f:
        tasks = yaml.safe_load(f)["pipeline"]["tasks"]
    for spec in tasks:
        assert _resolve_task_class(spec["type"]).__module__.startswith("draco_tpu_torch."), spec["type"]


@pytest.mark.parametrize(
    "path", ["draco.analysis.flagging.RFIMask", "draco_tpu.analysis.transform.GenerateSubBands"]
)
def test_a_task_not_ported_yet_raises(path):
    with pytest.raises(PipelineRuntimeError, match="not ported to draco_tpu_torch yet") as e:
        _resolve_task_class(path)
    assert path in str(e.value)
    problems = Manager({"pipeline": {"tasks": [{"type": path, "out": "x"}]}}).lint()
    assert any("not ported" in p for p in problems)


def test_resolving_reference_paths_imports_neither_jax_nor_draco_tpu():
    code = (
        "import sys\n"
        "from draco_tpu_torch.core.pipeline import _resolve_task_class\n"
        "for path in ('draco.analysis.transform.MModeTransform', 'draco_tpu.telescope.roundtrip.SimulateAndMap'):\n"
        "    print(_resolve_task_class(path).__module__)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'draco_tpu') or m.startswith(('jax.', 'draco_tpu.')))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["draco_tpu_torch.analysis.transform", "draco_tpu_torch.telescope.roundtrip"]


class _Doubler(ContainerTask):
    def process(self, item):
        out = item.copy()
        out.stack[:] = 2 * item.stack[:]
        return out


class _AddOne(ContainerTask):
    def process(self, item):
        out = item.copy()
        out.stack[:] = item.stack[:] + 1
        return out


def test_group_tasks_chains_process():
    t = group_tasks(_Doubler, _AddOne)()
    t.read_config({})
    c = containers.FrequencyStack(freq=np.array([400.0]))
    c.stack[:] = 3.0
    assert float(t.process(c).stack[:][0]) == 7.0


class _RandomUser(RandomTask, ContainerTask):
    pass


def test_random_task_reproducible():
    t1, t2 = _RandomUser(), _RandomUser()
    t1.read_config({"seed": 42})
    t2.read_config({"seed": 42})
    assert np.allclose(t1.rng.standard_normal(5), t2.rng.standard_normal(5))
    g1, g2 = t1.generator(), t1.generator()
    a, b = torch.rand(4, generator=g1), torch.rand(4, generator=g2)
    assert not torch.equal(a, b)
    assert torch.equal(torch.rand(4, generator=t2.generator()), a)
    assert g1.device.type == "cpu"


def test_unproduced_in_label_fails_fast():
    cfg = """
pipeline:
  tasks:
    - type: tests.test_torch_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 2
    - type: tests.test_torch_pipeline.Accumulate
      in: nmus
      out: total
"""
    with pytest.raises(PipelineRuntimeError, match="nmus"):
        Manager.from_yaml_str(cfg).run()


def test_retain_products_final():
    cfg = """
pipeline:
  retain_products: final
  tasks:
    - type: tests.test_torch_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 3
    - type: tests.test_torch_pipeline.Accumulate
      in: nums
      out: total
"""
    products = Manager.from_yaml_str(cfg).run()
    assert "nums" not in products
    assert len(products["total"]) == 1


def test_manager_rejects_non_mapping_config():
    with pytest.raises(config.ConfigError, match="mapping"):
        Manager(None)


def test_validate_finite_names_the_task():
    cfg = {"pipeline": {"validate_finite": True,
                        "tasks": [{"type": "tests.test_torch_pipeline.EmitNaN", "out": "bad"}]}}
    with pytest.raises(PipelineRuntimeError, match="EmitNaN.*'bad'/stack: 2 non-finite"):
        Manager(cfg).run()


def test_timing_and_profile(tmp_path):
    cfg = {"pipeline": {"timing": True, "profile": str(tmp_path / "prof"),
                        "tasks": [{"type": "tests.test_torch_pipeline.EmitNumbers", "out": "nums"}]}}
    man = Manager(cfg)
    man.run()
    # setup, three outputs, the stop, finish
    assert man.task_timing["tests.test_torch_pipeline.EmitNumbers[0]"]["calls"] == 6
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize(
    "mesh,ok",
    [("{freq: 1, m: -1}", True), ("{axes: {freq: 1}}", True), ("{freq: 2, m: 4}", False),
     ("{axes: {freq: -1}, dcn: {freq: 2}}", False), ("{freq: 0}", False)],
)
def test_mesh_stanza_one_device_only(mesh, ok):
    cfg = f"""
pipeline:
  mesh: {mesh}
  tasks:
    - type: tests.test_torch_pipeline.EmitNumbers
      out: nums
"""
    if ok:
        assert Manager.from_yaml_str(cfg).run()["nums"]
    else:
        with pytest.raises(config.ConfigError):
            Manager.from_yaml_str(cfg)
    if "2" in mesh:
        with pytest.raises(config.ConfigError, match="item 23"):
            Manager.from_yaml_str(cfg)


def test_checkpoint_restart_from_saved_products(tmp_path):
    stage1 = f"""
pipeline:
  tasks:
    - type: tests.test_torch_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 3
        save: true
        output_name: "{tmp_path}/ckpt_{{tag}}.h5"
"""
    Manager.from_yaml_str(stage1).run()
    assert len(sorted(tmp_path.glob("ckpt_*.h5"))) == 3
    stage2 = f"""
pipeline:
  tasks:
    - type: draco.core.io.LoadFilesFromParams
      out: nums
      params:
        files: "{tmp_path}/ckpt_*.h5"
        prefetch: true
    - type: tests.test_torch_pipeline.Accumulate
      in: nums
      out: total
"""
    assert _total(Manager.from_yaml_str(stage2).run()) == 3.0


# -- the command line ---------------------------------------------------------

PRODUCTS_YAML = """
config:
    output_directory: "products/"

telescope:
    type: UnpolarisedDishArray
    grid_ew: 2
    grid_ns: 1
    spacing_ew: 6.0
    spacing_ns: 6.0
    latitude: 45.0
    freq_lower: 400.0
    freq_upper: 410.0
    num_freq: 2
    auto_correlations: Yes
"""


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    """``makeproducts`` through the port's CLI (the products YAML of
    ``tests/test_examples.py``)."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = tmp / "products.yaml"
    cfg.write_text(PRODUCTS_YAML)
    assert main(["--platform", "cpu", "makeproducts", str(cfg)]) == 0
    return tmp / "products"


def test_makeproducts_load_in_both_packages(products):
    bt_dir = str(products / "bt")
    tbt = BeamTransfer(directory=bt_dir, device="cpu")
    jbt = JBeamTransfer(bt_dir)
    assert np.array_equal(tbt._bp.numpy(), np.asarray(jbt._bp))
    assert np.array_equal(tbt._bm.numpy(), np.asarray(jbt._bm))
    assert type(jbt.telescope).__name__ == type(tbt.telescope).__name__ == "UnpolarisedDishArray"
    # and they are the JAX package's beam transfer matrices of that telescope
    ref = JBeamTransfer(telescope=jbt.telescope).generate()
    bp = np.asarray(ref._bp)
    assert np.abs(tbt._bp.numpy() - bp).max() <= 2e-5 * np.abs(bp).max()


def test_load_product_manager(products, tmp_path):
    cfg = {"pipeline": {"tasks": [
        {"type": "draco.core.io.LoadProductManager", "out": "pm",
         "params": {"product_directory": str(products.parent / "products.yaml")}},
    ]}}
    pm = Manager(cfg).run()["pm"][0]
    assert pm.beamtransfer._bp is not None and pm.beamtransfer._bp.device.type == "cpu"
    stanza = tmp_path / "kl.yaml"
    stanza.write_text(PRODUCTS_YAML + "kltransform:\n  - type: KLTransform\n")
    with pytest.raises(NotImplementedError, match="not ported"):
        Manager({"pipeline": {"tasks": [
            {"type": "draco.core.io.LoadProductManager", "out": "pm", "params": {"product_directory": str(stanza)}},
        ]}}).run()


def test_cli_runs_a_pipeline_on_the_cpu(products, tmp_path):
    """``python -m draco_tpu_torch --platform cpu run`` in a fresh process,
    against the same chain run in this one."""
    nside = BeamTransfer(directory=str(products / "bt"), device="cpu").beam_nside
    tel = BeamTransfer(directory=str(products / "bt"), device="cpu").telescope
    sky = containers.Map(nside=nside, polarisation=False, freq=tel.frequencies)
    sky.map[:] = np.random.Generator(np.random.SFC64(4)).standard_normal(sky.map.shape)
    sky.save(str(tmp_path / "sky.h5"))
    cfg = f"""
pipeline:
  tasks:
    - type: draco.core.io.LoadBeamTransfer
      out: [tel, btm]
      params:
        product_directory: "{products}/bt"
    - type: draco.core.io.LoadMaps
      out: imap
      params:
        maps:
          files: ["{tmp_path}/sky.h5"]
          tag: testmap
    - type: draco.synthesis.stream.SimulateSidereal
      requires: btm
      in: imap
      out: sstream
    - type: draco.analysis.transform.MModeTransform
      in: sstream
      out: mmodes
    - type: draco.analysis.mapmaker.DirtyMapMaker
      requires: btm
      in: mmodes
      out: dmap
      params:
        nside: {nside}
        save: true
        output_name: "{tmp_path}/dirty_{{tag}}.h5"
"""
    (tmp_path / "cfg.yaml").write_text(cfg)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "draco_tpu_torch", "--platform", "cpu", "run", str(tmp_path / "cfg.yaml")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    saved = containers.ContainerBase.from_file(str(tmp_path / "dirty_testmap.h5"))
    assert "LoadBeamTransfer" in saved.history["config"]
    direct = Manager.from_yaml_str(cfg.replace("save: true", "save: false")).run()["dmap"][0]
    assert torch.equal(saved.map[:], direct.map[:])
    assert main(["lint", str(tmp_path / "cfg.yaml")]) == 0


@pytest.mark.parametrize("command", ["queue", "verify"])
def test_cli_commands_not_ported_yet_exit_nonzero(command, capsys):
    assert main([command, "anything"]) != 0
    assert "not ported yet" in capsys.readouterr().out
