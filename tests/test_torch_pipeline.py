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
from threadpoolctl import threadpool_limits

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
        ("draco.analysis.flagging.RFIMask", "draco_tpu_torch.analysis.flagging"),
        ("draco.analysis.flagging.ApplyRFIMask", "draco_tpu_torch.analysis.flagging"),
        ("draco.analysis.svdfilter.SVDFilter", "draco_tpu_torch.analysis.svdfilter"),
        ("draco_tpu.analysis.fgfilter.KLModeProject", "draco_tpu_torch.analysis.fgfilter"),
        ("draco.analysis.powerspectrum.QuadraticPSEstimation", "draco_tpu_torch.analysis.powerspectrum"),
        ("draco.analysis.delay.DelayFilter", "draco_tpu_torch.analysis.delay"),
        ("draco_tpu.analysis.delay.DelayPowerSpectrumGibbsBatched", "draco_tpu_torch.analysis.delay"),
        ("draco.analysis.delay.DelayCrossPowerSpectrumEstimatorBatched", "draco_tpu_torch.analysis.delay"),
        ("draco_tpu.analysis.delay.DelayPowerSpectrumNRML", "draco_tpu_torch.analysis.delay"),
        ("draco.analysis.transform.StokesIVis", "draco_tpu_torch.analysis.transform"),
        ("draco.analysis.transform.ReduceChisq", "draco_tpu_torch.analysis.transform"),
        ("draco.analysis.ringmapmaker.RingMapMaker", "draco_tpu_torch.analysis.ringmapmaker"),
        ("draco_tpu.analysis.ringmapmaker.BeamformNS", "draco_tpu_torch.analysis.ringmapmaker"),
        ("draco.analysis.ringmapmaker.WienerRingMapMakerAnalytical", "draco_tpu_torch.analysis.ringmapmaker"),
        ("draco.analysis.ringmapmaker.ReconstructVisFreqCov", "draco_tpu_torch.analysis.ringmapmaker"),
        ("draco.analysis.powerspec.ConstructWienerDelayTransform", "draco_tpu_torch.analysis.powerspec"),
        ("draco_tpu.analysis.powerspec.SphericalPowerSpectrum3Dto1D", "draco_tpu_torch.analysis.powerspec"),
        ("draco.analysis.dayenu.DayenuDelayFilter", "draco_tpu_torch.analysis.dayenu"),
        ("draco_tpu.analysis.dayenu.DayenuMFilter", "draco_tpu_torch.analysis.dayenu"),
        ("draco.analysis.interpolate.DPSSFilterDelay", "draco_tpu_torch.analysis.interpolate"),
        ("draco_tpu.analysis.interpolate.DPSSFilterMModeStokesI", "draco_tpu_torch.analysis.interpolate"),
        ("draco.analysis.wavelet.WaveletSpectrumEstimator", "draco_tpu_torch.analysis.wavelet"),
        ("draco.analysis.hyforesbandpass.DelayFilterHyFoReSBandpassHybridVisClean",
         "draco_tpu_torch.analysis.hyforesbandpass"),
    ],
)
def test_task_path_translation(path, module):
    assert _resolve_task_class(path).__module__ == module


@pytest.mark.parametrize(
    "example", ["simulate.yaml", "chime_scale.yaml", "analyze.yaml", "fused_roundtrip.yaml", "ringmap.yaml"]
)
def test_every_task_of_the_simulation_examples_resolves(example):
    """Every task of these example configs of the JAX package has a port,
    and the config lints clean."""
    import yaml

    with open(os.path.join(ROOT, "examples", example)) as f:
        cfg = yaml.safe_load(f)
    for spec in cfg["pipeline"]["tasks"]:
        assert _resolve_task_class(spec["type"]).__module__.startswith("draco_tpu_torch."), spec["type"]
    assert Manager(cfg).lint() == []


@pytest.mark.parametrize(
    "module", ["dayenu", "interpolate", "wavelet", "hyforesbandpass"]
)
def test_every_container_task_of_the_filter_modules_resolves(module):
    """Every ``ContainerTask`` class of these JAX modules has a port of the same name."""
    import importlib
    import inspect

    from draco_tpu.core.task import ContainerTask as JContainerTask

    jmod = importlib.import_module(f"draco_tpu.analysis.{module}")
    names = [n for n, c in inspect.getmembers(jmod, inspect.isclass)
             if issubclass(c, JContainerTask) and c.__module__ == jmod.__name__]
    assert names
    for name in names:
        cls = _resolve_task_class(f"draco_tpu.analysis.{module}.{name}")
        assert cls.__module__ == f"draco_tpu_torch.analysis.{module}" and issubclass(cls, ContainerTask), name


@pytest.mark.parametrize(
    "path", ["draco_tpu.ops.aotcache.cached_compile", "draco_tpu.parallel.mesh._put"]
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
        "for path in ('draco.analysis.transform.MModeTransform', 'draco_tpu.telescope.roundtrip.SimulateAndMap',\n"
        "             'draco.analysis.dayenu.DayenuDelayFilter', 'draco.analysis.interpolate.DPSSFilter',\n"
        "             'draco.analysis.wavelet.WaveletSpectrumEstimator',\n"
        "             'draco.analysis.hyforesbandpass.HyFoReSBandpassHybridVis'):\n"
        "    print(_resolve_task_class(path).__module__)\n"
        "import draco_tpu_torch.ops.dayenu, draco_tpu_torch.ops.dpss, draco_tpu_torch.ops.wavelet\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'draco_tpu') or m.startswith(('jax.', 'draco_tpu.')))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "draco_tpu_torch.analysis.transform", "draco_tpu_torch.telescope.roundtrip", "draco_tpu_torch.analysis.dayenu",
        "draco_tpu_torch.analysis.interpolate", "draco_tpu_torch.analysis.wavelet",
        "draco_tpu_torch.analysis.hyforesbandpass",
    ]


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
    """In one process (no launch) a mesh of one device runs unsharded; a mesh
    of more devices than the launch has raises at run, naming both counts,
    and a malformed stanza raises when the config is read."""
    cfg = f"""
pipeline:
  mesh: {mesh}
  tasks:
    - type: tests.test_torch_pipeline.EmitNumbers
      out: nums
"""
    if ok:
        assert Manager.from_yaml_str(cfg).run()["nums"]
    elif "0" in mesh:
        with pytest.raises(config.ConfigError, match="positive integer"):
            Manager.from_yaml_str(cfg)
    else:
        man = Manager.from_yaml_str(cfg)  # the syntax is valid: lint passes it
        with pytest.raises(config.ConfigError, match="covers 8 processes but the launch has 1|does not divide"):
            man.run()


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
    assert pm.kltransforms == {} and pm.psestimators == {}


KL_STANZAS = """
kltransform:
    - type: KLTransform
      name: kl
      threshold: 1.0e-4
    - type: DoubleKL
      name: dk
      threshold: 0.03
      foreground_threshold: 1.0e-4
      foreground_amp: 2.0
      noise_amp: 0.5
psfisher:
    - type: MonteCarlo
      name: ps
      klname: dk
      bands_kpar: [0.0, 0.5, 1.0]
      bands_kperp: [0.0, 0.5]
"""


def test_product_config_with_kl_and_ps_stanzas_builds(products, tmp_path):
    """``kltransform`` and ``psfisher`` stanzas build through the port's
    ``ProductManager.from_config``, as they do through the JAX package's."""
    from draco_tpu.telescope import ProductManager as JProductManager
    from draco_tpu_torch.telescope.kltransform import DoubleKL, KLTransform
    from draco_tpu_torch.telescope.psestimation import PSEstimation

    cfg = tmp_path / "kl.yaml"
    cfg.write_text(PRODUCTS_YAML.replace('"products/"', f'"{products}"') + KL_STANZAS)
    pm = Manager({"pipeline": {"tasks": [
        {"type": "draco.core.io.LoadProductManager", "out": "pm", "params": {"product_directory": str(cfg)}},
    ]}}).run()["pm"][0]
    jpm = JProductManager.from_config(str(cfg))
    assert list(pm.kltransforms) == list(jpm.kltransforms) == ["kl", "dk"]
    assert type(pm.kltransforms["kl"]) is KLTransform and type(pm.kltransforms["dk"]) is DoubleKL
    dk, ps = pm.kltransforms["dk"], pm.psestimators["ps"]
    assert (dk.threshold, dk.foreground_threshold, dk.noise_amp) == (0.03, 1e-4, 0.5)
    assert type(ps) is PSEstimation and ps.kltransform is dk and ps.beamtransfer is pm.beamtransfer
    assert dk.beamtransfer is pm.beamtransfer and pm.beamtransfer._bp is not None
    # generate() reaches every product, and the flags of the config stanza switch them off
    assert pm.generate() is pm and ps.nbands == jpm.generate().psestimators["ps"].nbands == 2
    evals = dk.evals_all()
    assert evals.device.type == "cpu" and evals.shape == (pm.telescope.mmax + 1, pm.telescope.nfreq * pm.beamtransfer.svd_len())
    assert bool(torch.isfinite(evals).all())
    off = tmp_path / "off.yaml"
    off.write_text(cfg.read_text().replace("config:\n", "config:\n    psfisher: No\n"))
    from draco_tpu_torch.telescope.manager import ProductManager

    pm_off = ProductManager.from_config(str(off)).generate()
    assert not hasattr(pm_off.psestimators["ps"], "nbands")


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


@pytest.mark.parametrize("command", ["queue"])
def test_cli_commands_not_ported_yet_exit_nonzero(command, capsys, tmp_path):
    """Every CLI command of the JAX package is ported; ``queue`` exits 1 on a
    ``cluster:`` stanza that fails lint."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("cluster: {nodes: 0, ppn: 4}\npipeline:\n  tasks:\n"
                   "    - type: tests.test_torch_pipeline.EmitNumbers\n      out: nums\n")
    assert main([command, str(cfg)]) == 1
    assert "cluster.nodes must be a positive integer" in capsys.readouterr().out


# -- examples/analyze.yaml through both Managers ------------------------------------

ANALYZE_TELESCOPE = dict(
    grid_ew=2, grid_ns=2, spacing_ew=6.0, spacing_ns=6.0, latitude=45.0, freq_lower=400.0, freq_upper=440.0,
    num_freq=4, dish_width=6.0, auto_correlations=True, force_lmax=15, force_mmax=15,
)
RFI_CELLS = [(1, 5), (2, 20), (2, 21)]  # (freq, ra) of the injected interference


@pytest.fixture(scope="module")
def analyze_chain(tmp_path_factory):
    """``examples/analyze.yaml``, task for task, through the JAX package's
    Manager and the port's, on one product directory and one simulated
    stream file: a smooth-spectrum foreground 1e3 x a Gaussian signal,
    noise, zero-weight gaps and interference at known cells."""
    import yaml

    from draco_tpu.core import containers as jcontainers
    from draco_tpu.core.pipeline import Manager as JManager
    from draco_tpu.synthesis.stream import SimulateSidereal as JSimulateSidereal
    from draco_tpu.telescope import UnpolarisedDishArray as JDishArray

    tmp = tmp_path_factory.mktemp("analyze")
    jtel = JDishArray(**ANALYZE_TELESCOPE)
    jbt = JBeamTransfer(telescope=jtel).generate()
    jbt.save(str(tmp / "products" / "bt"))
    rng = np.random.Generator(np.random.SFC64(31))
    npix = 12 * jbt.beam_nside**2
    sky = jcontainers.Map(nside=jbt.beam_nside, polarisation=False, freq=jtel.frequencies)
    spectrum = (jtel.frequencies / 400.0) ** -2.7
    sky.map[:] = 1e3 * spectrum[:, None, None] * rng.standard_normal((1, 1, npix)) + rng.standard_normal((4, 1, npix))
    sim = JSimulateSidereal()
    sim.read_config({})
    sim.setup(jbt)
    ss = sim.process(sky)
    vis = np.asarray(ss.vis[:]).copy()
    vis += 1e-3 * np.abs(vis).max() * (rng.standard_normal(vis.shape) + 1j * rng.standard_normal(vis.shape))
    for f, t in RFI_CELLS:
        vis[f, :, t] += 50.0 * np.abs(vis).max()
    weight = np.ones(vis.shape, np.float32)
    weight[:, 3, 10:13] = 0.0
    ss.vis[:] = vis
    ss.weight[:] = weight
    ss.save(str(tmp / "sim_0.h5"))

    with open(os.path.join(ROOT, "examples", "analyze.yaml")) as f:
        cfg = yaml.safe_load(f)
    tasks = cfg["pipeline"]["tasks"]
    tasks[0]["params"]["product_directory"] = str(tmp / "products" / "bt")
    tasks[1]["params"]["files"] = [str(tmp / "sim_*.h5")]
    tasks[-1]["params"] = {"nside": jbt.beam_nside}
    with default_device("cpu"):
        return JManager(cfg).run(), Manager(cfg).run(), jtel


def test_analyze_example_masks_the_injected_rfi(analyze_chain):
    jprod, tprod, _ = analyze_chain
    jmask, tmask = np.asarray(jprod["rfimask"][0].mask[:]), tprod["rfimask"][0].mask[:]
    assert isinstance(tprod["rfimask"][0], containers.SiderealRFIMask)
    assert np.array_equal(tmask, jmask)
    assert all(tmask[f, t] for f, t in RFI_CELLS) and tmask.mean() < 0.25
    w = tprod["sstream_masked"][0].weight[:]
    assert np.array_equal(w.numpy(), np.asarray(jprod["sstream_masked"][0].weight[:]))
    bad = torch.from_numpy(tmask)[:, None, :].expand(w.shape)
    assert bool((w[bad] == 0).all()) and bool((w[~bad][w[~bad] != 0] == 1).all())


def _unfiltered_mmodes(tprod, tel):
    """``SVDFilter`` writes into the m-modes it is given, so ``mmodes`` and
    ``mmodes_filt`` are one container: the unfiltered ones are made again."""
    from draco_tpu_torch.analysis.transform import MModeTransform

    t = MModeTransform()
    t.read_config({})
    t.setup(tel)
    return t.process(tprod["sstream_masked"][0])


def test_analyze_example_matches_jax(analyze_chain):
    """Each stage against the JAX package's, max|diff| over the peak of the
    stage's INPUT scale: 2e-5 (float32 against 64-bit types on).  The SVD
    filter's output is what is left of data 1e3 x brighter, so its
    differences are held against the unfiltered peak."""
    jprod, tprod, _ = analyze_chain
    ref = np.asarray(jprod["sstream"][0].vis[:])
    assert np.abs(tprod["sstream"][0].vis[:].numpy() - ref).max() <= 2e-5 * np.abs(ref).max()
    assert tprod["mmodes_filt"][0] is tprod["mmodes"][0] and jprod["mmodes_filt"][0] is jprod["mmodes"][0]
    raw = _unfiltered_mmodes(tprod, tprod["tel"][0])
    filt, jfilt = tprod["mmodes_filt"][0], jprod["mmodes_filt"][0]
    assert np.array_equal(filt.weight[:].numpy(), np.asarray(jfilt.weight[:]))
    assert torch.equal(filt.weight[:], raw.weight[:])
    peak = raw.vis[:].abs().max().item()
    assert np.abs(filt.vis[:].numpy() - np.asarray(jfilt.vis[:])).max() <= 2e-5 * peak
    # the bright smooth-spectrum mode is gone
    assert filt.vis[:].abs().max().item() < 0.01 * peak


def test_analyze_example_makes_the_ml_map(analyze_chain):
    """The ML map is finite and agrees with the JAX package's within 5e-2 of
    its peak: both take a float32 pseudo-inverse cut at 1e-3 of the largest
    singular value, which amplifies the filters' float32 differences (the
    map makers alone are held to 1e-4 in ``test_torch_tasks.py``)."""
    jprod, tprod, _ = analyze_chain
    jmap, tmap = np.asarray(jprod["mlmap"][0].map[:]), tprod["mlmap"][0].map[:]
    assert isinstance(tprod["mlmap"][0], containers.Map) and tmap.shape == jmap.shape
    assert bool(torch.isfinite(tmap).all())
    assert np.abs(tmap.numpy() - jmap).max() <= 5e-2 * np.abs(jmap).max()


# -- the delay-spectrum config (BASELINE.json config 3's chain) through both Managers -----

DELAY_TELESCOPE = dict(
    num_cylinders=2, num_feeds=4, feed_spacing=0.5, cylinder_width=20.0, cylinder_spacing=22.0, latitude=49.0,
    freq_lower=400.0, freq_upper=425.0, num_freq=65, auto_correlations=True,
)
DELAY_NRA = 32
SIGNAL_VAR, NOISE_VAR = 1.0, 0.01  # per product, complex: E|s|^2, E|n|^2


def delay_config(product_dir, stream_glob, estimator="DelayPowerSpectrumGibbsBatched"):
    return {"pipeline": {"tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"], "params": {"product_directory": product_dir}},
        {"type": "draco.core.io.LoadFilesFromParams", "out": "sstream", "params": {"files": [stream_glob]}},
        {"type": "draco.analysis.delay.DelayFilter", "requires": "tel", "in": "sstream", "out": "sstream_filt",
         "params": {"delay_cut": 0.1}},
        {"type": "draco.analysis.transform.StokesIVis", "requires": "tel", "in": "sstream_filt", "out": "sstream_I"},
        {"type": f"draco.analysis.delay.{estimator}", "in": "sstream_I", "out": "dspec",
         "params": {"nsamp": 20, "median_frac": 0.5, "seed": 5, "save_samples": True, "save_spectrum_mask": True}},
    ]}}


@pytest.fixture(scope="module")
def delay_chain(tmp_path_factory):
    """A dual-pol 2 x 4-feed cylinder, 65 channels, 32 RA samples: per product
    a smooth foreground (delays inside 0.05 us, below every cut), a white
    signal and noise of the variance the weights state, one dead channel and
    one dead sample on every product; run task for task through the JAX
    package's Manager and the port's.  The JAX package's run takes its
    per-baseline host sampler (``DelayPowerSpectrumGibbs``, the posterior
    the batched one samples): its batched sampler compiles for seconds on
    the CPU."""
    import pickle

    from draco_tpu.core import containers as jcontainers
    from draco_tpu.core.pipeline import Manager as JManager
    from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder

    tmp = tmp_path_factory.mktemp("delay")
    jtel = JPolCylinder(**DELAY_TELESCOPE)
    (tmp / "products").mkdir()
    with open(tmp / "products" / "telescope.pkl", "wb") as f:
        pickle.dump(jtel, f)
    rng = np.random.Generator(np.random.SFC64(41))
    pairs, freq = np.asarray(jtel.uniquepairs), jtel.frequencies
    shape = (len(freq), len(pairs), DELAY_NRA)

    def cn(var):
        return np.sqrt(var / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))

    tau = rng.uniform(-0.05, 0.05, (len(pairs), 3))
    amp = 30 * (rng.standard_normal((len(pairs), 3, DELAY_NRA)) + 1j * rng.standard_normal((len(pairs), 3, DELAY_NRA)))
    fg = np.einsum("pkt,fpk->fpt", amp, np.exp(2j * np.pi * freq[:, None, None] * tau[None]))
    weight = np.full(shape, 1.0 / NOISE_VAR, np.float32)
    weight[20], weight[:, :, 9] = 0.0, 0.0
    prod = np.empty(len(pairs), dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = pairs.T
    ss = jcontainers.SiderealStream(freq=freq, ra=DELAY_NRA, input=jtel.nfeed, prod=prod)
    ss.vis[:] = (fg + cn(SIGNAL_VAR) + cn(NOISE_VAR)).astype(np.complex64)
    ss.weight[:] = weight
    ss.save(str(tmp / "delay_0.h5"))
    cfg = delay_config(str(tmp / "products"), str(tmp / "delay_*.h5"))
    jcfg = delay_config(str(tmp / "products"), str(tmp / "delay_*.h5"), estimator="DelayPowerSpectrumGibbs")
    # one CPU thread for torch and the BLAS and OpenMP pools: the chain's
    # small products gain nothing from threads, and beside five other test
    # workers the spinning pools ran it tens of times slower
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with default_device("cpu"), threadpool_limits(1):
            return cfg, JManager(jcfg).run(), Manager(cfg).run()
    finally:
        torch.set_num_threads(n)


def test_delay_config_resolves_and_lints(delay_chain):
    cfg = delay_chain[0]
    for spec in cfg["pipeline"]["tasks"]:
        assert _resolve_task_class(spec["type"]).__module__.startswith("draco_tpu_torch."), spec["type"]
    assert Manager(cfg).lint() == []


def test_delay_config_matches_jax(delay_chain):
    """The filter and Stokes I within 2e-5 of the JAX package's (float32
    streams; over the input's peak); the Gibbs spectra statistically: both
    chains sample one posterior with independent draws (per-baseline torch
    generators against numpy's), so over the delays above every cut
    (|tau| > 0.2 us, where the filtered data are the white signal) the
    median of port over JAX must lie within 0.85-1.18.  Each spectrum is the
    median of 10 draws with nsamp = 31 samples, relative scatter about
    sqrt(2 / 31) / sqrt(3) ~ 0.15 a delay, 0.21 for the ratio; the median
    of about 10 x 60 ratios (neighbours correlated over ~4 delays by the
    window) has a standard error of about 1.25 x 0.21 / sqrt(150) = 0.02:
    the bounds are 7 of those."""
    _, jprod, tprod = delay_chain
    for label in ("sstream_filt", "sstream_I"):
        jc, tc = jprod[label][0], tprod[label][0]
        assert np.array_equal(tc.weight[:].numpy(), np.asarray(jc.weight[:]))
        ref = np.asarray(jc.vis[:])
        assert np.abs(tc.vis[:].numpy() - ref).max() <= 2e-5 * np.abs(np.asarray(jprod["sstream"][0].vis[:])).max()
    jd, td = jprod["dspec"][0], tprod["dspec"][0]
    assert isinstance(td, containers.DelaySpectrum) and np.array_equal(td.delay, jd.delay)
    tspec, jspec = td.spectrum[:].numpy(), np.asarray(jd.spectrum[:])
    live = ~td.datasets["spectrum_mask"][:]
    assert np.array_equal(live, ~np.asarray(jd.datasets["spectrum_mask"][:])) and live.sum() == 10
    above = np.abs(td.delay) > 0.2
    ratio = np.median(tspec[live][:, above] / jspec[live][:, above])
    assert 0.85 <= ratio <= 1.18, ratio
    # and both recover the injected Stokes I signal: E|s_XX + s_YY|^2 / N per delay
    expect = 2 * SIGNAL_VAR / len(td.delay)
    for spec in (tspec, jspec):
        assert 0.7 <= np.median(spec[live][:, above]) / expect <= 1.4


# -- examples/ringmap.yaml through both Managers -------------------------------------

RINGMAP_TELESCOPE = dict(
    num_cylinders=2, num_feeds=4, feed_spacing=1.0, cylinder_spacing=10.0, cylinder_width=10.0, latitude=45.0,
    freq_lower=500.0, freq_upper=520.0, num_freq=4, auto_correlations=True,
)
RINGMAP_NRA = 32


def _ringmap_example(tmp, insert_mask):
    """``examples/ringmap.yaml`` pointed at ``tmp``; with ``insert_mask`` the
    RFI mask is applied by ``ApplyTimeFreqMask`` (as ``examples/analyze.yaml``
    does) and the ring-map maker reads the masked stream."""
    import yaml

    with open(os.path.join(ROOT, "examples", "ringmap.yaml")) as f:
        cfg = yaml.safe_load(f)
    tasks = cfg["pipeline"]["tasks"]
    tasks[0]["params"]["product_directory"] = str(tmp / "products")
    tasks[1]["params"]["files"] = [str(tmp / "sim_sstream_*.h5")]
    tasks.pop()  # the Save task: the products are compared in memory
    if insert_mask:
        tasks.insert(3, {"type": "draco.analysis.flagging.ApplyTimeFreqMask", "in": ["sstream", "sstream_rfi"],
                         "out": "sstream_masked"})
        tasks[4]["in"] = "sstream_masked"
    return cfg


@pytest.fixture(scope="module")
def ringmap_example(tmp_path_factory):
    """A dual-pol 2 x 4-feed cylinder at 4 frequencies and 32 RA samples:
    two point sources, noise, a zero-weight gap and interference at one
    (freq, RA) cell, written as the example's stream file."""
    import pickle

    from draco_tpu.core import containers as jcontainers
    from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder

    tmp = tmp_path_factory.mktemp("ringmap")
    jtel = JPolCylinder(**RINGMAP_TELESCOPE)
    (tmp / "products").mkdir()
    with open(tmp / "products" / "telescope.pkl", "wb") as f:
        pickle.dump(jtel, f)
    rng = np.random.Generator(np.random.SFC64(51))
    pairs, freq = np.asarray(jtel.uniquepairs), jtel.frequencies
    ra = np.linspace(0.0, 360.0, RINGMAP_NRA, endpoint=False)
    bl = np.asarray(jtel.baselines)
    vis = np.zeros((len(freq), len(pairs), RINGMAP_NRA), complex)
    for ra0, el0 in ((90.0, 0.2), (250.0, -0.3)):
        ha = np.radians(ra - ra0)
        phase = (bl[:, 0, None] * np.sin(ha)[None] + bl[:, 1, None] * el0) * freq[:, None, None] * 1e6 / 299792458.0
        vis += 100.0 * np.exp(2j * np.pi * phase) * np.exp(-0.5 * (ha / 0.2) ** 2)
    vis += rng.standard_normal(vis.shape) + 1j * rng.standard_normal(vis.shape)
    vis[2, :, 11] += 1e4  # interference
    weight = np.ones(vis.shape, np.float32)
    weight[:, 5, 20:23] = 0.0
    prod = np.array([[int(a), int(b)] for a, b in pairs])
    ss = jcontainers.SiderealStream(freq=freq, input=jtel.nfeed, ra=RINGMAP_NRA, prod=prod)
    ss.vis[:] = vis.astype(np.complex64)
    ss.weight[:] = weight
    ss.input_flags[:] = np.ones(ss.input_flags.shape, dtype=np.float32)
    ss.save(str(tmp / "sim_sstream_0.h5"))
    return tmp


def _run_both(cfg):
    from draco_tpu.core.pipeline import Manager as JManager

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with default_device("cpu"), threadpool_limits(1):
            return JManager(cfg).run(), Manager(cfg).run()
    finally:
        torch.set_num_threads(n)


def test_ringmap_example_with_the_mask_applied_matches_jax(ringmap_example):
    """``examples/ringmap.yaml`` with ``ApplyTimeFreqMask`` inserted, through
    the JAX package's Manager and the port's: the same mask (exact), the
    same masked weights (exact) and the ring map within 1e-6 of the JAX
    package's (a float32 stream; ``tests/test_torch_ringmap.py`` holds each
    task).  The interference is masked and the sources make the map's peak."""
    jprod, tprod = _run_both(_ringmap_example(ringmap_example, insert_mask=True))
    jmask, tmask = np.asarray(jprod["sstream_rfi"][0].mask[:]), tprod["sstream_rfi"][0].mask[:]
    assert np.array_equal(tmask, jmask) and tmask[2, 11]
    assert np.array_equal(tprod["sstream_masked"][0].weight[:].numpy(), np.asarray(jprod["sstream_masked"][0].weight[:]))
    jrm, trm = jprod["ringmap"][0], tprod["ringmap"][0]
    assert isinstance(trm, containers.RingMap) and trm.map.shape == jrm.map.shape == (3, 4, 4, RINGMAP_NRA, 512)
    assert list(trm.index_map["pol"]) == ["XX", "reXY", "imXY", "YY"]
    for name in ("map", "weight", "rms"):
        ref = np.asarray(jrm.datasets[name][:])
        assert np.abs(trm.datasets[name][:].numpy() - ref).max() <= 1e-6 * np.abs(ref).max(), name
    xx = trm.map[1, 0].numpy()  # the zenith beam, XX: [freq, ra, el]
    assert np.isfinite(xx).all() and np.abs(xx).max() > 10 * np.median(np.abs(xx))


def test_ringmap_example_as_written_fails_alike_in_both_packages(ringmap_example):
    """As written the example hands ``RFIMask``'s mask container to the
    ring-map maker, which needs a stream (a fault of the reference config,
    not of the port): both packages raise the same error."""
    cfg = _ringmap_example(ringmap_example, insert_mask=False)
    errors = []
    for manager in _managers():
        with pytest.raises(Exception) as e:
            with default_device("cpu"):
                manager(cfg).run()
        errors.append(e.value)
    assert type(errors[0]) is type(errors[1]), errors
    assert "prodstack" in str(errors[0]) and "prodstack" in str(errors[1])


def _managers():
    from draco_tpu.core.pipeline import Manager as JManager

    return JManager, Manager


STACK_TELESCOPE = dict(RINGMAP_TELESCOPE, num_freq=2)
STACK_NTIME = 256  # samples a sidereal day
STACK_PAD = 4
STACK_LSD = 3000
STACK_NSRC = 16


def _stacking_config(tmp):
    an = "draco.analysis."
    return {"pipeline": {"tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"],
         "params": {"product_directory": str(tmp / "products")}},
        {"type": "draco.core.io.LoadFilesFromParams", "out": "tstream", "params": {"files": [str(tmp / "day_*.h5")]}},
        {"type": "draco.core.io.LoadFilesFromParams", "out": "catalog", "params": {"files": [str(tmp / "cat.h5")]}},
        {"type": an + "sidereal.SiderealGrouper", "requires": "tel", "in": "tstream", "out": "day"},
        {"type": an + "sidereal.SiderealRegridder", "requires": "tel", "in": "day", "out": "sday",
         "params": {"samples": 128}},
        {"type": an + "sidereal.SiderealStacker", "in": "sday", "out": "sstack", "params": {"with_sample_variance": True}},
        {"type": an + "sidereal.SiderealStackerMatch", "in": "sday", "out": "mstack"},
        {"type": an + "beamform.BeamFormCat", "requires": ["tel", "sstack"], "in": "catalog", "out": "fbeam",
         "params": {"timetrack": 2000.0}},
        {"type": an + "sourcestack.SourceStack", "in": "fbeam", "out": "fstack", "params": {"freqside": 0}},
        {"type": an + "sourcestack.RandomSubset", "requires": "catalog", "out": "subcat",
         "params": {"number": 1, "size": 6, "seed": 18}},
        {"type": an + "beamform.BeamFormCat", "requires": ["tel", "sstack"], "in": "subcat", "out": "fbeam_ha",
         "params": {"collapse_ha": False, "timetrack": 2000.0}},
        {"type": an + "sidereal.SiderealRebinner", "requires": "tel", "in": "day", "out": "rday",
         "params": {"samples": 128}},
        {"type": an + "sidereal.RebinGradientCorrection", "requires": "sday", "in": "rday", "out": "rday_corr"},
    ]}}


@pytest.fixture(scope="module")
def stacking_chain(tmp_path_factory):
    """Phase 18's chain at CPU size: a dual-pol 2 x 4-feed cylinder at 2
    channels, three sidereal days of 256 samples (each day's two halves and
    the boundary files it shares with its neighbours, as ``chip_smoke.py``
    writes them), noise and two point sources; a 16-source catalogue.  Run
    through the JAX package's Manager and the port's."""
    import pickle

    from draco_tpu.analysis.transform import TelescopeStreamMixIn
    from draco_tpu.core import containers as jcontainers
    from draco_tpu.telescope import PolarisedCylinderTelescope as JPolCylinder

    tmp = tmp_path_factory.mktemp("stacking")
    jtel = JPolCylinder(**STACK_TELESCOPE)
    (tmp / "products").mkdir()
    with open(tmp / "products" / "telescope.pkl", "wb") as f:
        pickle.dump(jtel, f)
    maps = TelescopeStreamMixIn()
    maps.setup(jtel)
    files = [(-STACK_PAD, STACK_PAD)]
    for d in range(3):
        lo, mid, hi = d * STACK_NTIME + STACK_PAD, d * STACK_NTIME + STACK_NTIME // 2, (d + 1) * STACK_NTIME - STACK_PAD
        files += [(lo, mid), (mid, hi), (hi, hi + 2 * STACK_PAD)]
    bl = np.asarray(jtel.baselines)
    nu = jtel.frequencies * 1e6 / 299792458.0
    for i, (k0, k1) in enumerate(files):
        lsd = STACK_LSD + np.arange(k0, k1) / STACK_NTIME
        ts = jcontainers.TimeStream(freq=jtel.frequencies, input=jtel.nfeed, prod=maps.bt_prod, stack=maps.bt_stack,
                                    reverse_map_stack=maps.bt_rev, time=jtel.lsd_to_unix(lsd))
        rng = np.random.Generator(np.random.SFC64(100 + i))
        shape = ts.vis.shape
        vis = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        for ra0, amp in ((40.0, 30.0), (200.0, 50.0)):
            ha = np.radians((360.0 * (lsd % 1.0) - ra0 + 180.0) % 360.0 - 180.0)
            vis += amp * np.exp(2j * np.pi * bl[:, 0, None] * np.sin(ha)[None] * nu[:, None, None]) * np.exp(
                -0.5 * (ha / 0.1) ** 2)
        w = np.ones(shape, np.float32)
        w[0, 3, : (k1 - k0) // 3] = 0.0
        ts.vis[:] = vis.astype(np.complex64)
        ts.weight[:] = w
        ts.input_flags[:] = 1.0
        ts.save(str(tmp / f"day_{i:02d}.h5"))
    rng = np.random.Generator(np.random.SFC64(7))
    cat = jcontainers.SpectroscopicCatalog(object_id=np.arange(STACK_NSRC))
    pos = np.zeros(STACK_NSRC, dtype=[("ra", np.float64), ("dec", np.float64)])
    pos["ra"] = np.concatenate([[40.0, 200.0, 359.5], rng.uniform(0, 360, STACK_NSRC - 3)])
    pos["dec"] = jtel.latitude + rng.uniform(-3, 3, STACK_NSRC)
    red = np.zeros(STACK_NSRC, dtype=[("z", np.float64), ("z_error", np.float64)])
    red["z"] = 1420.405751768 / rng.uniform(jtel.frequencies.min(), jtel.frequencies.max(), STACK_NSRC) - 1.0
    cat["position"][:] = pos
    cat["redshift"][:] = red
    cat.save(str(tmp / "cat.h5"))
    return _run_both(_stacking_config(tmp))


def test_stacking_chain_matches_jax(stacking_chain):
    """Phase 18's chain through both Managers: the stack and its weights
    within 1e-5 (float32 West updates of float32 regrids), its sample
    variance within 1e-4 (the float32 rounding of the sources' |vis|^2,
    50^2 here, left in a noise-sized sum: ``host_west_stack`` in
    ``chip_smoke.py`` bounds it),
    the matched stack within 3e-3 (the float32 cancellation of each day's
    mean: ``tests/test_torch_sidereal.py``), the formed beams, their weights
    and the frequency stack within 1e-5 of their largest values (complex64
    contractions in both), the rebinned and corrected days within 1e-5;
    every label's container type and shape the JAX package's."""
    jprod, tprod = stacking_chain
    tols = {"sday": 1e-5, "sstack": 1e-5, "mstack": 3e-3, "fbeam": 1e-5, "fbeam_ha": 1e-5, "fstack": 1e-5,
            "rday_corr": 1e-5, "subcat": 0.0}
    for label, tol in tols.items():
        assert len(tprod[label]) == len(jprod[label]), label
        for got, ref in zip(tprod[label], jprod[label]):
            assert type(got).__name__ == type(ref).__name__, label
            assert set(got.datasets) == set(ref.datasets), (label, set(got.datasets), set(ref.datasets))
            for name, ds in ref.datasets.items():
                r = np.asarray(ds[:])
                g = got.datasets[name][:]
                g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
                assert g.shape == r.shape, (label, name)
                t = 1e-4 if name == "sample_variance" else tol
                if r.dtype.kind not in "fc" or t == 0.0:
                    np.testing.assert_array_equal(g, r, err_msg=f"{label}.{name}")
                else:
                    scale = max(np.abs(r).max(), 1e-300)
                    assert np.abs(g - r).max() <= t * scale, (label, name, np.abs(g - r).max() / scale)
    assert len(tprod["sday"]) == 3 and len(tprod["rday_corr"]) == 3
    fb = tprod["fbeam"][0].beam[:].numpy()
    assert np.isfinite(fb).all() and np.abs(fb[:2, 0]).max() > 5 * np.median(np.abs(fb[3:, 0]))
