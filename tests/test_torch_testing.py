"""Test fixtures of draco_tpu_torch.util.testing against draco_tpu's.

The draws are host numpy draws from the same seeded generator in both
packages, so the mock spectra and the streams must agree exactly.
"""

import numpy as np
import pytest
import torch

from draco_tpu.util import testing as jtesting
from draco_tpu_torch.core.pipeline import Manager, _resolve_task_class
from draco_tpu_torch.core.task import PipelineStopIteration
from draco_tpu_torch.device import default_device
from draco_tpu_torch.util import testing

FREQ = np.linspace(800.0, 400.0, 32, endpoint=False)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"ndata": 3, "noise": 0.1}, {"noise": 0.5, "bad_freq": np.array([2, 9])}],
    ids=["noiseless", "realisations", "bad-freq"],
)
def test_mock_freq_data_matches_jax(kwargs):
    got = testing.mock_freq_data(FREQ, 12, 0.2, rng=np.random.Generator(np.random.SFC64(4)), **kwargs)
    ref = jtesting.mock_freq_data(FREQ, 12, 0.2, rng=np.random.Generator(np.random.SFC64(4)), **kwargs)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype and np.array_equal(g, r)


def _random_freq_data(mod, params):
    task = mod.RandomFreqData()
    task.read_config(params)
    out = []
    while True:
        try:
            out.append(task.next())
        except Exception as e:  # PipelineStopIteration of either package
            assert type(e).__name__ == "PipelineStopIteration"
            return out


@pytest.mark.parametrize("num_correlated", [None, 2])
def test_random_freq_data_matches_jax(num_correlated):
    params = {"num_realisation": 2, "num_ra": 6, "num_base": 3, "num_freq": 16, "seed": 9,
              "num_correlated": num_correlated, "noise": 0.3}
    with default_device("cpu"):
        got = _random_freq_data(testing, params)
    ref = _random_freq_data(jtesting, params)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        gs, rs = (g, r) if num_correlated is None else (g[1], r[1])
        if num_correlated is not None:
            assert len(g) == len(r) == num_correlated
        assert type(gs).__name__ == "SiderealStream" and gs.vis[:].device == torch.device("cpu")
        for name in ("vis", "weight"):
            assert np.array_equal(getattr(gs, name)[:].numpy(), np.asarray(getattr(rs, name)[:])), name
        for name in ("freq", "ra", "input"):
            assert np.array_equal(gs.index_map[name], np.asarray(rs.index_map[name])), name


def test_dummy_task_emits_tagged_containers():
    task = testing.DummyTask()
    task.read_config({"total_len": 2, "tag": "probe"})
    with default_device("cpu"):
        outs = [task.process(), task.process()]
    assert [o.attrs["tag"] for o in outs] == ["probe", "probe"]
    with pytest.raises(PipelineStopIteration):
        task.process()


@pytest.mark.parametrize("prefix", ["draco_tpu", "draco"])
@pytest.mark.parametrize("name", ["DummyTask", "RandomFreqData"])
def test_reference_paths_resolve_to_the_port(prefix, name):
    cls = _resolve_task_class(f"{prefix}.util.testing.{name}")
    assert cls is getattr(testing, name)


def test_random_freq_data_through_the_manager():
    cfg = {"pipeline": {"tasks": [{"type": "draco.util.testing.RandomFreqData", "out": "s",
                                   "params": {"num_ra": 4, "num_base": 2, "num_freq": 8, "seed": 1}}]}}
    with default_device("cpu"):
        products = Manager(cfg).run()
    ref = _random_freq_data(jtesting, {"num_ra": 4, "num_base": 2, "num_freq": 8, "seed": 1})
    assert len(products["s"]) == 1
    assert np.array_equal(products["s"][0].vis[:].numpy(), np.asarray(ref[0].vis[:]))
