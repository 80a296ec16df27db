"""Determinism checks: draco_tpu_torch.parallel.validate against draco_tpu's.

Digests and report lines are compared exactly between the packages on the
same numpy contents; the pipeline checks run a seeded ``RandomFreqData``
config in both packages (the CPU here), and must raise on a source that
draws unseeded.  The fixed-order segment sum that replaced ``index_add_``
in ``CollateProducts`` and ``stokes_I_sum`` is held bitwise to a pairwise
reference and within rounding to ``index_add_``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from draco_tpu.core import containers as jcontainers
from draco_tpu.parallel import validate as jvalidate
from draco_tpu_torch.core import containers
from draco_tpu_torch.core.pipeline import main
from draco_tpu_torch.device import default_device
from draco_tpu_torch.ops import tools
from draco_tpu_torch.parallel import validate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEEDED = """
pipeline:
  tasks:
    - type: draco_tpu.util.testing.RandomFreqData
      out: sstream
      params:
        num_realisation: 2
        num_ra: 8
        num_base: 3
        num_freq: 16
        seed: 7
"""
UNSEEDED = SEEDED.replace("        seed: 7\n", "")


def _structure(kind, seed=0):
    rng = np.random.Generator(np.random.SFC64(seed))
    if kind == "arrays":
        return rng.standard_normal((4, 3)).astype(np.float32)
    if kind == "nested":
        return {
            "a": [rng.standard_normal(5) + 1j * rng.standard_normal(5), 3.0, "label", None],
            "b": (np.arange(6, dtype=np.int64).reshape(2, 3), True),
        }
    raise AssertionError(kind)


def _stacks(cmod, val):
    c = cmod.FrequencyStack(freq=np.array([400.0, 500.0]), **({"device": "cpu"} if cmod is containers else {}))
    c.stack[:] = val
    return c


@pytest.mark.parametrize("kind", ["arrays", "nested"])
def test_fingerprint_matches_jax(kind):
    obj = _structure(kind)
    assert validate.fingerprint(obj) == jvalidate.fingerprint(obj)


def test_fingerprint_of_tensors_and_containers_matches_jax():
    obj = _structure("nested", 1)
    as_torch = {
        "a": [torch.from_numpy(obj["a"][0]), 3.0, "label", None],
        "b": (torch.from_numpy(obj["b"][0]), True),
    }
    assert validate.fingerprint(as_torch) == jvalidate.fingerprint(obj)
    fp = validate.fingerprint(_stacks(containers, 2.0))
    assert fp == jvalidate.fingerprint(_stacks(jcontainers, 2.0))
    assert "/stack" in fp and "/index_map/freq" in fp


def test_compare_products_matches_jax():
    a, b = _structure("nested", 2), _structure("nested", 2)
    b["a"][0] = b["a"][0] + 1e-3
    b["b"] = (b["b"][0] + 1, False)
    got = validate.compare_products(a, b)
    assert got == jvalidate.compare_products(a, b) and len(got) == 3
    assert validate.compare_products(a, a) == []
    ta, tb = _stacks(containers, 2.0), _stacks(containers, 2.0)
    tb.stack[:] = 2.001
    ja, jb = _stacks(jcontainers, 2.0), _stacks(jcontainers, 2.0)
    jb.stack[:] = 2.001
    assert validate.compare_products(ta, tb) == jvalidate.compare_products(ja, jb)
    # a relative tolerance swallows the drift
    assert validate.compare_products(ta, tb, rtol=1e-2) == []


def test_assert_deterministic_pass_and_fail():
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    validate.assert_deterministic(lambda: torch.randn(8, generator=gen.set_state(state)))
    count = {"n": 0}

    def impure():
        count["n"] += 1
        return torch.full((4,), float(count["n"]))

    with pytest.raises(validate.DeterminismError, match="impure-counter"):
        validate.assert_deterministic(impure, label="impure-counter")


def test_assert_sharding_invariant_over_placements():
    x = np.arange(64, dtype=np.float64).reshape(8, 8)
    places = [torch.as_tensor, lambda a: torch.as_tensor(a).T.contiguous().T, lambda a: torch.as_tensor(a).clone()]
    validate.assert_sharding_invariant(lambda t: (t * 2.0).sum(dim=0), [x], places, rtol=0.0)

    def leaky(t):
        return t.sum() + (0.0 if t.is_contiguous() else 1.0)

    with pytest.raises(validate.DeterminismError, match="leaky: placement 1"):
        validate.assert_sharding_invariant(
            leaky, [x], [torch.as_tensor, lambda a: torch.as_tensor(a).T.contiguous().T], label="leaky"
        )


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_check_pipeline_determinism_on_seeded_random_freq_data(package):
    if package == "jax":
        summary = jvalidate.check_pipeline_determinism(SEEDED, runs=2)
    else:
        with default_device("cpu"):
            summary = validate.check_pipeline_determinism(SEEDED, runs=2)
    # two streams, each vis and weight plus its index and reverse maps
    assert summary["products"] == 1 and summary["arrays"] >= 4


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_check_pipeline_determinism_catches_unseeded_draws(package):
    with pytest.raises((validate.DeterminismError, jvalidate.DeterminismError), match="/vis"):
        if package == "jax":
            jvalidate.check_pipeline_determinism(UNSEEDED, runs=2)
        else:
            with default_device("cpu"):
                validate.check_pipeline_determinism(UNSEEDED, runs=2)


def test_check_pipeline_determinism_refuses_a_run_without_products():
    cfg = SEEDED.replace("pipeline:\n", "pipeline:\n  retain_products: none\n")
    with default_device("cpu"), pytest.raises(validate.DeterminismError, match="retained no products"):
        validate.check_pipeline_determinism(cfg)


def test_cli_verify_through_main(tmp_path, capsys):
    good, bad = tmp_path / "good.yaml", tmp_path / "bad.yaml"
    good.write_text(SEEDED)
    bad.write_text(UNSEEDED)
    assert main(["--platform", "cpu", "verify", str(good), "--runs", "3"]) == 0
    assert "verify ok: 1 product labels" in capsys.readouterr().out
    assert main(["--platform", "cpu", "verify", str(bad)]) == 1
    assert "VERIFY FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("seeded,code", [(True, 0), (False, 1)])
def test_cli_verify_in_a_subprocess(tmp_path, seeded, code):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(SEEDED if seeded else UNSEEDED)
    out = subprocess.run(
        [sys.executable, "-m", "draco_tpu_torch", "--platform", "cpu", "verify", str(cfg)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == code, out.stderr
    assert ("verify ok" if seeded else "VERIFY FAILED") in out.stdout


# -- the fixed-order segment sum -----------------------------------------------


def _pairwise(items):
    """Each output's items summed as the pairwise tree ``segment_sum`` takes."""
    items, step = list(items), 1
    while step < len(items):
        for i in range(0, len(items), 2 * step):
            if i + step < len(items):
                items[i] = items[i] + items[i + step]
        step *= 2
    return items[0]


@pytest.mark.parametrize("nout,n,dtype", [(5, 40, torch.complex128), (7, 3, torch.float64), (64, 2000, torch.float32)])
def test_segment_sum_is_a_fixed_pairwise_sum(nout, n, dtype):
    """Bitwise the pairwise tree in item order of each output's items (on any
    device the same bits), within rounding of ``index_add_``'s sequential sum:
    1e-12 of the largest sum in float64, 1e-5 in float32."""
    rng = np.random.Generator(np.random.SFC64(n))
    dst = rng.integers(0, nout, n)
    x = rng.standard_normal((3, n, 4)) + (1j * rng.standard_normal((3, n, 4)) if dtype.is_complex else 0.0)
    x = torch.from_numpy(x).to(dtype)
    plan = tools.segment_plan(dst, nout, "cpu")
    got = tools.segment_sum(x, plan, 1)
    ref = torch.zeros(3, nout, 4, dtype=dtype)
    for k in np.unique(dst):
        ref[:, k] = _pairwise([x[:, i] for i in np.flatnonzero(dst == k)])
    assert torch.equal(got, ref)
    assert torch.equal(tools.segment_sum(x.transpose(0, 1), plan, 0), ref.transpose(0, 1))
    seq = torch.zeros(3, nout, 4, dtype=dtype).index_add_(1, torch.as_tensor(dst), x)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert ((got - seq).abs().max() / seq.abs().max()).item() <= tol
    assert len(plan.levels) == int(np.ceil(np.log2(np.bincount(dst).max())))
