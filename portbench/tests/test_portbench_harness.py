"""The benchmark's harness on the CPU at tiny sizes: cells found by name, a
cell added by files alone, the window and trace arithmetic, the reference
against the port, the checks failing on broken programs, and no JAX.

    python -m pytest portbench/tests -q

Tests marked ``cuda`` need the card and skip elsewhere.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import inputs, run, spec, trace  # noqa: E402
from portbench.window import whole_calls  # noqa: E402

CPU = torch.device("cpu")
F0 = 299.792458 / 0.6
DISH = {
    "telescope": {"class": "UnpolarisedDishArray", "grid_ew": 3, "grid_ns": 3, "spacing_ew": 7.0, "spacing_ns": 7.0,
                  "jitter": 1.0, "jitter_seed": 1, "latitude": 45.0, "dish_width": 5.0, "fwhm_factor": 1.0,
                  "auto_correlations": True},
    "band": {"freq_lower": 0.95 * F0, "freq_upper": 1.05 * F0, "num_freq": 2},
    "nside": 8, "lmax": 23, "mmax": 23,
}
CYLINDER = {
    "telescope": {"class": "PolarisedCylinderTelescope", "num_cylinders": 2, "num_feeds": 4, "cylinder_width": 20.0,
                  "cylinder_spacing": 22.0, "feed_spacing": 0.3048, "latitude": 49.32, "auto_correlations": True},
    "band": {"freq_lower": F0, "freq_upper": F0, "num_freq": 1},
    "nside": 8, "lmax": 23, "mmax": 23,
}
BIG_SEED = 2**31 + 12345


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def traffic(name: str, **changes) -> dict:
    t = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
    t.update(changes)
    return t


def tiny_cell(config: dict, traffic_name: str, metrics=(), **changes) -> spec.Cell:
    t = traffic(traffic_name, **changes)
    driver = spec.load_module(ROOT / "portbench" / "drivers" / f"{t['driver']}.py")
    layers = [({"name": n, "unit": "u"}, spec.load_module(ROOT / "portbench" / "layers" / f"{n}.py")) for n in metrics]
    return spec.Cell("tiny", 1, config, t, driver, bench()["end_to_end"], layers)


def passes(checks) -> bool:
    return bool(checks) and all(np.isfinite(v) and v <= lim for _, v, lim in checks)


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- found by name -----------------------------------------------------------


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_every_cell_is_found_by_name(name):
    b = bench()
    cell = spec.load_cell(name, ROOT)
    w = next(w for w in b["workloads"] if w["name"] == name)
    assert cell.chips == w["chips"] == 1
    assert hasattr(cell.driver, "Driver")
    assert cell.traffic["driver"] == Path(cell.driver.__file__).stem
    assert {m["name"] for m in cell.end_to_end} == {"channels_per_s", "peak_gib", "setup_s"}
    want = {m["name"] for m in b["per_layer"] if name in m.get("workloads", [name])}
    assert {m["name"] for m, _ in cell.per_layer} == want
    for _, reader in cell.per_layer:
        assert callable(reader.read)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert set(c["reduced"]) == set(json.loads((ROOT / c["file"]).read_text())["reduced"])


def test_a_cell_is_added_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    (tmp_path / "portbench" / "configs" / "tinydish.json").write_text(json.dumps({"name": "tinydish", **DISH}))
    (tmp_path / "portbench" / "traffic" / "tinyfused.json").write_text(json.dumps(traffic("fused8", check_calls=1)))
    b["configs"].append({"name": "tinydish", "source": "a test", "file": "portbench/configs/tinydish.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tinydish.tinyfused", "config": "tinydish", "traffic": "tinyfused", "chips": 1,
                           "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("tinydish.tinyfused", tmp_path)
    assert Path(cell.driver.__file__).parent == tmp_path / "portbench" / "drivers"
    assert [m["name"] for m, _ in cell.per_layer] == ["device.idle_share"]
    result, checks = run.run_cell(cell, BIG_SEED, 0.3, False, CPU)
    assert passes(checks)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"channels_per_s", "peak_gib", "setup_s"}
    assert result["metrics"]["channels_per_s"]["value"] > 0


# -- the window, the trace, the inputs ----------------------------------------


def test_the_rate_is_over_whole_calls():
    step_s, seconds = 0.05, 0.12

    def step(k):
        time.sleep(step_s)
        return 8

    t = {}
    calls, units, call_s = whole_calls(step, seconds, lambda: t.setdefault("a", time.perf_counter()),
                               lambda: t.setdefault("b", time.perf_counter()))
    window = t["b"] - t["a"]
    assert calls == 3 and units == 24  # calls start at 0, 0.05 and 0.10 s; the third ends the window
    assert len(call_s) == 3 and min(call_s) >= step_s and sum(call_s) <= t["b"] - t["a"]
    assert window >= calls * step_s and window >= seconds
    assert units / window <= 8 / step_s


def tiny_trace() -> trace.Trace:
    device = [(0.1, 0.3, "k1"), (0.2, 0.4, "k2"), (0.6, 0.7, "k1"), (0.95, 1.0, "k3")]
    host = [(0.0, 1.0, "outer"), (0.4, 0.6, "inner"), (0.45, 0.5, "innermost")]
    return trace.Trace((0.0, 1.0), device, host)


def test_busy_time_is_the_union_of_device_intervals():
    tr = tiny_trace()
    assert trace.union(tr.device) == [(0.1, 0.4), (0.6, 0.7), (0.95, 1.0)]
    assert trace.busy_s(tr) == pytest.approx(0.45)
    assert trace.idle_share(tr) == pytest.approx(0.55)
    assert trace.gaps(tr) == pytest.approx([(0.0, 0.1), (0.4, 0.6), (0.7, 0.95)])


def test_breakdown_names_ops_and_what_the_host_did_in_each_gap():
    tr = tiny_trace()
    b = trace.breakdown(tr)
    assert [name for name, _ in b["device_ops"]] == ["k1", "k2", "k3"]
    assert b["device_ops"][0][1] == pytest.approx(0.3)
    assert b["idle_gaps"][0] == ["outer", pytest.approx(0.25)]  # 0.7-0.95: only the outer span
    assert b["idle_gaps"][1] == ["innermost", pytest.approx(0.2)]  # 0.4-0.6, middle 0.5 in the innermost op
    assert trace.host_at(trace.Trace((0, 1), [], []), [0.5]) == ["idle"]


def test_inputs_repeat_for_any_seed_and_the_sample_is_fair():
    a = inputs.sky(CPU, BIG_SEED, 3, (2, 1, 48))
    assert torch.equal(a, inputs.sky(CPU, BIG_SEED, 3, (2, 1, 48)))
    assert not torch.equal(a, inputs.sky(CPU, BIG_SEED, 4, (2, 1, 48)))
    assert not torch.equal(a, inputs.sky(CPU, -BIG_SEED, 3, (2, 1, 48)))
    w = inputs.mmode_weight(CPU, 2**40, 0, (24, 2, 2, 37), 0.5, 2.0, 0.01, 0.05)
    assert float(w.max()) < 2.0 and (w == 0).any() and float(w[w > 0].min()) >= 0.5
    kept = np.zeros(10)
    for seed in range(400):
        slot, last = inputs.reservoir(seed, 2), {}
        for k in range(10):
            s = slot(k)
            if s is not None:
                last[s] = k
        kept[list(last.values())] += 1
    assert kept.sum() == 800 and kept.min() > 40  # each call kept about 80 times in 400


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", bench()["workloads"][0]["name"], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# -- the reference against the port -------------------------------------------


@pytest.mark.parametrize("config", [DISH, CYLINDER], ids=["dish", "cylinder"])
def test_reference_round_trip_matches_the_port_in_float64(config):
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map
    from portbench.drivers.fused import program_telescope, reference_telescope
    from portbench.reference.roundtrip import RoundTrip

    config = {**config, "nside": 16, "lmax": 47, "mmax": 47}
    tel, bt = program_telescope(config)
    ref_tel = reference_telescope(config)
    np.testing.assert_array_equal(ref_tel.baselines, tel.baselines)
    g = torch.Generator().manual_seed(5)
    sky = torch.randn(tel.nfreq, tel.num_pol_sky, 12 * config["nside"] ** 2, generator=g, dtype=torch.float64)
    w = 0.5 + torch.rand(config["mmax"] + 1, 2, tel.nfreq, ref_tel.nbase, generator=g, dtype=torch.float64)
    want = RoundTrip(ref_tel)(sky, w)
    got = fused_simulate_to_map(bt, sky, weight=w, device="cpu")
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-7
    got32 = fused_simulate_to_map(bt, sky.float(), weight=w.float(), device="cpu")
    assert ((got32.double() - want).abs().max() / want.abs().max()).item() < 1e-5


def test_fused_cells_are_correct_on_the_cpu():
    for config in (DISH, CYLINDER):
        result, checks = run.run_cell(tiny_cell(config, "fused8" if config is DISH else "fused1"), BIG_SEED, 0.2,
                                      False, CPU)
        assert passes(checks), checks


# -- broken programs fail the check ------------------------------------------


def _broken_round_trip(kind):
    from draco_tpu_torch.telescope import roundtrip

    real = roundtrip.fused_simulate_to_map

    def broken(bt, sky, chunk=None, weight=None, device=None):
        if kind == "unchanged":
            return sky.clone()
        out = real(bt, sky, chunk=chunk, weight=weight, device=device)
        if kind == "half_batch":
            out[out.shape[0] // 2:] = out[: out.shape[0] // 2].mean(0)
        elif kind == "altered":  # one pixel off by ten times the limit
            out[0, 0, out.shape[-1] // 3] += 10 * traffic("fused8")["limits"]["map_rel_err"] * out.abs().max()
        return out

    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_a_broken_round_trip_is_not_correct(kind, monkeypatch):
    from draco_tpu_torch.telescope import roundtrip

    monkeypatch.setattr(roundtrip, "fused_simulate_to_map", _broken_round_trip(kind))
    _, checks = run.run_cell(tiny_cell(DISH, "fused8"), BIG_SEED, 0.2, False, CPU)
    assert not passes(checks), checks


# -- no JAX ----------------------------------------------------------------------


def _loaded_top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_cell_imports_jax_or_the_jax_package():
    names = [w["name"] for w in bench()["workloads"]]
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from pathlib import Path\n"
            "from portbench import run, spec\n"
            f"for n in {names!r}:\n"
            "    cell = spec.load_cell(n, Path('.'))\n"
            "import draco_tpu_torch.telescope, draco_tpu_torch.telescope.roundtrip\n"
            "from portbench.drivers import fused\n")
    top = _loaded_top_levels(code)
    assert "draco_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "draco_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    top = _loaded_top_levels("import portbench.reference.geometry, portbench.reference.sht, "
                             "portbench.reference.roundtrip")
    assert not top & {"jax", "jaxlib", "flax", "draco_tpu", "draco_tpu_torch"}


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("config,name", [(DISH, "fused8"), (CYLINDER, "fused1")], ids=["dish", "cylinder"])
def test_the_control_fails_the_limit(card, config, name):
    """The reference put in the program's place one precision down (float32
    with TF32 matmuls) reads above the cell's limit; the program does not."""
    from portbench.drivers.fused import Driver

    config = {**config, "nside": 64, "lmax": 191, "mmax": 191}
    t = traffic(name)
    drv = Driver(config, t, BIG_SEED, card)
    limit = t["limits"]["map_rel_err"]
    assert drv.reading(program=True)["program.map_rel_err"] <= limit
    assert drv.reading(program=False)["control.map_rel_err"] > limit
