"""The readers of the round trip's spans (``portbench/layers/``): the stage
readers, ``roundtrip.idle_ms`` and ``roundtrip.host_syncs`` on synthetic
traces with known gaps, call ranges and runtime calls; the tiny cells read
on the CPU; every span the program records read by some metric.

    python -m pytest portbench/tests -q

Tests marked ``cuda`` need the card and skip elsewhere: there the trace's
clock puts each kernel after its launch, and a synchronise inside a call is
counted.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run, spec, trace  # noqa: E402
from test_portbench_harness import BIG_SEED, CYLINDER, DISH, bench, tiny_cell  # noqa: E402

CPU = torch.device("cpu")
CALL = "roundtrip.call"
STAGES = {
    "dish": ["windowed.sky_transform_ms", "windowed.fringe_build_ms", "windowed.project_ms",
             "windowed.accumulate_ms", "windowed.map_transform_ms"],
    "cylinder": ["fullsphere.sky_sections_ms", "fullsphere.fringe_build_ms", "fullsphere.ring_analysis_ms",
                 "fullsphere.uv_contraction_ms", "fullsphere.t_accumulate_ms", "fullsphere.adjoint_synthesis_ms"],
}
CALL_METRICS = ["roundtrip.idle_ms", "roundtrip.host_syncs"]


def reader(name: str):
    return spec.load_module(ROOT / "portbench" / "layers" / f"{name}.py")


def call_trace() -> trace.Trace:
    """Two calls, (0.05, 0.40) and (0.45, 0.95), in a window of 1 s: the card
    idle 0.00-0.10, 0.30-0.50 and 0.60-0.90, and runtime calls inside the
    calls, between them and after them."""
    device = [(0.1, 0.3, "k1"), (0.5, 0.6, "k2"), (0.9, 1.0, "k1")]
    host = [
        (0.05, 0.40, CALL), (0.45, 0.95, CALL), (0.06, 0.35, "windowed.project"),
        (0.10, 0.11, "cudaMemcpyAsync"), (0.11, 0.12, "cudaStreamSynchronize"),  # a pageable copy: one wait
        (0.20, 0.21, "cudaLaunchKernel"), (0.41, 0.44, "cudaFree"),  # between the calls
        (0.50, 0.51, "cudaMemcpy"), (0.60, 0.61, "cudaEventSynchronize"),
        (0.70, 0.71, "aten::copy_"), (0.97, 0.99, "cudaDeviceSynchronize"),  # after the last call
    ]
    return trace.Trace((0.0, 1.0), device, host)


def test_idle_ms_is_the_idle_time_inside_the_calls():
    # 0.05-0.10 and 0.30-0.40 in the first call, 0.45-0.50 and 0.60-0.90 in the second; 0.40-0.45 lies
    # between them
    assert reader("roundtrip.idle_ms").read({"trace": call_trace(), "calls": 2}) == pytest.approx(1e3 * 0.5 / 2)


def test_host_syncs_counts_the_waits_that_start_inside_the_calls():
    # cudaStreamSynchronize, cudaMemcpy and cudaEventSynchronize, over two calls
    assert reader("roundtrip.host_syncs").read({"trace": call_trace(), "calls": 2}) == pytest.approx(1.5)


@pytest.mark.parametrize("name", CALL_METRICS)
def test_call_readers_read_nothing_without_calls(name):
    tr = call_trace()
    assert reader(name).read({"trace": None, "calls": 2}) is None
    assert reader(name).read({"trace": tr, "calls": 0}) is None
    no_call = trace.Trace(tr.window, tr.device, [h for h in tr.host if h[2] != CALL])
    assert reader(name).read({"trace": no_call, "calls": 2}) is None


def test_idle_ms_reads_nothing_without_device_activity():
    tr = call_trace()
    assert reader("roundtrip.idle_ms").read({"trace": trace.Trace(tr.window, [], tr.host), "calls": 2}) is None


@pytest.mark.parametrize("name", STAGES["dish"] + STAGES["cylinder"])
def test_a_stage_reader_reads_its_span_and_nothing_without_it(name):
    r = reader(name)
    (span,) = r.SPANS
    assert name == f"{span}_ms"
    tr = trace.Trace((0.0, 1.0), [(0.1, 0.2, "k")], [])
    assert r.read({"trace": tr, "calls": 2}) is None
    tr.span_device_s, tr.span_count = {span: 0.3}, {span: 4}
    assert r.read({"trace": tr, "calls": 2}) == pytest.approx(150.0)
    assert r.read({"trace": None, "calls": 2}) is None


def test_the_benchmark_names_every_new_reader_for_its_cells():
    per_layer = {m["name"]: m for m in bench()["per_layer"]}
    for form, cell in (("dish", "dish64.fused8"), ("cylinder", "chime2048.fused1")):
        for name in STAGES[form] + CALL_METRICS:
            m = per_layer[name]
            assert cell in m["workloads"] and m["source"] == "device_trace" and m["moves"] == "channels_per_s"
    for name in CALL_METRICS:
        assert per_layer[name]["workloads"] == ["dish64.fused8", "chime2048.fused1"]


@pytest.mark.parametrize("config,name", [(DISH, "fused8"), (CYLINDER, "fused1")], ids=["dish", "cylinder"])
def test_a_traced_tiny_cell_reads_every_metric_that_needs_no_device(config, name):
    form = "dish" if config is DISH else "cylinder"
    cell = tiny_cell(config, name, STAGES[form] + CALL_METRICS)
    result, _ = run.run_cell(cell, BIG_SEED, 0.2, True, CPU)
    # idle time needs a device's activity; the stages' spans and the runtime's waits do not
    assert set(result["metrics"]) == set(STAGES[form]) | {"roundtrip.host_syncs"}
    assert result["metrics"]["roundtrip.host_syncs"]["value"] == 0.0


@pytest.mark.parametrize("config,name", [(DISH, "fused8"), (CYLINDER, "fused1")], ids=["dish", "cylinder"])
def test_every_span_the_program_records_is_read_by_a_metric(config, name):
    from torch.profiler import ProfilerActivity, profile

    layers = (ROOT / "portbench" / "layers").glob("*.py")
    read = {s for path in layers for s in getattr(spec.load_module(path), "SPANS", ())}
    read |= {reader(m).CALL for m in CALL_METRICS}
    cell = tiny_cell(config, name)
    drv = cell.driver.Driver(config, cell.traffic, BIG_SEED, CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv.step(0)
    recorded = {e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    assert CALL in recorded and recorded <= read, recorded - read


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _profiled(card, body):
    """``body()`` inside the harness's window span, traced on the host and the card."""
    from torch.profiler import ProfilerActivity, profile, record_function

    body()  # every allocation and library handle made before the trace
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            body()
    return prof


@pytest.mark.cuda
def test_a_kernel_launched_inside_a_call_starts_after_its_launch(card):
    from torch.autograd import DeviceType

    from portbench.drivers.fused import program_telescope
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    _, bt = program_telescope(DISH)
    sky = torch.randn(2, 1, 12 * DISH["nside"] ** 2, device=card)
    prof = _profiled(card, lambda: fused_simulate_to_map(bt, sky))
    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    (call,) = [(e.start_ns(), e.end_ns()) for e in cpu if e.name() == CALL]
    launch_ns = {e.correlation_id(): e.start_ns() for e in cpu if call[0] <= e.start_ns() <= call[1]}
    kernels = [(launch_ns[e.linked_correlation_id()], e.start_ns()) for e in events
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
               and e.linked_correlation_id() in launch_ns]
    assert len(kernels) > 10
    assert all(start >= launched for launched, start in kernels)


@pytest.mark.cuda
def test_a_synchronise_inside_a_call_is_counted(card):
    from torch.profiler import record_function

    x = torch.randn(256, 256, device=card)
    host = np.arange(1 << 16, dtype=np.float32)

    def synchronised():
        with record_function(CALL):
            (x @ x).sum()
            torch.cuda.synchronize(card)

    def pageable_copy():
        with record_function(CALL):
            torch.as_tensor(host, device=card).sum()

    syncs = reader("roundtrip.host_syncs")
    assert syncs.read({"trace": trace.from_profile(_profiled(card, synchronised)), "calls": 1}) == 1.0
    assert syncs.read({"trace": trace.from_profile(_profiled(card, pageable_copy)), "calls": 1}) >= 1.0
