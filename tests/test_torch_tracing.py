"""Profiler spans of the fused round trip (``draco_tpu_torch.util.trace``).

A tiny dish array runs the windowed form and a tiny dual-pol cylinder the
full-sphere form, each in several baseline chunks, under ``torch.profiler``
with CPU activity only.  Each call is one ``roundtrip.call`` span; the
stage spans lie inside it, appear once a call or once a chunk, and never
nest in a span of their own name (a reader matches a launch to the latest
range of a name).  The spans change no bit of the maps, and with no
profiler recording the helper enters no ``record_function`` at all.

On the card (marker ``cuda``), each hand-written kernel launched inside a
span is linked to it: ``portbench/trace.py``'s reading gives the span the
kernel's device time.
"""

from __future__ import annotations

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from draco_tpu_torch import telescope as tmod
from draco_tpu_torch.ops import cuda_kernels, sht
from draco_tpu_torch.telescope import roundtrip
from draco_tpu_torch.util import trace

F0 = 299.792458 / 0.6
CALL = "roundtrip.call"
# (telescope, chunk, spans once a call, spans once a chunk)
CASES = {
    "dish": (
        lambda: tmod.UnpolarisedDishArray(
            grid_ew=3, grid_ns=3, spacing_ew=7.0, spacing_ns=7.0, jitter=1.0, jitter_seed=1, latitude=45.0,
            dish_width=5.0, fwhm_factor=1.0, auto_correlations=True, freq_lower=0.95 * F0, freq_upper=1.05 * F0,
            num_freq=2, force_lmax=23, force_mmax=23,
        ),
        16,
        ("windowed.sky_transform", "windowed.map_transform"),
        ("windowed.fringe_build", "windowed.project", "windowed.accumulate"),
    ),
    "cylinder": (
        lambda: tmod.PolarisedCylinderTelescope(
            num_cylinders=2, num_feeds=4, cylinder_width=20.0, cylinder_spacing=22.0, feed_spacing=0.3048,
            latitude=49.32, auto_correlations=True, freq_lower=F0, freq_upper=F0, num_freq=1, force_lmax=23,
            force_mmax=23,
        ),
        8,
        ("fullsphere.sky_sections", "fullsphere.adjoint_synthesis"),
        ("fullsphere.fringe_build", "fullsphere.ring_analysis", "fullsphere.uv_contraction",
         "fullsphere.t_accumulate"),
    ),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The round trip of one form, its inputs, and one profiled call: the
    spans the call recorded ({name: [(start_ns, end_ns)]}) and its maps."""
    make_tel, chunk, per_call, per_chunk = CASES[request.param]
    tel = make_tel()
    run = roundtrip.fused_roundtrip_fn(tmod.BeamTransfer(tel, nside=8), chunk=chunk, device="cpu")
    g = torch.Generator().manual_seed(3)
    sky = torch.randn(tel.nfreq, tel.num_pol_sky, 12 * 8**2, generator=g)
    weight = 0.5 + torch.rand(24, 2, tel.nfreq, len(tel.uniquepairs), generator=g)
    run(sky, weight)  # tables built before the profiled call
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run(sky, weight)
    spans: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            spans.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {
        "run": run, "sky": sky, "weight": weight, "traced": traced, "spans": spans,
        "nchunk": run.state["dims"][3], "per_call": per_call, "per_chunk": per_chunk,
    }


def test_each_span_appears_once_a_call_or_once_a_chunk(case):
    assert case["nchunk"] >= 2
    want = Counter({CALL: 1, **dict.fromkeys(case["per_call"], 1), **dict.fromkeys(case["per_chunk"], case["nchunk"])})
    assert Counter({name: len(r) for name, r in case["spans"].items()}) == want


def test_every_stage_span_lies_inside_the_call(case):
    (c0, c1), = case["spans"][CALL]
    for name, ranges in case["spans"].items():
        for a, b in ranges:
            assert c0 <= a <= b <= c1, name


def test_no_span_nests_inside_one_of_its_own_name(case):
    for name, ranges in case["spans"].items():
        ranges = sorted(ranges)
        assert all(prev[1] <= nxt[0] for prev, nxt in zip(ranges, ranges[1:])), name


def test_the_maps_are_bit_identical_with_the_profiler_on_and_off(case):
    plain = case["run"](case["sky"], case["weight"])
    assert torch.equal(plain, case["traced"])


def test_no_record_function_is_entered_without_a_profiler(case, monkeypatch):
    entered = Counter()
    real = trace.record_function

    def counting(name):
        entered[name] += 1
        return real(name)

    monkeypatch.setattr(trace, "record_function", counting)
    case["run"](case["sky"], case["weight"])
    assert not entered
    with profile(activities=[ProfilerActivity.CPU]):
        case["run"](case["sky"], case["weight"])
    assert entered == Counter({name: len(r) for name, r in case["spans"].items()})


def test_the_helper_is_one_shared_no_op_without_a_profiler():
    assert trace.span("a") is trace.span("b")
    with trace.span("a") as inner:
        assert inner is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(trace.span("a"), torch.profiler.record_function)


# kernel -> the name of its CUDA function, which the trace's device events carry
KERNEL_FUNCTIONS = {
    "legendre": "legendre_kernel",
    "beamform": "beamform_rows",
    "banded_covariance": "banded_covariance_kernel",
    "fringe": "fringe_kernel",
}


def _kernel_call(kernel, cuda):
    """One call of ``kernel``'s wrapper on small seeded inputs made on the card beforehand."""
    g = torch.Generator(cuda).manual_seed(7)
    if kernel == "legendre":
        return lambda: sht.SHT(8)._legendre_block(torch.arange(6).numpy(), torch.float64, cuda)
    if kernel == "beamform":
        nfreq, nra, nprod, S, nha = 2, 32, 16, 5, 4
        vis = torch.randn(nfreq, nra, nprod, dtype=torch.complex64, device=cuda, generator=g)
        sw = torch.rand(nfreq, nra, nprod, device=cuda, generator=g)
        ra_idx = torch.randint(0, nra, (S, nha), dtype=torch.int32, device=cuda, generator=g)
        a, b = (torch.randn(S, nha, device=cuda, generator=g) for _ in range(2))
        u, v = (torch.randn(nfreq, nprod, device=cuda, generator=g) for _ in range(2))
        return lambda: cuda_kernels.beamform_sums(vis, sw, None, ra_idx, a, b, u, v, False)
    if kernel == "banded_covariance":
        R = torch.randn(40, 100, device=cuda, generator=g)
        Ni = torch.rand(3, 100, device=cuda, generator=g)
        return lambda: cuda_kernels.banded_covariance_batched(R, Ni, 4)
    from test_torch_fringe import chunk_args, synthetic_state

    args, kwargs = chunk_args(synthetic_state("fullsphere", 2, 4, 8, 2, 64, True, False, True, device=cuda), 1)
    return lambda: cuda_kernels.fringe_planes(*args, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(KERNEL_FUNCTIONS))
def test_trace_gives_each_kernel_to_the_span_that_launched_it(kernel):
    """One launch of the kernel (through its operator) inside a span, the
    only work of the traced window: the span holds nonzero device ms, all
    the window's device time, the kernel's included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd.profiler import record_function

    from portbench.trace import WINDOW, from_profile

    cuda = torch.device("cuda", 0)
    call = _kernel_call(kernel, cuda)
    call()  # built and warm
    torch.cuda.synchronize()
    name = f"kernel.{kernel}"
    before = cuda_kernels.launches[kernel]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            with trace.span(name):
                call()
            torch.cuda.synchronize()
    assert cuda_kernels.launches[kernel] == before + 1
    tr = from_profile(prof, spans=(name,))
    own = [b - a for a, b, fn in tr.device if KERNEL_FUNCTIONS[kernel] in fn]
    assert len(own) == 1 and own[0] > 0 and tr.span_count[name] == 1
    assert tr.span_device_s[name] > 0
    assert tr.span_device_s[name] == pytest.approx(sum(b - a for a, b, _ in tr.device), rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("kernel", sorted(KERNEL_FUNCTIONS))
def test_each_kernel_is_an_operator_that_writes_only_its_outputs(kernel):
    """``draco_tpu_torch::<kernel>`` takes (entry, inputs, outputs, ints),
    marks only the outputs as written, and has no CPU implementation: a
    call with CPU tensors raises and counts no launch."""
    op = cuda_kernels._operators()[kernel]
    entry, inputs, outputs, ints = op._schema.arguments
    assert (entry.name, inputs.name, outputs.name, ints.name) == ("entry", "inputs", "outputs", "ints")
    assert inputs.alias_info is None
    assert outputs.alias_info is not None and outputs.alias_info.is_write
    entry_name = next(iter(cuda_kernels._ENTRIES[kernel]))
    before = cuda_kernels.launches[kernel]
    with pytest.raises(NotImplementedError):
        cuda_kernels._launch(kernel, entry_name, [torch.zeros(2)], [torch.zeros(2)], [1])
    assert cuda_kernels.launches[kernel] == before


def test_a_launch_passes_pointers_and_integers_in_argtype_order(monkeypatch):
    """The operator's implementation calls the entry point with each
    tensor's address (NULL for None), inputs then outputs, and the integers
    where its argtypes put them, the stream last; a wrong count raises
    TypeError and a nonzero CUDA error RuntimeError naming the kernel."""
    import contextlib
    import types

    calls = []
    err = [0]

    def entry_point(*args):
        calls.append(args)
        return err[0]

    is_ptr = tuple(k is cuda_kernels._PTR for k in cuda_kernels._ENTRIES["fringe"]["fringe_planes_f32"][:-1])
    monkeypatch.setattr(cuda_kernels, "_entry_point", lambda kernel, entry: (entry_point, is_ptr, sum(is_ptr)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(cuda_stream=77))
    inputs = [torch.zeros(3) for _ in range(9)] + [None]
    outputs = [torch.zeros(3), torch.zeros(3)]
    ints = list(range(100, 110))
    cuda_kernels._run("fringe", "fringe_planes_f32", inputs, outputs, ints)
    p = [t.data_ptr() for t in inputs[:9]] + [None] + [t.data_ptr() for t in outputs]
    assert calls == [(*p[:3], 100, *p[3:10], 101, *p[10:], *range(102, 110), 77)]
    with pytest.raises(TypeError, match="takes 12 tensors and 10 integers"):
        cuda_kernels._run("fringe", "fringe_planes_f32", inputs, outputs, ints[:-1])
    err[0] = 700
    with pytest.raises(RuntimeError, match="fringe kernel launch failed: CUDA error 700"):
        cuda_kernels._run("fringe", "fringe_planes_f32", inputs, outputs, ints)
