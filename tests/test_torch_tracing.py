"""Profiler spans of the fused round trip (``draco_tpu_torch.util.trace``).

A tiny dish array runs the windowed form and a tiny dual-pol cylinder the
full-sphere form, each in several baseline chunks, under ``torch.profiler``
with CPU activity only.  Each call is one ``roundtrip.call`` span; the
stage spans lie inside it, appear once a call or once a chunk, and never
nest in a span of their own name (a reader matches a launch to the latest
range of a name).  The spans change no bit of the maps, and with no
profiler recording the helper enters no ``record_function`` at all.
"""

from __future__ import annotations

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from draco_tpu_torch import telescope as tmod
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
