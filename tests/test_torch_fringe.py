"""The fringe x beam planes of the fused round trip's chunks.

On CPU operands ``ops/cuda_kernels.py::fringe_planes`` takes its plain
version (``fringe_planes_plain``: the fringe trig, with the geometry
dedup's row gather, then the beam product, in the windowed layout or
stacked in the full-sphere one), which float64 reference states call by
name on either device.  That chain is what the CUDA kernel (``csrc/fringe.cu``)
is held to bit for bit on the card (``tests/test_torch_cuda.py``).  Here
the wrapper's plain route is held to the phasors computed in float64 from
the same operands, and bit for bit to a frozen copy of the chain as the
round trip ran it before it moved into ``ops/`` (:func:`frozen_chain`), in
the layout each form consumes, for every chunk of synthetic states (every
combination of frequency grid, beam kind, polarisations and dedup) and of
states prepared from small telescopes.  This file imports no JAX; the
card's tests take their operands and reference from
:func:`synthetic_state`, :func:`chunk_args` and :func:`plain_chain`.
"""

import numpy as np
import pytest
import torch

from draco_tpu_torch.ops import cuda_kernels
from draco_tpu_torch.ops.tools import phase_frac3, sincos_turns, threefloat_split
from draco_tpu_torch.telescope import BeamTransfer, PolarisedCylinderTelescope, UnpolarisedDishArray
from draco_tpu_torch.telescope import roundtrip

CPU = torch.device("cpu")
# the float32 planes' largest error against float64 phasors, over max|beam|
# and the channels: a phase is good to ~3e-7 turns (2e-6 rad) whatever its
# turns, a uniform grid's rotation adds about that a step, and a complex
# beam's two terms double it (the cases here reach 4.5e-7)
TOL_PHASOR = 4e-6
NSIDE = 8
LMAX = dict(force_lmax=3 * NSIDE - 1, force_mmax=3 * NSIDE - 1)
DISH = dict(
    grid_ew=2, grid_ns=2, spacing_ew=4.0, spacing_ns=4.0, latitude=30.0, freq_lower=400.0, freq_upper=500.0,
    num_freq=3, dish_width=8.0, auto_correlations=True, **LMAX,
)
DUALPOL = dict(
    num_cylinders=2, cylinder_width=20.0, cylinder_spacing=22.0, num_feeds=3, feed_spacing=0.5, latitude=49.0,
    freq_lower=400.0, freq_upper=450.0, num_freq=2, auto_correlations=True, **LMAX,
)


def synthetic_state(form, nfreq, npol, chunk, nchunk, K, uniform_freq, uniform_real, geom, seed=0, device=CPU,
                    dtype=torch.float32):
    """The fringe operands of a round-trip state, drawn from ``seed``.

    Pixel unit vectors with every tenth slot a zero pad (zero beam too);
    baselines of up to ~100 m at 1/lambda ~1.6 per metre, so phases of up
    to ~160 turns, as three-float splits (float64: the value and two
    zeros, as a float64 state holds them); beams of 3 products (one real
    one when ``uniform_real``); with ``geom`` the full-sphere dedup's
    geometry rows (Gc 8, chunks starting 5 rows apart, products sorted by
    geometry).
    """
    rng = np.random.Generator(np.random.SFC64(seed))
    npad = chunk * nchunk
    vec = rng.standard_normal((K, 3))
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    pad = np.arange(K) % 10 == 9
    vec[pad] = 0.0
    if uniform_freq:
        inv_wl = 1.6 + 0.01 * np.arange(nfreq)
    else:
        inv_wl = np.sort(rng.uniform(1.5, 1.8, nfreq))

    def coeff(bl):
        if uniform_freq:
            return np.stack([bl * inv_wl[0], bl * 0.01])
        return bl[None] * inv_wl[:, None, None]

    def split3(a):
        if dtype == torch.float64:
            a = torch.as_tensor(a, device=device)
            return a, torch.zeros_like(a), torch.zeros_like(a)
        return tuple(torch.as_tensor(p, device=device) for p in threefloat_split(a))

    nuniq = 1 if uniform_real else 3
    u_re = rng.standard_normal((nfreq, nuniq, npol, K))
    u_im = np.zeros_like(u_re) if uniform_real else rng.standard_normal((nfreq, nuniq, npol, K))
    u_re[..., pad] = 0.0
    u_im[..., pad] = 0.0
    va, vb, vc = split3(vec)
    bla, blb, blc = split3(coeff(rng.uniform(-60.0, 60.0, (npad, 3)) * [1.0, 1.0, 0.1]))
    state = {
        "form": form,
        "va": va,
        "vb": vb,
        "vc": vc,
        "u_re": torch.as_tensor(u_re, dtype=dtype, device=device),
        "u_im": torch.as_tensor(u_im, dtype=dtype, device=device),
        "uidx": torch.as_tensor(rng.integers(0, nuniq, npad), device=device),
        "bla": bla,
        "blb": blb,
        "blc": blc,
        "uniform_real": uniform_real,
        "uniform_freq": uniform_freq,
    }
    if form == "windowed":
        state["dims"] = (nfreq, npol, chunk, nchunk, npad, K, 0, ())
        return state
    Gc = 8 if geom else 0
    state["dims"] = (nfreq, npol, chunk, nchunk, npad, 0, Gc)
    if geom:
        g0s = tuple(5 * c for c in range(nchunk))
        gvec = rng.uniform(-60.0, 60.0, (g0s[-1] + Gc, 3)) * [1.0, 1.0, 0.1]
        state["ga"], state["gb"], state["gc"] = split3(coeff(gvec))
        state["g0s"] = g0s
        state["lidx"] = torch.as_tensor(np.sort(rng.integers(0, Gc, (nchunk, chunk)), axis=1).reshape(-1), device=device)
    return state


def chunk_args(state, c):
    """(args, kwargs) of :func:`cuda_kernels.fringe_planes` for chunk ``c``
    of ``state``, as the round trip passes them: the chunk's coefficient
    rows, or under the dedup its geometry rows and each product's row among
    them; the windowed form's (re, im), the full-sphere form's stack."""
    chunk = state["dims"][2]
    rows = slice(c * chunk, (c + 1) * chunk)
    Gc = state["dims"][6] if state["form"] == "fullsphere" else 0
    if Gc:
        coeff, row0, lidx = (state["ga"], state["gb"], state["gc"]), state["g0s"][c], state["lidx"][rows]
    else:
        coeff, row0, lidx = (state["bla"], state["blb"], state["blc"]), c * chunk, None
    args = (*coeff, *(state[k] for k in ("va", "vb", "vc", "u_re", "u_im")), state["uidx"][rows], row0,
            state["uniform_freq"], state["uniform_real"])
    return args, {"lidx": lidx, "geom_rows": Gc, "stacked": state["form"] == "fullsphere"}


def plain_chain(state, c):
    """The wrapper's plain version of chunk ``c`` on the state's device."""
    args, kwargs = chunk_args(state, c)
    return cuda_kernels.fringe_planes_plain(*args, **kwargs)


def _frozen_trig(ba, bb, bc, va, vb, vc, c0, chunk, nfreq, uniform):
    Ba = ba[:, c0 : c0 + chunk]
    Bb = bb[:, c0 : c0 + chunk]
    Bc = bc[:, c0 : c0 + chunk]
    if not uniform:
        return sincos_turns(phase_frac3(Ba, Bb, Bc, va, vb, vc))
    c_f, s_f = sincos_turns(phase_frac3(Ba[0], Bb[0], Bc[0], va, vb, vc))
    if nfreq == 1:
        return c_f[None], s_f[None]
    cd, sd = sincos_turns(phase_frac3(Ba[1], Bb[1], Bc[1], va, vb, vc))
    cs, ss = [c_f], [s_f]
    for _ in range(nfreq - 1):
        c_f, s_f = cs[-1] * cd - ss[-1] * sd, cs[-1] * sd + ss[-1] * cd
        cs.append(c_f)
        ss.append(s_f)
    return torch.stack(cs), torch.stack(ss)


def _frozen_beam_planes(state, cph, sph, c):
    chunk = state["dims"][2]
    if state["uniform_real"]:
        b = state["u_re"][:, 0][:, None]
        return b * cph[:, :, None], b * sph[:, :, None]
    idx = state["uidx"][c * chunk : (c + 1) * chunk]
    br = state["u_re"].index_select(1, idx)
    bi = state["u_im"].index_select(1, idx)
    cp = cph[:, :, None]
    sp = sph[:, :, None]
    return br * cp - bi * sp, br * sp + bi * cp


def frozen_chain(state, c):
    """Chunk ``c``'s planes by a frozen copy of the round trip's plain chain
    as it stood before it moved into ``ops/`` (``_fringe_trig`` ->
    ``_beam_planes``, with the dedup's row gather): the oracle that the
    wrapper's plain route keeps every bit of."""
    nfreq, npol, chunk = state["dims"][:3]
    va, vb, vc = state["va"], state["vb"], state["vc"]
    if state["form"] == "windowed":
        cph, sph = _frozen_trig(state["bla"], state["blb"], state["blc"], va, vb, vc, c * chunk, chunk, nfreq,
                                state["uniform_freq"])
        re, im = _frozen_beam_planes(state, cph, sph, c)
        K = state["dims"][5]
        return re.reshape(nfreq, chunk, npol * K), im.reshape(nfreq, chunk, npol * K)
    Gc = state["dims"][6]
    if Gc:
        cg, sg = _frozen_trig(state["ga"], state["gb"], state["gc"], va, vb, vc, state["g0s"][c], Gc, nfreq,
                              state["uniform_freq"])
        idx = state["lidx"][c * chunk : (c + 1) * chunk]
        cph, sph = cg.index_select(1, idx), sg.index_select(1, idx)
    else:
        cph, sph = _frozen_trig(state["bla"], state["blb"], state["blc"], va, vb, vc, c * chunk, chunk, nfreq,
                                state["uniform_freq"])
    re, im = _frozen_beam_planes(state, cph, sph, c)
    return torch.stack([re, im])


def _sum64(*parts):
    return sum(p.double() for p in parts)


def float64_planes(state, c):
    """Chunk ``c``'s planes from the state's operands in float64: each
    product's coefficient row (its geometry row under the dedup), the phase
    ``b . n`` in turns from the summed three-float parts, exact cos and sin,
    then the beam product; in the layout :func:`plain_chain` returns."""
    nfreq, npol, chunk = state["dims"][:3]
    rows = torch.arange(c * chunk, (c + 1) * chunk)
    if state["form"] == "fullsphere" and state["dims"][6]:
        coeff, idx = (state["ga"], state["gb"], state["gc"]), state["g0s"][c] + state["lidx"][rows]
    else:
        coeff, idx = (state["bla"], state["blb"], state["blc"]), rows
    b = _sum64(*coeff)[:, idx]  # [G, C, 3]
    if state["uniform_freq"]:
        b = b[0] + torch.arange(nfreq, dtype=torch.float64)[:, None, None] * b[1]
    turns = b @ _sum64(state["va"], state["vb"], state["vc"]).T  # [f, C, K]
    cph, sph = (f(2 * np.pi * turns)[:, :, None] for f in (torch.cos, torch.sin))
    uidx = torch.zeros_like(rows) if state["uniform_real"] else state["uidx"][rows]
    br, bi = (state[k].double().index_select(1, uidx) for k in ("u_re", "u_im"))  # [f, C, p, K]
    re, im = br * cph - bi * sph, br * sph + bi * cph
    if state["form"] == "fullsphere":
        return torch.stack([re, im])
    return re.reshape(nfreq, chunk, -1), im.reshape(nfreq, chunk, -1)


_STATES = {}


def _real_state(name, dtype=torch.float32):
    if (name, dtype) not in _STATES:
        if name == "dish":
            bt = BeamTransfer(UnpolarisedDishArray(**DISH), nside=NSIDE)
        else:
            bt = BeamTransfer(PolarisedCylinderTelescope(**DUALPOL), nside=NSIDE)
        _STATES[name, dtype] = roundtrip.prepare_state(bt, chunk=8, dtype=dtype, device=CPU)
    return _STATES[name, dtype]


SYNTHETIC = {
    # name: (form, nfreq, npol, uniform_freq, uniform_real, geom)
    "windowed-uniform-real-npol1": ("windowed", 4, 1, True, True, False),
    "windowed-nonuniform-real-npol1": ("windowed", 3, 1, False, True, False),
    "windowed-uniform-complex-npol4": ("windowed", 3, 4, True, False, False),
    "windowed-nonuniform-complex-npol4": ("windowed", 2, 4, False, False, False),
    "windowed-one-channel": ("windowed", 1, 1, True, True, False),
    "fullsphere-dedup-uniform-complex-npol4": ("fullsphere", 2, 4, True, False, True),
    "fullsphere-dedup-nonuniform-complex-npol1": ("fullsphere", 3, 1, False, False, True),
    "fullsphere-dedup-uniform-real-npol4": ("fullsphere", 1, 4, True, True, True),
    "fullsphere-uniform-real-npol1": ("fullsphere", 2, 1, True, True, False),
    "fullsphere-nonuniform-complex-npol4": ("fullsphere", 3, 4, False, False, False),
}


CASES = list(SYNTHETIC) + ["dish", "dualpol-cylinder"]


def _state(case, dtype=torch.float32):
    if case in SYNTHETIC:
        form, nfreq, npol, uniform_freq, uniform_real, geom = SYNTHETIC[case]
        return synthetic_state(form, nfreq, npol, 6, 3, 50, uniform_freq, uniform_real, geom, seed=len(case),
                               dtype=dtype)
    state = _real_state(case, dtype)
    want_form, want_geom = ("windowed", False) if case == "dish" else ("fullsphere", True)
    assert state["form"] == want_form
    assert state["uniform_real"] == (case == "dish")
    assert state["form"] == "windowed" or (state["dims"][6] > 0) == want_geom
    return state


def _pairs(state, got, want):
    return list(zip(got, want)) if state["form"] == "windowed" else [(got, want)]


def _assert_near_float64_phasors(state, c, got):
    """``got`` lies within TOL_PHASOR x nfreq x max|beam| of the float64
    phasors times the beams."""
    nfreq = state["dims"][0]
    scale = max(state["u_re"].abs().max().item(), state["u_im"].abs().max().item())
    for g, w in _pairs(state, got, float64_planes(state, c)):
        assert g.shape == w.shape and g.dtype == state["u_re"].dtype
        err = (g.double() - w).abs().max().item()
        assert err <= TOL_PHASOR * nfreq * scale, f"chunk {c}: max |diff| {err:.3e}, max|beam| {scale:.3e}"


@pytest.mark.parametrize("case", CASES)
def test_plain_fringe_planes_match_float64_phasors(case):
    """The wrapper's float32 planes on the CPU (its plain version), in the
    layout each form consumes, lie within TOL_PHASOR x nfreq x max|beam| of
    the float64 phasors times the beams, for every chunk: each product's own
    coefficient row (or geometry row), its frequencies and its beam."""
    state = _state(case)
    for c in range(state["dims"][3]):
        args, kwargs = chunk_args(state, c)
        _assert_near_float64_phasors(state, c, cuda_kernels.fringe_planes(*args, **kwargs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("case", CASES)
def test_fringe_planes_on_cpu_states_are_the_frozen_chain(case, dtype):
    """On CPU states of either precision the wrapper takes its plain version
    and launches nothing: every chunk's planes hold every bit of
    :func:`frozen_chain`'s, and lie as near the float64 phasors as the
    float32 chain must."""
    state = _state(case, dtype)
    cuda_kernels.reset_launches()
    for c in range(state["dims"][3]):
        args, kwargs = chunk_args(state, c)
        got = cuda_kernels.fringe_planes(*args, **kwargs)
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        for g, w in _pairs(state, got, frozen_chain(state, c)):
            assert g.shape == w.shape and g.dtype == w.dtype == dtype
            assert torch.equal(g.contiguous().view(bits), w.contiguous().view(bits)), f"chunk {c}"
        _assert_near_float64_phasors(state, c, got)
    assert cuda_kernels.launches["fringe"] == 0


@pytest.mark.parametrize("form", ["windowed", "fullsphere"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_float64_states_launch_no_kernel(form, dtype):
    """A CPU state runs the plain chain in either precision: the round trip
    never reaches the wrapper's launch, and launches stays 0."""
    tel = UnpolarisedDishArray(**DISH) if form == "windowed" else PolarisedCylinderTelescope(**DUALPOL)
    bt = BeamTransfer(tel, nside=NSIDE)
    state = roundtrip.prepare_state(bt, chunk=8, dtype=dtype, device=CPU)
    assert state["form"] == form and state["va"].device == CPU and state["va"].dtype == dtype
    sky = torch.as_tensor(
        np.random.Generator(np.random.SFC64(3)).standard_normal((tel.nfreq, tel.num_pol_sky, 12 * NSIDE**2)),
        dtype=dtype,
    )
    cuda_kernels.reset_launches()
    out = roundtrip.fused_roundtrip(state, sky)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert cuda_kernels.launches["fringe"] == 0


def test_fringe_planes_refuse_what_they_do_not_take():
    """Shapes, rows and the dedup's geometry rows are checked first; then
    CPU tensors take the plain version, and tensors on two devices raise
    (a meta tensor stands in for the card)."""
    state = synthetic_state("windowed", 3, 1, 4, 2, 20, True, True, False)
    args = [state[k] for k in ("bla", "blb", "blc", "va", "vb", "vc", "u_re", "u_im")]
    uidx = state["uidx"][:4]
    re, im = cuda_kernels.fringe_planes(*args, uidx, 0, True, True)
    assert re.shape == im.shape == (3, 4, 20) and re.dtype == torch.float32
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.fringe_planes(*args[:6], args[6].to("meta"), args[7], uidx, 0, True, True)
    with pytest.raises(IndexError):
        cuda_kernels.fringe_planes(*args, uidx, 6, True, True)
    lidx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="geom_rows"):
        cuda_kernels.fringe_planes(*args, uidx, 0, True, True, lidx=lidx)
    with pytest.raises(IndexError):
        cuda_kernels.fringe_planes(*args, uidx, 0, True, True, lidx=lidx, geom_rows=9)
    with pytest.raises(ValueError):
        cuda_kernels.fringe_planes(*args, uidx, 0, False, True)  # 3 channels need 3 groups off a uniform grid
    bad = list(args)
    bad[3] = bad[3][:-1]
    with pytest.raises(ValueError):
        cuda_kernels.fringe_planes(*bad, uidx, 0, True, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_round_trip_calls_the_plain_version_by_name_for_float64_states(dtype):
    """A float64 reference state's planes come from the plain version,
    called by name (the wrapper would raise on the card); a float32 state's
    from the wrapper, which takes the kernel on the card."""
    state = synthetic_state("windowed", 2, 1, 4, 2, 20, True, True, False, dtype=dtype)
    want = cuda_kernels.fringe_planes_plain if dtype == torch.float64 else cuda_kernels.fringe_planes
    assert roundtrip._fringe_planes_of(state) is want
