"""The SHT's chunked route: draco_tpu_torch against draco_tpu's on-the-fly transforms.

The JAX package's public ``SHT.analysis``/``synthesis`` never build the
whole Legendre tensor: they make it ``chunk_m`` m at a time.  The port's
chunked route (``_analysis_impl``/``_synthesis_impl`` with ``lam=None``)
does the same with two-float Legendre rows for float32 maps, where the
JAX package uses float32 rows: a deliberate difference, so in float32 the
port must be at least as close to float64 as the JAX package is.

Tolerances, max|diff| / max|ref|: float64 against the JAX package 1e-10;
float64 chunk sizes against each other 1e-12; float32 chunked against
the cached tables 1e-6; the Legendre rows against the JAX package's in
float64 1e-12 of the block's largest value, and the two-float pair
hi + lo within 1e-9 of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from draco_tpu.ops import healpix as jhealpix
from draco_tpu.ops import sht as jsht
from draco_tpu_torch.ops import healpix, sht

TOL64 = 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _maps(nside, lead, seed, complex_=False):
    rng = np.random.Generator(np.random.SFC64(seed))
    x = rng.standard_normal((*lead, healpix.npix_of(nside)))
    if complex_:
        x = x + 1j * rng.standard_normal(x.shape)
    return x


def _alm(lmax, mmax, lead, seed):
    rng = np.random.Generator(np.random.SFC64(seed))
    a = rng.standard_normal((*lead, lmax + 1, mmax + 1)) + 1j * rng.standard_normal((*lead, lmax + 1, mmax + 1))
    l, m = np.arange(lmax + 1)[:, None], np.arange(mmax + 1)[None, :]
    a = np.where(m <= l, a, 0.0)
    a[..., 0] = a[..., 0].real
    return a


@pytest.fixture
def chunked(monkeypatch):
    """Every analysis/synthesis takes the chunked route."""
    monkeypatch.setattr(sht, "TABLE_BUDGET_BYTES", 0)


# -- against the JAX package's on-the-fly transforms ---------------------------


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("it", [0, 3])
def test_chunked_analysis_matches_jax_float64(kind, it, chunked):
    s, js = sht.SHT(16, 47, 47), jsht.SHT(16, 47, 47)
    maps = _maps(16, (2,), 11, complex_=kind == "complex")
    alm = s.analysis(torch.from_numpy(maps), iter=it)
    assert s.last_route == "chunked" and alm.dtype == torch.complex128
    assert _rel(alm.numpy(), np.asarray(js.analysis(jnp.asarray(maps), iter=it))) <= TOL64


def test_chunked_impl_with_lam_none_matches_jax():
    s, js = sht.SHT(16, 40, 20, chunk_m=8), jsht.SHT(16, 40, 20)
    maps = _maps(16, (3,), 12)
    alm = s._analysis_impl(torch.from_numpy(maps), None, None)
    assert alm.shape == (3, 41, 21)
    assert _rel(alm.numpy(), np.asarray(js._analysis_j(jnp.asarray(maps)))) <= TOL64  # lam None: on the fly
    a = _alm(40, 20, (3,), 13)
    back = s._synthesis_impl(torch.from_numpy(a), None, None)
    assert _rel(back.numpy(), np.asarray(js._synthesis_j(jnp.asarray(a)))) <= TOL64


@pytest.mark.parametrize("nside,lmax,mmax", [(16, 47, 47), (16, 40, 20), (8, 40, 40), (8, 47, 36)])
def test_chunked_synthesis_matches_jax_float64(nside, lmax, mmax, chunked):
    """Including mmax >= 4 nside, where the belt's azimuths alias: exact
    point sampling in both packages."""
    s, js = sht.SHT(nside, lmax, mmax), jsht.SHT(nside, lmax, mmax)
    a = _alm(lmax, mmax, (2,), 14)
    maps = s.synthesis(torch.from_numpy(a))
    assert s.last_route == "chunked" and maps.dtype == torch.float64
    assert _rel(maps.numpy(), np.asarray(js.synthesis(jnp.asarray(a)))) <= TOL64


def test_chunked_float32_at_least_as_close_to_float64_as_jax(chunked):
    """The port contracts two-float Legendre rows, the JAX package float32
    rows: each float32 result against the float64 one."""
    s, js = sht.SHT(32, 95, 95), jsht.SHT(32, 95, 95)
    maps = _maps(32, (2,), 15)
    ref = np.asarray(js.analysis(jnp.asarray(maps)))
    got = s.analysis(torch.from_numpy(maps).float()).numpy()
    jgot = np.asarray(js.analysis(jnp.asarray(maps, jnp.float32)))
    assert got.dtype == np.complex64
    assert _rel(got, ref) <= _rel(jgot, ref) and _rel(got, ref) <= 1e-5
    a = _alm(95, 95, (2,), 16)
    ref = np.asarray(js.synthesis(jnp.asarray(a)))
    got = s.synthesis(torch.from_numpy(a).to(torch.complex64)).numpy()
    jgot = np.asarray(js.synthesis(jnp.asarray(a, jnp.complex64)))
    assert _rel(got, ref) <= _rel(jgot, ref) and _rel(got, ref) <= 1e-5


# -- channel by channel ---------------------------------------------------------


@pytest.mark.parametrize("route", ["tables", "chunked"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_per_channel_bits_do_not_depend_on_the_slab(route, dtype, monkeypatch):
    """``per_channel``: a channel's alm and map are bit-equal whether the
    call holds all four channels or a slab of them, within TOL64 of the JAX
    package in float64 (1e-6 of the batched call in float32), complex maps
    too; the chunked route makes each chunk's Legendre rows once for all
    channels."""
    if route == "chunked":
        monkeypatch.setattr(sht, "TABLE_BUDGET_BYTES", 0)
    s, js = sht.SHT(16, 47, 47, chunk_m=16), jsht.SHT(16, 47, 47)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    maps = torch.from_numpy(_maps(16, (4, 2), 21)).to(dtype)
    zmaps = torch.from_numpy(_maps(16, (4, 1), 22, complex_=True)).to(cdt)
    alm = torch.from_numpy(_alm(47, 47, (4, 2), 23)).to(cdt)
    builds = []
    chunk_legendre = s._chunk_legendre
    monkeypatch.setattr(s, "_chunk_legendre", lambda *a: builds.append(a[0]) or chunk_legendre(*a))
    full = [s.analysis(maps, per_channel=True), s.analysis(zmaps, per_channel=True), s.synthesis(alm, per_channel=True)]
    assert s.last_route == route
    assert len(builds) == (3 * len(list(s._m_chunks())) if route == "chunked" else 0)
    for sl in (slice(0, 2), slice(2, 4), slice(1, 2)):
        part = [s.analysis(maps[sl], per_channel=True), s.analysis(zmaps[sl], per_channel=True),
                s.synthesis(alm[sl], per_channel=True)]
        for p, f in zip(part, full):
            assert torch.equal(p, f[sl])
    batched = [s.analysis(maps), s.analysis(zmaps), s.synthesis(alm)]
    if dtype == torch.float64:
        ref = [js.analysis(jnp.asarray(maps.numpy())), js.analysis(jnp.asarray(zmaps.numpy())),
               js.synthesis(jnp.asarray(alm.numpy()))]
        for f, r in zip(full, ref):
            assert _rel(f.numpy(), np.asarray(r)) <= TOL64
    else:
        for f, b in zip(full, batched):
            assert _rel(f.numpy(), b.numpy()) <= 1e-6


# -- the route and the chunk size ---------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chunk_sizes_agree(dtype):
    maps = torch.from_numpy(_maps(16, (2,), 17)).to(dtype)
    a = torch.from_numpy(_alm(47, 47, (2,), 18)).to(torch.complex128 if dtype == torch.float64 else torch.complex64)
    ref_a = sht.SHT(16, chunk_m=64)._analysis_impl(maps, None)
    ref_m = sht.SHT(16, chunk_m=64)._synthesis_impl(a, None)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    for chunk in (1, 7):
        s = sht.SHT(16, chunk_m=chunk)
        assert _rel(s._analysis_impl(maps, None).numpy(), ref_a.numpy()) <= tol
        assert _rel(s._synthesis_impl(a, None).numpy(), ref_m.numpy()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunked_route_matches_tables(dtype):
    """Chunked against the cached split tables: 1e-6 in float32 (both
    two-float), 1e-12 in float64.  The whole dense tensor of
    ``precompute_legendre`` runs the recurrence in float32 for float32, as
    the JAX package's does: 2e-5 there."""
    s = sht.SHT(16, 47, 47)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    lam, lam_lo, plan = s.tables("cpu", dtype)
    maps = torch.from_numpy(_maps(16, (3,), 19)).to(dtype)
    a_t = s._analysis_impl(maps, lam, plan, lam_lo)
    a_c = s._analysis_impl(maps, None)
    assert _rel(a_c.numpy(), a_t.numpy()) <= tol
    m_c = s._synthesis_impl(a_t, None)
    assert _rel(m_c.numpy(), s._synthesis_impl(a_t, lam, plan, lam_lo).numpy()) <= tol
    dense = s.precompute_legendre(dtype, "cpu")
    assert dense.shape == (48, 48, s.info.nring) and dense.dtype == dtype
    tol_dense = 2e-5 if dtype == torch.float32 else 1e-12
    assert _rel(s._analysis_impl(maps, dense).numpy(), a_t.numpy()) <= tol_dense
    assert _rel(s._synthesis_impl(a_t, dense).numpy(), m_c.numpy()) <= tol_dense


def test_route_follows_the_budget(monkeypatch):
    s = sht.SHT(8)
    maps = torch.from_numpy(_maps(8, (), 20))
    assert s.table_bytes(torch.float64) <= sht.TABLE_BUDGET_BYTES
    alm_t = s.analysis(maps)
    assert s.last_route == "tables" and (torch.device("cpu"), torch.float64) in s._tables
    monkeypatch.setattr(sht, "TABLE_BUDGET_BYTES", s.table_bytes(torch.float64) - 1)
    s2 = sht.SHT(8)
    alm_c = s2.analysis(maps)
    assert s2.last_route == "chunked" and not s2._tables
    s2.synthesis(alm_c)
    assert s2.last_route == "chunked" and not s2._tables
    assert _rel(alm_c.numpy(), alm_t.numpy()) <= 1e-12
    # tables built already change nothing: the route follows the sizes alone
    s.analysis(maps)
    assert s.last_route == "chunked" and (torch.device("cpu"), torch.float64) in s._tables


def test_budget_keeps_nside_256_tables_and_chunks_nside_512():
    """Every caller up to nside 256 at full lmax keeps its cached tables;
    nside 512 at full lmax and nside 1024 go chunk by chunk."""
    for dtype in (torch.float32, torch.float64):
        assert sht.SHT(256).route(dtype) == "tables"
        assert sht.SHT(512).route(dtype) == "chunked"
        assert sht.SHT(1024, 1535).route(dtype) == "chunked"
    assert 3.5e9 < (768 * 768 * 1023 * 6) < sht.SHT(256).table_bytes(torch.float32)


# -- the Legendre rows ----------------------------------------------------------


@pytest.mark.parametrize("m0", [0, 320])
def test_legendre_block_matches_jax(m0):
    """Chunks of m at nside 8, lmax 383: the last one (m 320-383) lies in the
    polar-underflow regime, where Lambda_mm on the first rings is below the
    float64 floor and the rescaled recurrence must bring it back."""
    s, js = sht.SHT(8, 383, 383), jsht.SHT(8, 383, 383)
    m_vals = np.arange(m0, m0 + 64)
    ref = np.asarray(js._legendre_block(m_vals, jnp.float64))
    if m0:  # Lambda_mm of the chunk's last m on the first ring lies below exp's float64 floor
        assert np.log(np.sin(s.info.theta[0])) * m_vals[-1] < -745
    scale = np.abs(ref).max()
    got = s._legendre_block(m_vals, torch.float64, "cpu")
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * scale
    part = s._legendre_block(m_vals, torch.float64, "cpu", l0=m0)
    assert torch.equal(part, got[m0:])
    hi, lo = s._legendre_block(m_vals, device="cpu", two_float=True, l0=m0)
    assert hi.dtype == torch.float32 and lo.dtype == torch.bfloat16
    assert np.abs(hi.double().numpy() + lo.double().numpy() - ref[m0:]).max() <= 1e-9 * scale
    with pytest.raises(ValueError, match="l0"):
        s._legendre_block(m_vals, torch.float64, "cpu", l0=m0 + 1)


# -- smooth_gaussian: on the card unless the CPU is asked for --------------------


def test_smooth_gaussian_on_cpu_as_before_and_as_jax():
    rng = np.random.Generator(np.random.SFC64(21))
    m = rng.standard_normal((2, healpix.npix_of(8)))
    fwhm = healpix.nside2resol(8)
    got = healpix.smooth_gaussian(m, fwhm, device="cpu")
    # the recipe the function ran before it took a device, on the CPU
    t = sht.get_sht(8, 16, 16)
    sigma = fwhm / np.sqrt(8.0 * np.log(2.0))
    ell = np.arange(17)
    alm = t.analysis(torch.as_tensor(m), iter=3) * torch.as_tensor(np.exp(-0.5 * ell * (ell + 1) * sigma**2)[:, None])
    assert got.shape == m.shape and np.array_equal(got, t.synthesis(alm).numpy())
    assert _rel(got, np.asarray(jhealpix.smooth_gaussian(m, fwhm))) <= TOL64


def test_smooth_gaussian_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        healpix.smooth_gaussian(np.zeros(healpix.npix_of(4)), 0.1)
