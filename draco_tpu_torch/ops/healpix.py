"""Minimal native HEALPix (RING scheme) geometry.

The environment provides no healpy; the reference consumes it through
``cora.util.hputil`` (reference draco/synthesis/stream.py:85,
draco/analysis/mapmaker.py:112).  Only the RING-scheme geometry needed for
the spherical-harmonic transform and beam evaluation is implemented: ring
tables, pixel centre angles, and pixel vectors.  Formulas follow the
standard HEALPix definition (Gorski et al. 2005).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def npix_of(nside: int) -> int:
    return 12 * nside * nside


def nside_of(npix: int) -> int:
    nside = int(round(np.sqrt(npix / 12)))
    if 12 * nside * nside != npix:
        raise ValueError(f"npix={npix} is not a valid HEALPix size")
    return nside


@dataclass
class RingInfo:
    """Per-ring geometry of a RING-ordered HEALPix map.

    Attributes
    ----------
    nside : resolution
    nring : number of iso-latitude rings (4*nside - 1)
    theta : colatitude of each ring [nring]
    nphi : pixels in each ring [nring]
    phi0 : azimuth of the first pixel centre in each ring [nring]
    offset : start pixel index of each ring [nring]
    """

    nside: int
    nring: int
    theta: np.ndarray
    nphi: np.ndarray
    phi0: np.ndarray
    offset: np.ndarray
    weight: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.weight is None:
            # Equal-area quadrature: every pixel has solid angle 4*pi/npix.
            self.weight = np.full(self.nring, 4 * np.pi / npix_of(self.nside))


def ring_info(nside: int) -> RingInfo:
    """Compute the ring table for ``nside``."""
    if nside < 1 or (nside & (nside - 1)) != 0:
        raise ValueError(f"nside must be a positive power of two, got {nside}")
    nring = 4 * nside - 1
    theta = np.zeros(nring)
    nphi = np.zeros(nring, dtype=np.int64)
    phi0 = np.zeros(nring)
    offset = np.zeros(nring, dtype=np.int64)

    idx = 0
    pix = 0
    # North polar cap: rings i = 1 .. nside-1, 4i pixels each,
    # z = 1 - i^2/(3 nside^2), first pixel centre at pi/(4i).
    for i in range(1, nside):
        z = 1.0 - i * i / (3.0 * nside * nside)
        theta[idx] = np.arccos(z)
        nphi[idx] = 4 * i
        phi0[idx] = np.pi / (4 * i)
        offset[idx] = pix
        pix += 4 * i
        idx += 1
    # Equatorial belt: rings i = nside .. 3 nside, 4 nside pixels each,
    # z = 4/3 - 2i/(3 nside), phase alternating by half a pixel.
    for i in range(nside, 3 * nside + 1):
        z = 4.0 / 3.0 - 2.0 * i / (3.0 * nside)
        theta[idx] = np.arccos(z)
        nphi[idx] = 4 * nside
        s = (i - nside + 1) % 2
        phi0[idx] = (np.pi / (4 * nside)) * s
        offset[idx] = pix
        pix += 4 * nside
        idx += 1
    # South polar cap mirrors the north cap.
    for i in range(nside - 1, 0, -1):
        z = -(1.0 - i * i / (3.0 * nside * nside))
        theta[idx] = np.arccos(z)
        nphi[idx] = 4 * i
        phi0[idx] = np.pi / (4 * i)
        offset[idx] = pix
        pix += 4 * i
        idx += 1
    assert pix == npix_of(nside)
    return RingInfo(nside, nring, theta, nphi, phi0, offset)


def pix2ang(nside: int, ipix=None):
    """Colatitude/azimuth of RING-ordered pixel centres.

    Returns (theta, phi) arrays for all pixels if ``ipix`` is None.
    """
    info = ring_info(nside)
    npix = npix_of(nside)
    theta = np.zeros(npix)
    phi = np.zeros(npix)
    for r in range(info.nring):
        o, n = info.offset[r], info.nphi[r]
        theta[o : o + n] = info.theta[r]
        phi[o : o + n] = info.phi0[r] + 2 * np.pi * np.arange(n) / n
    if ipix is not None:
        return theta[ipix], phi[ipix]
    return theta, phi


def pix2vec(nside: int, ipix=None):
    """Unit vectors of RING-ordered pixel centres, shape [npix, 3]."""
    theta, phi = pix2ang(nside, ipix)
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], axis=-1)


def ang2pix(nside: int, theta, phi):
    """RING pixel CONTAINING (theta, phi) — the exact HEALPix algorithm.

    Standard diamond-boundary algebra (Gorski et al. 2005 / the healpy C
    implementation), not a nearest-centre approximation: pixel
    boundaries in the caps are not equidistant from centres, so a
    nearest-ring/nearest-phi rule disagrees with healpy near edges.
    """
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.mod(np.atleast_1d(np.asarray(phi, dtype=np.float64)), 2 * np.pi)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi / (0.5 * np.pi), 4.0)
    npix = npix_of(nside)
    ncap = 2 * nside * (nside - 1)
    pix = np.empty(theta.shape, dtype=np.int64)

    eq = za <= 2.0 / 3.0
    if eq.any():
        temp1 = nside * (0.5 + tt[eq])
        temp2 = nside * z[eq] * 0.75
        jp = np.floor(temp1 - temp2).astype(np.int64)
        jm = np.floor(temp1 + temp2).astype(np.int64)
        ir = nside + 1 + jp - jm  # ring index in {1, ..., 2*nside+1}
        kshift = 1 - (ir & 1)
        ip = np.mod((jp + jm - nside + kshift + 1) // 2, 4 * nside)
        pix[eq] = ncap + (ir - 1) * 4 * nside + ip

    po = ~eq
    if po.any():
        tp = tt[po] - np.floor(tt[po])
        tmp = nside * np.sqrt(3.0 * (1.0 - za[po]))
        jp = np.floor(tp * tmp).astype(np.int64)
        jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1  # ring counted from the nearer pole
        ir = np.minimum(ir, nside)  # guard exactly-on-boundary rounding
        ip = np.mod(np.floor(tt[po] * ir).astype(np.int64), 4 * ir)
        north = z[po] > 0
        pix[po] = np.where(
            north,
            2 * ir * (ir - 1) + ip,
            npix - 2 * ir * (ir + 1) + ip,
        )
    return pix


def nside2resol(nside: int) -> float:
    """Approximate pixel resolution in radians."""
    return np.sqrt(4 * np.pi / npix_of(nside))


# ---------------------------------------------------------------------------
# NEST scheme conversions (standard HEALPix face/xy algebra, vectorised)
# ---------------------------------------------------------------------------

# Ring offsets of the 12 base faces (HEALPix primer conventions)
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _compress_bits(v):
    """Extract the even bits of ``v`` (inverse of bit interleaving)."""
    v = np.asarray(v, dtype=np.uint64) & np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v.astype(np.int64)


def _spread_bits(v):
    """Spread the bits of ``v`` onto the even positions."""
    v = np.asarray(v, dtype=np.uint64) & np.uint64(0x00000000FFFFFFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v.astype(np.int64)


def _nest2xyf(nside: int, ipix):
    ipix = np.asarray(ipix, dtype=np.int64)
    face = ipix // (nside * nside)
    p = ipix % (nside * nside)
    return _compress_bits(p), _compress_bits(p >> 1), face


def _xyf2nest(nside: int, x, y, face):
    return (
        np.asarray(face, dtype=np.int64) * nside * nside
        + _spread_bits(x)
        + (_spread_bits(y) << 1)
    )


def _ring2xyf(nside: int, ipix):
    ipix = np.asarray(ipix, dtype=np.int64)
    npix = npix_of(nside)
    ncap = 2 * nside * (nside - 1)

    iring = np.zeros_like(ipix)
    iphi = np.zeros_like(ipix)
    kshift = np.zeros_like(ipix)
    nr = np.zeros_like(ipix)
    face = np.zeros_like(ipix)

    north = ipix < ncap
    eq = (~north) & (ipix < npix - ncap)
    south = ipix >= npix - ncap

    # North polar cap
    pn = ipix[north]
    irn = (1 + np.floor(np.sqrt(1 + 2 * pn)).astype(np.int64)) >> 1
    # Guard against floating point rounding at ring boundaries
    irn = np.where(2 * irn * (irn - 1) > pn, irn - 1, irn)
    irn = np.where(2 * (irn + 1) * irn <= pn, irn + 1, irn)
    ipn = pn + 1 - 2 * irn * (irn - 1)
    iring[north] = irn
    iphi[north] = ipn
    nr[north] = irn
    face[north] = (ipn - 1) // irn

    # Equatorial belt
    pe = ipix[eq] - ncap
    ire_ring = pe // (4 * nside) + nside
    ipe = pe % (4 * nside) + 1
    ks = (ire_ring + nside) & 1
    iring[eq] = ire_ring
    iphi[eq] = ipe
    kshift[eq] = ks
    nr[eq] = nside
    ire = ire_ring - nside + 1
    irm = 2 * nside + 2 - ire
    ifm = (ipe - ire // 2 + nside - 1) // nside
    ifp = (ipe - irm // 2 + nside - 1) // nside
    face[eq] = np.where(ifp == ifm, ifp | 4, np.where(ifp < ifm, ifp, ifm + 8))

    # South polar cap
    ps = npix - ipix[south]
    irs = (1 + np.floor(np.sqrt(2 * ps - 1)).astype(np.int64)) >> 1
    irs = np.where(2 * irs * (irs - 1) >= ps, irs - 1, irs)
    irs = np.where(2 * (irs + 1) * irs < ps, irs + 1, irs)
    ips = 4 * irs + 1 - (ps - 2 * irs * (irs - 1))
    face[south] = 8 + (ips - 1) // irs
    iphi[south] = ips
    nr[south] = irs
    iring[south] = 4 * nside - irs

    irt = iring - _JRLL[face] * nside + 1
    ipt = 2 * iphi - _JPLL[face] * nr - kshift - 1
    ipt = np.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)

    x = (ipt - irt) >> 1
    y = (-ipt - irt) >> 1
    return x, y, face


def _xyf2ring(nside: int, x, y, face):
    npix = npix_of(nside)
    ncap = 2 * nside * (nside - 1)

    jr = _JRLL[face] * nside - x - y - 1

    north = jr < nside
    south = jr > 3 * nside
    eq = ~(north | south)

    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    n_before = np.where(
        north,
        2 * nr * (nr - 1),
        np.where(south, npix - 2 * nr * (nr + 1), ncap + (jr - nside) * 4 * nside),
    )
    kshift = np.where(eq, (jr - nside) & 1, 0)

    jp = (_JPLL[face] * nr + x - y + 1 + kshift) // 2
    jp = np.where(jp > 4 * nside, jp - 4 * nside, jp)
    jp = np.where(jp < 1, jp + 4 * nside, jp)

    return n_before + jp - 1


def ring2nest(nside: int, ipix):
    """RING pixel indices -> NEST pixel indices."""
    return _xyf2nest(nside, *_ring2xyf(nside, ipix))


def nest2ring(nside: int, ipix):
    """NEST pixel indices -> RING pixel indices."""
    return _xyf2ring(nside, *_nest2xyf(nside, ipix))


def ud_grade(map_in, nside_out: int):
    """Up/downgrade a RING map to a new resolution (healpy.ud_grade semantics).

    Downgrading averages NEST children; upgrading replicates the parent.
    Works on the last axis of ``map_in``.
    """
    map_in = np.asarray(map_in)
    nside_in = nside_of(map_in.shape[-1])
    if nside_in == nside_out:
        return map_in.copy()

    # Map to NEST ordering
    ring_of_nest_in = nest2ring(nside_in, np.arange(npix_of(nside_in)))
    m_nest = map_in[..., ring_of_nest_in]

    if nside_out < nside_in:
        ratio = (nside_in // nside_out) ** 2
        m_out_nest = m_nest.reshape(*m_nest.shape[:-1], -1, ratio).mean(axis=-1)
    else:
        ratio = (nside_out // nside_in) ** 2
        m_out_nest = np.repeat(m_nest, ratio, axis=-1)

    out = np.empty_like(m_out_nest)
    ring_of_nest_out = nest2ring(nside_out, np.arange(npix_of(nside_out)))
    out[..., ring_of_nest_out] = m_out_nest
    return out


def smooth_gaussian(map_in, fwhm: float, lmax: int | None = None, device=None):
    """Smooth a RING map with a Gaussian beam of the given FWHM (radians).

    Equivalent of ``healpy.smoothing``: the map is transformed with the
    native SHT, the alm are multiplied by ``exp(-l(l+1) sigma^2 / 2)``, and
    synthesised back.  Batched over any leading axes.  The transforms run
    on ``device`` (:func:`draco_tpu_torch.device.resolve`:
    the first CUDA card unless the CPU is asked for); the result is a host
    numpy array.
    """
    import torch

    from ..device import resolve
    from . import sht as sht_mod

    map_in = np.asarray(map_in)
    nside = nside_of(map_in.shape[-1])
    if lmax is None:
        # 2*nside keeps the healpix quadrature accurate; combined with the
        # Jacobi refinement below the band-limited roundtrip is ~1e-4
        lmax = 2 * nside

    sigma = fwhm / np.sqrt(8.0 * np.log(2.0))
    ell = np.arange(lmax + 1)
    bl = np.exp(-0.5 * ell * (ell + 1) * sigma**2)

    dev = resolve(device)
    t = sht_mod.get_sht(nside, lmax, lmax)
    alm = t.analysis(torch.as_tensor(np.atleast_2d(map_in), device=dev), iter=3)
    alm = alm * torch.as_tensor(bl[np.newaxis, :, np.newaxis], device=dev)
    out = t.synthesis(alm).cpu().numpy()
    return out.reshape(map_in.shape)
