"""Quadratic power spectrum estimation products.

Port of ``draco_tpu.telescope.psestimation``, the replacement of
``drift.core.psestimation`` (API usage:
``manager.psestimators[name].genbands()/q_estimator(m, vec)/fisher_bias()``
at reference draco/analysis/powerspectrum.py:62-74).

The estimator works in the KL basis: for each (kpar, kperp) band a flat
band-power covariance C_a is built (plane-wave frequency kernel integrated
over the band, angular mask over the band's l range), projected through
the SVD+KL bases, and q_a = v^H C^-1 C_a C^-1 v is accumulated over m.
The Fisher matrix F_ab = Tr[C^-1 C_a C^-1 C_b] / 2 and noise bias
b_a = Tr[C^-1 C_a] come from the same band matrices.

The JAX package holds the band covariances of every (m, band) pair,
``C_kl`` [M, nbands, n, n], at once.  Here they are streamed: each
m-chunk's band covariances are built on the device, contracted into
``q``, ``fisher`` and ``bias`` (accumulated in float64) and dropped, so
the results do not depend on the chunk size and one pass serves all three.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config
from ..device import as_tensor
from ..ops import cosmology as cosmo
from ..parallel import mesh as pmesh


class PSEstimation(config.Reader):
    """Flat-band-power quadratic estimator in the KL basis.

    Attributes
    ----------
    bands_kpar, bands_kperp : list
        Band edges in h/Mpc.
    threshold : float
        KL threshold used when building the band covariances.
    m_chunk : int
        m values per streamed chunk of band covariances; unset, the KL
        transform's memory budget sizes it.
    """

    bands_kpar = config.list_prop(None)
    bands_kperp = config.list_prop(None)
    threshold = config.float_prop(None)
    m_chunk = config.int_prop(None)

    def __init__(self, bt=None, kl=None):
        self.beamtransfer = bt
        self.kltransform = kl
        self._batch = None
        self._fisher = None
        self._bias = None

    @classmethod
    def from_config(cls, cfg, bt=None, kl=None):
        self = cls(bt, kl)
        self.read_config(cfg or {})
        return self

    # ------------------------------------------------------------------
    def genbands(self):
        """Define the (kpar, kperp) bands."""
        if self.bands_kpar is None:
            self.bands_kpar = list(np.linspace(0.0, 0.6, 5))
        if self.bands_kperp is None:
            self.bands_kperp = list(np.linspace(0.0, 0.3, 4))
        self.kpar_bands = np.asarray(self.bands_kpar)
        self.kperp_bands = np.asarray(self.bands_kperp)
        self.nbands = (len(self.kpar_bands) - 1) * (len(self.kperp_bands) - 1)
        tel = self.beamtransfer.telescope
        self._csm = cosmo.Cosmology()
        self._chi = self._csm.comoving_distance_h(cosmo.freq_to_z(tel.frequencies))  # [nfreq] Mpc/h
        return self

    def _band_sky_cov(self, band: int):
        """Sky covariance [l, f, f'] of a unit flat band power."""
        tel = self.beamtransfer.telescope
        ip = band // (len(self.kperp_bands) - 1)
        iq = band % (len(self.kperp_bands) - 1)
        kpar_lo, kpar_hi = self.kpar_bands[ip], self.kpar_bands[ip + 1]
        kperp_lo, kperp_hi = self.kperp_bands[iq], self.kperp_bands[iq + 1]

        chi_mean = self._chi.mean()
        lmax = tel.lmax
        ell = np.arange(lmax + 1, dtype=np.float64)
        # l range of this band: l = kperp * chi
        lmask = (ell >= kperp_lo * chi_mean) & (ell < kperp_hi * chi_mean)

        # Frequency kernel: integral of cos(kpar * dchi) over the band
        dchi = self._chi[:, None] - self._chi[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            K = (np.sin(kpar_hi * dchi) - np.sin(kpar_lo * dchi)) / dchi
        K = np.where(np.abs(dchi) < 1e-8, kpar_hi - kpar_lo, K)
        K = K / (np.pi * chi_mean**2)

        return lmask[:, None, None] * K[None]

    # ------------------------------------------------------------------
    def _ensure_batch(self):
        """What every chunk shares: (C_sky [nbands, l, f, f'], ci [M, n], nmode [M]).

        ``ci`` is the masked inverse total-covariance diagonal,
        1/(lambda + 1) on kept modes and 0 on cut/padded ones, so every
        later contraction restricts itself to the truncated basis the
        reference builds explicitly per m.
        """
        if self._batch is not None:
            return self._batch
        kl = self.kltransform
        C_sky = np.stack([self._band_sky_cov(b) for b in range(self.nbands)])  # [nbands, l, f, f']
        thr = kl.threshold if self.threshold is None else self.threshold
        modes, nmode = kl._ensure_modes(thr)
        evals = modes["evals"]
        if not kl.subset:
            # cap at the valid packed rank: padded / sub-svcut SVD dims
            # are zeroed in the data by the beam-transfer keep mask, so
            # counting them in the Fisher/bias traces would bias the
            # band powers low
            svd_n = self.beamtransfer._svd["nmode"].to(evals.device)  # [f, M]
            nmode = torch.minimum(nmode, svd_n.sum(dim=0))
        keep = torch.arange(evals.shape[1], device=evals.device)[None] < nmode[:, None]
        ci = torch.where(keep, 1.0 / (evals + 1.0), torch.zeros_like(evals))
        self._thr = thr
        self._batch = (C_sky, ci, nmode)
        return self._batch

    def _chunks(self):
        """Stream (m0, m1, C_kl [mc, nbands, kc, kc], ci [mc, kc]) over the
        KL transform's stored chunks, cut to at most ``m_chunk`` values of m.

        C_kl = V^H C V with fwd = V^H rows: the basis in which the total
        covariance is diag(evals + 1); kc is the chunk's stored mode count.
        """
        kl = self.kltransform
        C_sky, ci, _ = self._ensure_batch()
        step = self.m_chunk or kl._chunk_len(ncov=self.nbands)
        for c0, c1, _, fwd_c in kl._modes["chunks"]:
            for m0 in range(c0, c1, step):
                m1 = min(m0 + step, c1)
                fwd = fwd_c[m0 - c0 : m1 - c0]
                C_svd = kl._svd_cov_all(C_sky, m0, m1)  # [mc, nbands, n, n]
                C_kl = torch.einsum("mia,mxab,mjb->mxij", fwd, C_svd.to(fwd.dtype), fwd.conj())
                del C_svd
                # under a mesh the m axis of the band covariances is the
                # sharded one and the m-sums below are its reductions
                C_kl = pmesh.shard_array_named(C_kl, ("m", "band", "i", "j"), "m")
                ci_c = pmesh.shard_array_named(ci[m0:m1, : fwd.shape[1]], ("m", "i"), "m")
                yield m0, m1, C_kl, ci_c

    def _band_kl_cov(self, m: int, band: int):
        """Band covariance in the truncated KL basis for one m, with its eigenvalues."""
        kl = self.kltransform
        C_sky, _, nmode = self._ensure_batch()
        n = int(nmode[m])
        evals, _, fwd = kl.modes_m(m, self._thr)
        C_svd = kl._svd_cov_all(C_sky[band : band + 1], m, m + 1)[0, 0]
        return fwd[:n] @ C_svd.to(fwd.dtype) @ fwd[:n].conj().T, evals[:n]

    # ------------------------------------------------------------------
    def _accumulate(self, x=None):
        """One pass over the band covariances: ``fisher`` and ``bias`` when
        they are not there yet, and ``q`` of KL vectors ``x`` [M, n] when given."""
        need_fisher = self._fisher is None
        dev = self._ensure_batch()[1].device
        nb = self.nbands
        q = torch.zeros(nb, dtype=torch.float64, device=dev)
        bias = torch.zeros(nb, dtype=torch.float64, device=dev)
        fisher = torch.zeros((nb, nb), dtype=torch.float64, device=dev)
        for m0, m1, C_kl, ci in self._chunks():
            kc = ci.shape[1]
            if x is not None:
                xw = pmesh.shard_array_named(x[m0:m1, :kc].to(C_kl.dtype), ("m", "i"), "m") * ci
                q += torch.einsum("mi,mxij,mj->x", xw.conj(), C_kl, xw).real.double()
            if need_fisher:
                bias += torch.einsum("mi,mxii->x", ci.to(C_kl.dtype), C_kl).real.double()
                W = ci[:, None, :, None] * C_kl * ci[:, None, None, :]
                fisher += 0.5 * torch.einsum("mxij,myji->xy", W, C_kl).real.double()
        if need_fisher:
            self._fisher = 0.5 * (fisher + fisher.T)
            self._bias = bias
        return q

    def _pad_vis(self, vis, M: int, n: int) -> torch.Tensor:
        """KL vectors [M_in, n_in] cut or zero-padded to [M, n]."""
        dev = self._ensure_batch()[1].device
        vis = as_tensor(vis, dev)
        x = torch.zeros((M, n), dtype=torch.complex128, device=dev)
        m_avail, w = min(M, vis.shape[0]), min(n, vis.shape[1])
        x[:m_avail, :w] = vis[:m_avail, :w]
        return x

    def q_estimator(self, m: int, vec) -> torch.Tensor:
        """Band powers q_a = x^H C^-1 C_a C^-1 x for one m."""
        kl = self.kltransform
        _, ci, _ = self._ensure_batch()
        vec = as_tensor(vec, ci.device)
        if vec.numel() == 0:
            return torch.zeros(self.nbands, dtype=torch.float64, device=ci.device)
        fwd = kl.modes_m(m, self._thr)[2]
        kc = fwd.shape[0]
        x = self._pad_vis(vec[None], 1, ci.shape[1])[0, :kc]
        C_svd = kl._svd_cov_all(self._batch[0], m, m + 1)[0]  # [nbands, n, n]
        C_kl = torch.einsum("ia,xab,jb->xij", fwd, C_svd.to(fwd.dtype), fwd.conj())
        xw = x.to(C_kl.dtype) * ci[m, :kc]
        return torch.einsum("i,xij,j->x", xw.conj(), C_kl, xw).real.double()

    def q_estimator_all(self, vis, nmode) -> torch.Tensor:
        """Band powers summed over every m.

        vis : [M, nmax] complex KL-basis vectors (zero-padded); nmode is
        accepted for API symmetry with the container but the masked
        ``ci`` already zeroes cut modes.  The same pass accumulates the
        Fisher matrix and the bias when they are not there yet.
        """
        del nmode
        _, ci, _ = self._ensure_batch()
        return self._accumulate(self._pad_vis(vis, *ci.shape))

    def fisher_bias(self):
        """Fisher matrix and noise bias accumulated over all m.

        F_ab = 1/2 sum_m Re Tr[Ci C_a Ci C_b], b_a = sum_m Re Tr[Ci C_a]
        with Ci the masked diagonal inverse covariance.
        """
        if self._fisher is None:
            self._accumulate()
        return self._fisher, self._bias

    def generate(self, regen: bool = False):
        self.genbands()
        return self
