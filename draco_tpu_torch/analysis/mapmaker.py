"""Map making from m-modes (the m-mode formalism inverse problem).

Port of ``draco_tpu.analysis.mapmaker``: reference
``draco/analysis/mapmaker.py`` (BaseMapMaker:11, DirtyMapMaker:143,
MaximumLikelihoodMapMaker:171, WienerMapMaker:204, pinv_svd:287).

The reference's nested per-m / per-freq solve loop (reference
mapmaker.py:79-94) is m-chunked batched linear algebra on the m-modes'
device: one batched einsum for the dirty map, batched SVD
pseudo-inverses for ML and batched solves (dual form when nsky > ntel,
reference mapmaker.py:266-278) for the Wiener map, then one batched
inverse SHT.  The dirty map maker also has the streaming (factorised)
adjoint, which never materialises the beam transfer matrices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops import sht
from ..ops.tools import find_keys, svd

__all__ = ["BaseMapMaker", "DirtyMapMaker", "MaximumLikelihoodMapMaker", "WienerMapMaker", "pinv_svd"]


class BaseMapMaker(ContainerTask):
    """m-mode map maker base (reference mapmaker.py:11).

    Attributes
    ----------
    nside : int
        Resolution of the output HEALPix map.
    m_chunk : int
        Number of m values per batched solve (memory/throughput knob).
    streaming : bool
        Use the streaming (factorised) projection, which never
        materialises the beam transfer matrices; the dirty map maker only.
    baseline_chunk : int
        Baselines per chunk of the streaming projection.
    """

    nside = config.int_prop(256)
    m_chunk = config.int_prop(32)
    streaming = config.bool_prop(False)
    baseline_chunk = config.int_prop(256)

    # only makers with a factorised projection support streaming; others
    # fail instead of skipping bt.generate() and failing in the solve
    _supports_streaming = False

    def setup(self, bt):
        """Set the beam transfer matrices (BeamTransfer or ProductManager)."""
        self.beamtransfer = io.get_beamtransfer(bt)

    def process(self, mmodes: containers.MModes) -> containers.Map:
        """Make a map from m-mode visibilities, on their device."""
        bt = self.beamtransfer
        if self.streaming and not self._supports_streaming:
            raise RuntimeError(
                f"{type(self).__name__} does not support streaming map-making "
                "(only the dirty-map adjoint factorises); unset `streaming` or use DirtyMapMaker."
            )
        if not self.streaming:
            bt.generate(device=mmodes.device)
        tel = bt.telescope
        lmax = tel.lmax
        mmax = min(tel.mmax, len(mmodes.index_map["m"]) - 1)
        nfreq = len(mmodes.index_map["freq"])
        npol = tel.num_pol_sky

        # map the m-mode frequencies onto the beam transfer channels
        freq_ind = find_keys(tel.frequencies, mmodes.index_map["freq"]["centre"], require_match=True)

        # [m, msign, freq, stack] -> [m, msign, freq, nbase]
        nbase = tel.npairs
        vis = mmodes.vis[:][: mmax + 1].reshape(mmax + 1, 2, nfreq, nbase)
        weight = mmodes.weight[:][: mmax + 1].reshape(mmax + 1, 2, nfreq, nbase)

        alm = self._solve_all_m(vis, weight, freq_ind, mmax)

        # pad the m axis to the full lmax+1 and synthesise maps
        if alm.shape[-1] < lmax + 1:
            alm = torch.nn.functional.pad(alm, (0, lmax + 1 - alm.shape[-1]))
        maps = sht.sphtrans_inv_sky(alm, self.nside)

        m = containers.Map(nside=self.nside, polarisation=npol == 4, axes_from=mmodes, attrs_from=mmodes)
        m.map[:] = maps
        return m

    # -- solver helpers ----------------------------------------------------
    def _bt_tensors(self, freq_ind):
        """Bp/Bm tensors channel-matched: [nfreq, nbase, npol, L+1, M+1]."""
        bt = self.beamtransfer
        fsel = torch.as_tensor(np.asarray(freq_ind, dtype=np.int64), device=bt._bp.device)
        return bt._bp.index_select(0, fsel), bt._bm.index_select(0, fsel)

    def _solve_all_m(self, vis, weight, freq_ind, mmax):
        """Return alm [nfreq, npol, lmax+1, mmax+1]; override per maker."""
        raise NotImplementedError

    def _m_chunks(self, mmax):
        for m0 in range(0, mmax + 1, self.m_chunk):
            yield m0, min(m0 + self.m_chunk, mmax + 1)


class DirtyMapMaker(BaseMapMaker):
    r"""Dirty map: :math:`\hat{a} = B^\dagger N^{-1} v`.

    (reference mapmaker.py:143-168): one batched adjoint einsum, or the
    streaming adjoint with ``streaming: true``.
    """

    _supports_streaming = True

    def _solve_all_m(self, vis, weight, freq_ind, mmax):
        if self.streaming:
            tel = self.beamtransfer.telescope
            if list(np.asarray(freq_ind)) != list(range(tel.nfreq)):
                raise ValueError(
                    "streaming map-making requires the m-mode frequencies to match the telescope channels exactly"
                )
            pad_m = tel.mmax - mmax
            if pad_m > 0:
                vis = torch.nn.functional.pad(vis, (0, 0, 0, 0, 0, 0, 0, pad_m))
                weight = torch.nn.functional.pad(weight, (0, 0, 0, 0, 0, 0, 0, pad_m))
            alm = self.beamtransfer.project_telescope_to_sky_dirty_streaming(
                vis, weight, chunk=self.baseline_chunk
            )
            return alm[..., : mmax + 1]
        bp, bm = self._bt_tensors(freq_ind)
        # the m-modes in float32, the JAX package's device precision
        wv = (vis.to(torch.complex64) * weight.to(torch.float32)).to(bp.device, bp.dtype)
        a = torch.einsum("fbplm,mfb->fplm", bp[..., : mmax + 1].conj(), wv[:, 0])
        return a + torch.einsum("fbplm,mfb->fplm", bm[..., : mmax + 1].conj(), wv[:, 1])


def pinv_svd(M: torch.Tensor, acond: float = 1e-4, rcond: float = 1e-3) -> torch.Tensor:
    """SVD pseudo-inverse with the reference's dual threshold.

    (reference mapmaker.py:287-300): singular values kept where
    s > rcond * s_max and s > acond.  Batched over leading dims.
    """
    u, s, vh = svd(M)
    smax = s.max(dim=-1, keepdim=True).values
    keep = (s > rcond * smax) & (s > acond)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    # pinv = V s^-1 U^H
    return vh.conj().transpose(-1, -2) @ (s_inv[..., :, None].to(u.dtype) * u.conj().transpose(-1, -2))


def _chunk_operands(bp, bm, vis, weight, m0, mc):
    """Whitened beam [mc, f, ntel, nsky] and data [mc, f, ntel] of one m-chunk."""
    nfreq, nbase, npol, L1 = bp.shape[:4]
    B = torch.cat([bp[..., m0 : m0 + mc], bm[..., m0 : m0 + mc]], dim=1)  # [f, ntel, p, L1, mc]
    B = B.movedim(-1, 0).reshape(mc, nfreq, 2 * nbase, npol * L1)
    v = vis[m0 : m0 + mc].movedim(1, 2).reshape(mc, nfreq, 2 * nbase)
    Ni = weight[m0 : m0 + mc].movedim(1, 2).reshape(mc, nfreq, 2 * nbase)
    Nh = torch.sqrt(Ni).to(B.dtype)
    return B * Nh[..., None], Nh * v.to(B.dtype)


class MaximumLikelihoodMapMaker(BaseMapMaker):
    r"""ML map: :math:`\hat{a} = (N^{-1/2}B)^+ N^{-1/2} v`.

    (reference mapmaker.py:171-201): m-chunked batched SVD pseudo-inverses.

    Attributes
    ----------
    acond, rcond : float
        Absolute and relative singular-value cuts of the pseudo-inverse
        (reference defaults, mapmaker.py:287).
    """

    acond = config.float_prop(1e-4)
    rcond = config.float_prop(1e-3)

    def _solve_all_m(self, vis, weight, freq_ind, mmax):
        bp, bm = self._bt_tensors(freq_ind)
        nfreq, nbase, npol, L1 = bp.shape[:4]
        vis, weight = vis.to(bp.device), weight.to(bp.device)
        out = []
        for m0, m1 in self._m_chunks(mmax):
            Bt, vt = _chunk_operands(bp, bm, vis, weight, m0, m1 - m0)
            # B is zero for l < m: the pseudo-inverse of the columns l >= m0 is
            # that of the whole matrix, with zero rows for the others
            cols = (torch.arange(L1, device=Bt.device) >= m0).repeat(npol)
            ib = pinv_svd(Bt[..., cols], acond=self.acond, rcond=self.rcond)
            a = torch.zeros(Bt.shape[:2] + (npol * L1,), dtype=ib.dtype, device=ib.device)
            a[..., cols] = torch.einsum("mfst,mft->mfs", ib, vt.to(ib.dtype))
            out.append(a.reshape(m1 - m0, nfreq, npol, L1))
        return torch.cat(out, dim=0).movedim(0, -1)  # [f, p, L1, M+1]


class WienerMapMaker(BaseMapMaker):
    r"""Wiener map with a power-law signal prior.

    :math:`\hat{a} = (S^{-1} + B^\dagger N^{-1} B)^{-1} B^\dagger N^{-1} v`
    (reference mapmaker.py:204-284).  The ``l < m`` block of B is zero, so
    the prior regularises it to zero and the solves stay uniform for
    batching.  The dual (telescope-space) form is used when nsky > ntel.

    Attributes
    ----------
    prior_amp, prior_tilt : float
        Power-law prior: C_l = prior_amp^2 * l^(-prior_tilt).
    """

    prior_amp = config.float_prop(1.0)
    prior_tilt = config.float_prop(0.5)

    def _solve_all_m(self, vis, weight, freq_ind, mmax):
        bp, bm = self._bt_tensors(freq_ind)
        nfreq, nbase, npol, L1 = bp.shape[:4]
        nsky = npol * L1
        ntel = 2 * nbase
        dev, cdt = bp.device, bp.dtype
        vis, weight = vis.to(dev), weight.to(dev)

        ell = np.arange(L1)
        ell[0] = 1
        cl_TT = self.prior_amp**2 * ell.astype(float) ** (-self.prior_tilt)
        S_diag = torch.as_tensor(np.tile(cl_TT, npol), device=dev).to(cdt)  # [nsky]

        out = []
        for m0, m1 in self._m_chunks(mmax):
            Bt, vt = _chunk_operands(bp, bm, vis, weight, m0, m1 - m0)
            if ntel > nsky:
                # primal: (S^-1 + B^H B) a = B^H v
                Ci = torch.einsum("mfts,mftr->mfsr", Bt.conj(), Bt) + torch.diag(1.0 / S_diag)
                rhs = torch.einsum("mfts,mft->mfs", Bt.conj(), vt)
                a = torch.linalg.solve(Ci, rhs[..., None])[..., 0]
            else:
                # dual: a = S B^H (I + B S B^H)^-1 v
                pCi = torch.einsum("mfts,mfrs->mftr", Bt * S_diag, Bt.conj())
                pCi = pCi + torch.eye(ntel, dtype=cdt, device=dev)
                v_int = torch.linalg.solve(pCi, vt[..., None])[..., 0]
                a = S_diag * torch.einsum("mfts,mft->mfs", Bt.conj(), v_int)
            out.append(a.reshape(m1 - m0, nfreq, npol, L1))
        a_all = torch.cat(out, dim=0)
        # zero the l < m block (prior-suppressed; the leakage is removed
        # for exact parity)
        M1 = a_all.shape[0]
        mask = (torch.arange(L1, device=dev)[None, :] >= torch.arange(M1, device=dev)[:, None])[:, None, None, :]
        return (a_all * mask).movedim(0, -1)
