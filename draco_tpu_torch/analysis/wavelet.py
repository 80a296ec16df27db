"""Wavelet power spectrum estimation.

Port of ``draco_tpu.analysis.wavelet`` (reference ``draco/analysis/wavelet.py``:
WaveletSpectrumEstimator:18).  The Wiener in-fill and the CWT run on the
data's device, a block of baselines at a time (the JAX package holds every
baseline's [nfreq, nfreq] operator and every scale chunk's transform at
once).

Deliberate differences:

* the in-fill runs in complex128 wherever it runs.  Its operator inverts
  ``F diag(D) F^H``, which the delay spectrum of delay-filtered data leaves
  close to singular; the JAX package runs it in complex128 only with
  64-bit types on (its CPU tests) and in complex64 on its TPU;
* a baseline whose operator cannot be inverted (no delay power: a
  baseline without data) gets a zero spectrum, counted in the output's
  attr ``infill_failed``, where the JAX package returns NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers
from ..core.task import ContainerTask
from ..ops import wavelet as wavelet_ops
from ..ops.delay import flatten_axes
from ..ops.tools import axis_blocks

# elements of one block's CWT ([nscale, nbase, ntime, nfreq])
CWT_BLOCK_ELEMENTS = 1 << 28


class WaveletSpectrumEstimator(ContainerTask):
    """Estimate a continuous wavelet power spectrum of the data.

    Requires the data and an estimate of its delay spectrum (used to
    Wiener in-fill masked frequencies before transforming).

    Attributes
    ----------
    dataset : str
        Dataset to transform.
    average_axis : str
        Axis the spectrum is averaged (variance taken) over.
    ndelay : int
        Number of delay scales.
    chunks : int
        Scale-bank chunks (memory control on very large inputs); baselines
        are taken in blocks as well.
    """

    dataset = config.str_prop("vis")
    average_axis = config.str_prop()
    ndelay = config.int_prop(128)
    wavelet = config.str_prop("morl")
    chunks = config.int_prop(4)

    def process(self, data, dspec):
        """Estimate the wavelet power spectrum.

        Parameters
        ----------
        data : containers.FreqContainer
            Data with a freq axis and the averaging axis.
        dspec : containers.DelaySpectrum
            Delay spectrum whose flattened baseline axis matches the
            remaining axes of ``data``.

        Returns
        -------
        wspec : containers.WaveletSpectrum
        """
        dset_view, bl_axes = flatten_axes(data[self.dataset], [self.average_axis, "freq"])
        weight_view, _ = flatten_axes(data.weight, [self.average_axis, "freq"], match_dset=data[self.dataset])

        nbase, ntime, nfreq = dset_view.shape
        freq = np.asarray(data.freq)
        dev = dset_view.device

        df = np.abs(freq[1] - freq[0])
        delay_scales = np.arange(1, self.ndelay + 1) / (2 * df * self.ndelay)

        # Wavelet scales, in frequency samples
        wv_scales = wavelet_ops.frequency2scale(delay_scales * df, wavelet=self.wavelet)

        wspec = containers.WaveletSpectrum(baseline=nbase, axes_from=data, attrs_from=data, delay=delay_scales)
        for ax in bl_axes:
            wspec.create_index_map(ax, data.index_map[ax])
        wspec.attrs["baseline_axes"] = np.array(bl_axes)

        ds = dspec.spectrum[:]
        ds = ds.to(dev) if isinstance(ds, torch.Tensor) else torch.as_tensor(np.asarray(ds), device=dev)
        # Fourier matrix mapping delays -> frequencies
        tau = torch.as_tensor(np.asarray(dspec.index_map["delay"], dtype=np.float64), device=dev)
        nu = torch.as_tensor(freq.astype(np.float64), device=dev)
        arg = -2.0 * np.pi * nu[:, None] * tau[None, :]
        F = torch.polar(torch.ones_like(arg), arg)

        Ni_all = weight_view.mean(dim=1)  # [nbase, nfreq]
        ws = wspec.spectrum[:]
        nfailed = 0
        bounds = np.linspace(0, len(wv_scales), self.chunks + 1, dtype=int)
        nsc = max(int(np.max(np.diff(bounds))), 1)
        for b0, b1 in axis_blocks(nbase, nsc * ntime * nfreq, CWT_BLOCK_ELEMENTS):
            d_infill, nf = wiener_infill(dset_view[b0:b1], Ni_all[b0:b1], ds[b0:b1], F)
            d_infill = d_infill.to(dset_view.dtype)
            nfailed += nf
            # CWT + variance, chunked over the scale bank
            for s, e in zip(bounds[:-1], bounds[1:]):
                if e <= s:
                    continue
                W = wavelet_ops.cwt(d_infill, wv_scales[s:e], wavelet=self.wavelet, axis=-1)
                ws[b0:b1, s:e] = wavelet_ops.cwt_var(W, axis=2).transpose(0, 1).to(ws.dtype)
                del W
            del d_infill
        wspec.weight[:] = Ni_all
        wspec.attrs["infill_failed"] = nfailed
        if nfailed:
            self.log.warning(f"{nfailed} of {nbase} baselines could not be in-filled (no delay power or a singular "
                             "operator): their spectrum is zero.")
        return wspec


def wiener_infill(d, Ni, D, F):
    """Wiener in-fill of masked channels (reference wavelet.py:108-121), in complex128.

    d : [nbase, ntime, nfreq]; Ni : [nbase, nfreq]; D : [nbase, ndelay];
    F : [nfreq, ndelay].  For each baseline, ``Ci = inv(F D F^H) +
    diag(Ni)`` and the result is ``solve(Ci, Ni d^T)^T``.

    A baseline whose ``F D F^H`` cannot be inverted (a delay spectrum of
    zeros: no data) or whose ``Ci`` is singular is in-filled with zeros
    (the JAX package returns NaN or infinities there).  Returns (in-fill,
    number of such baselines).
    """
    cdt = torch.complex128
    nbase, ntime, nfreq = d.shape
    out = torch.zeros((nbase, ntime, nfreq), dtype=cdt, device=d.device)
    live = torch.nonzero((D.abs() > 0).any(dim=-1) & torch.isfinite(D).all(dim=-1)).squeeze(1)
    if live.numel() == 0:
        return out, nbase
    F = F.to(cdt)
    Dl = D[live].to(cdt)
    Df = (F[None] * Dl[:, None, :]) @ F.conj().T[None]
    Dinv, info = torch.linalg.inv_ex(Df)
    # a singular F D F^H leaves non-finite entries that the solve must not see
    keep = (info == 0) & torch.isfinite(torch.view_as_real(Dinv)).flatten(1).all(dim=1)
    live, Dinv = live[keep], Dinv[keep]
    nlive = live.numel()
    if nlive:
        Nl = Ni[live].to(cdt)
        rhs = Nl[:, :, None] * d[live].to(cdt).transpose(1, 2)
        x, info2 = torch.linalg.solve_ex(Dinv + torch.diag_embed(Nl), rhs)
        good = info2 == 0
        out[live[good]] = x[good].transpose(1, 2)
        nlive = int(good.sum())
    return out, nbase - nlive
