"""Power spectrum estimation from ring maps.

Port of ``draco_tpu.analysis.powerspec`` (reference
``draco/analysis/powerspec.py``: TransformJyPerBeamToKelvin:25,
ConstructWienerDelayTransform:118, ApplyWienerDelayTransform:372,
ReduceExcessScatter:461, ScaleDelayTransform:480,
SpatialTransformDelayMap:539, CrossPowerSpectrum3D:708,
AutoPowerSpectrum3D:818, CylindricalPowerSpectrum2D:837,
SphericalPowerSpectrum2Dto1D:1020, SphericalPowerSpectrum3Dto1D:1116,
and the helpers :1295-2004).

The cosmological conversions, masks and bin edges are host numpy copies
of the JAX package's, on :mod:`draco_tpu_torch.ops.cosmology`.  The data
stay on their device:

* the Wiener operator inverts the masked (freq, freq) matrices of every
  (el, RA) of a polarisation in blocks of elevation, with masked
  rows/cols padded to the identity, by one batched ``inv_ex`` a block
  whose ``info`` is checked;
* the operator is applied by one einsum a polarisation;
* the spatial FFT is one batched ``fft2``; the binnings are flat
  ``bincount``s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops.cosmology import Cosmology
from ..ops.delay import flatten_axes
from ..ops.tools import axis_blocks, invert_no_zero, window_generalised
from .ringmapmaker import find_grid_indices
from .transform import ReduceChisq

C_LIGHT = 299792458.0
NU21 = 1420.405751768  # MHz
KB = 1.380649e-23

_default_cosmo = None


def get_cosmo(*args, **kwargs):
    """Default cosmology (reference powerspec.py:19)."""
    global _default_cosmo
    if args or kwargs:
        return Cosmology(*args, **kwargs)
    if _default_cosmo is None:
        _default_cosmo = Cosmology()
    return _default_cosmo


def _resolve_cosmo(c):
    """Build a Cosmology from a container's stored dict (or passthrough)."""
    if c is None:
        return get_cosmo()
    if isinstance(c, Cosmology):
        return c
    if isinstance(c, dict):
        return Cosmology(**{k: v for k, v in c.items() if v is not None})
    return get_cosmo()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _window(x, window) -> np.ndarray:
    """``window_generalised`` at host points, as a host array."""
    return window_generalised(np.asarray(x, dtype=np.float64), window=window).numpy()


class TransformJyPerBeamToKelvin(ContainerTask):
    """Convert a ringmap from Jy/beam to Kelvin (reference powerspec.py:25).

    Attributes
    ----------
    in_place : bool
        Modify the input container.
    ncyl : int
        Cylinder separations included in the max-baseline PSF estimate.
    """

    in_place = config.bool_prop(True)
    ncyl = config.int_prop(3)

    def setup(self, telescope):
        """Set the telescope used for the maximum baseline."""
        self.telescope = io.get_telescope(telescope)
        self.bl_max = self._get_max_baseline()

    def process(self, rm):
        """Scale map and weights by the Rayleigh-Jeans beam factor, on their device."""
        if not isinstance(rm, containers.RingMap):
            raise ValueError(f"Input container must be instance of RingMap (received {rm.__class__})")

        factor = torch.as_tensor(jy_per_beam_to_kelvin(np.asarray(rm.freq), self.bl_max), device=rm.map[:].device)
        out_map = rm if self.in_place else rm.copy()
        out_map.map[:].mul_(factor[None, None, :, None, None])
        out_map.weight[:].mul_(invert_no_zero(factor)[None, :, None, None] ** 2)
        return out_map

    def _get_max_baseline(self):
        pos = self.telescope.feedpositions
        pairs = self.telescope.prodstack
        sep = pos[pairs["input_a"], :] - pos[pairs["input_b"], :]
        near = find_grid_indices(sep)[0] <= self.ncyl
        return np.linalg.norm(sep[near], axis=-1).max()


class ConstructWienerDelayTransform(ContainerTask):
    """Build a Wiener frequency->delay projection operator.

    (reference powerspec.py:118-369).  Handles missing channels, applied
    spectral filters and known freq-freq noise covariance; the signal
    prior is an exponential-decay diagonal in delay space.  For each
    polarisation the operators of a block of elevations and every RA come
    from one batched solve in complex128 on the ring map's device.

    Attributes
    ----------
    prior_amp, prior_scale : float
        Amplitude / inverse coherence scale (MHz) of the delay prior.
    window : str
        Apodisation window over frequency.
    window_lower_freq, window_upper_freq : float
        Window support bounds in MHz.
    """

    prior_amp = config.float_prop(2.8e-5)
    prior_scale = config.float_prop(0.0)

    window = config.enum(
        ["uniform", "hann", "hanning", "hamming", "blackman", "nuttall", "blackman_nuttall", "blackman_harris",
         "tukey-0.5", "None"],
        default="uniform",
    )
    window_lower_freq = config.float_prop()
    window_upper_freq = config.float_prop()

    def process(self, data):
        """Construct the operator from a filtered ringmap."""
        npol, nfreq, nra, nel = data.weight.shape

        freq = np.asarray(data.freq)
        window = self._get_window(freq)
        win_mask = window > 0

        # Non-negative delay grid over the windowed band
        ntau = int(win_mask.sum())
        grid = np.fft.fftshift(np.fft.fftfreq(ntau, d=np.median(np.abs(np.diff(freq)))))
        tau = grid[grid >= 0.0]

        out = containers.DelayTransformOperator(delay=tau, axes_from=data, attrs_from=data)
        out.attrs.update(
            window=self.window,
            window_lower_freq=self.window_lower_freq,
            window_upper_freq=self.window_upper_freq,
        )

        # Delay -> frequency DFT operator
        F = np.exp(2.0j * np.pi * np.outer(freq, tau)) / np.sqrt(ntau)
        FT = F.T.conj()
        Sdiag = self._get_prior(tau)
        FSFT = (F * Sdiag[np.newaxis, :]) @ FT

        dev = out.filter[:].device
        cdt, rdt = torch.complex128, torch.float64
        consts = dict(
            FT=torch.as_tensor(FT, dtype=cdt, device=dev),
            FSFT=torch.as_tensor(FSFT, dtype=cdt, device=dev),
            Sdiag=torch.as_tensor(Sdiag, dtype=rdt, device=dev),
            window=torch.as_tensor(window, dtype=rdt, device=dev),
            win_mask=torch.as_tensor(win_mask, device=dev),
        )

        wall = data.weight[:]  # [pol, freq, ra, el]
        ball = data.dirty_beam_power[:][0]  # [pol, freq, el]
        for pp in range(npol):
            self.log.info(f"Processing pol {pp}/{npol}")
            C = data.freq_cov[pp].permute(2, 0, 1).to(cdt)  # (ra, freq, freq)
            K = data.filter[pp].permute(2, 0, 1).to(cdt)
            Cdiag = torch.diagonal(C, dim1=1, dim2=2)
            for e0, e1 in axis_blocks(nel, nra * nfreq * nfreq):
                w = wall[pp, :, :, e0:e1].permute(2, 1, 0).to(rdt)  # (el, ra, freq)
                b = ball[pp, :, e0:e1].T.to(rdt).sqrt()  # (el, freq)
                D = _wiener_operator_batch(w, b, C, K, Cdiag, **consts)  # (el, ra, delay, freq)
                out.filter[pp, :, e0:e1] = D.transpose(0, 1)
        return out

    def _get_prior(self, delay):
        """Exponential-decay delay prior (reference powerspec.py:328)."""
        decay = 2.0 * np.pi * self.prior_scale
        return self.prior_amp * np.exp(-decay * np.abs(delay))

    def _get_window(self, freq):
        """Spectral window over the configured band (reference :344)."""
        lo = freq.min() if self.window_lower_freq is None else self.window_lower_freq
        hi = freq.max() if self.window_upper_freq is None else self.window_upper_freq
        self.log.info(f"Windowing ({self.window}) the band {lo:0.2f}-{hi:0.2f} MHz.")
        return _window((freq - lo) / (hi - lo), self.window)


def _wiener_operator_batch(w, b, C, K, Cdiag, FT, FSFT, Sdiag, window, win_mask):
    """The Wiener operators of a block of elevations and every RA.

    w (el, ra, freq) weights, b (el, freq) the beam amplitude, C and K
    (ra, freq, freq) the noise covariance and the applied filter, Cdiag
    (ra, freq).  The reference inverts each RA's valid submatrix with
    np.ix_ + Cholesky (powerspec.py:295-312); here the masked rows/cols are
    padded with an identity block so one batched ``inv_ex`` covers every
    (el, RA).  Returns (el, ra, delay, freq); raises if an inverse fails.
    """
    r_noise = invert_no_zero(w * Cdiag).sqrt() * win_mask  # (el, ra, freq)
    N = C * (r_noise[..., :, None] * r_noise[..., None, :])

    M = (win_mask * (w > 0)).to(w.dtype)  # (el, ra, freq)
    H = M[..., :, None] * K
    HT = H.transpose(-1, -2).conj()

    RSRT = H @ (FSFT * (b[:, None, :, None] * b[:, None, None, :])) @ HT
    A = RSRT + N

    # Pad invalid rows/cols to an identity block, invert, then mask out
    M2 = M[..., :, None] * M[..., None, :]
    eye = torch.eye(A.shape[-1], dtype=w.dtype, device=w.device)
    B = A * M2 + eye * (1.0 - M[..., None, :] * eye)
    A_inv, info = torch.linalg.inv_ex(B)
    failed = int((info != 0).sum())
    if failed:
        raise RuntimeError(f"ConstructWienerDelayTransform: {failed} of {info.numel()} (el, ra) inverses failed")
    A_inv = A_inv * M2

    RT = FT @ HT  # (el, ra, delay, freq)
    return Sdiag[:, None] * (RT @ A_inv) * window


class ApplyWienerDelayTransform(ContainerTask):
    """Apply a precomputed Wiener delay operator to a ringmap.

    (reference powerspec.py:372-458): one einsum a polarisation, on the
    operator's device, in its type (complex64).
    """

    def process(self, data, operator):
        """Project the map into delay space."""
        npol, _, nra, nel = data.weight.shape

        out = containers.DelayTransform(
            baseline=npol * nel, sample=data.index_map["ra"], delay=operator.index_map["delay"], attrs_from=data,
            device=operator.filter[:].device,
        )
        out.add_dataset("weight")

        out.create_index_map("pol", data.index_map["pol"])
        out.create_index_map("el", data.index_map["el"])
        out.attrs["baseline_axes"] = np.array(["pol", "el"])
        out.attrs["freq"] = np.asarray(data.freq)
        # carry the operator's window provenance under window_los* names
        for src in ("window", "window_lower_freq", "window_upper_freq"):
            out.attrs[src.replace("window", "window_los")] = operator.attrs[src]

        filt = operator.filter[:]  # (pol, ra, el, delay, freq)
        maps = data.map[:][0]  # (pol, freq, ra, el)
        var = invert_no_zero(data.weight[:])
        spec = out.spectrum[:].view(npol, nel, nra, -1)
        sweight = out.weight[:].view(npol, nel, nra, -1)
        for pp in range(npol):
            # the output is already (el, ra, delay): the baseline axis is
            # (pol, el) flattened, spec[pp * nel + ee, rr] (reference powerspec.py:431)
            spec[pp] = torch.einsum("retf,fre->ert", filt[pp], maps[pp].to(filt.dtype))
            svar = torch.einsum("retf,fre->ert", filt[pp].abs() ** 2, var[pp].to(filt.real.dtype))
            sweight[pp] = invert_no_zero(svar)
        return out


class ReduceExcessScatter(ReduceChisq):
    """Noise re-scale factor from a jackknife map (reference powerspec.py:461)."""

    def reduction(self, arr, weight, axis):
        """RMS over frequencies of the weighted jackknife."""
        v, num = super().reduction(arr, weight, axis)
        return v.sqrt(), num


class ScaleDelayTransform(ContainerTask):
    """Scale a delay spectrum by a precomputed factor.

    (reference powerspec.py:480-536)

    Attributes
    ----------
    in_place : bool
        Modify the input container.
    """

    in_place = config.bool_prop(True)

    def process(self, ds, rm):
        """Multiply the per-baseline scale factor into the spectrum."""
        scale_factor, _ = flatten_axes(rm.map, ["ra", "freq"])

        out_ds = ds if self.in_place else ds.copy()
        spec = out_ds.spectrum[:]
        sf = scale_factor[: spec.shape[0]].to(spec.device)
        out_ds.spectrum[:] = spec * sf
        out_ds.weight[:] = out_ds.weight[:] * invert_no_zero(sf) ** 2
        return out_ds


class SpatialTransformDelayMap(ContainerTask):
    """2D spatial FFT of a delay map into the (u, v) domain.

    (reference powerspec.py:539-705)

    Attributes
    ----------
    apply_spatial_window : bool
        Apodise RA/Dec before the FFT.
    spatial_window : str
        Window name (see ops.tools.window_generalised).
    ew_min, ew_max, ns_bl : float
        Baseline limits in metres defining the uv mask.
    """

    apply_spatial_window = config.bool_prop(True)
    spatial_window = config.enum(
        ["uniform", "hann", "hanning", "hamming", "blackman", "nuttall", "blackman_nuttall", "blackman_harris",
         "tukey-0.5"],
        default="tukey-0.5",
    )
    ew_min = config.float_prop(14.0)
    ew_max = config.float_prop(76.0)
    ns_bl = config.float_prop(60.0)

    def setup(self, telescope):
        """Set the telescope (for its latitude) and the cosmology."""
        self.tel = io.get_telescope(telescope)
        self.cosmology = get_cosmo()

    def process(self, ds):
        """Transform the delay cube to the spatial Fourier domain."""
        if not isinstance(ds, containers.DelayTransform):
            raise ValueError(f"Input container must be instance of DelayTransform (received {ds.__class__})")

        delay = np.asarray(ds.index_map["delay"])
        el = np.asarray(ds.index_map["el"])
        ra = np.asarray(ds.index_map["sample"])
        dec = self.tel.latitude + np.degrees(np.arcsin(el))
        freq = np.asarray(ds.attrs["freq"])
        wl = C_LIGHT / (freq * 1e6)

        cube = self._unpack_spectrum(ds, ra.size)

        nu_c = freq[freq.size // 2]
        redshift = f2z(nu_c)
        kx, ky, u, v, kpara = get_fourier_modes(ra, dec, delay * 1e-6, redshift, self.cosmology)

        taper = self.spatial_window if self.apply_spatial_window else None

        vis_cube = containers.SpatialDelayCube(
            u=u, v=v, attrs_from=ds, axes_from=ds, cosmology=self.cosmology
        )
        vis_cube.kx[:] = kx
        vis_cube.ky[:] = ky
        vis_cube.kpara[:] = kpara
        vis_cube.uv_mask[:] = spatial_mask(
            kx, ky, self.ew_min, self.ew_max, self.ns_bl, wl.min(), wl.max(), redshift, self.cosmology
        )

        # One batched FFT over all (pol, delay)
        data_uv, NEB_ra, NEB_dec = image_to_uv(cube, ra=ra, dec=dec, window=taper)
        vis_cube.vis[:] = data_uv

        vis_cube.attrs.update(
            freq_center=nu_c,
            redshift=redshift,
            volume=vol_normalization(ra, dec, freq, redshift, self.cosmology),
            window_spatial=str(taper),
            effective_ra=NEB_ra,
            effective_dec=NEB_dec,
        )
        return vis_cube

    def _unpack_spectrum(self, ds, nra):
        """Spectrum as a (pol, delay, ra, el) cube (beam axis sliced at 0)."""
        axes = list(ds.attrs["baseline_axes"])
        lead = tuple(len(ds.index_map[ax]) for ax in axes)
        cube = ds.spectrum[:].reshape(*lead, nra, -1)
        if "beam" in axes:
            cube = cube[(slice(None),) * axes.index("beam") + (0,)]
        return cube.transpose(1, 3)


class CrossPowerSpectrum3D(ContainerTask):
    """3D cross power spectrum of two data cubes (reference powerspec.py:708)."""

    def process(self, vis_1, vis_2):
        """P = norm * V1 V2*, per pol pair, on the cubes' device."""
        if tuple(vis_1.vis.shape) != tuple(vis_2.vis.shape):
            raise ValueError(f"Cross-spectrum cubes disagree in shape: {vis_1.vis.shape} vs {vis_2.vis.shape}")
        if type(vis_1) is not type(vis_2):
            raise TypeError(f"type(vis_1) (={type(vis_1)}) must match type(vis_2) (={type(vis_2)})")

        pol_1 = [str(p) for p in vis_1.index_map["pol"]]
        pol_2 = [str(p) for p in vis_2.index_map["pol"]]
        pol = np.array([f"{p1}-{p2}" for p1 in pol_1 for p2 in pol_2])

        volume_cube = vis_1.attrs["volume"]
        if str(vis_1.attrs.get("window_los")) != "None" and str(vis_2.attrs.get("window_los")) != "None":
            if vis_1.attrs["window_los"] != vis_2.attrs["window_los"]:
                raise ValueError("The two cubes were windowed differently")
            NEB_freq = noise_equivalent_bandwidth(len(vis_1.index_map["delay"]), vis_1.attrs["window_los"])
            vis_1.attrs["effective_bandwidth"] = NEB_freq
        else:
            NEB_freq = 1

        NEB = 1 / (NEB_freq * vis_1.attrs["effective_ra"] * vis_1.attrs["effective_dec"])
        ps_norm = volume_cube * NEB

        ps_cube = containers.PowerSpectrum3D(pol=pol, axes_from=vis_1, attrs_from=vis_1, cosmology=vis_1.cosmology)
        for dset in ["kx", "ky", "kpara", "uv_mask"]:
            ps_cube.datasets[dset][:] = vis_1.datasets[dset][:]

        ps_cube.attrs["ps_norm"] = ps_norm
        if "lsd" in vis_1.attrs and "lsd" in vis_2.attrs:
            ps_cube.attrs["lsd_p0"] = vis_1.attrs["lsd"]
            ps_cube.attrs["lsd_p1"] = vis_2.attrs["lsd"]
        ps_cube.attrs["tag"] = "_x_".join([str(vis_1.attrs.get("tag", "p0")), str(vis_2.attrs.get("tag", "p1"))])

        # All pol pairs at once: (p1, p2, delay, u, v)
        v1, v2 = vis_1.vis[:], vis_2.vis[:]
        ps_cube.spectrum[:] = (ps_norm * v1[:, None] * v2[None, :].conj()).reshape(-1, *v1.shape[1:])
        return ps_cube


class AutoPowerSpectrum3D(CrossPowerSpectrum3D):
    """3D auto power spectrum (reference powerspec.py:818)."""

    def process(self, data):
        """Cross the cube with itself."""
        return super().process(data, data)


def _noise_inverse_variance(noise_ps, like: torch.Tensor) -> torch.Tensor:
    """Inverse-variance weights from an optional 1-sigma noise PS, on ``like``'s device."""
    if noise_ps is None:
        return torch.ones(like.shape, dtype=torch.float64, device=like.device)
    noise = noise_ps.spectrum[:].to(like.device).abs()
    return invert_no_zero(noise**2)


def _uv_selection(u, v, bl_min, bl_max, keep=None):
    """Flat (u, v) indices of the baselines in [bl_min, bl_max], then ``keep`` of those,
    in the row-major order of ``baseline_mask``."""
    sel = np.flatnonzero(baseline_mask(u, v, bl_min, bl_max)[0].ravel())
    return sel if keep is None else sel[keep]


class CylindricalPowerSpectrum2D(ContainerTask):
    """Cylindrically averaged 2D power spectrum (reference powerspec.py:837).

    Attributes
    ----------
    bl_min, bl_max : float
        Baseline-length range in metres.
    Nbins_2D : int
        Number of kperp bins.
    logbins_2D : bool
        Logarithmic binning.
    delay_cut : float
        Mask delays below this (seconds) in the stored signal mask.
    """

    bl_min = config.float_prop(20.0)
    bl_max = config.float_prop(66.0)
    Nbins_2D = config.int_prop(35)
    logbins_2D = config.bool_prop(False)
    delay_cut = config.float_prop(300.0e-9)

    def setup(self, noise_ps=None):
        """Optional 1-sigma noise power spectrum used as inverse variance."""
        self.noise_ps = noise_ps

    def process(self, ps):
        """Bin |k_perp| cylindrically for every (pol, delay): one bincount."""
        if not isinstance(ps, containers.PowerSpectrum3D):
            raise ValueError(f"Input container must be instance of PowerSpectrum3D (received {ps.__class__})")

        cosmo = _resolve_cosmo(ps.cosmology)

        pol = ps.index_map["pol"]
        delay = np.asarray(ps.delay)
        kpara = _host(ps.kpara[:])
        u = np.asarray(ps.index_map["u"])
        v = np.asarray(ps.index_map["v"])
        uv_mask = np.asarray(ps.uv_mask[:])
        redshift = ps.attrs["redshift"]
        nu_c = ps.attrs["freq_center"]
        wl = C_LIGHT / (nu_c * 1e6)

        u_lo = self.bl_min / wl
        u_hi = self.bl_max / wl
        edges = _k_edges(
            u_to_kperp(u_lo, redshift, cosmo), u_to_kperp(u_hi, redshift, cosmo), self.Nbins_2D, self.logbins_2D
        )
        centres = 0.5 * (edges[1:] + edges[:-1])

        ps_3D = ps.spectrum[:]
        dev = ps_3D.device
        weight = _noise_inverse_variance(self.noise_ps, ps_3D)

        pspec_2D = containers.PowerSpectrum2D(
            pol=pol, delay=delay, uv_dist=kperp_to_u(centres, redshift, cosmo), attrs_from=ps, cosmology=cosmo,
            device=dev,
        )
        pspec_2D.kpara[:] = kpara
        pspec_2D.kperp[:] = centres
        pspec_2D.attrs["delay_cut"] = self.delay_cut

        # Flatten uv (common for all pol/delay), mask and bin once
        flat, uu, vv = reshape_data_cube(np.broadcast_to(uv_mask, ps_3D.shape[-2:]), u, v, u_lo, u_hi)
        radius = np.hypot(u_to_kperp(uu, redshift, cosmo), u_to_kperp(vv, redshift, cosmo))
        raw_bin = np.digitize(radius, bins=edges)
        nbins = len(edges) - 1
        keep = flat.astype(bool) & (raw_bin >= 1) & (raw_bin <= nbins)
        bidx = torch.as_tensor(raw_bin[keep] - 1, device=dev)
        sel = torch.as_tensor(_uv_selection(u, v, u_lo, u_hi, keep), device=dev)

        # One flat bincount over every (pol, delay) plane via offset bins
        npol, ndelay = ps_3D.shape[:2]
        planes = (torch.arange(npol * ndelay, device=dev)[:, None] * nbins + bidx[None, :]).ravel()

        def binned(rows):
            return torch.bincount(planes, weights=rows.ravel(), minlength=npol * ndelay * nbins).reshape(
                npol, ndelay, nbins
            )

        d = ps_3D.reshape(npol, ndelay, -1)[:, :, sel]
        w = weight.reshape(npol, ndelay, -1)[:, :, sel]
        wsum = binned(w)
        pspec_2D.spectrum[:] = binned((w * d).real) / wsum
        pspec_2D.weight[:] = wsum
        pspec_2D.neff[:] = torch.nan_to_num(wsum**2 / binned(w**2))

        mask = np.ones(pspec_2D.mask.shape, dtype=bool)
        if self.delay_cut > 0.0:
            kpar_lim = delays_to_kpara(self.delay_cut, redshift, cosmo)
            mask[:, kpara < kpar_lim, :] = False
        pspec_2D.mask[:] = mask
        return pspec_2D


class SphericalPowerSpectrum2Dto1D(ContainerTask):
    """Spherically averaged 1D spectrum from a 2D spectrum.

    (reference powerspec.py:1020)

    Attributes
    ----------
    Nbins_3D : int
        Number of k bins.
    logbins_3D : bool
        Logarithmic binning.
    bin_edges : list
        Explicit bin edges (overrides the other two).
    """

    Nbins_3D = config.int_prop(8)
    logbins_3D = config.bool_prop(True)
    bin_edges = config.list_prop(None)

    def process(self, ps2D):
        """Bin |k| spherically per polarisation."""
        if not isinstance(ps2D, containers.PowerSpectrum2D):
            raise ValueError(f"Input container must be instance of PowerSpectrum2D (received {ps2D.__class__})")

        if self.bin_edges is not None:
            self.Nbins_3D = len(self.bin_edges)
            kbins = np.array(self.bin_edges)
        else:
            kbins = None

        pol = ps2D.index_map["pol"]
        ps_2D = ps2D.spectrum[:]
        mask_2D = np.asarray(ps2D.mask[:])
        weight_2D = ps2D.weight[:]

        pspec_1D = containers.PowerSpectrum1D(
            pol=pol, k=self.Nbins_3D - 1, attrs_from=ps2D, cosmology=_resolve_cosmo(ps2D.cosmology),
            device=ps_2D.device,
        )
        per_pol = [
            get_1d_ps(
                ps_2D[pp], ps2D.kperp[:], ps2D.kpara[:], signal_window=mask_2D[pp], kbins=kbins,
                Nbins_3D=self.Nbins_3D, weight_cube=weight_2D[pp], logbins_3D=self.logbins_3D,
            )
            for pp in range(len(pol))
        ]
        _store_1d(pspec_1D, per_pol)
        return pspec_1D


class SphericalPowerSpectrum3Dto1D(ContainerTask):
    """Spherically averaged 1D spectrum directly from the 3D cube.

    (reference powerspec.py:1116).  Consistency counterpart of
    :class:`SphericalPowerSpectrum2Dto1D`.

    Attributes
    ----------
    bl_min, bl_max : float
        Baseline range in metres.
    Nbins_3D, logbins_3D
        k-binning controls.
    delay_cut : float
        Delay mask threshold in seconds.
    """

    bl_min = config.float_prop(20.0)
    bl_max = config.float_prop(66.0)
    Nbins_3D = config.int_prop(9)
    logbins_3D = config.bool_prop(True)
    delay_cut = config.float_prop(300.0e-9)

    def setup(self, noise_ps=None):
        """Optional 1-sigma noise power spectrum used as inverse variance."""
        self.noise_ps = noise_ps

    def process(self, ps):
        """Flatten uv, mask, and bin |k| per polarisation."""
        if not isinstance(ps, containers.PowerSpectrum3D):
            raise ValueError(f"Input container must be instance of PowerSpectrum3D (received {ps.__class__})")

        cosmo = _resolve_cosmo(ps.cosmology)
        pol = ps.index_map["pol"]
        kpara = _host(ps.kpara[:])
        u = np.asarray(ps.index_map["u"])
        v = np.asarray(ps.index_map["v"])
        uv_mask = np.asarray(ps.uv_mask[:])
        redshift = ps.attrs["redshift"]
        wl = C_LIGHT / (ps.attrs["freq_center"] * 1e6)

        u_lo = self.bl_min / wl
        u_hi = self.bl_max / wl

        ps_3D = ps.spectrum[:]
        dev = ps_3D.device
        weight = _noise_inverse_variance(self.noise_ps, ps_3D)

        pspec_1D = containers.PowerSpectrum1D(
            k=self.Nbins_3D - 1, axes_from=ps, attrs_from=ps, cosmology=cosmo, device=dev
        )

        m_flat, uu_flat, vv_flat = reshape_data_cube(uv_mask, u, v, u_lo, u_hi)
        m_flat = m_flat.astype(bool)
        kperp = np.hypot(u_to_kperp(uu_flat[m_flat], redshift, cosmo), u_to_kperp(vv_flat[m_flat], redshift, cosmo))

        # Mask delays inside the cut out of the signal window (same for every pol)
        window = np.ones((kpara.size, int(m_flat.sum())), dtype=bool)
        if self.delay_cut > 0.0:
            kpar_lim = delays_to_kpara(self.delay_cut, redshift, cosmo)
            window[kpara < kpar_lim, :] = False

        sel = torch.as_tensor(_uv_selection(u, v, u_lo, u_hi, m_flat), device=dev)
        npol, ndelay = ps_3D.shape[:2]
        per_pol = [
            get_1d_ps(
                ps_3D[pp].reshape(ndelay, -1)[:, sel], kperp, kpara, signal_window=window, Nbins_3D=self.Nbins_3D,
                weight_cube=weight[pp].reshape(ndelay, -1)[:, sel], logbins_3D=self.logbins_3D,
            )
            for pp in range(npol)
        ]
        _store_1d(pspec_1D, per_pol)
        return pspec_1D


# ---------------------------------------------------------------------------
# Cosmological conversion helpers (reference powerspec.py:1295-1467); host numpy
# ---------------------------------------------------------------------------


def f2z(freq):
    """Frequency (MHz) -> 21cm redshift (reference :1295)."""
    return NU21 / freq - 1


def z2f(z):
    """Redshift -> 21cm frequency in MHz (reference :1310)."""
    return NU21 / (z + 1)


def dRperp_dtheta(z, cosmo=None):
    """Transverse comoving distance per radian, [h^-1 Mpc / rad]."""
    return (cosmo or get_cosmo()).comoving_distance_h(z)


def dRpara_df(z, cosmo=None):
    """Radial comoving distance per Hz, [h^-1 Mpc / Hz] (Liu+14 Eq. A9)."""
    cosmo = cosmo or get_cosmo()
    # H(z)/h has units km h / (s Mpc); c/(nu21 * H) then gives h^-1 Mpc/Hz
    hubble_over_h = cosmo.H(z) * (100.0 / cosmo.H0)
    rest_hz = NU21 * 1e6
    return (C_LIGHT / 1e3) * (1 + z) ** 2.0 / (hubble_over_h * rest_hz)


def delays_to_kpara(delay, z, cosmo=None):
    """Delay (s) -> k_parallel [h/Mpc] (Liu+14 Eq. A10)."""
    return 2 * np.pi * delay / dRpara_df(z, cosmo=cosmo)


def kpara_to_delay(kpara, z, cosmo=None):
    """k_parallel [h/Mpc] -> delay (s)."""
    return dRpara_df(z, cosmo=cosmo) * kpara / (2 * np.pi)


def u_to_kperp(u, z, cosmo=None):
    """Baseline u (wavelengths) -> k_perp [h/Mpc]."""
    return 2 * np.pi * u / dRperp_dtheta(z, cosmo=cosmo)


def kperp_to_u(kperp, z, cosmo=None):
    """k_perp [h/Mpc] -> baseline u (wavelengths)."""
    return dRperp_dtheta(z, cosmo=cosmo) * kperp / (2 * np.pi)


def jy_per_beam_to_kelvin(freq, bl_length):
    """Jy/beam -> Kelvin factor for a Gaussian PSF (reference :1470)."""
    wl = C_LIGHT / (freq * 1e6)
    # Rayleigh FWHM of the longest-baseline PSF, as a Gaussian solid angle
    fwhm_rad = 1.22 * wl / bl_length
    beam_sr = np.pi * fwhm_rad**2 / (4 * np.log(2))
    return 1.0e-26 * wl**2 / (2 * KB * beam_sr)


def noise_equivalent_bandwidth(N, window):
    """Relative equivalent noise bandwidth of a window (reference :1502)."""
    taper = _window(np.arange(N) / N, window)
    return taper.sum() ** 2 / (N * (taper**2).sum())


def _map_resolution(ra, dec, redshift, cosmo):
    """Comoving pixel sizes (d_RA, d_DEC) in h^-1 Mpc of an (ra, dec) grid."""
    dist = dRperp_dtheta(redshift, cosmo=cosmo)
    pix_ra = np.deg2rad(np.diff(ra).mean()) * np.cos(np.deg2rad(dec)).mean()
    pix_dec = np.deg2rad(np.diff(dec).mean())
    return dist * pix_ra, dist * pix_dec


def get_fourier_modes(ra, dec, delays, redshift, cosmo=None):
    """Spatial and line-of-sight Fourier modes (reference :1526).

    Returns (kx, ky, u, v, kpara).
    """
    cosmo = cosmo or get_cosmo()
    d_ra, d_dec = _map_resolution(ra, dec, redshift, cosmo)

    def k_axis(n, d):
        return 2 * np.pi * np.fft.fftshift(np.fft.fftfreq(n, d=d))

    k_x = k_axis(ra.size, d_ra)
    k_y = k_axis(dec.size, d_dec)
    return (
        k_x,
        k_y,
        kperp_to_u(k_x, redshift, cosmo),
        kperp_to_u(k_y, redshift, cosmo),
        delays_to_kpara(delays, redshift, cosmo),
    )


def image_to_uv(data: torch.Tensor, ra, dec, window="tukey-0.5"):
    """Spatial FFT over the last two axes (RA, Dec), batched on the data's device.

    (reference :1585 operates on one 2D slice at a time; here any leading
    axes are batched through a single ``torch.fft.fft2``.)
    """
    FT_norm = 1 / float(data.shape[-1] * data.shape[-2])

    if window:
        x_ra = (ra - ra[0]) / (ra[-1] - ra[0])
        x_dec = (dec - dec[0]) / (dec[-1] - dec[0])
        taper = np.outer(_window(x_ra, window), _window(x_dec, window))
        NEB_ra = noise_equivalent_bandwidth(ra.size, window)
        NEB_dec = noise_equivalent_bandwidth(dec.size, window)
        data = data * torch.as_tensor(taper, device=data.device)
    else:
        NEB_ra = NEB_dec = 1.0

    uv_map = torch.fft.fftshift(torch.fft.fft2(data, dim=(-2, -1)), dim=(-2, -1))
    return uv_map * FT_norm, NEB_ra, NEB_dec


def vol_normalization(ra, dec, freq, redshift, cosmo=None):
    """Survey volume normalisation in h^-3 Mpc^3 (reference :1628)."""
    cosmo = cosmo or get_cosmo()
    d_ra, d_dec = _map_resolution(ra, dec, redshift, cosmo)
    depth_per_hz = dRpara_df(redshift, cosmo=cosmo)
    band_hz = np.abs(np.diff(freq)).mean() * 1e6 * freq.size
    return (ra.size * d_ra) * (dec.size * d_dec) * (depth_per_hz * band_hz)


def nanaverage(d, w, axis=None):
    """Weighted average ignoring NaNs (reference :1677)."""
    num = np.sum(d * w, axis=axis, where=~np.isnan(d))
    return num / np.sum(w, axis=axis)


def _band_zone(k, lo, hi):
    """Mask of |k| within [lo, hi] (two-sided)."""
    mag = np.abs(k)
    return (mag >= min(lo, hi)) & (mag <= max(lo, hi))


def spatial_mask(k_x, k_y, ew_min, ew_max, ns_bl, wl_min, wl_max, redshift, cosmo=None):
    """uv-domain mask covering the instrument's baseline zones (reference :1697)."""
    cosmo = cosmo or get_cosmo()

    def to_k(u):
        return u_to_kperp(u, redshift, cosmo=cosmo)

    zone_x = _band_zone(k_x, to_k(ew_min / wl_max), to_k(ew_max / wl_min))
    # the NS zone is symmetric about zero and includes k_y = 0
    zone_y = np.abs(k_y) <= abs(to_k(ns_bl / wl_max))
    return zone_x[:, None] * zone_y[None, :]


def get_3D_ps(data_cube_1, data_cube_2, vol_norm_factor):
    """Real part of the cross power of two cubes (reference :1765)."""
    if data_cube_1 is None and data_cube_2 is None:
        raise NameError("Provide at least one data cube")
    if data_cube_2 is None:
        data_cube_2 = data_cube_1
    return (data_cube_1 * data_cube_2.conj()).real * vol_norm_factor


def baseline_mask(u, v, bl_min, bl_max):
    """[nu, nv] mask of baselines whose |u| lies in [bl_min, bl_max].

    The single source of the selection used by reshape_data_cube and its
    callers: the flat selections downstream must align with the flattened
    uu/vv this module returns.
    """
    g_vv, g_uu = np.meshgrid(u, v, indexing="ij")
    radius = np.hypot(g_uu, g_vv)
    return (radius >= bl_min) & (radius <= bl_max), g_uu, g_vv


def reshape_data_cube(data_cube, u, v, bl_min, bl_max):
    """Flatten a uv cube keeping baselines in [bl_min, bl_max] (reference :1797)."""
    bl_idx, g_uu, g_vv = baseline_mask(u, v, bl_min, bl_max)
    return data_cube[..., bl_idx], g_uu[bl_idx], g_vv[bl_idx]


def _store_1d(cont, per_pol):
    """Write per-pol (k, ps, err, var, neff) rows into a PowerSpectrum1D."""
    for name, col in zip(("k1D", "spectrum", "samp_var", "var", "neff"), zip(*per_pol)):
        cont.datasets[name][:] = torch.stack(col)


def _bin_select(values: torch.Tensor, edges):
    """(in-range selector, zero-based bin of each selected value): ``np.digitize`` semantics."""
    raw = torch.bucketize(values, torch.as_tensor(edges, dtype=values.dtype, device=values.device), right=True)
    inside = (raw >= 1) & (raw < len(edges))
    return inside, raw[inside] - 1


def _bin_sums(b, nbins, columns):
    """bincount each column of weights onto nbins bins."""
    return [torch.bincount(b, weights=c, minlength=nbins) for c in columns]


def _k_edges(lo, hi, n, log):
    if log:
        return np.logspace(np.log10(lo), np.log10(hi), n)
    return np.linspace(lo, hi, n)


def _as_float64(x, device) -> torch.Tensor:
    return torch.as_tensor(_host(x) if not isinstance(x, torch.Tensor) else x, device=device).to(torch.float64)


def get_2d_ps(ps_cube, weight, kperp_bins, uu, vv, redshift, cosmo=None):
    """Cylindrically bin a flattened spectrum (reference :1836), on ``ps_cube``'s device.

    One flat bincount instead of a per-bin scan.
    """
    cosmo = cosmo or get_cosmo()
    ps_cube = torch.as_tensor(ps_cube)
    dev = ps_cube.device
    radius = torch.as_tensor(
        np.hypot(u_to_kperp(uu, redshift, cosmo=cosmo), u_to_kperp(vv, redshift, cosmo=cosmo)), device=dev
    )
    inside, b = _bin_select(radius, kperp_bins)
    nbins = len(kperp_bins) - 1
    w = _as_float64(weight, dev)[inside]
    wsum, wp, w2 = _bin_sums(b, nbins, (w, (w * ps_cube[inside]).real, w**2))
    return wp / wsum, wsum, wsum**2 / w2


def get_1d_ps(ps_2D, kperp, kpara, weight_cube, signal_window=None, kbins=None, Nbins_3D=10, logbins_3D=True):
    """Spherically average to 1D (reference :1899), on ``ps_2D``'s device.

    Returns (k1d, ps, sample-variance error, variance, n_eff) as tensors.
    """
    ps_2D = torch.as_tensor(ps_2D)
    dev = ps_2D.device
    k = torch.hypot(_as_float64(kperp, dev)[None, :], _as_float64(kpara, dev)[:, None])
    w = torch.as_tensor(weight_cube, device=dev)
    if signal_window is not None:
        sw = torch.as_tensor(np.asarray(signal_window), device=dev)
        k, ps_2D, w = (a[sw] for a in (k, ps_2D, w))

    if kbins is None:
        # bin edges are derived from the selection; an empty selection
        # yields NaN bins rather than a crash
        positive = k > 0
        if not bool(positive.any()):
            n = Nbins_3D - 1
            nan = torch.full((n,), float("nan"), dtype=torch.float64, device=dev)
            return nan, nan.clone(), nan.clone(), nan.clone(), torch.zeros(n, dtype=torch.float64, device=dev)
        kbins = _k_edges(k[positive].min().item(), k.max().item(), Nbins_3D, logbins_3D)

    kf, pf, wf = (a.reshape(-1) for a in (k, ps_2D, w))
    inside, b = _bin_select(kf, kbins)
    nbins = len(kbins) - 1
    wi, pi, ki = wf[inside], pf[inside], kf[inside]
    wsum, w2sum, wp, wk = _bin_sums(b, nbins, (wi, wi**2, (wi * pi).real, wi * ki))

    ps_3D = wp / wsum
    return (wk / wsum, ps_3D, (w2sum * ps_3D.abs() ** 2 / wsum**2).sqrt(), 1 / wsum, wsum**2 / w2sum)
