"""Effective-beam streams for ring-map deconvolution.

Port of ``draco_tpu.analysis.beam`` (reference ``draco/analysis/beam.py``:
CreateBeamStream:25, CreateBeamStreamFromTelescope:159): a beam model
sampled in celestial coordinates becomes a
:class:`~draco_tpu_torch.core.containers_spec.HybridVisStream` carrying
the effective beam transfer function on the data's (ew, el, ra) grid.

The fringe phasor over the (freq, ew, dec, ha) grid and the el-averaged
weights are evaluated on the beam's device, one frequency at a time.  The
projected distance ``d`` reaches ~300 turns on CHIME's baselines, where a
float32 ``exp(2 pi i d)`` is ~1e-4 rad off: ``d`` is formed in float64 and
reduced to the nearest turn, ``d - round(d)``, before the sine and cosine
(as the beamforming path does).  The JAX package takes ``exp(2 pi i d)``
of the unreduced ``d``; in float64, as its tests run, the two agree to
~1e-13 rad.  The telescope's beam model (``beam_at``) is host numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import containers, io
from ..core.task import ContainerTask
from ..ops.interferometry import projected_distance
from ..ops.tools import invert_no_zero

_C_MS = 299792458.0


def phased_beam(beam: torch.Tensor, bweight: torch.Tensor, ha, dec, u, v, lat: float):
    """Rotate the beam by the conjugate fringe phasor; el-average the weights.

    beam : [pol, freq, input, dec, ha] complex tensor (input broadcasts to ew)
    bweight : [freq, pol, input, dec, ha] weight tensor on the same device
    ha, dec : [nha], [ndec] radians (host)
    u, v : [freq, ew] rotated EW/NS baseline lengths in wavelengths (host)
    lat : latitude in radians

    Returns the phased beam [pol, freq, ew, dec, ha] in the beam's dtype and
    the el-averaged weight [freq, pol, input, ha].
    """
    dev = beam.device
    f64 = dict(dtype=torch.float64, device=dev)
    ha_t = torch.as_tensor(np.asarray(ha), **f64)[None, None, :]
    dec_t = torch.as_tensor(np.asarray(dec), **f64)[None, :, None]
    u_t = torch.as_tensor(np.asarray(u), **f64)
    v_t = torch.as_tensor(np.asarray(v), **f64)
    npol, nfreq, _, ndec, nha = beam.shape
    out = torch.empty((npol, nfreq, u_t.shape[1], ndec, nha), dtype=beam.dtype, device=dev)
    for f in range(nfreq):
        d = projected_distance(ha_t, lat, dec_t, u_t[f, :, None, None], v_t[f, :, None, None])  # [ew, dec, ha]
        turns = (d - torch.round(d)).to(beam.real.dtype)
        out[:, f] = beam[:, f] * torch.polar(torch.ones_like(turns), 2.0 * math.pi * turns)
    nonzero = (bweight > 0).to(bweight.dtype)
    wavg = bweight.sum(dim=-2) * invert_no_zero(nonzero.sum(dim=-2))
    return out, wavg


class CreateBeamStream(ContainerTask):
    """Lay a celestial GridBeam onto a HybridVisStream's (el, RA) grid.

    The output carries ``beam * exp(+2 pi i b.n(ha, dec))``: the
    conjugate fringe phasor undoes the phase the (unrotated) NS
    beamformer applied, including the telescope rotation angle.
    Semantics of reference ``draco/analysis/beam.py:25-156``.
    """

    telescope = None

    def setup(self, telescope):
        """Capture the telescope model (latitude, rotation angle)."""
        self.telescope = io.get_telescope(telescope)
        lat = self.telescope.latitude
        rot = getattr(self.telescope, "rotation_angle", 0.0)
        self.log.info(f"Telescope model: latitude {lat:.4f} deg, rotation {rot:.4f} deg.")

    @staticmethod
    def _ra_placement(ha):
        """Indices placing the beam's hour angles onto a full-RA grid."""
        ra = (np.asarray(ha) + 360.0) % 360.0
        nra = round(360.0 / abs(ha[1] - ha[0]))
        cell = 360.0 / nra
        idx = np.rint(ra / cell).astype(int)
        if not np.allclose(ra / cell, idx, atol=1e-4):
            raise ValueError(
                "The beam's hour-angle sampling does not divide 360 deg evenly, so it cannot be scattered onto an "
                "RA grid."
            )
        return idx, nra

    def process(self, data, beam):
        """Build the effective-beam HybridVisStream for ``data``.

        Parameters
        ----------
        data : containers.HybridVisStream
            Supplies the (ew, el, freq) grid the beam is mapped onto.
        beam : containers.GridBeam
            Celestial beam model; its theta axis is declination.
        """
        if beam.coords != "celestial":
            raise RuntimeError(f"CreateBeamStream needs a GridBeam sampled in celestial coordinates; got {beam.coords!r}.")
        lat = self.telescope.latitude
        dec = np.asarray(beam.theta)
        if not np.allclose(np.sin(np.radians(dec - lat)), np.asarray(data.index_map["el"])):
            raise RuntimeError("Beam declinations do not line up with the data's el axis.")

        ha = np.asarray(beam.phi)
        map_ra, nra = self._ra_placement(ha)

        # rotated baseline components in wavelengths, [freq, ew]
        wavelength = _C_MS * 1e-6 / np.asarray(beam.freq)
        b_ew = np.asarray(data.index_map["ew"])[None, :] / wavelength[:, None]
        rot = np.radians(getattr(self.telescope, "rotation_angle", 0.0))

        phased, wavg = phased_beam(
            beam.beam[:].transpose(0, 1), beam.weight[:], np.radians(ha), np.radians(dec),
            np.cos(rot) * b_ew, np.sin(rot) * b_ew, np.radians(lat),
        )
        out = containers.HybridVisStream(ra=nra, axes_from=data, attrs_from=data)
        idx = torch.as_tensor(map_ra, device=phased.device)
        out.vis[:].index_copy_(-1, idx, phased.to(out.vis.dtype))
        w = out.weight[:]
        w.index_copy_(-1, idx, wavg.transpose(0, 1).to(w.dtype).expand(*w.shape[:-1], len(map_ra)))
        return out


class CreateBeamStreamFromTelescope(CreateBeamStream):
    """Same, but evaluating the telescope's own beam model.

    Semantics of reference ``draco/analysis/beam.py:159-257``; each
    needed (feed, freq) beam is evaluated once over the whole (dec, ha)
    grid (host numpy, the telescope's ``beam_at``) and reused across
    polarisation pairs.
    """

    def process(self, data):
        """Evaluate the telescope beam and map it onto ``data``'s grid."""
        return super().process(data, self._evaluate_beam(data))

    def _grid_coordinates(self, data):
        """(dec, ha) grid matching the data's (el, RA) sampling."""
        ha = (np.asarray(data.ra) + 180.0) % 360.0 - 180.0
        dec = np.degrees(np.arcsin(np.asarray(data.index_map["el"]))) + self.telescope.latitude
        return dec, ha

    def _evaluate_beam(self, data):
        """Fill a celestial GridBeam from ``telescope.beam_at``."""
        dec, ha = self._grid_coordinates(data)
        out = containers.GridBeam(theta=dec, phi=ha, input=np.array(["common-mode"]), axes_from=data,
                                  attrs_from=data)
        pol_pairs = [p.decode() if isinstance(p, bytes) else str(p) for p in out.index_map["pol"]]
        tel_pol = list(self.telescope.polarisation)

        # nearest telescope frequency channel per data channel, flagged
        # invalid when it falls outside the channel width
        fmap = data.index_map["freq"]
        centres = fmap["centre"] if fmap.dtype.names else np.asarray(fmap)
        widths = fmap["width"] if fmap.dtype.names else np.full(len(centres), np.abs(np.diff(centres)).mean())
        tel_freq = self.telescope.frequencies
        nearest = np.argmin(np.abs(centres[:, None] - tel_freq[None, :]), axis=1)
        in_band = np.abs(centres - tel_freq[nearest]) <= 0.5 * widths

        # one angular-position list covering the whole grid
        grid_shape = (dec.size, ha.size)
        theta_g, phi_g = np.meshgrid(0.5 * np.pi - np.radians(dec), np.radians(ha), indexing="ij")
        angpos = np.stack([theta_g.ravel(), phi_g.ravel()], axis=-1)

        beam = np.zeros(out.beam.shape, dtype=np.complex64)
        weight = np.ones(out.weight.shape, dtype=np.float32)
        for ff, tel_ff in enumerate(nearest):
            if not in_band[ff]:
                weight[ff] = 0.0
                continue
            cache = {}
            for pp, pair in enumerate(pol_pairs):
                for c in pair:
                    if c not in cache:
                        cache[c] = np.asarray(self.telescope.beam_at(tel_pol.index(c), tel_ff, angpos))
                power = cache[pair[0]] * cache[pair[1]].conj()
                if power.ndim == 2:
                    # polarised (E_theta, E_phi) response: total intensity
                    power = power.sum(axis=-1)
                beam[ff, pp, 0] = power.reshape(grid_shape)
        out.beam[:] = beam
        out.weight[:] = weight
        return out
