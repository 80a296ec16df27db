"""Fringe-rate mixing of visibilities.

Port of ``draco_tpu.analysis.fringestop`` (reference
``draco/analysis/fringestop.py``: Mix:10, DownMix:130, UpMix:136):
multiplying a stream by the fringe phasor of a field-centre source slows
its fringing so the time axis can be decimated.

The stream is rotated where it lies, in place, one frequency at a time.
``omega * phi`` reaches ~1e3 rad on CHIME's longest EW baselines, where a
float32 angle is ~1e-4 rad off; the angle is formed in float64 and reduced
to [-pi, pi) before it is cast to the data's precision and turned into the
phasor.  The JAX package's split real and imaginary planes (a workaround
for its transfer layer) have no counterpart here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import io
from ..core.task import ContainerTask

_C_MS = 299792458.0


def mix_in_place(vis: torch.Tensor, omega: torch.Tensor, phi: torch.Tensor, freq_axis: int) -> None:
    """``vis *= exp(i omega phi)``, one slab of ``freq_axis`` at a time.

    ``omega`` [freq, ...] (float64, radians per radian of rotation) broadcasts
    against the vis axes after ``freq_axis`` but the last; ``phi`` [nsample]
    (float64, radians) is the last axis.  The angle is reduced in float64.
    """
    rdt = vis.real.dtype
    for f in range(vis.shape[freq_axis]):
        ang = torch.remainder(omega[f, ..., None] * phi + math.pi, 2 * math.pi) - math.pi
        ang = ang.to(rdt)
        vis.select(freq_axis, f).mul_(torch.polar(torch.ones_like(ang), ang))


class Mix(ContainerTask):
    r"""Multiply a stream by a fringe phasor in earth-rotation angle.

    The mixing frequency ``omega = 2 pi b_ew cos(dec) / lambda`` is the
    fringe rate of a source at the field centre; down-mixing (the
    default) cancels that fringing.  Works on both stacked streams
    (``vis[freq, stack, ra|time]``, with the telescope's product mask
    applied to vis and weight) and hybrid beamformed streams
    (``vis[pol, freq, ew, el, ra]``).  Semantics of reference
    ``draco/analysis/fringestop.py:10-127``.
    """

    def setup(self, manager):
        """Keep the telescope model (feed positions, latitude, LSA)."""
        self.telescope = io.get_telescope(manager)

    def _ew_and_mask(self, stream):
        """EW baseline separation (m) and an optional product mask [stack]."""
        if "ew" in stream.index_map:
            return np.asarray(stream.index_map["ew"])[:, np.newaxis], None
        pairs = stream.prodstack
        pos = self.telescope.feedpositions[:, 0]
        sep = pos[pairs["input_a"]] - pos[pairs["input_b"]]
        keep = self.telescope.feedmask[(pairs["input_a"], pairs["input_b"])].astype(np.float64)
        return sep, keep

    def _rotation_angle(self, stream):
        """Earth-rotation angle samples in radians."""
        if "ra" in stream.index_map:
            return np.radians(np.asarray(stream.ra))
        return np.radians(self.telescope.unix_to_lsa(np.asarray(stream.time)))

    def _cos_dec(self, stream):
        """cos(declination) of each pointing (scalar or per-el row)."""
        if "el" in stream.index_map:
            el = np.asarray(stream.index_map["el"])[np.newaxis, :]
            return np.cos(np.arcsin(el) + np.radians(self.telescope.latitude))
        offset = getattr(self.telescope, "elevation_pointing_offset", 0.0)
        return np.cos(np.radians(self.telescope.latitude + offset))

    def omega(self, stream) -> np.ndarray:
        """The mixing frequency [freq, stack] or [freq, ew, el], float64."""
        sep, _ = self._ew_and_mask(stream)
        wavenumber = np.asarray(stream.freq) * 1e6 / _C_MS
        geom = sep * self._cos_dec(stream)
        omega = 2.0 * np.pi * wavenumber.reshape((-1,) + (1,) * np.ndim(geom)) * geom
        return -omega if self.conjugate else omega

    def process(self, stream):
        """Mix ``stream`` in place and return it."""
        hybrid = "ew" in stream.index_map
        _, prod_mask = self._ew_and_mask(stream)
        vis, weight = stream.vis[:], stream.weight[:]
        dev = vis.device
        if prod_mask is not None:
            keep = torch.as_tensor(prod_mask, device=dev)[:, None]
            vis.mul_(keep.to(vis.real.dtype))
            weight.mul_(keep.to(weight.dtype))
        omega = torch.as_tensor(self.omega(stream), dtype=torch.float64, device=dev)
        phi = torch.as_tensor(self._rotation_angle(stream), dtype=torch.float64, device=dev)
        mix_in_place(vis, omega, phi, freq_axis=1 if hybrid else 0)
        stream.attrs["fringestopped"] = not self.conjugate
        return stream


class DownMix(Mix):
    """Remove the field-centre fringing (reference fringestop.py:130)."""

    conjugate = False


class UpMix(Mix):
    """Restore the fringing of a down-mixed stream (reference fringestop.py:136)."""

    conjugate = True
