"""Simulated gain fluctuations and gain-product stacking.

Port of ``draco_tpu.synthesis.gain`` (reference ``draco/synthesis/gain.py``:
BaseGains:11, SiderealGains:116, RandomGains:223, RandomSiderealGains:296,
GainStacker:305, generate_fluctuations:442, gaussian_realisation:479,
constrained_gaussian_realisation:522).

Gain streams are draws from a squared-exponential Gaussian process per
(freq, input); a stream that continues across file boundaries is drawn
*conditioned on* the previous chunk.  The draws stay on the host in
float64 from the task's ``self.rng``, so a seed gives the JAX package's
gains exactly; the gain containers' tensors live on the stream's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.containers import empty_like
from ..core.task import ContainerTask, PipelineStopIteration, RandomTask
from ..ops.tools import invert_no_zero


def squared_exponential(scale, sigma):
    """Return ``C(x) = sigma^2 exp(-(xi - xj)^2 / (2 scale^2))``."""

    def cov(x):
        sep = x[:, np.newaxis] - x[np.newaxis, :]
        return sigma**2 * np.exp(-0.5 * (sep / scale) ** 2)

    return cov


class BaseGains(ContainerTask, RandomTask):
    """Common machinery for gain-stream simulation (reference gain.py:11-113).

    Subclasses supply ``_generate_amp`` / ``_generate_phase``; this class
    assembles ``g = amp * exp(i phase)`` into a gain container matching
    the input stream, on its device.

    Attributes
    ----------
    amp, phase : bool
        Toggle amplitude / phase fluctuations independently.
    """

    amp = config.bool_prop(True)
    phase = config.bool_prop(True)

    _prev_time = None

    def _fill_gains(self, out, time, freq):
        """Draw fluctuations and write ``out.gain`` for samples ``time``."""
        self.freq = freq
        self.ninput_local = out.gain.shape[1]
        self.ninput_global = out.gain.shape[1]

        amp = self._generate_amp(time) if self.amp else 1.0
        ph = self._generate_phase(time) if self.phase else 0.0
        out.gain[:] = amp * np.exp(1.0j * ph)
        self._prev_time = time

    def process(self, data):
        """Gain stream on the input's own time samples."""
        data.redistribute("freq")
        out = containers.GainData(axes_from=data)
        self._fill_gains(out, data.time, data.index_map["freq"]["centre"][:])
        return out

    def _generate_amp(self, time):
        raise NotImplementedError

    def _generate_phase(self, time):
        raise NotImplementedError


class SiderealGains(BaseGains):
    """One gain stream per sidereal day in a configured LSD range (reference gain.py:116-220).

    Attributes
    ----------
    start_time, end_time : utc_time
        Bounds of the simulated period; one output per whole LSD.
    """

    start_time = config.utc_time()
    end_time = config.utc_time()

    def setup(self, bt, sstream):
        """Telescope (for LSD conversion) and template sidereal stream."""
        self.observer = io.get_telescope(bt)
        self.lsd_start = self.observer.unix_to_lsd(self.start_time)
        self.lsd_end = self.observer.unix_to_lsd(self.end_time)
        self.log.info(f"Simulating gains for LSDs {int(self.lsd_start)}..{int(self.lsd_end)}.")
        self._next_lsd = None
        self.sstream = sstream

    def process(self):
        """Gain stream for the next LSD in the range."""
        if self._next_lsd is None:
            self._next_lsd = int(self.lsd_start + 1)
        if self._next_lsd >= self.lsd_end:
            raise PipelineStopIteration()
        lsd = self._next_lsd
        self._next_lsd += 1

        data = self.sstream
        data.redistribute("freq")
        nra = len(data.ra)
        time = np.linspace(self.observer.lsd_to_unix(lsd), self.observer.lsd_to_unix(lsd + 1), nra, endpoint=False)

        out = containers.SiderealGainData(axes_from=data)
        self._fill_gains(out, time, data.index_map["freq"]["centre"][:])
        out.attrs["lsd"] = lsd
        out.attrs["tag"] = f"lsd_{lsd:d}"
        return out


class RandomGains(BaseGains):
    r"""Gaussian-process amplitude/phase wander per (freq, input) (reference gain.py:223-293).

    Attributes
    ----------
    corr_length_amp, corr_length_phase : float
        GP correlation lengths in seconds.
    sigma_amp, sigma_phase : float
        Fractional amplitude / radian phase fluctuation scales.
    """

    corr_length_amp = config.float_prop(3600.0)
    corr_length_phase = config.float_prop(3600.0)
    sigma_amp = config.float_prop(0.02)
    sigma_phase = config.float_prop(0.1)

    _prev_amp = None
    _prev_phase = None

    def _draw(self, time, scale, sigma, prev):
        nstream = len(self.freq) * self.ninput_local
        fluc = generate_fluctuations(
            time, squared_exponential(scale, sigma), nstream, self._prev_time, prev, rng=self.rng
        )
        return fluc, fluc.reshape((len(self.freq), self.ninput_local, len(time)))

    def _generate_amp(self, time):
        self._prev_amp, shaped = self._draw(time, self.corr_length_amp, self.sigma_amp, self._prev_amp)
        return 1.0 + shaped

    def _generate_phase(self, time):
        self._prev_phase, shaped = self._draw(time, self.corr_length_phase, self.sigma_phase, self._prev_phase)
        return shaped


class RandomSiderealGains(RandomGains, SiderealGains):
    """Random GP gains sampled on a sidereal-day grid (reference gain.py:296)."""


class GainStacker(ContainerTask):
    r"""Accumulate ``g_i g_j^*`` over days onto a visibility template (reference gain.py:305-439).

    ``G_ij = (1/ndays) sum_d g_i^d g_j^{d*}``; optionally applied to the
    template stream at the end.  The products are formed on the gains'
    device.

    Attributes
    ----------
    only_gains : bool
        Emit the stacked gain products themselves rather than the
        template visibilities scaled by them.
    """

    only_gains = config.bool_prop(False)

    gain_stack = None
    lsd_list = None

    def setup(self, stream):
        """Visibility template defining the product layout."""
        self.stream = stream

    @staticmethod
    def _lsds_of(gain):
        tag = gain.attrs.get("lsd", -1)
        return list(tag) if hasattr(tag, "__iter__") else [tag]

    def process(self, gain):
        """Fold one day's gains into the stack."""
        days = self._lsds_of(gain)
        # prodstack resolves the stack axis the vis dataset carries, with
        # conjugation applied for conjugated stack entries
        prod = self.stream.prodstack
        g = gain.gain[:]
        dev = g.device
        ia = torch.as_tensor(prod["input_a"].astype(np.int64), device=dev)
        ib = torch.as_tensor(prod["input_b"].astype(np.int64), device=dev)
        gprod = g[:, ia] * g[:, ib].conj()
        if self.stream.is_stacked:
            conj = torch.as_tensor(self.stream.index_map["stack"]["conjugate"].astype(bool), device=dev)
            gprod = torch.where(conj[None, :, None], gprod.conj(), gprod)

        if gprod.shape[-1] != self.stream.vis.shape[-1]:
            raise ValueError(
                f"Gain time axis ({gprod.shape[-1]} samples) does not match the template stream "
                f"({self.stream.vis.shape[-1]}); regrid the gains onto the stream's grid first."
            )

        if self.gain_stack is None:
            self.log.info(f"New gain stack starting at LSD {days[0]}.")
            self.gain_stack = empty_like(self.stream)
            self.gain_stack.vis[:] = gprod
            self.gain_stack.weight[:] = 1.0
            self.lsd_list = days
            return None

        self.log.info(f"Folding LSD {days[0]} into the gain stack.")
        self.gain_stack.vis[:] = self.gain_stack.vis[:] + gprod
        self.gain_stack.weight[:] = self.gain_stack.weight[:] + 1.0
        self.lsd_list = self.lsd_list + days
        return None

    def process_finish(self):
        """Normalise; emit gains or the gain-scaled template."""
        if self.gain_stack is None:
            self.log.info("No gain streams were received; nothing to emit.")
            return None
        mean_g = self.gain_stack.vis[:] * invert_no_zero(self.gain_stack.weight[:])

        if self.only_gains:
            self.log.info("Emitting the stacked gain products alone.")
            self.gain_stack.vis[:] = mean_g
            return self.gain_stack

        out = empty_like(self.stream)
        out.vis[:] = self.stream.vis[:] * mean_g.to(self.stream.vis[:].device)
        out.weight[:] = self.stream.weight[:]
        out.attrs["tag"] = "gain_stack"
        return out


# ---------------------------------------------------------------------------
# Gaussian-process draws (reference gain.py:442-596), host numpy
# ---------------------------------------------------------------------------


def generate_fluctuations(x, corrfunc, n, prev_x, prev_fluc, rng=None):
    """``n`` correlated streams over samples ``x``; conditioned on the
    previous chunk when one exists (reference gain.py:442-476)."""
    nx = len(x)
    if prev_fluc is None:
        return gaussian_realisation(x, corrfunc, n, rng=rng).reshape(n, nx)
    return constrained_gaussian_realisation(x, corrfunc, n, prev_x, prev_fluc, rng=rng).reshape(n, nx)


def gaussian_realisation(x, corrfunc, n, rcond: float = 1e-12, rng=None):
    """Draws from ``N(0, corrfunc(x))`` via eigen-truncation (reference gain.py:479-519)."""
    return _realisation(corrfunc(np.asarray(x)), n, rcond, rng=rng)


def _nonnull_eigenbasis(C, rcond):
    """(kept eigenvalues, kept eigenvectors) above the rcond floor."""
    evals, evecs = np.linalg.eigh(C)
    keep = int(np.sum(evals > rcond * evals.max()))
    return evals[len(evals) - keep :], evecs[:, len(evals) - keep :]


def _realisation(C, n, rcond, rng=None):
    """Sample rows from N(0, C), dropping near-null eigenmodes."""
    if rng is None:
        rng = np.random.default_rng()
    kept, basis = _nonnull_eigenbasis(C, rcond)
    if kept.size == 0:
        # a zero covariance draws zeros
        return np.zeros((n, C.shape[0]))
    root = basis * kept[np.newaxis] ** 0.5
    return rng.standard_normal((n, kept.size)) @ root.T


def constrained_gaussian_realisation(x, corrfunc, n, x2, y2, rcond: float = 1e-12, rng=None):
    """Draws over ``x`` conditioned on existing samples ``(x2, y2)``.

    Blockwise Gaussian conditioning evaluated in the non-singular
    eigenbases of the two diagonal blocks (reference gain.py:522-596).
    """
    x = np.asarray(x)
    x2 = np.asarray(x2)
    y2 = np.asarray(y2)
    if (y2.ndim >= 2) and (n != y2.shape[0]):
        raise ValueError(
            f"constrained realisation: conditioning data has {y2.shape[0]} streams but {n} were requested."
        )

    M = corrfunc(np.concatenate([x, x2]))
    nl = len(x)
    A = M[:nl, :nl]  # new-new
    B = M[:nl, nl:]  # new-old
    C = M[nl:, nl:]  # old-old

    kept_A, R_A = _nonnull_eigenbasis(A, rcond)
    kept_C, R_C = _nonnull_eigenbasis(C, rcond)

    A_r = np.diag(kept_A)
    B_r = R_A.T @ B @ R_C
    Ci_r = np.diag(1.0 / kept_C)

    # conditional mean and covariance in the reduced basis
    z_r = (y2 @ R_C) @ (Ci_r @ B_r.T)
    Ap_r = A_r - B_r @ Ci_r @ B_r.T
    y_r = _realisation(Ap_r, n, rcond, rng=rng)
    return (z_r + y_r) @ R_A.T
