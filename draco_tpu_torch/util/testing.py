"""Test fixtures: a dummy producer task and delay-limited mock data.

Port of ``draco_tpu.util.testing``, the fixture surface of reference
``draco/util/testing.py`` (DummyTask:11, mock_freq_data:47,
RandomFreqData:115).  The draws are host numpy draws from the task's
``rng`` (``np.random.Generator(SFC64(seed))``, as the JAX task seeds it),
so the same seed gives the JAX package's streams exactly; the streams'
datasets are put on the containers' device.
"""

from __future__ import annotations

import numpy as np

from ..core import config
from ..core.containers import ContainerBase, SiderealStream
from ..core.task import ContainerTask, PipelineStopIteration, RandomTask
from ..ops.random import complex_normal_np

__all__ = ["DummyTask", "mock_freq_data", "RandomFreqData"]


class DummyTask(ContainerTask):
    """Emit a fixed number of empty, tagged containers.

    Attributes
    ----------
    total_len : int
        How many containers to emit before stopping.
    tag : str
        Value for the ``tag`` attribute of each output.
    """

    total_len = config.Property(default=1, proptype=int)
    tag = config.str_prop()

    def process(self):
        """Next empty container; stops after ``total_len``."""
        if self.total_len == 0:
            raise PipelineStopIteration

        self.log.debug(f"Emitting dummy container tagged {self.tag!r}.")
        out = ContainerBase()
        if "tag" not in out.attrs:
            out.attrs["tag"] = self.tag
        self.total_len -= 1
        return out


def mock_freq_data(
    freq: np.ndarray,
    ntime: int,
    delaycut: float,
    ndata: int | None = None,
    noise: float = 0.0,
    bad_freq: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
):
    """Spectra whose delay power is flat below ``delaycut`` and zero above.

    A white complex delay-domain signal is band-limited by the cut and
    Fourier-transformed to frequency; ``ndata`` realisations (if
    requested) share that signal and differ only by ``noise``-scaled
    white noise.  Host numpy, drawn from ``rng``.

    Returns
    -------
    data : complex [(ndata,) nfreq, ntime]
    weights : float, same shape, ``1/noise**2`` (1 when noiseless), with
        ``bad_freq`` channels zeroed in both.
    """
    nfreq = len(freq)
    df = np.abs(freq[1] - freq[0])

    inside_cut = np.abs(np.fft.fftfreq(nfreq, df)) < delaycut
    seed = complex_normal_np(size=(ntime, nfreq), rng=rng) * inside_cut
    signal = np.fft.fft(seed, axis=-1).T  # [nfreq, ntime]

    shape = (nfreq, ntime) if ndata is None else (ndata, nfreq, ntime)
    data = noise * complex_normal_np(size=shape, rng=rng) + signal

    weights = np.full(data.shape, 1.0 / noise**2 if noise > 0 else 1.0, dtype=np.float64)
    if bad_freq is not None and len(bad_freq):
        data[..., bad_freq, :] = 0.0
        weights[..., bad_freq, :] = 0.0
    return data, weights


class RandomFreqData(RandomTask):
    """Source task emitting random delay-limited sidereal streams.

    Each cycle produces one stream (or a list of ``num_correlated`` streams
    sharing the same sky signal but independent noise), on the containers'
    default device.

    Attributes
    ----------
    num_realisation : int
        Cycles before stopping.
    num_correlated : int
        Streams per cycle sharing a signal (None = single stream).
    num_ra, num_base, num_freq : int
        Output axis sizes.
    freq_start, freq_end : float
        Band edges in MHz.
    delay_cut : float
        Delay extent of the signal (microseconds).
    noise : float
        White-noise RMS.
    """

    num_realisation = config.int_prop(1)
    num_correlated = config.int_prop(None)

    num_ra = config.int_prop()
    num_base = config.int_prop()

    freq_start = config.float_prop(800.0)
    freq_end = config.float_prop(400.0)
    num_freq = config.int_prop(1024)

    delay_cut = config.float_prop(0.2)
    noise = config.float_prop(1e-5)

    def next(self):
        """Produce the next realisation (or correlated set)."""
        if self.num_realisation == 0:
            raise PipelineStopIteration()
        self.num_realisation -= 1

        freq = np.linspace(self.freq_start, self.freq_end, self.num_freq, endpoint=False)
        ncorr = self.num_correlated or 1

        # one batched draw per baseline: [ncorr, nfreq, ntime] each
        vis = np.empty((ncorr, self.num_freq, self.num_base, self.num_ra), dtype=np.complex64)
        wgt = np.empty((self.num_freq, self.num_base, self.num_ra), dtype=np.float32)
        for bb in range(self.num_base):
            d, w = mock_freq_data(
                freq, self.num_ra, self.delay_cut, ndata=ncorr, noise=self.noise, rng=self.rng
            )
            vis[:, :, bb] = d
            wgt[:, bb] = w[0]

        streams = []
        for cc in range(ncorr):
            s = SiderealStream(input=5, freq=freq, ra=self.num_ra, stack=self.num_base, prod=self.num_base)
            s.vis[:] = vis[cc]
            s.weight[:] = wgt
            streams.append(s)

        return streams[0] if self.num_correlated is None else streams
