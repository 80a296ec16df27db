"""Add instrumental noise effects into simulations.

Port of ``draco_tpu.synthesis.noise`` (reference ``draco/synthesis/noise.py``:
ReceiverTemperature:21, GaussianNoiseDataset:48,
MultipleNoiseRealizationsMixin:127, GaussianNoise:178, SampleNoise:287,
FreqCorrelatedNoise:377).

Every task works on the stream's device and in place where the
reference does.  Device draws take ``torch.Generator``s from
:class:`~draco_tpu_torch.core.task.RandomTask`, so they are reproducible
for a seed but are not the JAX package's draws.

``SampleNoise`` draws a complex-Wishart sample around the expectation
matrix of every (freq, time) row.  Rows are taken in chunks sized to a
device-memory budget, gathered from the stream and written back in place;
row ``i``'s generator is seeded from (task seed, draw count, ``i``) and
each row's Cholesky factor and products are computed on their own, so the
sample does not depend on the budget.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask, PipelineStopIteration, RandomTask
from ..ops import random as drandom
from ..ops import tools

# Ratio of an SI second to a sidereal second (caput STELLAR_S equivalent).
STELLAR_S = 86164.0905 / 86400.0


def _auto_mask(prodstack) -> np.ndarray:
    """Boolean mask of the auto-correlation entries of a prodstack."""
    prodstack = np.asarray(prodstack)
    if prodstack.dtype.names:
        return prodstack["input_a"] == prodstack["input_b"]
    return prodstack[:, 0] == prodstack[:, 1]


def _time_interval(data) -> tuple[float, int]:
    if isinstance(data, containers.SiderealStream):
        ra = data.ra
        return 240 * (ra[1] - ra[0]) * STELLAR_S, len(ra)
    t = data.time
    if len(t) < 2:
        # single-sample windows cannot derive the cadence from the axis;
        # the producer declares it
        dt = data.attrs.get("integration_time")
        if dt is None:
            raise ValueError(
                f"cannot infer the integration time from a length-{len(t)} time axis; "
                "set attrs['integration_time'] (seconds) on the container"
            )
        return float(dt), len(t)
    return t[1] - t[0], len(t)


class ReceiverTemperature(ContainerTask):
    """Add a receiver temperature offset to the autos (reference noise.py:21), in place."""

    recv_temp = config.float_prop(0.0)

    def process(self, data):
        autos = torch.as_tensor(np.flatnonzero(_auto_mask(data.prodstack)), device=data.vis[:].device)
        vis = data.vis[:]
        vis[:, autos] += self.recv_temp
        return data


class GaussianNoiseDataset(ContainerTask, RandomTask):
    """Replace a dataset with noise drawn from its weights (reference noise.py:48)."""

    dataset = config.str_prop(None)
    in_place = config.bool_prop(True)

    def process(self, data):
        if self.dataset is None:
            if isinstance(data, containers.DataWeightContainer):
                dataset_name = data._data_dset_name
            else:
                raise ValueError(f"Cannot pick a default dataset on {type(data)}.")
        else:
            dataset_name = self.dataset
        if dataset_name not in data:
            raise config.ConfigError(f"Dataset {dataset_name!r} does not exist in container {type(data)}.")
        data.redistribute("freq")
        out = data if self.in_place else data.copy()

        dset = out[dataset_name][:]
        std = tools.invert_no_zero(data.weight[:].to(torch.float32)) ** 0.5
        gen = self.generator(dset.device)
        if dset.is_complex():
            noise = drandom.complex_normal(dset.shape, generator=gen) * std
        else:
            noise = torch.randn(dset.shape, generator=gen, device=dset.device) * std
        # autos are real with doubled variance (reference noise.py:117-122)
        if dataset_name == "vis":
            autos = torch.as_tensor(np.flatnonzero(_auto_mask(data.prodstack)), device=dset.device)
            noise[:, autos] = (np.sqrt(2) * noise[:, autos].real).to(noise.dtype)
        out[dataset_name][:] = noise
        return out


class MultipleNoiseRealizationsMixin:
    """Generate multiple noise realizations (reference noise.py:127)."""

    niter = config.int_prop(1)
    in_place = False

    def setup(self, data1, data2=None):
        self.data = [data1]
        if data2 is not None:
            self.data.append(data2)

    def process(self):
        if self._count == self.niter:
            raise PipelineStopIteration()
        return super().process(self.data[self._count % len(self.data)])


class MultipleGaussianNoiseDatasets(MultipleNoiseRealizationsMixin, GaussianNoiseDataset):
    """Multiple Gaussian noise datasets (reference noise.py:172)."""


class GaussianNoise(ContainerTask, RandomTask):
    """Add radiometer-equation Gaussian noise (reference noise.py:178), in place.

    Attributes
    ----------
    recv_temp, ndays, set_weights, add_noise
        As in the reference: nsamp = ndays * dt * df * redundancy and
        std = recv_temp / sqrt(nsamp) (reference noise.py:260-261).
    """

    recv_temp = config.float_prop(50.0)
    ndays = config.float_prop(733.0)
    set_weights = config.bool_prop(True)
    add_noise = config.bool_prop(True)

    def setup(self, manager=None):
        self.telescope = io.get_telescope(manager) if manager is not None else None

    def process(self, data):
        data.redistribute("freq")
        dt, ntime = _time_interval(data)
        df = data.index_map["freq"]["width"][0] * 1e6
        vis = data.vis[:]
        nfreq, nprod = vis.shape[:2]
        prodstack = data.prodstack
        ninput = len(data.index_map["input"])

        if (self.telescope is not None) and (nprod == self.telescope.nbase):
            redundancy = self.telescope.redundancy
        elif nprod == ninput * (ninput + 1) // 2:
            redundancy = np.ones(nprod)
        else:
            raise ValueError("Product count does not match a full triangle")

        nsamp = int(self.ndays * dt * df) * redundancy
        std = self.recv_temp / np.sqrt(nsamp)

        if self.add_noise:
            gen = self.generator(vis.device)
            std_t = torch.as_tensor(std, dtype=torch.float32, device=vis.device)
            autos = torch.as_tensor(_auto_mask(prodstack), device=vis.device)
            # product blocks: no temporary of the stream's size
            for p0, p1 in tools.axis_blocks(nprod, nfreq * ntime):
                noise = drandom.complex_normal((nfreq, p1 - p0, ntime), generator=gen) * std_t[None, p0:p1, None]
                # autos: add sqrt(2) * the real part only (reference noise.py:271-277)
                auto = autos[None, p0:p1, None]
                vis[:, p0:p1] += torch.where(auto, np.sqrt(2) * noise.real + 0j, noise)

        if self.set_weights:
            data.weight[:] = torch.as_tensor(1.0 / std**2, device=vis.device)[None, :, None]
        return data


class _Hermitian:
    """Index tensors between an upper-triangle product axis and [nfeed, nfeed]
    matrices on ``device``: ``full`` gathers the matrix, ``lower`` marks
    the entries to conjugate, ``upper`` picks the triangle of a flattened
    matrix back out."""

    def __init__(self, nfeed: int, device):
        ii, jj = np.meshgrid(np.arange(nfeed), np.arange(nfeed), indexing="ij")
        self.nfeed = nfeed
        self.full = torch.as_tensor(tools.cmap(ii, jj, nfeed).ravel(), device=device)
        self.lower = torch.as_tensor(ii > jj, device=device)
        iu, ju = np.triu_indices(nfeed)
        self.upper = torch.as_tensor(iu * nfeed + ju, device=device)

    def unpack(self, row: torch.Tensor) -> torch.Tensor:
        m = row.index_select(0, self.full).reshape(self.nfeed, self.nfeed)
        return torch.where(self.lower, m.conj(), m)


def _sample_noise_rows(vis_rows, ndof, seeds, herm: _Hermitian, generator):
    """Wishart samples of the rows of one chunk: ``vis_rows`` [nprod, B]
    complex upper triangles, ``ndof`` [B], ``seeds`` [B] -> ([nprod, B],
    [B] Cholesky info).

    Row by row: unpack, regularise by 1e-6 of the mean auto, Cholesky
    factor L, Bartlett factor T with ``n`` degrees of freedom from the
    row's own seed, then ``(L T)(L T)^H / n`` repacked (one GEMM fewer than
    ``L (T T^H) L^H``).  Each row's factor and products are computed on
    their own, so a row's sample does not depend on the chunk.
    """
    eye = torch.eye(herm.nfeed, dtype=vis_rows.dtype, device=vis_rows.device)
    out = torch.empty_like(vis_rows)
    infos = []
    for b in range(vis_rows.shape[1]):
        vm = herm.unpack(vis_rows[:, b])
        # the Cholesky needs a strictly positive-definite input; a noiseless
        # expectation matrix is only semi-definite
        vm = vm + 1e-6 * vm.diagonal().real.mean().clamp(min=1e-30) * eye
        L, info = torch.linalg.cholesky_ex(vm)
        infos.append(info)
        del vm
        generator.manual_seed(seeds[b])
        T = drandom.standard_complex_wishart_factor(herm.nfeed, ndof[b], dtype=vis_rows.dtype, generator=generator)
        LT = L @ T
        del L, T
        samp = (LT @ LT.conj().transpose(-1, -2)) / ndof[b]
        del LT
        out[:, b] = samp.reshape(-1).index_select(0, herm.upper)
        del samp
    return out, torch.stack(infos)


class SampleNoise(ContainerTask, RandomTask):
    """Draw complex-Wishart distributed visibility samples, in place.

    (reference noise.py:287-374): the expectation visibilities (full
    triangle) of each (freq, time) row are unpacked into a Hermitian
    matrix, a Wishart sample with nsamp degrees of freedom is drawn around
    it, and the triangle is repacked.  Rows are processed in chunks whose
    Hermitian working set fits ``DRACO_TPU_SAMPLENOISE_CHUNK_GB`` (default
    2): about seven [nfeed, nfeed] complex64 buffers a row, so
    ``budget / (7 * 8 * nfeed^2)`` rows a chunk.  The chunk's rows are
    gathered from the stream and written back; the sample is the same
    under any budget.

    Attributes
    ----------
    sample_frac : float
        Multiplies the number of samples in each measurement.
    set_weights : bool
        Set the weights appropriately afterwards.
    """

    sample_frac = config.float_prop(1.0)
    set_weights = config.bool_prop(True)

    def process(self, data_exp):
        data_exp.redistribute("freq")
        nfeed = len(data_exp.index_map["input"])
        vis = data_exp.vis[:]  # [nfreq, nprod, ntime]
        nfreq, nprod, ntime = vis.shape
        if nprod != nfeed * (nfeed + 1) // 2:
            raise ValueError("SampleNoise requires full-triangle visibilities.")

        dt, _ = _time_interval(data_exp)
        df = data_exp.index_map["freq"]["width"] * 1e6  # [nfreq]
        nsamp = (self.sample_frac * dt * df).astype(int)  # [nfreq]

        budget = float(os.environ.get("DRACO_TPU_SAMPLENOISE_CHUNK_GB", "2")) * 2**30
        chunk = max(1, min(nfreq * ntime, int(budget // (7 * 8 * nfeed * nfeed))))
        # row i = (freq i // ntime, time i % ntime) has its own seed
        seeds = self.row_seeds(nfreq * ntime)
        generator = torch.Generator(device=vis.device)
        herm = _Hermitian(nfeed, vis.device)
        rdt = vis.real.dtype
        infos = []
        for fi in range(nfreq):
            ndof = torch.full((ntime,), float(nsamp[fi]), dtype=rdt, device=vis.device)
            for t0 in range(0, ntime, chunk):
                t1 = min(t0 + chunk, ntime)
                rows, info = _sample_noise_rows(
                    vis[fi, :, t0:t1], ndof[t0:t1], seeds[fi * ntime + t0 : fi * ntime + t1], herm, generator
                )
                vis[fi, :, t0:t1] = rows
                infos.append(info)
                del rows
        # one check of every row's Cholesky at the end: no host sync per row
        if bool(torch.cat(infos).any()):
            raise RuntimeError(
                "SampleNoise: Cholesky of the expectation visibility matrix failed "
                "(non-positive-definite even after regularisation); check for flagged "
                "feeds or a rank-deficient sky model."
            )

        if self.set_weights:
            autos = tools.extract_diagonal(vis, axis=1).real
            nsamp_t = torch.as_tensor(nsamp, dtype=autos.dtype, device=vis.device)
            weight_fac = nsamp_t[:, None, None] ** 0.5 * tools.invert_no_zero(autos)
            w = data_exp.weight[:]
            tools.apply_gain(w, weight_fac, axis=1, out=w)
        return data_exp


class FreqCorrelatedNoise(ContainerTask, RandomTask):
    """Frequency-correlated noise from Cholesky factors (reference noise.py:377-470).

    Unit complex normals are coloured by the stored freq-freq Cholesky
    factors in one batched matmul over (pol, ew, ra).

    Attributes
    ----------
    save_redundancy : bool
        Save the redundancy of each visibility.
    """

    save_redundancy = config.bool_prop(False)

    def process(self, noise_model: containers.FreqNoiseModel):
        noise_model.redistribute("ra")
        out = containers.VisGridStream(axes_from=noise_model, attrs_from=noise_model)

        redundancy = noise_model.redundancy[:].to(torch.float64)  # [pol, ew, ns]
        inv_sqrt_red = tools.invert_no_zero(redundancy.sqrt())
        if self.save_redundancy:
            out.add_dataset("redundancy")
            out.datasets["redundancy"][:] = redundancy[..., None].expand(out.datasets["redundancy"].shape)

        L = noise_model.freq_cov[:].to(torch.complex64)  # [p, e, ra, f, f]
        npol, nfreq, new, nns, nra = out.vis.shape
        z = drandom.complex_normal((npol, new, nra, nfreq, nns), generator=self.generator(L.device))
        sz = (L @ z) * inv_sqrt_red[:, :, None, None, :].to(torch.float32)  # [p, e, ra, f, ns]
        ovis = sz.permute(0, 3, 1, 4, 2).contiguous()  # [p, f, e, ns, ra]

        # Hermitian fix-up of the EW = 0 plane (reference noise.py:456-468)
        nyp = nns // 2 + 1
        pol_names = [p.decode() if isinstance(p, bytes) else str(p) for p in out.index_map["pol"]]
        pconjmap = np.unique([p[1] + p[0] for p in pol_names], return_inverse=True)[1]
        neg = torch.arange(nns - 1, nns - nyp, -1, device=ovis.device)
        for pi, po in enumerate(pconjmap):
            ovis[po, :, 0, neg, :] = ovis[pi, :, 0, 1:nyp, :].conj().clone()
            if pi == po:
                ovis[po, :, 0, 0, :] = ovis[pi, :, 0, 0, :].real * 2**0.5
        out.vis[:] = ovis

        weight = noise_model.weight[:]  # [p, f, e, ra]
        out.weight[:] = weight[:, :, :, None, :] * redundancy[:, None, :, :, None].to(weight.dtype)
        return out


class MultipleFreqCorrelatedNoise(MultipleNoiseRealizationsMixin, FreqCorrelatedNoise):
    """Multiple frequency-correlated noise realizations (reference noise.py:473)."""
