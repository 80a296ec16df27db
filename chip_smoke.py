#!/usr/bin/env python3
"""Smoke run of the draco_tpu_torch slices on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (exit code != 0):

1. set-up: needs a CUDA device; prints the card's name and power limit;
   builds the CUDA kernels from ``draco_tpu_torch/csrc``, one nvcc for
   each source, all started together;
2. the banded-covariance kernel against its plain PyTorch version in
   float64 on the card, on the operands that phase 3's regrid hands it
   (R [2098, 8640] from a Lanczos matrix of one jittered sidereal day,
   Ni [2017, 8640], the time stream's weights with their zero-weight gaps,
   bw 9): the float32 kernel within 1e-5 and the
   float64 kernel within 1e-12 (max|diff| / max|ref|), band-end zeros
   exact, two launches bitwise equal; each timed with CUDA events beside
   the plain version in its type.  At R [300, 1000]: an R with permuted
   columns (every sample window full width) and bw 33, within 1e-5;
3. the dish slice at the bench headline's width: a time stream from
   ``--seed`` (every baseline of the 64-dish array x 8640 samples, with
   zero-weight gaps) -> ``regrid_sidereal`` to 2048 RA bins ->
   ``make_marray`` and ``mmode_weights`` (mmax 767) ->
   ``fused_simulate_to_map`` at nside 256 with those weights (chunk 520).
   The kernel launch counts are zeroed just before and read just after;
   the kernel must have launched;
4. accuracy: the same weighted round trip at nside 64 in float32 and
   float64 on the card, within 1e-5 relative error;
5. the kernel on the cylinder path's operands (R [2098, 8640], Ni [1789,
   8640] from phase 6's time stream), as in phase 2;
6. the cylinder slice at CHIME width (4 cylinders x 256 feeds, 1789
   unique baselines, nside 256, lmax = mmax = 767): time stream ->
   regrid -> m-modes and weights -> the weighted full-sphere round trip
   (chunk 256), with the launch counts zeroed just before and read just
   after; one warm round trip under ``torch.profiler`` splits the
   full-sphere loop by stage;
7. the 2048-feed dual-pol cylinder (7155 stacked products, T/Q/U/V sky):
   the unweighted full-sphere round trip at chunk 96 with the geometry
   dedup engaged;
8. accuracy at nside 64: the full-sphere round trip in float32 against
   float64 within 1e-5 relative (a weighted 2 x 16 cylinder and a 2 x 8
   dual-pol cylinder), and the fused map against the composed streaming
   stages within 3e-5 of the map's peak;
9. at nside 32, a small cylinder and a small dish array: ``generate``,
   the batched projection against the streaming one within 2e-5, and the
   SVD projector finite and idempotent within 1e-4;
10. the task chain at the dish slice's width through the pipeline
   ``Manager`` (the scheduler ``python -m draco_tpu_torch run`` drives),
   from a config mapping: ``LoadBeamTransfer`` of a directory that holds
   only the telescope's ``telescope.pkl``, a seeded sky from this script's
   ``EmitSky`` task, then chain A: ``SimulateSidereal`` (streaming, 1535
   RA samples) -> ``MakeSiderealDayStream`` (one LSD) ->
   ``MakeMultipleTimeStreams`` (8640 samples a sidereal day, from 120 s
   before the day to 120 s after it, one file) -> ``SiderealRegridder``
   (2048 bins, Ni [2017, 8665]) -> ``MModeTransform`` -> ``DirtyMapMaker``
   (streaming, nside 256).  The launch counts are zeroed just before the
   run and read just after: the kernel must have launched once per
   regrid.  Every label's container type, shape and finiteness are
   checked; chain A's m-modes are printed against chain B's; the
   Manager's per-task times are printed for a first and a second run;
11. in the same config, chain B (``SimulateSidereal`` -> ``MModeTransform``
   -> ``DirtyMapMaker``, streaming) against ``SimulateAndMap``: unit
   sidereal weights give m-mode weights of nra = 1535, so chain B's map
   must be 1535 times the fused map within 3e-5 of its peak; both are
   printed against the float64 fused map of the same sky;
12. the matrix map makers at nside 32 (the small dish array): the dirty
   map batched against streaming within 2e-5, the maximum-likelihood
   solution re-projected onto the data within 1e-4, the Wiener map finite;
13. the CHIME-scale composite simulation through the pipeline ``Manager``
   on phase 7's 2048-feed dual-pol cylinder (nside 256, one frequency):
   ``GenerateGaussianSky`` (foreground, T/Q/U/V) -> ``SimulateSidereal``
   (streaming, ``fast_ra``: 1536 RA samples) -> ``ExpandProducts`` (the
   full triangle, 2,098,176 products) -> ``ReceiverTemperature`` ->
   ``RandomSiderealGains`` -> ``ApplyGain`` -> ``SampleNoise`` (a
   complex-Wishart sample of every 2048 x 2048 row, ``sample_frac`` 1)
   -> ``CollateProducts`` -> ``MModeTransform`` -> ``DirtyMapMaker``
   (streaming).  The receiver temperature is 10 x the largest |vis| of a
   first simulation of the same sky (the JAX package's test rule), raised
   to the Gershgorin bound of the sky's visibility matrices where that is
   larger, so every expectation matrix is positive definite.  Two
   pass-through probes of this script record 2^20 sampled cross products
   (with their autos and weights) after ``ApplyGain`` and after
   ``SampleNoise``.  Checks: ``ApplyGain`` against g_i g_j* V in float64
   on 10^5 of them within 1e-6; z = (W - V) / sqrt(V_ii V_jj / n) with
   mean |z|^2 within 0.02 of 1 and |mean z| <= 0.01; autos real and
   positive; weights n / (W_ii W_jj); the expand -> collate round trip of
   the noiseless stream within 1e-6; two chunk budgets (2 and 0.25 GiB)
   giving bit-identical samples on a 4-sample cut; the map finite and
   [1, 4, npix]; peak device memory under 64 GiB.  Prints the Manager's
   per-task times;
14. the analysis example config, task for task, through the pipeline
   ``Manager`` on a 191-pair cylinder (2 x 64 feeds, 4 frequencies over
   400-500 MHz, nside 256, lmax = mmax = 767, every m; the dense beam
   transfer matrices generated on the card): this script's ``EmitObserved``
   source (a seeded Gaussian sky drawn from the KL transform's own
   covariance models, foreground amplitude 100 and tilt 3 against signal
   amplitude 1 and tilt 1, through ``SimulateSidereal``, plus
   ``GaussianNoise``, plus interference at known (freq, RA) cells) in
   place of the example's file loader -> ``CollateProducts`` -> ``RFIMask``
   -> ``ApplyTimeFreqMask`` -> ``MModeTransform`` -> ``SVDFilter`` (5 EM
   iterations) -> ``MaximumLikelihoodMapMaker``.  Checks: every injected
   cell masked and under 5% of the clean cells; masked weights exactly 0
   and the others unchanged; the filter's output within 1e-4 of the
   unfiltered peak of the same filter run in complex128; the m-mode power
   over that of the signal and noise alone falling by at least 1e3; the
   map finite, and on 16 sampled m the ML solution re-projected through
   the beam transfer within 1e-4 of a complex128 pseudo-inverse's (of the
   rank the float32 one kept, the two ranks within 2 of each other);
15. the KL path of the foreground-filter baseline config on the same
   product: a product config with a ``kltransform`` stanza (a
   ``KLTransform`` and a ``DoubleKL``) and a ``psfisher`` stanza through
   ``ProductManager.from_config``, then ``SVDModeProject`` (forward) ->
   ``KLModeProject`` (forward, then filter) -> ``QuadraticPSEstimation``.
   Prints the seconds of the beam SVD, the KL solves (with their rate in
   ``eigh`` calls a second), the projections and the Fisher pass, and the
   peak device memory.  Checks: ``fwd @ bwd = I`` and ``V^H (S + N) V =
   diag(lambda + 1)`` within 1e-6 over every m; the eigenvalues of 4
   sampled m within 1e-7 of the largest of ``scipy.linalg.eigh(S, N)`` on
   the host in float64; ``DoubleKL`` in filter mode cutting the
   foreground-only data's power by at least 1e4 and keeping at least 1%
   of the signal-only data's; ``q_estimator_all`` equal to the sum of
   ``q_estimator`` over 8 sampled m within 1e-10 when only those m carry
   data; the Fisher matrix symmetric with a positive diagonal and the band
   powers finite; two m-chunk sizes giving ``q``, Fisher matrix and bias
   within 1e-10;
16. the delay-spectrum path of ``BASELINE.json`` config 3 through the
   pipeline ``Manager`` on phase 7's 2048-feed dual-pol cylinder (7155
   stacked products, built without ``generate``) at 1024 frequencies over
   400-800 MHz and 256 RA samples (the cut): this script's
   ``EmitDelayStream`` (per product a foreground of three delays inside its
   horizon cut at 1e3 x the signal's power, a white signal, noise of the
   variance the weights state; four flagged channels and three flagged RA
   samples on every product, with interference in them) -> ``DelayFilter``
   (``delay_cut`` 0.2 us) -> ``StokesIVis`` -> ``DelayPowerSpectrumGibbsBatched``
   (20 samples, median of the last half, samples and mask saved).  Prints
   the per-task seconds, the Gibbs iterations and Cholesky factorisations a
   second, the batch, the failed and re-sampled chains and the peak device
   memory.  Checks: a foreground-only copy of 256 products losing at least
   1e3 of its power to the filter, the filter's projectors idempotent within
   1e-6 (and the seconds of all its SVDs); Stokes I within 1e-6 of a float64
   numpy segment sum on 10^5 cells; every spectrum finite and no chain
   failed; above every cut the spectrum 0.85-1.10 of the injected power; on
   4 baselines the median over delays of the chain over the host float64
   sampler's within 0.05 of 1; one baseline run alone bit-identical to
   itself inside a batch of 128; on the same data, smaller: ``DelayCrossPowerSpectrumEstimatorBatched``
   on two noise draws of 16 baselines (its autos within 0.2 of the auto
   estimator's), ``DelayPowerSpectrumNRML`` on 4 baselines (``LogLikePS``
   within 1e-8 of host float64 ``scipy``) and ``DelaySpectrumFFT`` on every
   baseline (4 of them within 1e-5 of numpy).

17. the ring-map path on phase 7's 2048-feed dual-pol cylinder (7155
   stacked products of the full 2,098,176-product triangle, built without
   ``generate``) at 16 contiguous channels of CHIME's 390.625 kHz from 600
   MHz and 4096 RA samples (the cut is frequencies), through the pipeline
   ``Manager`` twice each: this script's ``EmitRingStream`` (three point
   sources at known (RA, el), 1e2-1e3 x the noise, seen through the
   analytical EW beam of ``DeconvolveAnalyticalBeam``; noise of the
   variance the weights state; four flagged (freq, RA) cells with
   interference in them) in place of the file loader, then 17a:
   ``examples/ringmap.yaml`` task for task with ``ApplyTimeFreqMask``
   inserted (``RFIMask`` -> ``ApplyTimeFreqMask`` -> ``RingMapMaker``, npix
   512, natural weights, precision 64), and 17b: ``MakeVisGrid`` ->
   ``BeamformNS`` -> this script's ``AttachDelayFilterModel`` (an identity
   spectral filter and a diagonal freq-freq covariance, standing in for
   the delay filter that is not ported yet) -> ``MModeTransform`` ->
   ``WienerRingMapMakerAnalytical`` -> ``RADependentWeights`` ->
   ``AttachDelayFilterModel`` (the covariance that the inverse-variance
   EW weighting does not carry into the ring map) ->
   ``TransformJyPerBeamToKelvin`` -> ``ConstructWienerDelayTransform`` ->
   ``ApplyWienerDelayTransform`` -> ``SpatialTransformDelayMap`` ->
   ``AutoPowerSpectrum3D`` -> ``CylindricalPowerSpectrum2D`` and
   ``SphericalPowerSpectrum3Dto1D``, with one source's spectrum carrying a
   delay tone.  Prints the per-task seconds of both runs, each Manager's
   wall time and peak device memory and each stage's bound.  Checks: one
   frequency and 64 RA samples of 17a's ring map within 1e-5 of a float64
   numpy grid -> NS -> EW beamforming on the host; every injected cell
   masked; the sources peaking at their (RA, el) pixel within one pixel
   (searched within half a grating-lobe spacing); the deconvolved map at
   each source's pixel within 1e-3 of its flux times the dirty beam at
   transit (``_deconvolve_core``'s normalisation), every pol and channel;
   the tone's delay bin above 10 x every other nonzero
   delay bin of its pixel; every output finite, of its container type and
   shape (every factorisation's ``info`` 0, or the task raises).
18. the day-stacking and source-beamforming path on phase 17's cylinder and
   band, through the pipeline ``Manager`` (``retain_products: final``):
   this script's ``EmitDayStream`` (three sidereal days of 8640 samples,
   each in two halves plus the 24-sample boundary files it shares with its
   neighbours; unit complex noise with weights 1, three flagged cells with
   interference a file, and 16 catalogue sources at 100 x the noise seen
   through the telescope's own ``beam_at``) -> ``SiderealGrouper`` ->
   ``SiderealRegridder`` (4096 samples, the banded-covariance kernel at
   blocks of 8 channels x 7155 stacks) -> ``SiderealStacker`` (inverse
   variance, sample variance) and ``SiderealStackerMatch`` ->
   ``BeamFormCat`` (the task's defaults: full polarisation, natural
   weights, a 900 s track, 85 HA samples collapsed) on this script's
   8192-source ``SpectroscopicCatalog`` -> ``SourceStack``; a second
   ``BeamFormCat`` with ``collapse_ha: false`` on 512 sources that
   ``RandomSubset`` draws; the last day through ``SiderealRebinner`` ->
   ``RebinGradientCorrection`` (against its regridded self).  Probes keep
   64 sampled (freq, stack) rows of every day.  Prints the per-task
   seconds, the peak device memory and both kernels' launches (zeroed just
   before the run).  Checks: the launches (3 days x 2 regrid blocks;
   beamform > 0); every kept product finite, of its type and shape; the
   stack's rows within 1e-6 of a float64 West update on the host (the
   sample variance within its float32 rounding bound) and nsample 3 where
   all days have weight; the matched stack within 1e-5 of float64 on the
   host; the rebinned rows within 1e-5 of a float64 host rebin; the 16
   injected sources' formed flux within 5 sigma (from the formed weights)
   plus the regulariser's shrink of the flux; every other source's
   inverse-variance mean over XX, YY and the channels within 5 sigma of 0;
   ``SourceStack`` within 1e-6 of a float64 host segment sum; 64 sampled
   sources' formed beams within 1e-4 of a float64 evaluation of the JAX
   program's formula on the host; the beamform kernel within 1e-5 of its
   plain version on 256 sources, timed beside it at the task's batch of
   32; the banded covariance at the regrid's block against its plain
   version in float64.

The last lines are the kernels' JSON record, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

NSIDE = 256
NSIDE_ACC = 64
NSIDE_SMALL = 32
NFEED_SIDE = 8
CHUNK = 520
CHUNK_CHIME = 256
CHUNK_CHIME_POL = 96
NTIME = 8640
SAMPLES = 2048
KERNEL_WIDTH = 5
EPSILON = 1e-3
TOL_KERNEL = 1e-5
TOL_KERNEL_F64 = 1e-12
TOL_MAP = 1e-5
TOL_COMPOSED = 3e-5
TOL_PROJECTION = 2e-5
TOL_SVD = 1e-4
TOL_CHAIN_FUSED = 3e-5
TOL_ML = 1e-4
# phase 13: the composite chain
CHUNK_COMPOSITE = 96
# the map maker's baseline chunk: its working set adds to the full-triangle
# stream that the Manager still holds
CHUNK_COMPOSITE_MAP = 48
SKY_SEED = 13
N_PROBE = 1 << 20
N_GAIN_CHECK = 100_000
TOL_GAIN = 1e-6
TOL_ROUND_TRIP = 1e-6
# z = (W - V) / sqrt(V_ii V_jj / n) of a Wishart sample has E z = 0 and
# E|z|^2 = 1 (+ O(1/n)); |z|^2 is about exponential, so the mean of
# N = 2^20 of them has standard error 1/sqrt(N) ~ 1e-3, as has mean z.
# Products that share a row are weakly correlated, so the limits sit at
# 20 and 10 standard errors.
TOL_Z2 = 0.02
TOL_ZMEAN = 0.01
PEAK_LIMIT_GIB = 64.0
# phases 14 and 15: the foreground-filter paths on the 191-pair cylinder
ANALYSIS_NFREQ = 4
ANALYSIS_SEED = 14
# the KL transform's covariance models, from which the sky is drawn too:
# the defaults' signal and foreground, thermal noise 100 x below the default
KL_MODEL = {"signal_amp": 1.0, "signal_tilt": 1.0, "foreground_amp": 100.0, "foreground_tilt": 3.0,
            "noise_amp": 1e-4}
KL_THRESHOLD = 0.1
DKL_FOREGROUND_THRESHOLD = 0.1
DKL_THRESHOLD = 1.0
RFI_CELLS = ((1, 200), (2, 777), (2, 778), (3, 1200))  # (freq, RA sample) of the injected interference
RFI_CLEAN_SHARE = 0.05
TOL_SVD_FILTER = 1e-4
FOREGROUND_EXCESS_FALL = 1e3
N_ML_CHECK = 16
# the model's noise is 100 x below the default's, its pencil that much worse conditioned
TOL_KL = 1e-6
TOL_KL_EVALS = 1e-7
DKL_FOREGROUND_CUT = 1e4
DKL_SIGNAL_KEPT = 0.01
TOL_PS = 1e-10
# phase 16: the delay-spectrum path (BASELINE.json config 3) on phase 7's 2048-feed dual-pol cylinder
DELAY_NFREQ = 1024  # 400-800 MHz: CHIME's 390.625 kHz channels
DELAY_NRA = 256  # the cut: CHIME's 4096-sample sidereal grid would be 240 GB of visibilities
DELAY_CUT = 0.2  # DelayFilter's delay_cut, us (its default is 0.1)
DELAY_SEED = 16
DELAY_SIGNAL_VAR = 1e4  # E|s|^2 of each product's white signal
DELAY_NOISE_VAR = 1.0  # E|n|^2 of each product's noise; the weights are its inverse
DELAY_FG_POWER = 1e3  # each product's foreground power over its signal's
DELAY_FG_MODES = 3  # delay components of a product's foreground, each inside 0.8 of its cut
DELAY_FLAG_CHANNELS = (100, 101, 513, 900)
DELAY_FLAG_RA = (40, 41, 200)
DELAY_RFI = 1e5  # added to every flagged cell
DELAY_NSAMP = 20
N_DELAY_FG_CHECK = 256  # products filtered a second time as a foreground-only copy
TOL_FILTER_FALL = 1e3
TOL_IDEMPOTENT = 1e-6
N_STOKES_CHECK = 100_000
TOL_STOKES = 1e-6
# The auto estimator tapers the data and its design but states the noise
# untapered (reference semantics), so at a finite signal-to-noise it reads
# low by a few percent (0.85-0.87 of the injected power in the 65-channel
# test of tests/test_torch_pipeline.py at SNR 100 a product; this stream's
# is 1e4); the median over >1e5 (baseline, delay) cells of draws from 252
# samples carries no sampling error at this level.  Above every cut the
# spectrum must read 0.85-1.10 of the injected Stokes I power per delay.
DELAY_RECOVERY = (0.85, 1.10)
N_DELAY_HOST = 4
# Two chains of one posterior: each delay's value is the median of 10 draws
# from 252 samples (relative scatter sqrt(2 / 252) = 0.089 a draw, ~0.05
# for the median of 10 correlated draws, 0.07 for the ratio of two); the
# median over 2048 delays, correlated over ~8 by the window, has a standard
# error of 1.25 x 0.07 / sqrt(256) = 0.0055.  The limit is 9 of those.
TOL_DELAY_HOST = 0.05
N_DELAY_CROSS = 16
# The cross estimator's autos sample the same Stokes I data but taper
# channel f by the window at f / N (half the window) where the auto one
# tapers at f / (N / 2 + 1); each reads low by its own window's few percent.
# Over the delays above the cut (~1500 a baseline) the median of the ratio
# has a sampling error under 1%: the limit is 0.2.
TOL_DELAY_CROSS = 0.2
N_DELAY_NRML = 4
TOL_LOGLIKE = 1e-8
TOL_DELAY_FFT = 1e-5
# the task chain: the simulated sidereal day and its time stream
RING_NFREQ = 16  # the cut: CHIME's 1024 channels would be 64 x this
RING_DF = 0.390625  # MHz, CHIME's channel width
RING_F0 = 600.0
RING_NRA = 4096  # CHIME's sidereal grid
RING_NPIX = 512
RING_SEED = 17
# (RA sample, el pixel, flux in noise units) of the injected point sources
RING_SOURCES = ((700, 345, 300.0), (2100, 230, 1000.0), (3300, 262, 100.0))
RING_TONE = (1, 3, 0.5)  # (source, delay bin, relative amplitude) of 17b's spectral tone
RING_FLAGS = ((2, 1400), (5, 1401), (9, 2700), (13, 3900))  # flagged (freq, RA sample) cells
RING_RFI = 1e5  # added to every flagged cell
N_RING_HOST = 64  # RA samples of the float64 host beamforming check
TOL_RING_HOST = 1e-5
TOL_RING_AMP = 1e-3  # the other sources' NS and RA sidelobes: 1.1e-4 here, 1.3e-2 with 4 feeds a cylinder
RING_TONE_CONTRAST = 10.0
# phase 18: the day-stacking and source-beamforming path on phase 17's cylinder and band
STACK_NFREQ = RING_NFREQ
STACK_NTIME = 8640  # samples a sidereal day (CHIME's ~10 s cadence)
STACK_PAD = 12  # samples beyond each end of a day: the boundary files shared by two days
STACK_DAYS = 3
STACK_SAMPLES = 4096  # CHIME's sidereal grid
STACK_NSRC = 8192
STACK_NINJ = 16
STACK_NSUB = 512  # sources of the HA-resolved BeamFormCat
STACK_FLUX = 100.0  # injected flux over the noise's per-sample standard deviation
STACK_INJECT_HA = 20.0  # deg: the sources are added within this of transit (the beam there is < 1e-12)
STACK_RFI = 1e5
STACK_FREQSIDE = 7
STACK_SEED = 18
STACK_NU21 = 1420.405751768
STACK_C = 299792458.0
N_STACK_CHECK = 64  # sampled (freq, stack) rows of the host checks
N_BEAM_CHECK = 64  # sources of the host beamforming check
N_KERNEL_CHECK = 256  # sources of the beamform kernel's check
TOL_STACK = 1e-6
TOL_MATCH = 1e-5
TOL_REBIN = 1e-5
TOL_BEAMFORM_HOST = 1e-4
TOL_BEAMFORM_KERNEL = 1e-5
TOL_SOURCESTACK = 1e-6
STACK_PROBES: dict = {}  # what phase 18's probes keep for the host checks

LSD = 8000
CHAIN_SAMPLES_PER_DAY = 8640
CHAIN_PAD_S = 120.0
# CHIME-class cylinders: the JAX bench's ``run_cylinder`` geometry
CHIME = dict(cylinder_width=20.0, cylinder_spacing=22.0, feed_spacing=0.5, latitude=49.0)
# one H100 SXM (NVIDIA's data sheet): HBM rate, and the peak rates outside
# the tensor cores, which the float32 and float64 sums run on
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def log(*args):
    print(*args, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def telescope(nside: int):
    """The bench headline array: 8 x 8 jittered dishes, one frequency, autos."""
    from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedDishArray

    f0 = 299.792458 / 0.6  # MHz
    tel = UnpolarisedDishArray(
        grid_ew=NFEED_SIDE, grid_ns=NFEED_SIDE, spacing_ew=7.0, spacing_ns=7.0,
        jitter=1.0, jitter_seed=1, latitude=45.0, dish_width=5.0, fwhm_factor=1.0,
        freq_lower=f0, freq_upper=f0, num_freq=1, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
    )
    return tel, BeamTransfer(tel, nside=nside)


def cylinder(nside: int, ncyl: int, nfeed: int, pol: bool = False, nfreq: int = 1):
    """A CHIME-class cylinder array at lambda = 0.6 m (``nfreq`` 1), or over
    400-500 MHz; ``pol`` gives X and Y feeds at every position."""
    from draco_tpu_torch.telescope import BeamTransfer, PolarisedCylinderTelescope, UnpolarisedCylinderTelescope

    f0 = 299.792458 / 0.6
    band = dict(freq_lower=f0, freq_upper=f0) if nfreq == 1 else dict(freq_lower=400.0, freq_upper=500.0)
    cls = PolarisedCylinderTelescope if pol else UnpolarisedCylinderTelescope
    tel = cls(
        num_cylinders=ncyl, num_feeds=nfeed, num_freq=nfreq, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1, **band, **CHIME,
    )
    return tel, BeamTransfer(tel, nside=nside)


def small_dishes(nside: int):
    from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedDishArray

    tel = UnpolarisedDishArray(
        grid_ew=2, grid_ns=2, spacing_ew=4.0, spacing_ns=4.0, latitude=30.0, freq_lower=400.0,
        freq_upper=500.0, num_freq=2, dish_width=8.0, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
    )
    return tel, BeamTransfer(tel, nside=nside)


def time_stream(nfreq: int, nbase: int, ntime: int, seed: int):
    """Seeded irregular samples of one sidereal day with zero-weight gaps.

    Returns (times [ntime] in days, vis [nfreq, nbase, ntime] complex64,
    weight [nfreq, nbase, ntime] float32).
    """
    rng = np.random.Generator(np.random.SFC64(seed))
    times = (np.arange(ntime) + rng.uniform(-0.3, 0.3, ntime)) / ntime
    times[0] = 0.0
    shape = (nfreq, nbase, ntime)
    vis = np.empty(shape, np.complex64)
    vis.real = rng.standard_normal(shape, dtype=np.float32)
    vis.imag = rng.standard_normal(shape, dtype=np.float32)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    weight[..., ntime // 4 : ntime // 4 + 40] = 0.0
    weight[:, ::7, ::97] = 0.0
    return times, vis, weight


def regrid_operands(times: np.ndarray, weight: np.ndarray, samples: int):
    """R and Ni exactly as the slice's ``regrid_sidereal`` hands them to the
    kernel: R [samples + 2 pad, ntime], Ni [nfreq * nbase, ntime]."""
    from draco_tpu_torch.ops import regrid

    pad = 5 * KERNEL_WIDTH
    end = float(times[-1])
    grid = end * np.arange(-pad, samples + pad, dtype=np.float64) / samples
    R = np.ascontiguousarray(regrid.lanczos_forward_matrix(grid, times, KERNEL_WIDTH).T, np.float32)
    Ni = np.ascontiguousarray(weight.reshape(-1, times.size), np.float32)
    return R, Ni


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _rel_err(out, ref) -> tuple[float, float]:
    err = (out.double() - ref).abs().max().item()
    return err, err / ref.abs().max().item()


def _rel(got, ref) -> float:
    """max|diff| / max|ref| of real or complex tensors, in float64."""
    import torch

    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    got, ref = got.double(), ref.double()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _band_end_zeros(out, bw: int) -> bool:
    m = out.shape[-1]
    return all(bool((out[:, d, max(m - d, 0) :] == 0).all()) for d in range(bw + 1))


def covariance_bound(R, Ni, bw: int) -> tuple[float, str]:
    """Least time (ms) the card could take for ``banded_covariance`` on these
    operands, and what sets it: each input read once and the output written
    once at the HBM rate, against 2 flops a batch row for every (row, diagonal,
    sample) whose two R entries are both nonzero, at the peak rate outside
    the tensor cores for the operands' type."""
    import torch

    m = R.shape[0]
    nbytes = (R.numel() + Ni.numel() + Ni.shape[0] * (bw + 1) * m) * R.element_size()
    nz = R != 0
    pairs = sum(int((nz[d:] & nz[: m - d]).sum()) for d in range(min(bw, m - 1) + 1))
    flops = 2.0 * Ni.shape[0] * pairs
    peak = PEAK_FLOPS["float64" if R.dtype == torch.float64 else "float32"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(device, label: str, times, weight):
    """The kernel against its plain version on one path's regrid operands,
    then timed beside it (plain, kernel, kernel, plain) in each type."""
    import torch

    from draco_tpu_torch.ops import banded, cuda_kernels

    bw = 2 * KERNEL_WIDTH - 1
    R_h, Ni_h = regrid_operands(times, weight, SAMPLES)
    R = torch.from_numpy(R_h).to(device)
    Ni = torch.from_numpy(Ni_h).to(device)
    R64, Ni64 = R.double(), Ni.double()
    out = cuda_kernels.banded_covariance_batched(R, Ni, bw)
    again = cuda_kernels.banded_covariance_batched(R, Ni, bw)
    out64 = cuda_kernels.banded_covariance_batched(R64, Ni64, bw)
    torch.cuda.synchronize()
    ref = banded.banded_covariance(R64, Ni64, bw)
    err, rel = _rel_err(out, ref)
    err64, rel64 = _rel_err(out64, ref)
    tail_zero = _band_end_zeros(out, bw) and _band_end_zeros(out64, bw)
    bitwise = torch.equal(out, again)
    log(f"kernel banded_covariance [{label}] R{tuple(R.shape)} Ni{tuple(Ni.shape)} bw={bw}: "
        f"float32 max_abs_err={err:.3e} rel={rel:.3e} (tol {TOL_KERNEL}), "
        f"float64 max_abs_err={err64:.3e} rel={rel64:.3e} (tol {TOL_KERNEL_F64}), "
        f"band_end_zeros_exact={tail_zero} two_launches_bitwise_equal={bitwise}")
    if not (rel <= TOL_KERNEL and torch.isfinite(out).all()):
        raise RuntimeError(f"float32 banded_covariance kernel disagrees with its plain version: rel {rel:.3e}")
    if not (rel64 <= TOL_KERNEL_F64 and torch.isfinite(out64).all()):
        raise RuntimeError(f"float64 banded_covariance kernel disagrees with its plain version: rel {rel64:.3e}")
    if not (tail_zero and bitwise):
        raise RuntimeError("banded_covariance kernel: band-end zeros not exact or launches not bitwise equal")
    del ref, out, again, out64
    stats = {"max_abs_err": err, "max_abs_err_f64": err64, "library_ms": None}
    for suffix, (r, ni) in (("", (R, Ni)), ("_f64", (R64, Ni64))):
        plain1 = cuda_ms(lambda: banded.banded_covariance(r, ni, bw), 3)
        kern1 = cuda_ms(lambda: cuda_kernels.banded_covariance_batched(r, ni, bw), 10)
        kern2 = cuda_ms(lambda: cuda_kernels.banded_covariance_batched(r, ni, bw), 10)
        plain2 = cuda_ms(lambda: banded.banded_covariance(r, ni, bw), 3)
        bound, bound_by = covariance_bound(r, ni, bw)
        log(f"kernel banded_covariance [{label}] {r.dtype} ms: kernel {kern1:.4f} {kern2:.4f}, "
            f"plain {plain1:.4f} {plain2:.4f}, bound {bound:.4f} ({bound_by})")
        stats.update({
            "ms" + suffix: min(kern1, kern2), "plain_ms" + suffix: min(plain1, plain2),
            "bound_ms" + suffix: bound, "bound_by" + suffix: bound_by,
        })
    return stats


def check_small_cases(device, seed: int, m: int = 300, n: int = 1000, batch: int = 64):
    """Phase 2, small shapes: an R whose columns are permuted, and bw 33."""
    import torch

    from draco_tpu_torch.ops import banded, cuda_kernels, regrid

    rng = np.random.Generator(np.random.SFC64(seed))
    samples = np.sort(rng.uniform(0.0, 1.0, n))
    R_h = regrid.lanczos_forward_matrix(np.linspace(0.0, 1.0, m), samples, KERNEL_WIDTH).T
    Ni = torch.from_numpy(rng.uniform(0.5, 2.0, (batch, n)).astype(np.float32)).to(device)
    permuted = torch.from_numpy(np.ascontiguousarray(R_h[:, rng.permutation(n)], np.float32)).to(device)
    # the nonzeros of every tile of rows span the samples: full-width windows
    win = cuda_kernels.tile_windows(permuted, cuda_kernels.tile_rows())
    full = bool(((win[:, 1] - win[:, 0] >= 0.9 * n) | (win[:, 1] <= win[:, 0])).all())
    banded_R = torch.from_numpy(np.ascontiguousarray(R_h, np.float32)).to(device)
    for name, R, bw in (("permuted columns", permuted, 2 * KERNEL_WIDTH - 1), ("bw 33", banded_R, 33)):
        out = cuda_kernels.banded_covariance_batched(R, Ni, bw)
        ref = banded.banded_covariance(R.double(), Ni.double(), bw)
        err, rel = _rel_err(out, ref)
        tail_zero = _band_end_zeros(out, bw)
        log(f"kernel banded_covariance {name} R{tuple(R.shape)} Ni{tuple(Ni.shape)} bw={bw}: "
            f"max_abs_err={err:.3e} rel={rel:.3e} band_end_zeros_exact={tail_zero}"
            + (f" full_width_windows={full}" if name == "permuted columns" else ""))
        if not (rel <= TOL_KERNEL and tail_zero and torch.isfinite(out).all()):
            raise RuntimeError(f"banded_covariance kernel, {name}: rel {rel:.3e} or band-end zeros not exact")
    if not full:
        raise RuntimeError("the permuted R did not give full-width windows")


def run_slice(bt, tel, sky, times, vis, weight, device, samples, chunk):
    """Time-ordered data -> regrid -> m-modes and weights -> weighted round trip."""
    import torch

    from draco_tpu_torch.analysis.transform import mmode_weights, regrid_sidereal
    from draco_tpu_torch.ops import mmode
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    stages = {}
    t0 = _sync_clock(device)
    vis_d = torch.from_numpy(vis).to(device)
    weight_d = torch.from_numpy(weight).to(device)
    sky_d = torch.from_numpy(sky).to(device)
    t1 = _sync_clock(device)
    stages["upload_s"] = t1 - t0
    _, v, ni = regrid_sidereal(
        vis_d, weight_d, times, samples, 0.0, float(times[-1]), KERNEL_WIDTH, EPSILON
    )
    t2 = _sync_clock(device)
    stages["regrid_s"] = t2 - t1
    mvis = mmode.make_marray(v, mmax=tel.mmax)
    w = mmode_weights(ni, tel.mmax)
    t3 = _sync_clock(device)
    stages["mmodes_s"] = t3 - t2
    maps = fused_simulate_to_map(bt, sky_d, chunk=chunk, weight=w)
    t4 = _sync_clock(device)
    stages["roundtrip_s"] = t4 - t3
    return stages, mvis, w, maps


def _sync_clock(device) -> float:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def drive_slice(name, bt, tel, sky, stream, device, chunk, npol=1):
    """One path end to end with the launch counts zeroed just before and read
    just after, its outputs checked, then twice warm; returns the launches,
    the m-mode weights and the first run's stage times."""
    import torch

    from draco_tpu_torch.ops import cuda_kernels, healpix

    times, vis, weight = stream
    nbase = len(tel.uniquepairs)
    torch.cuda.reset_peak_memory_stats(device)
    cuda_kernels.reset_launches()
    stages, mvis, w, maps = run_slice(bt, tel, sky, times, vis, weight, device, SAMPLES, chunk)
    launches = dict(cuda_kernels.launches)
    log(f"{name} stages, first run (s): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    log(f"{name} kernel launches: {launches}")
    if launches["banded_covariance"] < 1:
        raise RuntimeError(f"the {name} did not launch the banded_covariance kernel")
    for what, x, shape in (
        ("m-modes", mvis, (tel.mmax + 1, 2, tel.nfreq, nbase)),
        ("m-mode weights", w, (tel.mmax + 1, 2, tel.nfreq, nbase)),
        ("map", maps, (tel.nfreq, npol, healpix.npix_of(NSIDE))),
    ):
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{name} {what}: shape {tuple(x.shape)} (want {shape}) or non-finite values")
    if not bool((w > 0).any()):
        raise RuntimeError(f"{name} m-mode weights are all zero")
    # the same path again, warm: lazy kernel-module loading and the
    # round trip's table build fall in the first run only
    warm = [run_slice(bt, tel, sky, times, vis, weight, device, SAMPLES, chunk)[0] for _ in range(2)]
    log(f"{name} stages warm (s): " + json.dumps({k: round(min(run[k] for run in warm), 4) for k in stages}))
    log(f"{name} peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    return launches, w, stages


def profile_split(run, label_prefix: str) -> None:
    """One call of ``run`` under ``torch.profiler``.

    Prints, for each ``record_function`` label of ``label_prefix``, the
    device time of the kernels launched inside its host ranges and the
    summed device-side spans of those ranges; then the device time of all
    kernels against the call's wall time (clock read inside the profiled
    block, after a synchronise), whose ratio is the device's busy share.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_ms(ev, name):
        for attr in (name, name.replace("device", "cuda")):
            if hasattr(ev, attr):
                return getattr(ev, attr) / 1e3
        return 0.0

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched, spans, kernels_ms = {}, {}, 0.0
    for ev in prof.key_averages():
        if ev.key.startswith(label_prefix):
            if ev.device_type == DeviceType.CPU:
                launched[ev.key] = round(dev_ms(ev, "device_time_total"), 3)
            else:
                spans[ev.key] = round(dev_ms(ev, "device_time_total"), 3)
        elif ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
            kernels_ms += dev_ms(ev, "self_device_time_total")
    log(f"profile {label_prefix}* (torch.profiler, one warm call) device ms of the kernels launched "
        f"in each stage: {json.dumps(launched)}; device-side spans: {json.dumps(spans)}")
    log(f"profile: all kernels {kernels_ms:.3f} ms of device time in {wall_ms:.3f} ms wall "
        f"(busy share {kernels_ms / wall_ms:.3f})")


def run_dualpol(device):
    """Phase 7: the 2048-feed dual-pol cylinder, unweighted, chunk 96."""
    import torch

    from draco_tpu_torch.ops import healpix
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    tel, bt = cylinder(NSIDE, 4, 256, pol=True)
    nprod = len(tel.uniquepairs)
    log(f"dual-pol cylinder: nside={NSIDE} 4 x 256 dual-pol feeds ({tel.nfeed} feeds), "
        f"products={nprod} npol_sky={tel.num_pol_sky} chunk={CHUNK_CHIME_POL}")
    rng = np.random.Generator(np.random.SFC64(3))
    sky = torch.from_numpy(
        rng.standard_normal((1, tel.num_pol_sky, healpix.npix_of(NSIDE))).astype(np.float32)
    ).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = _sync_clock(device)
    maps = fused_simulate_to_map(bt, sky, chunk=CHUNK_CHIME_POL)
    first = _sync_clock(device) - t0
    state = next(iter(bt._fused_fns.values())).state
    Gc = state["dims"][-1]
    log(f"dual-pol state: form={state['form']} Gc={Gc} chunks={state['dims'][3]}")
    if state["form"] != "fullsphere" or Gc <= 0:
        raise RuntimeError(f"dual-pol cylinder: form {state['form']}, geometry dedup Gc={Gc} not engaged")
    if tuple(maps.shape) != (1, 4, healpix.npix_of(NSIDE)) or not bool(torch.isfinite(maps).all()):
        raise RuntimeError(f"dual-pol map: shape {tuple(maps.shape)} or non-finite values")
    warm = []
    for _ in range(2):
        t0 = _sync_clock(device)
        fused_simulate_to_map(bt, sky, chunk=CHUNK_CHIME_POL)
        warm.append(_sync_clock(device) - t0)
    log(f"dual-pol round trip: first call {first:.4f} s, warm {min(warm):.4f} s (best of {warm[0]:.4f}, "
        f"{warm[1]:.4f}); peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")


def check_fullsphere_accuracy(device) -> None:
    """Phase 8: float32 against float64, and fused against composed stages."""
    import torch

    from draco_tpu_torch.ops import healpix, mmode, sht
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    rng = np.random.Generator(np.random.SFC64(8))
    npix = healpix.npix_of(NSIDE_ACC)
    for name, ncyl, nfeed, pol in (("2 x 16 cylinder", 2, 16, False), ("2 x 8 dual-pol cylinder", 2, 8, True)):
        tel, bt = cylinder(NSIDE_ACC, ncyl, nfeed, pol=pol)
        shape = (tel.mmax + 1, 2, tel.nfreq, len(tel.uniquepairs))
        w = torch.from_numpy(rng.uniform(0.5, 2.0, shape)).to(device)
        sky = torch.from_numpy(rng.standard_normal((tel.nfreq, tel.num_pol_sky, npix))).to(device)
        m32 = fused_simulate_to_map(bt, sky.float(), chunk=64, weight=w.float())
        m64 = fused_simulate_to_map(bt, sky, chunk=64, weight=w)
        rel = _rel(m32, m64)
        log(f"accuracy nside={NSIDE_ACC} {name} ({shape[-1]} products): float32 vs float64 weighted "
            f"full-sphere round trip rel err {rel:.3e} (tol {TOL_MAP})")
        if not rel <= TOL_MAP:
            raise RuntimeError(f"{name}: full-sphere accuracy {rel:.3e} exceeds {TOL_MAP}")
        if not pol:
            # the same spine as separate streaming stages, through the
            # sidereal stream and back
            alm = sht.sphtrans_sky(sky.float(), lmax=tel.lmax)[..., : tel.mmax + 1]
            vis = bt.project_sky_to_telescope_streaming(alm)
            stream = mmode.mmodes_to_sidereal(vis, n=2 * tel.mmax + 1, oddra=True)
            dirty = bt.project_telescope_to_sky_dirty_streaming(mmode.make_marray(stream, mmax=tel.mmax), w.float())
            composed = sht.sphtrans_inv_sky(dirty, NSIDE_ACC)
            rel = _rel(m32, composed)
            log(f"accuracy nside={NSIDE_ACC} {name}: fused vs composed streaming stages "
                f"max|diff| / max|map| {rel:.3e} (tol {TOL_COMPOSED})")
            if not rel <= TOL_COMPOSED:
                raise RuntimeError(f"{name}: fused map is {rel:.3e} from the composed stages (tol {TOL_COMPOSED})")


def check_beamtransfer(device) -> None:
    """Phase 9: generate, batched against streaming projection, SVD projector."""
    import torch

    from draco_tpu_torch.ops import healpix, sht

    rng = np.random.Generator(np.random.SFC64(9))
    for name, (tel, bt) in (
        ("2 x 4 cylinder", cylinder(NSIDE_SMALL, 2, 4, nfreq=2)),
        ("2 x 2 dishes", small_dishes(NSIDE_SMALL)),
    ):
        t0 = _sync_clock(device)
        bt.generate()
        gen_s = _sync_clock(device) - t0
        if bt._bp.device != device or not bool(torch.isfinite(torch.view_as_real(bt._bp)).all()):
            raise RuntimeError(f"{name}: generate gave {bt._bp.device} or non-finite beam transfer matrices")
        sky = rng.standard_normal((tel.nfreq, 1, healpix.npix_of(NSIDE_SMALL))).astype(np.float32)
        alm = sht.sphtrans_sky(sky, lmax=tel.lmax)[..., : tel.mmax + 1]
        rel = _rel(bt.project_sky_to_telescope(alm), bt.project_sky_to_telescope_streaming(alm))
        shape = (tel.mmax + 1, 2, tel.nfreq, len(tel.uniquepairs))
        v = torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).to(device)
        proj = bt.project_svd_to_telescope(bt.project_telescope_to_svd(v))  # [M+1, f, (msign, b)]
        proj_vis = proj.reshape(shape[0], shape[2], 2, shape[3]).movedim(2, 1)  # [M+1, msign, f, b]
        idem = _rel(bt.project_svd_to_telescope(bt.project_telescope_to_svd(proj_vis)), proj)
        finite = bool(torch.isfinite(torch.view_as_real(proj)).all())
        log(f"beam transfer nside={NSIDE_SMALL} {name} ({'windowed' if bt._beam_window() else 'full-sphere'}): "
            f"generate {gen_s:.3f} s, batched vs streaming projection rel {rel:.3e} (tol {TOL_PROJECTION}), "
            f"SVD projector idempotence rel {idem:.3e} (tol {TOL_SVD}), finite={finite}, "
            f"modes kept {bt.ndofmax} of {bt.svd_len()}")
        if not (rel <= TOL_PROJECTION and idem <= TOL_SVD and finite):
            raise RuntimeError(f"{name}: beam-transfer projections or SVD projector out of tolerance")


def sky_task() -> str:
    """Define the pipeline phases' source task, ``EmitSky`` (one seeded sky
    Map on the process default device), in this module; return its path."""
    from draco_tpu_torch.core import config, containers
    from draco_tpu_torch.core.task import ContainerTask, PipelineStopIteration

    class EmitSky(ContainerTask):
        seed = config.int_prop(0)
        nside = config.int_prop(NSIDE)
        freq = config.list_prop([])

        def process(self):
            if self._count:
                raise PipelineStopIteration()
            m = containers.Map(nside=self.nside, polarisation=False, freq=np.array(self.freq))
            rng = np.random.Generator(np.random.SFC64(self.seed))
            m.map[:] = rng.standard_normal(m.map.shape)
            m.attrs["tag"] = "sky"
            return m

    globals()["EmitSky"] = EmitSky
    return f"{__name__}.EmitSky"


def chain_config(product_dir: str, tel, source: str) -> dict:
    """Phases 10 and 11 as one pipeline config mapping."""
    day_s = float(tel.lsd_to_unix(LSD + 1) - tel.lsd_to_unix(LSD))
    streaming = {"streaming": True, "baseline_chunk": CHUNK}
    to_map = {"nside": NSIDE, **streaming}
    return {"pipeline": {"tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"],
         "params": {"product_directory": product_dir, "nside": NSIDE}},
        {"type": source, "out": "sky", "params": {"seed": 10, "nside": NSIDE, "freq": [float(f) for f in tel.frequencies]}},
        {"type": "draco.synthesis.stream.SimulateSidereal", "requires": "bt", "in": "sky", "out": "sstream",
         "params": streaming},
        {"type": "draco.synthesis.stream.MakeSiderealDayStream", "requires": ["bt", "sstream"], "out": "sday",
         "params": {"start_time": float(tel.lsd_to_unix(LSD - 0.5)), "end_time": float(tel.lsd_to_unix(LSD + 0.5))}},
        {"type": "draco.synthesis.stream.MakeMultipleTimeStreams", "requires": ["tel", "sday"], "out": "tstream",
         "params": {"start_time": float(tel.lsd_to_unix(LSD)) - CHAIN_PAD_S,
                    "end_time": float(tel.lsd_to_unix(LSD + 1)) + CHAIN_PAD_S,
                    "integration_time": day_s / CHAIN_SAMPLES_PER_DAY, "samples_per_file": 2 * CHAIN_SAMPLES_PER_DAY}},
        {"type": "draco.analysis.sidereal.SiderealRegridder", "requires": "tel", "in": "tstream", "out": "sregrid",
         "params": {"samples": SAMPLES, "kernel_width": KERNEL_WIDTH, "epsilon": EPSILON}},
        {"type": "draco.analysis.transform.MModeTransform", "requires": "tel", "in": "sregrid", "out": "mmodes_a"},
        {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "bt", "in": "mmodes_a", "out": "map_a",
         "params": to_map},
        {"type": "draco.analysis.transform.MModeTransform", "requires": "tel", "in": "sstream", "out": "mmodes_b"},
        {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "bt", "in": "mmodes_b", "out": "map_b",
         "params": to_map},
        {"type": "draco_tpu.telescope.roundtrip.SimulateAndMap", "requires": "bt", "in": "sky", "out": "map_fused",
         "params": {"baseline_chunk": CHUNK}},
    ]}}


def check_chain_products(products, tel, device) -> None:
    """Container type, shape and finiteness at every label of phases 10-11."""
    import torch

    from draco_tpu_torch.core import containers
    from draco_tpu_torch.ops import healpix

    nb, M1, npix = len(tel.uniquepairs), tel.mmax + 1, healpix.npix_of(NSIDE)
    ntime = products["tstream"][0].vis.shape[-1]
    want = {
        "sky": (containers.Map, {"map": (1, 1, npix)}),
        "sstream": (containers.SiderealStream, {"vis": (1, nb, 2 * tel.mmax + 1)}),
        "sday": (containers.SiderealStream, {"vis": (1, nb, 2 * tel.mmax + 1)}),
        "tstream": (containers.TimeStream, {"vis": (1, nb, ntime), "vis_weight": (1, nb, ntime)}),
        "sregrid": (containers.SiderealStream, {"vis": (1, nb, SAMPLES), "vis_weight": (1, nb, SAMPLES)}),
        "mmodes_a": (containers.MModes, {"vis": (M1, 2, 1, nb), "vis_weight": (M1, 2, 1, nb)}),
        "mmodes_b": (containers.MModes, {"vis": (M1, 2, 1, nb), "vis_weight": (M1, 2, 1, nb)}),
        "map_a": (containers.Map, {"map": (1, 1, npix)}),
        "map_b": (containers.Map, {"map": (1, 1, npix)}),
        "map_fused": (containers.Map, {"map": (1, 1, npix)}),
    }
    for label, (cls, shapes) in want.items():
        cont = products[label][0]
        if len(products[label]) != 1 or not isinstance(cont, cls):
            raise RuntimeError(f"task chain label {label}: {products[label]} is not one {cls.__name__}")
        for name, shape in shapes.items():
            data = cont[name][:]
            if tuple(data.shape) != shape or data.device != device or not bool(torch.isfinite(data).all()):
                raise RuntimeError(
                    f"task chain {label}/{name}: shape {tuple(data.shape)} (want {shape}), "
                    f"device {data.device} or non-finite values"
                )
    if abs(products["tstream"][0].vis.shape[-1] - CHAIN_SAMPLES_PER_DAY * (1 + 2 * CHAIN_PAD_S / 86164.0905)) > 2:
        raise RuntimeError(f"task chain time stream has {ntime} samples")


def run_task_chain(tel, device) -> int:
    """Phases 10 and 11: the chain through the Manager, twice; returns the
    kernel launches of the first run."""
    import pickle
    import tempfile

    import torch

    from draco_tpu_torch.core.pipeline import Manager
    from draco_tpu_torch.ops import cuda_kernels
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    with tempfile.TemporaryDirectory() as product_dir:
        with open(Path(product_dir) / "telescope.pkl", "wb") as f:
            pickle.dump(tel, f)
        config = chain_config(product_dir, tel, sky_task())
        torch.cuda.reset_peak_memory_stats(device)
        cuda_kernels.reset_launches()
        manager = Manager(config)
        t0 = time.perf_counter()
        products = manager.run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = cuda_kernels.launches["banded_covariance"]
        log(f"task chain run 1: {wall:.2f} s wall, kernel launches {dict(cuda_kernels.launches)}, "
            f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
        log("task chain run 1 task_timing (s): " + json.dumps(
            {name: round(t["wall"], 4) for name, t in manager.task_timing.items()}))
        nregrid = len(products["sregrid"])
        if launches != nregrid:
            raise RuntimeError(f"the task chain launched banded_covariance {launches} times for {nregrid} regrids")
        check_chain_products(products, tel, device)

        # phase 10: chain A's m-modes against chain B's (the Lanczos sample
        # and regrid error, no limit: the CPU tests hold each task to JAX)
        va, vb = products["mmodes_a"][0].vis[:], products["mmodes_b"][0].vis[:]
        half = tel.mmax // 2
        log(f"task chain: chain A vs chain B m-modes max|diff| / max|ref| {_rel(va, vb):.3e} over all m, "
            f"{_rel(va[: half + 1], vb[: half + 1]):.3e} over m <= {half}")
        wa = products["mmodes_a"][0].weight[:]
        log(f"task chain: m-mode weights chain A mean {wa.mean().item():.2f}, "
            f"chain B {products['mmodes_b'][0].weight[:].mean().item():.2f}")

        # phase 11: unit sidereal weights -> m-mode weights nra = 1535
        nra = products["sstream"][0].vis.shape[-1]
        wb = products["mmodes_b"][0].weight[:]
        if not bool(((wb - nra).abs() <= 1e-6 * nra).all()):
            raise RuntimeError(f"chain B's m-mode weights are not all {nra}")
        map_b, fused = products["map_b"][0].map[:], products["map_fused"][0].map[:]
        rel = ((map_b - nra * fused).abs().max() / map_b.abs().max()).item()
        log(f"task chain: chain B map vs {nra} x SimulateAndMap map max|diff| / max|map| {rel:.3e} "
            f"(tol {TOL_CHAIN_FUSED})")
        if not rel <= TOL_CHAIN_FUSED:
            raise RuntimeError(f"chain B's map is {rel:.3e} from the fused map (tol {TOL_CHAIN_FUSED})")
        # both against the float64 fused round trip of the same sky (no
        # limit: the 1e-5 contract is held by phases 4 and 8)
        truth = fused_simulate_to_map(products["bt"][0], products["sky"][0].map[:], chunk=CHUNK)
        log(f"task chain: against the float64 fused map, chain B map / {nra} {_rel(map_b / nra, truth):.3e}, "
            f"float32 SimulateAndMap map {_rel(fused, truth):.3e} (max|diff| / max|map|)")
        del products, va, vb, wa, wb, map_b, fused, truth
        torch.cuda.empty_cache()

        manager = Manager(config)
        t0 = time.perf_counter()
        manager.run()
        torch.cuda.synchronize(device)
        log(f"task chain run 2: {time.perf_counter() - t0:.2f} s wall")
        log("task chain run 2 task_timing (s): " + json.dumps(
            {name: round(t["wall"], 4) for name, t in manager.task_timing.items()}))
    return launches


def check_map_makers(device) -> None:
    """Phase 12: the matrix map makers on the card at nside 32."""
    import torch

    from draco_tpu_torch.analysis.mapmaker import DirtyMapMaker, MaximumLikelihoodMapMaker, WienerMapMaker
    from draco_tpu_torch.analysis.transform import MModeTransform
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.synthesis.stream import SimulateSidereal

    def run(task, params, setup, data):
        task.read_config(params)
        task.setup(*setup)
        return task.process(data)

    tel, bt = small_dishes(NSIDE_SMALL)
    bt.generate()
    sky = containers.Map(nside=NSIDE_SMALL, polarisation=False, freq=tel.frequencies)
    sky.map[:] = np.random.Generator(np.random.SFC64(12)).standard_normal(sky.map.shape)
    mmodes = run(MModeTransform(), {}, (tel,), run(SimulateSidereal(), {}, (bt,), sky))
    params = {"nside": NSIDE_SMALL}
    batched = run(DirtyMapMaker(), params, (bt,), mmodes).map[:]
    streamed = run(DirtyMapMaker(), {**params, "streaming": True}, (bt,), mmodes).map[:]
    rel_dirty = _rel(batched, streamed)
    # the float32 SVD resolves modes down to about 3e-5 of the largest
    ml_params = {**params, "rcond": 3e-5, "acond": 1e-9}
    ml_map = run(MaximumLikelihoodMapMaker(), ml_params, (bt,), mmodes).map[:]
    ml = MaximumLikelihoodMapMaker()
    ml.read_config(ml_params)
    ml.setup(bt)
    shape = (tel.mmax + 1, 2, tel.nfreq, tel.npairs)
    vis = mmodes.vis[:].reshape(shape)
    alm = ml._solve_all_m(vis, mmodes.weight[:].reshape(shape), list(range(tel.nfreq)), tel.mmax)
    rel_ml = _rel(bt.project_sky_to_telescope(alm), vis)
    wiener = run(WienerMapMaker(), {**params, "prior_amp": 10.0}, (bt,), mmodes).map[:]
    finite = all(bool(torch.isfinite(m).all()) and m.device == device for m in (batched, streamed, ml_map, wiener))
    log(f"map makers nside={NSIDE_SMALL} 2 x 2 dishes: dirty batched vs streaming {rel_dirty:.3e} "
        f"(tol {TOL_PROJECTION}), ML re-projected vs data {rel_ml:.3e} (tol {TOL_ML}), "
        f"Wiener max|map| {wiener.abs().max().item():.3e}, all finite on the card: {finite}")
    if not (rel_dirty <= TOL_PROJECTION and rel_ml <= TOL_ML and finite):
        raise RuntimeError("phase 12: a map maker is out of tolerance or not finite on the card")


PROBES: dict = {}


def probe_task() -> str:
    """Define ``ProbeProducts`` (a pass-through task that records sampled
    cross products of a full-triangle stream, with their autos and
    weights, into ``PROBES``) in this module; return its path."""
    import torch

    from draco_tpu_torch.core import config
    from draco_tpu_torch.core.task import ContainerTask
    from draco_tpu_torch.ops import tools

    class ProbeProducts(ContainerTask):
        probe = config.str_prop("probe")

        def process(self, ss):
            vis, weight = ss.vis[:], ss.weight[:]
            nfeed, ntime = len(ss.input), vis.shape[-1]
            i, j, t = probe_samples(nfeed, ntime)
            flat = {k: torch.as_tensor(tools.cmap(a, b, nfeed) * ntime + t, device=vis.device)
                    for k, (a, b) in (("ij", (i, j)), ("ii", (i, i)), ("jj", (j, j)))}
            PROBES[self.probe] = {
                **{k: vis[0].reshape(-1)[idx].cpu().numpy().astype(np.complex128) for k, idx in flat.items()},
                "weight": weight[0].reshape(-1)[flat["ij"]].cpu().numpy().astype(np.float64),
            }
            return ss

    globals()["ProbeProducts"] = ProbeProducts
    return f"{__name__}.ProbeProducts"


def probe_samples(nfeed: int, ntime: int):
    """(i, j, t) of ``N_PROBE`` seeded cross products, i < j."""
    rng = np.random.Generator(np.random.SFC64(SKY_SEED))
    i, j = rng.integers(0, nfeed, 2 * N_PROBE), rng.integers(0, nfeed, 2 * N_PROBE)
    keep = np.flatnonzero(i != j)[:N_PROBE]
    i, j = np.minimum(i[keep], j[keep]), np.maximum(i[keep], j[keep])
    return i, j, rng.integers(0, ntime, N_PROBE)


def composite_config(product_dir: str, tel, recv_temp: float, probe: str) -> dict:
    """Phase 13 as one pipeline config mapping."""
    f0 = float(tel.frequencies[0])
    streaming = {"streaming": True, "baseline_chunk": CHUNK_COMPOSITE}
    sky = {"model": "foreground", "nside": NSIDE, "freq_start": f0, "freq_end": f0 + 1.0, "nfreq": 1,
           "polarisation": True, "seed": SKY_SEED}
    return {"pipeline": {"tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"],
         "params": {"product_directory": product_dir, "nside": NSIDE}},
        {"type": "draco.synthesis.skymodel.GenerateGaussianSky", "out": "sky", "params": sky},
        {"type": "draco.synthesis.stream.SimulateSidereal", "requires": "bt", "in": "sky", "out": "sstream",
         "params": {**streaming, "fast_ra": True}},
        {"type": "draco.synthesis.stream.ExpandProducts", "requires": "tel", "in": "sstream", "out": "sstream_full"},
        {"type": "draco.synthesis.noise.ReceiverTemperature", "in": "sstream_full", "out": "sstream_rt",
         "params": {"recv_temp": recv_temp}},
        {"type": "draco.synthesis.gain.RandomSiderealGains", "requires": ["tel", "sstream_rt"], "out": "gain_fluc",
         "params": {"seed": SKY_SEED, "start_time": "2015-10-05 12:15:00", "end_time": "2015-10-06 12:15:00",
                    "sigma_amp": 0.001, "sigma_phase": 0.001}},
        {"type": "draco.analysis.calibration.ApplyGain", "in": ["sstream_rt", "gain_fluc"], "out": "sstream_gain",
         "params": {"inverse": False}},
        {"type": probe, "in": "sstream_gain", "out": "sstream_exp", "params": {"probe": "expect"}},
        {"type": "draco.synthesis.noise.SampleNoise", "in": "sstream_exp", "out": "sstream_noise",
         "params": {"seed": SKY_SEED, "sample_frac": 1.0, "set_weights": True}},
        {"type": probe, "in": "sstream_noise", "out": "sstream_sampled", "params": {"probe": "noise"}},
        {"type": "draco.analysis.transform.CollateProducts", "requires": "bt", "in": "sstream_sampled",
         "out": "sstream_coll"},
        {"type": "draco.analysis.transform.MModeTransform", "requires": "tel", "in": "sstream_coll", "out": "mmodes"},
        {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "bt", "in": "mmodes", "out": "dmap",
         "params": {"nside": NSIDE, "streaming": True, "baseline_chunk": CHUNK_COMPOSITE_MAP}},
    ]}}


def receiver_temperature(tel, sstream) -> tuple[float, float, float]:
    """(recv_temp, 10 max|vis|, Gershgorin bound) of a noiseless stacked stream:
    the bound is the largest sum over j of |V_ij| (autos included), which a
    receiver temperature must exceed for V + T I to be positive definite."""
    import torch

    vis = sstream.vis[:][0]  # [nstack, ntime]
    nfeed = tel.nfeed
    fmap = tel.feedmap
    rows, cols = np.nonzero(fmap >= 0)
    counts = np.zeros((nfeed, vis.shape[0]), np.float32)
    np.add.at(counts, (rows, fmap[rows, cols]), 1.0)
    rowsum = torch.as_tensor(counts, device=vis.device) @ vis.abs()
    ten_max = 10.0 * vis.abs().max().item()
    gershgorin = rowsum.max().item()
    return max(ten_max, 1.01 * gershgorin), ten_max, gershgorin


def run_composite(device) -> None:
    """Phase 13: the composite chain at 2048 dual-pol feeds through the Manager."""
    import os
    import pickle
    import tempfile

    import torch

    from draco_tpu_torch.analysis.transform import CollateProducts
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.core.pipeline import Manager
    from draco_tpu_torch.ops import healpix
    from draco_tpu_torch.synthesis.noise import ReceiverTemperature, SampleNoise
    from draco_tpu_torch.synthesis.skymodel import GenerateGaussianSky
    from draco_tpu_torch.synthesis.stream import ExpandProducts, SimulateSidereal

    def run(task, params, setup, *data):
        task.read_config(params)
        task.setup(*setup)
        return task.process(*data)

    tel, bt = cylinder(NSIDE, 4, 256, pol=True)
    nfeed, nprod = tel.nfeed, tel.nfeed * (tel.nfeed + 1) // 2
    log(f"composite chain: 4 x 256 dual-pol feeds ({nfeed} inputs, {nprod} products, {tel.npairs} stacked), "
        f"nside={NSIDE}, baseline chunk {CHUNK_COMPOSITE} (map maker {CHUNK_COMPOSITE_MAP})")

    # a first simulation of the same sky sets the receiver temperature
    t0 = _sync_clock(device)
    config = composite_config("", tel, 0.0, "")
    sky_params = config["pipeline"]["tasks"][1]["params"]
    sky = run(GenerateGaussianSky(), sky_params, ())
    pre = run(SimulateSidereal(), config["pipeline"]["tasks"][2]["params"], (bt,), sky)
    recv_temp, ten_max, gershgorin = receiver_temperature(tel, pre)
    log(f"composite chain: first simulation {_sync_clock(device) - t0:.2f} s; receiver temperature {recv_temp:.6e} "
        f"(10 x max|vis| {ten_max:.6e}, Gershgorin bound {gershgorin:.6e})")
    del sky, bt
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as product_dir:
        with open(Path(product_dir) / "telescope.pkl", "wb") as f:
            pickle.dump(tel, f)
        config = composite_config(product_dir, tel, recv_temp, probe_task())
        torch.cuda.reset_peak_memory_stats(device)
        manager = Manager(config)
        t0 = time.perf_counter()
        products = manager.run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    timing = {name.split(".")[-1]: round(t["wall"], 4) for name, t in manager.task_timing.items()}
    log(f"composite chain run: {wall:.2f} s wall, peak device memory {peak:.2f} GiB")
    log("composite chain task_timing (s): " + json.dumps(timing))
    sample_s = next(t for name, t in timing.items() if name.startswith("SampleNoise"))
    ntime = products["sstream"][0].vis.shape[-1]
    gflop_row = (8.0 / 3.0 + 16.0) * nfeed**3 / 1e9  # complex Cholesky + two complex GEMMs
    log(f"SampleNoise: {ntime} rows of {nfeed} x {nfeed} in {sample_s:.4f} s: {ntime / sample_s:.1f} rows/s, "
        f"{gflop_row * ntime / sample_s / 1e3:.2f} TFLOP/s at {gflop_row:.1f} GFLOP a row "
        f"(67 TFLOP/s float32 outside the tensor cores)")

    # the map
    dmap = products["dmap"][0].map[:]
    npix = healpix.npix_of(NSIDE)
    if tuple(dmap.shape) != (1, 4, npix) or not bool(torch.isfinite(dmap).all()):
        raise RuntimeError(f"composite chain map: shape {tuple(dmap.shape)} or non-finite values")

    # ApplyGain: g_i g_j* V0 in float64 on the sampled products
    i, j, t = probe_samples(nfeed, ntime)
    s0 = products["sstream"][0].vis[:][0].cpu().numpy().astype(np.complex128)  # [nstack, ntime]
    g = products["gain_fluc"][0].gain[:][0].cpu().numpy()  # [nfeed, ntime]

    def expectation(a, b, tt):
        u = tel.feedmap[a, b]
        v = np.where(u >= 0, s0[np.maximum(u, 0), tt], 0.0)
        v = np.where(tel.feedconj[a, b] != 0, v.conj(), v) + recv_temp * (a == b)
        return g[a, tt] * g[b, tt].conj() * v

    expect, noisy = PROBES["expect"], PROBES["noise"]
    k = slice(0, N_GAIN_CHECK)
    v64 = expectation(i[k], j[k], t[k])
    rel_gain = np.abs(expect["ij"][k] - v64).max() / np.abs(v64).max()
    rel_auto = np.abs(expect["ii"][k] - expectation(i[k], i[k], t[k])).max() / recv_temp

    # SampleNoise: z-scores, autos, weights
    nsamp = int(1.0 * 240 * (products["sstream"][0].ra[1] - products["sstream"][0].ra[0])
                * (86164.0905 / 86400.0) * products["sstream"][0].index_map["freq"]["width"][0] * 1e6)
    z = (noisy["ij"] - expect["ij"]) / np.sqrt(expect["ii"].real * expect["jj"].real / nsamp)
    z2, zmean = float(np.mean(np.abs(z) ** 2)), float(np.abs(np.mean(z)))
    autos = np.concatenate([noisy["ii"], noisy["jj"]])
    autos_ok = bool((autos.real > 0).all() and (np.abs(autos.imag) <= 1e-5 * autos.real).all())
    w_want = expect["weight"] * nsamp / (noisy["ii"].real * noisy["jj"].real)
    rel_w = float(np.abs(noisy["weight"] - w_want).max() / np.abs(w_want).max())
    log(f"composite chain checks: ApplyGain vs g_i g_j* V (float64) on {N_GAIN_CHECK} products "
        f"{rel_gain:.3e} (autos {rel_auto:.3e}; tol {TOL_GAIN}); SampleNoise n={nsamp} on {N_PROBE} cross products: "
        f"mean|z|^2 {z2:.5f} (tol 1 +- {TOL_Z2}), |mean z| {zmean:.2e} (tol {TOL_ZMEAN}), autos real and "
        f"positive {autos_ok}, weights vs n / (W_ii W_jj) {rel_w:.3e}")
    s_noiseless = products["sstream"][0]
    # the Manager holds every product, the full-triangle stream among them
    del manager, products, expect, noisy, PROBES["expect"], PROBES["noise"], dmap
    torch.cuda.empty_cache()

    # the expand -> collate round trip of the noiseless stream
    t0 = _sync_clock(device)
    full = run(ExpandProducts(), {}, (tel,), s_noiseless)
    back = run(CollateProducts(), {}, (tel,), full)
    del full
    rel_rt = _rel(back.vis[:], s_noiseless.vis[:])
    log(f"composite chain: expand -> collate round trip of the noiseless stream max|diff| / max|ref| {rel_rt:.3e} "
        f"(tol {TOL_ROUND_TRIP}; {_sync_clock(device) - t0:.2f} s)")
    del back
    torch.cuda.empty_cache()

    # SampleNoise under two chunk budgets on a 4-sample cut
    cut = containers.SiderealStream(axes_from=s_noiseless, attrs_from=s_noiseless, ra=s_noiseless.ra[:4])
    cut.vis[:] = s_noiseless.vis[:][..., :4]
    cut.weight[:] = 1.0
    draws = {}
    budget_before = os.environ.get("DRACO_TPU_SAMPLENOISE_CHUNK_GB")
    for budget in ("2", "0.25"):
        os.environ["DRACO_TPU_SAMPLENOISE_CHUNK_GB"] = budget
        full = run(ReceiverTemperature(), {"recv_temp": recv_temp}, (), run(ExpandProducts(), {}, (tel,), cut))
        draws[budget] = run(SampleNoise(), {"seed": SKY_SEED, "sample_frac": 1.0}, (), full).vis[:]
        del full
    if budget_before is None:
        del os.environ["DRACO_TPU_SAMPLENOISE_CHUNK_GB"]
    else:
        os.environ["DRACO_TPU_SAMPLENOISE_CHUNK_GB"] = budget_before
    invariant = bool(torch.equal(draws["2"], draws["0.25"]))
    log(f"composite chain: SampleNoise on a 4-sample cut under 2 and 0.25 GiB budgets bit-identical: {invariant}")
    del draws, cut, s_noiseless
    torch.cuda.empty_cache()

    failures = [
        what for what, ok in (
            (f"ApplyGain {rel_gain:.3e}", rel_gain <= TOL_GAIN and rel_auto <= TOL_GAIN),
            (f"mean|z|^2 {z2:.5f}", abs(z2 - 1.0) <= TOL_Z2),
            (f"|mean z| {zmean:.2e}", zmean <= TOL_ZMEAN),
            ("autos", autos_ok),
            (f"weights {rel_w:.3e}", rel_w <= 1e-5),
            (f"round trip {rel_rt:.3e}", rel_rt <= TOL_ROUND_TRIP),
            ("chunk invariance", invariant),
            (f"peak {peak:.2f} GiB", peak < PEAK_LIMIT_GIB),
        ) if not ok
    ]
    if failures:
        raise RuntimeError(f"phase 13 (composite chain) failed: {', '.join(failures)}")


ANALYSIS: dict = {}


def observed_task() -> str:
    """Define phase 14's source task, ``EmitObserved``, in this module; return its path.

    It draws a Gaussian foreground and a Gaussian signal sky from the KL
    transform's covariance models (``KL_MODEL``), simulates each through
    ``SimulateSidereal``, adds ``GaussianNoise`` of the model's variance
    per m-mode and interference at ``RFI_CELLS``, and leaves the parts in
    ``ANALYSIS`` for the checks of phases 14 and 15.
    """
    import torch

    from draco_tpu_torch.core import config, containers
    from draco_tpu_torch.core.task import ContainerTask, PipelineStopIteration
    from draco_tpu_torch.device import resolve
    from draco_tpu_torch.ops import sht
    from draco_tpu_torch.synthesis.noise import GaussianNoise
    from draco_tpu_torch.synthesis.stream import SimulateSidereal
    from draco_tpu_torch.telescope.kltransform import KLTransform

    def run(task, params, setup, data):
        task.read_config(params)
        task.setup(*setup)
        return task.process(data)

    def draw_alm(cov_lff, rng):
        """alm [f, 1, l, m] with <a_lm a_l'm'*> = cov[l, f, f'] (real at m = 0), no monopole."""
        L1, nf = cov_lff.shape[:2]
        z = (rng.standard_normal((L1, nf, L1)) + 1j * rng.standard_normal((L1, nf, L1))) / np.sqrt(2.0)
        z[..., 0] = np.sqrt(2.0) * z[..., 0].real
        alm = np.einsum("lfg,lgm->flm", np.linalg.cholesky(cov_lff), z)
        alm *= np.arange(L1)[None, :] <= np.arange(L1)[:, None]  # m <= l
        alm[:, 0] = 0.0
        return alm[:, None]

    class EmitObserved(ContainerTask):
        seed = config.int_prop(0)
        nside = config.int_prop(NSIDE)

        def setup(self, bt):
            self.bt = bt

        def process(self):
            if self._count:
                raise PipelineStopIteration()
            bt, tel = self.bt, self.bt.telescope
            device = resolve()
            t0 = _sync_clock(device)
            bt.generate()
            ANALYSIS["generate_s"] = _sync_clock(device) - t0
            rng = np.random.Generator(np.random.SFC64(self.seed))
            model = KLTransform.from_config(KL_MODEL)
            streams = {}
            for name, cov in (("foreground", model.foreground), ("signal", model.signal)):
                alm = torch.as_tensor(draw_alm(cov(tel.lmax, tel.frequencies), rng), device=device).to(torch.complex64)
                sky = containers.Map(nside=self.nside, polarisation=False, freq=tel.frequencies)
                sky.map[:] = sht.sphtrans_inv_sky(alm, self.nside)
                streams[name] = run(SimulateSidereal(), {}, (bt,), sky)
            total = streams["foreground"].copy()
            total.vis[:] += streams["signal"].vis[:]
            # thermal noise of variance noise_amp per m-mode at redundancy 1: an m-mode is the mean of nra samples
            nra = total.vis.shape[-1]
            nsamp = int(240 * (total.ra[1] - total.ra[0]) * (86164.0905 / 86400.0) * total.index_map["freq"]["width"][0] * 1e6)
            noise = {"recv_temp": float(np.sqrt(KL_MODEL["noise_amp"] * nra * nsamp)), "ndays": 1.0, "seed": self.seed}
            streams["signal+noise"] = run(GaussianNoise(), noise, (bt,), streams["signal"].copy())
            total = run(GaussianNoise(), noise, (bt,), total)
            streams["total"] = total.copy()
            peak = total.vis[:].abs().max()
            for f, t in RFI_CELLS:
                total.vis[:][f, :, t] += 2.0 * peak
            ANALYSIS.update(streams)
            total.attrs["tag"] = "observed"
            return total

    globals()["EmitObserved"] = EmitObserved
    return f"{__name__}.EmitObserved"


def analyze_config(product_dir: str, source: str) -> dict:
    """Phase 14: the analysis example config with the source task in place of its file loader."""
    return {"pipeline": {"tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"],
         "params": {"product_directory": product_dir, "nside": NSIDE}},
        {"type": source, "requires": "btm", "out": "sstream_raw", "params": {"seed": ANALYSIS_SEED, "nside": NSIDE}},
        {"type": "draco.analysis.transform.CollateProducts", "requires": "tel", "in": "sstream_raw", "out": "sstream"},
        {"type": "draco.analysis.flagging.RFIMask", "in": "sstream", "out": "rfimask"},
        {"type": "draco.analysis.flagging.ApplyTimeFreqMask", "in": ["sstream", "rfimask"], "out": "sstream_masked"},
        {"type": "draco.analysis.transform.MModeTransform", "requires": "btm", "in": "sstream_masked", "out": "mmodes"},
        {"type": "draco.analysis.svdfilter.SVDFilter", "in": "mmodes", "out": "mmodes_filt", "params": {"niter": 5}},
        {"type": "draco.analysis.mapmaker.MaximumLikelihoodMapMaker", "requires": "btm", "in": "mmodes_filt",
         "out": "mlmap", "params": {"nside": NSIDE}},
    ]}}


def _mmodes_of(tel, sstream):
    from draco_tpu_torch.analysis.transform import MModeTransform

    task = MModeTransform()
    task.read_config({})
    task.setup(tel)
    return task.process(sstream)


def _power(x) -> float:
    return float((x.abs().double() ** 2).sum())


def run_analyze(device):
    """Phase 14: the analysis example's chain through the Manager; returns its beam transfer."""
    import pickle
    import tempfile

    import torch

    from draco_tpu_torch.analysis import svdfilter
    from draco_tpu_torch.analysis.mapmaker import MaximumLikelihoodMapMaker, _chunk_operands, pinv_svd
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.core.pipeline import Manager
    from draco_tpu_torch.ops import healpix
    from draco_tpu_torch.ops.tools import svd

    tel, _ = cylinder(NSIDE, 2, 64, nfreq=ANALYSIS_NFREQ)
    nb, M1 = tel.npairs, tel.mmax + 1
    log(f"analysis chain: 2 x 64 feeds, {nb} pairs, {tel.nfreq} frequencies {tel.frequencies[0]:.1f}-"
        f"{tel.frequencies[-1]:.1f} MHz, nside={NSIDE}, lmax=mmax={tel.mmax}, every m")
    with tempfile.TemporaryDirectory() as product_dir:
        with open(Path(product_dir) / "telescope.pkl", "wb") as f:
            pickle.dump(tel, f)
        torch.cuda.reset_peak_memory_stats(device)
        manager = Manager(analyze_config(product_dir, observed_task()))
        t0 = time.perf_counter()
        products = manager.run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    timing = {name.split(".")[-1]: round(t["wall"], 4) for name, t in manager.task_timing.items()}
    log(f"analysis chain run: {wall:.2f} s wall (generate inside EmitObserved {ANALYSIS['generate_s']:.2f} s), "
        f"peak device memory {peak:.2f} GiB")
    log("analysis chain task_timing (s): " + json.dumps(timing))
    bt = products["btm"][0]
    tel = bt.telescope
    nra = 2 * tel.mmax + 1

    # containers, shapes, devices
    want = {
        "sstream": (containers.SiderealStream, "vis", (tel.nfreq, nb, nra)),
        "sstream_masked": (containers.SiderealStream, "vis_weight", (tel.nfreq, nb, nra)),
        "mmodes_filt": (containers.MModes, "vis", (M1, 2, tel.nfreq, nb)),
        "mlmap": (containers.Map, "map", (tel.nfreq, 1, healpix.npix_of(NSIDE))),
    }
    for label, (cls, name, shape) in want.items():
        data = products[label][0][name][:]
        if not isinstance(products[label][0], cls) or tuple(data.shape) != shape or data.device != device \
                or not bool(torch.isfinite(torch.view_as_real(data) if data.is_complex() else data).all()):
            raise RuntimeError(f"analysis chain {label}/{name}: {type(products[label][0]).__name__} {tuple(data.shape)} "
                               f"on {data.device} (want {cls.__name__} {shape} on {device}) or non-finite values")
    if bt._bp.device != device:
        raise RuntimeError(f"the beam transfer matrices lie on {bt._bp.device}")

    # the RFI mask and the masked weights
    mask = products["rfimask"][0].mask[:]  # host bool [freq, ra]
    injected = np.zeros_like(mask)
    for f, t in RFI_CELLS:
        injected[f, t] = True
    caught = bool(mask[injected].all())
    clean_share = float(mask[~injected].mean())
    w = products["sstream_masked"][0].weight[:]
    w0 = ANALYSIS["total"].weight[:]
    bad = torch.as_tensor(mask, device=device)[:, None, :].expand(w.shape)
    masked_zero = bool((w[bad] == 0).all())
    others = ((w[~bad] - w0[~bad]).abs().max() / w0.abs().max()).item()
    log(f"analysis chain: RFIMask caught every injected cell: {caught}; masks {100 * clean_share:.3f}% of the clean cells "
        f"(limit {100 * RFI_CLEAN_SHARE:.0f}%); masked weights exactly 0: {masked_zero}; the others against the source's "
        f"{others:.3e} (limit 1e-6)")

    # the SVD filter against the same filter in complex128, and what it takes out
    raw = _mmodes_of(tel, products["sstream_masked"][0])
    filt = products["mmodes_filt"][0].vis[:]
    A, fmask = svdfilter._mmode_matrices(raw, dtype=torch.complex128)
    t0 = _sync_clock(device)
    ref, _ = svdfilter._svd_filter_device(A, fmask, niter=5, global_threshold=1e-3, local_threshold=1e-2)
    ref_s = _sync_clock(device) - t0
    ref = ref.reshape(M1, tel.nfreq, 2, nb).permute(0, 2, 1, 3)
    rel_filter = ((filt - ref).abs().max() / raw.vis[:].abs().max()).item()
    p_sn = _power(_mmodes_of(tel, ANALYSIS["signal+noise"]).vis[:])
    excess_before, excess_after = _power(raw.vis[:]) / p_sn, _power(filt) / p_sn
    log(f"analysis chain: SVDFilter vs complex128 max|diff| / max|unfiltered| {rel_filter:.3e} (tol {TOL_SVD_FILTER}; "
        f"complex128 filter {ref_s:.2f} s); m-mode power over the signal+noise power: {excess_before:.4e} before, "
        f"{excess_after:.4e} after (fall {excess_before / excess_after:.3e}, at least {FOREGROUND_EXCESS_FALL:.0e})")
    del A, fmask, ref, raw

    # the ML solve on sampled m against a complex128 pseudo-inverse of the same rank
    ml = MaximumLikelihoodMapMaker()
    ml.read_config({"nside": NSIDE})
    ml.setup(bt)
    msel = np.unique(np.round(np.linspace(0, tel.mmax, N_ML_CHECK)).astype(int))
    mm = products["mmodes_filt"][0]
    shape = (M1, 2, tel.nfreq, nb)
    bp, bm = ml._bt_tensors(list(range(tel.nfreq)))
    ops = [_chunk_operands(bp, bm, mm.vis[:].reshape(shape), mm.weight[:].reshape(shape), int(m), 1) for m in msel]
    Bt, vt = torch.cat([o[0] for o in ops]), torch.cat([o[1] for o in ops])  # [16, f, ntel, nsky], [16, f, ntel]
    t0 = _sync_clock(device)
    a64 = torch.einsum("mfst,mft->mfs", pinv_svd(Bt, acond=ml.acond, rcond=ml.rcond), vt)
    s64 = svd(Bt)[1]
    k64 = ((s64 > ml.rcond * s64.amax(dim=-1, keepdim=True)) & (s64 > ml.acond)).sum(dim=-1)
    Bt, vt = Bt.to(torch.complex128), vt.to(torch.complex128)
    U, s, Vh = svd(Bt)
    k128 = ((s > ml.rcond * s.amax(dim=-1, keepdim=True)) & (s > ml.acond)).sum(dim=-1)
    keep = torch.arange(s.shape[-1], device=device) < k64[..., None]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    a128 = torch.einsum("mfks,mfk,mftk,mft->mfs", Vh.conj(), s_inv.to(U.dtype), U.conj(), vt)
    r64, r128 = torch.einsum("mfts,mfs->mft", Bt, a64.to(Bt.dtype)), torch.einsum("mfts,mfs->mft", Bt, a128)
    rel_ml = ((r64 - r128).abs().max() / r128.abs().max()).item()
    rank_diff = int((k64 - k128).abs().max())
    log(f"analysis chain: ML solution on {len(msel)} sampled m re-projected vs a complex128 pseudo-inverse of its rank "
        f"{rel_ml:.3e} (tol {TOL_ML}); ranks float32 {int(k64.min())}-{int(k64.max())}, against complex128 differ by at most "
        f"{rank_diff} (limit 2); check {_sync_clock(device) - t0:.2f} s")
    del products, manager, mm, ops, Bt, vt, U, s, Vh, a64, a128, r64, r128, bp, bm
    torch.cuda.empty_cache()

    failures = [
        what for what, ok in (
            ("an injected RFI cell is not masked", caught),
            (f"mask covers {clean_share:.3f} of the clean cells", clean_share < RFI_CLEAN_SHARE),
            ("masked weights", masked_zero and others <= 1e-6),
            (f"SVDFilter {rel_filter:.3e}", rel_filter <= TOL_SVD_FILTER),
            (f"foreground fall {excess_before / excess_after:.3e}", excess_before / excess_after >= FOREGROUND_EXCESS_FALL),
            (f"ML {rel_ml:.3e}, ranks differ by {rank_diff}", rel_ml <= TOL_ML and rank_diff <= 2),
        ) if not ok
    ]
    if failures:
        raise RuntimeError(f"phase 14 (analysis chain) failed: {', '.join(failures)}")
    return bt


def kl_product_config(directory: str) -> dict:
    """Phase 15's product config: the cylinder of phase 14, a KLTransform, a DoubleKL and a PS estimator."""
    return {
        "config": {"output_directory": directory},
        "telescope": {
            "type": "UnpolarisedCylinder", "num_cylinders": 2, "num_feeds": 64, "num_freq": ANALYSIS_NFREQ,
            "auto_correlations": True, "force_lmax": 3 * NSIDE - 1, "force_mmax": 3 * NSIDE - 1,
            "freq_lower": 400.0, "freq_upper": 500.0, **CHIME,
        },
        "beamtransfer": {"nside": NSIDE},
        "kltransform": [
            {"type": "KLTransform", "name": "kl", "threshold": KL_THRESHOLD, **KL_MODEL},
            {"type": "DoubleKL", "name": "dk", "threshold": DKL_THRESHOLD,
             "foreground_threshold": DKL_FOREGROUND_THRESHOLD, **KL_MODEL},
        ],
        "psfisher": [{"type": "MonteCarlo", "name": "ps", "klname": "dk"}],
    }


def check_kl_modes(kl, device, with_diagonal: bool):
    """Over every m: max|fwd @ bwd - I| and, with the one-stage transform,
    max|V^H (S + N) V - diag(lambda + 1)| / max(lambda + 1) on the stored modes."""
    import torch

    from draco_tpu_torch.telescope.kltransform import _regularise

    modes, nmode = kl._ensure_modes()
    round_trip = diagonal = 0.0
    for m0, m1, bwd, fwd in modes["chunks"]:
        if fwd.device != device or fwd.dtype != torch.complex128:
            raise RuntimeError(f"KL modes of m {m0}-{m1} are {fwd.dtype} on {fwd.device}")
        kc = fwd.shape[1]
        if kc == 0:
            continue
        keep = torch.arange(kc, device=device)[None] < nmode[m0:m1, None]  # [mc, kc]
        both = keep[:, :, None] & keep[:, None, :]
        eye = torch.eye(kc, dtype=fwd.dtype, device=device)
        round_trip = max(round_trip, ((fwd @ bwd - eye).abs() * both).max().item())
        if with_diagonal:
            S, F, Nt = kl._pencil(m0, m1)
            want = modes["evals"][m0:m1, :kc] + 1.0
            cov = fwd @ (S + _regularise(F + Nt)) @ fwd.mH
            diagonal = max(diagonal, ((cov - torch.diag_embed(want).to(cov.dtype)).abs() / want.amax(dim=-1)[:, None, None]).max().item())
    return round_trip, diagonal


def run_kl_path(device, bt) -> None:
    """Phase 15: SVD -> KL -> quadratic power spectrum through the product manager."""
    import tempfile

    import scipy.linalg as sla
    import torch
    import yaml

    from draco_tpu_torch.analysis.fgfilter import KLModeProject, SVDModeProject
    from draco_tpu_torch.analysis.powerspectrum import QuadraticPSEstimation
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.telescope.kltransform import _regularise
    from draco_tpu_torch.telescope.manager import ProductManager
    from draco_tpu_torch.telescope.psestimation import PSEstimation

    def run(task, params, setup, data):
        task.read_config(params)
        task.setup(*setup)
        return task.process(data)

    with tempfile.TemporaryDirectory() as directory:
        path = Path(directory) / "products.yaml"
        path.write_text(yaml.safe_dump(kl_product_config(directory)))
        pm = ProductManager.from_config(str(path))
    tel = pm.telescope
    if not (np.array_equal(tel.uniquepairs, bt.telescope.uniquepairs) and np.array_equal(tel.frequencies, bt.telescope.frequencies)):
        raise RuntimeError("the product config's telescope is not phase 14's")
    # the beam transfer matrices phase 14 generated (the same telescope): not generated twice
    pm.beamtransfer._bp, pm.beamtransfer._bm = bt._bp, bt._bm
    pm.generate()
    M = tel.mmax + 1
    torch.cuda.reset_peak_memory_stats(device)
    times = {}

    def timed(name, fn):
        t0 = _sync_clock(device)
        out = fn()
        times[name] = round(_sync_clock(device) - t0, 4)
        return out

    timed("beam SVD", pm.beamtransfer._ensure_svd)
    n = tel.nfreq * pm.beamtransfer.svd_len()
    mmodes = {name: _mmodes_of(tel, ANALYSIS[name]) for name in ("total", "foreground", "signal")}
    svd = timed("SVDModeProject x3", lambda: {
        name: run(SVDModeProject(), {"mode": "forward"}, (pm,), mm) for name, mm in mmodes.items()})
    for name, c in svd.items():
        if not isinstance(c, containers.SVDModes) or tuple(c.vis.shape) != (M, n) or c.vis[:].device != device:
            raise RuntimeError(f"SVD modes of the {name} data: {c} on {c.vis[:].device}")

    # the one-stage transform
    kl = pm.kltransforms["kl"]
    _, nmode = timed("KLTransform solve", kl._ensure_modes)
    stored = sum(f.numel() + b.numel() for _, _, b, f in kl._modes["chunks"]) * 16 / 2**30
    log(f"KL path: n = {n}; KLTransform {times['KLTransform solve']:.2f} s for {M} m ({M / times['KLTransform solve']:.1f} "
        f"eigh/s, {len(kl._modes['chunks'])} chunks); modes above {KL_THRESHOLD}: {int(nmode.sum())} of {M * n} "
        f"(at most {int(nmode.max())} an m); stored fwd and bwd {stored:.2f} GiB")
    round_trip, diagonal = timed("KLTransform checks", lambda: check_kl_modes(kl, device, True))
    evals_err = 0.0
    t0 = time.perf_counter()
    for m in (1, M // 4, M // 2, 3 * M // 4):
        S, F, Nt = kl._pencil(m, m + 1)
        ref = np.sort(sla.eigh(S[0].cpu().numpy(), _regularise(F + Nt)[0].cpu().numpy(), eigvals_only=True))[::-1]
        evals_err = max(evals_err, float(np.abs(kl.evals_all()[m].cpu().numpy() - ref).max() / ref.max()))
    times["scipy eigh x4 (host)"] = round(time.perf_counter() - t0, 4)
    log(f"KL path: KLTransform over every m: max|fwd @ bwd - I| {round_trip:.3e}, diagonalisation {diagonal:.3e} "
        f"(tol {TOL_KL}); eigenvalues of 4 m against host float64 scipy.linalg.eigh(S, N) {evals_err:.3e} of the largest "
        f"(tol {TOL_KL_EVALS})")
    klm = timed("KLModeProject forward (kl)", lambda: run(KLModeProject(), {"mode": "forward", "klname": "kl"}, (pm,), svd["total"]))
    back = timed("KLModeProject filter (kl)", lambda: run(KLModeProject(), {"mode": "filter", "klname": "kl"}, (pm,), svd["total"]))
    kl_ok = (
        isinstance(klm, containers.KLModes) and type(back) is containers.SVDModes and klm.vis[:].device == device
        and torch.equal(klm.nmode[:].long(), nmode) and bool(torch.isfinite(torch.view_as_real(back.vis[:])).all())
        and bool(torch.isfinite(torch.view_as_real(klm.vis[:])).all())
    )
    del pm.kltransforms["kl"], kl, klm, back
    torch.cuda.empty_cache()

    # the two-stage transform: foreground rejection, then signal over noise
    dk = pm.kltransforms["dk"]
    _, nmode = timed("DoubleKL solve", dk._ensure_modes)
    dk_round_trip, _ = timed("DoubleKL checks", lambda: check_kl_modes(dk, device, False))
    evals = dk.evals_all()
    kept = torch.arange(n, device=device)[None] < nmode[:, None]
    expected_share = float(evals[kept].sum() / evals.clamp(min=0).sum())
    project = {"mode": "forward", "klname": "dk"}
    klmodes = timed("KLModeProject forward (dk) x3", lambda: {name: run(KLModeProject(), project, (pm,), c) for name, c in svd.items()})
    p_kl = {name: _power(c.vis[:]) for name, c in klmodes.items()}
    p_svd = {name: _power(c.vis[:]) for name, c in svd.items()}
    foreground_cut = (p_kl["signal"] / p_kl["foreground"]) / (p_svd["signal"] / p_svd["foreground"])
    signal_vs_expected = p_kl["signal"] / float(evals[kept].sum())
    log(f"KL path: DoubleKL {times['DoubleKL solve']:.2f} s ({2 * M / times['DoubleKL solve']:.1f} eigh/s); modes kept "
        f"{int(nmode.sum())} (at most {int(nmode.max())} an m); round trip {dk_round_trip:.3e} (tol {TOL_KL}); "
        f"signal-to-foreground power ratio {p_svd['signal'] / p_svd['foreground']:.3e} in the SVD basis, "
        f"{p_kl['signal'] / p_kl['foreground']:.3e} in the kept KL modes: better by {foreground_cut:.3e} (at least "
        f"{DKL_FOREGROUND_CUT:.0e}); the kept modes hold {expected_share:.4f} of the model's signal-to-noise (at least "
        f"{DKL_SIGNAL_KEPT}), and the simulated signal's power in them is {signal_vs_expected:.4f} of the eigenvalues' sum "
        f"(0.8 to 1.25)")

    # the quadratic estimator
    ps = pm.psestimators["ps"]
    total = klmodes["total"]
    q = timed("q, Fisher and bias pass", lambda: ps.q_estimator_all(total.vis[:], total.nmode[:]))
    fisher, bias = ps.fisher_bias()
    out = timed("QuadraticPSEstimation", lambda: run(QuadraticPSEstimation(), {"psname": "ps"}, (pm,), total))
    m8 = np.unique(np.round(np.linspace(1, 0.6 * M, 8)).astype(int))
    only = torch.zeros_like(total.vis[:])
    only[m8] = total.vis[:][m8]
    q_all = ps.q_estimator_all(only, total.nmode[:])
    q_sum = sum(ps.q_estimator(int(m), total.vis[:][int(m)]) for m in m8)
    rel_q = ((q_all - q_sum).abs().max() / q_sum.abs().max()).item()
    other = PSEstimation.from_config({"m_chunk": 1}, pm.beamtransfer, dk).genbands()
    q1 = timed("pass at m_chunk 1", lambda: other.q_estimator_all(total.vis[:], total.nmode[:]))
    rel_chunk = max(
        ((a - b).abs().max() / b.abs().max()).item() for a, b in zip((q1, *other.fisher_bias()), (q, fisher, bias)))
    symmetric = bool(torch.equal(fisher, fisher.T)) and bool((fisher.diagonal() > 0).all())
    bands = out.powerspectrum[:]
    ps_ok = isinstance(out, containers.Powerspectrum2D) and bool(torch.isfinite(bands).all()) and fisher.device == device
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"KL path: {ps.nbands} bands; q_estimator_all against the sum of q_estimator over {len(m8)} m {rel_q:.3e}; "
        f"m_chunk {dk._chunk_len(ps.nbands)} against 1: q, Fisher, bias within {rel_chunk:.3e} (tol {TOL_PS} both); Fisher "
        f"symmetric with a positive diagonal: {symmetric}; band powers finite: {ps_ok}")
    log("KL path seconds: " + json.dumps(times))
    log(f"KL path: peak device memory {peak:.2f} GiB")

    failures = [
        what for what, ok in (
            (f"KLTransform round trip {round_trip:.3e}, diagonalisation {diagonal:.3e}", max(round_trip, diagonal) <= TOL_KL),
            (f"eigenvalues vs scipy {evals_err:.3e}", evals_err <= TOL_KL_EVALS),
            ("KLModeProject containers", kl_ok),
            (f"DoubleKL round trip {dk_round_trip:.3e}", dk_round_trip <= TOL_KL),
            (f"foreground cut {foreground_cut:.3e}", foreground_cut >= DKL_FOREGROUND_CUT),
            (f"signal kept {expected_share:.4f}, measured/expected {signal_vs_expected:.4f}",
             expected_share >= DKL_SIGNAL_KEPT and 0.8 <= signal_vs_expected <= 1.25),
            (f"q per m {rel_q:.3e}", rel_q <= TOL_PS),
            (f"chunk invariance {rel_chunk:.3e}", rel_chunk <= TOL_PS),
            ("Fisher matrix", symmetric),
            ("band powers", ps_ok),
            (f"peak {peak:.2f} GiB", peak < PEAK_LIMIT_GIB),
        ) if not ok
    ]
    if failures:
        raise RuntimeError(f"phase 15 (KL path) failed: {', '.join(failures)}")


def delay_telescope(ncyl: int = 4, nfeed: int = 256, nfreq: int = DELAY_NFREQ):
    """Phase 16's telescope: phase 7's dual-pol CHIME cylinder over 400-800 MHz (no beam transfer)."""
    from draco_tpu_torch.telescope import PolarisedCylinderTelescope

    return PolarisedCylinderTelescope(
        num_cylinders=ncyl, num_feeds=nfeed, num_freq=nfreq, freq_lower=400.0, freq_upper=800.0,
        auto_correlations=True, **CHIME,
    )


def delay_cuts(tel, pairs) -> np.ndarray:
    """``DelayFilter``'s horizon cut (us) of each feed pair at phase 16's ``delay_cut``."""
    from draco_tpu_torch.analysis.delay import C_US

    pos = tel.feedpositions
    return np.maximum(np.abs(pos[pairs[:, 0], 1] - pos[pairs[:, 1], 1]) / C_US, DELAY_CUT)


def _seed(*key) -> int:
    return int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])


def delay_stream(tel, prods, nra: int, device, noise_seed: int = 0, parts=("fg", "signal", "noise")):
    """A ``SiderealStream`` of the telescope's products ``prods`` [nfreq, len(prods), nra].

    Each product is made from its own seeds alone (so any subset is the same
    data): a foreground of ``DELAY_FG_MODES`` delays drawn inside 0.8 of its
    horizon cut, with amplitudes that vary smoothly over RA, at
    ``DELAY_FG_POWER`` x the signal's power; a white complex signal of
    variance ``DELAY_SIGNAL_VAR``; noise of variance ``DELAY_NOISE_VAR``
    (draw ``noise_seed``).  Every product has the flagged channels and RA
    samples at weight 0, with ``DELAY_RFI`` added to their data.
    """
    import torch

    from draco_tpu_torch.core import containers

    pairs = np.asarray(tel.uniquepairs)[prods]
    prod = np.empty(len(prods), dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = pairs.T
    ss = containers.SiderealStream(freq=tel.frequencies, ra=nra, input=tel.nfeed, prod=prod, device=device)
    w = ss.weight[:]
    w.fill_(1.0 / DELAY_NOISE_VAR)
    w[list(DELAY_FLAG_CHANNELS)] = 0.0
    w[:, :, list(DELAY_FLAG_RA)] = 0.0
    nu = torch.as_tensor(tel.frequencies, dtype=torch.float64, device=device)
    turns = torch.arange(nra, dtype=torch.float64, device=device) / nra
    cuts = delay_cuts(tel, pairs)
    gen = torch.Generator(device=device)
    vis = ss.vis[:]
    for j, p in enumerate(np.asarray(prods)):
        v = torch.zeros((tel.nfreq, nra), dtype=torch.complex64, device=device)
        if "fg" in parts:
            rng = np.random.Generator(np.random.SFC64(_seed(DELAY_SEED, int(p), 0)))
            tau = torch.as_tensor(rng.uniform(-0.8, 0.8, DELAY_FG_MODES) * cuts[j], device=device)
            amp = (rng.standard_normal(DELAY_FG_MODES) + 1j * rng.standard_normal(DELAY_FG_MODES)) * np.sqrt(
                DELAY_FG_POWER * DELAY_SIGNAL_VAR / (2 * DELAY_FG_MODES))
            phi = torch.as_tensor(rng.uniform(0, 2 * np.pi, DELAY_FG_MODES), device=device)
            ramp = torch.as_tensor(amp, device=device)[:, None] * (1 + 0.5 * torch.cos(2 * np.pi * turns[None] + phi[:, None]))
            v += (torch.exp(2j * np.pi * nu[:, None] * tau[None]) @ ramp).to(v.dtype)
        for part, var, seed in (("signal", DELAY_SIGNAL_VAR, _seed(DELAY_SEED, int(p), 1)),
                                ("noise", DELAY_NOISE_VAR, _seed(DELAY_SEED, int(p), 2, noise_seed))):
            if part in parts:
                gen.manual_seed(seed)
                v += np.sqrt(var / 2) * torch.view_as_complex(
                    torch.randn((tel.nfreq, nra, 2), generator=gen, device=device))
        vis[:, j] = v
    vis[list(DELAY_FLAG_CHANNELS)] += DELAY_RFI
    vis[:, :, list(DELAY_FLAG_RA)] += DELAY_RFI
    return ss


def stokes_members(tel) -> np.ndarray:
    """The stacks that ``StokesIVis`` sums."""
    from draco_tpu_torch.analysis.transform import stokes_I_index

    return stokes_I_index(tel)[0]


def delay_source_task() -> str:
    """Define phase 16's source task, ``EmitDelayStream``, in this module; return its path."""
    from draco_tpu_torch.core import config, io
    from draco_tpu_torch.core.task import ContainerTask, PipelineStopIteration
    from draco_tpu_torch.device import resolve

    class EmitDelayStream(ContainerTask):
        nra = config.int_prop(DELAY_NRA)

        def setup(self, tel):
            self.tel = io.get_telescope(tel)

        def process(self):
            if self._count:
                raise PipelineStopIteration()
            ss = delay_stream(self.tel, np.arange(self.tel.npairs), self.nra, resolve())
            ss.attrs["tag"] = "delay"
            return ss

    globals()["EmitDelayStream"] = EmitDelayStream
    return f"{__name__}.EmitDelayStream"


def delay_config(product_dir: str, source: str, nra: int) -> dict:
    """Phase 16: BASELINE.json config 3's chain with the source task in place of a file loader."""
    return {"pipeline": {"tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"], "params": {"product_directory": product_dir}},
        {"type": source, "requires": "tel", "out": "sstream", "params": {"nra": nra}},
        {"type": "draco.analysis.delay.DelayFilter", "requires": "tel", "in": "sstream", "out": "sstream_filt",
         "params": {"delay_cut": DELAY_CUT}},
        {"type": "draco.analysis.transform.StokesIVis", "requires": "tel", "in": "sstream_filt", "out": "sstream_I"},
        {"type": "draco.analysis.delay.DelayPowerSpectrumGibbsBatched", "in": "sstream_I", "out": "dspec",
         "params": {"nsamp": DELAY_NSAMP, "median_frac": 0.5, "seed": DELAY_SEED, "save_samples": True,
                    "save_spectrum_mask": True}},
    ]}}


def _subset_stream(like, vis, weight, stack):
    """A Stokes I stream like ``like`` holding the baselines ``stack`` with ``vis`` and ``weight``."""
    from draco_tpu_torch.core import containers

    out = containers.empty_like(like, stack=stack)
    out.vis[:], out.weight[:] = vis, weight
    return out


def run_delay(device, ncyl: int = 4, nfeed: int = 256, nfreq: int = DELAY_NFREQ, nra: int = DELAY_NRA,
              n_fg: int = N_DELAY_FG_CHECK, n_stokes: int = N_STOKES_CHECK) -> None:
    """Phase 16: BASELINE.json config 3 through the Manager, then its checks and the other estimators.

    The sizes default to the phase's; smaller ones make it a rehearsal on
    the CPU (with the flagged channels moved inside the band).
    """
    import pickle
    import tempfile

    import scipy.linalg as sla
    import torch

    from draco_tpu_torch.analysis import delay as tdelay
    from draco_tpu_torch.analysis.delayopt import LogLikePS, _windowed_projection
    from draco_tpu_torch.analysis.transform import stokes_I_index, stokes_I_sum
    from draco_tpu_torch.core.pipeline import Manager
    from draco_tpu_torch.ops import delay as dops
    from draco_tpu_torch.ops import filters

    def run(task, params, setup, *data):
        task.read_config(params)
        if setup:
            task.setup(*setup)
        return task, task.process(*data)

    failures = []

    def check(label, value, ok):
        log(f"  {label}: {value}  [{'ok' if ok else 'FAIL'}]")
        if not ok:
            failures.append(label)

    tel = delay_telescope(ncyl, nfeed, nfreq)
    freq = tel.frequencies
    log(f"delay path: {ncyl} x {nfeed} dual-pol feeds ({tel.nfeed} inputs), {tel.npairs} stacked products, "
        f"{nfreq} frequencies {freq[0]:.3f}-{freq[-1]:.3f} MHz (step {freq[1] - freq[0]:.6f}), {nra} RA samples; "
        f"visibilities {tel.npairs * nfreq * nra * 8 / 1e9:.2f} GB, weights {tel.npairs * nfreq * nra * 4 / 1e9:.2f} GB")

    torch.zeros(1, device=device)  # the allocator's statistics exist once the device is in use
    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as product_dir:
        with open(Path(product_dir) / "telescope.pkl", "wb") as f:
            pickle.dump(tel, f)
        manager = Manager(delay_config(product_dir, delay_source_task(), nra))
        t0 = time.perf_counter()
        products = manager.run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated(device) / 2**30
    timing = {name.split(".")[-1]: round(t["wall"], 4) for name, t in manager.task_timing.items()}
    log(f"delay path run: {wall:.2f} s wall, peak device memory {run_peak:.2f} GiB")
    log("delay path task_timing (s): " + json.dumps(timing))
    ss, sI, dspec = products["sstream"][0], products["sstream_I"][0], products["dspec"][0]
    if products["sstream_filt"][0] is not ss:
        failures.append("DelayFilter did not filter in place")
    del products
    ubase = sI.index_map["stack"]
    nbase = len(ubase)
    spec = dspec.spectrum[:]
    live = ~dspec.datasets["spectrum_mask"][:]
    gibbs_s = next(t for name, t in timing.items() if name.startswith("DelayPowerSpectrumGibbsBatched"))
    nlive, batch = int(live.sum()), dops.GIBBS_BATCH
    nchol = -(-nlive // batch) * batch * DELAY_NSAMP
    log(f"StokesIVis: {nbase} baselines ({nlive} with every pol product); Gibbs: {nlive} chains x {DELAY_NSAMP} "
        f"iterations in {gibbs_s:.2f} s = {nlive * DELAY_NSAMP / gibbs_s:.1f} iterations/s, {nchol / gibbs_s:.1f} "
        f"Cholesky factorisations/s of [{len(dspec.delay)}, {len(dspec.delay)}] (batch {batch}); "
        f"failed chains {dspec.attrs['gibbs_failed']}")
    # least times from the run's shapes: float32 operations over 67 TFLOP/s, bytes over 3.35 TB/s
    nd, nrow, ns = len(dspec.delay), 2 * (nfreq - len(DELAY_FLAG_CHANNELS)), nra - len(DELAY_FLAG_RA)
    step_flop = nd**3 / 3 + 2 * nd**2 * ns + 2 * ns * nrow * nd  # Cholesky, two triangular solves, FTNih (d + w2)
    gibbs_bound = nlive * (DELAY_NSAMP * step_flop + 2 * nrow * nd**2) / PEAK_FLOPS["float32"]
    ncopol = int(np.isin(np.arange(tel.npairs), stokes_members(tel)).sum())
    stokes_bound = (ncopol * 12 + nbase * 12) * nfreq * nra / HBM_BYTES_PER_S
    project_bound = max(8 * nfreq**2 * tel.npairs * nra / PEAK_FLOPS["float32"], 2 * 8 * tel.npairs * nfreq * nra / HBM_BYTES_PER_S)
    filter_s = next(t for name, t in timing.items() if name.startswith("DelayFilter"))
    stokes_s = next(t for name, t in timing.items() if name.startswith("StokesIVis"))
    log(f"bounds: Gibbs {gibbs_bound:.3f} s (operations; measured {gibbs_s / gibbs_bound:.1f}x), StokesIVis "
        f"{1e3 * stokes_bound:.2f} ms (bytes; {stokes_s / stokes_bound:.1f}x), the filter's products "
        f"{1e3 * project_bound:.1f} ms (operations; the task {filter_s:.2f} s)")

    # the filter: a foreground-only copy, the projectors, the SVD stage
    cuts_all = delay_cuts(tel, np.asarray(tel.uniquepairs))
    sample = np.unique(np.linspace(0, tel.npairs - 1, n_fg).astype(int))
    fg = delay_stream(tel, sample, nra, device, parts=("fg",))
    before = fg.vis[:].clone()
    _, fg = run(tdelay.DelayFilter(), {"delay_cut": DELAY_CUT}, (tel,), fg)
    keep = fg.weight[:] > 0
    fall = float((before[keep].abs().double() ** 2).sum() / (fg.vis[:][keep].abs().double() ** 2).sum())
    del before, fg, keep
    check(f"foreground-only power over the filtered ({len(sample)} products)", f"{fall:.3e} (limit >= {TOL_FILTER_FALL:.0e})",
          fall >= TOL_FILTER_FALL)
    mask = np.ones(nfreq)
    mask[list(DELAY_FLAG_CHANNELS)] = 0.0
    groups = np.unique(cuts_all)
    bandwidth = np.ptp(freq)
    t0 = _sync_clock(device)
    projs = {}
    for i, cut in enumerate(groups):
        P = filters.null_filter(freq, cut, mask, num_modes=tdelay._mode_count(bandwidth, cut), window=False, device=device)
        if i in (0, len(groups) // 2, len(groups) - 1):
            projs[float(cut)] = P
    svd_s = _sync_clock(device) - t0
    idem = max(((P @ P - P).abs().max() / P.abs().max()).item() for P in projs.values())
    # complex Householder bidiagonalisation of [m, k] and forming its U: about 2 x 4 (4 m k^2 - 4 k^3 / 3) flops
    ks = np.minimum([tdelay._mode_count(bandwidth, c) for c in groups], nfreq)
    svd_bound = float(np.sum(8 * (4 * nfreq * ks**2 - 4 * ks**3 / 3))) / PEAK_FLOPS["float64"]
    log(f"DelayFilter SVD stage: {len(groups)} (cut, mask) groups, {svd_s:.2f} s of null_filter "
        f"({1e3 * svd_s / len(groups):.1f} ms a group; modes {ks[0]}-{ks[-1]}); bound {1e3 * svd_bound:.1f} ms "
        f"(operations, float64)")
    check("projector idempotence max|PP - P| / max|P| (3 cuts)", f"{idem:.3e} (limit {TOL_IDEMPOTENT})", idem <= TOL_IDEMPOTENT)
    del projs, P

    # Stokes I against a float64 numpy segment sum of the filtered stream
    src, dst, _ = stokes_I_index(tel)
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=nbase)
    members = np.full((nbase, max(counts.max(), 1)), -1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for b in range(nbase):
        members[b, : counts[b]] = src[order[starts[b] : starts[b] + counts[b]]]
    rng = np.random.Generator(np.random.SFC64(DELAY_SEED))
    f_i, b_i, t_i = rng.integers(0, nfreq, n_stokes), rng.integers(0, nbase, n_stokes), rng.integers(0, nra, n_stokes)
    m = members[b_i]
    idx = [torch.as_tensor(a, device=device) for a in (f_i[:, None], np.maximum(m, 0), t_i[:, None])]
    for name, full, got in (("vis", ss.vis[:], sI.vis[:]), ("weight", ss.weight[:], sI.weight[:])):
        parts = full[idx[0], idx[1], idx[2]].cpu().numpy().astype(np.complex128 if full.is_complex() else np.float64)
        ref = (parts * (m >= 0)).sum(axis=1)
        out = got[tuple(torch.as_tensor(a, device=device) for a in (f_i, b_i, t_i))].cpu().numpy()
        err = np.abs(out - ref).max() / np.abs(ref).max()
        check(f"Stokes I {name} vs float64 numpy segment sum ({n_stokes} cells)", f"{err:.3e} (limit {TOL_STOKES})",
              err <= TOL_STOKES)
    del ss
    torch.cuda.empty_cache()

    # the spectra
    finite = bool(torch.isfinite(spec).all())
    check("Gibbs spectra finite; failed chains", f"{finite}; {dspec.attrs['gibbs_failed']} (limit 0)",
          finite and dspec.attrs["gibbs_failed"] == 0)
    N = len(dspec.delay)
    expect = (2 * DELAY_SIGNAL_VAR + 1.5 * DELAY_NOISE_VAR) / N
    bcut = np.maximum(np.abs(ubase[:, 1]) / tdelay.C_US, DELAY_CUT)
    above = np.abs(dspec.delay)[None, :] > 1.5 * bcut[:, None] + 0.02
    sel = above & live[:, None]
    rec = float(np.median(spec.cpu().numpy()[sel])) / expect
    check(f"recovery: median over {int(sel.sum())} above-cut cells of S / injected", f"{rec:.4f} (limits {DELAY_RECOVERY})",
          DELAY_RECOVERY[0] <= rec <= DELAY_RECOVERY[1])

    # the chain's inputs, as the batched task forms them
    delays, chans = tdelay._spectral_grid(freq, zero=freq[0], spacing=np.abs(np.diff(freq)).min(), nchan=None,
                                          skip_nyquist=True, complex_td=False)
    rows, wrows = sI.vis[:].permute(1, 2, 0), sI.weight[:].permute(1, 2, 0)  # [b, t, f] views
    nzt, fok, _ = tdelay._batch_cut_masks(wrows > 0, 0.0, 0.0)
    livei = np.flatnonzero(live)

    def inputs(bsel):
        d = tdelay._select(rows, bsel, nzt, fok)
        d = d - d.mean(dim=-2, keepdim=True)
        return d, tdelay._select(wrows, bsel, nzt, fok).mean(dim=-2)

    # the host float64 sampler on 4 baselines
    host = livei[np.linspace(0, len(livei) - 1, N_DELAY_HOST).astype(int)]
    d4, w4 = inputs(host)
    t0 = time.perf_counter()
    ratios = []
    for k, b in enumerate(host):
        draws, ok = dops.delay_power_spectrum_gibbs(
            d4[k].cpu().numpy().astype(np.complex128), N, w4[k].cpu().numpy().astype(np.float64), np.full(N, 10.0),
            window="nuttall", fsel=chans[fok], niter=DELAY_NSAMP, rng=np.random.Generator(np.random.SFC64(int(b))),
        )
        hs = np.fft.fftshift(np.median(draws[-DELAY_NSAMP // 2 :], axis=0))
        ratios.append(float(np.median(spec[b].cpu().numpy() / hs)) if ok else float("nan"))
    log(f"host float64 sampler: {N_DELAY_HOST} baselines in {time.perf_counter() - t0:.2f} s")
    check("median over delays of batched / host float64 chain (4 baselines)", f"{np.round(ratios, 4).tolist()} "
          f"(limit |r - 1| <= {TOL_DELAY_HOST})", all(abs(r - 1) <= TOL_DELAY_HOST for r in ratios))

    # one baseline alone against the same baseline inside a full batch
    nb = min(batch, len(livei))
    db, wb = inputs(livei[:nb])
    kw = dict(window="nuttall", fsel=chans[fok], niter=DELAY_NSAMP)
    S0 = np.full((nb, N), 10.0)
    full, _ = dops.delay_power_spectrum_gibbs_batched(db, N, wb, S0, seeds=list(range(nb)), **kw)
    k = nb // 2
    alone, _ = dops.delay_power_spectrum_gibbs_batched(db[k : k + 1], N, wb[k : k + 1], S0[:1], seeds=[k], **kw)
    same = bool(torch.equal(alone[:, 0], full[:, k]))
    check(f"baseline {k} alone vs inside a batch of {batch}: bit-identical samples", same, same)
    del d4, w4, db, wb, full, alone

    # the cross estimator on two noise draws of 16 baselines
    cross = livei[np.linspace(0, len(livei) - 1, N_DELAY_CROSS).astype(int)]
    mem = members[cross]
    prods = np.unique(mem[mem >= 0])
    local = {int(p): i for i, p in enumerate(prods)}
    lsrc = np.array([local[int(p)] for p in mem.ravel() if p >= 0])
    ldst = np.array([b for b, row in enumerate(mem) for p in row if p >= 0])
    datasets = []
    t0 = _sync_clock(device)
    for draw in (0, 1):
        small = delay_stream(tel, prods, nra, device, noise_seed=draw)
        _, small = run(tdelay.DelayFilter(), {"delay_cut": DELAY_CUT}, (tel,), small)
        vis = stokes_I_sum(small.vis[:], lsrc, ldst, len(cross))
        wgt = stokes_I_sum(small.weight[:], lsrc, ldst, len(cross))
        datasets.append(_subset_stream(sI, vis, wgt, ubase[cross]))
    same = _rel(datasets[0].vis[:], sI.vis[:][:, torch.as_tensor(cross, device=device)])
    check("the first draw's 16 baselines, filtered alone, vs the chain's Stokes I", f"{same:.3e} (limit 1e-5)", same <= 1e-5)
    task, xs = run(tdelay.DelayCrossPowerSpectrumEstimatorBatched(),
                   {"nsamp": DELAY_NSAMP, "median_frac": 0.5, "seed": DELAY_SEED}, (), *datasets)
    cross_s = _sync_clock(device) - t0
    xspec = xs.spectrum[:].cpu().numpy()
    aspec = spec.cpu().numpy()[cross]
    xa = above[cross]
    xr = [float(np.median(xspec[i, i][k][xa[k]] / aspec[k][xa[k]])) for i in (0, 1) for k in range(len(cross))]
    log(f"cross estimator: {len(cross)} baselines x 2 draws, {len(prods)} products filtered, {cross_s:.2f} s "
        f"(re-sampled in complex128: {xs.attrs['gibbs_resampled']})")
    check("cross autos / auto spectra above the cut (median a baseline)", f"{min(xr):.4f}-{max(xr):.4f} "
          f"(limit |r - 1| <= {TOL_DELAY_CROSS})", bool(np.isfinite(xspec).all()) and all(abs(r - 1) <= TOL_DELAY_CROSS for r in xr))
    del datasets, xs
    torch.cuda.empty_cache()

    # NRML on 4 baselines, and its likelihood against host float64 scipy
    nrml_b = livei[np.linspace(0, len(livei) - 1, N_DELAY_NRML).astype(int)]
    bsel = torch.as_tensor(nrml_b, device=device)
    sub = _subset_stream(sI, sI.vis[:].index_select(1, bsel), sI.weight[:].index_select(1, bsel), ubase[nrml_b])
    t0 = time.perf_counter()
    task, nr = run(tdelay.DelayPowerSpectrumNRML(), {"save_spectrum_mask": True}, (), sub)
    nrml_s = time.perf_counter() - t0
    block, w, f_keep, _ = task._trim_block(sub.vis[:][:, 0].T, sub.weight[:][:, 0].T)
    data, w = block.cpu().numpy().astype(np.complex128), w.cpu().numpy().astype(np.float64)
    proj, rws = _windowed_projection(N, chans[f_keep], "nuttall", data, w)
    X, Ninv = (rws.T @ rws.conj()) / data.shape[0], np.where(w > 0, 1.0 / np.where(w > 0, w, 1.0), 0.0)
    like = LogLikePS(X, proj, Ninv, data.shape[0], device=device)
    xs0 = np.log(np.full(N, expect))
    errs = []
    for x in (xs0, xs0 + 0.5 * np.sin(np.arange(N) / 7.0)):
        s = np.exp(x)
        C = (like.MF * s) @ like.MFT + np.diag(like.N)
        cf = sla.cho_factor(C)
        host_v = data.shape[0] * (2 * np.sum(np.log(np.diag(cf[0]).real)) + np.trace(sla.cho_solve(cf, like.X)).real)
        errs.append(abs(like.value(x) - host_v) / abs(host_v))
    log(f"NRML: {N_DELAY_NRML} baselines in {nrml_s:.2f} s, converged on {int((~nr.datasets['spectrum_mask'][:]).sum())}")
    check("NRML spectra finite; LogLikePS vs host float64 scipy", f"{bool(torch.isfinite(nr.spectrum[:]).all())}; "
          f"{max(errs):.3e} (limit {TOL_LOGLIKE})", bool(torch.isfinite(nr.spectrum[:]).all()) and max(errs) <= TOL_LOGLIKE)
    del sub, nr, like

    # the FFT estimator on every baseline
    t0 = _sync_clock(device)
    task, ft = run(tdelay.DelaySpectrumFFT(), {"complex_timedomain": True, "freq_frac": -1.0}, (), sI)
    fft_s = _sync_clock(device) - t0
    fspec = ft.spectrum[:]
    errs = []
    w_fft = tdelay.tools.window_generalised(np.arange(nfreq) / nfreq).numpy()
    for b in host:
        d = sI.vis[:][:, b].T.cpu().numpy().astype(np.complex128)[nzt]
        d = d - d.mean(axis=0)
        ref = np.fft.fftshift(np.fft.ifft(d * w_fft, axis=-1), axes=-1)
        errs.append(np.abs(fspec[b].cpu().numpy()[nzt] - ref).max() / np.abs(ref).max())
    log(f"DelaySpectrumFFT: {nbase} baselines x {nra} samples in {fft_s:.2f} s; output {tuple(fspec.shape)} {fspec.dtype}")
    check("FFT spectra finite; 4 baselines vs numpy float64", f"{bool(torch.isfinite(torch.view_as_real(fspec)).all())}; "
          f"{max(errs):.3e} (limit {TOL_DELAY_FFT})",
          bool(torch.isfinite(torch.view_as_real(fspec)).all()) and max(errs) <= TOL_DELAY_FFT)
    del ft, fspec
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"delay path peak device memory {peak:.2f} GiB (the Manager's run {run_peak:.2f} GiB)")
    if failures:
        raise RuntimeError(f"phase 16 (delay path) failed: {', '.join(failures)}")


def ring_telescope(ncyl: int = 4, nfeed: int = 256, nfreq: int = RING_NFREQ):
    """Phase 17's telescope: phase 7's dual-pol CHIME cylinder at ``nfreq`` channels of 390.625 kHz from 600 MHz."""
    from draco_tpu_torch.telescope import PolarisedCylinderTelescope

    return PolarisedCylinderTelescope(
        num_cylinders=ncyl, num_feeds=nfeed, num_freq=nfreq, freq_lower=RING_F0,
        freq_upper=RING_F0 + nfreq * RING_DF, auto_correlations=True, **CHIME,
    )


def ring_sources(nra: int, npix: int):
    """``RING_SOURCES`` on a grid of ``nra`` RA samples and ``npix`` elevation pixels."""
    return [(r * nra // RING_NRA, round(e * (npix - 1) / (RING_NPIX - 1)), a) for r, e, a in RING_SOURCES]


def ring_flux(k: int, freq, tone: bool) -> np.ndarray:
    """Source ``k``'s flux at ``freq`` (MHz): flat, or with 17b's delay tone."""
    flux = np.full(len(freq), ring_sources(RING_NRA, RING_NPIX)[k][2])
    src, nbin, rel = RING_TONE
    if tone and k == src:
        tau = nbin / (len(freq) * RING_DF)  # us: exactly a bin of the delay grid
        flux = flux * (1.0 + rel * np.cos(2 * np.pi * tau * (freq - freq[0])))
    return flux


def ring_flags(nfreq: int, nra: int):
    return [(f * nfreq // RING_NFREQ, r * nra // RING_NRA) for f, r in RING_FLAGS]


def ring_stream(tel, nra: int, npix: int, device, tone: bool = False):
    """A stacked ``SiderealStream`` of every unique pair, labelled as
    ``CollateProducts`` labels it (the full product triangle, its stack
    maps, input flags all 1).

    Each source is seen through the analytical EW beam that
    ``DeconvolveAnalyticalBeam`` deconvolves (``_get_beam_mmodes``): at
    feed-pair polarisation p, EW separation u (wavelengths) and the
    source's declination, ``conj(exp(2 pi i u cos(dec) sin(phi)) exp(-(2
    tan(phi / 2))^2 / 2 sigma_p^2))`` in its RA offset phi, times the NS
    fringe of its elevation pixel; noise of unit variance (the weights);
    the ``RING_FLAGS`` cells at weight 0 with ``RING_RFI`` added.
    """
    import torch

    from draco_tpu_torch.analysis.ringmapmaker import C_LIGHT, DeconvolveAnalyticalBeam, find_grid_indices
    from draco_tpu_torch.analysis.transform import TelescopeStreamMixIn
    from draco_tpu_torch.core import containers

    maps = TelescopeStreamMixIn()
    maps.setup(tel)
    ss = containers.SiderealStream(
        freq=tel.frequencies, ra=nra, input=tel.nfeed, prod=maps.bt_prod, stack=maps.bt_stack,
        reverse_map_stack=maps.bt_rev, device=device,
    )
    ss.input_flags[:] = 1.0
    pairs = np.asarray(tel.uniquepairs)
    feedpol = tel.polarisation[pairs]
    names, pidx = np.unique(np.char.add(feedpol[:, 0], feedpol[:, 1]), return_inverse=True)
    prefactor = np.array([[DeconvolveAnalyticalBeam._EW_SIGMA_PREFACTOR[c] for c in p] for p in names])
    xind, yind, min_x, min_y = find_grid_indices(tel.baselines)
    el = np.linspace(-1.0, 1.0, npix)
    phi = np.radians(np.linspace(0.0, 360.0, nra, endpoint=False))
    pidx_t = torch.as_tensor(pidx, device=device)
    xpos = torch.as_tensor(xind * min_x, dtype=torch.float64, device=device)[:, None]
    ypos = torch.as_tensor(yind * min_y, dtype=torch.float64, device=device)[:, None]
    gen = torch.Generator(device=device)
    gen.manual_seed(RING_SEED)
    vis = ss.vis[:]
    for fi, f in enumerate(tel.frequencies):
        nu = f * 1e6 / C_LIGHT
        acc = torch.zeros((len(pairs), nra), dtype=torch.complex128, device=device)
        for k, (r0, e0, _) in enumerate(ring_sources(nra, npix)):
            dec = np.arcsin(el[e0]) + np.radians(tel.latitude)
            sa, sb = (prefactor[:, i] / (f * np.cos(dec)) for i in (0, 1))
            sigma = sa * sb / np.hypot(sa, sb)  # [pol]
            dphi = phi - phi[r0]
            env = np.exp(-0.5 * (2 * np.tan(dphi / 2)) ** 2 / sigma[:, None] ** 2)  # [pol, ra]
            ew = torch.as_tensor(-2 * np.pi * nu * np.cos(dec) * np.sin(dphi), device=device)[None] * xpos
            arg = ew + 2 * np.pi * nu * el[e0] * ypos
            amp = ring_flux(k, tel.frequencies, tone)[fi]
            acc += amp * torch.as_tensor(env, device=device)[pidx_t] * torch.polar(torch.ones_like(arg), arg)
        noise = torch.randn((len(pairs), nra, 2), generator=gen, device=device, dtype=torch.float64)
        vis[fi] = acc + np.sqrt(0.5) * torch.view_as_complex(noise)
    w = ss.weight[:]
    w.fill_(1.0)
    for fi, ri in ring_flags(tel.nfreq, nra):
        w[fi, :, ri] = 0.0
        vis[fi, :, ri] += RING_RFI
    return ss


def ring_tasks() -> tuple[str, str]:
    """Define phase 17's source task ``EmitRingStream`` and the delay filter's
    stand-in ``AttachDelayFilterModel`` in this module; return their paths."""
    import torch

    from draco_tpu_torch.core import config, containers, io
    from draco_tpu_torch.core.task import ContainerTask, PipelineStopIteration
    from draco_tpu_torch.device import resolve
    from draco_tpu_torch.ops.tools import invert_no_zero

    class EmitRingStream(ContainerTask):
        nra = config.int_prop(RING_NRA)
        npix = config.int_prop(RING_NPIX)
        tone = config.bool_prop(False)

        def setup(self, tel):
            self.tel = io.get_telescope(tel)

        def process(self):
            if self._count:
                raise PipelineStopIteration()
            ss = ring_stream(self.tel, self.nra, self.npix, resolve(), tone=self.tone)
            ss.attrs["tag"] = "ringmap"
            return ss

    class AttachDelayFilterModel(ContainerTask):
        """Stands in for the delay filter, which is not ported yet: on a hybrid
        stream an identity spectral filter and the freq-freq covariance of its
        weights (diagonal); on a ring map the covariance alone, as the identity
        (a diagonal covariance cancels in the Wiener operator's noise term)."""

        def process(self, data):
            dev = data.weight[:].device
            eye = torch.eye(len(data.freq), dtype=torch.float64, device=dev)
            if isinstance(data, containers.HybridVisStream):
                data.add_dataset("filter")
                data.filter[:] = eye[None, :, :, None, None]
                data.add_dataset("freq_cov")
                data.freq_cov[:] = eye[None, :, :, None, None] * invert_no_zero(data.weight[:].double())[:, :, None]
            elif "freq_cov" not in data.datasets:
                data.add_dataset("freq_cov")
                data.freq_cov[:] = eye[None, :, :, None]
            return data

    globals()["EmitRingStream"] = EmitRingStream
    globals()["AttachDelayFilterModel"] = AttachDelayFilterModel
    return f"{__name__}.EmitRingStream", f"{__name__}.AttachDelayFilterModel"


def ring_config(product_dir: str, source: str, attach: str, chain: str, nra: int, npix: int) -> dict:
    """Phase 17a (``examples/ringmap.yaml`` with ``ApplyTimeFreqMask``) or 17b."""
    head = [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"], "params": {"product_directory": product_dir}},
        {"type": source, "requires": "tel", "out": "sstream", "params": {"nra": nra, "npix": npix, "tone": chain == "b"}},
    ]
    if chain == "a":
        return {"pipeline": {"tasks": head + [
            {"type": "draco.analysis.flagging.RFIMask", "in": "sstream", "out": "sstream_rfi"},
            {"type": "draco.analysis.flagging.ApplyTimeFreqMask", "in": ["sstream", "sstream_rfi"],
             "out": "sstream_masked"},
            {"type": "draco.analysis.ringmapmaker.RingMapMaker", "requires": "tel", "in": "sstream_masked",
             "out": "ringmap", "params": {"npix": npix, "weight": "natural"}},
        ]}}
    rmm, ps = "draco.analysis.ringmapmaker.", "draco.analysis.powerspec."
    return {"pipeline": {"tasks": head + [
        {"type": rmm + "MakeVisGrid", "requires": "tel", "in": "sstream", "out": "grid"},
        {"type": rmm + "BeamformNS", "in": "grid", "out": "hstream",
         "params": {"npix": npix, "span": 1.0, "weight": "natural", "precision": 64}},
        {"type": attach, "in": "hstream", "out": "hstream_filt"},
        {"type": "draco.analysis.transform.MModeTransform", "in": "hstream_filt", "out": "hmodes"},
        {"type": rmm + "WienerRingMapMakerAnalytical", "requires": "tel", "in": "hmodes", "out": "rmap",
         "params": {"save_dirty_beam": True}},
        {"type": rmm + "RADependentWeights", "in": ["hstream_filt", "rmap"], "out": "rmap_ra"},
        {"type": attach, "in": "rmap_ra", "out": "rmap_cov"},
        {"type": ps + "TransformJyPerBeamToKelvin", "requires": "tel", "in": "rmap_cov", "out": "rmap_k"},
        {"type": ps + "ConstructWienerDelayTransform", "in": "rmap_k", "out": "dop"},
        {"type": ps + "ApplyWienerDelayTransform", "in": ["rmap_k", "dop"], "out": "dtrans"},
        {"type": ps + "SpatialTransformDelayMap", "requires": "tel", "in": "dtrans", "out": "cube"},
        {"type": ps + "AutoPowerSpectrum3D", "in": "cube", "out": "ps3d"},
        {"type": ps + "CylindricalPowerSpectrum2D", "in": "ps3d", "out": "ps2d"},
        {"type": ps + "SphericalPowerSpectrum3Dto1D", "in": "ps3d", "out": "ps1d"},
    ]}}


def ring_host_beamform(tel, ss, fi: int, ra_sel, npix: int):
    """One frequency and the RA samples ``ra_sel`` of ``MakeVisGrid`` ->
    ``BeamformNS`` (natural, precision 64) -> ``BeamformEW`` in float64 numpy
    on the host: the JAX package's math written out.  Returns (map [beam,
    pol, ra, el], weight [pol, ra])."""
    from draco_tpu_torch.analysis.ringmapmaker import C_LIGHT, find_grid_indices

    vis = ss.vis[fi].cpu().numpy()[:, ra_sel].astype(np.complex128)  # [stack, ra]
    w = ss.weight[fi].cpu().numpy()[:, ra_sel].astype(np.float64)
    nstack = vis.shape[0]
    rev = np.asarray(ss.reverse_map["stack"]["stack"]).astype(int)
    red = np.bincount(rev[rev < nstack], minlength=nstack).astype(np.float64)  # input flags all 1

    feedpol = tel.polarisation[tel.uniquepairs]
    pol, pind = np.unique(np.char.add(feedpol[:, 0], feedpol[:, 1]), return_inverse=True)
    pconj = np.unique([b + a for a, b in pol], return_inverse=True)[1]
    xind, yind, _, min_y = find_grid_indices(tel.baselines)
    nx, ny, nr = np.abs(xind).max() + 1, 2 * np.abs(yind).max() + 1, vis.shape[1]
    G = np.zeros((4, nx, ny, nr), complex)
    W = np.zeros((4, nx, ny, nr))
    R = np.zeros((4, nx, ny))
    intra = np.flatnonzero(xind == 0)
    for p, x, y, src, conj in ((pconj[pind[intra]], xind[intra], -yind[intra], intra, True),
                               (pind, xind, yind, np.arange(nstack), False)):
        G[p, x, y] = np.conj(vis[src]) if conj else vis[src]
        W[p, x, y] = w[src]
        R[p, x, y] = red[src]

    def inv(a):
        return np.where(a == 0, 0.0, 1.0 / np.where(a == 0, 1.0, a))

    gw = R[..., None] * (W > 0)
    gw[:, 0, 0] = 0.0  # include_auto False
    gw = gw * inv(gw.sum(axis=2, keepdims=True))
    nspos = np.fft.fftfreq(ny, d=1.0 / (ny * min_y))
    el = np.linspace(-1.0, 1.0, npix)
    F = np.exp(-2j * np.pi * nspos[None, :] * el[:, None] * tel.frequencies[fi] * 1e6 / C_LIGHT)
    H = np.einsum("en,pxnr->pxer", F, G * gw)
    hw = inv(np.sum(inv(W) * gw**2, axis=2))  # [pol, x, ra]

    P = np.eye(4, dtype=complex)  # XX, (XY, YX) -> (reXY, imXY), YY
    P[1, 1:3], P[2, 1:3] = [0.5, 0.5], [-0.5j, 0.5j]
    wew = (nx - np.arange(nx)).astype(float)
    wew /= wew.sum()
    B = np.fft.irfft(np.tensordot(P, H, axes=(1, 0)) * wew[None, :, None, None], n=2 * nx - 1, axis=1) * (2 * nx - 1)
    var = np.tensordot(np.abs(P) ** 2, inv(hw), axes=(1, 0))
    rm_var = 0.5 * np.sum(wew[None, :, None] ** 2 * var, axis=1)  # [pol, ra]
    return B.transpose(1, 0, 3, 2), inv(rm_var)


def ring_bounds(nstack, nfreq, nra, nx, ny, nel, ntau, nm, npol=4):
    """Least seconds of each stage from its shapes: (seconds, "bytes" or "operations")."""
    bw = HBM_BYTES_PER_S
    f64 = PEAK_FLOPS["float64"]
    grid, hyb = npol * nfreq * nx * ny * nra, npol * nfreq * nx * nel * nra
    nbeam = 2 * nx - 1
    out = {
        # read the stream (vis 8 B, weight 4 B), write the grid
        "MakeVisGrid": (12 * nstack * nfreq * nra + 12 * grid, "bytes"),
        # the complex128 GEMM [el, ns] x [ns, ra] for every (pol, freq, ew)
        "BeamformNS": (8 * nel * ny * nra * npol * nfreq * nx, "operations"),
        # read the hybrid stream, write the map and its weight
        "BeamformEW": (8 * hyb + 8 * nbeam * npol * nfreq * nra * nel + 8 * npol * nfreq * nra * nel, "bytes"),
        "MModeTransform": (8 * hyb + 8 * 2 * nm * npol * nfreq * nx * nel, "bytes"),
        # write the beam m-modes, read them and the data m-modes, write the map and weight
        "WienerRingMapMakerAnalytical": (3 * 8 * 2 * nm * npol * nfreq * nx * nel + 16 * npol * nfreq * nra * nel,
                                         "bytes"),
        # per (pol, el, ra): two complex products of [f, f], the inverse, [tau, f] x [f, f] twice
        "ConstructWienerDelayTransform": (npol * nel * nra * (8 * (3 * nfreq**3) + 16 * ntau * nfreq**2), "operations"),
        # read the complex64 operator and the map
        "ApplyWienerDelayTransform": (8 * npol * nra * nel * ntau * nfreq + 16 * npol * nfreq * nra * nel, "bytes"),
        "SpatialTransformDelayMap": (2 * 16 * npol * ntau * nra * nel, "bytes"),
        "AutoPowerSpectrum3D": (16 * npol * ntau * nra * nel + 16 * npol**2 * ntau * nra * nel, "bytes"),
    }
    out = {name: (v / (bw if kind == "bytes" else f64), kind) for name, (v, kind) in out.items()}
    parts = [out[name] for name in ("MakeVisGrid", "BeamformNS", "BeamformEW")]
    out["RingMapMaker"] = (sum(t for t, _ in parts), "+".join(kind for _, kind in parts))
    return out


def _run_twice(label: str, cfg: dict, device):
    """Run ``cfg`` through the Manager twice; print each run's per-task seconds,
    wall time and peak device memory; return the second run's products,
    timing and peak."""
    import gc

    import torch

    from draco_tpu_torch.core.pipeline import Manager

    products = None
    for attempt in ("first", "second"):
        products = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        manager = Manager(cfg)
        t0 = _sync_clock(device)
        products = manager.run()
        wall = _sync_clock(device) - t0
        peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else float("nan")
        timing = {name.split(".")[-1]: round(t["wall"], 4) for name, t in manager.task_timing.items()}
        log(f"phase {label} {attempt} run: {wall:.2f} s wall, peak device memory {peak:.2f} GiB")
        log(f"phase {label} {attempt} run task_timing (s): " + json.dumps(timing))
    return products, timing, peak


def run_ringmap(device, ncyl: int = 4, nfeed: int = 256, nfreq: int = RING_NFREQ, nra: int = RING_NRA,
                npix: int = RING_NPIX) -> None:
    """Phase 17: the ring-map path (17a) and the deconvolving and power-spectrum chain (17b) through the Manager.

    The sizes default to the phase's; smaller ones make it a rehearsal on the
    CPU.  At 4 x 4 feeds with 4096 RA samples and npix 64 every check holds
    but the deconvolved amplitude's (1.3e-2: with 4 feeds a cylinder the
    sources' sidelobes reach each other's pixels); with fewer RA samples
    ``RFIMask`` also flags the bright sources' transits (too sharp for its
    3-sample median).
    """
    import gc
    import pickle
    import tempfile

    import torch

    from draco_tpu_torch.analysis.powerspec import jy_per_beam_to_kelvin
    from draco_tpu_torch.analysis.ringmapmaker import WienerRingMapMakerAnalytical, find_grid_indices
    from draco_tpu_torch.core import containers

    failures = []

    def check(label, value, ok):
        log(f"  {label}: {value}  [{'ok' if ok else 'FAIL'}]")
        if not ok:
            failures.append(label)

    tel = ring_telescope(ncyl, nfeed, nfreq)
    freq = tel.frequencies
    nstack = tel.npairs
    xind, yind, _, _ = find_grid_indices(tel.baselines)
    nx, ny = np.abs(xind).max() + 1, 2 * np.abs(yind).max() + 1
    nm, ntau = nra // 2 + 1, nfreq // 2
    GB = 1e9
    log(f"ring-map path: {ncyl} x {nfeed} dual-pol feeds, {nstack} stacked products, {nfreq} channels "
        f"{freq[0]:.6f}-{freq[-1]:.6f} MHz, {nra} RA samples, npix {npix}; stream {12 * nstack * nfreq * nra / GB:.2f} "
        f"GB, grid [4, {nfreq}, {nx}, {ny}, {nra}] {12 * 4 * nfreq * nx * ny * nra / GB:.2f} GB, hybrid "
        f"{8 * 4 * nfreq * nx * npix * nra / GB:.2f} GB, ring map [{2 * nx - 1}, 4, {nfreq}, {nra}, {npix}] "
        f"{8 * (2 * nx - 1) * 4 * nfreq * nra * npix / GB:.2f} GB, m-modes {8 * 2 * nm * 4 * nfreq * nx * npix / GB:.2f} "
        f"GB, Wiener operator {8 * 4 * nra * npix * ntau * nfreq / GB:.2f} GB")
    bounds = ring_bounds(nstack, nfreq, nra, nx, ny, npix, ntau, nm)
    sources = ring_sources(nra, npix)
    el = np.linspace(-1.0, 1.0, npix)

    with tempfile.TemporaryDirectory() as product_dir:
        with open(Path(product_dir) / "telescope.pkl", "wb") as f:
            pickle.dump(tel, f)
        source, attach = ring_tasks()

        # 17a: examples/ringmap.yaml with ApplyTimeFreqMask
        products, timing_a, peak_a = _run_twice("17a", ring_config(product_dir, source, attach, "a", nra, npix), device)
        ss, mask, rm = products["sstream_masked"][0], products["sstream_rfi"][0], products["ringmap"][0]
        del products
        masked = np.asarray(mask.mask[:])
        check("17a every injected cell masked", f"{sum(bool(masked[f, r]) for f, r in ring_flags(nfreq, nra))} of "
              f"{len(RING_FLAGS)} (masked share {masked.mean():.4f})",
              all(masked[f, r] for f, r in ring_flags(nfreq, nra)))
        shape = (2 * nx - 1, 4, nfreq, nra, npix)
        ok = isinstance(rm, containers.RingMap) and tuple(rm.map.shape) == shape and bool(torch.isfinite(rm.map[:]).all())
        check("17a ring map type, shape, finite", f"{type(rm).__name__} {tuple(rm.map.shape)}", ok)
        fi = nfreq // 2
        r0 = sources[0][0]
        ra_sel = (r0 - N_RING_HOST // 2 + np.arange(N_RING_HOST)) % nra
        t0 = time.perf_counter()
        hmap, hweight = ring_host_beamform(tel, ss, fi, ra_sel, npix)
        sel = torch.as_tensor(ra_sel, device=rm.map[:].device)
        got = rm.map[:, :, fi].index_select(2, sel).cpu().numpy()
        gotw = rm.weight[:, fi].index_select(1, sel)[..., 0].cpu().numpy()
        err = np.abs(got - hmap).max() / np.abs(hmap).max()
        errw = np.abs(gotw - hweight).max() / np.abs(hweight).max()
        check(f"17a ring map at channel {fi}, {N_RING_HOST} RA samples vs float64 numpy on the host "
              f"({time.perf_counter() - t0:.1f} s)", f"map {err:.3e}, weight {errw:.3e} (limit {TOL_RING_HOST})",
              err <= TOL_RING_HOST and errw <= TOL_RING_HOST)
        half = npix // 5  # under half the NS grating-lobe spacing of 0.5 m feeds
        for k, (r0, e0, flux) in enumerate(sources):
            worst = 0
            rows = (r0 + np.arange(-nra // 16, nra // 16 + 1)) % nra
            cols = np.arange(max(e0 - half, 0), min(e0 + half + 1, npix))
            for p in (0, 3):  # XX, YY
                block = rm.map[0, p].index_select(1, torch.as_tensor(rows, device=device))
                block = block.index_select(2, torch.as_tensor(cols, device=device)).cpu().numpy()  # [freq, ra, el]
                for f in range(nfreq):
                    ir, ie = np.unravel_index(np.argmax(block[f]), block[f].shape)
                    worst = max(worst, abs(rows[ir] - r0), abs(cols[ie] - e0))
            check(f"17a source {k} (RA sample {r0}, el {el[e0]:.4f}, flux {flux:g}) peak offset over freq, XX/YY",
                  f"{worst} pixels (limit 1)", worst <= 1)
        del ss, mask, rm
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # 17b: the deconvolving and power-spectrum chain
        products, timing_b, peak_b = _run_twice("17b", ring_config(product_dir, source, attach, "b", nra, npix), device)

    want = {
        "sstream": (containers.SiderealStream, "vis", (nfreq, nstack, nra)),
        "grid": (containers.VisGridStream, "vis", (4, nfreq, nx, ny, nra)),
        "hstream": (containers.HybridVisStream, "vis", (4, nfreq, nx, npix, nra)),
        "hmodes": (containers.HybridVisMModes, "vis", (nm, 2, 4, nfreq, nx, npix)),
        "rmap_k": (containers.RingMap, "map", (1, 4, nfreq, nra, npix)),
        "dop": (containers.DelayTransformOperator, "filter", (4, nra, npix, ntau, nfreq)),
        "dtrans": (containers.DelayTransform, "spectrum", (4 * npix, nra, ntau)),
        "cube": (containers.SpatialDelayCube, "vis", (4, ntau, nra, npix)),
        "ps3d": (containers.PowerSpectrum3D, "spectrum", (16, ntau, nra, npix)),
    }
    for label, (cls, name, shp) in want.items():
        cont = products[label][0]
        data = cont.datasets[name][:]
        ok = isinstance(cont, cls) and tuple(data.shape) == shp and bool(torch.isfinite(torch.view_as_real(data)
                                                                                          if data.is_complex() else data).all())
        check(f"17b {label} type, shape, finite", f"{type(cont).__name__}.{name} {tuple(data.shape)}", ok)
    ps2d, ps1d = products["ps2d"][0], products["ps1d"][0]
    live = ps2d.weight[:] > 0
    s2 = ps2d.spectrum[:]
    check("17b 2D spectrum finite where its bins hold cells", f"{int(live.sum())} of {live.numel()} bins hold cells",
          bool(live.any()) and bool(torch.isfinite(torch.view_as_real(s2[live])).all()))
    filled = torch.isfinite(ps1d.neff[:]) & (ps1d.neff[:] > 0)
    check("17b 1D spectrum finite where its bins hold cells", f"{int(filled.sum())} of {filled.numel()} bins hold cells",
          bool(filled.any()) and bool(torch.isfinite(torch.view_as_real(ps1d.spectrum[:][filled])).all()))
    check("17b Wiener operator inverses", f"{4 * npix * nra} (pol, el, RA) matrices of [{nfreq}, {nfreq}], every info 0",
          True)

    # a point source of flux A reads A times the dirty beam at transit (_deconvolve_core's normalisation)
    rmap = products["rmap_k"][0]
    factor = jy_per_beam_to_kelvin(freq, _bl_max(tel))
    worst, peaks = 0.0, []
    for k, (r0, e0, _) in enumerate(sources):
        flux = ring_flux(k, freq, tone=True)
        amp = rmap.map[0, :, :, r0, e0].cpu().numpy() / factor[None]  # [pol, freq], back to Jy/beam
        beam0 = rmap.dirty_beam[0, :, :, 0, e0].cpu().numpy()
        peaks.append(beam0)
        dev = np.abs(amp / (flux[None] * beam0) - 1)
        log(f"  17b source {k}: deconvolved over flux x dirty beam - 1, max over channels per pol {dev.max(axis=1)}")
        worst = max(worst, float(dev.max()))
    peaks = np.concatenate(peaks)
    check("17b deconvolved map at the sources' pixels over flux x the dirty beam at transit, every pol and "
          f"channel (- 1; the dirty beam there {peaks.min():.4f}-{peaks.max():.4f})",
          f"{worst:.3e} (limit {TOL_RING_AMP})", worst <= TOL_RING_AMP)
    maker = WienerRingMapMakerAnalytical()
    maker.read_config({})
    maker.setup(tel)
    t0 = _sync_clock(device)
    beam = maker._get_beam_mmodes(products["hmodes"][0])
    beam_s = _sync_clock(device) - t0
    beam_bytes = beam.vis[:].numel() * beam.vis[:].element_size()
    del beam
    log(f"17b analytical beam m-modes alone: {beam_s:.4f} s against {1e3 * beam_bytes / HBM_BYTES_PER_S:.2f} ms "
        f"(bytes: writing {beam_bytes / 1e9:.2f} GB)")

    src, nbin, _ = RING_TONE
    r0, e0, _ = sources[src]
    spec = products["dtrans"][0].spectrum[e0, r0].abs().cpu().numpy() ** 2  # pol XX is baselines 0..npix-1
    others = np.delete(spec, [0, nbin])
    contrast = spec[nbin] / others.max()
    check(f"17b delay tone: power at delay bin {nbin} over the largest other nonzero bin", f"{contrast:.3e} (limit "
          f">= {RING_TONE_CONTRAST})", contrast >= RING_TONE_CONTRAST)
    del products, rmap
    gc.collect()

    for label, timing in (("17a", timing_a), ("17b", timing_b)):
        parts = []
        for name, t in timing.items():
            key = next((b for b in bounds if name.startswith(b)), None)
            if key is not None:
                bound, kind = bounds[key]
                parts.append(f"{key} {t:.3f} s against {1e3 * bound:.2f} ms ({kind}; {t / bound:.0f}x)")
        log(f"phase {label} bounds: " + "; ".join(parts))
    log(f"phase 17 Manager peaks: 17a {peak_a:.2f} GiB, 17b {peak_b:.2f} GiB")
    if failures:
        raise RuntimeError(f"phase 17 (ring-map path) failed: {', '.join(failures)}")


def stack_catalog(tel, nsrc: int, ninj: int, nfreq: int, seed: int = STACK_SEED):
    """Phase 18's catalogue in ICRS: ``ninj`` sources at RA 1 + 15 k deg, 3-4
    deg north and south of the zenith's declination in turn (so that each
    one's neighbours, 15 deg away, are 8.5 deg off the zenith while it
    transits: 1e-2 of their flux is left there), the ones the day streams
    carry; and the others at RA 251-336 deg, 25 deg or more from every
    injected one (an injected source 21 deg of hour angle off transit keeps
    1e-7 of its flux), at any declination within 15 deg of the zenith's;
    redshifts put every 21 cm line in the band.  Returns (ra, dec, z), each
    [nsrc]."""
    rng = np.random.Generator(np.random.SFC64(seed))
    ra = rng.uniform(251.0, 336.0, nsrc)
    dec = tel.latitude + rng.uniform(-15.0, 15.0, nsrc)
    k = np.arange(ninj)
    ra[:ninj] = 1.0 + 15.0 * k
    dec[:ninj] = tel.latitude + np.array([-4.0, 4.0, -3.0, 3.0])[k % 4]
    f = tel.frequencies
    df = abs(f[1] - f[0]) if nfreq > 1 else 0.390625
    line = rng.uniform(f.min() + df, f.max() - df, nsrc)
    return ra, dec, STACK_NU21 / line - 1.0


def stack_epoch(tel, ndays: int) -> float:
    """Unix epoch of the stack's mean LSD, where ``BeamFormCat`` precesses the catalogue."""
    return float(tel.lsd_to_unix(np.mean(LSD + np.arange(ndays))))


def stack_pol_index(tel, prodstack) -> np.ndarray:
    """Index into (XX, XY, YX, YY) of each stack, as ``BeamFormBase`` labels them."""
    pol = np.asarray(tel.polarisation)
    pair = np.char.add(pol[prodstack["input_a"].astype(int)], pol[prodstack["input_b"].astype(int)])
    return np.array([["XX", "XY", "YX", "YY"].index(p) for p in pair])


def stack_beams(tel, dec, ha) -> np.ndarray:
    """Primary-beam power [pol, freq, len(ha)] of (XX, XY, YX, YY) at declination
    ``dec`` along hour angles ``ha`` (radians), as ``BeamFormBase._beamfunc``
    forms it from ``beam_at``."""
    pol = list(np.asarray(tel.polarisation))
    feed = {"X": pol.index("X"), "Y": pol.index("Y")}
    angpos = np.stack([(0.5 * np.pi - dec) * np.ones_like(ha), ha], axis=-1)
    out = np.zeros((4, tel.nfreq, ha.size))
    for fi in range(tel.nfreq):
        b = {p: np.atleast_2d(tel.beam_at(feed[p], fi, angpos)) for p in "XY"}
        for k, pp in enumerate(("XX", "XY", "YX", "YY")):
            out[k, fi] = np.sum(b[pp[0]] * b[pp[1]].conj(), axis=-1).real
    return out


def stack_files(ntime: int, pad: int, ndays: int):
    """Sample ranges [k0, k1) of the day-stream files on the grid lsd = LSD + k / ntime:
    a boundary file of 2 ``pad`` samples at every day boundary, and each day's
    remaining samples in two halves.  ``SiderealGrouper`` joins a day from its
    halves and the boundary files on either side, ``pad`` samples beyond the
    day at each end (the regridder needs the day's ends inside the samples)."""
    files = [(-pad, pad)]
    for d in range(ndays):
        lo, mid, hi = d * ntime + pad, d * ntime + ntime // 2, (d + 1) * ntime - pad
        files += [(lo, mid), (mid, hi), (hi, hi + 2 * pad)]
    return files


def stack_day_file(tel, maps, k0: int, k1: int, ntime: int, sources, device, seed: int):
    """One file of phase 18's day streams: unit complex noise (weights 1) drawn
    on the card from ``seed``, three flagged cells with interference, and the
    point sources ``sources`` [(ra, dec CIRS deg, flux)] seen through the
    telescope's own beam within 20 deg of transit: ``flux * pb * exp(2 pi i
    d)``, with pb and d as ``BeamFormCat`` forms them."""
    import torch

    from draco_tpu_torch.core import containers

    lsd = LSD + np.arange(k0, k1) / ntime
    ts = containers.TimeStream(
        freq=tel.frequencies, input=tel.nfeed, prod=maps.bt_prod, stack=maps.bt_stack,
        reverse_map_stack=maps.bt_rev, time=tel.lsd_to_unix(lsd), device=device,
    )
    ts.input_flags[:] = 1.0
    vis, weight = ts.vis[:], ts.weight[:]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    torch.randn(vis.shape + (2,), generator=gen, device=device, out=torch.view_as_real(vis))
    vis.mul_(np.sqrt(0.5))
    weight.fill_(1.0)
    rng = np.random.Generator(np.random.SFC64(seed))
    for _ in range(3):
        f, s, t = rng.integers(0, vis.shape[0]), rng.integers(0, vis.shape[1]), rng.integers(0, vis.shape[2])
        weight[f, s, t] = 0.0
        vis[f, s, t] += STACK_RFI

    ps = ts.prodstack
    pidx = torch.as_tensor(stack_pol_index(tel, ps), device=device)
    pos = tel.feedpositions
    bl = pos[ps["input_a"].astype(int)] - pos[ps["input_b"].astype(int)]  # [stack, 2] m
    nu = tel.frequencies * 1e6 / STACK_C
    u = torch.as_tensor(nu[:, None] * bl[None, :, 0], device=device)
    v = torch.as_tensor(nu[:, None] * bl[None, :, 1], device=device)
    lat = np.radians(tel.latitude)
    lst = 360.0 * np.mod(lsd, 1.0)
    for ra_s, dec_s, flux in sources:
        ha = np.radians((lst - ra_s + 180.0) % 360.0 - 180.0)
        sel = np.flatnonzero(np.abs(ha) <= np.radians(STACK_INJECT_HA))
        if sel.size == 0:
            continue
        h, dec = ha[sel], np.radians(dec_s)
        a = torch.as_tensor(np.cos(dec) * np.sin(h), device=device)
        b = torch.as_tensor(np.cos(lat) * np.sin(dec) - np.sin(lat) * np.cos(dec) * np.cos(h), device=device)
        d = u[:, :, None] * a + v[:, :, None] * b  # [freq, stack, t] turns
        pb = torch.as_tensor(stack_beams(tel, dec, h), device=device)[pidx].transpose(0, 1)  # [freq, stack, t]
        tsel = torch.as_tensor(sel, device=device)
        add = torch.polar(flux * pb, 2 * np.pi * (d - torch.round(d)))
        vis.index_add_(2, tsel, add.to(vis.dtype))
        del d, pb, add
    return ts


def take_rows(x, f, s) -> np.ndarray:
    """``x[f, s]`` on the host; a uint16 tensor is read through its int16
    view, as CUDA indexes no uint16."""
    import torch

    if x.dtype == torch.uint16:
        return x.view(torch.int16)[f, s].cpu().numpy().view(np.uint16)
    return x[f, s].cpu().numpy()


def stacking_tasks() -> dict:
    """Define phase 18's source tasks (the day streams and the catalogue) and
    its probes in this module; return their task paths."""
    import torch

    from draco_tpu_torch.analysis.beamform import icrs_to_cirs
    from draco_tpu_torch.analysis.transform import TelescopeStreamMixIn
    from draco_tpu_torch.core import config, containers, io
    from draco_tpu_torch.core.task import ContainerTask, PipelineStopIteration
    from draco_tpu_torch.device import resolve

    class EmitDayStream(ContainerTask):
        """The day-stream files of :func:`stack_files`, one a call."""

        ntime = config.int_prop(STACK_NTIME)
        pad = config.int_prop(STACK_PAD)
        ndays = config.int_prop(STACK_DAYS)
        nsrc = config.int_prop(STACK_NSRC)
        ninj = config.int_prop(STACK_NINJ)
        flux = config.float_prop(STACK_FLUX)

        def setup(self, tel):
            self.tel = io.get_telescope(tel)
            self.maps = TelescopeStreamMixIn()
            self.maps.setup(self.tel)
            self.files = stack_files(self.ntime, self.pad, self.ndays)
            ra, dec, _ = stack_catalog(self.tel, self.nsrc, self.ninj, self.tel.nfreq)
            ra_c, dec_c = icrs_to_cirs(ra[: self.ninj], dec[: self.ninj], stack_epoch(self.tel, self.ndays))
            self.sources = [(r, d, self.flux) for r, d in zip(ra_c, dec_c)]

        def process(self):
            if self._count >= len(self.files):
                raise PipelineStopIteration()
            k0, k1 = self.files[self._count]
            return stack_day_file(self.tel, self.maps, k0, k1, self.ntime, self.sources, resolve(),
                                  _seed(STACK_SEED, self._count))

    class EmitCatalog(ContainerTask):
        """The :func:`stack_catalog` as a ``SpectroscopicCatalog`` in ICRS."""

        nsrc = config.int_prop(STACK_NSRC)
        ninj = config.int_prop(STACK_NINJ)

        def setup(self, tel):
            self.tel = io.get_telescope(tel)

        def process(self):
            if self._count:
                raise PipelineStopIteration()
            ra, dec, z = stack_catalog(self.tel, self.nsrc, self.ninj, self.tel.nfreq)
            cat = containers.SpectroscopicCatalog(object_id=np.arange(self.nsrc))
            pos = np.zeros(self.nsrc, dtype=[("ra", np.float64), ("dec", np.float64)])
            pos["ra"], pos["dec"] = ra, dec
            red = np.zeros(self.nsrc, dtype=[("z", np.float64), ("z_error", np.float64)])
            red["z"] = z
            cat["position"][:] = pos
            cat["redshift"][:] = red
            cat.attrs["tag"] = "catalog"
            return cat

    class Probe(ContainerTask):
        """Passes its input through unchanged, keeping the sampled (freq, stack)
        rows of ``STACK_PROBES`` (and, for a joined day, its first regrid
        block's weights) for the host checks."""

        kind = config.str_prop("raw")
        block_freqs = config.int_prop(0)

        def process(self, data):
            rec = {"lsd": data.attrs.get("lsd")}
            f, s = STACK_PROBES["rows"]
            ft, st = (torch.as_tensor(x, device=data.vis[:].device) for x in (f, s))
            for name in ("vis", "weight", "nsample", "effective_ra"):
                if name == "vis" or name == "weight" or name in data.datasets:
                    ds = data.vis if name == "vis" else data.weight if name == "weight" else data.datasets[name]
                    rec[name] = take_rows(ds[:], ft, st)
            if self.kind == "raw":
                rec["times"] = data.time.copy()
                if self.block_freqs and "block" not in STACK_PROBES:
                    w = data.weight[:]
                    STACK_PROBES["block"] = (data.time.copy(), w[: self.block_freqs].reshape(-1, w.shape[-1]).clone())
            if self.kind == "sday":
                rec["Ni"] = data.weight[:].double().mean(dim=1).cpu().numpy()
            STACK_PROBES.setdefault(self.kind, []).append(rec)
            return data

    class Hold(ContainerTask):
        """Passes its input through under a label no task consumes, so that a
        ``retain_products: final`` run keeps it."""

        def process(self, data):
            return data

    class PickDay(ContainerTask):
        """Passes on the ``index``-th input only."""

        index = config.int_prop(0)

        def process(self, data):
            self._seen = getattr(self, "_seen", -1) + 1
            return data if self._seen == self.index else None

    for cls in (EmitDayStream, EmitCatalog, Probe, Hold, PickDay):
        globals()[cls.__name__] = cls
    return {cls.__name__: f"{__name__}.{cls.__name__}" for cls in (EmitDayStream, EmitCatalog, Probe, Hold, PickDay)}


def stack_config(product_dir: str, paths: dict, ntime: int, pad: int, ndays: int, samples: int, nsrc: int,
                 ninj: int, nsub: int, freqside: int, block_freqs: int) -> dict:
    """Phase 18's chain as a pipeline config mapping."""
    an = "draco.analysis."
    emit = {"ntime": ntime, "pad": pad, "ndays": ndays, "nsrc": nsrc, "ninj": ninj}
    return {"pipeline": {"retain_products": "final", "tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"], "params": {"product_directory": product_dir}},
        {"type": paths["EmitDayStream"], "requires": "tel", "out": "tstream", "params": emit},
        {"type": paths["EmitCatalog"], "requires": "tel", "out": "catalog", "params": {"nsrc": nsrc, "ninj": ninj}},
        {"type": an + "sidereal.SiderealGrouper", "requires": "tel", "in": "tstream", "out": "day"},
        {"type": paths["Probe"], "in": "day", "out": "day_p", "params": {"kind": "raw", "block_freqs": block_freqs}},
        {"type": an + "sidereal.SiderealRegridder", "requires": "tel", "in": "day_p", "out": "sday",
         "params": {"samples": samples, "kernel_width": KERNEL_WIDTH, "epsilon": EPSILON}},
        {"type": paths["Probe"], "in": "sday", "out": "sday_p", "params": {"kind": "sday"}},
        {"type": an + "sidereal.SiderealStacker", "in": "sday_p", "out": "sstack",
         "params": {"with_sample_variance": True}},
        {"type": an + "sidereal.SiderealStackerMatch", "in": "sday_p", "out": "mstack"},
        {"type": paths["Hold"], "in": "sstack", "out": "sstack_kept"},
        {"type": an + "beamform.BeamFormCat", "requires": ["tel", "sstack"], "in": "catalog", "out": "fbeam"},
        {"type": paths["Hold"], "in": "fbeam", "out": "fbeam_kept"},
        {"type": an + "sourcestack.SourceStack", "in": "fbeam", "out": "fstack", "params": {"freqside": freqside}},
        {"type": an + "sourcestack.RandomSubset", "requires": "catalog", "out": "subcat",
         "params": {"number": 1, "size": nsub, "seed": STACK_SEED}},
        {"type": an + "beamform.BeamFormCat", "requires": ["tel", "sstack"], "in": "subcat", "out": "fbeam_ha",
         "params": {"collapse_ha": False}},
        {"type": paths["PickDay"], "in": "day_p", "out": "rawday_last", "params": {"index": ndays - 1}},
        {"type": an + "sidereal.SiderealRebinner", "requires": "tel", "in": "rawday_last", "out": "rday",
         "params": {"samples": samples}},
        {"type": paths["Probe"], "in": "rday", "out": "rday_p", "params": {"kind": "rday"}},
        {"type": paths["PickDay"], "in": "sday_p", "out": "sday_last", "params": {"index": ndays - 1}},
        {"type": an + "sidereal.RebinGradientCorrection", "requires": "sday_last", "in": "rday_p",
         "out": "rday_corr"},
    ]}}


def host_west_stack(days):
    """The stack and sample variance of ``days`` (probe records of the sampled
    rows) by the West (1979) update in float64 numpy, inverse-variance
    weights.  Returns (vis, weight, nsample, sample_variance [3, ...],
    sv_bound [...]): the last bounds the float32 update's rounding in the
    sample variance, 2^-22 w |d| (|d| + |stack|) a day, scaled as the sample
    variance is (the first day's after-delta is d minus its own rounded
    copy, so a bright source leaves |d|^2-sized rounding in a noise-sized sum)."""
    vis = np.zeros(days[0]["vis"].shape, complex)
    w_st = np.zeros(vis.shape)
    n = np.zeros(vis.shape)
    scs = np.zeros(vis.shape)
    sv = np.zeros((3,) + vis.shape)
    rnd = np.zeros(vis.shape)
    inv = lambda x: np.where(x == 0, 0.0, 1.0 / np.where(x == 0, 1.0, x))  # noqa: E731
    for day in days:
        d, w = day["vis"].astype(complex), day["weight"].astype(np.float64)
        n += w > 0
        rnd += 2.0**-22 * w * np.abs(d) * (np.abs(d) + np.abs(vis))
        w_st += w
        before = w * (d - vis)
        vis = vis + before * inv(w_st)
        scs += w**2
        after = d - vis
        sv += np.stack([before.real * after.real, before.real * after.imag, before.imag * after.imag])
    scale = np.where(n > 1, inv(w_st - scs * inv(w_st)), 0.0)
    return vis, w_st, n, sv * scale, rnd * scale


def host_match_stack(days, rows):
    """The matched stack of the sampled rows in float64 numpy: each day's
    running update with its [freq, ra] mean weight, then the deconvolution of
    the per-day mean modes and the median subtraction."""
    f = rows[0]
    st = 0.0
    Ni_s, V = 0.0, []
    for day in days:
        Ni = day["Ni"]  # [freq, ra], float64 means over every stack
        v = Ni / np.sqrt(Ni.sum(axis=1))[:, None]
        d = day["vis"].astype(complex)  # [row, ra]
        st = st + d * Ni[f] - v[f] * np.sum(d * v[f], axis=1)[:, None]
        Ni_s, V = Ni_s + Ni, V + [v]
    V64 = np.array(V).transpose(1, 2, 0) / Ni_s[:, :, None]  # [freq, ra, day]
    M = np.eye(len(days))[None] - np.einsum("frd,fr,fre->fde", V64, Ni_s, V64)
    A = np.linalg.pinv(M, rcond=1e-8)[f]  # [row, day, day]
    X = np.einsum("sr,srd->sd", st, V64[f])
    sv = st / Ni_s[f] + np.einsum("srd,sd->sr", V64[f], np.einsum("sde,se->sd", A, X))
    return sv - (np.median(sv.real, axis=1) + 1j * np.median(sv.imag, axis=1))[:, None]


def host_rebin(raw, lsd, samples: int):
    """``SiderealRebinner`` (inverse-variance weights) of the sampled rows of
    one joined day at sample LSDs ``lsd``, in float64 numpy.  Returns (vis,
    weight, nsample, effective_ra)."""
    from draco_tpu_torch.ops import regrid

    start = float(raw["lsd"])
    target = np.linspace(start, start + 1, samples, endpoint=False)
    Rt = regrid.rebin_matrix(lsd, target, width_t=np.median(np.abs(np.diff(lsd)))).T
    w = raw["weight"].astype(np.float64)
    inv = lambda x: np.where(x == 0, 0.0, 1.0 / np.where(x == 0, 1.0, x))  # noqa: E731
    norm = inv(w @ Rt)
    vis = norm * ((raw["vis"].astype(complex) * w) @ Rt)
    weight = inv(norm**2 * (w @ Rt**2))
    nsample = (w > 0).astype(np.float64) @ Rt
    era = 360.0 * norm * (((lsd - start) * w) @ Rt)
    era = np.where(weight == 0, 360.0 * (target - start), era)
    return vis, weight, nsample, era


def host_beamform(tel, arrays, ra_axis, src_ra, src_dec, nha_side: int, pols):
    """``_beamform_sources_jit``'s formula (natural weights, the hour angle
    collapsed) for a few sources, in float64 on the host CPU: ``arrays`` maps
    each pol to its host (vis [freq, ra, prod], sw, vw, u, v), the task's own
    float32 inputs.  Returns (formed [src, pol, freq], weight [src, pol, freq])."""
    import torch

    nra = len(ra_axis)
    lat = np.radians(tel.latitude)
    out, wout = [], []
    for ra_s, dec_s in zip(src_ra, src_dec):
        idx = np.searchsorted(ra_axis, ra_s) % nra
        win = np.arange(idx - nha_side, idx + nha_side + 1) % nra
        ha = np.radians(ra_axis[win] - ra_s)
        ha = (ha + np.pi) % (2 * np.pi) - np.pi
        dec = np.radians(dec_s)
        pbs = stack_beams(tel, dec, ha)
        a = torch.as_tensor(np.cos(dec) * np.sin(ha))
        b = torch.as_tensor(np.cos(lat) * np.sin(dec) - np.sin(lat) * np.cos(dec) * np.cos(ha))
        rows = torch.as_tensor(win)
        fs, ws = [], []
        for p in pols:
            vis, sw, vw, u, v = arrays[p]
            pb = torch.as_tensor(pbs[["XX", "XY", "YX", "YY"].index(p)])  # [freq, h]
            vg = vis.index_select(1, rows).to(torch.complex128)  # [freq, h, prod]
            swg = sw.index_select(1, rows).double()
            vwg = vw.index_select(1, rows).double()
            d = u.double()[:, None, :] * a[None, :, None] + v.double()[:, None, :] * b[None, :, None]
            F = (swg * (vg * torch.polar(torch.ones_like(d), -2 * np.pi * d)).real).sum(-1)
            sumw = (swg.sum(-1) * pb**2).sum(-1)
            w2 = ((swg**2 * torch.where(vwg > 0, 1 / vwg, torch.zeros_like(vwg))).sum(-1) * pb**2).sum(-1)
            fs.append(((F * pb).sum(-1) / sumw).numpy())
            ws.append((sumw**2 / w2).numpy())
        out.append(fs)
        wout.append(ws)
    return np.array(out), 2.0 * np.array(wout)


def beamform_bound(ra_idx, nfreq: int, nprod: int, natural: bool, sfu_per_s: float) -> tuple[float, str]:
    """Least ms of one beamforming launch: the unique (freq, RA row) rows its
    windows touch read once (16 bytes a product: vis, sw, vw; 12 without vw),
    the baselines, the tracks and the outputs, at the HBM rate; against two
    special-function results (a sine and a cosine) a term at ``sfu_per_s``."""
    S, nha = ra_idx.shape
    rows = len(np.unique(np.asarray(ra_idx)))
    per = 16 if natural else 12
    nbytes = nfreq * rows * nprod * per + 2 * nfreq * nprod * 4 + S * nha * 12 + (3 if natural else 2) * nfreq * S * nha * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * nfreq * S * nha * nprod / sfu_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sfu_rate() -> float:
    """Special-function results a second: 132 SMs x 16 a clock at the card's largest SM clock."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return 132 * 16 * float(out.stdout.strip().splitlines()[0]) * 1e6


def run_stacking(device, ncyl: int = 4, nfeed: int = 256, nfreq: int = STACK_NFREQ, ntime: int = STACK_NTIME,
                 pad: int = STACK_PAD, ndays: int = STACK_DAYS, samples: int = STACK_SAMPLES, nsrc: int = STACK_NSRC,
                 ninj: int = STACK_NINJ, nsub: int = STACK_NSUB, ncheck: int = N_STACK_CHECK):
    """Phase 18: the day-stacking and source-beamforming path through the Manager.

    The sizes default to the phase's; smaller ones make it a rehearsal on
    the CPU (where the kernels are their plain versions and nothing is
    timed).  Returns the kernels' numbers for the JSON record.
    """
    import gc
    import pickle
    import tempfile

    import torch

    from draco_tpu_torch.analysis.beamform import BeamFormCat, icrs_to_cirs
    from draco_tpu_torch.analysis.transform import REGRID_BLOCK_BYTES
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.core.pipeline import Manager
    from draco_tpu_torch.ops import banded, cuda_kernels, interferometry, regrid

    failures = []
    on_card = device.type == "cuda"

    def check(label, value, ok):
        log(f"  {label}: {value}  [{'ok' if ok else 'FAIL'}]")
        if not ok:
            failures.append(label)

    tel = ring_telescope(ncyl, nfeed, nfreq)
    nstack = tel.npairs
    freqside = min(STACK_FREQSIDE, (nfreq - 1) // 2)
    # whole frequencies a regrid block, as regrid_sidereal counts them
    block_freqs = max(1, REGRID_BLOCK_BYTES // (2 * KERNEL_WIDTH * (samples + 10 * KERNEL_WIDTH) * 4 * nstack))
    blocks = -(-nfreq // block_freqs)
    rows_f = np.random.Generator(np.random.SFC64(STACK_SEED)).integers(0, nfreq, ncheck)
    rows_s = np.random.Generator(np.random.SFC64(STACK_SEED + 1)).integers(0, nstack, ncheck)
    STACK_PROBES.clear()
    STACK_PROBES["rows"] = (rows_f, rows_s)
    GB = 1e9
    nday_t = ntime + 2 * pad
    if on_card:
        log(f"stacking path: device memory allocated at the start {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
    log(f"stacking path: {ncyl} x {nfeed} dual-pol feeds, {nstack} stacks, {nfreq} channels, {ndays} days of "
        f"{ntime} (+{2 * pad}) samples -> {samples} RA; a joined day {12 * nfreq * nstack * nday_t / GB:.2f} GB, a "
        f"regridded day {12 * nfreq * nstack * samples / GB:.2f} GB, regrid rows B = {nfreq * nstack}; catalogue "
        f"{nsrc} sources ({ninj} injected at {STACK_FLUX:g} x the noise), HA-resolved subset {nsub}")

    paths = stacking_tasks()
    with tempfile.TemporaryDirectory() as product_dir:
        with open(Path(product_dir) / "telescope.pkl", "wb") as f:
            pickle.dump(tel, f)
        cfg = stack_config(product_dir, paths, ntime, pad, ndays, samples, nsrc, ninj, nsub, freqside, block_freqs)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        cuda_kernels.reset_launches()
        manager = Manager(cfg)
        t0 = _sync_clock(device)
        products = manager.run()
        wall = _sync_clock(device) - t0
        launches = dict(cuda_kernels.launches)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if on_card else float("nan")
    timing = {name.split(".")[-1]: round(t["wall"], 4) for name, t in manager.task_timing.items()}
    log(f"phase 18 Manager run: {wall:.2f} s wall, peak device memory {peak:.2f} GiB, launches {launches}")
    log("phase 18 task_timing (s): " + json.dumps(timing))
    del manager

    stack, mstack = products["sstack_kept"][0], products["mstack"][0]
    fbeam, fbeam_ha, fstack = products["fbeam_kept"][0], products["fbeam_ha"][0], products["fstack"][0]
    rcorr = products["rday_corr"][0]
    del products
    if on_card:
        check("the main path launched both kernels", f"banded_covariance {launches['banded_covariance']} (expect "
              f"{ndays} days x {blocks} blocks of {block_freqs} channels), beamform {launches['beamform']}",
              launches["banded_covariance"] == ndays * blocks and launches["beamform"] > 0)
    nha = fbeam_ha.beam.shape[-1]
    want = {
        "stack": (stack, containers.SiderealStream, "vis", (nfreq, nstack, samples)),
        "matched stack": (mstack, containers.SiderealStream, "vis", (nfreq, nstack, samples)),
        "formed beams": (fbeam, containers.FormedBeam, "beam", (nsrc, 4, nfreq)),
        "HA-resolved beams": (fbeam_ha, containers.FormedBeamHA, "beam", (nsub, 4, nfreq, nha)),
        "frequency stack": (fstack, containers.FrequencyStackByPol, "stack", (4, 2 * freqside + 1)),
        "corrected rebinned day": (rcorr, containers.SiderealStream, "vis", (nfreq, nstack, samples)),
    }
    for label, (cont, cls, name, shp) in want.items():
        data = cont.datasets[name][:]
        fin = torch.isfinite(torch.view_as_real(data) if data.is_complex() else data).all()
        check(f"{label} type, shape, finite", f"{type(cont).__name__}.{name} {tuple(data.shape)}",
              isinstance(cont, cls) and tuple(data.shape) == shp and bool(fin))

    # check 3: the stacks against the host float64 updates of the same regridded days
    sdays = STACK_PROBES["sday"]
    ft, st_ = (torch.as_tensor(x, device=device) for x in (rows_f, rows_s))
    hv, hw, hn, hsv, hsv_bound = host_west_stack(sdays)
    got_v = stack.vis[:][ft, st_].cpu().numpy()
    got_w = stack.weight[:][ft, st_].cpu().numpy()
    got_n = take_rows(stack.nsample[:], ft, st_).astype(np.float64)
    got_sv = stack.sample_variance[:][:, ft, st_].cpu().numpy()
    err_v = np.abs(got_v - hv).max() / np.abs(hv).max()
    err_w = np.abs(got_w - hw).max() / np.abs(hw).max()
    err_sv = np.abs(got_sv - hsv).max() / np.abs(hsv).max()
    sv_ratio = np.max(np.abs(got_sv - hsv) / (hsv_bound + TOL_STACK * np.abs(hsv).max()))
    check(f"stack of {ncheck} sampled (freq, stack) rows vs a float64 West update on the host",
          f"vis {err_v:.3e}, weight {err_w:.3e} (limit {TOL_STACK}); sample variance {err_sv:.3e}, its |diff| over "
          f"(its float32 rounding bound + {TOL_STACK} of its largest) {sv_ratio:.3f} (limit 1)",
          max(err_v, err_w) <= TOL_STACK and sv_ratio <= 1.0)
    all3 = np.all([d["weight"] > 0 for d in sdays], axis=0)
    check("nsample == 3 wherever all three days have weight", f"{int((got_n[all3] == ndays).sum())} of "
          f"{int(all3.sum())} cells", bool(np.all(got_n[all3] == ndays)) and all3.any())
    hm = host_match_stack(sdays, (rows_f, rows_s))
    got_m = mstack.vis[:][ft, st_].cpu().numpy()
    err_m = np.abs(got_m - hm).max() / np.abs(hm).max()
    check(f"matched stack of the sampled rows vs float64 on the host", f"{err_m:.3e} (limit {TOL_MATCH})",
          err_m <= TOL_MATCH)

    # check 7: the rebinned last day against a float64 host rebin of its sampled rows
    raw_last = STACK_PROBES["raw"][ndays - 1]
    rb = STACK_PROBES["rday"][0]
    h_v, h_w, h_n, h_e = host_rebin(raw_last, tel.unix_to_lsd(raw_last["times"]), samples)
    errs = [np.abs(rb[k] - h).max() / np.abs(h).max() for k, h in (("vis", h_v), ("weight", h_w),
                                                                     ("effective_ra", h_e))]
    n_ok = bool(np.all(np.abs(rb["nsample"].astype(np.float64) - h_n) < 1.0))
    check(f"rebinned day of {ncheck} sampled rows vs a float64 host rebin", f"vis {errs[0]:.3e}, weight "
          f"{errs[1]:.3e}, effective RA {errs[2]:.3e} (limit {TOL_REBIN}); nsample within its truncation to uint16 "
          f"{n_ok}", max(errs) <= TOL_REBIN and n_ok)

    # check 5: physics.  sigma of a formed value: 1 / sqrt(formed weight); the
    # regulariser epsilon shrinks each regridded sample by epsilon / (ni + epsilon)
    ra, dec, z = stack_catalog(tel, nsrc, ninj, nfreq)
    ra_c, dec_c = icrs_to_cirs(ra, dec, stack_epoch(tel, ndays))
    beam = fbeam.beam[:].cpu().numpy()
    fw = fbeam.weight[:].cpu().numpy()
    sigma = np.where(fw > 0, 1 / np.sqrt(np.where(fw > 0, fw, 1.0)), np.inf)
    ni_min = min(d["weight"][d["weight"] > 0].min() for d in sdays)
    shrink = EPSILON / (ni_min + EPSILON)
    dev_inj = np.abs(beam[:ninj] - STACK_FLUX)
    limit = 5 * sigma[:ninj] + STACK_FLUX * shrink
    worst = np.max(dev_inj / limit)
    rel = beam[:ninj, [0, 3]] / STACK_FLUX - 1
    check(f"{ninj} injected sources: |formed - flux| over (5 sigma + flux x {shrink:.2e}, the regulariser's "
          f"shrink at the smallest regridded weight {ni_min:.3f}), worst over pol and channel; formed / flux - 1 "
          f"for XX and YY in [{rel.min():.3e}, {rel.max():.3e}], 5 sigma of XX {5 * sigma[:ninj, 0].max():.3e}",
          f"{worst:.3f} (limit 1)", worst <= 1.0)
    co = [0, 3]
    wz = fw[ninj:, co]
    zsrc = (beam[ninj:, co] * wz).sum(axis=(1, 2)) / np.sqrt(np.maximum(wz.sum(axis=(1, 2)), 1e-300))
    top = np.argsort(-np.abs(zsrc))[:3]
    check(f"{nsrc - ninj} sources not injected: the inverse-variance mean of XX and YY over the channels in units "
          f"of its sigma, largest |z| (the three largest at RA, dec "
          f"{', '.join(f'{ra_c[ninj + i]:.2f} {dec_c[ninj + i]:.2f}' for i in top)})",
          f"{np.abs(zsrc).max():.3f} (limit 5; mean z^2 {np.mean(zsrc**2):.3f})", np.abs(zsrc).max() <= 5.0)

    # check 6: SourceStack against a float64 segment sum on the host
    freq = np.asarray(fbeam.freq)
    axis_c = np.asarray(fstack.index_map["freq"]["centre"])
    axis_w = np.asarray(fstack.index_map["freq"]["width"])
    step = 1.0 if axis_c[-1] >= axis_c[0] else -1.0
    edges = np.append(axis_c - step * 0.5 * axis_w, axis_c[-1] + step * 0.5 * axis_w[-1])
    nu_src = STACK_NU21 / (1 + z)
    bins = np.digitize(freq[None, :] - nu_src[:, None], edges) - 1
    good = (bins >= 0) & (bins < len(axis_c))
    num = np.zeros((4, len(axis_c)))
    den = np.zeros((4, len(axis_c)))
    for p in range(4):
        np.add.at(num[p], bins[good], (fw[:, p] * beam[:, p])[good])
        np.add.at(den[p], bins[good], fw[:, p][good])
    host_fs = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
    err_fs = np.abs(fstack.stack[:].cpu().numpy() - host_fs).max() / np.abs(host_fs).max()
    err_fw = np.abs(fstack.weight[:].cpu().numpy() - den).max() / np.abs(den).max()
    check("SourceStack vs a float64 segment sum of the same formed beams on the host (a one-hot product in a "
          "fixed order on the card)", f"stack {err_fs:.3e}, weight {err_fw:.3e} (limit {TOL_SOURCESTACK})",
          max(err_fs, err_fw) <= TOL_SOURCESTACK)

    # checks 1 and 4 need the task's per-pol arrays: a BeamFormCat set up on the same stack
    task = BeamFormCat()
    task.read_config({})
    task.setup(tel, stack)
    cat = containers.SpectroscopicCatalog(object_id=np.arange(nsrc))
    pos = np.zeros(nsrc, dtype=[("ra", np.float64), ("dec", np.float64)])
    pos["ra"], pos["dec"] = ra, dec
    cat["position"][:] = pos
    task._process_catalog(cat)
    task._initialize_beam_with_data()
    nbeam = min(N_BEAM_CHECK, nsrc // 2)
    pick = np.random.Generator(np.random.SFC64(STACK_SEED + 2)).choice(nsrc - ninj, nbeam - ninj // 4,
                                                                        replace=False) + ninj
    pick = np.concatenate([np.arange(ninj // 4), pick])
    arrays = {p: (task.vis[k].cpu(), task.sumweight[k].cpu(), task.visweight[k].cpu(), task._uv[k][0].cpu(),
                  task._uv[k][1].cpu()) for k, p in enumerate(task.process_pol)}
    t0 = time.perf_counter()
    hf, hwt = host_beamform(tel, arrays, np.asarray(stack.ra), ra_c[pick], dec_c[pick], int(task.ha_side),
                            task.process_pol)
    del arrays
    err_f = np.abs(beam[pick] - hf).max() / np.abs(hf).max()
    err_hw = np.abs(fw[pick] - hwt).max() / np.abs(hwt).max()
    check(f"formed beams and weights of {len(pick)} sampled sources ({ninj // 4} injected) vs a float64 evaluation "
          f"of the formula on the host CPU ({time.perf_counter() - t0:.1f} s)", f"beam {err_f:.3e}, weight "
          f"{err_hw:.3e} (limit {TOL_BEAMFORM_HOST})", max(err_f, err_hw) <= TOL_BEAMFORM_HOST)

    # check 1: the kernel against its plain version on the card, at the task's batch of 32
    kern = {}
    lat = np.radians(tel.latitude)
    sel = np.arange(min(N_KERNEL_CHECK, nsrc))
    windows = []
    for s in sel:
        idx = task._transit_index(task.sra[s])
        windows.append(task._ha_array(task.ra, idx, task.sra[s], int(task.ha_side), True))
    worst, scale = 0.0, 0.0
    batch_args = []
    for b0 in range(0, len(sel), 32):
        wb = windows[b0 : b0 + 32]
        ra_idx = np.stack([w[1] for w in wb]).astype(np.int32)
        ha = np.stack([w[0] for w in wb])
        decs = np.radians(task.sdec[sel[b0 : b0 + 32]])[:, None]
        a = np.cos(decs) * np.sin(ha)
        b = np.cos(lat) * np.sin(decs) - np.sin(lat) * np.cos(decs) * np.cos(ha)
        args = (task.vis[0], task.sumweight[0], task.visweight[0], torch.as_tensor(ra_idx, device=device),
                torch.as_tensor(a, dtype=torch.float32, device=device),
                torch.as_tensor(b, dtype=torch.float32, device=device), *task._uv[0])
        batch_args.append((args, ra_idx))
        got = cuda_kernels.beamform_sums(*args, natural=True)
        ref = interferometry.beamform_sums_plain(*args, natural=True)
        for g, r in zip(got, ref):
            worst = max(worst, (g.double() - r.double()).abs().max().item())
            scale = max(scale, r.double().abs().max().item())
    kerr = worst / scale
    check(f"beamform kernel vs its plain version on the {'card' if on_card else 'CPU'}, {len(sel)} sources "
          f"(pol XX, natural; F, W and Q)", f"max|diff| {worst:.3e}, / max|ref| {kerr:.3e} (limit "
          f"{TOL_BEAMFORM_KERNEL})", kerr <= TOL_BEAMFORM_KERNEL)
    kern["beamform"] = {"max_abs_err": worst, "library_ms": None}
    nfreq_k, _, nprod = task.vis[0].shape
    if on_card:
        # every batch of the check, timed and bounded on its own (their
        # windows differ: the first holds the injected sources, far apart),
        # reported as the mean of a launch
        def mean_ms(fn, reps):
            return float(np.mean([cuda_ms(lambda a=a: fn(*a, natural=True), reps) for a, _ in batch_args]))

        k1 = mean_ms(cuda_kernels.beamform_sums, 20)
        p1 = mean_ms(interferometry.beamform_sums_plain, 3)
        p2 = mean_ms(interferometry.beamform_sums_plain, 3)
        k2 = mean_ms(cuda_kernels.beamform_sums, 20)
        rate = sfu_rate()
        bounds = [beamform_bound(ra_idx, nfreq_k, nprod, True, rate) for _, ra_idx in batch_args]
        bound = float(np.mean([b for b, _ in bounds]))
        bys = [by for _, by in bounds]
        bound_by = max(set(bys), key=bys.count)
        log(f"kernel beamform, mean of {len(batch_args)} batches [S<=32, nha={batch_args[0][1].shape[1]}, "
            f"nfreq={nfreq_k}, nprod={nprod}] ms: kernel {k1:.4f} {k2:.4f}, plain {p1:.4f} {p2:.4f}, bound "
            f"{bound:.4f} ({bound_by}; each batch {', '.join(f'{b:.4f}' for b, _ in bounds)}); the phase's "
            f"{launches['beamform']} launches at this time: {launches['beamform'] * min(k1, k2) / 1e3:.3f} s")
        kern["beamform"].update({"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bound, "bound_by": bound_by})
    del task, batch_args
    gc.collect()

    # check 2: the banded covariance on the regrid's first block of the first day
    times, wblock = STACK_PROBES.pop("block")
    lsd_t = tel.unix_to_lsd(times)
    grid = LSD + np.arange(-5 * KERNEL_WIDTH, samples + 5 * KERNEL_WIDTH) / samples
    R = torch.as_tensor(np.ascontiguousarray(regrid.lanczos_forward_matrix(grid, lsd_t, KERNEL_WIDTH).T),
                        dtype=torch.float32, device=device)
    bw = 2 * KERNEL_WIDTH - 1
    out = cuda_kernels.banded_covariance_batched(R, wblock, bw)
    # against the plain version in float64 a channel's rows at a time (the
    # whole block's float64 reference would be 19 GB)
    cerr, cscale = 0.0, 0.0
    R64 = R.double()
    for r0 in range(0, wblock.shape[0], nstack):
        ref = banded.banded_covariance(R64, wblock[r0 : r0 + nstack].double(), bw)
        cerr = max(cerr, (out[r0 : r0 + nstack].double() - ref).abs().max().item())
        cscale = max(cscale, ref.abs().max().item())
        del ref
    crel = cerr / cscale
    check(f"banded_covariance at the regrid's block R{tuple(R.shape)} Ni{tuple(wblock.shape)} bw {bw} vs its "
          "plain version in float64", f"max_abs_err {cerr:.3e}, rel {crel:.3e} (limit {TOL_KERNEL})",
          crel <= TOL_KERNEL)
    del out, R64
    stack_kern = {"launches": launches["banded_covariance"], "max_abs_err": cerr}
    if on_card:
        kk1 = cuda_ms(lambda: cuda_kernels.banded_covariance_batched(R, wblock, bw), 5)
        pp1 = cuda_ms(lambda: banded.banded_covariance(R, wblock, bw), 2)
        pp2 = cuda_ms(lambda: banded.banded_covariance(R, wblock, bw), 2)
        kk2 = cuda_ms(lambda: cuda_kernels.banded_covariance_batched(R, wblock, bw), 5)
        cb, cb_by = covariance_bound(R, wblock, bw)
        log(f"kernel banded_covariance [stacking path, B={wblock.shape[0]}] ms: kernel {kk1:.4f} {kk2:.4f}, plain "
            f"{pp1:.4f} {pp2:.4f}, bound {cb:.4f} ({cb_by})")
        stack_kern.update({"ms": min(kk1, kk2), "plain_ms": min(pp1, pp2), "bound_ms": cb, "bound_by": cb_by})
    del R, wblock
    STACK_PROBES.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"phase 18 (stacking path) failed: {', '.join(failures)}")
    return launches, kern["beamform"], stack_kern


def _bl_max(tel) -> float:
    from draco_tpu_torch.analysis.powerspec import TransformJyPerBeamToKelvin

    t = TransformJyPerBeamToKelvin()
    t.read_config({})
    t.setup(tel)
    return t.bl_max


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2, help="seed of the time streams and kernel inputs")
    args = parser.parse_args()
    # the later phases hold tens of GB in blocks of changing sizes: let the
    # caching allocator grow its segments rather than split them (set before
    # torch first touches the card)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    repo = Path(__file__).resolve().parent
    if not all((repo / "draco_tpu_torch" / "csrc" / f"{n}.cu").is_file() for n in ("banded_covariance", "beamform")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(repo))

    import draco_tpu_torch  # noqa: F401  (sets the float32 matmul policy)
    from draco_tpu_torch import _build
    from draco_tpu_torch.ops import cuda_kernels, healpix
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")

    # phase 1: build every kernel, one nvcc for each source, all started together
    t0 = time.perf_counter()
    built = _build.build_all()
    for name in _build.sources():
        _build.load(name)
    log(f"build: {', '.join(f'{n}.cu {t:.2f} s' for n, t in built.items()) or 'nothing to build'} "
        f"(all together {time.perf_counter() - t0:.2f} s)")

    # phase 2: the kernel at the dish slice's shape
    tel, bt = telescope(NSIDE)
    nbase = len(tel.uniquepairs)
    stream = time_stream(tel.nfreq, nbase, NTIME, seed=args.seed)
    kern = check_kernel(device, "dish path", stream[0], stream[2])
    check_small_cases(device, seed=args.seed + 1)

    # phase 3: the dish slice at headline width
    rng = np.random.Generator(np.random.SFC64(1))
    sky = rng.standard_normal((tel.nfreq, 1, healpix.npix_of(NSIDE))).astype(np.float32)
    log(f"slice: nside={NSIDE} lmax=mmax={tel.mmax} pairs={nbase} nfreq={tel.nfreq} "
        f"ntime={NTIME} -> {SAMPLES} RA bins, chunk={CHUNK}")
    launches, w, _ = drive_slice("slice", bt, tel, sky, stream, device, CHUNK)
    del stream

    # phase 4: accuracy at nside 64, float32 against float64
    tel64, bt64 = telescope(NSIDE_ACC)
    rng = np.random.Generator(np.random.SFC64(1))
    sky64 = torch.from_numpy(rng.standard_normal((1, 1, healpix.npix_of(NSIDE_ACC)))).to(device)
    w64 = w[: tel64.mmax + 1].double()
    m32 = fused_simulate_to_map(bt64, sky64.float(), chunk=CHUNK, weight=w64.float())
    m64 = fused_simulate_to_map(bt64, sky64, chunk=CHUNK, weight=w64)
    rel = ((m32.double() - m64).abs().max() / m64.abs().max()).item()
    log(f"accuracy nside={NSIDE_ACC}: float32 vs float64 weighted round trip rel err {rel:.3e} (tol {TOL_MAP})")
    if not rel <= TOL_MAP:
        raise RuntimeError(f"round-trip accuracy {rel:.3e} exceeds {TOL_MAP}")
    del bt, bt64, w, w64, m32, m64
    torch.cuda.empty_cache()

    # phase 5: the kernel on the cylinder path's operands
    tel_c, bt_c = cylinder(NSIDE, 4, 256)
    nbase_c = len(tel_c.uniquepairs)
    stream_c = time_stream(tel_c.nfreq, nbase_c, NTIME, seed=args.seed + 2)
    kern_c = check_kernel(device, "cylinder path", stream_c[0], stream_c[2])

    # phase 6: the cylinder slice at CHIME width
    sky_c = np.random.Generator(np.random.SFC64(6)).standard_normal(
        (tel_c.nfreq, 1, healpix.npix_of(NSIDE))).astype(np.float32)
    log(f"cylinder slice: nside={NSIDE} lmax=mmax={tel_c.mmax} 4 x 256 feeds, pairs={nbase_c} "
        f"nfreq={tel_c.nfreq} ntime={NTIME} -> {SAMPLES} RA bins, chunk={CHUNK_CHIME}")
    launches_c, w_c, _ = drive_slice("cylinder slice", bt_c, tel_c, sky_c, stream_c, device, CHUNK_CHIME)
    run_c = next(iter(bt_c._fused_fns.values()))
    if run_c.state["form"] != "fullsphere":
        raise RuntimeError(f"the cylinder slice ran the {run_c.state['form']} form, not the full-sphere one")
    sky_cd = torch.from_numpy(sky_c).to(device)
    profile_split(lambda: run_c(sky_cd, weight=w_c), "fullsphere.")
    del bt_c, run_c, stream_c, w_c, sky_cd
    torch.cuda.empty_cache()

    # phase 7: the 2048-feed dual-pol cylinder
    run_dualpol(device)
    torch.cuda.empty_cache()

    # phase 8: full-sphere accuracy at nside 64
    check_fullsphere_accuracy(device)

    # phase 9: generate, projections and SVD at nside 32
    check_beamtransfer(device)
    torch.cuda.empty_cache()

    # phases 10 and 11: the task chain through the pipeline Manager
    t0 = time.perf_counter()
    tel = telescope(NSIDE)[0]
    chain_launches = run_task_chain(tel, device)
    log(f"phases 10-11 wall time {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phase 12: the matrix map makers at nside 32
    check_map_makers(device)
    torch.cuda.empty_cache()

    # phase 13: the composite simulation at 2048 dual-pol feeds
    t0 = time.perf_counter()
    cuda_kernels.reset_launches()
    run_composite(device)
    composite_launches = cuda_kernels.launches["banded_covariance"]
    log(f"phase 13 wall time {time.perf_counter() - t0:.1f} s; banded_covariance launches {composite_launches} "
        "(the chain has no regrid)")
    del tel
    torch.cuda.empty_cache()

    # phase 14: the analysis example's chain on the 191-pair cylinder
    t0 = time.perf_counter()
    cuda_kernels.reset_launches()
    bt_a = run_analyze(device)
    analyze_launches = cuda_kernels.launches["banded_covariance"]
    log(f"phase 14 wall time {time.perf_counter() - t0:.1f} s; banded_covariance launches {analyze_launches} "
        "(the chain has no regrid)")

    # phase 15: SVD -> KL -> quadratic power spectrum on the same product
    t0 = time.perf_counter()
    cuda_kernels.reset_launches()
    run_kl_path(device, bt_a)
    kl_launches = cuda_kernels.launches["banded_covariance"]
    log(f"phase 15 wall time {time.perf_counter() - t0:.1f} s; banded_covariance launches {kl_launches} "
        "(the path has no regrid)")
    del bt_a
    torch.cuda.empty_cache()

    # phase 16: the delay-spectrum path of BASELINE.json config 3
    t0 = time.perf_counter()
    cuda_kernels.reset_launches()
    run_delay(device)
    delay_launches = cuda_kernels.launches["banded_covariance"]
    log(f"phase 16 wall time {time.perf_counter() - t0:.1f} s; banded_covariance launches {delay_launches} "
        "(the path has no regrid)")
    torch.cuda.empty_cache()

    # phase 17: the ring-map path and the power spectrum built on it
    t0 = time.perf_counter()
    cuda_kernels.reset_launches()
    run_ringmap(device)
    ringmap_launches = cuda_kernels.launches["banded_covariance"]
    log(f"phase 17 wall time {time.perf_counter() - t0:.1f} s; banded_covariance launches {ringmap_launches} "
        "(the path has no regrid)")
    torch.cuda.empty_cache()

    # phase 18: the day-stacking and source-beamforming path, after dropping
    # the spherical-transform tables the earlier phases cached on the card
    import gc

    from draco_tpu_torch.ops import sht as sht_mod

    held = torch.cuda.memory_allocated(device) / 2**30
    sht_mod._sht_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated before phase 18: {held:.2f} GiB, {torch.cuda.memory_allocated(device) / 2**30:.2f} "
        "GiB without the cached SHT tables")
    t0 = time.perf_counter()
    stack_launches, beam_kern, stack_kern = run_stacking(device)
    log(f"phase 18 wall time {time.perf_counter() - t0:.1f} s; launches {stack_launches}")
    log(f"smoke wall time {time.perf_counter() - t_start:.1f} s")

    record = {"kernels": [{
        "name": "banded_covariance",
        "route": "cuda",
        "source": "draco_tpu_torch/csrc/banded_covariance.cu",
        "replaces": "draco_tpu/ops/pallas_kernels.py:57",
        "launches": launches["banded_covariance"],
        **kern,
        "cylinder_path": {"launches": launches_c["banded_covariance"], **kern_c},
        "task_chain": {"launches": chain_launches},
        "composite_chain": {"launches": composite_launches},
        "analysis_chain": {"launches": analyze_launches},
        "kl_path": {"launches": kl_launches},
        "delay_path": {"launches": delay_launches},
        "ringmap_path": {"launches": ringmap_launches},
        "stacking_path": stack_kern,
    }, {
        "name": "beamform",
        "route": "cuda",
        "source": "draco_tpu_torch/csrc/beamform.cu",
        "replaces": "draco_tpu/ops/interferometry.py:161",
        "launches": stack_launches["beamform"],
        **beam_kern,
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
