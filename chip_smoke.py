#!/usr/bin/env python3
"""Smoke run of the draco_tpu_torch slices on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --spine-stages tasks,sht [--repo DIR]   # not the smoke: a timing (spine_stages)

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
   the kernel must have launched.  Then the Legendre kernel's two launches
   on this path (the whole two-float table, every m over the 1023 rings
   from l = 0, and the beam window's band rings) against the plain loop on
   the same inputs, two-float and float64: hi + lo within 1e-9 and float64
   within 1e-12 of max|Lambda| (the same shapes as phase 21a's nside-256
   table build);
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
   product at its last two frequencies, 450 and 475 MHz (the cut; the beam
   SVD and the KL solves grow with them): a product config with a ``kltransform`` stanza (a
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
   shape (every factorisation's ``info`` 0, or the task raises); 17b's
   config run twice more by ``check_pipeline_determinism`` (rtol 0), keeping
   the products no task consumes (the 2D and 1D spectra): bit-identical.
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
   before the run), then ``BeamFormCat``'s split (host windows, ``beam_at``,
   the contraction, the torch normalisation) from one synchronised run of
   its stages.  Checks: the launches (3 days x 2 regrid blocks; beamform
   exactly 8, one a polarisation for each ``BeamFormCat``'s whole
   catalogue); every kept product finite, of its type and shape; the
   stack's rows within 1e-6 of a float64 West update on the host (the
   sample variance within its float32 rounding bound) and nsample 3 where
   all days have weight; the matched stack within 1e-5 of float64 on the
   host; the rebinned rows within 1e-5 of a float64 host rebin; the 16
   injected sources' formed flux within 5 sigma (from the formed weights)
   plus the regulariser's shrink of the flux; every other source's
   inverse-variance mean over XX, YY and the channels within 5 sigma of 0;
   ``SourceStack`` within 1e-6 of a float64 host segment sum; 64 sampled
   sources' formed beams within 1e-4 of a float64 evaluation of the JAX
   program's formula on the host; the task's tracks, built at once, equal
   to a window a source; the beamform kernel within 1e-5 of its plain
   version (F, W and Q each) on 8 batches of 32 sources and on the whole
   catalogue in one launch (the plain version in batches of 32), each timed
   beside it; the split run's formed beams within 1e-5 of the Manager's;
   the banded covariance at the regrid's block against its plain version
   in float64;
19. the flagging and fringe-stop path on phase 17's and 18's cylinder and
   band, in two runs of the pipeline ``Manager``.  19a: one half-day file
   (4344 samples; the cut) of phase 18's ``EmitDayStream`` with the autos and the
   weights a correlator reports (the radiometer equation's weights,
   scattering by 1% from sample to sample) and unflagged interference in
   every product of its cells (3 narrowband channels over 600 samples and 8
   broadband bursts of 3-10 samples, at 20 x the radiometer metric's
   scatter: more power in the autos and the cross products, the weights
   lowered to match) -> ``ComputeSystemSensitivity`` ->
   ``RFISensitivityMask`` (the task's defaults, with ``sir: true``) ->
   ``ApplyTimeFreqMask``; beside it, on the same stream,
   ``RFITransientVisMask`` (on one channel: the cut) and the ``RFIStaticVisMask`` group ->
   ``CombineMasks`` -> ``ApplyTimeFreqMask`` -> ``SanitizeWeights`` ->
   ``ThresholdVisWeightFrequency``, and ``DownMix`` -> ``UpMix`` (the time
   branch, with the product mask).  19b: phase 17's ``EmitRingStream`` ->
   ``MakeVisGrid`` -> ``BeamformNS`` -> ``DownMix`` -> ``UpMix`` (the ra and
   el branches) -> ``CreateBeamStreamFromTelescope``.  Prints each task's
   seconds, each Manager's wall time and peak device memory, the host's
   CPU count, the OpenMP threads and build seconds of the native medians
   and their calls and seconds, and the path's device programs timed alone.
   Checks: every injected sample masked; the masked share outside the
   injected cells below 5%; the sensitivity on every (freq, pol) row at 512
   sampled times within 1e-5 of float64 numpy on the host;
   ``RFISensitivityMask`` again on the CPU, on the same
   ``SystemSensitivity``, equal to the card's mask (a differing sample is
   listed with its SIR margin, and allowed only at the float64 tie); one
   (37, 181) moving median of the metric, native against numpy, identical;
   ``UpMix(DownMix(x))`` within 1e-6 relative RMS of x and ``DownMix`` on 64
   sampled rows within 1e-5 of float64 on the host, for both streams; the
   beam stream on 64 sampled (pol, freq, ew, el) rows within 1e-5 of a
   float64 evaluation of ``beam_at`` and the conjugate fringe phasor on the
   host, and its el-averaged weights 1.  The phase launches neither kernel.
20. the DAYENU, DPSS, wavelet and HyFoReS filter path, in three runs of the
   pipeline ``Manager``, the tasks' default windows and epsilons.  20a: phase
   16's stream (``EmitFilterStream``: 7155 products x 1024 channels over
   400-800 MHz, the foreground, white signal, noise and flagged channels of
   ``delay_stream``) at 64 RA samples (the cut; its three flagged samples
   moved onto them), with a delay tone (0.8 us, 10 x the signal) on one
   Stokes-I baseline -> ``DayenuDelayFilterFixedCutoff`` (``single_mask:
   false``, ``reduce_baseline: true``), ``DPSSFilterDelay`` (half-width 0.2
   us) -> ``StokesIVis`` -> ``DPSSFilterDelayStokesI``, and
   ``DayenuDelayFilter`` (``tauw`` 0.2 us, ``single_mask: false``) ->
   ``StokesIVis`` -> ``DelaySpectrumFFT`` -> ``DelaySpectrumToPowerSpectrum``
   -> ``WaveletSpectrumEstimator`` (over RA, 128 delays).  20b: every pair
   of phase 17's cylinder and band at CHIME's 4096 RA samples
   (``EmitMStream``: on intracylinder rows tones at m 60 and 5, on the
   others the fringe of a source at dec 40 with a slow envelope and a tone
   150 above it, noise, four flagged (channel, RA) cells with interference)
   -> ``DayenuMFilter`` -> ``DPSSFilterMMode`` (half-width 0.3 a degree);
   every component has a source's Gaussian envelope (20 degrees) about RA
   180, so it is band-limited within the span (the filter does not wrap).
   20c: phase 17's stream at 256 channels from 400 MHz (above 600 MHz no
   elevation lies inside HyFoReS's aliased horizon) and 512 RA samples ->
   ``MakeVisGrid`` -> ``BeamformNS`` (256 elevations) -> ``ForkHybrid`` (a
   copy with a 5% bandpass ripple at 0.8 us, a second one, a signal-only
   copy, an empty pixel mask) -> ``BeamformEW`` -> ``DayenuDelayFilterMap``;
   ``DayenuDelayFilterHybridVis`` (``save_filter``, ``calculate_cov``) ->
   ``DelayFilterHyFoReSBandpassHybridVis`` on the ripple copy ->
   ``DelayFilterHyFoReSBandpassHybridVisClean`` (cutoff 1e-2); the other
   copy filtered -> ``HyFoReSBandpassHybridVis`` and its ``Mask`` and
   ``MaskKeepSource`` variants; ``ApplyDelayFilterHybridVis`` on the
   signal-only copy.  Prints each task's seconds, each run's wall and peak
   device memory, and the path's device programs timed alone beside their
   bounds.  Checks: the DAYENU output of 64 products at 8 NS separations
   within 1e-2 of host float64 numpy (epsilon 1e-12 makes the covariance's
   condition 1e12, so two LAPACKs' float64 filters differ by ~3e-3), and
   the card's pseudo-inverse at epsilon 1e-3 within 1e-10 of the host's;
   the foreground-only copy's power through the filter under 1e-6 of its
   power before; the power beyond each product's cut + 0.1 us kept within
   5%; the inpainted channels within 0.1 (RMS) of the foreground there; the
   DPSS solve on 256 rows within 1e-3 of host float64; the wavelet spectrum
   of 8 baselines within 1e-2 of a host float64 in-fill and CWT (the in-fill
   inverts F D F^H, and D spans ~1e15 after the DAYENU filter), and the
   tone's baseline peaking within 10% of its delay; the m filter passing
   its component within 0.1 on the channels without flagged cells (at 4096
   samples and epsilon 1e-10 its float64 pass band is ~5% off: numpy's
   pseudo-inverse of the same covariance too) and letting through under
   1e-4 of the power of a rejected-only copy; both 20b tasks on rows of a
   flagged channel within 1e-3 of host float64; the ripple recovered on every (pol, ew)
   (correlation > 0.8, median residual < 0.3 of its peak); the three
   pre-filtered estimators equal within 1e-6; ``ApplyDelayFilterHybridVis``'s
   batched product bit-equal to one column at a time on 16 columns; the
   saved covariance of 16 columns within 1e-10 of host float64; the ring
   map's power below 0.05 us cut by 1e4; every output finite.  The phase
   launches neither kernel.
21. the spherical-harmonic transforms at CHIME's map resolution and the
   determinism check.  21a: ``make_sky`` (foreground, nside 1024, lmax =
   mmax = 3071, 16 channels) on the card, ``map2alm`` (iter 0) of the 16
   maps in float32 and ``alm2map`` back, all three by the SHT's chunked
   route (64 m at a time; its Legendre tables alone would take 232 GB), with the
   launch counts zeroed just before and read just after: the Legendre
   kernel ``csrc/legendre.cu`` must have launched once a chunk.  Prints the
   route, each step's seconds, the peak device memory, and the kernel's ms
   on the first chunk beside its bound and the plain loop's.  Checks: the
   kernel against its plain version on the card on the first chunk (m 0-63)
   and the last, over the rings in the order the route hands them (m 3008-3071, where Lambda_mm underflows near the poles):
   float64 within 1e-12 of the chunk's max|Lambda|, two-float hi + lo
   within 1e-9, float32 within 1e-5; float32 against float64 (the same
   route) on 2 channels within 1e-5 for the alm and the maps;
   ``smooth_gaussian`` of one nside-1024 map in float32 against float64
   within 1e-5; at nside 256 (lmax 767, whose tables are kept) the chunked
   route within 1e-6 of the tables on 4 maps; everything finite.  21b:
   ``check_pipeline_determinism`` at rtol 0: phase 10's two runs of the
   dish chain compared array by array (their fingerprints, which must hold
   the same keys and at least one array), and a seeded
   simulation of a 2 x 16 dual-pol cylinder at nside 64 and 16 channels
   (``GenerateGaussianSky`` -> ``SimulateSidereal`` -> ``ExpandProducts`` ->
   ``RandomSiderealGains`` -> ``ApplyGain`` -> ``CollateProducts`` ->
   ``StokesIVis`` -> ``DelaySpectrumFFT``) run twice: every product
   bit-identical;
22. the multi-device layer (``draco_tpu_torch/parallel``).  22a: the dish
   array of phases 3 and 10 over 8 channels (bench.py's multi-frequency
   extra, nside 256, lmax = mmax = 767): a foreground sky ->
   ``SimulateSidereal`` -> ``MModeTransform`` -> ``DirtyMapMaker`` (both
   streaming), with ``FrequencyRebin`` (pairs) beside them, through ``python
   -m draco_tpu_torch run`` under ``pipeline.mesh: {freq: -1}``: launched at
   world size 1 (``nccl``), as two ranks sharing the card (``gloo``) and,
   where the machine has two cards or more, one rank per card on 2 or 4
   cards (``nccl``),
   the launches at once (each through a file store of its own), beside
   this process's run of the config with no mesh.  Every product of every
   rank must be bit-equal to that run (the chain sums nothing across
   ranks); each rank must run on the backend its launch calls for and
   launch ``legendre``; prints each rank's peak memory and launches and
   each launch's wall time.  The Legendre kernel's two launches a rank
   (the whole table and the band rings of the beam window, which spans
   all 8 channels) are held against the plain loop on the same inputs, as
   in phase 3.  22b, while 22a's launches run:
   ``parallel.dryrun_multichip(2)`` on the card: the explicit spine split
   over (freq, m), the fused round trip of a sky split over a 1-D ``freq``
   mesh and the composite chain under a mesh, each against its unsharded
   run.

The last lines are the kernels' JSON record, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
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
KL_FREQS = slice(2, 4)  # phase 15 takes the last two of phase 14's frequencies (the cut: the beam SVD and the KL eigh
# grow with them; at the first two the top kperp band, l = 0.2-0.3 chi, lies above lmax)
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
# phase 19: the flagging and fringe-stop path on phase 17's and 18's cylinder and band
FLAG_NFREQ = RING_NFREQ
FLAG_DAY = 8640  # samples a sidereal day: FLAG_NARROW and FLAG_BURSTS place the interference on a whole day
# the cut: a quarter of phase 18's day.  The host's medians are the phase's
# cost; at the half-day file (4344) the phase took 202.7 s alone, which in a
# call whose host runs as slowly as the slowest seen would pass 1200 s
FLAG_NTIME = 2172
FLAG_TRANSIENT_CHANNELS = (3, 4)  # the cut: the channel range RFITransientVisMask runs on
FLAG_SEED = 19
FLAG_TSYS = (50.0, 60.0)  # auto power of the X and the Y feeds
FLAG_SIGMA = 0.01  # the weights' relative scatter from sample to sample: the radiometer metric's scatter
FLAG_AMP = 20.0  # the injected interference, in units of the metric's scatter
FLAG_NARROW = ((3, 1200), (8, 4100), (12, 6500))  # (channel, first sample) of the narrowband lines
FLAG_NARROW_LEN = 600  # samples of a whole day: the lines cover 7% of the stream, scaled with it
FLAG_BURSTS = ((700, 3), (1900, 5), (2800, 10), (3600, 4), (5200, 7), (6100, 3), (7300, 8), (8100, 6))
FLAG_C = 299792458.0
N_FLAG_CHECK = 64  # sampled rows of the mixers' and the beam stream's host checks
N_FLAG_SENS_T = 512  # sampled times of the sensitivity's host check
FLAG_TOL_SENS = 1e-5
FLAG_TOL_MIX = 1e-5
FLAG_TOL_ROUNDTRIP = 1e-6
FLAG_TOL_BEAM = 1e-5
FLAG_MASKED_MAX = 0.05
FLAG_PROBES: dict = {}  # what phase 19's probes keep for the host checks

# phase 20: the DAYENU, DPSS, wavelet and HyFoReS filter path
FILT_NRA = 64  # 20a's RA samples (the cut: phase 16 has 256, CHIME's grid 4096)
FILT_TAUW = 0.2  # us: DayenuDelayFilter's tauw and DPSSFilterDelay's halfwidth (the foreground lies inside 0.8 x max(NS / c, 0.2 us))
FILT_TONE = ((22.0, 0.5), 0.8, 1e3)  # (baseline (EW, NS) m, delay us, amplitude) of the wavelet check's tone
FILT_NDELAY = 128
FILT_SEED = 20
N_FILT_CUTS = 8  # NS separations of the host checks' products
N_FILT_PER_CUT = 8  # products of each
N_FILT_DPSS = 4  # products (x every RA sample) of the DPSS host check
N_FILT_WAVELET = 8  # Stokes-I baselines of the wavelet host check
FILT_TOL_DAYENU = 1e-2  # card vs host float64 at epsilon 1e-12: the covariance's condition 1e12 leaves two LAPACKs ~3e-3 apart
FILT_TOL_DAYENU_E3 = 1e-10  # the card's float64 pseudo-inverse at epsilon 1e-3 vs host float64
FILT_FG_FALL = 1e-6
FILT_KEEP = 0.05  # power beyond each product's cut + 0.1 us kept within this
FILT_TOL_INPAINT = 0.1  # inpainted channels vs the foreground there, RMS over RMS (the white signal is not inpainted)
FILT_TOL_DPSS = 1e-3
FILT_TOL_WAVELET = 1e-2  # the in-fill inverts F D F^H, and D spans ~1e15 after the DAYENU filter (3.1e-3 between two CPU LAPACKs)
FILT_TONE_TOL = 0.1
MF_NFREQ = 16  # 20b's channels (the cut: CHIME's 1024 would be 64 x this)
MF_NRA = 4096  # CHIME's sidereal grid
MF_DEC = 40.0  # DayenuMFilter's default
MF_AMP = 1e4  # over unit noise: the DPSS solve's default epsilon (1e-3) assumes weights of order 1
MF_NOISE_VAR = 1.0  # the weights are its inverse
MF_ENVELOPE = 20.0  # deg: the components' Gaussian envelope about RA 180
MF_INTRA_M = (60.0, 5.0)  # (passed, rejected) m of the intracylinder rows (pass band 0.25-1 x the cylinder's m)
MF_INTER_OFFSET = 150.0  # m of the intercylinder rows' rejected component above their fringe (pass band +-0.75 x it)
MF_FLAGS = ((2, 1000), (5, 1001), (9, 2500), (13, 3800))  # flagged (channel, RA sample) cells
MF_RFI = 1e7
MF_HALFWIDTH = 0.3  # DPSSFilterMMode's halfwidth, cycles a degree: |m| < 108 holds the intracylinder pass band
MF_TOL_PASS = 0.1  # at 4096 samples and epsilon 1e-10 the pass band's eigenvalues of 1 come from cancelling entries of 1/(a eps) ~ 1e12: float64 leaves them ~5% off (numpy's pinv too)
MF_TOL_OOB = 1e-4
MF_TOL_HOST = 1e-3
N_MF_HOST = 4  # rows of each host check
HV_NFREQ = 256  # 20c: 100 MHz of CHIME's channels
HV_F0 = 400.0  # MHz: HyFoReS keeps the elevations inside the aliased horizon, c / (f d_NS) - 1, none above 600 MHz
HV_NRA = 512
HV_NPIX = 256
HV_RIPPLE = (0.05, 0.8)  # amplitude and delay (us) of the bandpass ripple on the unfiltered copy
HV_EDGE = 8  # band-edge channels the ripple check leaves out (the window is rank deficient there)
HV_SEED = 22
N_HV_COLS = 16  # (ew, ra) columns of the per-column checks
HV_CORR = 0.8
HV_RESID = 0.3
HV_TOL_VARIANTS = 1e-6
HV_TOL_COV = 1e-10
HV_MAP_FALL = 1e-4
FILT_PROBES: dict = {}  # what phase 20's source tasks keep for the host checks

SHT_NSIDE = 1024  # CHIME's map resolution: lmax = mmax = 3071, the SHT goes chunk by chunk
SHT_NFREQ = 16
SHT_SEED = 21
SHT_NCHECK = 2  # channels transformed again in float64
SHT_NSIDE_TABLES = 256  # the largest nside whose tables are kept: both routes there
SHT_NMAPS_TABLES = 4
TOL_SHT = 1e-5  # float32 against float64, maps and alm (the map-error contract)
TOL_SHT_ROUTES = 1e-6  # the chunked route against the cached tables, both float32
TOL_LEGENDRE = {"f64": 1e-12, "2f": 1e-9, "f32": 1e-5}  # the kernel against its plain version, of max|Lambda|
VERIFY_NSIDE = 64  # 21b (ii): the small polarised cylinder's simulation
VERIFY_NFREQ = 16
VERIFY_SEED = 22
MESH_NFREQ = 8  # phase 22: bench.py's BENCH_NFREQ extra (bench.py:814), 8 channels over the dish slice's band
MESH_SEED = 23
MESH_LABELS = ("sky", "sstream", "srebin", "mmodes", "dmap")
MESH_TIMEOUT_S = 300  # a launch of phase 22 that takes longer has hung

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


def kernel_device_ms(fn, reps: int, key: str) -> float:
    """Device ms a launch of the kernel whose name holds ``key``, from
    ``torch.profiler`` over ``reps`` calls of ``fn`` after a warm one: the
    summed kernel time over the launches the trace holds (a trace can miss
    some, so not over ``reps``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if key in ev.key:
            total += getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
            count += ev.count
    if count == 0:
        raise RuntimeError(f"the profiler traced no kernel named like {key!r}")
    return total / 1e3 / count


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


def profile_top(run, label: str, top: int = 8) -> None:
    """One call of ``run`` under ``torch.profiler``: the ``top`` kernels by
    device time, and all kernels' device time against the call's wall time
    (the device's busy share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_ms(ev):
        return getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0)) / 1e3

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [(dev_ms(ev), ev.count, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)]
    total = sum(k[0] for k in kern)
    log(f"profile {label} (torch.profiler, one call): all kernels {total:.1f} ms of device time in {wall_ms:.1f} ms "
        f"wall (busy share {total / wall_ms:.3f}); top: " + "; ".join(
            f"{name[:60]} x{count} {ms:.1f} ms" for ms, count, name in sorted(kern, reverse=True)[:top]))


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


def run_task_chain(tel, device) -> tuple[int, tuple[dict, dict]]:
    """Phases 10 and 11: the chain through the Manager, twice; returns the
    kernel launches of the first run and the fingerprints of both runs'
    products (phase 21b compares them)."""
    import pickle
    import tempfile

    import torch

    from draco_tpu_torch.core.pipeline import Manager
    from draco_tpu_torch.ops import cuda_kernels
    from draco_tpu_torch.parallel import validate
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
        fp1 = validate.fingerprint(products)

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
        products = manager.run()
        torch.cuda.synchronize(device)
        log(f"task chain run 2: {time.perf_counter() - t0:.2f} s wall")
        log("task chain run 2 task_timing (s): " + json.dumps(
            {name: round(t["wall"], 4) for name, t in manager.task_timing.items()}))
        fp2 = validate.fingerprint(products)
        del products
    return launches, (fp1, fp2)


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


def _freq_subset(ss, fsel: slice):
    """A copy of the sidereal stream ``ss`` at its frequencies ``fsel``."""
    from draco_tpu_torch.core import containers

    out = containers.empty_like(ss, freq=np.asarray(ss.index_map["freq"])[fsel])
    for name in out.datasets:
        ds = ss.datasets[name]
        sel = [slice(None)] * len(ds.axes)
        if "freq" in ds.axes:
            sel[ds.axes.index("freq")] = fsel
        out.datasets[name][:] = ds[:][tuple(sel)]
    return out


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
    """Phase 15's product config: the cylinder of phase 14 at its frequencies ``KL_FREQS``, a KLTransform, a
    DoubleKL and a PS estimator."""
    return {
        "config": {"output_directory": directory},
        "telescope": {
            "type": "UnpolarisedCylinder", "num_cylinders": 2, "num_feeds": 64,
            "num_freq": KL_FREQS.stop - KL_FREQS.start, "auto_correlations": True,
            "force_lmax": 3 * NSIDE - 1, "force_mmax": 3 * NSIDE - 1,
            "freq_lower": 400.0 + KL_FREQS.start * 100.0 / ANALYSIS_NFREQ,
            "freq_upper": 400.0 + KL_FREQS.stop * 100.0 / ANALYSIS_NFREQ, **CHIME,
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
    if not (np.array_equal(tel.uniquepairs, bt.telescope.uniquepairs)
            and np.array_equal(tel.frequencies, bt.telescope.frequencies[KL_FREQS])):
        raise RuntimeError("the product config's telescope is not phase 14's at its frequencies KL_FREQS")
    # the beam transfer matrices phase 14 generated (the same telescope): not generated twice
    pm.beamtransfer._bp, pm.beamtransfer._bm = bt._bp[KL_FREQS], bt._bm[KL_FREQS]
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
    mmodes = {name: _mmodes_of(tel, _freq_subset(ANALYSIS[name], KL_FREQS)) for name in ("total", "foreground", "signal")}
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


def delay_stream(tel, prods, nra: int, device, noise_seed: int = 0, parts=("fg", "signal", "noise"),
                 flag_ra=DELAY_FLAG_RA):
    """A ``SiderealStream`` of the telescope's products ``prods`` [nfreq, len(prods), nra].

    Each product is made from its own seeds alone (so any subset is the same
    data): a foreground of ``DELAY_FG_MODES`` delays drawn inside 0.8 of its
    horizon cut, with amplitudes that vary smoothly over RA, at
    ``DELAY_FG_POWER`` x the signal's power; a white complex signal of
    variance ``DELAY_SIGNAL_VAR``; noise of variance ``DELAY_NOISE_VAR``
    (draw ``noise_seed``).  Every product has the flagged channels and the
    RA samples ``flag_ra`` at weight 0, with ``DELAY_RFI`` added to their data.
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
    w[:, :, list(flag_ra)] = 0.0
    nu = torch.as_tensor(tel.frequencies, dtype=torch.float64, device=device)
    turns = torch.arange(nra, dtype=torch.float64, device=device) / nra
    cuts = delay_cuts(tel, pairs)
    gen = torch.Generator(device=device)
    vis = ss.vis[:]
    prods = np.asarray(prods)
    if "fg" in parts:
        # each product's foreground parameters from its own seed, on the host
        tau = np.empty((len(prods), DELAY_FG_MODES))
        amp = np.empty((len(prods), DELAY_FG_MODES), np.complex128)
        phi = np.empty((len(prods), DELAY_FG_MODES))
        for j, p in enumerate(prods):
            rng = np.random.Generator(np.random.SFC64(_seed(DELAY_SEED, int(p), 0)))
            tau[j] = rng.uniform(-0.8, 0.8, DELAY_FG_MODES) * cuts[j]
            amp[j] = (rng.standard_normal(DELAY_FG_MODES) + 1j * rng.standard_normal(DELAY_FG_MODES)) * np.sqrt(
                DELAY_FG_POWER * DELAY_SIGNAL_VAR / (2 * DELAY_FG_MODES))
            phi[j] = rng.uniform(0, 2 * np.pi, DELAY_FG_MODES)
    step = max(1, (1 << 26) // (tel.nfreq * nra))
    for b0 in range(0, len(prods), step):
        b1 = min(b0 + step, len(prods))
        if "fg" in parts:
            ta, am, ph = (torch.as_tensor(x[b0:b1], device=device) for x in (tau, amp, phi))
            ramp = am[:, :, None] * (1 + 0.5 * torch.cos(2 * np.pi * turns[None, None] + ph[:, :, None]))
            vis[:, b0:b1] = torch.einsum("fbk,bkt->fbt", torch.exp(2j * np.pi * nu[:, None, None] * ta[None]),
                                         ramp).to(vis.dtype)
        blk = torch.zeros((b1 - b0, tel.nfreq, nra), dtype=vis.dtype, device=device)
        for j, p in enumerate(prods[b0:b1]):
            for part, var, seed in (("signal", DELAY_SIGNAL_VAR, _seed(DELAY_SEED, int(p), 1)),
                                    ("noise", DELAY_NOISE_VAR, _seed(DELAY_SEED, int(p), 2, noise_seed))):
                if part in parts:
                    gen.manual_seed(seed)
                    blk[j] += np.sqrt(var / 2) * torch.view_as_complex(
                        torch.randn((tel.nfreq, nra, 2), generator=gen, device=device))
        vis[:, b0:b1] += blk.transpose(0, 1)
        del blk
    vis[list(DELAY_FLAG_CHANNELS)] += DELAY_RFI
    vis[:, :, list(flag_ra)] += DELAY_RFI
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


def ring_telescope(ncyl: int = 4, nfeed: int = 256, nfreq: int = RING_NFREQ, f0: float = RING_F0):
    """Phase 17's telescope: phase 7's dual-pol CHIME cylinder at ``nfreq`` channels of 390.625 kHz from ``f0`` MHz."""
    from draco_tpu_torch.telescope import PolarisedCylinderTelescope

    return PolarisedCylinderTelescope(
        num_cylinders=ncyl, num_feeds=nfeed, num_freq=nfreq, freq_lower=f0,
        freq_upper=f0 + nfreq * RING_DF, auto_correlations=True, **CHIME,
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
    freqs = np.asarray(tel.frequencies)
    step = max(1, (1 << 25) // (len(pairs) * nra))  # channels at a time
    for f0 in range(0, len(freqs), step):
        f = freqs[f0 : f0 + step]
        nu = torch.as_tensor(f * 1e6 / C_LIGHT, device=device)[:, None, None]
        acc = torch.zeros((len(f), len(pairs), nra), dtype=torch.complex128, device=device)
        for k, (r0, e0, _) in enumerate(ring_sources(nra, npix)):
            dec = np.arcsin(el[e0]) + np.radians(tel.latitude)
            sa, sb = (prefactor[None, :, i] / (f[:, None] * np.cos(dec)) for i in (0, 1))
            sigma = sa * sb / np.hypot(sa, sb)  # [freq, pol]
            dphi = phi - phi[r0]
            env = np.exp(-0.5 * (2 * np.tan(dphi / 2)) ** 2 / sigma[:, :, None] ** 2)  # [freq, pol, ra]
            ew = (-2 * np.pi * nu * np.cos(dec)) * torch.as_tensor(np.sin(dphi), device=device)[None, None] * xpos[None]
            arg = ew + 2 * np.pi * nu * el[e0] * ypos[None]
            amp = torch.as_tensor(ring_flux(k, freqs, tone)[f0 : f0 + step], device=device)[:, None, None]
            acc += amp * torch.as_tensor(env, device=device)[:, pidx_t] * torch.polar(torch.ones_like(arg), arg)
        for j in range(len(f)):
            noise = torch.randn((len(pairs), nra, 2), generator=gen, device=device, dtype=torch.float64)
            vis[f0 + j] = acc[j] + np.sqrt(0.5) * torch.view_as_complex(noise)
        del acc
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
    from draco_tpu_torch.parallel import validate

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
        cfg_b = ring_config(product_dir, source, attach, "b", nra, npix)
        # the determinism check of `verify` on 17b's spectra (the products no
        # task consumes), whose binned sums must not change from run to run
        t0 = time.perf_counter()
        summary = validate.check_pipeline_determinism(
            {"pipeline": {**cfg_b["pipeline"], "retain_products": "final"}}, runs=2, rtol=0.0)
        log(f"phase 17b check_pipeline_determinism: two runs in {time.perf_counter() - t0:.2f} s bit-identical: "
            f"{summary['products']} product labels, {summary['arrays']} arrays")
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        products, timing_b, peak_b = _run_twice("17b", cfg_b, device)

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
              f"{ndays} days x {blocks} blocks of {block_freqs} channels), beamform {launches['beamform']} (expect "
              "2 BeamFormCat calls x 4 pols: one launch a pol for each whole catalogue)",
              launches["banded_covariance"] == ndays * blocks and launches["beamform"] == 2 * 4)
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

    # check 1: the kernel against its plain version, on the check's batches
    # of 32 (the catalogue's first 256 sources) and on the whole catalogue in
    # one launch (against the plain version in batches of 32)
    kern = {}
    lat = np.radians(tel.latitude)
    transits = task._transit_indices(task.sra)
    windows = [task._ha_array(task.ra, transits[s], task.sra[s], int(task.ha_side), True) for s in range(nsrc)]
    ra_all = np.stack([w[1] for w in windows]).astype(np.int32)
    ha_all = np.stack([w[0] for w in windows])
    decs = np.radians(task.sdec)[:, None]
    a_all = np.cos(decs) * np.sin(ha_all)
    b_all = np.cos(lat) * np.sin(decs) - np.sin(lat) * np.cos(decs) * np.cos(ha_all)
    tracks = task._source_tracks()
    check("the task's tracks of the whole catalogue, built at once, vs a window a source",
          f"{len(tracks.src_ids)} of {nsrc} sources kept, RA indices and hour angles equal",
          np.array_equal(tracks.src_ids, np.arange(nsrc)) and np.array_equal(tracks.ra_idx, ra_all)
          and np.array_equal(tracks.ha, ha_all))

    def kernel_args(sl):
        return (task.vis[0], task.sumweight[0], task.visweight[0], torch.as_tensor(ra_all[sl], device=device),
                torch.as_tensor(a_all[sl], dtype=torch.float32, device=device),
                torch.as_tensor(b_all[sl], dtype=torch.float32, device=device), *task._uv[0])

    batch_args = [(kernel_args(slice(b0, b0 + 32)), ra_all[b0 : b0 + 32])
                  for b0 in range(0, min(N_KERNEL_CHECK, nsrc), 32)]
    plain_batches = [kernel_args(slice(b0, b0 + 32)) for b0 in range(0, nsrc, 32)]
    whole = kernel_args(slice(None))

    def compare(pairs):
        """max|diff| and max|ref| of F, W and Q over (kernel, plain) output pairs."""
        worst, scale = np.zeros(3), np.zeros(3)
        for got, ref in pairs:
            for i, (g, r) in enumerate(zip(got, ref)):
                worst[i] = max(worst[i], (g.double() - r.double()).abs().max().item())
                scale[i] = max(scale[i], r.double().abs().max().item())
        return worst, worst / scale

    wb, rb = compare((cuda_kernels.beamform_sums(*args, natural=True),
                      interferometry.beamform_sums_plain(*args, natural=True)) for args, _ in batch_args)
    check(f"beamform kernel vs its plain version on the {'card' if on_card else 'CPU'}, {len(batch_args)} batches "
          "of 32 sources (pol XX, natural)", f"max|diff| / max|ref| F {rb[0]:.3e}, W {rb[1]:.3e}, Q {rb[2]:.3e} "
          f"(limit {TOL_BEAMFORM_KERNEL})", rb.max() <= TOL_BEAMFORM_KERNEL)
    got = cuda_kernels.beamform_sums(*whole, natural=True)
    ww, rw = compare(([g[:, b0 : b0 + 32] for g in got], interferometry.beamform_sums_plain(*args, natural=True))
                     for b0, args in zip(range(0, nsrc, 32), plain_batches))
    del got
    check(f"beamform kernel on the whole catalogue ({nsrc} sources, one launch) vs its plain version in batches of 32",
          f"max|diff| / max|ref| F {rw[0]:.3e}, W {rw[1]:.3e}, Q {rw[2]:.3e} (limit {TOL_BEAMFORM_KERNEL})",
          rw.max() <= TOL_BEAMFORM_KERNEL)
    kern["beamform"] = {"max_abs_err": float(max(wb.max(), ww.max())), "library_ms": None,
                        "max_rel_err_F_W_Q": np.maximum(rb, rw).tolist()}
    nfreq_k, _, nprod = task.vis[0].shape
    if on_card:
        # every batch of the check, timed and bounded on its own (their
        # windows differ: the first holds the injected sources, far apart),
        # reported as the mean of a launch
        def mean_ms(fn, reps):
            return float(np.mean([cuda_ms(lambda a=a: fn(*a, natural=True), reps) for a, _ in batch_args]))

        def plain_all():
            for args in plain_batches:
                interferometry.beamform_sums_plain(*args, natural=True)

        def whole_ms(reps):
            return cuda_ms(lambda: cuda_kernels.beamform_sums(*whole, natural=True), reps)

        def device_ms(args, reps):
            return kernel_device_ms(lambda: cuda_kernels.beamform_sums(*args, natural=True), reps, "beamform_rows")

        k1 = mean_ms(cuda_kernels.beamform_sums, 20)
        p1 = mean_ms(interferometry.beamform_sums_plain, 3)
        p2 = mean_ms(interferometry.beamform_sums_plain, 3)
        k2 = mean_ms(cuda_kernels.beamform_sums, 20)
        kw1 = whole_ms(5)
        pw1 = cuda_ms(plain_all, 1)
        pw2 = cuda_ms(plain_all, 1)
        kw2 = whole_ms(5)
        sub = kernel_args(slice(0, nsub))
        k_sub = cuda_ms(lambda: cuda_kernels.beamform_sums(*sub, natural=True), 20)
        # the kernel alone, without the row plan's bookkeeping
        d_batch = float(np.mean([device_ms(a, 20) for a, _ in batch_args]))
        d_whole, d_sub = device_ms(whole, 5), device_ms(sub, 20)
        rate = sfu_rate()
        bounds = [beamform_bound(ra_idx, nfreq_k, nprod, True, rate) for _, ra_idx in batch_args]
        bound = float(np.mean([b for b, _ in bounds]))
        bys = [by for _, by in bounds]
        bound_by = max(set(bys), key=bys.count)
        bound_w, by_w = beamform_bound(ra_all, nfreq_k, nprod, True, rate)
        bound_sub, by_sub = beamform_bound(ra_all[:nsub], nfreq_k, nprod, True, rate)
        phase_s = (launches["beamform"] // 2) * (min(kw1, kw2) + k_sub) / 1e3
        log(f"kernel beamform, mean of {len(batch_args)} batches [S<=32, nha={ra_all.shape[1]}, nfreq={nfreq_k}, "
            f"nprod={nprod}] ms a call (row plan + kernel): {k1:.4f} {k2:.4f}, the kernel alone {d_batch:.4f}, plain "
            f"{p1:.4f} {p2:.4f}, bound {bound:.4f} ({bound_by}; each batch {', '.join(f'{b:.4f}' for b, _ in bounds)})")
        log(f"kernel beamform, the whole catalogue in one launch [S={nsrc}] ms a call: {kw1:.4f} {kw2:.4f}, the "
            f"kernel alone {d_whole:.4f}, plain in {len(plain_batches)} batches of 32 {pw1:.4f} {pw2:.4f}, bound "
            f"{bound_w:.4f} ({by_w}); [S={nsub}, the HA-resolved call's shape] a call {k_sub:.4f}, the kernel alone "
            f"{d_sub:.4f}, bound {bound_sub:.4f} ({by_sub}); the phase's {launches['beamform']} launches "
            f"({launches['beamform'] // 2} at each shape) at these times: {phase_s:.4f} s")
        kern["beamform"].update({
            "ms": min(kw1, kw2), "device_ms": d_whole, "plain_ms": min(pw1, pw2), "bound_ms": bound_w,
            "bound_by": by_w, "sources": nsrc, "phase_kernel_s": phase_s,
            "batch32": {"ms": min(k1, k2), "device_ms": d_batch, "plain_ms": min(p1, p2), "bound_ms": bound,
                        "bound_by": bound_by},
            f"sources_{nsub}": {"ms": k_sub, "device_ms": d_sub, "bound_ms": bound_sub, "bound_by": by_sub},
        })
    del batch_args, plain_batches, whole

    # BeamFormCat's split: one synchronised run of its stages on the whole
    # catalogue, against the Manager's formed beams
    t = [_sync_clock(device)]
    tracks = task._source_tracks()
    t.append(_sync_clock(device))
    beams = task._track_beams(tracks)
    t.append(_sync_clock(device))
    sums = task._track_sums(tracks, slice(None))
    t.append(_sync_clock(device))
    formed, wformed = task._finish_tracks(tracks, slice(None), sums, beams)
    t.append(_sync_clock(device))
    del sums, beams
    split = np.diff(t)
    log(f"BeamFormCat split ({nsrc} sources, {task.npol} pols; s): host windows {split[0]:.4f}, beam_at "
        f"{split[1]:.4f}, contraction (row plan + kernel, {task.npol} launches) {split[2]:.4f}, torch normalisation "
        f"{split[3]:.4f}; the Manager's first BeamFormCat "
        f"{next(t for name, t in timing.items() if name.startswith('BeamFormCat'))} s in all")
    err_split = max(np.abs(formed.cpu().numpy() - beam).max() / np.abs(beam).max(),
                    np.abs(wformed.cpu().numpy() - fw).max() / np.abs(fw).max())
    check("the split run's formed beams and weights vs the Manager's", f"{err_split:.3e} (limit "
          f"{TOL_BEAMFORM_KERNEL})", err_split <= TOL_BEAMFORM_KERNEL)
    kern["beamform"]["beamformcat_split_s"] = dict(zip(("host_windows", "beam_at", "contraction", "normalisation"),
                                                       split.tolist()))
    del task, tracks, formed, wformed
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


def flag_cells(nfreq: int, ntime: int):
    """Phase 19a's injected interference, its places and the lines' lengths
    scaled from a day of ``FLAG_DAY`` samples to ``nfreq`` channels and
    ``ntime`` samples (the bursts' lengths not): [(freq slice, time slice)]
    of the narrowband lines and of the broadband bursts.  A line longer than
    ~10% of its channel's samples moves the channel's 15% time quantile
    enough that ``RFISensitivityMask``'s 1-D mask takes the whole channel."""
    nline = FLAG_NARROW_LEN * ntime // FLAG_DAY
    narrow = [(slice(f * nfreq // FLAG_NFREQ, f * nfreq // FLAG_NFREQ + 1),
               slice(t * ntime // FLAG_DAY, t * ntime // FLAG_DAY + nline)) for f, t in FLAG_NARROW]
    bursts = [(slice(0, nfreq), slice(t * ntime // FLAG_DAY, t * ntime // FLAG_DAY + n)) for t, n in FLAG_BURSTS]
    return narrow, bursts


def flag_correlator(ts, tel, rng_seed: int):
    """Give phase 18's day stream the autos and weights a correlator reports,
    and the phase's interference in every product of its cells.

    Autos: ``FLAG_TSYS`` per polarisation (real).  Weights: the radiometer
    equation's ``nint * cnt / (T_a T_b)`` for a stack of ``cnt`` products,
    divided by ``g^2``, where ``g = 1 + FLAG_SIGMA * n`` (n a standard normal
    draw per (freq, pol group, time)) is the sample-to-sample scatter of the
    weights a correlator estimates: the radiometer metric
    (``ComputeSystemSensitivity``'s measured over radiometric noise) is then
    ``g``.  In an interference cell the autos (and the cross products) gain
    the power ``FLAG_TSYS`` and the weights drop by the square of the doubled
    power and of ``1 + FLAG_AMP * FLAG_SIGMA``: the metric rises by
    ``FLAG_AMP`` times its own scatter.  Returns the boolean [freq, time]
    map of the injected cells."""
    import torch

    vis, weight = ts.vis[:], ts.weight[:]
    dev = vis.device
    nfreq, nstack, ntime = vis.shape
    ps = ts.prodstack
    pol = np.asarray(tel.polarisation)
    pa, pb = pol[ps["input_a"].astype(int)], pol[ps["input_b"].astype(int)]
    group = np.where(pa == pb, np.where(pa == "X", 0, 2), 1)  # XX, XY, YY
    tsys = np.where(pol == "X", FLAG_TSYS[0], FLAG_TSYS[1])
    t_a, t_b = tsys[ps["input_a"].astype(int)], tsys[ps["input_b"].astype(int)]
    rev = np.asarray(ts.reverse_map["stack"]["stack"]).astype(int)
    cnt = np.bincount(rev[rev < nstack], minlength=nstack).astype(np.float64)
    autos = np.flatnonzero(ps["input_a"] == ps["input_b"])
    nint = np.median(ts.index_map["freq"]["width"]) * 1e6 * np.median(np.diff(ts.time))

    zeroed = torch.nonzero(weight == 0, as_tuple=True)  # the day file's flagged cells stay flagged
    inj = np.zeros((nfreq, ntime), dtype=bool)
    for fs, tsl in sum(flag_cells(nfreq, ntime), []):
        inj[fs, tsl] = True
    gen = torch.Generator(device=dev)
    gen.manual_seed(rng_seed)
    g = 1.0 + FLAG_SIGMA * torch.randn((nfreq, 3, ntime), generator=gen, device=dev, dtype=torch.float64)
    inj_t = torch.as_tensor(inj, device=dev)
    g = torch.where(inj_t[:, None], g * (1.0 + FLAG_AMP * FLAG_SIGMA), g)
    power = torch.where(inj_t, 2.0, 1.0).to(torch.float64)  # [freq, time]
    base = torch.as_tensor(nint * cnt / (t_a * t_b), device=dev)  # [stack]
    group_t = torch.as_tensor(group, device=dev)
    auto_t = torch.as_tensor(autos, device=dev)
    auto_power = torch.as_tensor(np.where(pa == "X", FLAG_TSYS[0], FLAG_TSYS[1])[autos], device=dev)
    for f in range(nfreq):
        gf = g[f].index_select(0, group_t)  # [stack, time]
        weight[f] = base[:, None] / (gf * power[f]) ** 2
        vis[f] += (FLAG_TSYS[0] * inj_t[f]).to(vis.dtype)[None]
        vis[f, auto_t] = (auto_power[:, None] * power[f][None]).to(vis.dtype)
    weight[zeroed] = 0.0
    return inj


def flag_tasks() -> dict:
    """Define phase 19's source task (one day of phase 18's stream with a
    correlator's autos, weights and interference), its probes and its list
    maker in this module; return their task paths."""
    import torch

    from draco_tpu_torch.analysis.beamform import icrs_to_cirs
    from draco_tpu_torch.analysis.flagging import RFISensitivityMask
    from draco_tpu_torch.analysis.transform import TelescopeStreamMixIn
    from draco_tpu_torch.core import config, io
    from draco_tpu_torch.core.task import ContainerTask, PipelineStopIteration
    from draco_tpu_torch.device import resolve

    class EmitFlagDay(ContainerTask):
        """Samples [0, ntime) of phase 18's day stream (its noise, flagged
        cells and catalogue sources), through :func:`flag_correlator`."""

        ntime = config.int_prop(FLAG_NTIME)

        def setup(self, tel):
            self.tel = io.get_telescope(tel)
            self.maps = TelescopeStreamMixIn()
            self.maps.setup(self.tel)
            ra, dec, _ = stack_catalog(self.tel, STACK_NSRC, STACK_NINJ, self.tel.nfreq)
            ra_c, dec_c = icrs_to_cirs(ra[:STACK_NINJ], dec[:STACK_NINJ], stack_epoch(self.tel, 1))
            self.sources = [(r, d, STACK_FLUX) for r, d in zip(ra_c, dec_c)]

        def process(self):
            if self._count:
                raise PipelineStopIteration()
            ts = stack_day_file(self.tel, self.maps, 0, self.ntime, STACK_NTIME, self.sources, resolve(),
                                _seed(FLAG_SEED, 0))
            ts.create_index_map("input", self.tel.input_index)  # the correlator's labels of the feeds
            FLAG_PROBES["injected"] = flag_correlator(ts, self.tel, _seed(FLAG_SEED, 1))
            # the weights and autos ComputeSystemSensitivity reads, at the
            # host check's sampled times (later tasks edit the weights)
            tsel = torch.as_tensor(FLAG_PROBES["sens_times"], device=ts.vis[:].device)
            ps = ts.prodstack
            autos = torch.as_tensor(np.flatnonzero(ps["input_a"] == ps["input_b"]), device=tsel.device)
            FLAG_PROBES["weights0"] = ts.weight[:].index_select(2, tsel)
            FLAG_PROBES["autos0"] = ts.vis[:].index_select(1, autos).index_select(2, tsel).real.clone()
            ts.attrs["tag"] = "flagday"
            return ts

    class FlagProbe(ContainerTask):
        """Passes its input through; keeps under ``key`` the container
        (``kind: keep``), a copy of its vis on the card (``kind: copy``) or
        the vis at the ``FLAG_PROBES`` sampled rows (``kind: rows``)."""

        key = config.str_prop("x")
        kind = config.str_prop("copy")

        def process(self, data):
            v = data.vis[:] if self.kind != "keep" else None
            if self.kind == "keep":
                FLAG_PROBES[self.key] = data
            elif self.kind == "copy":
                FLAG_PROBES[self.key] = v.clone()
            else:
                idx = FLAG_PROBES[self.key + "_rows"]
                FLAG_PROBES[self.key] = v[tuple(torch.as_tensor(i, device=v.device) for i in idx)].cpu().numpy()
            return data

    class Collect(ContainerTask):
        """Its inputs as one list, for ``CombineMasks``."""

        def process(self, *items):
            return list(items)

    class KeepPreSIR(RFISensitivityMask):
        """``RFISensitivityMask`` that keeps the mask its SIR dilates."""

        def _apply_sir(self, mask, baseflag, eta=None):
            FLAG_PROBES["pre_sir"] = mask.copy()
            return super()._apply_sir(mask, baseflag, eta)

    for cls in (EmitFlagDay, FlagProbe, Collect, KeepPreSIR):
        globals()[cls.__name__] = cls
    return {cls.__name__: f"{__name__}.{cls.__name__}" for cls in (EmitFlagDay, FlagProbe, Collect, KeepPreSIR)}


def flag_config(product_dir: str, paths: dict, ntime: int, nfreq: int, transient: tuple) -> dict:
    """Phase 19a's chain as a pipeline config mapping."""
    fl = "draco.analysis.flagging."
    transient_in = "tstream"
    whole = tuple(transient) == (0, nfreq)
    masks = ["sens_mask", "static_mask"] + (["transient_mask"] if whole else [])
    tasks = [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"], "params": {"product_directory": product_dir}},
        {"type": paths["EmitFlagDay"], "requires": "tel", "out": "tstream", "params": {"ntime": ntime}},
        {"type": "draco.analysis.sensitivity.ComputeSystemSensitivity", "requires": "tel", "in": "tstream",
         "out": "sens"},
        {"type": paths["FlagProbe"], "in": "sens", "out": "sens_p", "params": {"key": "sens", "kind": "keep"}},
        {"type": paths["KeepPreSIR"], "in": "sens_p", "out": "sens_mask", "params": {"sir": True}},
        {"type": fl + "ApplyTimeFreqMask", "in": ["tstream", "sens_mask"], "out": "tstream_sens",
         "params": {"share": "vis"}},
    ]
    if not whole:
        transient_in = "tstream_cut"
        tasks.append({"type": "draco.analysis.transform.SelectFreq", "in": "tstream", "out": transient_in,
                      "params": {"channel_range": list(transient)}})
    tasks += [
        {"type": fl + "RFITransientVisMask", "requires": "tel", "in": transient_in, "out": "transient_mask"},
        {"type": fl + "RFIStaticVisMask", "requires": "tel", "in": "tstream", "out": "static_mask",
         "params": {"stokes_i": False, "axes": ["stack"], "dataset": "vis", "weighting": "weighted"}},
        {"type": paths["Collect"], "in": masks, "out": "masks"},
        {"type": fl + "CombineMasks", "in": "masks", "out": "combined"},
        {"type": paths["FlagProbe"], "in": "tstream", "out": "tstream_p", "params": {"key": "dx"}},
        {"type": "draco.analysis.fringestop.DownMix", "requires": "tel", "in": "tstream_p", "out": "tdown"},
        {"type": paths["FlagProbe"], "in": "tdown", "out": "tdown_p", "params": {"key": "ddown", "kind": "rows"}},
        {"type": "draco.analysis.fringestop.UpMix", "requires": "tel", "in": "tdown_p", "out": "tup"},
        {"type": fl + "ApplyTimeFreqMask", "in": ["tup", "combined"], "out": "tmasked"},
        {"type": fl + "SanitizeWeights", "in": "tmasked", "out": "tclean"},
        {"type": fl + "ThresholdVisWeightFrequency", "in": "tclean", "out": "freq_mask"},
    ]
    return {"pipeline": {"retain_products": "all", "tasks": tasks}}


def flag_config_b(product_dir: str, source: str, paths: dict, nra: int, npix: int) -> dict:
    """Phase 19b's chain: phase 17's hybrid stream, the mixers and the beam stream."""
    rmm, fs = "draco.analysis.ringmapmaker.", "draco.analysis.fringestop."
    return {"pipeline": {"retain_products": "final", "tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"], "params": {"product_directory": product_dir}},
        {"type": source, "requires": "tel", "out": "sstream", "params": {"nra": nra, "npix": npix}},
        {"type": rmm + "MakeVisGrid", "requires": "tel", "in": "sstream", "out": "grid"},
        {"type": rmm + "BeamformNS", "in": "grid", "out": "hstream",
         "params": {"npix": npix, "span": 1.0, "weight": "natural", "precision": 64}},
        {"type": paths["FlagProbe"], "in": "hstream", "out": "hstream_p", "params": {"key": "hx"}},
        {"type": fs + "DownMix", "requires": "tel", "in": "hstream_p", "out": "hdown"},
        {"type": paths["FlagProbe"], "in": "hdown", "out": "hdown_p", "params": {"key": "hdown", "kind": "rows"}},
        {"type": fs + "UpMix", "requires": "tel", "in": "hdown_p", "out": "hup"},
        {"type": paths["FlagProbe"], "in": "hup", "out": "hup_p", "params": {"key": "hup", "kind": "keep"}},
        {"type": "draco.analysis.beam.CreateBeamStreamFromTelescope", "requires": "tel", "in": "hup_p",
         "out": "bstream"},
    ]}}


def host_sensitivity(tel, ts_w, ts_autos, ps, rev, nstack: int, nint: float):
    """``ComputeSystemSensitivity``'s measured and radiometric noise [pol, t]
    of one channel in float64 numpy, from the channel's weights [stack, t]
    and auto stacks' real parts [nauto, t]: the radiometer equation written
    out (every input flag is 1)."""
    pol = np.asarray(tel.polarisation)
    pa, pb = pol[ps["input_a"].astype(int)], pol[ps["input_b"].astype(int)]
    label = np.char.add(np.where(pa <= pb, pa, pb), np.where(pa <= pb, pb, pa))
    cnt = np.bincount(rev[rev < nstack], minlength=nstack).astype(np.float64)
    auto = ps["input_a"] == ps["input_b"]
    scale = np.where(auto, 1.0, 2.0)
    w = ts_w.astype(np.float64)
    live = (w > 0).astype(np.float64)
    inv = np.divide(1.0, w, out=np.zeros_like(w), where=w > 0)
    meas, rad = [], []
    apol = pa[auto]
    nfeed = cnt[auto][:, None] * (ts_w[auto] > 0)
    x = nfeed * ts_autos.astype(np.float64)
    for p in ("XX", "XY", "YY"):
        m = label == p
        contrib = (cnt * scale)[m][:, None] * live[m]
        counter = contrib.sum(axis=0)
        meas.append(np.sqrt(2.0 * (contrib * cnt[m][:, None] * inv[m]).sum(axis=0) / counter**2))
        pairs = [(i, j) for i in range(len(apol)) for j in range(len(apol))
                 if "".join(sorted(apol[i] + apol[j])) == p]
        num = sum(x[i] * x[j] for i, j in pairs)
        den = sum(nfeed[i] * nfeed[j] for i, j in pairs)
        rad.append(np.sqrt(2.0 * num / (nint * den**2)))
    return np.array(meas), np.array(rad)


def sir_margin(mask_row: np.ndarray, i: int, eta: float):
    """The largest ``flagged - (1 - eta) * length`` over the windows of a
    boolean row that contain sample ``i``, in exact rational arithmetic:
    SIR flags ``i`` iff it is >= 0, and 0 is the tie."""
    from fractions import Fraction

    keep = 1 - Fraction(str(eta))
    c = np.concatenate([[0], np.cumsum(mask_row.astype(np.int64))])
    q = [Fraction(int(c[k])) - keep * k for k in range(len(c))]
    return max(q[i + 1 :]) - min(q[: i + 1])


def _native_timer():
    """Wrap the native medians so that their calls and seconds are counted;
    returns (counts dict, restore function)."""
    from draco_tpu_torch import native

    counts = {"calls": 0, "seconds": 0.0}
    saved = {}
    for name in ("weighted_median", "moving_weighted_median"):
        fn = saved[name] = getattr(native, name)

        def timed(*a, _fn=fn, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                counts["calls"] += 1
                counts["seconds"] += time.perf_counter() - t0

        setattr(native, name, timed)

    def restore():
        for name, fn in saved.items():
            setattr(native, name, fn)

    return counts, restore


def _flag_run(label: str, cfg: dict, device, medians: dict) -> dict:
    """Run one of phase 19's configs through the Manager; print its per-task
    seconds, wall time, peak device memory and native medians' share."""
    import gc

    import torch

    from draco_tpu_torch.core.pipeline import Manager

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    before = dict(medians)
    manager = Manager(cfg)
    t0 = _sync_clock(device)
    products = manager.run()
    wall = _sync_clock(device) - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else float("nan")
    timing = {name.split(".")[-1]: round(t["wall"], 4) for name, t in manager.task_timing.items()}
    nmed, smed = medians["calls"] - before["calls"], medians["seconds"] - before["seconds"]
    log(f"phase {label} Manager run: {wall:.2f} s wall, peak device memory {peak:.2f} GiB; native medians {nmed} "
        f"calls, {smed:.2f} s ({100 * smed / wall:.1f}% of the run)")
    log(f"phase {label} task_timing (s): " + json.dumps(timing))
    return products


def run_flagging(device, ncyl: int = 4, nfeed: int = 256, nfreq: int = RING_NFREQ, ntime: int = FLAG_NTIME,
                 transient: tuple = FLAG_TRANSIENT_CHANNELS, nra: int = RING_NRA, npix: int = RING_NPIX,
                 ncheck: int = N_FLAG_CHECK, nsens_t: int = N_FLAG_SENS_T):
    """Phase 19: the flagging and fringe-stop path through the Manager.

    The sizes default to the phase's; smaller ones make it a rehearsal on
    the CPU.
    """
    import gc
    import os
    import pickle
    import tempfile

    import torch

    from draco_tpu_torch import native
    from draco_tpu_torch.analysis.beam import phased_beam
    from draco_tpu_torch.analysis.fringestop import mix_in_place
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.ops import rfi
    from draco_tpu_torch.ops.interferometry import projected_distance
    from draco_tpu_torch.ops.tools import taper_mask

    failures = []
    t_phase = time.perf_counter()

    def check(label, value, ok):
        log(f"  {label}: {value}  [{'ok' if ok else 'FAIL'}]")
        if not ok:
            failures.append(label)

    tel = ring_telescope(ncyl, nfeed, nfreq)
    nstack = tel.npairs
    FLAG_PROBES.clear()
    GB = 1e9
    native.load()
    log(f"flagging path: host {os.cpu_count()} CPUs, native medians {native.omp_threads()} OpenMP threads, "
        f"library build {native.build_seconds:.2f} s (0: built before this process); {ncyl} x {nfeed} dual-pol "
        f"feeds, {nstack} stacks, {nfreq} channels; 19a: {ntime} samples of a day, stream "
        f"{12 * nfreq * nstack * ntime / GB:.2f} GB, RFITransientVisMask on channels {transient[0]}-{transient[1] - 1}; "
        f"19b: the hybrid stream [4, {nfreq}, ew, {npix}, {nra}]")
    paths = flag_tasks()
    source, _ = ring_tasks()
    medians, restore = _native_timer()
    try:
        with tempfile.TemporaryDirectory() as product_dir:
            with open(Path(product_dir) / "telescope.pkl", "wb") as f:
                pickle.dump(tel, f)

            # 19a: time-stream RFI, with the rows and times its host checks sample
            rng = np.random.Generator(np.random.SFC64(FLAG_SEED + 1))
            FLAG_PROBES["ddown_rows"] = (rng.integers(0, nfreq, ncheck), rng.integers(0, nstack, ncheck))
            FLAG_PROBES["sens_times"] = np.sort(rng.choice(ntime, nsens_t, replace=False))
            products = _flag_run("19a", flag_config(product_dir, paths, ntime, nfreq, transient), device, medians)
            flag_checks_a(products, tel, device, ntime, nfreq, ncheck, nsens_t, check)
            del products
            FLAG_PROBES.pop("dx", None)

            # 19b: the hybrid stream's mixers and its beam stream
            rng = np.random.Generator(np.random.SFC64(FLAG_SEED))
            FLAG_PROBES["hdown_rows"] = (rng.integers(0, 4, ncheck), rng.integers(0, nfreq, ncheck),
                                         rng.integers(0, ncyl, ncheck), rng.integers(0, npix, ncheck))
            bstream = _flag_run("19b", flag_config_b(product_dir, source, paths, nra, npix), device,
                                medians)["bstream"][0]
        hup = FLAG_PROBES.pop("hup")
        # UpMix(DownMix(x)) against x, and DownMix's sampled rows against float64 on the host
        x0 = FLAG_PROBES.pop("hx")
        num = (torch.view_as_real(hup.vis[:] - x0).double() ** 2).sum()
        rel = float(torch.sqrt(num / (torch.view_as_real(x0).double() ** 2).sum()))
        check("19b hybrid stream UpMix(DownMix(x)) relative RMS", f"{rel:.3e} (limit {FLAG_TOL_ROUNDTRIP})",
              rel <= FLAG_TOL_ROUNDTRIP)
        pi, fi, ei, li = FLAG_PROBES["hdown_rows"]
        el = np.asarray(hup.index_map["el"])
        ew = np.asarray(hup.index_map["ew"])
        nu = np.asarray(hup.freq) * 1e6 / FLAG_C
        omega = 2 * np.pi * nu[fi] * ew[ei] * np.cos(np.arcsin(el[li]) + np.radians(tel.latitude))
        rows0 = x0[tuple(torch.as_tensor(i, device=x0.device) for i in (pi, fi, ei, li))].cpu().numpy()
        want = rows0.astype(np.complex128) * np.exp(1j * omega[:, None] * np.radians(np.asarray(hup.ra))[None])
        err = np.abs(FLAG_PROBES["hdown"] - want).max() / np.abs(want).max()
        check(f"19b hybrid DownMix on {ncheck} sampled (pol, freq, ew, el) rows vs float64 on the host",
              f"{err:.3e} (limit {FLAG_TOL_MIX})", err <= FLAG_TOL_MIX)
        del x0

        # the beam stream's sampled rows and el-averaged weights against float64 on the host
        t0 = time.perf_counter()
        dec = np.degrees(np.arcsin(el)) + tel.latitude
        ha = (np.asarray(hup.ra) + 180.0) % 360.0 - 180.0
        pols = [p.decode() if isinstance(p, bytes) else str(p) for p in hup.index_map["pol"]]
        tpol = list(tel.polarisation)
        tel_f = np.argmin(np.abs(np.asarray(hup.freq)[:, None] - tel.frequencies[None]), axis=1)
        got = bstream.vis[:][tuple(torch.as_tensor(i, device=device) for i in (pi, fi, ei, li))].cpu().numpy()
        want = np.zeros_like(got, dtype=np.complex128)
        for k in range(ncheck):
            angpos = np.stack([np.full(ha.size, 0.5 * np.pi - np.radians(dec[li[k]])), np.radians(ha)], axis=-1)
            ba = np.asarray(tel.beam_at(tpol.index(pols[pi[k]][0]), tel_f[fi[k]], angpos))
            bb = np.asarray(tel.beam_at(tpol.index(pols[pi[k]][1]), tel_f[fi[k]], angpos))
            power = (ba * bb.conj()).sum(axis=-1) if ba.ndim == 2 else ba * bb.conj()
            rot = np.radians(getattr(tel, "rotation_angle", 0.0))
            d = projected_distance(np.radians(ha), np.radians(tel.latitude), np.radians(dec[li[k]]),
                                   np.cos(rot) * ew[ei[k]] * nu[fi[k]], np.sin(rot) * ew[ei[k]] * nu[fi[k]])
            want[k] = power * np.exp(2j * np.pi * d)
        berr = np.abs(got - want).max() / np.abs(want).max()
        wgot = bstream.weight[:].cpu().numpy()
        check(f"19b beam stream on {ncheck} sampled (pol, freq, ew, el) rows vs float64 beam_at and phasor on the "
              f"host ({time.perf_counter() - t0:.1f} s); el-averaged weights",
              f"{berr:.3e} (limit {FLAG_TOL_BEAM}); weights in [{wgot.min():g}, {wgot.max():g}] (expect 1)",
              berr <= FLAG_TOL_BEAM and np.all(wgot == 1.0))
        ok = (isinstance(bstream, containers.HybridVisStream) and tuple(bstream.vis.shape) == tuple(hup.vis.shape)
              and bool(torch.isfinite(torch.view_as_real(bstream.vis[:])).all()))
        check("19b beam stream type, shape, finite", f"{type(bstream).__name__} {tuple(bstream.vis.shape)}", ok)

        # the device programs of the path, each timed alone on the phase's shapes
        progs = {}
        t0 = _sync_clock(device)
        mix_in_place(hup.vis[:], torch.as_tensor(np.zeros((nfreq, len(ew), len(el))), device=device),
                     torch.as_tensor(np.radians(np.asarray(hup.ra)), device=device), freq_axis=1)
        progs["fringestop.mix_in_place (hybrid)"] = _sync_clock(device) - t0
        bw = torch.ones((nfreq, 4, 1, len(el), len(ha)), dtype=torch.float32, device=device)
        bb_ = torch.ones((4, nfreq, 1, len(el), len(ha)), dtype=torch.complex64, device=device)
        u = np.asarray(hup.freq)[:, None] * 1e6 / FLAG_C * ew[None]
        t0 = _sync_clock(device)
        phased_beam(bb_, bw, np.radians(ha), np.radians(dec), u, 0.0 * u, np.radians(tel.latitude))
        progs["beam.phased_beam"] = _sync_clock(device) - t0
        del bw, bb_, hup, bstream
        gc.collect()
        metric = FLAG_PROBES["metric"]
        good = FLAG_PROBES["metric_good"]
        t0 = _sync_clock(device)
        rfi.sumthreshold(metric, 64, start_flag=~good, threshold1=5.0, remove_median=False, rho=1.0,
                         variance=np.ones_like(metric), device=device)
        progs["rfi.sumthreshold (max_m 64)"] = _sync_clock(device) - t0
        t0 = _sync_clock(device)
        rfi.scale_invariant_rank(~good, eta=0.2, axis=(0, -1), device=device)
        progs["rfi.scale_invariant_rank"] = _sync_clock(device) - t0
        t0 = _sync_clock(device)
        taper_mask(~good, 32, device=device)
        progs["tools.taper_mask (nwidth 32)"] = _sync_clock(device) - t0
        progs.update(FLAG_PROBES.pop("sens_progs"))
        log("phase 19 device programs alone (s): " + json.dumps({k: round(v, 4) for k, v in progs.items()}))
    finally:
        restore()
    FLAG_PROBES.clear()
    log(f"phase 19 native medians: {medians['calls']} calls, {medians['seconds']:.2f} s of the phase's "
        f"{time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise RuntimeError(f"phase 19 (flagging path) failed: {', '.join(failures)}")


def flag_checks_a(products, tel, device, ntime: int, nfreq: int, ncheck: int, nsens_t: int, check):
    """Phase 19a's checks on its Manager run's products."""
    import torch

    from draco_tpu_torch.analysis.sensitivity import measured_noise
    from draco_tpu_torch.core import containers
    from draco_tpu_torch.device import default_device
    from draco_tpu_torch.ops import median

    sens, mask = FLAG_PROBES.pop("sens"), products["sens_mask"][0]
    inj = FLAG_PROBES.pop("injected")
    m = np.asarray(mask.mask[:])
    check("19a every injected sample masked by RFISensitivityMask",
          f"{int(m[inj].sum())} of {int(inj.sum())} ({len(FLAG_NARROW)} lines x {FLAG_NARROW_LEN * ntime // FLAG_DAY}"
          f" samples, {len(FLAG_BURSTS)} bursts of 3-10 samples, at {FLAG_AMP:g} x the metric's scatter)",
          bool(m[inj].all()))
    outside = float(m[~inj].mean())
    check("19a masked fraction outside the injected cells", f"{outside:.5f} (limit {FLAG_MASKED_MAX})",
          outside < FLAG_MASKED_MAX)
    for label in ("static_mask", "transient_mask", "combined", "freq_mask"):
        if label in products:
            mk = np.asarray(products[label][0].mask[:])
            sub = inj[slice(*FLAG_TRANSIENT_CHANNELS) if mk.shape[0] < nfreq else slice(None)]
            log(f"  19a {label}: masked share {mk.mean():.5f}, of the injected cells {mk[sub].mean():.5f}")
    clean = products["tclean"][0]
    w = clean.weight[:]
    cm = torch.as_tensor(np.asarray(products["combined"][0].mask[:]), device=w.device)
    ok = bool((w.amax(dim=1) == 0)[cm].all()) and bool(torch.isfinite(w).all())
    check("19a combined mask applied (every masked (freq, time) weight 0), SanitizeWeights output finite",
          f"combined share {float(cm.float().mean()):.5f}", ok)

    # the sensitivity against float64 numpy on the host
    tstream = products["tstream_sens"][0]
    ps = tstream.prodstack
    rev = np.asarray(tstream.reverse_map["stack"]["stack"]).astype(int)
    nstack = tstream.vis.shape[1]
    nint = np.median(tstream.index_map["freq"]["width"]) * 1e6 * np.median(np.diff(tstream.time))
    tsel_t = torch.as_tensor(FLAG_PROBES.pop("sens_times"), device=device)
    w0, a0 = FLAG_PROBES.pop("weights0").cpu().numpy(), FLAG_PROBES.pop("autos0").cpu().numpy()
    t0 = time.perf_counter()
    worst = 0.0
    nrows = 0
    for f in range(nfreq):
        wf, af = w0[f], a0[f]
        hm, hr = host_sensitivity(tel, wf, af, ps, rev, nstack, nint)
        gm = sens.measured[:][f].index_select(1, tsel_t).cpu().numpy()
        gr = sens.radiometer[:][f].index_select(1, tsel_t).cpu().numpy()
        worst = max(worst, float(np.max(np.abs(gm - hm) / np.abs(hm))), float(np.max(np.abs(gr - hr) / np.abs(hr))))
        nrows += 3
    check(f"19a sensitivity on all {nrows} (freq, pol) rows (the phase has fewer than {ncheck}) at {nsens_t} sampled "
          f"times vs float64 numpy on the host ({time.perf_counter() - t0:.1f} s)",
          f"{worst:.3e} (limit {FLAG_TOL_SENS})", worst <= FLAG_TOL_SENS)

    # RFISensitivityMask again on the CPU, on the same SystemSensitivity
    pre_card = FLAG_PROBES.pop("pre_sir")
    cpu_sens = containers.SystemSensitivity(axes_from=sens, attrs_from=sens, device="cpu")
    for name in ("measured", "radiometer", "weight", "frac_lost"):
        cpu_sens.datasets[name][:] = sens.datasets[name][:].cpu()
    t0 = time.perf_counter()
    with default_device("cpu"):
        task = KeepPreSIR()
        task.read_config({"sir": True})
        task.setup()
        cpu_mask = np.asarray(task.process(cpu_sens).mask[:])
    cpu_s = time.perf_counter() - t0
    diff = np.argwhere(cpu_mask != m)
    pre_cpu = FLAG_PROBES.pop("pre_sir")
    same_pre = np.array_equal(pre_cpu, pre_card)
    notes = []
    allowed = same_pre
    for f, t in diff:
        margins = (sir_margin(pre_card[f], t, 0.2), sir_margin(pre_card[:, t], f, 0.2))
        allowed &= max(margins) == 0
        notes.append(f"({f}, {t}): card {bool(m[f, t])}, CPU {bool(cpu_mask[f, t])}, SIR margin over time "
                     f"{float(margins[0]):+.3f} / freq {float(margins[1]):+.3f}")
    check(f"19a RFISensitivityMask on the CPU ({cpu_s:.1f} s) against the card: the masks before SIR "
          f"{'equal' if same_pre else 'DIFFER'}; after SIR {len(diff)} samples differ, each allowed only at an "
          "exact SIR tie (margin 0: the float64 rounding of the prefix sums decides it)",
          "; ".join(notes) or "identical", allowed)

    # one (37, 181) moving median of the metric, native against numpy
    metric = np.asarray(sens.measured[:][:, 0].cpu().numpy(), dtype=np.float64) / np.asarray(
        sens.radiometer[:][:, 0].cpu().numpy(), dtype=np.float64)
    good = ~m
    FLAG_PROBES["metric"], FLAG_PROBES["metric_good"] = metric, good
    n = min(1024, ntime)
    xs, ws = metric[:, :n], good[:, :n].astype(np.float64)
    t0 = time.perf_counter()
    nat = median.moving_weighted_median(xs, ws, (37, 181))
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = median.moving_weighted_median(xs, ws, (37, 181), method="numpy")
    t_np = time.perf_counter() - t0
    check(f"19a one (37, 181) moving median on the metric's [{nfreq}, {n}] slice, native ({t_nat:.2f} s) against "
          f"numpy ({t_np:.2f} s)", "identical" if np.array_equal(nat, ref) else "DIFFERENT", np.array_equal(nat, ref))

    # the day stream's mixers: UpMix(DownMix(x)) against x, DownMix's rows against float64 on the host
    tup = products["tmasked"][0]
    x0 = FLAG_PROBES["dx"]
    num = (torch.view_as_real(tup.vis[:] - x0).double() ** 2).sum()
    rel = float(torch.sqrt(num / (torch.view_as_real(x0).double() ** 2).sum()))
    check("19a day stream UpMix(DownMix(x)) relative RMS", f"{rel:.3e} (limit {FLAG_TOL_ROUNDTRIP})",
          rel <= FLAG_TOL_ROUNDTRIP)
    fi, si = FLAG_PROBES["ddown_rows"]
    pos = tel.feedpositions[:, 0]
    sep = pos[ps["input_a"][si].astype(int)] - pos[ps["input_b"][si].astype(int)]
    nu = np.asarray(tup.freq)[fi] * 1e6 / FLAG_C
    omega = 2 * np.pi * nu * sep * np.cos(np.radians(tel.latitude))
    phi = np.radians(tel.unix_to_lsa(np.asarray(tup.time)))
    rows0 = x0[torch.as_tensor(fi, device=x0.device), torch.as_tensor(si, device=x0.device)].cpu().numpy()
    want = rows0.astype(np.complex128) * np.exp(1j * omega[:, None] * phi[None])
    err = np.abs(FLAG_PROBES["ddown"] - want).max() / np.abs(want).max()
    check(f"19a day stream DownMix on {ncheck} sampled (freq, stack) rows vs float64 on the host",
          f"{err:.3e} (limit {FLAG_TOL_MIX})", err <= FLAG_TOL_MIX)

    # the sensitivity's einsums alone, one channel at a time as the task runs them
    dev = sens.measured[:].device
    member = torch.ones((3, nstack), dtype=torch.float32, device=dev)
    scale = torch.ones(nstack, dtype=torch.float32, device=dev)
    cnt = torch.ones((1, nstack, ntime), dtype=torch.float32, device=dev)
    t0 = _sync_clock(dev)
    for f in range(nfreq):
        measured_noise(member, scale, cnt, tup.weight[:][f : f + 1].float())
    FLAG_PROBES["sens_progs"] = {"sensitivity.measured_noise (all channels)": _sync_clock(dev) - t0}


def filt_flag_ra(nra: int):
    """Phase 16's flagged RA samples, moved onto a grid of ``nra`` samples."""
    return tuple(sorted({r * nra // DELAY_NRA for r in DELAY_FLAG_RA}))


def filt_tone_products(tel):
    """The stacks whose baseline vector is the Stokes-I baseline nearest ``FILT_TONE``'s, and that baseline's
    index among ``stokes_I_index``'s unique baselines."""
    from draco_tpu_torch.analysis.transform import stokes_I_index

    _, _, ubase = stokes_I_index(tel)
    b = int(np.argmin(np.abs(ubase - np.asarray(FILT_TONE[0])).sum(axis=1)))
    bl = tel.baselines
    return np.flatnonzero(np.abs(bl - ubase[b]).sum(axis=1) < 1e-4), b


def filt_tone(tel, nra: int, device):
    """The tone [nfreq, nra] added to the tone's stacks: ``FILT_TONE``'s delay with a complex Gaussian
    amplitude that changes from one RA sample to the next (the wavelet spectrum is a variance over RA)."""
    import torch

    rng = np.random.Generator(np.random.SFC64(FILT_SEED))
    amp = (rng.standard_normal(nra) + 1j * rng.standard_normal(nra)) * FILT_TONE[2] / np.sqrt(2)
    nu = torch.as_tensor(tel.frequencies, dtype=torch.float64, device=device)
    ph = torch.polar(torch.ones_like(nu), 2 * np.pi * FILT_TONE[1] * nu)
    return (ph[:, None] * torch.as_tensor(amp, device=device)[None]).to(torch.complex64)


def mf_flags(nfreq: int, nra: int):
    return [(f * nfreq // 16, r * nra // MF_NRA) for f, r in MF_FLAGS]


def mf_components(tel, prods, nra: int, device):
    """20b's passed and rejected components [nfreq, len(prods), nra] (complex64, phases in float64) and each
    row's EW separation.

    Intracylinder rows: tones at ``MF_INTRA_M``; intercylinder rows: the
    fringe of a source at ``MF_DEC`` at transit (``DayenuMFilter``'s mixing
    frequency) and a tone ``MF_INTER_OFFSET`` above it.  Every component has
    the Gaussian envelope of a source transiting at RA 180 (``MF_ENVELOPE``
    degrees), so that it is band-limited within the RA span: the filter
    does not wrap in RA, and a component cut off at the span's ends has a
    spread of m that reaches the other band.
    """
    import torch

    from draco_tpu_torch.analysis.dayenu import C_LIGHT
    from draco_tpu_torch.ops.dayenu import instantaneous_m

    pairs = np.asarray(tel.uniquepairs)[prods]
    pos = tel.feedpositions
    spacing = tel.cylinder_spacing
    ub = np.round((pos[pairs[:, 0], 0] - pos[pairs[:, 1], 0]) / spacing) * spacing
    intra = np.abs(ub) < 0.5 * spacing
    phi = torch.as_tensor(np.radians(np.linspace(0.0, 360.0, nra, endpoint=False)), device=device)
    env = torch.exp(-0.5 * ((phi - np.pi) / np.radians(MF_ENVELOPE)) ** 2)
    P = torch.zeros((tel.nfreq, len(prods), nra), dtype=torch.complex64, device=device)
    O = torch.zeros_like(P)
    for f, nu in enumerate(tel.frequencies):
        mc = instantaneous_m(0.0, np.radians(tel.latitude), np.radians(MF_DEC), ub / (C_LIGHT / (nu * 1e6)), 0.0)
        mp = torch.as_tensor(np.where(intra, MF_INTRA_M[0], mc), device=device)[:, None]
        mo = torch.as_tensor(np.where(intra, MF_INTRA_M[1], mc + MF_INTER_OFFSET), device=device)[:, None]
        P[f] = MF_AMP * env * torch.polar(torch.ones_like(mp * phi), mp * phi)
        O[f] = MF_AMP * env * torch.polar(torch.ones_like(mo * phi), mo * phi)
    return P, O, ub


def mf_stream(tel, nra: int, device, parts=("pass", "reject", "noise")):
    """20b's stream of every unique pair [nfreq, npairs, nra]: the passed and rejected components of
    :func:`mf_components` and unit noise (as ``parts`` names), weights of the noise, the ``MF_FLAGS`` cells at
    weight 0 with ``MF_RFI`` added.  Returns (stream, passed component, each row's EW separation)."""
    import torch

    from draco_tpu_torch.core import containers

    pairs = np.asarray(tel.uniquepairs)
    prod = np.empty(len(pairs), dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = pairs.T
    ss = containers.SiderealStream(freq=tel.frequencies, ra=nra, input=tel.nfeed, prod=prod, device=device)
    P, O, ub = mf_components(tel, np.arange(len(pairs)), nra, device)
    vis = ss.vis[:]
    if "pass" in parts:
        vis += P
    if "reject" in parts:
        vis += O
    del O
    if "noise" in parts:
        gen = torch.Generator(device=device)
        gen.manual_seed(FILT_SEED + 1)
        for f in range(vis.shape[0]):
            vis[f] += np.sqrt(MF_NOISE_VAR / 2) * torch.view_as_complex(
                torch.randn((*vis.shape[1:], 2), generator=gen, device=device))
    w = ss.weight[:]
    w.fill_(1.0 / MF_NOISE_VAR)
    for f, r in mf_flags(tel.nfreq, nra):
        w[f, :, r] = 0.0
        vis[f, :, r] += MF_RFI
    return ss, P, ub


def filter_tasks() -> dict:
    """Define phase 20's source and probe tasks in this module; return their paths."""
    import torch

    from draco_tpu_torch.core import config, containers, io
    from draco_tpu_torch.core.task import ContainerTask, PipelineStopIteration
    from draco_tpu_torch.device import resolve

    class EmitFilterStream(ContainerTask):
        """20a: phase 16's stream at ``nra`` samples, with the wavelet check's delay tone."""

        nra = config.int_prop(FILT_NRA)

        def setup(self, tel):
            self.tel = io.get_telescope(tel)

        def process(self):
            if self._count:
                raise PipelineStopIteration()
            ss = delay_stream(self.tel, np.arange(self.tel.npairs), self.nra, resolve(),
                              flag_ra=filt_flag_ra(self.nra))
            prods, _ = filt_tone_products(self.tel)
            tone = filt_tone(self.tel, self.nra, resolve())
            ok = ss.weight[:][:, 0] > 0  # the flagged cells keep their interference only
            for p in prods:
                ss.vis[:][:, p] += torch.where(ok, tone, 0)
            ss.attrs["tag"] = "filters"
            return ss

    class EmitMStream(ContainerTask):
        """20b: every unique pair at ``nra`` RA samples (:func:`mf_stream`)."""

        nra = config.int_prop(MF_NRA)

        def setup(self, tel):
            self.tel = io.get_telescope(tel)

        def process(self):
            if self._count:
                raise PipelineStopIteration()
            dev = resolve()
            ss, P, ub = mf_stream(self.tel, self.nra, dev)
            FILT_PROBES["mf_pass"] = P
            intra = np.abs(ub) < 0.5 * self.tel.cylinder_spacing
            rows = np.concatenate([np.flatnonzero(intra)[:N_MF_HOST], np.flatnonzero(~intra)[:N_MF_HOST]])
            FILT_PROBES["mf_rows"] = rows
            FILT_PROBES["mf_in_rows"] = ss.vis[:][:, torch.as_tensor(rows, device=dev)].clone()
            ss.attrs["tag"] = "mfilter"
            return ss

    class ForkHybrid(ContainerTask):
        """20c: from the hybrid stream, a copy with the bandpass ripple, a second one for the pre-filtered
        estimators, a signal-only copy (unit complex noise, the same weights) and an empty pixel mask."""

        def process(self, hv):
            dev = hv.vis[:].device
            f = np.asarray(hv.freq)
            g = torch.as_tensor(1.0 + HV_RIPPLE[0] * np.cos(2 * np.pi * HV_RIPPLE[1] * f), device=dev)
            rip = hv.copy()
            rip.vis[:] *= g.to(torch.complex64)[None, :, None, None, None]
            pre = rip.copy()
            sig = hv.copy()
            gen = torch.Generator(device=dev)
            gen.manual_seed(HV_SEED)
            for p in range(sig.vis.shape[0]):
                sig.vis[:][p] = torch.view_as_complex(torch.randn((*sig.vis.shape[1:], 2), generator=gen, device=dev))
            mask = containers.RingMapMask(freq=f, pol=np.asarray(hv.index_map["pol"]), ra=np.asarray(hv.ra),
                                          el=np.asarray(hv.index_map["el"]), device=dev)
            mask.mask[:] = np.zeros(mask.mask.shape, bool)
            x, t = FILT_PROBES["hv_cols"]
            FILT_PROBES["hv_w0"] = hv.weight[:][:, :, x, t].clone()  # [pol, freq, col]
            FILT_PROBES["sig_in"] = torch.stack([sig.vis[:][:, :, xi, :, ti] for xi, ti in zip(x, t)], dim=1)
            FILT_PROBES["g_true"] = g.cpu().numpy() - 1.0
            return rip, pre, sig, mask

    class FilterProbe(ContainerTask):
        """Keep what the host checks need of the container under ``key``: ``keep`` the container itself (passed
        on), ``copy`` a copy of it (the container passed on), or, as the last task of a branch (nothing passed
        on), ``columns`` the vis of the 20c check's (ew, ra) columns [pol, col, freq, el] or ``finite`` whether
        the vis is finite and its shape."""

        key = config.str_prop("x")
        mode = config.enum(["keep", "copy", "columns", "finite"], default="keep")

        def process(self, data):
            if self.mode in ("keep", "copy"):
                FILT_PROBES[self.key] = data.copy() if self.mode == "copy" else data
                return data
            if self.mode == "columns":
                x, t = FILT_PROBES["hv_cols"]
                FILT_PROBES[self.key] = torch.stack([data.vis[:][:, :, xi, :, ti] for xi, ti in zip(x, t)], dim=1)
            else:
                FILT_PROBES[self.key] = (bool(torch.isfinite(torch.view_as_real(data.vis[:])).all()),
                                         tuple(data.vis.shape))
            return None

    paths = {}
    for cls in (EmitFilterStream, EmitMStream, ForkHybrid, FilterProbe):
        globals()[cls.__name__] = cls
        paths[cls.__name__] = f"{__name__}.{cls.__name__}"
    return paths


def filter_config_a(product_dir: str, paths: dict, nra: int) -> dict:
    """20a: the DAYENU delay filter -> Stokes I -> delay and wavelet spectra, beside the DPSS inpainting and
    the fixed-cutoff chi-squared; the non-destructive tasks come first (the DAYENU filter works in place)."""
    an = "draco.analysis."
    dpss = {"centres": [0.0], "halfwidths": [FILT_TAUW]}
    return {"pipeline": {"retain_products": "all", "tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"], "params": {"product_directory": product_dir}},
        {"type": paths["EmitFilterStream"], "requires": "tel", "out": "sstream", "params": {"nra": nra}},
        {"type": an + "dayenu.DayenuDelayFilterFixedCutoff", "in": "sstream", "out": "chi2",
         "params": {"single_mask": False, "reduce_baseline": True}},
        {"type": an + "interpolate.DPSSFilterDelay", "requires": "tel", "in": "sstream", "out": "inp", "params": dpss},
        {"type": an + "transform.StokesIVis", "requires": "tel", "in": "inp", "out": "inpI"},
        {"type": an + "interpolate.DPSSFilterDelayStokesI", "requires": "tel", "in": "inpI", "out": "inpI2",
         "params": dpss},
        {"type": an + "dayenu.DayenuDelayFilter", "requires": "tel", "in": "sstream", "out": "sfilt",
         "params": {"tauw": FILT_TAUW, "single_mask": False}},
        {"type": an + "transform.StokesIVis", "requires": "tel", "in": "sfilt", "out": "sI"},
        {"type": an + "delay.DelaySpectrumFFT", "in": "sI", "out": "dtrans",
         "params": {"complex_timedomain": True, "freq_frac": -1.0}},
        {"type": an + "delay.DelaySpectrumToPowerSpectrum", "in": "dtrans", "out": "dspec"},
        {"type": an + "wavelet.WaveletSpectrumEstimator", "in": ["sI", "dspec"], "out": "wspec",
         "params": {"average_axis": "ra", "ndelay": FILT_NDELAY}},
    ]}}


def filter_config_b(product_dir: str, paths: dict, nra: int) -> dict:
    """20b: the m-mode DAYENU filter -> DPSS inpainting over RA."""
    an = "draco.analysis."
    return {"pipeline": {"retain_products": "all", "tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"], "params": {"product_directory": product_dir}},
        {"type": paths["EmitMStream"], "requires": "tel", "out": "mstream", "params": {"nra": nra}},
        {"type": an + "dayenu.DayenuMFilter", "requires": "tel", "in": "mstream", "out": "mfilt"},
        {"type": an + "interpolate.DPSSFilterMMode", "requires": "tel", "in": "mfilt", "out": "minp",
         "params": {"centres": [0.0], "halfwidths": [MF_HALFWIDTH]}},
    ]}}


def filter_config_c(product_dir: str, source: str, paths: dict, nra: int, npix: int) -> dict:
    """20c: hybrid visibilities -> the DAYENU hybrid filter -> HyFoReS (all five estimators) -> Clean, the
    saved filter applied to a signal-only copy, and the ring map's delay filter."""
    rmm, an = "draco.analysis.ringmapmaker.", "draco.analysis."
    hf = an + "hyforesbandpass."
    probe = paths["FilterProbe"]
    return {"pipeline": {"retain_products": "final", "tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"], "params": {"product_directory": product_dir}},
        {"type": source, "requires": "tel", "out": "sstream", "params": {"nra": nra, "npix": npix}},
        {"type": rmm + "MakeVisGrid", "requires": "tel", "in": "sstream", "out": "grid"},
        {"type": rmm + "BeamformNS", "in": "grid", "out": "hstream",
         "params": {"npix": npix, "span": 1.0, "weight": "natural", "precision": 64}},
        {"type": paths["ForkHybrid"], "in": "hstream", "out": ["hrip", "hpre", "hsig", "pmask"]},
        {"type": rmm + "BeamformEW", "in": "hstream", "out": "rmap"},
        {"type": probe, "in": "rmap", "out": "rmap_p", "params": {"key": "rmap_before", "mode": "copy"}},
        {"type": an + "dayenu.DayenuDelayFilterMap", "in": "rmap_p", "out": "rmap_f"},
        {"type": an + "dayenu.DayenuDelayFilterHybridVis", "in": "hstream", "out": "hfilt",
         "params": {"save_filter": True, "calculate_cov": True}},
        {"type": probe, "in": "hfilt", "out": "hfilt_p", "params": {"key": "hfilt"}},
        {"type": an + "dayenu.DayenuDelayFilterHybridVis", "in": "hpre", "out": "hpf", "params": {"save_filter": True}},
        {"type": hf + "DelayFilterHyFoReSBandpassHybridVis", "requires": "tel", "in": ["hrip", "hfilt_p"], "out": "bp"},
        {"type": hf + "HyFoReSBandpassHybridVis", "requires": "tel", "in": ["hrip", "hpf"], "out": "bp_pre"},
        {"type": hf + "HyFoReSBandpassHybridVisMask", "requires": "tel", "in": ["hrip", "hpf", "pmask"],
         "out": "bp_mask"},
        {"type": hf + "HyFoReSBandpassHybridVisMaskKeepSource", "requires": "tel",
         "in": ["hrip", "hpf", "pmask", "pmask"], "out": "bp_keep"},
        {"type": an + "dayenu.ApplyDelayFilterHybridVis", "in": ["hsig", "hfilt_p"], "out": "hsig_f"},
        {"type": probe, "in": "hsig_f", "params": {"key": "hsig_cols", "mode": "columns"}},
        {"type": hf + "DelayFilterHyFoReSBandpassHybridVisClean", "in": ["hrip", "hfilt_p", "bp"],
         "out": ["hclean", "comp"], "params": {"cutoff": 1e-2}},
        {"type": probe, "in": "hclean", "params": {"key": "hclean", "mode": "finite"}},
    ]}}


def _filter_run(label: str, cfg: dict, device):
    """Run one of phase 20's configs through the Manager; print its per-task seconds, wall time and peak
    device memory; return (products, wall seconds)."""
    import gc

    import torch

    from draco_tpu_torch.core.pipeline import Manager

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    manager = Manager(cfg)
    t0 = _sync_clock(device)
    products = manager.run()
    wall = _sync_clock(device) - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else float("nan")
    timing = {}
    for name, t in manager.task_timing.items():
        key = name.split(".")[-1]
        while key in timing:
            key += "'"
        timing[key] = round(t["wall"], 4)
    log(f"phase {label} Manager run: {wall:.2f} s wall, peak device memory {peak:.2f} GiB")
    log(f"phase {label} task_timing (s): " + json.dumps(timing))
    return products, wall


def _bound(flops: float, nbytes: float, kind: str):
    """(least seconds, what bounds it) of work of ``flops`` in ``kind`` moving ``nbytes``."""
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _time_prog(progs: dict, device, name: str, fn, flops: float, nbytes: float, kind: str):
    """Time ``fn`` once, synchronised, beside its bound; record it under ``name``."""
    t0 = _sync_clock(device)
    fn()
    s = _sync_clock(device) - t0
    b, by = _bound(flops, nbytes, kind)
    progs[name] = {"s": round(s, 5), "bound_s": float(f"{b:.4g}"), "bound_by": by}


def host_dayenu(freq, cut: float, mask, eps: float) -> np.ndarray:
    """The DAYENU high-pass filter in float64 numpy: ``numpy.linalg.pinv`` of the masked covariance."""
    df = freq[:, None] - freq[None, :]
    m2 = np.outer(mask, mask).astype(np.float64)
    cov = (np.eye(freq.size) + np.sinc(2.0 * cut * df) / eps) * m2
    return np.linalg.pinv(cov, hermitian=True) * m2


def host_dayenu_apply(freq, cut: float, x, w, eps: float, cache: dict) -> np.ndarray:
    """DayenuDelayFilter (single_mask false) on one product's [nfreq, nra] data in float64: a filter for each
    unique column mask (kept in ``cache`` by cut and mask)."""
    out = np.zeros_like(x, dtype=np.complex128)
    flag = w > 0
    masks, inv = np.unique(flag.T, axis=0, return_inverse=True)
    for k, m in enumerate(masks):
        cols = np.flatnonzero(inv.reshape(-1) == k)
        key = (round(float(cut), 6), m.tobytes())
        if key not in cache:
            cache[key] = host_dayenu(freq, cut, m, eps)
        out[:, cols] = cache[key] @ x[:, cols]
    return out


def host_dpss_basis(samples, cut: float) -> np.ndarray:
    """The DPSS basis in float64 numpy: the top-hat covariance's eigenvectors above 1e-12 of the largest."""
    ds = samples[:, None] - samples[None, :]
    w, v = np.linalg.eigh(np.sinc(2.0 * cut * ds))
    keep = w > 1e-12 * w.max()
    return v[:, keep]


def host_dpss_filter(x, Ni, W, A, Si: float) -> np.ndarray:
    """DPSSFilter's solve of one row in float64 (mean-subtract, Wiener solve in the basis, re-add)."""
    xhat = (x * W).sum() / max(W.sum(), 1)
    K = (A.T * Ni) @ A
    b = np.linalg.solve(K + Si * np.eye(A.shape[1]), A.T @ (Ni * (x - xhat)))
    return A @ b + xhat


def host_wavelet(d, Ni, D, F, scales) -> np.ndarray:
    """WaveletSpectrumEstimator of one baseline in float64 numpy: the Wiener in-fill, the analytic-Morlet CWT
    and the variance over the averaging axis.  d [ntime, nfreq]; returns [nscale, nfreq]."""
    Df = (F * D[None]) @ F.conj().T
    Ci = np.linalg.inv(Df) + np.diag(Ni)
    x = np.linalg.solve(Ci, Ni[:, None] * d.T).T
    n = x.shape[-1]
    w = 2.0 * np.pi * np.fft.fftfreq(n)
    sw = scales[:, None] * w[None]
    bank = np.sqrt(2.0 * np.pi * scales)[:, None] * (np.pi**-0.25) * np.exp(-0.5 * (sw - 5.0) ** 2) * (sw > 0)
    W = np.fft.ifft(np.fft.fft(x, axis=-1)[None] * bank[:, None], axis=-1)
    return np.mean(np.abs(W - W.mean(axis=1, keepdims=True)) ** 2, axis=1)


def run_filters(device, ncyl: int = 4, nfeed: int = 256, nfreq_a: int = DELAY_NFREQ, nra_a: int = FILT_NRA,
                nfreq_b: int = MF_NFREQ, nra_b: int = MF_NRA, nfreq_c: int = HV_NFREQ, nra_c: int = HV_NRA,
                npix: int = HV_NPIX) -> None:
    """Phase 20: the DAYENU, DPSS, wavelet and HyFoReS filter path through the Manager.

    The sizes default to the phase's; smaller ones make it a rehearsal on
    the CPU.
    """
    import gc
    import logging
    import pickle
    import tempfile

    import torch

    from draco_tpu_torch.analysis import dayenu as tdayenu
    from draco_tpu_torch.analysis import hyforesbandpass as thf
    from draco_tpu_torch.analysis.dayenu import C_LIGHT
    from draco_tpu_torch.analysis.wavelet import wiener_infill
    from draco_tpu_torch.ops import dayenu as dops
    from draco_tpu_torch.ops import dpss as dpss_ops
    from draco_tpu_torch.ops import wavelet as wops
    from draco_tpu_torch.ops.tools import invert_no_zero

    failures = []
    progs = {}
    seconds = {}

    def check(label, value, ok):
        log(f"  {label}: {value}  [{'ok' if ok else 'FAIL'}]")
        if not ok:
            failures.append(label)

    def host(x):
        return x.detach().cpu().numpy()

    paths = filter_tasks()
    FILT_PROBES.clear()
    GB = 1e9
    with tempfile.TemporaryDirectory() as product_dir:

        def save(tel):
            # the unique-pair tables first (a Python loop over every feed pair: ~14 s at 2048 feeds), so that
            # the Manager's unpickled copy and this function's checks share one computation
            tel.uniquepairs
            with open(Path(product_dir) / "telescope.pkl", "wb") as f:
                pickle.dump(tel, f)

        # ---- 20a: the delay axis -------------------------------------------------
        t_sub = time.perf_counter()
        tel = delay_telescope(ncyl, nfeed, nfreq_a)
        save(tel)
        nprod, freq = tel.npairs, tel.frequencies
        log(f"20a: {ncyl} x {nfeed} dual-pol feeds, {nprod} products x {nfreq_a} channels x {nra_a} RA samples "
            f"(stream {12 * nprod * nfreq_a * nra_a / GB:.2f} GB), DAYENU tauw {FILT_TAUW} us, single_mask false")
        products, wall = _filter_run("20a", filter_config_a(product_dir, paths, nra_a), device)
        sfilt = products["sfilt"][0]
        pos = tel.feedpositions
        pairs = np.asarray(tel.uniquepairs)
        ns = np.abs(pos[pairs[:, 0], 1] - pos[pairs[:, 1], 1])
        cuts = 1e6 * ns / C_LIGHT + FILT_TAUW
        ucut = np.unique(np.round(cuts, 6))
        log(f"20a: {len(ucut)} distinct delay cuts ({ucut.min():.4f}-{ucut.max():.4f} us): the DAYENU filter "
            "factorised one [nfreq, nfreq] float64 eigh per (cut, mask) group")
        # the host checks' products: N_FILT_PER_CUT products at each of N_FILT_CUTS NS separations
        useps = np.unique(ns)
        pick = useps[np.linspace(0, len(useps) - 1, min(N_FILT_CUTS, len(useps))).astype(int)]
        prods = np.concatenate([np.flatnonzero(ns == s)[:N_FILT_PER_CUT] for s in pick])
        ref = delay_stream(tel, prods, nra_a, device, flag_ra=filt_flag_ra(nra_a))
        tone_prods, tone_b = filt_tone_products(tel)
        tone = filt_tone(tel, nra_a, device)
        w_in = host(ref.weight[:])
        tone_in = np.zeros(w_in.shape, np.complex128)
        for j, p in enumerate(prods):
            if p in set(tone_prods.tolist()):
                tone_in[:, j] = np.where(w_in[:, j] > 0, host(tone), 0)
        x_in = host(ref.vis[:]).astype(np.complex128) + tone_in
        out = host(sfilt.vis[:][:, torch.as_tensor(prods, device=device)]).astype(np.complex128)
        # the signal and noise (with the tone) alone: what the filter should keep beyond each cut
        sn = delay_stream(tel, prods, nra_a, device, parts=("signal", "noise"), flag_ra=filt_flag_ra(nra_a))
        sn_in = host(sn.vis[:]).astype(np.complex128) + tone_in
        del sn
        t0 = time.perf_counter()
        errs, keep, cache = [], [], {}
        tau = np.fft.fftfreq(nfreq_a, freq[1] - freq[0])
        for j, p in enumerate(prods):
            want = host_dayenu_apply(freq, cuts[p], x_in[:, j], w_in[:, j], 1e-12, cache)
            errs.append(np.abs(out[:, j] - want).max() / np.abs(want).max())
            valid = (w_in[:, j] > 0).any(axis=0)
            xin = np.where(w_in[:, j] > 0, sn_in[:, j], 0)[:, valid]
            hi = np.abs(tau) > cuts[p] + 0.1
            pin = (np.abs(np.fft.fft(xin, axis=0)[hi]) ** 2).sum()
            pout = (np.abs(np.fft.fft(out[:, j][:, valid], axis=0)[hi]) ** 2).sum()
            keep.append(pout / pin)
        check(f"20a DAYENU output of {len(prods)} products at {len(pick)} NS separations vs host float64 numpy "
              f"({time.perf_counter() - t0:.1f} s)", f"{max(errs):.3e} (limit {FILT_TOL_DAYENU}: epsilon 1e-12, "
              "condition 1e12)", max(errs) <= FILT_TOL_DAYENU)
        check("20a power at delays beyond each product's cut + 0.1 us, out / in (signal and noise)",
              f"{min(keep):.4f}-{max(keep):.4f} "
              f"(within {FILT_KEEP})", all(abs(k - 1) <= FILT_KEEP for k in keep))
        mask0 = w_in[:, 0, 0] > 0
        if not mask0.any():
            mask0 = (w_in[:, 0] > 0).any(axis=1)
        got = dops.highpass_delay_filter(freq, cuts[prods[0]], mask0[:, None], epsilon=1e-3, device=device)[0][0]
        want = host_dayenu(freq, cuts[prods[0]], mask0, 1e-3)
        xv = x_in[:, 0, :]
        e3 = np.abs(host(got) @ xv - want @ xv).max() / np.abs(want @ xv).max()
        check("20a the card's float64 pseudo-inverse at epsilon 1e-3 applied to a product vs host float64",
              f"{e3:.3e} (limit {FILT_TOL_DAYENU_E3})", e3 <= FILT_TOL_DAYENU_E3)
        # the foreground-only copy of the sampled products through the same task
        fg = delay_stream(tel, prods, nra_a, device, parts=("fg",), flag_ra=filt_flag_ra(nra_a))
        live = fg.weight[:] > 0
        before = float((fg.vis[:].abs() ** 2 * live).sum())
        task = tdayenu.DayenuDelayFilter()
        task.read_config({"tauw": FILT_TAUW, "single_mask": False})
        task.setup(tel)
        task.process(fg)
        after = float((fg.vis[:].abs() ** 2 * live).sum())
        check("20a foreground-only copy: power through the filter / before", f"{after / before:.3e} "
              f"(limit {FILT_FG_FALL})", after / before <= FILT_FG_FALL)
        # the inpainted channels against the foreground there
        inp = products["inp"][0]
        fgv = host(delay_stream(tel, prods, nra_a, device, parts=("fg",), flag_ra=filt_flag_ra(nra_a)).vis[:])
        gap = ~(w_in > 0) & (w_in > 0).any(axis=0, keepdims=True)  # flagged channels of live RA samples
        ip = host(inp.vis[:][:, torch.as_tensor(prods, device=device)])
        fgap = fgv[gap] - DELAY_RFI  # delay_stream adds the interference to the flagged cells of every copy
        rel = np.sqrt(np.mean(np.abs(ip[gap] - fgap) ** 2) / np.mean(np.abs(fgap) ** 2))
        check(f"20a DPSS-inpainted channels of {len(prods)} products vs their foreground, RMS / RMS",
              f"{rel:.3e} (limit {FILT_TOL_INPAINT}; the white signal and noise are not inpainted)",
              rel <= FILT_TOL_INPAINT)
        # the DPSS solve against host float64 on N_FILT_DPSS products x every RA sample
        t0 = time.perf_counter()
        feedmap, baselines = tel.feedmap, tel.baselines
        dcut = np.round(np.maximum(np.abs(baselines[feedmap[pairs[:, 0], pairs[:, 1]]][:, 1]) / C_LIGHT * 1e6,
                                   FILT_TAUW), 3)
        errs = []
        for j in range(min(N_FILT_DPSS, len(prods))):
            A = host_dpss_basis(freq, dcut[prods[j]])
            for t in np.flatnonzero((w_in[:, j] > 0).any(axis=0)):
                W = w_in[:, j, t] > 0
                want = host_dpss_filter(x_in[:, j, t], w_in[:, j, t] * W, W, A, 1e-3)
                errs.append(np.abs(ip[~W, j, t] - want[~W]).max() / np.abs(want[~W]).max())
        check(f"20a DPSS solve on {len(errs)} rows vs host float64 ({time.perf_counter() - t0:.1f} s)",
              f"{max(errs):.3e} (limit {FILT_TOL_DPSS})", max(errs) <= FILT_TOL_DPSS)
        inpI2 = products["inpI2"][0]
        chi2 = products["chi2"][0]
        ok = (bool(torch.isfinite(torch.view_as_real(inpI2.vis[:])).all())
              and bool(torch.isfinite(torch.view_as_real(chi2.vis[:])).all())
              and tuple(chi2.vis.shape) == (nfreq_a, 1, nra_a))
        check("20a DPSSFilterDelayStokesI and the fixed-cutoff chi^2 finite, chi^2 shape",
              f"{tuple(inpI2.vis.shape)}, {tuple(chi2.vis.shape)}", ok)
        # the wavelet spectrum against host float64 on N_FILT_WAVELET baselines, and the tone's peak
        sI, dspec, wspec = products["sI"][0], products["dspec"][0], products["wspec"][0]
        ws = host(wspec.spectrum[:])
        delays = np.asarray(wspec.index_map["delay"])
        fsl = slice(nfreq_a // 16, nfreq_a - nfreq_a // 16)
        peak = delays[np.argmax(ws[tone_b][:, fsl].mean(axis=-1))]
        check(f"20a wavelet spectrum of the tone's baseline peaks at its delay {FILT_TONE[1]} us", f"{peak:.3f} us",
              abs(peak - FILT_TONE[1]) <= FILT_TONE_TOL * FILT_TONE[1])
        t0 = time.perf_counter()
        nbase = sI.vis.shape[1]
        dlive = np.flatnonzero(host(dspec.spectrum[:]).max(axis=-1) > 0)  # baselines with data
        bsel = np.unique(np.concatenate([[tone_b], dlive[np.linspace(0, len(dlive) - 1, N_FILT_WAVELET - 1)
                                                         .astype(int)]]))
        log(f"20a wavelet spectrum: {nbase} Stokes-I baselines, {wspec.attrs['infill_failed']} without delay "
            "power (no data) given a zero spectrum")
        df = abs(freq[1] - freq[0])
        scales = wops.frequency2scale(np.arange(1, FILT_NDELAY + 1) / (2 * df * FILT_NDELAY) * df, wavelet="morl")
        F = np.exp(-2.0j * np.pi * np.asarray(dspec.index_map["delay"])[None, :] * freq[:, None])
        errs = []
        for b in bsel:
            d = host(sI.vis[:][:, b]).T.astype(np.complex128)
            Ni = host(sI.weight[:][:, b]).mean(axis=-1).astype(np.float64)
            want = host_wavelet(d, Ni, host(dspec.spectrum[:][b]), F, scales)
            errs.append(np.abs(ws[b] - want).max() / np.abs(want).max())
        check(f"20a wavelet spectrum of {len(bsel)} baselines vs a host float64 in-fill and CWT "
              f"({time.perf_counter() - t0:.1f} s)", f"{max(errs):.3e} (limit {FILT_TOL_WAVELET})",
              max(errs) <= FILT_TOL_WAVELET)

        # 20a's device programs alone, on the phase's shapes
        n = nfreq_a
        nu = min(len(ucut), 64)
        covs = torch.stack([torch.as_tensor(dops.delay_covariance(freq, c, 0.0, 1e-12)) for c in ucut[:nu]]).to(device)
        _time_prog(progs, device, f"dayenu.hermitian_pinv_batched [{nu} of the {len(ucut)} cuts, {n}, {n}] float64",
                   lambda: dops.hermitian_pinv_batched(covs), nu * 16 / 3 * n**3, 2 * covs.numel() * 8, "float64")
        del covs
        X = sfilt.vis[:].view(n, -1)
        F32 = torch.eye(n, dtype=torch.complex64, device=device)
        _time_prog(progs, device, f"filter apply [{n}, {n}] @ [{n}, {X.shape[1]}] complex64", lambda: F32 @ X,
                   8.0 * n * n * X.shape[1], 2 * X.numel() * 8, "float32")
        del F32
        nbI = sI.vis.shape[1]
        blk = min(nbI, 128)
        dI, NiI = sI.vis[:].permute(1, 2, 0)[:blk].contiguous(), sI.weight[:].permute(1, 2, 0)[:blk].mean(dim=1)
        Ft = torch.as_tensor(F, device=device)
        Dt = dspec.spectrum[:][:blk]
        _time_prog(progs, device, f"wavelet.wiener_infill [{blk} of {nbI} baselines, {n}, {n}] complex128",
                   lambda: wiener_infill(dI, NiI, Dt, Ft), blk * 4 * (2 * n**3 + 2 * n**3 + 2 / 3 * n**3
                                                                     + 2 * n * n * dI.shape[1]),
                   blk * (2 * n * n * 16 + dI[0].numel() * 16), "float64")
        nsc = FILT_NDELAY // 4
        _time_prog(progs, device, f"wavelet.cwt + cwt_var [{nsc} scales x {blk} baselines x {dI.shape[1]} x {n}]",
                   lambda: wops.cwt_var(wops.cwt(dI, scales[:nsc]), axis=2),
                   5.0 * n * np.log2(n) * blk * dI.shape[1] * (nsc + 1), dI.numel() * 8 + nsc * blk * n * 4, "float32")
        del dI, NiI, Ft, Dt
        seconds["20a"] = time.perf_counter() - t_sub
        del products, sfilt, inp, inpI2, chi2, sI, dspec, wspec, ref, fg, X
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # ---- 20b: the m axis -------------------------------------------------
        t_sub = time.perf_counter()
        tel = ring_telescope(ncyl, nfeed, nfreq_b)
        save(tel)
        nprod = tel.npairs
        log(f"20b: {nprod} products x {nfreq_b} channels x {nra_b} RA samples "
            f"(stream {12 * nprod * nfreq_b * nra_b / GB:.2f} GB), DayenuMFilter defaults, DPSSFilterMMode "
            f"halfwidth {MF_HALFWIDTH}")
        products, wall = _filter_run("20b", filter_config_b(product_dir, paths, nra_b), device)
        mfilt, minp = products["mfilt"][0], products["minp"][0]
        P = FILT_PROBES.pop("mf_pass")
        pairs_b = np.asarray(tel.uniquepairs)
        posb = tel.feedpositions
        ub = np.round((posb[pairs_b[:, 0], 0] - posb[pairs_b[:, 1], 0]) / tel.cylinder_spacing) * tel.cylinder_spacing
        live = mfilt.weight[:] > 0
        clean = sorted(set(range(nfreq_b)) - {f for f, _ in mf_flags(nfreq_b, nra_b)})
        cl = torch.as_tensor(clean, device=device)
        err = float(((mfilt.vis[:][cl] - P[cl]).abs() * live[cl]).max()) / float(P.abs().max())
        check(f"20b passed component on the {len(clean)} channels without flagged cells, max|out - passed| / "
              "max|passed|", f"{err:.3e} (limit {MF_TOL_PASS}: the filter's float64 pass band)", err <= MF_TOL_PASS)
        del P
        # the rejected component alone through the same task
        rej, _, _ = mf_stream(tel, nra_b, device, parts=("reject",))
        before = float(((rej.vis[:].abs() ** 2) * live).sum())
        task = tdayenu.DayenuMFilter()
        task.read_config({})
        task.setup(tel)
        task.process(rej)
        leak = float(((rej.vis[:].abs() ** 2) * live).sum()) / before
        check("20b rejected component alone: power through the filter / before", f"{leak:.3e} (limit {MF_TOL_OOB})",
              leak <= MF_TOL_OOB)
        del rej
        # both tasks against host float64 on rows of one channel
        t0 = time.perf_counter()
        f0 = mf_flags(nfreq_b, nra_b)[0][0]  # a channel with a flagged cell
        ra = np.radians(np.asarray(mfilt.ra, dtype=np.float64))
        rows = FILT_PROBES.pop("mf_rows")
        rows_t = torch.as_tensor(rows, device=device)
        x_rows = host(FILT_PROBES.pop("mf_in_rows"))[f0].astype(np.complex128)
        flag = host(live[f0].index_select(0, rows_t)).any(axis=0)
        task = tdayenu.DayenuMFilter()
        task.read_config({})
        task.setup(tel)
        db = 0.5 * tel.cylinder_spacing
        nu = tel.frequencies[f0]
        m_cut = abs(task._get_cut(nu, db))
        dra = ra[:, None] - ra[None, :]
        a_bp = np.median(np.abs(np.diff(ra))) * 0.375 * m_cut / np.pi
        eps = 1e-10

        def host_pinv(cov):
            m2 = np.outer(flag, flag)
            return np.linalg.pinv(cov * m2, hermitian=True) * m2

        intra_f = host_pinv(np.eye(ra.size) / (a_bp * eps) + 2 * a_bp * (1.0 - 1.0 / (a_bp * eps))
                            * np.sinc(0.375 * m_cut * dra / np.pi) * np.cos(0.625 * m_cut * dra))
        a_lp = np.median(np.abs(np.diff(ra))) * 0.75 * m_cut / np.pi
        inter_f = host_pinv(np.eye(ra.size) / (a_lp * eps) + a_lp * (1.0 - 1.0 / (a_lp * eps))
                            * np.sinc(0.75 * m_cut * dra / np.pi))
        got = host(mfilt.vis[:][f0].index_select(0, rows_t)).astype(np.complex128)
        errs = []
        for k, r in enumerate(rows):
            if abs(ub[r]) < db:
                want = intra_f @ x_rows[k]
            else:
                mix = np.exp(-1j * task._get_cut(nu, ub[r]) * ra)
                want = (inter_f @ (x_rows[k] * mix)) * mix.conj()
            errs.append(np.abs(got[k] - want).max() / np.abs(want).max())
        check(f"20b DayenuMFilter on {len(rows)} rows of channel {f0} (intra and inter) vs host float64 "
              f"({time.perf_counter() - t0:.1f} s)", f"{max(errs):.3e} (limit {MF_TOL_HOST})", max(errs) <= MF_TOL_HOST)
        t0 = time.perf_counter()
        samples = np.asarray(mfilt.ra, dtype=np.float64)
        A = host_dpss_basis(samples, MF_HALFWIDTH)
        errs = []
        wm = host(mfilt.weight[:][f0].index_select(0, rows_t))
        ipm = host(minp.vis[:][f0].index_select(0, rows_t))
        for k, r in enumerate(rows):
            W = wm[k] > 0
            if abs(ub[r]) >= db or W.all():
                continue
            want = host_dpss_filter(got[k], wm[k] * W, W, A, 1e-3)
            errs.append(np.abs(ipm[k, ~W] - want[~W]).max() / np.abs(want).max())
        check(f"20b DPSSFilterMMode on {len(errs)} intracylinder rows vs host float64 "
              f"({time.perf_counter() - t0:.1f} s)", f"{max(errs) if errs else float('nan'):.3e} (limit {MF_TOL_HOST})",
              bool(errs) and max(errs) <= MF_TOL_HOST)
        check("20b outputs finite", f"{tuple(minp.vis.shape)}",
              bool(torch.isfinite(torch.view_as_real(minp.vis[:])).all())
              and bool(torch.isfinite(torch.view_as_real(mfilt.vis[:])).all()))
        # 20b's device programs alone
        mask = live[f0].any(dim=0)[None]
        _time_prog(progs, device, f"dayenu.bandpass + lowpass_mmode_filter [2, {nra_b}, {nra_b}] float64",
                   lambda: (dops.bandpass_mmode_filter(ra, 0.625 * m_cut, 0.375 * m_cut, mask),
                            dops.lowpass_mmode_filter(ra, 0.75 * m_cut, mask)),
                   2 * 16 / 3 * nra_b**3, 2 * 2 * nra_b**2 * 8, "float64")
        v0 = mfilt.vis[:][f0]
        Fm = torch.eye(nra_b, dtype=torch.complex64, device=device)
        _time_prog(progs, device, f"m filter apply [{nprod}, {nra_b}] @ [{nra_b}, {nra_b}] complex64",
                   lambda: v0 @ Fm, 8.0 * nprod * nra_b**2, 2 * v0.numel() * 8, "float32")
        del Fm
        mcuts = [MF_HALFWIDTH] + [np.round((np.pi / 180) * tel.freq_start * 1e6 * k * tel.cylinder_spacing
                                           / (C_LIGHT * np.cos(np.radians(tel.latitude))), 2) for k in (1, 2, 3)]
        covm = [dpss_ops.make_covariance(samples, c, 0.0, device=device) for c in mcuts]
        _time_prog(progs, device, f"dpss.get_bases [{len(mcuts)}, {nra_b}, {nra_b}] float64",
                   lambda: dpss_ops.get_bases(covm), len(mcuts) * 16 / 3 * nra_b**3, 2 * len(mcuts) * nra_b**2 * 8,
                   "float64")
        Am = dpss_ops.get_bases(covm[-1:])[0]
        del covm
        nm = Am.shape[1]
        rows_m = mfilt.vis[:][:, : min(64, nprod)].reshape(-1, nra_b)  # [nfreq x 64 rows, nra]
        Ni_m = mfilt.weight[:][:, : min(64, nprod)].reshape(-1, nra_b)
        _time_prog(progs, device, f"dpss.solve_batched [{rows_m.shape[0]} rows, {nra_b} samples, {nm} modes] complex64",
                   lambda: dpss_ops.solve_batched(rows_m, Ni_m, Am), nfreq_b * 8.0 * (3 * nra_b * nm * nm + nm**3 / 3)
                   + rows_m.shape[0] * 8.0 * 2 * nra_b * nm, 2 * rows_m.numel() * 8 + Am.numel() * 4, "float32")
        del Am, rows_m, Ni_m, v0
        seconds["20b"] = time.perf_counter() - t_sub
        del products, mfilt, minp, live
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # ---- 20c: hybrid visibilities and ring maps ----------------------------------
        t_sub = time.perf_counter()
        tel = ring_telescope(ncyl, nfeed, nfreq_c, HV_F0)
        save(tel)
        source, _ = ring_tasks()
        rng = np.random.Generator(np.random.SFC64(HV_SEED))
        FILT_PROBES["hv_cols"] = (rng.integers(0, ncyl, N_HV_COLS), rng.integers(0, nra_c, N_HV_COLS))
        log(f"20c: the hybrid stream [4, {nfreq_c}, {ncyl}, {npix}, {nra_c}] "
            f"({8 * 4 * nfreq_c * ncyl * npix * nra_c / GB:.2f} GB), ripple {HV_RIPPLE[0]} at {HV_RIPPLE[1]} us")
        products, wall = _filter_run("20c", filter_config_c(product_dir, source, paths, nra_c, npix), device)
        comp = products["comp"][0]
        g_true = FILT_PROBES.pop("g_true")
        g_est = host(comp.comp_bandpass[:]).real  # [pol, ew, freq]
        sl = slice(HV_EDGE, nfreq_c - HV_EDGE)
        corr = np.array([[np.corrcoef(g_est[p, x, sl], g_true[sl])[0, 1] for x in range(g_est.shape[1])]
                         for p in range(g_est.shape[0])])
        resid = np.array([[np.median(np.abs(g_est[p, x, sl] - g_true[sl])) for x in range(g_est.shape[1])]
                          for p in range(g_est.shape[0])]) / np.abs(g_true).max()
        check(f"20c ripple recovered on every (pol, ew): correlation, median residual / peak (channels "
              f"{HV_EDGE}-{nfreq_c - HV_EDGE - 1})", f"corr >= {corr.min():.3f}, resid <= {resid.max():.3f} "
              f"(limits {HV_CORR}, {HV_RESID})", corr.min() > HV_CORR and resid.max() < HV_RESID)
        b_pre, b_mask, b_keep = (products[k][0].bandpass[:] for k in ("bp_pre", "bp_mask", "bp_keep"))
        dv = max(float((b - b_pre).abs().max()) for b in (b_mask, b_keep)) / max(float(b_pre.abs().max()), 1e-300)
        check("20c the three pre-filtered estimators with empty masks agree", f"{dv:.3e} (limit {HV_TOL_VARIANTS})",
              dv <= HV_TOL_VARIANTS)
        hfilt = FILT_PROBES.pop("hfilt")
        xs, ts = (torch.as_tensor(i, device=device) for i in FILT_PROBES.pop("hv_cols"))
        sig_in = FILT_PROBES.pop("sig_in")  # [pol, col, freq, el]
        Fcol = hfilt.filter[:][:, :, :, xs, ts].permute(0, 3, 1, 2)  # [pol, col, f, g]
        # the task's product form, [pol, t, f, g] @ [pol, t, g, el], with one column at a time
        want = torch.cat([Fcol[:, c : c + 1].to(torch.complex64) @ sig_in[:, c : c + 1] for c in range(len(xs))], dim=1)
        got = FILT_PROBES.pop("hsig_cols")
        check(f"20c ApplyDelayFilterHybridVis: batched product bit-equal to one (ew, ra) column at a time on "
              f"{len(xs)} columns", f"max |diff| {float((got - want).abs().max()):.3e}", bool(torch.equal(got, want)))
        w0 = host(FILT_PROBES.pop("hv_w0")).astype(np.float32)  # [pol, freq, col]
        Fh = host(Fcol)
        var = host(invert_no_zero(torch.as_tensor(w0))).astype(np.float64)
        want_cov = np.einsum("pcfg,pgc,pchg->pfhc", Fh, var, Fh)
        got_cov = host(hfilt.freq_cov[:][:, :, :, xs, ts])
        ecov = np.abs(got_cov - want_cov).max() / np.abs(want_cov).max()
        check(f"20c freq_cov of {len(xs)} columns vs host float64 NF diag(var) NF^T", f"{ecov:.3e} (limit {HV_TOL_COV})",
              ecov <= HV_TOL_COV)
        rb, rf = FILT_PROBES.pop("rmap_before"), products["rmap_f"][0]
        fr = np.asarray(rf.freq)
        low = torch.as_tensor(np.abs(np.fft.fftfreq(fr.size, abs(fr[1] - fr[0]))) < 0.05, device=device)

        def low_power(m):  # power at |delay| < 0.05 us, a pol at a time, on the card
            return sum(float((torch.fft.fft(m[:, p], dim=1)[:, low].abs() ** 2).sum()) for p in range(m.shape[1]))

        pb, pa = low_power(rb.map[:]), low_power(rf.map[:])
        check(f"20c DayenuDelayFilterMap on the ring map {tuple(rf.map.shape)}: power at |delay| < 0.05 us, after / "
              "before; finite", f"{pa / pb:.3e} (limit {HV_MAP_FALL})",
              pa / pb <= HV_MAP_FALL and bool(torch.isfinite(rf.map[:]).all()))
        finite, shape = FILT_PROBES.pop("hclean")
        check("20c Clean output finite, of the stream's shape", f"{shape}",
              finite and shape == tuple(hfilt.vis.shape))
        del rb, rf, products, comp, b_pre, b_mask, b_keep, sig_in, Fcol, got, want
        gc.collect()
        # 20c's device programs alone, on the filter stream's shapes
        hv = hfilt
        filt, vis, wgt = hv.filter[:], hv.vis[:], hv.weight[:]
        npol, nf, new, nel, nr = vis.shape
        ncol = npol * new * nr
        _time_prog(progs, device, f"hyfores._apply_filter_batch [{ncol} x ({nf}, {nf}) @ ({nf}, {nel})] complex64",
                   lambda: thf._apply_filter_batch(vis, wgt, filt, 0.0, logging.getLogger("chip_smoke")),
                   8.0 * ncol * nf * nf * nel, filt.numel() * 8 + 2 * vis.numel() * 8, "float32")
        elm = np.ones(nel, bool)
        _time_prog(progs, device, f"hyfores._estimate_gains_window [{ncol} x ({nf}, {nel}) Grams] complex128",
                   lambda: thf._estimate_gains_window(vis, vis, wgt, filt, elm),
                   8.0 * ncol * nf * nf * nel + 8.0 * ncol * nf * nf, filt.numel() * 8 + 2 * vis.numel() * 8, "float64")
        cvar = invert_no_zero(wgt.double())
        _time_prog(progs, device, f"hyfores._freq_cov [{ncol} x ({nf}, {nf})] float64",
                   lambda: thf._freq_cov(filt, cvar), 2.0 * ncol * nf**3, 2 * filt.numel() * 8, "float64")
        Wm = torch.randn(npol * new, nf, nf, dtype=torch.complex128, device=device)
        _time_prog(progs, device, f"Clean's window SVD [{npol * new}, {nf}, {nf}] complex128",
                   lambda: torch.linalg.svd(Wm, full_matrices=False), npol * new * 4 * 22.0 * nf**3,
                   2 * Wm.numel() * 16, "float64")
        del hv, hfilt, filt, vis, wgt, cvar, Wm
        seconds["20c"] = time.perf_counter() - t_sub
    FILT_PROBES.clear()
    gc.collect()
    log("phase 20 device programs alone (s, bound s, bound by): " + json.dumps(progs))
    log("phase 20 sub-phase seconds: " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    if failures:
        raise RuntimeError(f"phase 20 (filter path) failed: {', '.join(failures)}")



def legendre_bound(L1: int, l0: int, m_vals, R: int, mode: str) -> tuple[float, str]:
    """Least ms the card could take for one ``legendre_block`` call and what
    sets it: its output written once (6 bytes a value two-float, else the
    type's) and its inputs read once at the HBM rate, against 4 operations
    (three multiplies and an add) for every value above the seed, l > m, in
    the working type at the peak rate outside the tensor cores."""
    C = len(m_vals)
    esize = 8 if mode != "f32" else 4
    nbytes = (L1 - l0) * C * R * (6 if mode == "2f" else esize) + (2 * R + 2 * C + 2 * L1 * C) * esize
    flops = 4.0 * R * float(np.maximum(0, L1 - 1 - np.asarray(m_vals)).sum())
    t, by = _bound(flops, nbytes, "float32" if mode == "f32" else "float64")
    return t * 1e3, by


def _legendre_err(got, ref, two_float: bool) -> tuple[float, float, bool]:
    """(max|got - ref|, max|ref|, got finite) of two Legendre blocks, hi + lo
    summed in float64 for the two-float mode; a slab of l rows at a time, so
    a whole table's comparison holds little more than the two blocks."""
    import torch

    err, scale, finite = 0.0, 0.0, True
    nl = (got[0] if two_float else got).shape[0]
    for l0 in range(0, nl, 64):
        if two_float:
            g = got[0][l0:l0 + 64].double() + got[1][l0:l0 + 64].double()
            r = ref[0][l0:l0 + 64].double() + ref[1][l0:l0 + 64].double()
        else:
            g, r = got[l0:l0 + 64].double(), ref[l0:l0 + 64].double()
        err = max(err, (g - r).abs().max().item())
        scale = max(scale, r.abs().max().item())
        finite = finite and bool(torch.isfinite(g).all())
    return err, scale, finite


def check_legendre(device, s, rings, m_vals, l0: int, label: str, modes=("2f", "f64", "f32"),
                   time_it: bool = False) -> dict:
    """The Legendre kernel against its plain version on the card, on the
    exact inputs a path hands it (``rings`` in its order, the m of
    ``m_vals``, rows from ``l0``), in each of ``modes``; with ``time_it``
    the two-float call is timed beside the plain one (plain, kernel,
    kernel, plain; the first plain call is the check's own)."""
    import torch

    from draco_tpu_torch.ops import cuda_kernels, sht

    rings, m_vals = np.asarray(rings), np.asarray(m_vals)
    stats = {}
    for mode in modes:
        wdt = cuda_kernels.LEGENDRE_MODES[mode]

        def t(a, wdt=wdt):
            return torch.as_tensor(a, dtype=wdt, device=device)

        args = (t(s._x[rings]), t(s._lnsin[rings]), t(s._cm[m_vals]), t(s._a_tab[:, m_vals]),
                t(s._b_tab[:, m_vals]), torch.as_tensor(m_vals, device=device))
        got = cuda_kernels.legendre_block(*args, mode, l0=l0)
        t0 = _sync_clock(device)
        ref = sht._legendre_block_core(*args, two_float=mode == "2f", l0=l0)
        plain1 = (_sync_clock(device) - t0) * 1e3
        err, scale, finite = _legendre_err(got, ref, mode == "2f")
        log(f"legendre kernel [{label}, m {m_vals[0]}-{m_vals[-1]}, l {l0}-{s.lmax}, {len(rings)} rings] {mode}: "
            f"max_abs_err {err:.3e} rel {err / scale:.3e} (tol {TOL_LEGENDRE[mode]}), max|Lambda| {scale:.3e}")
        if not (finite and err <= TOL_LEGENDRE[mode] * scale):
            raise RuntimeError(f"the legendre kernel ({label}, {mode}) disagrees with its plain version: "
                               f"{err / scale:.3e}")
        stats["max_abs_err"] = max(stats.get("max_abs_err", 0.0), err)
        stats[f"max_abs_err_{mode}"] = err
        del got, ref
        if mode == "2f" and time_it:
            kern1 = cuda_ms(lambda: cuda_kernels.legendre_block(*args, "2f", l0=l0), 5)
            kern2 = cuda_ms(lambda: cuda_kernels.legendre_block(*args, "2f", l0=l0), 5)
            t0 = _sync_clock(device)
            sht._legendre_block_core(*args, two_float=True, l0=l0)
            plain2 = (_sync_clock(device) - t0) * 1e3
            bound, by = legendre_bound(s.lmax + 1, l0, m_vals, len(rings), "2f")
            log(f"legendre kernel [{label}, m {m_vals[0]}-{m_vals[-1]}] two-float ms: kernel {kern1:.4f} {kern2:.4f}, "
                f"plain loop {plain1:.2f} {plain2:.2f}, bound {bound:.4f} ({by}); "
                f"{(s.lmax + 1 - l0) * len(m_vals) * len(rings) * 6 / 1e9:.3f} GB written")
            stats.update({"ms": min(kern1, kern2), "plain_ms": min(plain1, plain2), "bound_ms": bound,
                          "bound_by": by, "library_ms": None})
        del args
    return stats


def check_legendre_tables(device, bt, label: str) -> dict:
    """The Legendre kernel's launches on a round trip's path held against
    the plain loop on their exact inputs: the whole-table build (every m,
    every ring in section order, from l = 0) and, when the beam has a
    window, the band rings' table, both two-float and float64."""
    from draco_tpu_torch.ops import sht

    tel = bt.telescope
    s = sht.get_sht(bt.beam_nside, tel.lmax, tel.mmax)
    stats = check_legendre(device, s, s._section_rings(), s._m, 0, f"{label} tables", ("2f", "f64"))
    win = bt._beam_window()
    if win is not None:
        band = check_legendre(device, s, win.band, s._m, 0, f"{label} band rings", ("2f", "f64"))
        stats = {k: max(v, band[k]) for k, v in stats.items()}
    return stats


def run_sht(device, nside: int = SHT_NSIDE, nfreq: int = SHT_NFREQ, ncheck: int = SHT_NCHECK,
            nside_tables: int = SHT_NSIDE_TABLES, nmaps_tables: int = SHT_NMAPS_TABLES) -> tuple[int, dict]:
    """Phase 21a: a foreground sky at nside 1024 made and transformed both ways
    by the chunked route, with the Legendre kernel held against its plain
    version; returns (the kernel's launches on the main path, its stats).
    Smaller sizes make it a rehearsal on the CPU."""
    import gc

    import torch

    from draco_tpu_torch.ops import cuda_kernels, healpix, sht
    from draco_tpu_torch.synthesis.skymodel import make_sky

    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    s = sht.get_sht(nside)
    log(f"sht nside={nside} lmax=mmax={s.lmax}: tables would need {s.table_bytes(torch.float32) / 1e9:.1f} GB "
        f"(float32), {s.table_bytes(torch.float64) / 1e9:.1f} GB (float64); budget "
        f"{sht.TABLE_BUDGET_BYTES / 2**30:.0f} GiB; chunk_m {s.chunk_m}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    # the main path: the counts are zeroed just before it and read just after
    cuda_kernels.reset_launches()
    t0 = _sync_clock(device)
    sky = make_sky("foreground", nside=nside, nfreq=nfreq, seed=SHT_SEED, device=device)
    t_sky = _sync_clock(device) - t0
    route_sky = s.last_route
    maps = sky.map[:][:, 0].float()  # [nfreq, npix]
    t0 = _sync_clock(device)
    alm = sht.map2alm(maps, iter=0)
    t_ana = _sync_clock(device) - t0
    route_ana = s.last_route
    t0 = _sync_clock(device)
    back = sht.alm2map(alm, nside)
    t_syn = _sync_clock(device) - t0
    route_syn = s.last_route
    launches = dict(cuda_kernels.launches)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else float("nan")
    nchunk = len(list(s._m_chunks()))
    log(f"phase 21a main path: makesky {t_sky:.2f} s (route {route_sky}), map2alm of {nfreq} maps {t_ana:.2f} s "
        f"(route {route_ana}), alm2map {t_syn:.2f} s (route {route_syn}); legendre launches {launches['legendre']} "
        f"({nchunk} chunks a transform), peak device memory {peak:.2f} GiB")
    if not route_sky == route_ana == route_syn == "chunked":
        raise RuntimeError(f"the nside {nside} transforms took the routes {route_sky}, {route_ana}, {route_syn}")
    if cuda and launches["legendre"] != 3 * nchunk:
        raise RuntimeError(f"the legendre kernel launched {launches['legendre']} times for 3 x {nchunk} chunks")
    if not (bool(torch.isfinite(maps).all()) and bool(torch.isfinite(alm).all()) and bool(torch.isfinite(back).all())):
        raise RuntimeError("a phase 21a transform is not finite")
    if alm.shape != (nfreq, s.lmax + 1, s.mmax + 1) or back.shape != maps.shape or alm.dtype != torch.complex64:
        raise RuntimeError(f"phase 21a shapes: alm {tuple(alm.shape)} {alm.dtype}, maps {tuple(back.shape)}")

    if cuda:
        profile_top(lambda: sht.map2alm(maps, iter=0), f"map2alm of {nfreq} maps at nside {nside}")

    # the kernel on the first chunk and the last (the polar-underflow regime)
    chunks, rings = list(s._m_chunks()), s._section_rings()
    stats = check_legendre(device, s, rings, chunks[0], int(chunks[0][0]), f"nside {nside}", time_it=True)
    stats_last = check_legendre(device, s, rings, chunks[-1], int(chunks[-1][0]), f"nside {nside}")
    stats.update({k: max(v, stats_last[k]) for k, v in stats.items() if k.startswith("max_abs_err")})
    bound_all = sum(legendre_bound(s.lmax + 1, int(c[0]), c, s.info.nring, "2f")[0] for c in chunks)
    log(f"legendre kernel: a float32 transform's {nchunk} chunks need >= {bound_all:.2f} ms of writes "
        f"({sum((s.lmax + 1 - int(c[0])) * len(c) for c in chunks) * s.info.nring * 6 / 1e9:.2f} GB)")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # float32 against float64, the same chunked route on the card
    m64 = maps[:ncheck].double()
    t0 = _sync_clock(device)
    alm64 = sht.map2alm(m64, iter=0)
    back64 = sht.alm2map(alm64, nside)
    t64 = _sync_clock(device) - t0
    rel_alm, rel_map = _rel(alm[:ncheck], alm64), _rel(back[:ncheck], back64)
    log(f"phase 21a float32 vs float64 on {ncheck} channels ({t64:.2f} s in float64): alm {rel_alm:.3e}, "
        f"maps {rel_map:.3e} (tol {TOL_SHT})")
    if not (rel_alm <= TOL_SHT and rel_map <= TOL_SHT and bool(torch.isfinite(back64).all())):
        raise RuntimeError(f"the float32 transforms are {rel_alm:.3e} / {rel_map:.3e} from float64")
    del sky, maps, alm, back, m64, alm64, back64
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the smoothing at nside 1024 (lmax 2 nside: chunked) against float64
    one = np.random.Generator(np.random.SFC64(SHT_SEED)).standard_normal(healpix.npix_of(nside))
    fwhm = healpix.nside2resol(nside) * 4
    t0 = _sync_clock(device)
    sm32 = healpix.smooth_gaussian(one.astype(np.float32), fwhm, device=device)
    t_sm = _sync_clock(device) - t0
    sm64 = healpix.smooth_gaussian(one, fwhm, device=device)
    rel_sm = float(np.abs(sm32 - sm64).max() / np.abs(sm64).max())
    route_sm = sht.get_sht(nside, 2 * nside, 2 * nside).last_route
    log(f"phase 21a smooth_gaussian at nside {nside} (route {route_sm}, {t_sm:.2f} s in float32): float32 vs float64 "
        f"{rel_sm:.3e} (tol {TOL_SHT})")
    if not (rel_sm <= TOL_SHT and np.isfinite(sm32).all() and route_sm == "chunked"):
        raise RuntimeError(f"smooth_gaussian at nside {nside}: {rel_sm:.3e} from float64, route {route_sm}")

    # both routes at the largest nside that keeps its tables
    st = sht.SHT(nside_tables)
    m4 = torch.from_numpy(np.random.Generator(np.random.SFC64(SHT_SEED + 1)).standard_normal(
        (nmaps_tables, healpix.npix_of(nside_tables))).astype(np.float32)).to(device)
    lam, lam_lo, plan = st.tables(device, torch.float32)
    a_t = st._analysis_impl(m4, lam, plan, lam_lo)
    a_c = st._analysis_impl(m4, None)
    b_t = st._synthesis_impl(a_t, lam, plan, lam_lo)
    b_c = st._synthesis_impl(a_t, None)
    rel_a, rel_b = _rel(a_c, a_t), _rel(b_c, b_t)
    log(f"phase 21a nside {nside_tables} (route {st.route(torch.float32)}): chunked vs tables alm {rel_a:.3e}, "
        f"maps {rel_b:.3e} (tol {TOL_SHT_ROUTES})")
    if st.route(torch.float32) != "tables" or not (rel_a <= TOL_SHT_ROUTES and rel_b <= TOL_SHT_ROUTES):
        raise RuntimeError(f"at nside {nside_tables} the chunked route is {rel_a:.3e} / {rel_b:.3e} from the tables")
    del st, lam, lam_lo, plan, m4, a_t, a_c, b_t, b_c
    sht._sht_cache.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"phase 21a wall time {time.perf_counter() - t_phase:.1f} s")
    return launches["legendre"], stats


def verify_config(product_dir: str, tel, nside: int) -> dict:
    """21b (ii): a seeded simulation of a small polarised cylinder's full
    triangle, gains applied, collated (``CollateProducts``), Stokes I
    (``StokesIVis``) and its delay spectrum."""
    f = np.asarray(tel.frequencies)
    sky = {"model": "foreground", "nside": nside, "freq_start": float(f[0]),
           "freq_end": float(f[-1] + (f[1] - f[0])), "nfreq": len(f), "polarisation": True, "seed": VERIFY_SEED}
    return {"pipeline": {"retain_products": "all", "tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"],
         "params": {"product_directory": product_dir, "nside": nside}},
        {"type": "draco.synthesis.skymodel.GenerateGaussianSky", "out": "sky", "params": sky},
        {"type": "draco.synthesis.stream.SimulateSidereal", "requires": "bt", "in": "sky", "out": "sstream",
         "params": {"streaming": True}},
        {"type": "draco.synthesis.stream.ExpandProducts", "requires": "tel", "in": "sstream", "out": "sfull"},
        {"type": "draco.synthesis.gain.RandomSiderealGains", "requires": ["tel", "sfull"], "out": "gain",
         "params": {"seed": VERIFY_SEED, "start_time": "2015-10-05 12:15:00", "end_time": "2015-10-06 12:15:00",
                    "sigma_amp": 0.01, "sigma_phase": 0.01}},
        {"type": "draco.analysis.calibration.ApplyGain", "in": ["sfull", "gain"], "out": "sgain",
         "params": {"inverse": False}},
        {"type": "draco.analysis.transform.CollateProducts", "requires": "bt", "in": "sgain", "out": "scoll"},
        {"type": "draco.analysis.transform.StokesIVis", "requires": "tel", "in": "scoll", "out": "sI"},
        {"type": "draco.analysis.delay.DelaySpectrumFFT", "in": "sI", "out": "dspec",
         "params": {"complex_timedomain": True, "freq_frac": -1.0}},
    ]}}


def _fingerprint_count(fp: dict) -> tuple[int, int]:
    """(labels, arrays) that a fingerprint of a Manager's products digests."""
    labels = {k.split("]")[0] for k in fp}
    return len(labels), sum(v != "<unchecked>" for v in fp.values())


def run_verify(device, chain_fps, nside: int = VERIFY_NSIDE, nfreq: int = VERIFY_NFREQ, ncyl: int = 2,
               nfeed: int = 16) -> None:
    """Phase 21b: the determinism check on the card, bitwise (rtol 0): (i) phase
    10's two runs of the dish chain, (ii) a small config through
    ``CollateProducts`` and ``StokesIVis``, run twice by
    ``check_pipeline_determinism``."""
    import pickle
    import tempfile

    from draco_tpu_torch.parallel import validate

    t_phase = time.perf_counter()
    fp1, fp2 = chain_fps
    nlab, narr = _fingerprint_count(fp1)
    differ = sorted(k for k in set(fp1) | set(fp2) if fp1.get(k) != fp2.get(k))
    log(f"phase 21b (i) phase 10's two runs: {nlab} labels, {narr} arrays compared bitwise; "
        f"{len(differ)} differ{': ' + ', '.join(differ[:20]) if differ else ''}")
    if narr == 0 or set(fp1) != set(fp2):
        raise RuntimeError(f"phase 10's fingerprints hold {narr} arrays, and {len(set(fp1) ^ set(fp2))} keys "
                           "are in one run only: nothing to compare")
    if differ:
        raise RuntimeError(f"phase 10's two runs differ in {len(differ)} arrays: {differ[:20]}")
    tel, _ = cylinder(nside, ncyl, nfeed, pol=True, nfreq=nfreq)
    with tempfile.TemporaryDirectory() as product_dir:
        with open(Path(product_dir) / "telescope.pkl", "wb") as f:
            pickle.dump(tel, f)
        cfg = verify_config(product_dir, tel, nside)
        t0 = _sync_clock(device)
        summary = validate.check_pipeline_determinism(cfg, runs=2, rtol=0.0)
        wall = _sync_clock(device) - t0
    labels = [t["out"] for t in cfg["pipeline"]["tasks"]]
    log(f"phase 21b (ii) {len(tel.uniquepairs)} pairs of a {ncyl} x {nfeed} dual-pol cylinder, {nfreq} channels, "
        f"nside {nside}: two runs in {wall:.2f} s bit-identical: {summary['products']} product labels "
        f"({labels}), {summary['arrays']} arrays")
    log(f"phase 21b wall time {time.perf_counter() - t_phase:.1f} s")


def mesh_telescope(nside: int, nfreq: int):
    """Phase 22: the dish slice's array (8 x 8 jittered dishes, 2017 unique
    baselines) over ``nfreq`` channels centred on lambda = 0.6 m, as
    bench.py's multi-frequency extra (``bench.py:291-306``)."""
    from draco_tpu_torch.telescope import UnpolarisedDishArray

    f0 = 299.792458 / 0.6
    half_bw = 0.05 * f0 * (nfreq - 1) / nfreq
    return UnpolarisedDishArray(
        grid_ew=NFEED_SIDE, grid_ns=NFEED_SIDE, spacing_ew=7.0, spacing_ns=7.0,
        jitter=1.0, jitter_seed=1, latitude=45.0, dish_width=5.0, fwhm_factor=1.0,
        freq_lower=f0 - half_bw, freq_upper=f0 + half_bw, num_freq=nfreq, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
    )


def mesh_config(product_dir: str, tel, nside: int, chunk: int, fp_path: str, mesh: bool) -> dict:
    """Phase 22a: sky -> ``SimulateSidereal`` -> ``MModeTransform`` ->
    ``DirtyMapMaker`` (both streaming), with ``FrequencyRebin`` (pairs of
    channels) beside them, every product's fingerprint written by
    ``WriteFingerprints``; under ``pipeline.mesh: {freq: -1}`` if ``mesh``."""
    streaming = {"streaming": True, "baseline_chunk": chunk}
    sky = {"model": "foreground", "nside": nside, "freq_start": float(tel.freq_lower),
           "freq_end": float(tel.freq_upper), "nfreq": tel.nfreq, "seed": MESH_SEED}
    pipeline = {"retain_products": "none", "tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"],
         "params": {"product_directory": product_dir, "nside": nside}},
        {"type": "draco.synthesis.skymodel.GenerateGaussianSky", "out": "sky", "params": sky},
        {"type": "draco.synthesis.stream.SimulateSidereal", "requires": "bt", "in": "sky", "out": "sstream",
         "params": streaming},
        {"type": "draco.analysis.transform.FrequencyRebin", "in": "sstream", "out": "srebin",
         "params": {"channel_bin": 2}},
        {"type": "draco.analysis.transform.MModeTransform", "requires": "tel", "in": "sstream", "out": "mmodes"},
        {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "bt", "in": "mmodes", "out": "dmap",
         "params": {"nside": nside, **streaming}},
        {"type": f"{Path(__file__).stem}.WriteFingerprints", "in": list(MESH_LABELS),
         "params": {"path": fp_path, "names": list(MESH_LABELS)}},
    ]}
    if mesh:
        pipeline["mesh"] = {"freq": -1}
    return {"pipeline": pipeline}


def _fingerprint_task():
    """``WriteFingerprints``: a sink task that writes what a run produced to
    JSON, one file a process (``path`` formatted with ``rank``): the
    fingerprints (``parallel.validate.fingerprint``) of each input under
    its name in ``names``, the card's peak memory, the backend and the
    kernels' launch counts.  The card machine has no ``h5py``: this is how
    phase 22 holds runs in other processes against each other."""
    import torch
    import torch.distributed

    from draco_tpu_torch.core import config
    from draco_tpu_torch.core.task import ContainerTask
    from draco_tpu_torch.ops import cuda_kernels
    from draco_tpu_torch.parallel import multihost, validate

    class WriteFingerprints(ContainerTask):
        path = config.str_prop()
        names = config.list_prop([])

        def process(self, *inputs):
            names = list(self.names) or [str(i) for i in range(len(inputs))]
            if len(names) != len(inputs):
                raise ValueError(f"{len(names)} names for {len(inputs)} inputs")
            record = {
                "rank": multihost.process_index(),
                "processes": multihost.process_count(),
                "backend": torch.distributed.get_backend() if torch.distributed.is_initialized() else None,
                "fingerprints": {n: validate.fingerprint(x) for n, x in zip(names, inputs)},
                "launches": dict(cuda_kernels.launches),
                "peak_memory_bytes": torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else None,
            }
            with open(self.path.format(rank=record["rank"]), "w") as f:
                json.dump(record, f)

    return WriteFingerprints


def __getattr__(name: str):
    # phase 22's configs name ``chip_smoke.WriteFingerprints``; the class is
    # made on first use, as this module imports the port only inside functions
    if name != "WriteFingerprints":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    cls = globals()[name] = _fingerprint_task()
    return cls


def _gib(nbytes) -> str:
    return "n/a (no card)" if nbytes is None else f"{nbytes / 2**30:.2f} GiB"


class Launch:
    """``python -m draco_tpu_torch run cfg_path`` in ``world`` processes, the
    launch variables set for each (world None: one plain process)."""

    def __init__(self, label: str, cfg_path: str, fp_path: str, world: int | None, device, per_rank_env=None):
        repo = Path(__file__).resolve().parent
        cmd = [sys.executable, "-m", "draco_tpu_torch"] + (["--platform", "cpu"] if device.type == "cpu" else [])
        cmd += ["run", cfg_path]
        self.label, self.fp_path, self.world = label, fp_path, world
        store = Path(fp_path).parent / f"store-{Path(cfg_path).stem}"  # a file store: no port to race for
        self.procs, self.logs = [], []
        self.t0 = time.perf_counter()
        for rank in range(world or 1):
            env = dict(os.environ)
            if world is not None:
                env.update(DRACO_TPU_COORDINATOR=f"file://{store}", DRACO_TPU_NUM_PROCESSES=str(world),
                           DRACO_TPU_PROCESS_ID=str(rank))
            env.update((per_rank_env or {}).get(rank, {}))
            self.logs.append(fp_path.format(rank=rank) + ".log")
            with open(self.logs[-1], "w") as out:
                self.procs.append(subprocess.Popen(cmd, cwd=repo, env=env, stdout=out, stderr=subprocess.STDOUT))
        # each process's end, seen as it happens (wait() is called later)
        self.ended = [None] * len(self.procs)
        self.watchers = [threading.Thread(target=self._watch, args=(r, p), daemon=True) for r, p in enumerate(self.procs)]
        for w in self.watchers:
            w.start()

    def _watch(self, rank: int, proc) -> None:
        proc.wait()
        self.ended[rank] = time.perf_counter()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def output(self, rank: int) -> str:
        with open(self.logs[rank]) as f:
            return f.read()[-3000:]

    def wait(self):
        """(wall seconds, each rank's ``WriteFingerprints`` record); a process
        that fails, or a launch that outlasts ``MESH_TIMEOUT_S``, stops the
        others and raises with the output."""
        deadline = self.t0 + MESH_TIMEOUT_S
        try:
            while any(p.poll() is None for p in self.procs):
                failed = [r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]
                if failed or time.perf_counter() > deadline:
                    self.kill()
                    outs = {r: self.output(r) for r in (failed or range(len(self.procs)))}
                    why = f"ranks {failed} failed" if failed else f"did not finish in {MESH_TIMEOUT_S} s"
                    raise RuntimeError(f"phase 22a {self.label}: {why}:\n"
                                       + "\n".join(f"[rank {r}] {o}" for r, o in outs.items()))
                time.sleep(0.2)
            for w in self.watchers:
                w.join()
            wall = max(self.ended) - self.t0
            bad = {r: p.returncode for r, p in enumerate(self.procs) if p.returncode != 0}
            if bad:
                raise RuntimeError(f"phase 22a {self.label}: exit codes {bad}:\n" + self.output(min(bad)))
        finally:
            self.kill()
        records = []
        for rank in range(self.world or 1):
            with open(self.fp_path.format(rank=rank)) as f:
                records.append(json.load(f))
        return wall, records


def run_multidevice(device, nside: int = NSIDE, nfreq: int = MESH_NFREQ, chunk: int = CHUNK,
                    dryrun_ranks: int = 2) -> dict:
    """Phase 22: the multi-device layer.

    22a: the spine through ``python -m draco_tpu_torch run`` under
    ``pipeline.mesh: {freq: -1}``: at world size 1 (``nccl`` on the card), as
    two ranks sharing the card (``gloo``: ``nccl`` refuses two ranks on one
    card) and, with two or more cards, one rank per card (``nccl``), the
    launches at once on the card beside this process's own run of the config
    with no mesh; every product of every rank bit-equal to that run (the
    chain has no sum across ranks: every stage is frequency-local or
    gathered); each rank's peak memory, launch wall time and Legendre
    launches printed; on the card, the Legendre kernel held against its
    plain loop at the shapes of the ranks' launches.  22b, while the
    launches run: ``dryrun_multichip(2)`` on the card.  Returns (the
    kernels' launches in 22a's runs, by launch and rank; the Legendre
    check's max errors, empty on the CPU).
    """
    import pickle
    import tempfile

    import torch

    from draco_tpu_torch.core.pipeline import Manager, dump_config
    from draco_tpu_torch.ops import cuda_kernels
    from draco_tpu_torch.parallel import dryrun_multichip
    from draco_tpu_torch.telescope import BeamTransfer

    t_phase = time.perf_counter()
    tel = mesh_telescope(nside, nfreq)
    ncard = torch.cuda.device_count() if device.type == "cuda" else 0
    runs = [("world size 1", 1, None), ("two ranks on one card", 2, None)]
    if ncard >= 2:
        nper = 4 if ncard >= 4 else 2  # ranks that divide the 8 channels
        runs.append((f"one rank per card on {nper} cards", nper,
                     {r: {"CUDA_VISIBLE_DEVICES": str(r)} for r in range(nper)}))
    launches, started = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        with open(Path(tmp) / "telescope.pkl", "wb") as f:
            pickle.dump(tel, f)

        def cfg_for(name: str, mesh: bool) -> tuple[dict, str]:
            fp = str(Path(tmp) / f"fp.{name}.{{rank}}.json")  # WriteFingerprints formats the rank
            return mesh_config(tmp, tel, nside, chunk, fp, mesh), fp

        try:
            for label, world, env in runs:
                cfg, fp = cfg_for(label.replace(" ", "_"), True)
                path = Path(tmp) / f"{label.replace(' ', '_')}.yaml"
                path.write_text(dump_config(cfg))
                started.append((label, world, env, Launch(label, str(path), fp, world, device, env)))
            # the kernel at the ranks' shapes: the whole table (phase 3's
            # inputs) and the band rings of a window over all 8 channels
            leg = (check_legendre_tables(device, BeamTransfer(tel, nside=nside), f"phase 22 nside {nside}")
                   if device.type == "cuda" else {})
            # the reference: this process, no mesh, beside the launches
            cfg, fp = cfg_for("ref", False)
            cuda_kernels.reset_launches()
            t0 = _sync_clock(device)
            Manager(cfg).run()
            wall = _sync_clock(device) - t0
            with open(fp.format(rank=0)) as f:
                ref_fp = json.load(f)["fingerprints"]
            narr = sum(len(v) for v in ref_fp.values())
            log(f"phase 22a this process, no mesh: {wall:.2f} s wall, {len(tel.uniquepairs)} baselines, {nfreq} "
                f"channels, nside {nside}; {narr} arrays of {len(ref_fp)} products fingerprinted; launches "
                f"{dict(cuda_kernels.launches)} (the tables may be cached here)")
            # 22b, while the launches run
            t0 = time.perf_counter()
            summary = dryrun_multichip(dryrun_ranks, device=None if device.type == "cuda" else "cpu")
            log(f"phase 22b dryrun_multichip({dryrun_ranks}) on {summary['device']}: {time.perf_counter() - t0:.2f} s "
                "(beside 22a's launches), " + json.dumps(summary))
            for label, world, env, run in started:
                key = label.replace(" ", "_")
                wall, recs = run.wait()
                launches[key] = [r["launches"] for r in recs]
                for r in recs:
                    log(f"phase 22a {label}: rank {r['rank']} of {r['processes']} on {r['backend']}: peak "
                        f"{_gib(r['peak_memory_bytes'])}, launches {r['launches']}")
                differ = sorted(f"rank {r['rank']} {lab}{k}" for r in recs for lab in ref_fp
                                for k in set(ref_fp[lab]) | set(r["fingerprints"].get(lab, {}))
                                if ref_fp[lab].get(k) != r["fingerprints"].get(lab, {}).get(k))
                backends = {r["backend"] for r in recs}
                log(f"phase 22a {label}: {wall:.2f} s from the launch to its last process's end (beside the other "
                    f"launches), backend "
                    f"{sorted(backends)}; {narr} arrays on each of {world} ranks against the run with no mesh: "
                    f"{len(differ)} differ{': ' + ', '.join(differ[:20]) if differ else ' (bit-equal)'}")
                if differ:
                    raise RuntimeError(f"phase 22a {label}: {len(differ)} arrays differ from the run with no mesh")
                want = "nccl" if (world == 1 or env) and device.type == "cuda" else "gloo"
                if backends != {want}:
                    raise RuntimeError(f"phase 22a {label} ran on {backends}, not {want}")
                if device.type == "cuda" and not all(n["legendre"] >= 1 for n in launches[key]):
                    raise RuntimeError(f"phase 22a {label}: a rank launched legendre no time: {launches[key]}")
        finally:
            for *_, run in started:
                run.kill()
    if ncard < 2:
        log(f"phase 22a: {ncard} card(s) here: nccl across cards did not run (unverified)")
    log(f"phase 22 wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, leg


def time_spine_tasks(device, nside: int, nfreq: int, chunk: int) -> list[dict]:
    """``--spine-stages tasks``: phase 22's chain in this process with no mesh,
    run twice (the first run builds the Legendre tables); each task's
    ``process`` timed, with its Legendre launches."""
    from draco_tpu_torch.analysis.mapmaker import DirtyMapMaker
    from draco_tpu_torch.analysis.transform import MModeTransform
    from draco_tpu_torch.ops import cuda_kernels
    from draco_tpu_torch.synthesis.skymodel import GenerateGaussianSky
    from draco_tpu_torch.synthesis.stream import SimulateSidereal
    from draco_tpu_torch.telescope import BeamTransfer

    tel = mesh_telescope(nside, nfreq)
    bt = BeamTransfer(tel, nside=nside)
    sky_task = GenerateGaussianSky()
    sky_task.read_config({"model": "foreground", "nside": nside, "freq_start": float(tel.freq_lower),
                          "freq_end": float(tel.freq_upper), "nfreq": nfreq, "seed": MESH_SEED})
    sky_task.setup()
    sky = sky_task.process()
    streaming = {"streaming": True, "baseline_chunk": chunk}
    stages = [("SimulateSidereal", SimulateSidereal(), streaming, bt), ("MModeTransform", MModeTransform(), {}, tel),
              ("DirtyMapMaker", DirtyMapMaker(), {"nside": nside, **streaming}, bt)]
    for _, task, params, req in stages:
        task.read_config(params)
        task.setup(req)
    rows = []
    for run in ("first", "second"):
        data = sky
        for name, task, _, _ in stages:
            cuda_kernels.reset_launches()
            t0 = _sync_clock(device)
            data = task.process(data)
            seconds = _sync_clock(device) - t0
            rows.append({"case": "tasks", "run": run, "stage": name, "seconds": seconds, "nside": nside,
                         "nfreq": nfreq, "legendre_launches": cuda_kernels.launches["legendre"]})
        m = data.map[:]
        rows[-1]["map_sum_abs"] = float(m.abs().double().sum())
    return rows


def time_spine_sht(device, nside: int, nfreq: int, reps: int) -> list[dict]:
    """``--spine-stages sht``: ``nfreq`` maps at ``nside`` through
    ``sphtrans_sky`` and ``sphtrans_inv_sky`` batched, one whole transform a
    channel, and (where the package has it) ``per_channel=True``; each timed
    ``reps`` times after a warm call, with its Legendre launches and its
    largest difference from the batched call over the largest value."""
    import inspect

    import torch

    from draco_tpu_torch.ops import cuda_kernels, sht

    rng = np.random.Generator(np.random.SFC64(5))
    maps = torch.as_tensor(rng.standard_normal((nfreq, 1, 12 * nside**2)), dtype=torch.float32, device=device)
    has_flag = "per_channel" in inspect.signature(sht.sphtrans_sky).parameters
    route = sht.get_sht(nside).route(torch.float32)
    ways = {
        "analysis": {
            "batched": lambda x: sht.sphtrans_sky(x),
            "whole_per_channel": lambda x: torch.cat([sht.sphtrans_sky(x[i : i + 1]) for i in range(x.shape[0])]),
        },
        "synthesis": {
            "batched": lambda a: sht.sphtrans_inv_sky(a, nside),
            "whole_per_channel": lambda a: torch.cat([sht.sphtrans_inv_sky(a[i : i + 1], nside)
                                                      for i in range(a.shape[0])]),
        },
    }
    if has_flag:
        ways["analysis"]["per_channel"] = lambda x: sht.sphtrans_sky(x, per_channel=True)
        ways["synthesis"]["per_channel"] = lambda a: sht.sphtrans_inv_sky(a, nside, per_channel=True)
    rows = []
    alm = None
    for direction, fns in ways.items():
        x = maps if direction == "analysis" else alm
        ref = fns["batched"](x)  # the warm call
        scale = float(ref.abs().max())
        for way, fn in fns.items():
            seconds, out = [], None
            for _ in range(reps):
                del out
                out = None
                cuda_kernels.reset_launches()
                t0 = _sync_clock(device)
                out = fn(x)
                seconds.append(_sync_clock(device) - t0)
            rows.append({"case": "sht", "direction": direction, "way": way, "route": route, "nside": nside,
                         "nfreq": nfreq, "seconds": seconds, "legendre_launches": cuda_kernels.launches["legendre"],
                         "rel_from_batched": float((out - ref).abs().max()) / scale})
        del out
        if direction == "analysis":
            alm = ref
    return rows


def spine_stages(args) -> int:
    """``python3 chip_smoke.py --spine-stages tasks,sht [--repo DIR]``: not the
    smoke but a timing of the spine's SHT stages, one JSON line a row, with
    the package of the checkout at ``--repo`` (this one by default), so that
    two checkouts run in one call can be compared.

    - ``tasks``: phase 22's chain (``mesh_telescope``: 2017 baselines,
      ``--nfreq`` channels, nside ``--nside``, the SHT's table route at
      256) with no mesh, twice;
    - ``sht``: ``--nfreq`` maps at ``--nside-chunked`` (1024: the chunked
      route, whose Legendre rows are made anew in every call).

    The last line printed is the card's ``nvidia-smi`` name and power limit.
    """
    import torch

    sys.path.insert(0, str(Path(args.repo).resolve()))
    import draco_tpu_torch  # noqa: F401  (sets the float32 matmul policy)
    from draco_tpu_torch.device import default_device

    device = torch.device(args.device)
    log(json.dumps({"repo": str(Path(args.repo).resolve()), "torch": torch.__version__}))
    cases = args.spine_stages.split(",")
    with default_device(device):
        rows = time_spine_tasks(device, args.nside, args.nfreq, CHUNK) if "tasks" in cases else []
        rows += time_spine_sht(device, args.nside_chunked, args.nfreq, 2) if "sht" in cases else []
    for row in rows:
        log(json.dumps(row))
    if device.type == "cuda":
        log(gpu_name_and_power())
    return 0


def _bl_max(tel) -> float:
    from draco_tpu_torch.analysis.powerspec import TransformJyPerBeamToKelvin

    t = TransformJyPerBeamToKelvin()
    t.read_config({})
    t.setup(tel)
    return t.bl_max


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2, help="seed of the time streams and kernel inputs")
    parser.add_argument("--spine-stages", metavar="CASES",
                        help="instead of the smoke, time the spine's SHT stages (tasks, sht; see spine_stages)")
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parent),
                        help="with --spine-stages: the checkout whose draco_tpu_torch is timed")
    parser.add_argument("--device", default="cuda", help="with --spine-stages: the device")
    parser.add_argument("--nside", type=int, default=NSIDE, help="with --spine-stages: the task chain's nside")
    parser.add_argument("--nside-chunked", type=int, default=SHT_NSIDE, help="with --spine-stages: the maps' nside")
    parser.add_argument("--nfreq", type=int, default=MESH_NFREQ, help="with --spine-stages: channels")
    args = parser.parse_args()
    if args.spine_stages:
        return spine_stages(args)
    # the later phases hold tens of GB in blocks of changing sizes: let the
    # caching allocator grow its segments rather than split them (set before
    # torch first touches the card)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    repo = Path(__file__).resolve().parent
    if not all((repo / "draco_tpu_torch" / "csrc" / f"{n}.cu").is_file()
               for n in ("banded_covariance", "beamform", "legendre")):
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
    leg_tables = check_legendre_tables(device, bt, f"dish slice nside {NSIDE}")

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
    chain_launches, chain_fps = run_task_chain(tel, device)
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
    medians, restore = _native_timer()
    try:
        run_ringmap(device)
    finally:
        restore()
    ringmap_launches = cuda_kernels.launches["banded_covariance"]
    log(f"phase 17 wall time {time.perf_counter() - t0:.1f} s; banded_covariance launches {ringmap_launches} "
        f"(the path has no regrid); native medians {medians['calls']} calls, {medians['seconds']:.2f} s (17a's "
        "RFIMask, both runs)")
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

    # phase 19: the flagging and fringe-stop path, after dropping phase 18's data
    STACK_PROBES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated before phase 19: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    cuda_kernels.reset_launches()
    run_flagging(device)
    flag_launches = dict(cuda_kernels.launches)
    log(f"phase 19 wall time {time.perf_counter() - t0:.1f} s; launches {flag_launches} (the path runs neither "
        "kernel)")

    # phase 20: the DAYENU, DPSS, wavelet and HyFoReS filter path
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated before phase 20: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    cuda_kernels.reset_launches()
    run_filters(device)
    filter_launches = dict(cuda_kernels.launches)
    log(f"phase 20 wall time {time.perf_counter() - t0:.1f} s; launches {filter_launches} (the path runs neither "
        "kernel)")

    # phase 21: the SHT at nside 1024 chunk by chunk, then the determinism check
    sht_mod._sht_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated before phase 21: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    sht_launches, leg_kern = run_sht(device)
    log(f"phase 21a done; launches {sht_launches} of legendre on the main path")
    run_verify(device, chain_fps)
    log(f"phase 21 wall time {time.perf_counter() - t0:.1f} s")

    # phase 22: the multi-device layer: the spine under a process mesh, the dry run
    sht_mod._sht_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches, mesh_leg = run_multidevice(device)
    log(f"smoke wall time {time.perf_counter() - t_start:.1f} s")

    def on_mesh(name):
        return {"launches": {run: [r[name] for r in ranks] for run, ranks in mesh_launches.items()}}

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
        "flagging_path": {"launches": flag_launches["banded_covariance"]},
        "filter_path": {"launches": filter_launches["banded_covariance"]},
        "multidevice_path": on_mesh("banded_covariance"),
    }, {
        "name": "beamform",
        "route": "cuda",
        "source": "draco_tpu_torch/csrc/beamform.cu",
        "replaces": "draco_tpu/ops/interferometry.py:161",
        "launches": stack_launches["beamform"],
        **beam_kern,
        "flagging_path": {"launches": flag_launches["beamform"]},
        "filter_path": {"launches": filter_launches["beamform"]},
        "multidevice_path": on_mesh("beamform"),
    }, {
        "name": "legendre",
        "route": "cuda",
        "source": "draco_tpu_torch/csrc/legendre.cu",
        "replaces": "draco_tpu/ops/sht.py:124",
        "launches": sht_launches,
        **leg_kern,
        "dish_slice": {"launches": launches["legendre"], **leg_tables},
        "cylinder_path": {"launches": launches_c["legendre"]},
        "flagging_path": {"launches": flag_launches["legendre"]},
        "filter_path": {"launches": filter_launches["legendre"]},
        "multidevice_path": {**on_mesh("legendre"), **mesh_leg},
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
