#!/usr/bin/env python3
"""Rates of the batched factorisations the foreground-filter path leans on.

    python3 scripts/torch_linalg_rates.py               # on the card
    python3 scripts/torch_linalg_rates.py --device cpu --scale 8   # a rehearsal

Times, with CUDA events after one warm call, at the shapes of the
191-pair cylinder (2 x 64 feeds, nside 256, lmax = mmax = 767, 4
frequencies; ntel 382, nsky 768, packed KL dimension 4 x 382 = 1528):

- ``torch.linalg.svd`` (economy) of [64, 382, 768] complex64 under the
  default cuSOLVER routine and each named one (``gesvdj``, ``gesvda``,
  ``gesvd``),
  with the singular values' error against a complex128 SVD and the
  reconstruction error: the beam SVD and the maximum-likelihood
  pseudo-inverse do 4 x 768 of these each;
- the SVD filter's batch, [768, 4, 382], in complex64 and complex128;
- ``torch.linalg.eigh``, ``cholesky_ex``, ``inv_ex`` and
  ``solve_triangular`` of [16, n, n] Hermitian positive-definite matrices,
  n = 764 and 1528, in complex64 and complex128: the KL solve does one of
  each (two triangular solves and a back-solve) per m.

``--scale k`` divides every dimension by k.  ``--json PATH`` also writes
the rows to a file; the last line printed is the card's ``nvidia-smi``
name and power limit.

    python3 scripts/torch_linalg_rates.py --kl          # on the card

``--kl`` instead measures, on the beam transfer matrices of that cylinder
at 16 sampled m (the product is generated on the card; ``--nside`` and
``--nfeed`` shrink it for a rehearsal), what the KL solve loses in
complex64 against complex128:

- the beam SVD [16 x 4, 382, 768] under each routine: seconds, the
  reconstruction error and the singular values against a complex128 SVD;
- ``KLTransform`` and ``DoubleKL`` solved in complex64 and in complex128
  from the same complex64 beam SVD: the round trip ``fwd @ bwd = I``, the
  diagonalisation ``V^H (S + N) V = diag(lambda + 1)`` (N the regularised
  matrix that is solved), and on 4 of the m the eigenvalues against
  ``scipy.linalg.eigh(S, N)`` on the host in float64; a factorisation that
  fails is reported as such;
- quantiles of the complex128 eigenvalues, from which the smoke's
  thresholds are chosen.

    python3 scripts/torch_linalg_rates.py --delay       # on the card

``--delay`` instead times the delay-spectrum path's calls at its widths
(1024 channels, N = 2048 delays, 240 samples; ``--scale`` divides them):

- ``cholesky_ex``, ``cholesky_solve`` (240 right-hand sides) and the
  batched product of float32 [B, 2048, 2048] normal matrices for B = 1, 8,
  16, 32 and 128, with whether the first 8 results are bit-identical
  across B (the batched Gibbs chain's chunk invariance rests on it);
- one batched Gibbs step (:func:`draco_tpu_torch.ops.delay.gibbs_step`,
  draws from one ``torch.Generator`` per baseline included) per baseline
  at B = 8, 16 and 32;
- the complex64 [16, 4096, 4096] Cholesky of the cross sampler's coupled
  system;
- the complex128 ``gesvd`` of the delay filter's [1024, k] Fourier designs
  (k = 160, 410, 680) and one complex128 likelihood core of the NRML
  estimator at [1016, 2048].

    python3 scripts/torch_linalg_rates.py --filters     # on the card

``--filters`` instead times the DAYENU, DPSS and wavelet path's
factorisations at its widths (``--scale`` divides them):

- ``torch.linalg.eigh`` in float64 of B DAYENU delay covariances [B, 1024,
  1024] (B = 1, 8, 32; 1024 channels over 400-800 MHz, cut 0.2-0.42 us,
  epsilon 1e-12) and :func:`draco_tpu_torch.ops.dayenu.hermitian_pinv_batched`
  of 32 of them;
- the float64 ``eigh`` of the m-mode filter's pair [2, 4096, 4096] (one
  channel of ``DayenuMFilter`` on CHIME's 4096 RA samples);
- the Wiener in-fill (:func:`draco_tpu_torch.analysis.wavelet.wiener_infill`,
  complex128 ``inv`` and ``solve`` at [B, 1024, 1024], 64 right-hand sides)
  for B = 1, 16 and 64;
- the DPSS bases of four m-mode cuts (:func:`draco_tpu_torch.ops.dpss.get_bases`,
  float64 [4, 4096, 4096]) and the complex64 ``cholesky_ex`` of 16 of the
  largest basis's [2529, 2529] systems.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SVD_BATCH = 64
NTEL, NSKY = 382, 768
FILTER_SHAPE = (768, 4, 382)
PENCIL_BATCH = 16
PENCIL_N = (764, 1528)


def seconds(fn, on_card: bool) -> float:
    """Seconds of one call after one warm call."""
    import torch

    fn()
    if not on_card:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3


def finish(json_path, on_card: bool, rows: list) -> int:
    """Print the card's name and power limit; write the rows beside them to ``json_path`` if given."""
    import torch

    card = "cpu rehearsal (no device number)"
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps({"card": card, "torch": torch.__version__, "rows": rows}, indent=1))
    print(card)
    return 0


def kl_precision(device, on_card: bool, nside: int, nfeed: int, json_path) -> int:
    """The ``--kl`` mode (see the module docstring)."""
    import numpy as np
    import scipy.linalg as sla
    import torch

    from draco_tpu_torch.ops.tools import SVD_ROUTINE_KEYWORD
    from draco_tpu_torch.telescope import BeamTransfer, UnpolarisedCylinderTelescope
    from draco_tpu_torch.telescope import kltransform as klmod

    rows = []

    def report(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    tel = UnpolarisedCylinderTelescope(
        num_cylinders=2, num_feeds=nfeed, num_freq=4, auto_correlations=True, force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1, freq_lower=400.0, freq_upper=500.0, cylinder_width=20.0, cylinder_spacing=22.0,
        feed_spacing=0.5, latitude=49.0,
    )
    bt = BeamTransfer(tel, nside=nside)
    t0 = time.perf_counter()
    bt.generate(device=device)
    if on_card:
        torch.cuda.synchronize()
    report(op="generate", pairs=tel.npairs, nside=nside, seconds=time.perf_counter() - t0)
    mmax = tel.mmax
    msel = sorted({int(round(x * mmax)) for x in (0, 1 / mmax, 2 / mmax, 0.007, 0.013, 0.026, 0.065, 0.13, 0.2, 0.26, 0.39, 0.52, 0.65, 0.78, 0.91, 1)})
    sel = torch.as_tensor(msel, device=device)
    # the sampled m take the place of the m axis: every function below then sees a short product
    bt._bp, bt._bm = bt._bp.index_select(-1, sel).contiguous(), bt._bm.index_select(-1, sel).contiguous()
    bt._bm[..., 0] = 0.0 if msel[0] == 0 else bt._bm[..., 0]

    B = torch.cat([bt._bp, bt._bm], dim=1).movedim(-1, 1).reshape(tel.nfreq * len(msel), bt.ntel, bt.nsky)
    s_ref = torch.linalg.svdvals(B.to(torch.complex128))
    for routine in ((None, "gesvdj", "gesvda", "gesvd") if on_card else (None,)):
        kw = {} if routine is None else {SVD_ROUTINE_KEYWORD: routine}
        try:
            t = seconds(lambda: torch.linalg.svd(B, full_matrices=False, **kw), on_card)
        except torch.linalg.LinAlgError as e:
            report(op="beam svd", shape=list(B.shape), routine=routine, failed=str(e)[:300])
            continue
        U, s, Vh = torch.linalg.svd(B, full_matrices=False, **kw)
        rec = ((U * s[..., None, :].to(U.dtype)) @ Vh - B).abs().amax(dim=(-1, -2)) / B.abs().amax(dim=(-1, -2)).clamp(min=1e-30)
        s_err = (s.double() - s_ref).abs().amax(dim=-1) / s_ref.amax(dim=-1)
        kept = (s > 1e-6 * s.amax(dim=-1, keepdim=True)).sum(dim=-1)
        kept_ref = (s_ref > 1e-6 * s_ref.amax(dim=-1, keepdim=True)).sum(dim=-1)
        report(op="beam svd", shape=list(B.shape), routine=routine or "default", seconds=t, per_matrix_ms=1e3 * t / B.shape[0],
               reconstruction_err_max=rec.max().item(), sv_err_vs_complex128_max=s_err.max().item(),
               kept_modes_differ_max=int((kept - kept_ref).abs().max()))
    del B, U, s, Vh, s_ref

    bt._ensure_svd()
    ref_m = [1, len(msel) // 3, 2 * len(msel) // 3, len(msel) - 1]
    fg_threshold = None  # DoubleKL's: the median complex128 eigenvalue of KLTransform, so that half the modes go
    for cls_name in ("KLTransform", "DoubleKL"):
        # the reference: scipy's generalised solver on the host, on the complex128 pencil
        params = {} if cls_name == "KLTransform" else {"foreground_threshold": fg_threshold}
        kl = getattr(klmod, cls_name).from_config({"subset": False, **params}, bt)
        S, F, Nt = kl._pencil(0, len(msel))
        N = klmod._regularise(F + Nt)
        ref = {}
        if cls_name == "KLTransform":
            for i in ref_m:
                ref[i] = np.sort(sla.eigh(S[i].cpu().numpy(), N[i].cpu().numpy(), eigvals_only=True))[::-1]
        for dtype in (torch.complex64, torch.complex128):
            kl._solve_dtype = dtype
            row = dict(op=cls_name, dtype=str(dtype).split(".")[-1], m=msel, n=kl._size[1])
            try:
                S, F, Nt = kl._pencil(0, len(msel))
                t0 = time.perf_counter()
                evals, fwd, bwd = kl._solve_chunk(S, F, Nt)
                if on_card:
                    torch.cuda.synchronize()
                row["seconds"] = time.perf_counter() - t0
            except torch.linalg.LinAlgError as e:
                report(**row, failed=str(e)[:300])
                continue
            evals = evals.real.double()
            # DoubleKL: the modes stage 1 rejected carry eigenvalue ~0 and are no part of the round trip
            kept = [int((e > 1e-9 * e.max()).sum()) if cls_name == "DoubleKL" else len(e) for e in evals]
            row["round_trip_max"] = max(
                (fwd[i, :k] @ bwd[i, :, :k] - torch.eye(k, dtype=fwd.dtype, device=device)).abs().max().item()
                for i, k in enumerate(kept) if k)
            row["kept"] = kept
            if cls_name == "KLTransform":
                N = klmod._regularise(F + Nt)
                cov = fwd @ (S + N) @ fwd.mH
                want = torch.diag_embed(evals + 1.0)
                row["diagonalisation_max"] = ((cov - want).abs().amax(dim=(-1, -2)) / want.abs().amax(dim=(-1, -2))).max().item()
                row["evals_vs_scipy_max"] = max(
                    float(np.abs(evals[i].cpu().numpy() - ref[i]).max() / ref[i].max()) for i in ref_m)
                row["kept_above_1_differ_max"] = max(
                    abs(int((evals[i] > 1.0).sum()) - int((ref[i] > 1.0).sum())) for i in ref_m)
            if dtype == torch.complex128:
                if fg_threshold is None:
                    fg_threshold = float(evals.median())
                    row["median_eigenvalue"] = fg_threshold
                q = torch.tensor([0.0, 0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=device)
                row["eval_quantiles_by_m"] = {str(msel[i]): torch.quantile(evals[i], q).tolist() for i in range(0, len(msel), 3)}
                row["modes_above"] = {str(thr): (evals > thr).sum(dim=-1).tolist() for thr in (0.1, 1.0, 10.0, 100.0)}
            report(**row)
    return finish(json_path, on_card, rows)


def delay_rates(device, on_card: bool, k: int, json_path) -> int:
    """The ``--delay`` mode (see the module docstring)."""
    import numpy as np
    import torch

    from draco_tpu_torch.analysis.delayopt import likelihood_core
    from draco_tpu_torch.ops import delay as dops
    from draco_tpu_torch.ops import filters

    rows = []

    def report(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    nd, nrow, nsamp = 2048 // k, 2032 // k, 240 // k
    gen = torch.Generator(device=device).manual_seed(0)
    Ft = torch.randn(nd, nrow, generator=gen, device=device) / nrow**0.5
    for B in (1, 8, 16, 32, 128):
        Nih = torch.rand(B, nrow, generator=gen, device=device) + 0.5
        A = (Ft[None] * (Nih**2)[:, None, :]) @ Ft.T + torch.eye(nd, device=device)
        rhs = torch.randn(B, nd, nsamp, generator=gen, device=device)
        L = torch.linalg.cholesky_ex(A)[0]
        if B == 8:
            ref = (A, rhs, L, torch.cholesky_solve(rhs, L), A @ rhs)
        elif B > 8:
            A[:8], rhs[:8] = ref[0], ref[1]
            L = torch.linalg.cholesky_ex(A)[0]
        same = {}
        if B > 8:
            same = dict(cholesky_bit_identical_to_B8=bool(torch.equal(L[:8], ref[2])),
                        solve_bit_identical_to_B8=bool(torch.equal(torch.cholesky_solve(rhs, L)[:8], ref[3])),
                        matmul_bit_identical_to_B8=bool(torch.equal((A @ rhs)[:8], ref[4])))
        for name, fn in (("cholesky_ex", lambda: torch.linalg.cholesky_ex(A)),
                         ("cholesky_solve", lambda: torch.cholesky_solve(rhs, L)),
                         ("bmm", lambda: A @ rhs),
                         ("design", lambda: (Ft[None] * (Nih**2)[:, None, :]) @ Ft.T)):
            t = seconds(fn, on_card)
            report(op=name, shape=[B, nd, nd], rhs=nsamp, dtype="float32", seconds=t, per_matrix_ms=1e3 * t / B, **same)
            same = {}
        del A, rhs, L
    for B in (8, 16, 32):
        Nih = torch.rand(B, nrow, generator=gen, device=device) + 0.5
        dw, A = dops.gibbs_batch_design(torch.randn(B, nsamp, nrow // 2, dtype=torch.complex64, generator=gen, device=device),
                                        Ft, None, Nih)
        S = torch.full((B, nd), 1e-2, device=device)
        gens = [torch.Generator(device=device).manual_seed(i) for i in range(B)]
        half = torch.full((nd,), nsamp / 2.0, device=device)

        def step():
            w1 = torch.empty((B, nsamp, nd), device=device)
            w2 = torch.empty((B, nsamp, nrow), device=device)
            chi2 = torch.empty((B, nd), device=device)
            for j, g in enumerate(gens):
                w1[j].normal_(generator=g)
                w2[j].normal_(generator=g)
                chi2[j] = 2.0 * torch._standard_gamma(half, generator=g)
            return dops.gibbs_step(A, Ft, Nih, dw, S, w1, w2, chi2)

        t = seconds(step, on_card)
        report(op="gibbs_step", batch=B, nd=nd, nrow=nrow, nsamp=nsamp, seconds=t, per_baseline_ms=1e3 * t / B)
        del dw, A
    n = 4096 // k
    X = torch.randn(16, n, n, dtype=torch.complex64, generator=gen, device=device)
    H = X @ X.mH / n + torch.eye(n, dtype=torch.complex64, device=device)
    del X
    t = seconds(lambda: torch.linalg.cholesky_ex(H), on_card)
    report(op="cholesky_ex", shape=[16, n, n], dtype="complex64", seconds=t, per_matrix_ms=1e3 * t / 16)
    del H
    freq = np.linspace(400.0, 800.0, 1024 // k, endpoint=False)
    for modes in (160, 410, 680):
        m = max(modes // k, 2)
        cut = m / (4 * np.ptp(freq))
        t = seconds(lambda: filters.null_filter(freq, cut, np.ones(freq.size), num_modes=m, window=False, device=device), on_card)
        report(op="null_filter", shape=[freq.size, m], dtype="complex128", routine="gesvd" if on_card else "default", seconds=t)
    nchan = 1016 // k
    MF = torch.randn(nchan, nd, dtype=torch.complex128, generator=gen, device=device)
    X = torch.randn(nchan, nchan, dtype=torch.complex128, generator=gen, device=device)
    X = X @ X.mH / nchan
    s = torch.rand(nd, dtype=torch.float64, generator=gen, device=device) + 0.1
    N = torch.ones(nchan, dtype=torch.float64, device=device)
    t = seconds(lambda: likelihood_core(MF, N, X, s), on_card)
    report(op="likelihood_core", shape=[nchan, nd], dtype="complex128", seconds=t)
    return finish(json_path, on_card, rows)


def filter_rates(device, on_card: bool, k: int, json_path) -> int:
    """The ``--filters`` mode (see the module docstring)."""
    import numpy as np
    import torch

    from draco_tpu_torch.analysis.wavelet import wiener_infill
    from draco_tpu_torch.ops import dayenu, dpss

    rows = []

    def report(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    nfreq = 1024 // k
    freq = np.linspace(400.0, 800.0, nfreq, endpoint=False)
    cuts = np.linspace(0.2, 0.42, 32)
    covs = torch.stack([torch.as_tensor(dayenu.delay_covariance(freq, c, 0.0, 1e-12)) for c in cuts]).to(device)
    for B in (1, 8, 32):
        t = seconds(lambda: torch.linalg.eigh(covs[:B]), on_card)
        report(op="eigh", shape=[B, nfreq, nfreq], dtype="float64", seconds=t, per_matrix=t / B)
    t = seconds(lambda: dayenu.hermitian_pinv_batched(covs), on_card)
    report(op="hermitian_pinv_batched", shape=list(covs.shape), dtype="float64", seconds=t, per_matrix=t / 32)
    del covs

    nra = 4096 // k
    ra = np.linspace(0, 2 * np.pi, nra, endpoint=False)
    dra = torch.as_tensor(ra[:, None] - ra[None, :], device=device)
    pair = torch.stack([torch.eye(nra, dtype=torch.float64, device=device) * 1e10 + torch.sinc(80.0 * dra / np.pi)
                        for _ in range(2)])
    t = seconds(lambda: torch.linalg.eigh(pair), on_card)
    report(op="eigh", shape=list(pair.shape), dtype="float64", seconds=t, per_matrix=t / 2)
    del pair, dra

    gen = torch.Generator(device=device).manual_seed(1)
    tau = torch.as_tensor(np.fft.fftshift(np.fft.fftfreq(nfreq, freq[1] - freq[0])), device=device)
    arg = -2.0 * np.pi * torch.as_tensor(freq, device=device)[:, None] * tau[None, :]
    F = torch.polar(torch.ones_like(arg), arg)
    for B in (1, 16, 64):
        d = torch.randn(B, 64, nfreq, dtype=torch.complex64, generator=gen, device=device)
        Ni = torch.rand(B, nfreq, generator=gen, device=device) + 0.5
        D = torch.rand(B, nfreq, dtype=torch.float64, generator=gen, device=device) + 1e-3
        t = seconds(lambda: wiener_infill(d, Ni, D, F), on_card)
        report(op="wiener_infill", shape=[B, nfreq, nfreq], dtype="complex128", seconds=t, per_baseline=t / B)

    samples = np.linspace(0.0, 360.0, nra, endpoint=False)
    mcuts = [0.3, 1.17, 2.34, 3.51]
    mcovs = [dpss.make_covariance(samples, c, 0.0, device=device) for c in mcuts]
    t = seconds(lambda: dpss.get_bases(mcovs), on_card)
    bases = dpss.get_bases(mcovs)
    report(op="dpss.get_bases", shape=[len(mcuts), nra, nra], dtype="float64", seconds=t,
           nmodes=[int(b.shape[1]) for b in bases])
    A = bases[-1].to(torch.complex64)
    Ni = (torch.rand(16, nra, generator=gen, device=device) > 0.01).to(torch.complex64)
    K = (A.conj().T[None] * Ni[:, None, :]) @ A + 1e-3 * torch.eye(A.shape[1], dtype=A.dtype, device=device)
    t = seconds(lambda: torch.linalg.cholesky_ex(K), on_card)
    report(op="cholesky_ex", shape=list(K.shape), dtype="complex64", seconds=t, per_matrix=t / 16)
    return finish(json_path, on_card, rows)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--scale", type=int, default=1)
    parser.add_argument("--kl", action="store_true", help="the KL solve in complex64 against complex128")
    parser.add_argument("--delay", action="store_true", help="the delay-spectrum path's calls")
    parser.add_argument("--filters", action="store_true", help="the DAYENU, DPSS and wavelet path's factorisations")
    parser.add_argument("--nside", type=int, default=256)
    parser.add_argument("--nfeed", type=int, default=64)
    parser.add_argument("--json", default=None, help="also write the rows to this file")
    args = parser.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_linalg_rates: no CUDA device is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import draco_tpu_torch  # noqa: F401  (sets the float32 matmul policy)
    from draco_tpu_torch.ops.tools import SVD_ROUTINE_KEYWORD

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if args.kl:
        return kl_precision(device, on_card, args.nside, args.nfeed, args.json)
    k = args.scale
    if args.delay:
        return delay_rates(device, on_card, k, args.json)
    if args.filters:
        return filter_rates(device, on_card, k, args.json)
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randc(*shape, dtype=torch.complex128):
        return torch.randn(*shape, dtype=dtype, generator=gen).to(device)

    rows = []

    def report(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    # the beam matrix's shape, columns decaying over eight decades as the
    # beam transfer's spectrum does
    batch, ntel, nsky = max(SVD_BATCH // k, 2), NTEL // k, NSKY // k
    decay = torch.logspace(0, -8, nsky, dtype=torch.float64, device=device)
    A128 = randc(batch, ntel, nsky) * decay
    A64 = A128.to(torch.complex64)
    s_ref = torch.linalg.svdvals(A128)
    for routine in ((None, "gesvdj", "gesvda", "gesvd") if on_card else (None,)):
        kw = {} if routine is None else {SVD_ROUTINE_KEYWORD: routine}
        t = seconds(lambda: torch.linalg.svd(A64, full_matrices=False, **kw), on_card)
        U, s, Vh = torch.linalg.svd(A64, full_matrices=False, **kw)
        s_err = ((s.double() - s_ref).abs().max() / s_ref.max()).item()
        rec = ((U * s[..., None, :].to(U.dtype)) @ Vh - A64).abs().max().item() / A64.abs().max().item()
        report(op="svd", shape=[batch, ntel, nsky], dtype="complex64", routine=routine or "default", seconds=t,
               per_matrix_ms=1e3 * t / batch, sv_err_vs_complex128=s_err, reconstruction_err=rec)
    t = seconds(lambda: torch.linalg.svd(A128[: max(batch // 4, 1)], full_matrices=False), on_card)
    report(op="svd", shape=[max(batch // 4, 1), ntel, nsky], dtype="complex128", routine="default", seconds=t,
           per_matrix_ms=1e3 * t / max(batch // 4, 1))
    del A128, A64, U, s, Vh

    M, F, B2 = FILTER_SHAPE[0] // k, FILTER_SHAPE[1], FILTER_SHAPE[2] // k
    for dtype in (torch.complex64, torch.complex128):
        X = randc(M, F, B2).to(dtype)
        t = seconds(lambda: torch.linalg.svd(X, full_matrices=False), on_card)
        report(op="svd", shape=[M, F, B2], dtype=str(dtype).split(".")[-1], routine="default", seconds=t,
               per_matrix_ms=1e3 * t / M)
    del X

    for n in PENCIL_N:
        n = n // k
        X = randc(PENCIL_BATCH, n, n)
        H128 = X @ X.mH / n + torch.eye(n, dtype=torch.complex128, device=device)
        del X
        for dtype in (torch.complex64, torch.complex128):
            H = H128.to(dtype)
            L = torch.linalg.cholesky(H)
            ops = {
                "eigh": lambda: torch.linalg.eigh(H),
                "cholesky_ex": lambda: torch.linalg.cholesky_ex(H),
                "inv_ex": lambda: torch.linalg.inv_ex(H),
                "solve_triangular": lambda: torch.linalg.solve_triangular(L, H, upper=False),
                "matmul": lambda: H @ H,
            }
            for name, fn in ops.items():
                t = seconds(fn, on_card)
                report(op=name, shape=[PENCIL_BATCH, n, n], dtype=str(dtype).split(".")[-1], seconds=t,
                       per_matrix_ms=1e3 * t / PENCIL_BATCH)
            del H, L
        del H128

    return finish(args.json, on_card, rows)


if __name__ == "__main__":
    sys.exit(main())
