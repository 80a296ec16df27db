"""The beamform kernel's row plan, on the CPU.

``ops/cuda_kernels.py::beamform_plan`` inverts a batch of RA windows into
the rows' pair lists and cuts them into work items, as the CUDA kernel
takes them.  Held against numpy: every (s, h) pair once, under its own row,
rows in order, no item above its size, a row hit by more pairs split.  A
plain torch evaluation of F, W and Q that walks the plan item by item, as
a block of the kernel does (x = sw vis and the row's W and Q formed once),
equals ``beamform_sums_plain`` to 1e-12 in float64 (the same terms summed
in another order).
"""

import math

import numpy as np
import pytest
import torch

from draco_tpu_torch.ops import cuda_kernels, interferometry
from draco_tpu_torch.ops.tools import invert_no_zero

K = cuda_kernels.BEAMFORM_ITEM_PAIRS


def _ra_idx(seed, S, nha, nra, pad=0, pile=0):
    """Windows of S sources over nra samples (wrapping), the last ``pad``
    slots of every window padded at index 0, the first ``pile`` sources all
    on one window."""
    rng = np.random.Generator(np.random.SFC64(seed))
    start = rng.integers(0, nra, S)
    start[:pile] = start[0]
    ra_idx = ((start[:, None] + np.arange(nha)) % nra).astype(np.int32)
    if pad:
        ra_idx[:, nha - pad :] = 0
    return ra_idx


CASES = {
    "one-source": dict(S=1, nha=9, nra=9),
    "wrap": dict(S=5, nha=11, nra=50),
    "shared-rows": dict(S=512, nha=11, nra=64),
    "padded-above-K": dict(S=64, nha=11, nra=40, pad=5),
    "piled-above-K": dict(S=300, nha=3, nra=1000, pile=300),
    "window-longer-than-day": dict(S=3, nha=85, nra=16),
}


@pytest.mark.parametrize("max_pairs", [K, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_beamform_plan_matches_numpy(case, max_pairs):
    ra_idx = _ra_idx(3, **CASES[case])
    nra = CASES[case]["nra"]
    plan = cuda_kernels.beamform_plan(torch.from_numpy(ra_idx), nra, max_pairs)
    assert all(x.dtype == torch.int32 for x in plan)
    pairs, row, start, count = (x.numpy().astype(np.int64) for x in plan)
    r = ra_idx.reshape(-1)
    # every pair once, in numpy's stable order by row
    np.testing.assert_array_equal(pairs, np.argsort(r, kind="stable"))
    np.testing.assert_array_equal(np.sort(pairs), np.arange(r.size))
    # items tile the sorted pairs in order, rows ascending, 1..max_pairs each
    assert np.all(np.diff(row) >= 0)
    np.testing.assert_array_equal(start, np.concatenate([[0], np.cumsum(count)[:-1]]))
    assert count.sum() == r.size and count.min() >= 1 and count.max() <= max_pairs
    for i in range(len(row)):
        assert np.all(r[pairs[start[i] : start[i] + count[i]]] == row[i])
    # a row hit by c pairs is ceil(c / max_pairs) items
    hits = np.bincount(r, minlength=nra)
    np.testing.assert_array_equal(np.bincount(row, minlength=nra), -(-hits // max_pairs))
    if case.endswith("above-K"):
        assert hits.max() > K and np.bincount(row).max() > 1


@pytest.mark.parametrize("bad", [-1, 40])
def test_beamform_plan_refuses_an_index_outside_the_day(bad):
    ra_idx = torch.from_numpy(_ra_idx(3, **CASES["wrap"]))
    ra_idx[2, 4] = bad
    with pytest.raises(IndexError):
        cuda_kernels.beamform_plan(ra_idx, 40)


def test_beamform_plan_of_no_pairs():
    plan = cuda_kernels.beamform_plan(torch.zeros((0, 5), dtype=torch.int32), 10)
    assert all(len(x) == 0 for x in plan)


def planned_sums(vis, sw, vw, ra_idx, a, b, u, v, natural, max_pairs=K):
    """F, W, Q through the row plan, item by item as the kernel's blocks take them."""
    nfreq, nra, _ = vis.shape
    S, nha = ra_idx.shape
    plan = cuda_kernels.beamform_plan(ra_idx, nra, max_pairs)
    F = torch.zeros(nfreq, S * nha, dtype=sw.dtype)
    W = torch.zeros_like(F)
    Q = torch.zeros_like(F) if natural else None
    af, bf = a.reshape(-1), b.reshape(-1)
    for r, i0, n in zip(*(x.tolist() for x in plan[1:])):
        j = plan.pairs[i0 : i0 + n].long()
        x = sw[:, r] * vis[:, r]  # [f, p]: sw folded into vis, once a row
        d = u[:, None, :] * af[j][None, :, None] + v[:, None, :] * bf[j][None, :, None]  # [f, pairs, p]
        ang = 2 * math.pi * (d - torch.round(d))
        F[:, j] = (x.real[:, None] * torch.cos(ang) + x.imag[:, None] * torch.sin(ang)).sum(-1)
        W[:, j] = sw[:, r].sum(-1)[:, None]
        if natural:
            Q[:, j] = (sw[:, r] ** 2 * invert_no_zero(vw[:, r])).sum(-1)[:, None]
    shape = (nfreq, S, nha)
    return F.reshape(shape), W.reshape(shape), None if Q is None else Q.reshape(shape)


@pytest.mark.parametrize("natural", [True, False])
@pytest.mark.parametrize("case", ["wrap", "padded-above-K", "window-longer-than-day"])
def test_planned_sums_match_plain_in_float64(case, natural):
    spec = CASES[case]
    nfreq, nprod = 2, 33
    rng = np.random.Generator(np.random.SFC64(11))
    shape = (nfreq, spec["nra"], nprod)
    vis = torch.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    sw = torch.from_numpy(rng.uniform(0.5, 2.0, shape))
    sw[0, 3] = 0.0
    sw[:, :, 5] = 0.0
    vw = torch.from_numpy(rng.uniform(0.5, 2.0, shape))
    vw[1, 0, :4] = 0.0
    ra_idx = torch.from_numpy(_ra_idx(5, **spec))
    a = torch.from_numpy(rng.uniform(-0.1, 0.1, ra_idx.shape))
    b = torch.from_numpy(rng.uniform(0.2, 0.9, ra_idx.shape))
    u = torch.from_numpy(rng.uniform(-130, 130, (nfreq, nprod)))
    v = torch.from_numpy(rng.uniform(-260, 260, (nfreq, nprod)))
    args = (vis, sw, vw if natural else None, ra_idx, a, b, u, v, natural)
    ref = interferometry.beamform_sums_plain(*args)
    for max_pairs in (K, 4):
        got = planned_sums(*args, max_pairs=max_pairs)
        for g, r in zip(got, ref):
            if r is None:
                assert g is None
                continue
            assert ((g - r).abs().max() / r.abs().max()).item() <= 1e-12
