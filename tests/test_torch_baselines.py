"""The telescope's unique-baseline table, vectorised, against the JAX package's loop.

``draco_tpu_torch.telescope.core._compute_baselines`` finds the unique
baselines of every feed pair with numpy; the JAX package walks the 2.1M
pairs of a 2048-feed telescope in a Python loop.  The table (feed map,
conjugation, mask, unique pairs in first-seen order, baselines,
redundancy) must be the same, to the element.
"""

import numpy as np
import pytest

from draco_tpu import telescope as jtel
from draco_tpu_torch import telescope as ttel

CYL = dict(cylinder_width=20.0, cylinder_spacing=22.0, feed_spacing=0.5, latitude=49.0, num_freq=2,
           freq_lower=400.0, freq_upper=500.0)

CASES = {
    "jittered dishes": ("UnpolarisedDishArray", dict(
        grid_ew=8, grid_ns=8, spacing_ew=7.0, spacing_ns=7.0, jitter=1.0, jitter_seed=1, latitude=45.0,
        dish_width=5.0, num_freq=1, freq_lower=500.0, freq_upper=500.0, auto_correlations=True)),
    "dual-pol cylinder": ("PolarisedCylinderTelescope", dict(
        num_cylinders=2, num_feeds=16, auto_correlations=True, **CYL)),
    "cylinder cut by length, no autos": ("UnpolarisedCylinderTelescope", dict(
        num_cylinders=3, num_feeds=8, auto_correlations=False, minlength=1.0, maxlength=30.0, **CYL)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_baseline_table_matches_the_jax_loop(case):
    cls, kw = CASES[case]
    got = getattr(ttel, cls)(**kw)._compute_baselines()
    want = getattr(jtel, cls)(**kw)._compute_baselines()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=f"{case}: {key}")
        assert got[key].dtype.kind == np.asarray(want[key]).dtype.kind, key
    if "no autos" in case:
        # the cut removes pairs (and both mirror entries of the mask)
        assert not got["feedmask"].all() and (got["feedmap"][~got["feedmask"]] == -1).all()
