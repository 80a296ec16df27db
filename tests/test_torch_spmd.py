"""The spine split over a process mesh equals the unsplit run.

The JAX package's contract (``tests/test_spmd.py``): results must not
depend on the mesh.  Here ranks are spawned ``gloo`` processes on the CPU
(``tests/test_torch_multihost.py::run_ranks``, a file store under
``tmp_path``, a deadline per launch), running the pipeline Manager under
``pipeline.mesh``.  Each is held:

- bit-equal to the port's one-process run of the same config with no mesh:
  the spine's tasks are frequency-local (each rank runs its own channels,
  and the SHTs go channel by channel, so a channel's bits do not depend on
  its neighbours) or take the gathered whole; nothing is summed across
  ranks;
- within the task parity tolerance of ``tests/test_torch_tasks.py`` (2e-5
  of the peak; float32) of the JAX package's single-process run, which its
  own tests prove equal to its sharded runs;
- the quadratic estimator on an ``m`` mesh, whose sums over m do cross
  ranks, within 1e-12 of one rank (float64 sums in another order).
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from draco_tpu.analysis.mapmaker import DirtyMapMaker as JDirtyMapMaker
from draco_tpu.analysis.transform import MModeTransform as JMModeTransform
from draco_tpu.core import containers as jcontainers
from draco_tpu.synthesis.stream import SimulateSidereal as JSimulateSidereal
from draco_tpu.telescope import BeamTransfer as JBeamTransfer
from draco_tpu.telescope import UnpolarisedDishArray as JDishArray
from draco_tpu_torch.core.pipeline import Manager
from draco_tpu_torch.device import default_device
from draco_tpu_torch.parallel import mesh as pmesh
from draco_tpu_torch.telescope import UnpolarisedDishArray
from tests.test_torch_multihost import run_ranks

# tests/test_spmd.py's telescope: 8 channels divide over 2 and 4 ranks
TEL = dict(grid_ew=2, grid_ns=2, spacing_ew=5.0, spacing_ns=5.0, latitude=40.0, freq_lower=400.0,
           freq_upper=440.0, num_freq=8, dish_width=5.0, auto_correlations=True, force_lmax=23, force_mmax=23)
NSIDE = 16  # the beam transfer's nside for lmax 23, in both packages
SEED = 3
TOL = 2e-5  # tests/test_torch_tasks.py's task parity tolerance
LABELS = ("sstream", "srebin", "mmodes", "dmap")


def spine_config(product_dir: str, mesh: dict | None) -> dict:
    freq = [float(f) for f in UnpolarisedDishArray(**TEL).frequencies]
    pipeline = {"tasks": [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "bt"],
         "params": {"product_directory": product_dir, "nside": NSIDE}},
        {"type": "tests.test_torch_multihost.EmitMap", "out": "sky",
         "params": {"seed": SEED, "nside": NSIDE, "freq": freq}},
        {"type": "draco.synthesis.stream.SimulateSidereal", "requires": "bt", "in": "sky", "out": "sstream"},
        {"type": "draco.analysis.transform.FrequencyRebin", "in": "sstream", "out": "srebin",
         "params": {"channel_bin": 2}},
        {"type": "draco.analysis.transform.MModeTransform", "requires": "tel", "in": "sstream", "out": "mmodes"},
        {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "bt", "in": "mmodes", "out": "dmap",
         "params": {"nside": NSIDE}},
    ]}
    if mesh:
        pipeline["mesh"] = mesh
    return {"pipeline": pipeline}


def _gathered(products) -> dict:
    """{label: {dataset: numpy}} of the spine's products, gathered (a
    collective: every rank calls it)."""
    return {lab: {name: pmesh.unshard(ds._data).numpy() for name, ds in products[lab][0].datasets.items()}
            for lab in LABELS}


def _spine_on_ranks(rank, n, product_dir, mesh):
    from draco_tpu_torch.parallel import validate
    from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

    products = Manager(spine_config(product_dir, mesh)).run()
    out = {"placed": {lab: repr(products[lab][0].vis[:].placements) for lab in ("sstream", "mmodes")},
           "products": _gathered(products)}
    # assert_sharding_invariant with the mesh's placements: the fused round
    # trip of a frequency-split sky within float32's 1e-5 (it batches the
    # channels of a slab in its GEMMs, so a channel's bits follow the slab);
    # a program whose answer is the rank's own block is caught
    bt = products["bt"][0]
    sky = pmesh.unshard(products["sky"][0].map[:]).float()
    mesh_obj = pmesh.make_mesh(axis_name="freq")
    split = validate.mesh_placement(mesh_obj, ("freq", "pol", "pix"))
    validate.assert_sharding_invariant(lambda s: fused_simulate_to_map(bt, s, chunk=4), [sky],
                                       [lambda x: x, split], rtol=1e-5, label="fused round trip")
    try:
        validate.assert_sharding_invariant(lambda s: pmesh.local(s).sum(), [sky], [lambda x: x, split],
                                           rtol=0.0, label="a rank's block")
        out["block_caught"] = False
    except validate.DeterminismError:
        out["block_caught"] = True
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def spine(tmp_path_factory):
    """The product directory, the one-process run with no mesh, and the JAX
    package's single-process run of the same sky."""
    tmp = tmp_path_factory.mktemp("spine")
    with default_device("cpu"):
        tel = UnpolarisedDishArray(**TEL)
        with open(tmp / "telescope.pkl", "wb") as f:
            pickle.dump(tel, f)
        one = _gathered(Manager(spine_config(str(tmp), None)).run())

    jtel = JDishArray(**TEL)
    jbt = JBeamTransfer(telescope=jtel).generate()
    assert jbt.beam_nside == NSIDE
    jm = jcontainers.Map(nside=NSIDE, polarisation=False, freq=jtel.frequencies)
    jm.map[:] = np.random.Generator(np.random.SFC64(SEED)).standard_normal(jm.map.shape)
    jout = {}
    for label, task, params, setup, src in (
        ("sstream", JSimulateSidereal(), {}, (jbt,), jm),
        ("mmodes", JMModeTransform(), {}, (), None),
        ("dmap", JDirtyMapMaker(), {"nside": NSIDE}, (jbt,), None),
    ):
        task.read_config(params)
        task.setup(*setup)
        jout[label] = task.process(src if src is not None else jout[{"mmodes": "sstream", "dmap": "mmodes"}[label]])
    jax_ref = {"sstream": np.asarray(jout["sstream"].vis[:]), "mmodes": np.asarray(jout["mmodes"].vis[:]),
               "dmap": np.asarray(jout["dmap"].map[:])}
    return tmp, one, jax_ref


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _check(run, one, jax_ref):
    for lab in LABELS:
        assert set(run[lab]) == set(one[lab]), lab
        for name in one[lab]:
            assert np.array_equal(run[lab][name], one[lab][name]), (lab, name)
    for lab, name in (("sstream", "vis"), ("mmodes", "vis"), ("dmap", "map")):
        assert _rel(run[lab][name], jax_ref[lab]) <= TOL, lab


def test_the_one_process_spine_matches_jax(spine):
    _, one, jax_ref = spine
    for lab, name in (("sstream", "vis"), ("mmodes", "vis"), ("dmap", "map")):
        assert _rel(one[lab][name], jax_ref[lab]) <= TOL, lab


def test_spine_on_a_two_rank_freq_mesh(spine, tmp_path):
    tmp, one, jax_ref = spine
    res = run_ranks(_spine_on_ranks, 2, tmp_path, str(tmp), {"freq": -1})[0]
    # the stream and the m-modes are split over the frequency dimension
    assert res["placed"] == {"sstream": "(Shard(dim=0),)", "mmodes": "(Shard(dim=2),)"}
    _check(res["products"], one, jax_ref)
    assert res["block_caught"]


def test_spine_on_a_two_by_two_freq_m_mesh(spine, tmp_path):
    tmp, one, jax_ref = spine
    res = run_ranks(_spine_on_ranks, 4, tmp_path, str(tmp), {"freq": 2, "m": 2})[0]
    # the m-modes are split over both dimensions (m 24 and freq 8 divide by 2)
    assert res["placed"] == {"sstream": "(Shard(dim=0), Replicate())", "mmodes": "(Shard(dim=2), Shard(dim=0))"}
    _check(res["products"], one, jax_ref)


# -- the quadratic estimator on an m mesh -------------------------------------------

PS_TEL = dict(grid_ew=2, grid_ns=2, spacing_ew=6.0, spacing_ns=6.0, latitude=45.0, freq_lower=400.0,
              freq_upper=440.0, num_freq=4, dish_width=6.0, auto_correlations=True, force_lmax=15, force_mmax=15)
BANDS = {"bands_kpar": [0.0, 0.5, 1.0], "bands_kperp": [0.0, 0.5], "m_chunk": 4}


def _estimates(mesh):
    """(q, Fisher, bias) of seeded KL vectors under ``mesh`` (None: unsplit)."""
    from draco_tpu_torch.telescope import BeamTransfer, kltransform
    from draco_tpu_torch.telescope.psestimation import PSEstimation

    bt = BeamTransfer(UnpolarisedDishArray(**PS_TEL)).generate(device="cpu")
    kl = kltransform.KLTransform.from_config({"threshold": 0.0, "subset": False}, bt)
    ps = PSEstimation.from_config(BANDS, bt, kl)
    rng = np.random.Generator(np.random.SFC64(11))
    x = torch.as_tensor(rng.standard_normal((16, 12)) + 1j * rng.standard_normal((16, 12)))
    with pmesh.use_mesh(mesh):
        ps.genbands()
        q = ps.q_estimator_all(x, None)
        fisher, bias = ps.fisher_bias()
    return q.numpy(), fisher.numpy(), bias.numpy()


def _estimates_on_ranks(rank, n):
    mesh = pmesh.make_mesh(axis_name="m")
    return _estimates(mesh)


def test_quadratic_estimator_on_an_m_mesh(tmp_path):
    with default_device("cpu"):
        ref = _estimates(None)
    for got in run_ranks(_estimates_on_ranks, 2, tmp_path):
        for a, b in zip(got, ref):
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
    assert np.abs(ref[1]).max() > 0
