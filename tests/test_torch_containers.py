"""The port's containers: the cases of ``tests/test_containers.py`` on
draco_tpu_torch, its tensor storage, and HDF5 files against draco_tpu.

Files written by either package read in the other equal to the last bit;
``truncate`` rounds bit for bit as draco_tpu's does.  The port's containers
live on the CPU here.
"""

import h5py
import numpy as np
import pytest
import torch

from draco_tpu.core import containers as jcontainers
from draco_tpu.core import truncate as jtruncate
from draco_tpu_torch.core import containers, truncate
from draco_tpu_torch.device import default_device


@pytest.fixture(autouse=True)
def on_cpu():
    with default_device("cpu"):
        yield


def make_stream(nfreq=4, nfeed=4, nra=16, package=containers):
    freq = np.linspace(800.0, 750.0, nfreq)
    ss = package.SiderealStream(freq=freq, input=nfeed, ra=nra)
    nstack = len(ss.index_map["stack"])
    ss.vis[:] = np.arange(nfreq * nstack * nra, dtype=np.float32).reshape(nfreq, nstack, nra)
    ss.weight[:] = 1.0
    return ss


def test_basic_shapes():
    ss = make_stream()
    nprod = 4 * 5 // 2
    assert ss.vis.shape == (4, nprod, 16)
    assert ss.weight.shape == (4, nprod, 16)
    assert ss.vis.dtype == torch.complex64
    assert ss.weight.dtype == torch.float32
    assert isinstance(ss.vis[:], torch.Tensor) and ss.vis[:].device.type == "cpu"
    assert list(ss.vis.axes) == ["freq", "stack", "ra"]
    assert len(ss.input) == 4
    assert not ss.is_stacked


@pytest.mark.parametrize(
    "np_dtype,torch_dtype",
    [
        (np.float32, torch.float32), (np.float64, torch.float64), (np.complex64, torch.complex64),
        (np.complex128, torch.complex128), (np.int32, torch.int32), (np.int64, torch.int64),
        (np.uint8, torch.uint8), (np.uint16, torch.uint16), (">f4", torch.float32),
        (bool, None), ("<U8", None), ([("a", np.float64), ("b", np.int32)], None),
    ],
)
def test_dtype_map(np_dtype, torch_dtype):
    assert containers.torch_dtype(np_dtype) == torch_dtype


def test_numeric_datasets_are_tensors_and_the_rest_numpy():
    mask = containers.RFIMask(freq=np.array([400.0, 500.0]), time=np.arange(3))
    assert isinstance(mask.datasets["mask"][:], np.ndarray) and mask.datasets["mask"].dtype == np.bool_
    cat = containers.SpectroscopicCatalog(object_id=np.arange(5))
    assert isinstance(cat["position"][:], np.ndarray) and cat["position"][:].dtype.names == ("ra", "dec")
    ss = make_stream()
    assert containers.torch_dtype(ss.dataset_spec()["nsample"]["dtype"]) == ss.add_dataset("nsample").dtype


def test_setitem_moves_casts_and_writes_in_place():
    ss = make_stream()
    view = ss.vis[:]
    ss.vis[0, 0] = np.full(16, 5.0 + 1.0j)  # host complex128 -> complex64 in place
    ss.vis[1] = torch.ones(10, 16, dtype=torch.float64)
    assert view[0, 0, 3] == 5.0 + 1.0j and view.dtype == torch.complex64
    assert (view[1] == 1).all()
    host = np.asarray(ss.vis)
    assert isinstance(host, np.ndarray) and host.dtype == np.complex64 and host[0, 0, 0] == 5.0 + 1.0j
    with pytest.raises(ValueError, match="shape"):
        ss.vis.data = torch.zeros(3)


def test_axes_from_and_attrs_from():
    ss = make_stream()
    ss.attrs["tag"] = "orig"
    new = containers.SiderealStream(axes_from=ss, attrs_from=ss)
    assert np.array_equal(new.freq, ss.freq)
    assert np.array_equal(new.ra, ss.ra)
    assert new.attrs["tag"] == "orig"
    assert new.vis.shape == ss.vis.shape
    assert new.device == ss.device


def test_device_follows_axes_from_unless_named():
    ss = make_stream()
    assert containers.SiderealStream(axes_from=ss, device="cpu").device == torch.device("cpu")
    with default_device(None):
        # axes_from gives the device; nothing resolves the (absent) card
        assert containers.empty_like(ss).vis[:].device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='device="cpu"'):
                containers.Map(nside=2, polarisation=False, freq=np.array([400.0]))


def test_copy_shared_and_deep():
    ss = make_stream()
    c1 = ss.copy()
    c1.vis[:] = 0.0
    assert not np.allclose(np.asarray(ss.vis), 0.0)
    c2 = ss.copy(shared=("vis",))
    assert c2.vis.shape == ss.vis.shape
    c2.vis[:] = 0.0  # shared storage: the original sees the write
    assert np.allclose(np.asarray(ss.vis), 0.0)
    assert not np.allclose(np.asarray(c2.weight), 0.0)


def test_mmodes_basic():
    mm = containers.MModes(mmax=8, freq=np.array([400.0, 500.0]), input=3, oddra=True)
    assert mm.mmax == 8
    assert mm.oddra
    assert mm.vis.shape == (9, 2, 2, 6)
    assert mm.vis.dtype == torch.complex128


def test_map_container():
    m = containers.Map(nside=8, polarisation=True, freq=np.array([400.0]))
    assert m.map.shape == (1, 4, 12 * 64)
    assert m.nside == 8
    m2 = containers.Map(nside=8, polarisation=False, freq=np.array([400.0]))
    assert m2.map.shape == (1, 1, 12 * 64)
    assert len(containers.Map(nside=4, polarisation=False, freq=4).freq) == 4


def test_stack_none_builds_identity():
    ss = make_stream()
    prod = np.array([[0, 1], [0, 2]])
    new = containers.SiderealStream(prod=prod, stack=None, axes_from=ss)
    assert len(new.index_map["stack"]) == 2
    assert np.array_equal(new.index_map["stack"]["prod"], [0, 1])
    assert np.array_equal(new.reverse_map["stack"]["stack"], [0, 1])


def test_hdf5_roundtrip(tmp_path):
    ss = make_stream()
    ss.attrs["tag"] = "round"
    ss.attrs["meta"] = {"a": 1, "b": [1, 2]}
    ss.history["config"] = "yaml: true"
    path = str(tmp_path / "ss.h5")
    ss.save(path)

    loaded = containers.ContainerBase.from_file(path)
    assert isinstance(loaded, containers.SiderealStream)
    assert torch.equal(loaded.vis[:], ss.vis[:])
    assert loaded.attrs["tag"] == "round" and loaded.attrs["meta"] == {"a": 1, "b": [1, 2]}
    assert loaded.history["config"] == "yaml: true"
    assert np.array_equal(loaded.freq, ss.freq)


def test_hdf5_selection(tmp_path):
    ss = make_stream(nfreq=6)
    path = str(tmp_path / "sel.h5")
    ss.save(path)
    loaded = containers.ContainerBase.from_file(path, sel={"freq": slice(1, 4)})
    assert loaded.vis.shape[0] == 3
    assert torch.equal(loaded.vis[:], ss.vis[:][1:4])
    assert np.array_equal(loaded.freq, ss.freq[1:4])


def test_selection_on_source_axis_drops_reverse_map(tmp_path):
    ss = make_stream()
    nprod = len(ss.index_map["prod"])
    path = str(tmp_path / "r.h5")
    ss.save(path)
    assert "stack" in containers.SiderealStream.from_file(path).reverse_map
    part = containers.SiderealStream.from_file(path, sel={"prod": slice(0, nprod // 2)})
    assert "stack" not in part.reverse_map


def test_from_file_rejects_unknown_kwargs(tmp_path):
    ss = make_stream()
    path = str(tmp_path / "s.h5")
    ss.save(path)
    with pytest.raises(TypeError, match="unexpected keyword"):
        containers.SiderealStream.from_file(path, dsitributed=False)


def test_json_attr_collision_rejected(tmp_path):
    ss = make_stream()
    ss.attrs["meta"] = {"a": 1}
    ss.attrs["meta!json"] = "i am not the encoding"
    with pytest.raises(ValueError, match="collision"):
        ss.save(str(tmp_path / "c.h5"))


def test_foreign_nonjson_tagged_attr_survives(tmp_path):
    ss = make_stream()
    path = str(tmp_path / "f.h5")
    ss.save(path)
    with h5py.File(path, "a") as f:
        f.attrs["odd!json"] = "{not json"
    assert containers.SiderealStream.from_file(path, distributed=False).attrs["odd!json"] == "{not json"


def test_copy_datasets_filter():
    ss = make_stream(nfreq=6)
    dest = containers.SiderealStream(freq=ss.freq[2:5], input=4, ra=16)
    containers.copy_datasets_filter(ss, dest, selection={"freq": slice(2, 5)})
    assert torch.equal(dest.vis[:], ss.vis[:][2:5])
    # an unselected dataset is copied, not shared
    containers.copy_datasets_filter(ss, dest, axis="freq", selection=[2, 3, 4])
    dest.input_flags[:] = 7.0
    assert not (ss.input_flags[:] == 7.0).any()
    with pytest.raises(ValueError):
        containers.copy_datasets_filter(ss, dest, axis=("freq", "ra"), selection=[1])


def test_concatenate_tod():
    parts = []
    for k in range(3):
        ts = containers.TimeStream(freq=np.array([400.0]), input=2, time=np.arange(4) + 4 * k)
        ts.vis[:] = float(k)
        parts.append(ts)
    joined = containers.concatenate_tod(parts)
    assert np.array_equal(joined.time, np.arange(12))
    assert torch.equal(joined.vis[:][0, 0], torch.tensor([0.0] * 4 + [1.0] * 4 + [2.0] * 4, dtype=torch.complex64))


def test_container_zoo_instantiable():
    """Every container of the JAX package's zoo test builds on the port,
    with the same datasets initialised."""
    freq = np.array([400.0, 500.0])
    n = 4
    cases = [
        ("TimeStream", {"freq": freq, "input": 3, "time": np.arange(n)}),
        ("SystemSensitivity", {"freq": freq, "pol": np.array(["XX"]), "time": np.arange(n)}),
        ("RFIMask", {"freq": freq, "time": np.arange(n)}),
        ("RFIMaskByPol", {"freq": freq, "pol": np.array(["XX"]), "time": np.arange(n)}),
        ("SiderealRFIMask", {"freq": freq, "ra": 8}),
        ("BaselineMask", {"freq": freq, "stack": np.arange(3), "time": np.arange(n)}),
        ("SVDModes", {"mmax": 4, "mode": np.arange(6)}),
        ("KLModes", {"mmax": 4, "mode": np.arange(6)}),
        ("VisGridStream", {"freq": freq, "pol": np.array(["XX"]), "ew": np.arange(2), "ns": np.arange(3), "ra": 8}),
        ("HybridVisStream", {"freq": freq, "pol": np.array(["XX"]), "ew": np.arange(2), "el": np.arange(3), "ra": 8}),
        ("HybridVisMModes", {"mmax": 3, "freq": freq, "pol": np.array(["XX"]), "ew": np.arange(2), "el": np.arange(3)}),
        ("RingMap", {"freq": freq, "beam": np.arange(1), "pol": np.array(["XX"]), "ra": 8, "el": np.arange(3)}),
        ("RingMapMask", {"freq": freq, "pol": np.array(["XX"]), "ra": 8, "el": np.arange(3)}),
        ("GainData", {"freq": freq, "input": 3, "time": np.arange(n)}),
        ("SiderealGainData", {"freq": freq, "input": 3, "ra": 8}),
        ("StaticGainData", {"freq": freq, "input": 3}),
        ("CommonModeGainData", {"freq": freq, "time": np.arange(n)}),
        ("DelaySpectrum", {"baseline": np.arange(3), "delay": np.linspace(-1, 1, 5)}),
        ("DelayTransform", {"baseline": np.arange(3), "sample": np.arange(2), "delay": np.linspace(-1, 1, 5)}),
        ("DelayCutoff", {"pol": np.array(["XX"]), "el": np.arange(3)}),
        ("FrequencyStack", {"freq": freq}),
        ("FrequencyStackByPol", {"freq": freq, "pol": np.array(["XX"])}),
        ("MockFrequencyStack", {"freq": freq, "mock": np.arange(2)}),
        ("Stack3D", {"freq": freq, "pol": np.array(["XX"]), "delta_ra": np.arange(3), "delta_dec": np.arange(3)}),
        ("SourceCatalog", {"object_id": np.arange(5)}),
        ("SpectroscopicCatalog", {"object_id": np.arange(5)}),
        ("FormedBeam", {"freq": freq, "object_id": np.arange(5), "pol": np.array(["XX"])}),
        ("FormedBeamHA", {"freq": freq, "object_id": np.arange(5), "pol": np.array(["XX"]), "ha": np.arange(3)}),
        ("FormedBeamMask", {"freq": freq, "object_id": np.arange(5), "pol": np.array(["XX"])}),
        ("GridBeam", {"freq": freq, "pol": np.array(["XX"]), "input": 2, "theta": np.arange(3), "phi": np.arange(4)}),
        ("HEALPixBeam", {"freq": freq, "pol": np.array(["XX"]), "input": 2, "nside": 4}),
        ("TrackBeam", {"freq": freq, "pol": np.array(["XX"]), "input": 2, "theta": np.arange(3.0), "phi": np.arange(3.0)}),
        ("Powerspectrum2D", {"kperp_edges": np.linspace(0, 1, 4), "kpar_edges": np.linspace(0, 1, 5)}),
        ("SVDSpectrum", {"m": np.arange(4), "singularvalue": np.arange(3)}),
        ("WaveletSpectrum", {"freq": freq, "baseline": np.arange(3), "delay": np.linspace(-1, 1, 5)}),
        ("DelayCrossSpectrum", {"baseline": np.arange(3), "delay": np.linspace(-1, 1, 5), "dataset": np.arange(2)}),
        ("LocalizedRFIMask", {"freq": freq, "el": np.arange(3), "time": np.arange(n)}),
        ("LocalizedSiderealRFIMask", {"freq": freq, "ra": 8, "el": np.arange(3)}),
        ("VisBandpassWindow", {"freq": freq, "pol": np.array(["XX"])}),
        ("VisBandpassCompensate", {"freq": freq, "pol": np.array(["XX"])}),
        ("HorizonLimit", {"azimuth": np.arange(8.0)}),
        ("PowerSpectrum2D", {"pol": np.array(["XX"]), "delay": np.arange(3.0), "uv_dist": np.arange(4.0)}),
        ("PowerSpectrum1D", {"pol": np.array(["XX"]), "k": np.arange(4.0)}),
        ("SpatialDelayCube", {"pol": np.array(["XX"]), "delay": np.arange(3.0), "u": np.arange(4), "v": np.arange(4)}),
        ("FreqNoiseModel", {"freq": freq, "pol": np.array(["XX"]), "ew": np.arange(2), "ns": np.arange(3), "ra": 8}),
    ]
    assert sorted(containers.__all__) == sorted(jcontainers.__all__ + ["concatenate_tod", "torch_dtype"])
    for name, kwargs in cases:
        cont = getattr(containers, name)(**kwargs)
        ref = getattr(jcontainers, name)(**kwargs)
        assert sorted(cont.datasets) == sorted(ref.datasets), name
        for dname, ds in cont.datasets.items():
            assert ds.shape == ref.datasets[dname].shape, (name, dname)
    assert containers.HorizonLimit(azimuth=np.arange(8.0)).get_horizon_limit(3.5) == 0.0


def test_empty_like():
    ss = make_stream()
    e = containers.empty_like(ss)
    assert e.vis.shape == ss.vis.shape
    assert torch.equal(e.vis[:], torch.zeros_like(ss.vis[:]))


def test_hybrid_weight_exclusivity():
    hv = containers.HybridVisStream(
        freq=np.array([400.0]), pol=np.array(["XX"]), ew=np.arange(2), el=np.arange(3), ra=8
    )
    with pytest.raises(RuntimeError):
        hv.add_dataset("elevation_vis_weight")


def test_empty_like_overridden_axis_drops_stale_reverse_map():
    ss = make_stream()
    nprod = len(ss.index_map["prod"])
    rmap = np.zeros(nprod, dtype=[("stack", "<u4"), ("conjugate", "u1")])
    rmap["stack"] = np.arange(nprod) % max(1, nprod - 1)
    ss.reverse_map["stack"] = rmap
    assert "stack" in containers.empty_like(ss).reverse_map
    new = containers.empty_like(ss, stack=ss.index_map["stack"][: nprod // 2])
    got = new.reverse_map.get("stack")
    if got is not None:
        assert got["stack"].max() < len(new.index_map["stack"])


def _layout(path):
    """Every object, attribute and value of an HDF5 file, as comparable data."""
    out = {}

    def visit(name, obj):
        attrs = {k: np.asarray(v).tolist() for k, v in obj.attrs.items()}
        data = obj[()].tobytes() if isinstance(obj, h5py.Dataset) else None
        dtype = str(obj.dtype) if isinstance(obj, h5py.Dataset) else None
        out[name] = (attrs, data, dtype)

    with h5py.File(path, "r") as f:
        out["/"] = ({k: np.asarray(v).tolist() for k, v in f.attrs.items()}, None, None)
        f.visititems(visit)
    return out


def _filled(package):
    ss = make_stream(package=package)
    rng = np.random.Generator(np.random.SFC64(3))
    ss.vis[:] = (rng.standard_normal(ss.vis.shape) + 1j * rng.standard_normal(ss.vis.shape)).astype(np.complex64)
    ss.weight[:] = rng.uniform(0.5, 2.0, ss.weight.shape).astype(np.float32)
    ss.attrs.update(tag="interop", lsd=8000, meta={"k": [1, 2]})
    ss.history["config"] = "pipeline: {}"
    ss.history["versions"] = {"numpy": np.__version__}
    return ss


@pytest.mark.parametrize("truncated", [False, True])
def test_files_interoperate_both_ways(tmp_path, truncated):
    """The port writes what draco_tpu writes, and each reads the other's
    file to the last bit: datasets, index and reverse maps, attrs, history."""
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "torch.h5")
    _filled(jcontainers).save(jpath, truncate=truncated)
    _filled(containers).save(tpath, truncate=truncated)
    assert _layout(jpath) == _layout(tpath)

    got = containers.ContainerBase.from_file(jpath)
    back = jcontainers.ContainerBase.from_file(tpath)
    assert type(got).__name__ == type(back).__name__ == "SiderealStream"
    for name in ("vis", "vis_weight", "input_flags"):
        assert np.asarray(got[name]).tobytes() == np.asarray(back[name][:]).tobytes()
    for a, b in ((got.index_map, back.index_map), (got.reverse_map, back.reverse_map)):
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    assert got.attrs == back.attrs and got.history == back.history


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_truncate_matches_jax_bitwise(dtype):
    rng = np.random.Generator(np.random.SFC64(11))
    shape = (3, 500)
    x = rng.standard_normal(shape) * 10 ** rng.uniform(-6, 6, shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    x = x.astype(dtype)
    weight = rng.uniform(0.0, 100.0, shape).astype(np.float32)
    for tspec, w in ((True, None), ({"weight_dataset": "w"}, weight)):
        got = truncate.truncate_dataset(x, tspec, w)
        want = jtruncate.truncate_dataset(x, tspec, w)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
