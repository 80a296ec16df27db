"""The concrete container zoo.

Re-provides all 74 typed containers of the reference framework (class list
at reference ``draco/core/containers.py:470-3409``; see SURVEY.md section
2.1) on top of :class:`~draco_tpu_torch.core.containers.ContainerBase`, whose
numeric datasets are torch tensors.  Copied from ``draco_tpu.core.containers_spec``
as data: the declarations are the same.
Axis layouts, dtypes and distributed axes follow the reference specs so that
on-disk data and pipeline configs translate directly.
"""

from __future__ import annotations

from typing import ClassVar

import numpy as np

from .containers import (
    COMPRESSION,
    COMPRESSION_OPTS,
    ContainerBase,
    DataWeightContainer,
    FreqContainer,
    MContainer,
    SampleVarianceContainer,
    SiderealContainer,
    TODContainer,
    VisBase,
    VisContainer,
    dataset_property,
)

__all__ = [
    "Map",
    "HealpixContainer",
    "CosmologyContainer",
    "TableSpec",
    "SiderealStream",
    "SystemSensitivity",
    "RFIMask",
    "RFIMaskByPol",
    "SiderealRFIMask",
    "SiderealRFIMaskByPol",
    "BaselineMask",
    "SiderealBaselineMask",
    "TimeStream",
    "GridBeam",
    "HEALPixBeam",
    "TrackBeam",
    "MModes",
    "SVDModes",
    "KLModes",
    "VisGridStream",
    "FilterFreqContainer",
    "HybridVisStream",
    "HybridVisMModes",
    "RingMap",
    "RingMapMask",
    "RingMapTaper",
    "FreqNoiseModel",
    "GainDataBase",
    "CommonModeGainData",
    "CommonModeSiderealGainData",
    "GainData",
    "SiderealGainData",
    "StaticGainData",
    "DelayCutoff",
    "DelayContainer",
    "DelaySpectrum",
    "DelayTransform",
    "DelayTransformOperator",
    "Fourier3DContainer",
    "SpatialDelayCube",
    "PowerSpectrum3D",
    "PowerSpectrum2D",
    "PowerSpectrum1D",
    "WaveletSpectrum",
    "DelayCrossSpectrum",
    "Powerspectrum2D",
    "SVDSpectrum",
    "FrequencyStack",
    "FrequencyStackByPol",
    "MockFrequencyStack",
    "MockFrequencyStackByPol",
    "Stack3D",
    "SourceCatalog",
    "SpectroscopicCatalog",
    "FormedBeam",
    "FormedBeamHA",
    "FormedBeamHAEW",
    "FitFormedBeam",
    "FitFormedBeamEW",
    "FormedBeamMask",
    "FormedBeamHAMask",
    "LocalizedRFIMask",
    "LocalizedSiderealRFIMask",
    "VisBandpassWindow",
    "VisBandpassCompensate",
    "VisBandpassWindowBaseline",
    "VisBandpassCompensateBaseline",
    "VisBandpassWindowBaselineRA",
    "VisBandpassCompensateBaselineRA",
    "HorizonLimit",
    "empty_timestream",
]


# ---------------------------------------------------------------------------
# Bases that the reference pulls from cora / caput
# ---------------------------------------------------------------------------


class HealpixContainer(ContainerBase):
    """Container with a HEALPix pixel axis (cora HealpixContainer equivalent).

    Parameters
    ----------
    nside
        HEALPix resolution; the pixel axis has 12*nside**2 entries.
    """

    _axes = ("pixel",)

    def __init__(self, nside: int | None = None, **kwargs):
        if nside is not None:
            kwargs["pixel"] = np.arange(12 * nside * nside)
        super().__init__(**kwargs)

    @property
    def nside(self) -> int:
        return int(np.sqrt(len(self.index_map["pixel"]) / 12))


class CosmologyContainer(ContainerBase):
    """Container carrying cosmological metadata in attrs (cora equivalent)."""

    def __init__(self, *args, cosmology: dict | None = None, **kwargs):
        attrs_to_set = {}
        for key in ("redshift", "freq_center", "ps_norm", "delay_cut"):
            if key in kwargs:
                attrs_to_set[key] = kwargs.pop(key)
        super().__init__(*args, **kwargs)
        if cosmology is not None:
            if not isinstance(cosmology, dict):
                # Accept a Cosmology-like object (ops.cosmology.Cosmology)
                cosmology = {
                    "H0": getattr(cosmology, "H0", 67.8),
                    "omega_m": getattr(cosmology, "omega_m", 0.309),
                    "omega_l": getattr(cosmology, "omega_l", None),
                }
            self.attrs["cosmology"] = dict(cosmology)
        self.attrs.update(attrs_to_set)

    @property
    def cosmology(self):
        """The stored cosmological parameters (dict), if any."""
        return self.attrs.get("cosmology")


class TableSpec(ContainerBase):
    """Container of structured table datasets (caput TableSpec equivalent).

    Subclasses declare ``_table_spec``: name -> {columns: [[col, dtype]...],
    axis: axis_name}.  Tables become structured-dtype datasets over that axis.
    """

    _table_spec: ClassVar[dict[str, dict]] = {}

    @classmethod
    def table_spec(cls) -> dict[str, dict]:
        spec: dict[str, dict] = {}
        for klass in reversed(cls.__mro__):
            for name, ts in vars(klass).get("_table_spec", {}).items():
                spec[name] = ts
        return spec

    @classmethod
    def dataset_spec(cls) -> dict[str, dict]:
        spec = dict(super().dataset_spec())
        for name, ts in cls.table_spec().items():
            dtype = np.dtype([(cn, ct) for cn, ct in ts["columns"]])
            spec[name] = {
                "axes": [ts["axis"]],
                "dtype": dtype,
                "initialise": True,
                "distributed": False,
            }
        return spec


# ---------------------------------------------------------------------------
# Maps (reference containers.py:470 — cora Map with draco freq map)
# ---------------------------------------------------------------------------


class Map(FreqContainer, HealpixContainer):
    """Multi-frequency sky maps ``[freq, pol, pixel]`` (reference containers.py:470).

    Parameters
    ----------
    nside
        HEALPix nside of the maps.
    polarisation
        Store all Stokes IQUV (True) or just Stokes I (False).
    """

    _axes = ("pol",)

    _dataset_spec: ClassVar = {
        "map": {
            "axes": ["freq", "pol", "pixel"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        }
    }

    def __init__(self, polarisation: bool | None = None, **kwargs):
        if polarisation is not None and "pol" not in kwargs:
            kwargs["pol"] = (
                np.array(["I", "Q", "U", "V"]) if polarisation else np.array(["I"])
            )
        super().__init__(**kwargs)

    map = dataset_property("map")

    @property
    def pol(self):
        return self.index_map["pol"]


# ---------------------------------------------------------------------------
# Visibility streams (reference containers.py:489, 821)
# ---------------------------------------------------------------------------


class SiderealStream(
    FreqContainer, VisContainer, SiderealContainer, SampleVarianceContainer
):
    """Visibilities in sidereal time ``[freq, stack, ra]``.

    (reference containers.py:489-593)
    """

    _dataset_spec: ClassVar = {
        "vis": {
            "axes": ["freq", "stack", "ra"],
            "dtype": np.complex64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
            "compression": COMPRESSION,
            "compression_opts": COMPRESSION_OPTS,
            "chunks": (32, 512, 2048),
        },
        "vis_weight": {
            "axes": ["freq", "stack", "ra"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
            "compression": COMPRESSION,
            "compression_opts": COMPRESSION_OPTS,
            "chunks": (32, 512, 2048),
        },
        "input_flags": {
            "axes": ["input", "ra"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": False,
        },
        "gain": {
            "axes": ["freq", "input", "ra"],
            "dtype": np.complex64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "sample_variance": {
            "axes": ["component", "freq", "stack", "ra"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "nsample": {
            "axes": ["freq", "stack", "ra"],
            "dtype": np.uint16,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "effective_ra": {
            "axes": ["freq", "stack", "ra"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    gain = dataset_property("gain")
    input_flags = dataset_property("input_flags")

    @property
    def _mean(self):
        return self.datasets["vis"]

    @property
    def effective_ra(self):
        if "effective_ra" in self.datasets:
            return self.datasets["effective_ra"]
        raise KeyError("Dataset 'effective_ra' not initialised.")


class TimeStream(FreqContainer, VisContainer, TODContainer):
    """Visibilities in time ``[freq, stack, time]`` (reference containers.py:821)."""

    _dataset_spec: ClassVar = {
        "vis": {
            "axes": ["freq", "stack", "time"],
            "dtype": np.complex64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
            "compression": COMPRESSION,
            "compression_opts": COMPRESSION_OPTS,
            "chunks": (16, 256, 1024),
        },
        "vis_weight": {
            "axes": ["freq", "stack", "time"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
            "compression": COMPRESSION,
            "compression_opts": COMPRESSION_OPTS,
            "chunks": (16, 256, 1024),
        },
        "input_flags": {
            "axes": ["input", "time"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": False,
        },
        "gain": {
            "axes": ["freq", "input", "time"],
            "dtype": np.complex64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    gain = dataset_property("gain")
    input_flags = dataset_property("input_flags")


def empty_timestream(**kwargs) -> TimeStream:
    """Create a new TimeStream (reference containers.py:3062)."""
    return TimeStream(**kwargs)


# ---------------------------------------------------------------------------
# Sensitivity + masks (reference containers.py:596-820)
# ---------------------------------------------------------------------------


class SystemSensitivity(FreqContainer, TODContainer):
    """Total system sensitivity summary (reference containers.py:596)."""

    _axes = ("pol",)

    _dataset_spec: ClassVar = {
        "measured": {
            "axes": ["freq", "pol", "time"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "radiometer": {
            "axes": ["freq", "pol", "time"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["freq", "pol", "time"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "frac_lost": {
            "axes": ["freq", "time"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    measured = dataset_property("measured")
    radiometer = dataset_property("radiometer")
    weight = dataset_property("weight")
    frac_lost = dataset_property("frac_lost")

    @property
    def pol(self):
        return self.index_map["pol"]


class RFIMask(FreqContainer, TODContainer):
    """RFI mask ``[freq, time]``; True = contaminated (reference containers.py:661)."""

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["freq", "time"],
            "dtype": bool,
            "initialise": True,
            "distributed": False,
        }
    }

    mask = dataset_property("mask")


class RFIMaskByPol(RFIMask):
    """Pol-dependent RFI mask (reference containers.py:684)."""

    _axes = ("pol",)

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["pol", "freq", "time"],
            "dtype": bool,
            "initialise": True,
            "distributed": False,
        }
    }

    @property
    def pol(self):
        return self.index_map["pol"]


class SiderealRFIMask(FreqContainer, SiderealContainer):
    """RFI mask over RA (reference containers.py:709)."""

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["freq", "ra"],
            "dtype": bool,
            "initialise": True,
            "distributed": False,
        }
    }

    mask = dataset_property("mask")


class SiderealRFIMaskByPol(SiderealRFIMask):
    """Pol-dependent RFI mask over RA (reference containers.py:732)."""

    _axes = ("pol",)

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["pol", "freq", "ra"],
            "dtype": bool,
            "initialise": True,
            "distributed": False,
        }
    }

    @property
    def pol(self):
        return self.index_map["pol"]


class BaselineMask(FreqContainer, TODContainer):
    """Baseline-dependent mask ``[freq, stack, time]`` (reference containers.py:757)."""

    _axes = ("stack",)

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["freq", "stack", "time"],
            "dtype": bool,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        }
    }

    mask = dataset_property("mask")

    @property
    def stack(self):
        return self.index_map["stack"]


class SiderealBaselineMask(FreqContainer, SiderealContainer):
    """Baseline-dependent mask over RA (reference containers.py:789)."""

    _axes = ("stack",)

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["freq", "stack", "ra"],
            "dtype": bool,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        }
    }

    mask = dataset_property("mask")

    @property
    def stack(self):
        return self.index_map["stack"]


# ---------------------------------------------------------------------------
# Beams (reference containers.py:883-1165)
# ---------------------------------------------------------------------------


class GridBeam(FreqContainer, DataWeightContainer):
    """2D beam on a rectangular grid (reference containers.py:883)."""

    _axes = ("pol", "input", "theta", "phi")

    _dataset_spec: ClassVar = {
        "beam": {
            "axes": ["freq", "pol", "input", "theta", "phi"],
            "dtype": np.complex64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["freq", "pol", "input", "theta", "phi"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "quality": {
            "axes": ["freq", "pol", "input", "theta", "phi"],
            "dtype": np.uint8,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "gain": {
            "axes": ["freq", "input"],
            "dtype": np.complex64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    _data_dset_name = "beam"
    _weight_dset_name = "weight"

    def __init__(self, coords: str = "celestial", **kwargs):
        super().__init__(**kwargs)
        self.attrs["coords"] = coords

    beam = dataset_property("beam")
    quality = dataset_property("quality")
    gain = dataset_property("gain")

    @property
    def coords(self):
        return self.attrs["coords"]

    @property
    def pol(self):
        return self.index_map["pol"]

    @property
    def input(self):
        return self.index_map["input"]

    @property
    def theta(self):
        return self.index_map["theta"]

    @property
    def phi(self):
        return self.index_map["phi"]


class HEALPixBeam(FreqContainer, HealpixContainer, DataWeightContainer):
    """Spherical beam on a HEALPix grid (reference containers.py:967)."""

    _axes = ("pol", "input")

    _dataset_spec: ClassVar = {
        "beam": {
            "axes": ["freq", "pol", "input", "pixel"],
            "dtype": np.dtype([("Et", np.complex64), ("Ep", np.complex64)]),
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["freq", "pol", "input", "pixel"],
            "dtype": np.dtype([("Et", np.float32), ("Ep", np.float32)]),
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    _data_dset_name = "beam"
    _weight_dset_name = "weight"

    def __init__(self, coords: str = "unknown", ordering: str = "unknown", **kwargs):
        super().__init__(**kwargs)
        self.attrs["coords"] = coords
        self.attrs["ordering"] = ordering

    beam = dataset_property("beam")

    @property
    def ordering(self):
        return self.attrs["ordering"]

    @property
    def coords(self):
        return self.attrs["coords"]

    @property
    def pol(self):
        return self.index_map["pol"]

    @property
    def input(self):
        return self.index_map["input"]


class TrackBeam(FreqContainer, SampleVarianceContainer, DataWeightContainer):
    """Beam samples at arbitrary sphere locations (reference containers.py:1036)."""

    _axes = ("pol", "input", "pix")

    _dataset_spec: ClassVar = {
        "beam": {
            "axes": ["freq", "pol", "input", "pix"],
            "dtype": np.complex64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["freq", "pol", "input", "pix"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "sample_variance": {
            "axes": ["component", "freq", "pol", "input", "pix"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "nsample": {
            "axes": ["freq", "pol", "input", "pix"],
            "dtype": np.uint8,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    _data_dset_name = "beam"
    _weight_dset_name = "weight"

    def __init__(
        self,
        theta=None,
        phi=None,
        coords: str = "celestial",
        track_type: str = "drift",
        **kwargs,
    ):
        if theta is not None and phi is not None:
            if len(theta) != len(phi):
                raise RuntimeError(
                    f"theta and phi axes must have same length: "
                    f"({len(theta)} != {len(phi)})"
                )
            pix = np.zeros(
                len(theta), dtype=[("theta", np.float32), ("phi", np.float32)]
            )
            pix["theta"] = theta
            pix["phi"] = phi
            kwargs["pix"] = pix
        elif (theta is None) != (phi is None):
            raise RuntimeError("Both theta and phi coordinates must be specified.")
        super().__init__(**kwargs)
        self.attrs["coords"] = coords
        self.attrs["track_type"] = track_type

    beam = dataset_property("beam")

    @property
    def coords(self):
        return self.attrs["coords"]

    @property
    def track_type(self):
        return self.attrs["track_type"]

    @property
    def pol(self):
        return self.index_map["pol"]

    @property
    def input(self):
        return self.index_map["input"]

    @property
    def pix(self):
        return self.index_map["pix"]

    @property
    def _mean(self):
        return self.datasets["beam"]


# ---------------------------------------------------------------------------
# m-mode containers (reference containers.py:1167-1247)
# ---------------------------------------------------------------------------


class MModes(FreqContainer, VisContainer, MContainer):
    """m-mode data ``[m, msign, freq, stack]`` distributed over m.

    (reference containers.py:1167-1193)
    """

    _dataset_spec: ClassVar = {
        "vis": {
            "axes": ["m", "msign", "freq", "stack"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "m",
        },
        "vis_weight": {
            "axes": ["m", "msign", "freq", "stack"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "m",
        },
    }


class SVDModes(MContainer, VisBase):
    """SVD-projected m-mode data ``[m, mode]`` (reference containers.py:1196)."""

    _axes = ("mode",)

    _dataset_spec: ClassVar = {
        "vis": {
            "axes": ["m", "mode"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "m",
        },
        "vis_weight": {
            "axes": ["m", "mode"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "m",
        },
        "nmode": {
            "axes": ["m"],
            "dtype": np.int32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "m",
        },
    }

    nmode = dataset_property("nmode")


class KLModes(SVDModes):
    """KL-filtered m-mode data (reference containers.py:1237)."""


class HybridVisMModes(FreqContainer, MContainer, VisBase):
    """NS-beamformed visibilities in m-space (reference containers.py:1550)."""

    _axes = ("pol", "ew", "el")

    _dataset_spec: ClassVar = {
        "vis": {
            "axes": ["m", "msign", "pol", "freq", "ew", "el"],
            "dtype": np.complex64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "vis_weight": {
            "axes": ["m", "msign", "pol", "freq", "ew"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }


# ---------------------------------------------------------------------------
# Gridded / hybrid visibilities and ring maps
# (reference containers.py:1249-1838)
# ---------------------------------------------------------------------------


class VisGridStream(FreqContainer, SiderealContainer, VisBase):
    """Visibilities on a pol x ew x ns grid (reference containers.py:1249)."""

    _axes = ("pol", "ew", "ns")

    _dataset_spec: ClassVar = {
        "vis": {
            "axes": ["pol", "freq", "ew", "ns", "ra"],
            "dtype": np.complex64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
            "chunks": (1, 64, 1, 64, 128),
            "compression": COMPRESSION,
            "compression_opts": COMPRESSION_OPTS,
        },
        "vis_weight": {
            "axes": ["pol", "freq", "ew", "ns", "ra"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
            "chunks": (1, 64, 1, 64, 128),
            "compression": COMPRESSION,
            "compression_opts": COMPRESSION_OPTS,
        },
        "redundancy": {
            "axes": ["pol", "ew", "ns", "ra"],
            "dtype": np.int32,
            "initialise": False,
            "distributed": False,
        },
    }

    @property
    def redundancy(self):
        if "redundancy" in self.datasets:
            return self.datasets["redundancy"]
        raise KeyError("Dataset 'redundancy' not initialised.")


class FilterFreqContainer(ContainerBase):
    """Base for frequency-filtered data with a freq_sum axis.

    (reference containers.py:1302-1387)
    """

    _axes = ("freq_sum",)

    def _finalise_axes(self, axes_from):
        super()._finalise_axes(axes_from)
        if "freq_sum" not in self.index_map and "freq" in self.index_map:
            self.create_index_map("freq_sum", self.index_map["freq"])

    def add_dataset(self, name, data=None):
        exclusive = {
            "filter": "complex_filter",
            "complex_filter": "filter",
            "freq_cov": "complex_freq_cov",
            "complex_freq_cov": "freq_cov",
        }
        other = exclusive.get(name)
        if other is not None and other in self.datasets:
            raise RuntimeError(
                f"Requesting creation of {name!r} but {other!r} already exists."
            )
        return super().add_dataset(name, data=data)

    @property
    def filter(self):
        for name in ("filter", "complex_filter"):
            if name in self.datasets:
                return self.datasets[name]
        raise KeyError("Dataset 'filter' not initialised.")

    @property
    def freq_cov(self):
        for name in ("freq_cov", "complex_freq_cov"):
            if name in self.datasets:
                return self.datasets[name]
        raise KeyError("Dataset 'freq_cov' not initialised.")

    @property
    def swapped_freq_cov_axis(self):
        swap = {"freq": "freq_sum", "freq_sum": "freq"}
        return np.array([swap.get(ax, ax) for ax in self.freq_cov.attrs["axis"]])


class HybridVisStream(FilterFreqContainer, FreqContainer, SiderealContainer, VisBase):
    """Visibilities beamformed in NS only (reference containers.py:1389)."""

    _axes = ("pol", "ew", "el")

    _dataset_spec: ClassVar = {
        "vis": {
            "axes": ["pol", "freq", "ew", "el", "ra"],
            "dtype": np.complex64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "dirty_beam": {
            "axes": ["pol", "freq", "ew", "el", "ra"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "vis_weight": {
            "axes": ["pol", "freq", "ew", "ra"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "elevation_vis_weight": {
            "axes": ["pol", "freq", "ew", "el", "ra"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "effective_ra": {
            "axes": ["pol", "freq", "ew", "ra"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "nsample": {
            "axes": ["pol", "freq", "ew", "ra"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "filter": {
            "axes": ["pol", "freq", "freq_sum", "ew", "ra"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "complex_filter": {
            "axes": ["pol", "freq", "freq_sum", "ew", "ra"],
            "dtype": np.complex128,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "freq_cov": {
            "axes": ["pol", "freq", "freq_sum", "ew", "ra"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "complex_freq_cov": {
            "axes": ["pol", "freq", "freq_sum", "ew", "ra"],
            "dtype": np.complex128,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    def add_dataset(self, name, data=None):
        # Elevation-dependent and -independent weights are mutually exclusive
        # (reference containers.py:1501-1516).
        if name == "vis_weight" and "elevation_vis_weight" in self.datasets:
            raise RuntimeError(
                "Requesting creation of elevation-independent weights but "
                "elevation-dependent weights already exist."
            )
        if name == "elevation_vis_weight":
            if "vis_weight" in self.datasets:
                raise RuntimeError(
                    "Requesting creation of elevation-dependent weights but "
                    "elevation-independent weights already exist."
                )
            self._weight_dset_name = "elevation_vis_weight"
        return super().add_dataset(name, data=data)

    dirty_beam = dataset_property("dirty_beam")

    @property
    def effective_ra(self):
        if "effective_ra" in self.datasets:
            return self.datasets["effective_ra"]
        raise KeyError("Dataset 'effective_ra' not initialised.")

    @property
    def nsample(self):
        if "nsample" in self.datasets:
            return self.datasets["nsample"]
        raise KeyError("Dataset 'nsample' not initialised.")

    @property
    def pol(self):
        return self.index_map["pol"]

    @property
    def ew(self):
        return self.index_map["ew"]


class RingMap(FilterFreqContainer, FreqContainer, SiderealContainer, DataWeightContainer):
    """Multifrequency ring maps ``[beam, pol, freq, ra, el]``.

    (reference containers.py:1577)
    """

    _axes = ("pol", "beam", "el")

    _dataset_spec: ClassVar = {
        "map": {
            "axes": ["beam", "pol", "freq", "ra", "el"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
            "chunks": (1, 1, 32, 512, 512),
            "compression": COMPRESSION,
            "compression_opts": COMPRESSION_OPTS,
        },
        "weight": {
            "axes": ["pol", "freq", "ra", "el"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
            "chunks": (1, 32, 512, 512),
            "compression": COMPRESSION,
            "compression_opts": COMPRESSION_OPTS,
        },
        "dirty_beam": {
            "axes": ["beam", "pol", "freq", "ra", "el"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "dirty_beam_power": {
            "axes": ["beam", "pol", "freq", "el"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "rms": {
            "axes": ["pol", "freq", "ra"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "filter": {
            "axes": ["pol", "freq", "freq_sum", "ra"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "complex_filter": {
            "axes": ["pol", "freq", "freq_sum", "ra"],
            "dtype": np.complex128,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "freq_cov": {
            "axes": ["pol", "freq", "freq_sum", "ra"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "complex_freq_cov": {
            "axes": ["pol", "freq", "freq_sum", "ra"],
            "dtype": np.complex128,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    _data_dset_name = "map"
    _weight_dset_name = "weight"

    map = dataset_property("map")

    @property
    def pol(self):
        return self.index_map["pol"]

    @property
    def el(self):
        return self.index_map["el"]

    @property
    def rms(self):
        return self.datasets["rms"]

    @property
    def dirty_beam(self):
        return self.datasets["dirty_beam"]

    @property
    def dirty_beam_power(self):
        return self.datasets["dirty_beam_power"]


class RingMapMask(FreqContainer, SiderealContainer):
    """Mask of bad ringmap pixels (reference containers.py:1730)."""

    _axes = ("pol", "el")

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["pol", "freq", "ra", "el"],
            "dtype": bool,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        }
    }

    mask = dataset_property("mask")


class RingMapTaper(FreqContainer, SiderealContainer):
    """Smooth taper from good to bad ringmap pixels (reference containers.py:1751)."""

    _axes = ("pol", "el")

    _dataset_spec: ClassVar = {
        "taper": {
            "axes": ["pol", "freq", "ra", "el"],
            "dtype": float,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        }
    }

    taper = dataset_property("taper")

    @property
    def weight(self):
        return self.datasets["taper"]


class FreqNoiseModel(FilterFreqContainer, FreqContainer, SiderealContainer):
    """Cholesky factors of freq-freq noise covariance (reference containers.py:1777)."""

    _axes = ("pol", "ew", "ns")

    _dataset_spec: ClassVar = {
        "redundancy": {
            "axes": ["pol", "ew", "ns"],
            "dtype": np.int32,
            "initialise": True,
            "distributed": False,
        },
        "weight": {
            "axes": ["pol", "freq", "ew", "ra"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "freq_cov": {
            "axes": ["pol", "ew", "ra", "freq", "freq_sum"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "ra",
        },
        "complex_freq_cov": {
            "axes": ["pol", "ew", "ra", "freq", "freq_sum"],
            "dtype": np.complex128,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "ra",
        },
    }

    redundancy = dataset_property("redundancy")
    weight = dataset_property("weight")


# ---------------------------------------------------------------------------
# Gains (reference containers.py:1840-2005)
# ---------------------------------------------------------------------------


class GainDataBase(DataWeightContainer):
    """Interface for gain-like data (reference containers.py:1840)."""

    _data_dset_name = "gain"
    _weight_dset_name = "weight"

    gain = dataset_property("gain")

    @property
    def weight(self):
        try:
            return super().weight
        except KeyError:
            return None


class CommonModeGainData(FreqContainer, TODContainer, GainDataBase):
    """Gain common to all inputs vs time (reference containers.py:1867)."""

    _dataset_spec: ClassVar = {
        "gain": {
            "axes": ["freq", "time"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["freq", "time"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }


class CommonModeSiderealGainData(FreqContainer, SiderealContainer, GainDataBase):
    """Gain common to all inputs vs RA (reference containers.py:1888)."""

    _dataset_spec: ClassVar = {
        "gain": {
            "axes": ["freq", "ra"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["freq", "ra"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }


class GainData(FreqContainer, TODContainer, GainDataBase):
    """Per-input gains vs time (reference containers.py:1909)."""

    _axes = ("input",)

    _dataset_spec: ClassVar = {
        "gain": {
            "axes": ["freq", "input", "time"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["freq", "input", "time"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "update_id": {
            "axes": ["time"],
            "dtype": np.dtype("<U64"),
            "initialise": False,
            "distributed": False,
        },
    }

    @property
    def update_id(self):
        return self.datasets.get("update_id")

    @property
    def input(self):
        return self.index_map["input"]


class SiderealGainData(FreqContainer, SiderealContainer, GainDataBase):
    """Per-input gains vs RA (reference containers.py:1951)."""

    _axes = ("input",)

    _dataset_spec: ClassVar = {
        "gain": {
            "axes": ["freq", "input", "ra"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["freq", "input", "ra"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    @property
    def input(self):
        return self.index_map["input"]


class StaticGainData(FreqContainer, GainDataBase):
    """Non time-varying gains (reference containers.py:1979)."""

    _axes = ("input",)

    _dataset_spec: ClassVar = {
        "gain": {
            "axes": ["freq", "input"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["freq", "input"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    @property
    def input(self):
        return self.index_map["input"]


# ---------------------------------------------------------------------------
# Delay containers (reference containers.py:2007-2306)
# ---------------------------------------------------------------------------


class DelayCutoff(ContainerBase):
    """Delay cutoff per pol/el (reference containers.py:2007)."""

    _axes = ("pol", "el")

    _dataset_spec: ClassVar = {
        "cutoff": {
            "axes": ["pol", "el"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        }
    }

    cutoff = dataset_property("cutoff")

    @property
    def pol(self):
        return self.index_map["pol"]

    @property
    def el(self):
        return self.index_map["el"]


class DelayContainer(ContainerBase):
    """A container with a delay axis (reference containers.py:2038)."""

    _axes = ("delay",)

    @property
    def delay(self) -> np.ndarray:
        """The delay axis in microseconds."""
        return self.index_map["delay"]


class DelaySpectrum(DelayContainer):
    """Delay power spectrum ``[baseline, delay]`` (reference containers.py:2049)."""

    _axes = ("baseline", "sample")

    _dataset_spec: ClassVar = {
        "spectrum": {
            "axes": ["baseline", "delay"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "baseline",
        },
        "spectrum_samples": {
            "axes": ["sample", "baseline", "delay"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "baseline",
        },
        "spectrum_mask": {
            "axes": ["baseline"],
            "dtype": bool,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "baseline",
        },
    }

    def __init__(self, *args, weight_boost: float = 1.0, sample: int = 1, **kwargs):
        super().__init__(*args, sample=np.arange(sample), **kwargs)
        self.attrs["weight_boost"] = weight_boost

    spectrum = dataset_property("spectrum")

    @property
    def weight_boost(self):
        return self.attrs["weight_boost"]

    @property
    def freq(self):
        """The frequency axis of the input data."""
        return self.attrs["freq"]


class DelayTransform(DelayContainer):
    """Complex delay spectrum ``[baseline, sample, delay]``.

    (reference containers.py:2113)
    """

    _axes = ("baseline", "sample")

    _dataset_spec: ClassVar = {
        "spectrum": {
            "axes": ["baseline", "sample", "delay"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "baseline",
        },
        "weight": {
            "axes": ["baseline", "sample", "delay"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "baseline",
        },
        "spectrum_mask": {
            "axes": ["baseline", "sample"],
            "dtype": bool,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "baseline",
        },
    }

    def __init__(self, weight_boost: float = 1.0, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.attrs["weight_boost"] = weight_boost

    spectrum = dataset_property("spectrum")

    @property
    def weight(self):
        return self.datasets["weight"]

    @property
    def weight_boost(self):
        return self.attrs["weight_boost"]

    @property
    def freq(self):
        return self.attrs["freq"]


class DelayTransformOperator(DelayContainer, FreqContainer, SiderealContainer):
    """Per-pixel freq->delay Wiener filter (reference containers.py:2185)."""

    _axes = ("pol", "el")

    _dataset_spec: ClassVar = {
        "filter": {
            "axes": ["pol", "ra", "el", "delay", "freq"],
            "dtype": np.complex64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "el",
        }
    }

    filter = dataset_property("filter")


class Fourier3DContainer(CosmologyContainer, DelayContainer):
    """Base container with Fourier axes (pol, delay, u, v).

    (reference containers.py:2206)
    """

    _axes = ("pol", "u", "v")

    _dataset_spec: ClassVar = {
        "kx": {
            "axes": ["u"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "ky": {
            "axes": ["v"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "kpara": {
            "axes": ["delay"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "uv_mask": {
            "axes": ["u", "v"],
            "dtype": bool,
            "initialise": True,
            "distributed": False,
        },
    }

    kx = dataset_property("kx")
    ky = dataset_property("ky")
    kpara = dataset_property("kpara")
    uv_mask = dataset_property("uv_mask")

    @property
    def redshift(self):
        return self.attrs["redshift"]

    @property
    def freq_center(self):
        return self.attrs["freq_center"]


class SpatialDelayCube(Fourier3DContainer):
    """Data in (pol, delay, u, v) (reference containers.py:2269)."""

    _dataset_spec: ClassVar = {
        "vis": {
            "axes": ["pol", "delay", "u", "v"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "delay",
        }
    }

    vis = dataset_property("vis")


class PowerSpectrum3D(Fourier3DContainer):
    """3D power spectrum (reference containers.py:2288)."""

    _dataset_spec: ClassVar = {
        "spectrum": {
            "axes": ["pol", "delay", "u", "v"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "delay",
        }
    }

    spectrum = dataset_property("spectrum")

    @property
    def ps_norm(self):
        return self.attrs["ps_norm"]


class PowerSpectrum2D(CosmologyContainer):
    """Cylindrically averaged 2D power spectrum (reference containers.py:2312)."""

    _axes = ("pol", "delay", "uv_dist")

    _dataset_spec: ClassVar = {
        "spectrum": {
            "axes": ["pol", "delay", "uv_dist"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "delay",
        },
        "weight": {
            "axes": ["pol", "delay", "uv_dist"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
        },
        "neff": {
            "axes": ["pol", "delay", "uv_dist"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "delay",
        },
        "mask": {
            "axes": ["pol", "delay", "uv_dist"],
            "dtype": bool,
            "initialise": True,
            "distributed": True,
        },
        "kpara": {
            "axes": ["delay"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "kperp": {
            "axes": ["uv_dist"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
    }

    spectrum = dataset_property("spectrum")
    weight = dataset_property("weight")
    neff = dataset_property("neff")
    mask = dataset_property("mask")
    kpara = dataset_property("kpara")
    kperp = dataset_property("kperp")

    @property
    def delay_cut(self):
        return self.attrs["delay_cut"]


class PowerSpectrum1D(CosmologyContainer):
    """1D power spectrum (reference containers.py:2394)."""

    _axes = ("pol", "k")

    _dataset_spec: ClassVar = {
        "spectrum": {
            "axes": ["pol", "k"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
        },
        "samp_var": {
            "axes": ["pol", "k"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
        },
        "var": {
            "axes": ["pol", "k"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
        },
        "neff": {
            "axes": ["pol", "k"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
        },
        "k1D": {
            "axes": ["pol", "k"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
        },
    }

    spectrum = dataset_property("spectrum")
    samp_var = dataset_property("samp_var")
    var = dataset_property("var")
    neff = dataset_property("neff")
    k1D = dataset_property("k1D")


class WaveletSpectrum(FreqContainer, DelayContainer, DataWeightContainer):
    """Wavelet power spectrum (reference containers.py:2458)."""

    _axes = ("baseline",)

    _dataset_spec: ClassVar = {
        "spectrum": {
            "axes": ["baseline", "delay", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "baseline",
        },
        "weight": {
            "axes": ["baseline", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "baseline",
        },
    }

    _data_dset_name = "spectrum"
    _weight_dset_name = "weight"

    spectrum = dataset_property("spectrum")


class DelayCrossSpectrum(DelaySpectrum):
    """Delay cross power spectra (reference containers.py:2488)."""

    _axes = ("dataset",)

    _dataset_spec: ClassVar = {
        "spectrum": {
            "axes": ["dataset", "dataset", "baseline", "delay"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "baseline",
        },
        "spectrum_samples": {
            "axes": ["sample", "dataset", "dataset", "baseline", "delay"],
            "dtype": np.float64,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "baseline",
        },
    }

    def add_dataset(self, name, data=None):
        # Datasets use the repeated "dataset" axis twice: shape derives fine.
        return super().add_dataset(name, data=data)

    spectrum = dataset_property("spectrum")


class Powerspectrum2D(ContainerBase):
    """2D cartesian power spectrum from the quadratic estimator.

    (reference containers.py:2516)
    """

    _axes = ("kperp", "kpar")

    _dataset_spec: ClassVar = {
        "powerspectrum": {
            "axes": ["kperp", "kpar"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "C_inv": {
            "axes": ["kperp", "kpar", "kperp", "kpar"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
    }

    def __init__(self, kperp_edges=None, kpar_edges=None, **kwargs):
        for name, edges in (("kperp", kperp_edges), ("kpar", kpar_edges)):
            if edges is not None:
                edges = np.asarray(edges)
                centre = 0.5 * (edges[1:] + edges[:-1])
                width = edges[1:] - edges[:-1]
                ax = np.zeros(
                    len(centre),
                    dtype=[("centre", np.float64), ("width", np.float64)],
                )
                ax["centre"] = centre
                ax["width"] = width
                kwargs[name] = ax
        super().__init__(**kwargs)

    powerspectrum = dataset_property("powerspectrum")
    C_inv = dataset_property("C_inv")


class SVDSpectrum(ContainerBase):
    """m-mode SVD spectrum (reference containers.py:2589)."""

    _axes = ("m", "singularvalue")

    _dataset_spec: ClassVar = {
        "spectrum": {
            "axes": ["m", "singularvalue"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "m",
        }
    }

    spectrum = dataset_property("spectrum")


# ---------------------------------------------------------------------------
# Frequency stacks + catalogs + formed beams
# (reference containers.py:2610-3059)
# ---------------------------------------------------------------------------


class FrequencyStack(FreqContainer, DataWeightContainer):
    """Frequency stack (reference containers.py:2610)."""

    _dataset_spec: ClassVar = {
        "stack": {
            "axes": ["freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "weight": {
            "axes": ["freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
    }

    _data_dset_name = "stack"
    _weight_dset_name = "weight"

    stack = dataset_property("stack")


class FrequencyStackByPol(FrequencyStack):
    """Frequency stack split by pol (reference containers.py:2642)."""

    _axes = ("pol",)

    _dataset_spec: ClassVar = {
        "stack": {
            "axes": ["pol", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "weight": {
            "axes": ["pol", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
    }

    @property
    def pol(self):
        return self.index_map["pol"]


class MockFrequencyStack(FrequencyStack):
    """Frequency stacks for multiple mock catalogs (reference containers.py:2668)."""

    _axes = ("mock",)

    _dataset_spec: ClassVar = {
        "stack": {
            "axes": ["mock", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "weight": {
            "axes": ["mock", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
    }


class MockFrequencyStackByPol(FrequencyStackByPol):
    """Per-pol frequency stacks for multiple mocks (reference containers.py:2692)."""

    _axes = ("mock",)

    _dataset_spec: ClassVar = {
        "stack": {
            "axes": ["mock", "pol", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "weight": {
            "axes": ["mock", "pol", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
    }


class Stack3D(FreqContainer, DataWeightContainer):
    """3D frequency stack (reference containers.py:2716)."""

    _axes = ("pol", "delta_ra", "delta_dec")

    _dataset_spec: ClassVar = {
        "stack": {
            "axes": ["pol", "delta_ra", "delta_dec", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
        "weight": {
            "axes": ["pol", "delta_ra", "delta_dec", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
    }

    _data_dset_name = "stack"
    _weight_dset_name = "weight"

    stack = dataset_property("stack")


class SourceCatalog(TableSpec):
    """Astronomical source catalog; ra/dec in ICRS (reference containers.py:2745)."""

    _table_spec: ClassVar = {
        "position": {
            "columns": [["ra", np.float64], ["dec", np.float64]],
            "axis": "object_id",
        }
    }

    _axes = ("object_id",)

    position = dataset_property("position")


class SpectroscopicCatalog(SourceCatalog):
    """Spectroscopic catalog with redshifts (reference containers.py:2761)."""

    _table_spec: ClassVar = {
        "redshift": {
            "columns": [["z", np.float64], ["z_error", np.float64]],
            "axis": "object_id",
        }
    }

    redshift = dataset_property("redshift")


class FormedBeam(FreqContainer, DataWeightContainer):
    """Formed beams (reference containers.py:2772)."""

    _axes = ("object_id", "pol")

    _dataset_spec: ClassVar = {
        "beam": {
            "axes": ["object_id", "pol", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["object_id", "pol", "freq"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "position": {
            "axes": ["object_id"],
            "dtype": np.dtype([("ra", np.float64), ("dec", np.float64)]),
            "initialise": True,
            "distributed": False,
        },
        "redshift": {
            "axes": ["object_id"],
            "dtype": np.dtype([("z", np.float64), ("z_error", np.float64)]),
            "initialise": False,
            "distributed": False,
        },
    }

    _data_dset_name = "beam"
    _weight_dset_name = "weight"

    beam = dataset_property("beam")
    position = dataset_property("position")

    @property
    def redshift(self):
        if "redshift" in self.datasets:
            return self.datasets["redshift"]
        raise KeyError("Dataset 'redshift' not initialised.")

    @property
    def frequency(self):
        return self.index_map["freq"]

    @property
    def id(self):
        return self.index_map["object_id"]

    @property
    def pol(self):
        return self.index_map["pol"]


class FormedBeamHA(FormedBeam):
    """Formed beams vs hour angle (reference containers.py:2843)."""

    _axes = ("ha",)

    _dataset_spec: ClassVar = {
        "beam": {
            "axes": ["object_id", "pol", "freq", "ha"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["object_id", "pol", "freq", "ha"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "object_ha": {
            "axes": ["object_id", "ha"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
    }

    @property
    def ha(self):
        return self.datasets["object_ha"]


class FormedBeamHAEW(FormedBeamHA):
    """Formed beams vs hour angle and EW baseline (reference containers.py:2886)."""

    _axes = ("ew",)

    _dataset_spec: ClassVar = {
        "beam": {
            "axes": ["object_id", "pol", "freq", "ew", "ha"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["object_id", "pol", "freq", "ew", "ha"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "object_ha": {
            "axes": ["object_id", "ha"],
            "dtype": np.float64,
            "initialise": True,
            "distributed": False,
        },
    }

    @property
    def ew(self):
        return self.index_map["ew"]


class FitFormedBeam(FormedBeam):
    """Formed beams fit to a beam model vs hour angle (reference containers.py:2930)."""

    _dataset_spec: ClassVar = {
        "background": {
            "axes": ["object_id", "pol", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight_background": {
            "axes": ["object_id", "pol", "freq"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "corr_background_beam": {
            "axes": ["object_id", "pol", "freq"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    background = dataset_property("background")
    weight_background = dataset_property("weight_background")
    corr_background_beam = dataset_property("corr_background_beam")


class FitFormedBeamEW(FitFormedBeam):
    """Fit formed beams, not collapsed over EW (reference containers.py:2973)."""

    _axes = ("ew",)

    _dataset_spec: ClassVar = {
        "beam": {
            "axes": ["object_id", "pol", "freq", "ew"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight": {
            "axes": ["object_id", "pol", "freq", "ew"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "background": {
            "axes": ["object_id", "pol", "freq", "ew"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "weight_background": {
            "axes": ["object_id", "pol", "freq", "ew"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "corr_background_beam": {
            "axes": ["object_id", "pol", "freq", "ew"],
            "dtype": np.float32,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    @property
    def ew(self):
        return self.index_map["ew"]


class FormedBeamMask(FreqContainer):
    """Mask of bad formed beams (reference containers.py:3025)."""

    _axes = ("object_id", "pol")

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["object_id", "pol", "freq"],
            "dtype": bool,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        }
    }

    mask = dataset_property("mask")


class FormedBeamHAMask(FormedBeamMask):
    """Formed beam mask vs hour angle (reference containers.py:3046)."""

    _axes = ("ha",)

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["object_id", "pol", "freq", "ha"],
            "dtype": bool,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        }
    }


# ---------------------------------------------------------------------------
# Localized RFI masks + bandpass + horizon (reference containers.py:3080-3409)
# ---------------------------------------------------------------------------


class LocalizedRFIMask(FreqContainer, TODContainer):
    """RFI mask per (freq, el, time) (reference containers.py:3080)."""

    _axes = ("el",)

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["freq", "el", "time"],
            "dtype": bool,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "frac_rfi": {
            "axes": ["freq", "el", "time"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    mask = dataset_property("mask")
    frac_rfi = dataset_property("frac_rfi")

    @property
    def el(self):
        return self.index_map["el"]


class LocalizedSiderealRFIMask(FreqContainer, SiderealContainer):
    """RFI mask per (freq, ra, el) (reference containers.py:3126)."""

    _axes = ("el",)

    _dataset_spec: ClassVar = {
        "mask": {
            "axes": ["freq", "ra", "el"],
            "dtype": bool,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "freq",
        },
        "frac_rfi": {
            "axes": ["freq", "ra", "el"],
            "dtype": np.float32,
            "initialise": False,
            "distributed": True,
            "distributed_axis": "freq",
        },
    }

    mask = dataset_property("mask")
    frac_rfi = dataset_property("frac_rfi")

    @property
    def el(self):
        return self.index_map["el"]


class VisBandpassWindow(FreqContainer):
    """HyFoReS bandpass gains + window (reference containers.py:3172)."""

    _axes = ("pol",)

    _dataset_spec: ClassVar = {
        "bandpass": {
            "axes": ["pol", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": False,
        },
        "window": {
            "axes": ["pol", "freq", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": False,
        },
    }

    bandpass = dataset_property("bandpass")
    window = dataset_property("window")


class VisBandpassCompensate(FreqContainer):
    """Window-compensated bandpass gains (reference containers.py:3204)."""

    _axes = ("pol",)

    _dataset_spec: ClassVar = {
        "comp_bandpass": {
            "axes": ["pol", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": False,
        },
        "sval": {
            "axes": ["pol", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": False,
        },
    }

    comp_bandpass = dataset_property("comp_bandpass")
    sval = dataset_property("sval")


class VisBandpassWindowBaseline(VisBandpassWindow):
    """Per-EW-baseline bandpass gains + window (reference containers.py:3236)."""

    _axes = ("ew",)

    _dataset_spec: ClassVar = {
        "bandpass": {
            "axes": ["pol", "ew", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": False,
        },
        "window": {
            "axes": ["pol", "ew", "freq", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": False,
        },
    }


class VisBandpassCompensateBaseline(VisBandpassCompensate):
    """Per-EW-baseline compensated bandpass (reference containers.py:3267)."""

    _axes = ("ew",)

    _dataset_spec: ClassVar = {
        "comp_bandpass": {
            "axes": ["pol", "ew", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": False,
        },
        "sval": {
            "axes": ["pol", "ew", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": False,
        },
    }


class VisBandpassWindowBaselineRA(SiderealContainer, VisBandpassWindowBaseline):
    """Per-baseline-and-RA bandpass window (reference containers.py:3298)."""

    _dataset_spec: ClassVar = {
        "bandpass": {
            "axes": ["pol", "ew", "ra", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "ra",
        },
        "window": {
            "axes": ["pol", "ew", "ra", "freq", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "ra",
        },
    }


class VisBandpassCompensateBaselineRA(SiderealContainer, VisBandpassCompensateBaseline):
    """Per-baseline-and-RA compensated bandpass (reference containers.py:3335)."""

    _dataset_spec: ClassVar = {
        "comp_bandpass": {
            "axes": ["pol", "ew", "ra", "freq"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "ra",
        },
        "rank": {
            "axes": ["pol", "ew", "ra"],
            "dtype": np.complex128,
            "initialise": True,
            "distributed": True,
            "distributed_axis": "ra",
        },
    }

    rank = dataset_property("rank")


class HorizonLimit(ContainerBase):
    """Horizon altitude vs azimuth (reference containers.py:3372)."""

    _axes = ("azimuth",)

    _dataset_spec: ClassVar = {
        "altitude": {
            "axes": ["azimuth"],
            "dtype": float,
            "initialise": True,
            "distributed": False,
        }
    }

    altitude = dataset_property("altitude")

    @property
    def azimuth(self):
        return self.index_map["azimuth"]

    def get_horizon_limit(self, az):
        """Interpolate the horizon altitude at azimuth ``az`` (degrees)."""
        return np.interp(
            az, self.azimuth, np.asarray(self.altitude), period=360.0
        )


# ---------------------------------------------------------------------------
# Storage bit-truncation table.
#
# The reference marks these (container, dataset) pairs for lossy mantissa
# truncation before compression (reference draco/core/containers.py:510,523,
# 547,568,839,852,1055,1068,1079,1267,...). ``True`` requests a fixed
# relative precision; a dict derives the per-element tolerance from the
# named inverse-variance weight dataset (see draco_tpu_torch.core.truncate).
# Applied copy-on-write so mixin-owned spec entries are never mutated.
# ---------------------------------------------------------------------------

_TRUNCATE_SPEC = {
    "SiderealStream": {
        "vis": {"weight_dataset": "vis_weight"},
        "vis_weight": True,
        "sample_variance": True,
        "effective_ra": True,
    },
    "TimeStream": {
        "vis": {"weight_dataset": "vis_weight"},
        "vis_weight": True,
    },
    "TrackBeam": {
        "beam": {"weight_dataset": "weight"},
        "weight": True,
        "sample_variance": True,
    },
    # NB the reference points VisGridStream.vis at a "weight" dataset that
    # does not exist there (its weights live in "vis_weight"); the save path
    # degrades that to relative truncation, which is also what happens
    # upstream.
    "VisGridStream": {
        "vis": {"weight_dataset": "weight"},
        "vis_weight": True,
    },
    "RingMap": {
        "map": {"weight_dataset": "weight"},
        "weight": True,
        "dirty_beam": True,
        "dirty_beam_power": True,
        "rms": True,
    },
    "DelayTransform": {
        "spectrum": True,
        "weight": True,
    },
    "LocalizedRFIMask": {"frac_rfi": True},
    "LocalizedSiderealRFIMask": {"frac_rfi": True},
}


def _apply_truncate_spec() -> None:
    g = globals()
    for clsname, entries in _TRUNCATE_SPEC.items():
        cls = g[clsname]
        own = vars(cls).get("_dataset_spec")
        if own is None:
            own = {}
            cls._dataset_spec = own
        merged = cls.dataset_spec()
        for dsname, tval in entries.items():
            entry = dict(merged.get(dsname, {}))
            entry["truncate"] = tval
            own[dsname] = entry


_apply_truncate_spec()
