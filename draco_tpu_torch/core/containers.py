"""Typed, axis-labelled data containers whose numeric datasets are tensors.

Port of ``draco_tpu.core.containers``.  Every container declares named
axes and a ``_dataset_spec`` (per dataset: axes, dtype, distribution), as
in the JAX package and the reference it re-provides (reference
``draco/core/containers.py``).  What changes is the storage:

* numeric datasets (float, complex, integer) are ``torch.Tensor``s on the
  container's device, written in place (``ds[sel] = value``);
* structured, string and bool datasets stay numpy arrays on the host:
  torch has no structured dtypes, and these are index-like data;
* index maps, reverse maps and attributes are host data (numpy / Python).

A container made with ``axes_from=`` takes that container's device unless
``device=`` names one; otherwise ``device`` goes through
:func:`draco_tpu_torch.device.resolve` (None: the process default, the first
CUDA card, or a raise without one).  ``np.asarray(ds)`` copies a dataset to
the host; ``ds[:]`` returns the tensor itself.

There is one device and no mesh (:mod:`draco_tpu_torch.parallel.mesh`), so
``redistribute`` only records the nominally distributed axis.

HDF5 ``save``/``from_file`` keep the JAX package's layout: datasets at the
root with an ``axis`` attribute, ``index_map/`` and ``reverse_map/`` groups,
attributes (JSON-tagged where HDF5 cannot hold them) and the pipeline
provenance in ``history``.  Files written by either package read in the
other.  ``h5py`` is imported only by ``save`` and ``from_file``.
"""

from __future__ import annotations

import json
import logging
from typing import Any, ClassVar

import numpy as np
import torch

from ..device import resolve

logger = logging.getLogger(__name__)

# Storage compression defaults, mirroring the reference container chunk
# specs (reference draco/core/containers.py:500-513).
COMPRESSION = "gzip"
COMPRESSION_OPTS = 4

_UNSET = object()

_TORCH_DTYPES = {
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
}


def torch_dtype(dtype) -> torch.dtype | None:
    """The torch dtype a dataset of numpy ``dtype`` is stored in.

    Numeric dtypes (float, complex, integer; native byte order) map onto
    their torch counterparts.  None means the data stays numpy: bool,
    structured, string and object dtypes.
    """
    dt = np.dtype(dtype)
    if dt.names is not None or dt.kind not in "fciu":
        return None
    return _TORCH_DTYPES.get(dt.newbyteorder("="))


def _to_numpy(arr) -> np.ndarray:
    """Host copy of a tensor (numpy arrays pass through)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _as_storage(data, device: torch.device):
    """``data`` as a dataset holds it: a tensor on ``device`` for numeric
    data, a numpy array otherwise.  A tensor is moved, never copied when
    it already lies on ``device``."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    data = np.asarray(data)
    if torch_dtype(data.dtype) is None:
        return data
    return torch.as_tensor(np.ascontiguousarray(data)).to(device)


def _copy_array(arr):
    return arr.clone() if isinstance(arr, torch.Tensor) else arr.copy()


def _select(arr, axis: int, sel):
    """``arr`` restricted to ``sel`` (slice or index array) along ``axis``."""
    idx = _sel_to_indices(sel, arr.shape[axis])
    if isinstance(arr, torch.Tensor):
        return arr.index_select(axis, torch.as_tensor(idx, dtype=torch.long, device=arr.device))
    return np.take(arr, idx, axis=axis)


class Dataset:
    """A named array with labelled axes and attributes.

    The array is a tensor (numeric data, on the container's device) or a
    numpy array (bool, structured and string data).  ``ds[sel] = value``
    writes in place; a value on the host or on another device is moved to
    the dataset's device and cast to its dtype.
    """

    def __init__(
        self,
        name: str,
        data,
        axes: tuple[str, ...],
        attrs: dict | None = None,
        distributed: bool = False,
        distributed_axis: str | None = None,
        spec: dict | None = None,
    ):
        self.name = name
        self._data = data
        self.attrs = dict(attrs or {})
        self.attrs.setdefault("axis", tuple(axes))
        self.distributed = distributed
        self.distributed_axis = distributed_axis
        self.spec = dict(spec or {})

    # -- array access -----------------------------------------------------
    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, value):
        if tuple(value.shape) != tuple(self._data.shape):
            raise ValueError(
                f"Dataset {self.name!r}: shape {tuple(value.shape)} != "
                f"{tuple(self._data.shape)}"
            )
        if isinstance(self._data, torch.Tensor):
            value = _as_storage(value, self._data.device)
        self._data = value

    @property
    def axes(self) -> tuple[str, ...]:
        return tuple(self.attrs["axis"])

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """``torch.dtype`` of tensor data, ``numpy.dtype`` of host data."""
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.ndim

    # Reference-compat alias: the global array (no per-rank locality here).
    @property
    def local_array(self):
        return self._data

    def __getitem__(self, sel):
        if sel is Ellipsis or (isinstance(sel, slice) and sel == slice(None)):
            return self._data
        return self._data[sel]

    def __setitem__(self, sel, value):
        if isinstance(self._data, torch.Tensor):
            if isinstance(value, torch.Tensor):
                value = value.to(device=self._data.device, dtype=self._data.dtype)
            elif not np.isscalar(value):
                value = torch.as_tensor(np.asarray(value)).to(
                    device=self._data.device, dtype=self._data.dtype
                )
            self._data[sel] = value
        else:
            self._data[sel] = _to_numpy(value) if isinstance(value, torch.Tensor) else value

    def __array__(self, dtype=None, copy=None):
        arr = _to_numpy(self._data)
        return arr.astype(dtype) if dtype is not None else arr

    def __len__(self):
        return len(self._data)

    def __repr__(self):
        return (
            f"<Dataset {self.name!r} axes={self.axes} shape={self.shape} "
            f"dtype={self.dtype}>"
        )

    # -- distribution -------------------------------------------------------
    def to_device(self) -> "Dataset":
        """Placement over the mesh: with one device, nothing moves."""
        return self

    def redistribute(self, axis_name: str | None) -> "Dataset":
        """Record ``axis_name`` as the distributed axis.

        With one device there is nothing to reshard: this is the JAX
        package's no-mesh path, metadata only.
        """
        if not self.distributed:
            return self
        if axis_name is not None and axis_name not in self.axes:
            return self
        self.distributed_axis = axis_name
        return self


def dataset_property(name: str, doc: str = ""):
    """Class property returning the named dataset."""

    def fget(self):
        return self.datasets[name]

    return property(fget, doc=doc or f"The {name!r} dataset.")


def make_freq_map(freq) -> np.ndarray:
    """Build a structured frequency index map (centre/width in MHz)."""
    freq = np.asarray(freq)
    if freq.dtype.names and "centre" in freq.dtype.names:
        return freq
    freq = np.atleast_1d(freq)
    out = np.zeros(len(freq), dtype=[("centre", np.float64), ("width", np.float64)])
    out["centre"] = freq
    out["width"] = np.abs(np.median(np.diff(freq))) if len(freq) > 1 else 1.0
    return out


def make_prod_map(prod) -> np.ndarray:
    prod = np.asarray(prod)
    if prod.dtype.names:
        return prod
    out = np.zeros(len(prod), dtype=[("input_a", np.int64), ("input_b", np.int64)])
    out["input_a"] = prod[:, 0]
    out["input_b"] = prod[:, 1]
    return out


def default_stack_maps(nprod: int):
    """Identity stack index/reverse maps (each product its own stack)."""
    fwd = np.zeros(nprod, dtype=[("prod", "<u4"), ("conjugate", "u1")])
    fwd["prod"] = np.arange(nprod)
    rev = np.zeros(nprod, dtype=[("stack", "<u4"), ("conjugate", "u1")])
    rev["stack"] = np.arange(nprod)
    return fwd, rev


class ContainerBase:
    """Base for all typed containers.

    Subclasses declare ``_axes`` (named axes) and ``_dataset_spec``
    (datasets over those axes).  Constructor keyword args give axis
    definitions (array, or int for a default integer/uniform axis);
    ``axes_from=`` copies missing axes from another container and
    ``attrs_from=`` copies attributes (the reference container
    construction protocol, reference test/test_containers.py:25-39).
    ``device=`` places the numeric datasets; left out, the container
    takes the device of ``axes_from``, or :func:`~draco_tpu_torch.device.resolve`'s.
    """

    _axes: ClassVar[tuple[str, ...]] = ()
    _dataset_spec: ClassVar[dict[str, dict]] = {}

    def __init__(
        self,
        *,
        axes_from: "ContainerBase | None" = None,
        attrs_from: "ContainerBase | None" = None,
        skip_datasets: bool = False,
        distributed: bool = True,
        comm: Any = None,  # accepted for API parity; unused (no MPI)
        device=None,
        **kwargs,
    ):
        self.index_map: dict[str, np.ndarray] = {}
        self.reverse_map: dict[str, np.ndarray] = {}
        self.attrs: dict[str, Any] = {}
        self.datasets: dict[str, Dataset] = {}
        self.distributed = distributed
        self.comm = comm
        self.history: dict[str, Any] = {}
        if device is None and axes_from is not None:
            self.device = axes_from.device
        else:
            self.device = resolve(device)

        # Stage 1: axes from explicit kwargs, falling back to axes_from.
        overridden: set[str] = set()
        for ax in self.axes_spec():
            if ax in kwargs:
                overridden.add(ax)
                val = kwargs.pop(ax)
                if val is not None and val is not _UNSET:
                    self.create_index_map(ax, self._convert_axis(ax, val))
                elif val is None:
                    # explicit None: suppress inheritance, let subclass derive
                    kwargs[ax] = None
                    continue
            elif axes_from is not None and ax in axes_from.index_map:
                self.create_index_map(ax, axes_from.index_map[ax])
        self._extra_kwargs = kwargs

        if axes_from is not None:
            for name, rmap in axes_from.reverse_map.items():
                # only for axes inherited from axes_from: a reverse_map
                # indexes into its own axis, so copying it onto an axis the
                # caller replaced would leave a stale, out-of-range mapping
                if name in self.index_map and name not in overridden:
                    self.reverse_map[name] = np.asarray(rmap).copy()

        # Stage 2: subclass hook for derived axes (stack from prod, ...).
        self._finalise_axes(axes_from)

        # Stage 3: attributes.
        if attrs_from is not None:
            for k, v in attrs_from.attrs.items():
                self.attrs.setdefault(k, v)
            self.history.update(getattr(attrs_from, "history", {}))

        # Stage 4: datasets.
        if not skip_datasets:
            for name, spec in self.dataset_spec().items():
                if spec.get("initialise", False):
                    self.add_dataset(name)

        # Anything no stage (or subclass _finalise_axes hook) consumed is
        # a typo'd axis or argument; explicit-None axis suppressions from
        # stage 1 are expected leftovers.
        axes_known = set(self.axes_spec())
        unknown = [
            k
            for k, v in self._extra_kwargs.items()
            if not (k in axes_known and v is None)
        ]
        if unknown:
            raise TypeError(
                f"{type(self).__name__}: unknown constructor argument(s) "
                f"{sorted(unknown)}; valid axes: {sorted(axes_known)}"
            )

    # -- subclass hooks -----------------------------------------------------
    def _finalise_axes(self, axes_from: "ContainerBase | None") -> None:
        """Derive axes that depend on other axes; override in subclasses."""

    # -- class-level spec assembly -------------------------------------------
    @classmethod
    def axes_spec(cls) -> tuple[str, ...]:
        axes: list[str] = []
        for klass in reversed(cls.__mro__):
            for ax in vars(klass).get("_axes", ()):
                if ax not in axes:
                    axes.append(ax)
        return tuple(axes)

    @classmethod
    def dataset_spec(cls) -> dict[str, dict]:
        spec: dict[str, dict] = {}
        for klass in reversed(cls.__mro__):
            for name, ds in vars(klass).get("_dataset_spec", {}).items():
                spec[name] = ds
        return spec

    # -- axis handling --------------------------------------------------------
    def _convert_axis(self, name: str, value):
        """Convert an axis constructor argument into an index map array."""
        if isinstance(value, ContainerBase):
            return value.index_map[name]
        if np.isscalar(value) and np.issubdtype(type(value), np.integer):
            n = int(value)
            if name == "ra":
                return np.linspace(0.0, 360.0, n, endpoint=False)
            return np.arange(n)
        value = np.asarray(value)
        if name == "freq":
            return make_freq_map(value)
        if name == "prod":
            return make_prod_map(value)
        return value

    def create_index_map(self, name: str, imap) -> None:
        self.index_map[name] = np.asarray(imap)

    def create_reverse_map(self, name: str, rmap) -> None:
        self.reverse_map[name] = np.asarray(rmap)

    # -- datasets ----------------------------------------------------------
    def add_dataset(self, name: str, data=None) -> Dataset:
        """Create dataset ``name`` of the spec: zeros, or ``data`` (moved to
        the container's device; its dtype is kept)."""
        spec = self.dataset_spec()[name]
        axes = tuple(spec["axes"])
        missing = [ax for ax in axes if ax not in self.index_map]
        if missing:
            raise ValueError(
                f"Cannot create dataset {name!r}: axes {missing} undefined on "
                f"{type(self).__name__} (define via constructor or axes_from)"
            )
        shape = tuple(len(self.index_map[ax]) for ax in axes)
        dtype = np.dtype(spec.get("dtype", np.float64))
        if data is None:
            tdt = torch_dtype(dtype)
            if tdt is None:
                data = np.zeros(shape, dtype=dtype)
            else:
                data = torch.zeros(shape, dtype=tdt, device=self.device)
        else:
            data = _as_storage(data, self.device)
        if tuple(data.shape) != shape:
            raise ValueError(
                f"Dataset {name!r}: supplied shape {tuple(data.shape)} != "
                f"axis shape {shape}"
            )
        ds = Dataset(
            name,
            data,
            axes,
            distributed=spec.get("distributed", False) and self.distributed,
            distributed_axis=spec.get("distributed_axis"),
            spec=spec,
        )
        self.datasets[name] = ds
        return ds

    def __getitem__(self, name: str) -> Dataset:
        return self.datasets[name]

    def __contains__(self, name: str) -> bool:
        return name in self.datasets

    def __delitem__(self, name: str) -> None:
        del self.datasets[name]

    # -- distribution -----------------------------------------------------
    def redistribute(self, axis_name: str | None) -> "ContainerBase":
        """Record ``axis_name`` as every distributed dataset's split axis
        (datasets without it are left as they are, reference
        draco/analysis/transform.py:592)."""
        for ds in self.datasets.values():
            ds.redistribute(axis_name)
        return self

    def to_device(self) -> "ContainerBase":
        """Placement over the mesh: with one device, nothing moves."""
        return self

    # -- copying ------------------------------------------------------------
    def copy(self, shared: tuple[str, ...] = ()) -> "ContainerBase":
        """Deep copy; datasets named in ``shared`` share storage."""
        new = self.__class__.__new__(self.__class__)
        new.index_map = {k: np.asarray(v).copy() for k, v in self.index_map.items()}
        new.reverse_map = {k: np.asarray(v).copy() for k, v in self.reverse_map.items()}
        new.attrs = dict(self.attrs)
        new.history = dict(self.history)
        new.distributed = self.distributed
        new.comm = self.comm
        new.device = self.device
        new._extra_kwargs = {}
        new.datasets = {}
        for name, ds in self.datasets.items():
            data = ds._data if name in shared else _copy_array(ds._data)
            new.datasets[name] = Dataset(
                name,
                data,
                ds.axes,
                attrs=dict(ds.attrs),
                distributed=ds.distributed,
                distributed_axis=ds.distributed_axis,
                spec=ds.spec,
            )
        return new

    # -- IO ------------------------------------------------------------------
    def save(self, path: str, mode: str = "w", truncate: bool = False) -> None:
        """Write to HDF5 in the JAX package's layout.

        With ``truncate=True``, datasets whose spec carries a ``truncate``
        entry have sub-noise mantissa bits rounded away before compression
        (:mod:`draco_tpu_torch.core.truncate`); off by default, so saving
        is lossless unless asked.
        """
        h5py = _import_h5py()

        from . import truncate as _trunc

        with h5py.File(path, mode) as f:
            f.attrs["__draco_tpu_container__"] = type(self).__name__
            _write_attrs(f.attrs, self.attrs)
            im = f.create_group("index_map")
            for name, arr in self.index_map.items():
                im.create_dataset(name, data=_h5_safe(arr))
            if self.reverse_map:
                rm = f.create_group("reverse_map")
                for name, arr in self.reverse_map.items():
                    d = rm.create_dataset(name, data=_h5_safe(arr))
                    # record which axis indexes the rows, so that a later
                    # partial read can tell exactly when the map goes stale
                    arr_np = np.asarray(arr)
                    nrow = arr_np.shape[0] if arr_np.ndim else 0
                    src = [
                        ax
                        for ax, imap in self.index_map.items()
                        if np.asarray(imap).ndim
                        and np.asarray(imap).shape[0] == nrow
                        and ax != name
                    ]
                    if len(src) == 1:
                        d.attrs["__source_axis__"] = src[0]
            for name, ds in self.datasets.items():
                arr = _h5_safe(_to_numpy(ds._data))
                tspec = ds.spec.get("truncate") if truncate else None
                if tspec:
                    wname = tspec.get("weight_dataset") if isinstance(tspec, dict) else None
                    wds = self.datasets.get(wname) if wname else None
                    weight = _to_numpy(wds._data) if wds is not None else None
                    arr = _trunc.truncate_dataset(arr, tspec, weight)
                kwargs = {}
                chunks = ds.spec.get("chunks")
                if chunks is not None and arr.size:
                    chunks = tuple(max(1, min(c, s)) for c, s in zip(chunks, arr.shape))
                    kwargs = {
                        "chunks": chunks,
                        "compression": ds.spec.get("compression", COMPRESSION),
                        "compression_opts": ds.spec.get("compression_opts", COMPRESSION_OPTS),
                    }
                d = f.create_dataset(name, data=arr, **kwargs)
                d.attrs["axis"] = np.array([a.encode() for a in ds.axes])
                _write_attrs(d.attrs, {k: v for k, v in ds.attrs.items() if k != "axis"})
            hist = f.create_group("history")
            _write_attrs(
                hist.attrs,
                {k: (v if isinstance(v, str) else _ForceJSON(v)) for k, v in self.history.items()},
            )

    @classmethod
    def from_file(
        cls,
        path: str,
        *,
        distributed: bool = True,
        comm=None,
        sel: dict | None = None,
        device=None,
        **kwargs,
    ):
        """Read a container back from HDF5 (either package's files).

        ``sel`` optionally maps axis name -> slice/index-array for partial
        reads (the reference's fsel/isel/tsel selections, reference
        test/test_selections.py:33-60).  Numeric datasets go to ``device``
        (:func:`~draco_tpu_torch.device.resolve`).
        """
        if kwargs:
            # a misspelled sel=/distributed= must not be dropped
            raise TypeError(
                f"{cls.__name__}.from_file() got unexpected keyword "
                f"argument(s): {sorted(kwargs)}"
            )
        device = resolve(device)
        h5py = _import_h5py()
        sel = dict(sel or {})
        with h5py.File(path, "r") as f:
            clsname = f.attrs.get("__draco_tpu_container__")
            klass = cls
            if clsname and (cls is ContainerBase or str(clsname) != cls.__name__):
                klass = _container_registry().get(str(clsname), cls)
            self = klass.__new__(klass)
            self.index_map = {}
            self.reverse_map = {}
            self.attrs = {}
            self.datasets = {}
            self.history = {}
            self.distributed = distributed
            self.comm = comm
            self.device = device
            self._extra_kwargs = {}

            _decode_attrs(f.attrs, self.attrs)
            orig_len = {}
            for name, d in f["index_map"].items():
                arr = d[:]
                orig_len[name] = arr.shape[0] if arr.ndim else 0
                if name in sel:
                    arr = arr[sel[name]]
                # a structured field named after a selected axis indexes
                # into it, and now refers to the unselected ordering
                if arr.dtype.names:
                    stale = [fn for fn in arr.dtype.names if fn in sel]
                    if stale:
                        logger.warning(
                            "%s: index_map[%r] field(s) %s index into "
                            "selected axes; those indices refer to the "
                            "UNSELECTED axis ordering",
                            path,
                            name,
                            stale,
                        )
                self.index_map[name] = arr
            selected_lens = {orig_len.get(ax) for ax in sel}
            if "reverse_map" in f:
                for name, d in f["reverse_map"].items():
                    arr = d[:]
                    # a reverse map indexes into its own axis and is indexed
                    # by a source axis: a selection on either makes it
                    # stale.  Files that record the source axis say so
                    # exactly; foreign files fall back to matching lengths.
                    src_axis = d.attrs.get("__source_axis__")
                    if isinstance(src_axis, bytes):
                        src_axis = src_axis.decode()
                    if src_axis is not None:
                        stale = name in sel or src_axis in sel
                    else:
                        stale = name in sel or (sel and arr.shape[0] in selected_lens)
                    if stale:
                        logger.warning(
                            "%s: dropping reverse_map[%r] invalidated by the axis selection",
                            path,
                            name,
                        )
                        continue
                    self.reverse_map[name] = arr
            spec = klass.dataset_spec()
            for name, d in f.items():
                if name in ("index_map", "reverse_map", "history"):
                    continue
                # axis labels may be bytes (our writer) or vlen unicode
                # (reference/caput-written files)
                axes = tuple(a.decode() if isinstance(a, bytes) else str(a) for a in d.attrs["axis"])
                arr = d[:]
                for i, ax in enumerate(axes):
                    if ax in sel:
                        arr = np.take(arr, _sel_to_indices(sel[ax], arr.shape[i]), axis=i)
                dspec = spec.get(name, {})
                ds_attrs: dict[str, Any] = {}
                _decode_attrs(d.attrs, ds_attrs)
                ds_attrs["axis"] = axes
                self.datasets[name] = Dataset(
                    name,
                    _as_storage(arr, device),
                    axes,
                    attrs=ds_attrs,
                    distributed=dspec.get("distributed", False) and distributed,
                    distributed_axis=dspec.get("distributed_axis"),
                    spec=dspec,
                )
            if "history" in f:
                _decode_attrs(f["history"].attrs, self.history)
        return self

    def __repr__(self):
        dss = ", ".join(f"{n}{list(d.shape)}" for n, d in self.datasets.items())
        return f"<{type(self).__name__} {dss}>"


def _import_h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "draco_tpu_torch needs the h5py package to read or write container files"
        ) from e
    return h5py


def _decode_attrs(h5attrs, target: dict) -> None:
    for k, v in h5attrs.items():
        k = str(k)
        if k.startswith("__"):
            continue
        if k.endswith("!json"):
            # our writer's tag for non-native attrs; a foreign file may
            # name an attr '*!json' with a non-JSON payload: keep it
            try:
                target[k[: -len("!json")]] = json.loads(v)
            except (TypeError, ValueError):
                target[k] = v
        else:
            target[k] = v


class _ForceJSON:
    """Marker: always JSON-encode this attr value (used for history)."""

    def __init__(self, value):
        self.value = value


def _write_attrs(h5attrs, attrs: dict) -> None:
    """Write attrs to an HDF5 attribute set, JSON-tagging as needed.

    Attrs h5py cannot store natively (dicts, lists of mixed type, ...) are
    JSON encoded under ``<name>!json``, which :meth:`ContainerBase.from_file`
    decodes.  A tagged key and a literal attr of the same encoded name
    would shadow one another on read, so the pair is rejected.
    """
    for k in attrs:
        if k.endswith("!json") and k[: -len("!json")] in attrs:
            raise ValueError(
                f"attribute name collision: {k!r} shadows the JSON-"
                f"tagged encoding of {k[:-len('!json')]!r}"
            )
    for k, v in attrs.items():
        if isinstance(v, _ForceJSON):
            h5attrs[k + "!json"] = json.dumps(v.value)
            continue
        try:
            h5attrs[k] = v
        except TypeError:
            h5attrs[k + "!json"] = json.dumps(v)


def _h5_safe(arr: np.ndarray) -> np.ndarray:
    """Convert unicode string dtypes to bytes for HDF5 storage."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "U":
        return arr.astype(f"S{arr.dtype.itemsize // 4 or 1}")
    if arr.dtype.names:
        new_dtype = []
        needs_convert = False
        for name in arr.dtype.names:
            dt = arr.dtype[name]
            if dt.kind == "U":
                new_dtype.append((name, f"S{dt.itemsize // 4 or 1}"))
                needs_convert = True
            else:
                new_dtype.append((name, dt))
        if needs_convert:
            out = np.zeros(arr.shape, dtype=new_dtype)
            for name in arr.dtype.names:
                out[name] = arr[name]
            return out
    return arr


def _sel_to_indices(s, n):
    if isinstance(s, slice):
        return np.arange(n)[s]
    return np.asarray(s)


def _container_registry() -> dict[str, type]:
    # the full class zoo must be imported before names are resolved
    from . import containers_spec  # noqa: F401

    reg = {}
    stack = [ContainerBase]
    while stack:
        klass = stack.pop()
        reg[klass.__name__] = klass
        stack.extend(klass.__subclasses__())
    return reg


def empty_like(cont: ContainerBase, **kwargs) -> ContainerBase:
    """New zeroed container with the same axes/attrs (and device) as ``cont``."""
    return cont.__class__(axes_from=cont, attrs_from=cont, **kwargs)


def concatenate_tod(containers_list):
    """Concatenate containers along their time-like axis, on their device.

    Equivalent of ``caput.containers.tod.concatenate`` (used by the
    reference SiderealGrouper, draco/analysis/sidereal.py:148).
    """
    first = containers_list[0]
    if len(containers_list) == 1:
        return first.copy()
    taxis = "time" if "time" in first.index_map else "ra"
    new_time = np.concatenate([np.asarray(c.index_map[taxis]) for c in containers_list])
    new = first.__class__(axes_from=first, attrs_from=first, **{taxis: new_time})
    for name, ds in first.datasets.items():
        if taxis in ds.axes:
            ax = list(ds.axes).index(taxis)
            parts = [c.datasets[name][:] for c in containers_list]
            if isinstance(ds._data, torch.Tensor):
                arr = torch.cat([p.to(first.device) for p in parts], dim=ax)
            else:
                arr = np.concatenate(parts, axis=ax)
        else:
            arr = ds[:]
        if name not in new.datasets:
            new.add_dataset(name)
        new.datasets[name][:] = arr
        # carry per-dataset metadata (units, calibration tags, ...)
        new.datasets[name].attrs.update({k: v for k, v in ds.attrs.items() if k != "axis"})
    return new


def copy_datasets_filter(
    source: ContainerBase,
    dest: ContainerBase,
    axis: str | tuple[str, ...] = (),
    selection: dict | None = None,
    exclude_axes: tuple[str, ...] | None = None,
) -> None:
    """Copy datasets from source to dest applying per-axis selections.

    Mirrors the reference helper used to down-select containers
    (reference test/test_containers.py:87-142): ``axis`` names the
    filtered axes; a non-dict ``selection`` applies to the single named
    axis, and a dict selection's keys must match ``axis`` when given.
    Tensors are selected on their device.
    """
    axis = (axis,) if isinstance(axis, str) else tuple(axis)
    if selection is None:
        selection = {}
    if not isinstance(selection, dict):
        if len(axis) != 1:
            raise ValueError(
                f"a non-dict selection needs exactly one axis name, got axis={axis!r}"
            )
        selection = {axis[0]: selection}
    else:
        selection = dict(selection)
        if axis and set(axis) != set(selection):
            raise ValueError(
                f"axis argument {sorted(axis)} does not match selection keys {sorted(selection)}"
            )
    exclude_axes = tuple(exclude_axes or ())
    for name, ds in source.datasets.items():
        if name not in dest.dataset_spec():
            continue
        if any(ax in ds.axes for ax in exclude_axes):
            continue
        arr = ds._data
        for i, ax in enumerate(ds.axes):
            if ax in selection:
                arr = _select(arr, i, selection[ax])
        if name not in dest.datasets:
            dest.add_dataset(name, data=_copy_array(arr) if arr is ds._data else arr)
        else:
            dest.datasets[name][:] = arr


# ---------------------------------------------------------------------------
# Structural base containers (reference draco/core/containers.py:83-467)
# ---------------------------------------------------------------------------


class TODContainer(ContainerBase):
    """A container with a time axis (reference containers.py:83)."""

    _axes = ("time",)

    @property
    def time(self):
        t = self.index_map["time"]
        if t.dtype.names and "ctime" in t.dtype.names:
            return t["ctime"]
        return t


class FreqContainer(ContainerBase):
    """A container with a frequency axis (reference containers.py:362)."""

    _axes = ("freq",)

    def _convert_axis(self, name, value):
        if name == "freq" and np.isscalar(value) and np.issubdtype(type(value), np.integer):
            return make_freq_map(np.linspace(800.0, 400.0, int(value), endpoint=False))
        return super()._convert_axis(name, value)

    @property
    def freq(self):
        f = self.index_map["freq"]
        if f.dtype.names and "centre" in f.dtype.names:
            return f["centre"]
        return f


class SiderealContainer(ContainerBase):
    """A container with a right-ascension axis (reference containers.py:386)."""

    _axes = ("ra",)

    @property
    def ra(self):
        return self.index_map["ra"]


class MContainer(ContainerBase):
    """A container with harmonic m and msign axes (reference containers.py:422)."""

    _axes = ("m", "msign")

    def __init__(self, mmax: int | None = None, oddra: bool | None = None, **kwargs):
        if mmax is not None:
            kwargs["m"] = np.arange(mmax + 1)
        kwargs.setdefault("msign", np.array(["+", "-"]))
        super().__init__(**kwargs)
        if oddra is not None:
            self.attrs["oddra"] = bool(oddra)

    def _finalise_axes(self, axes_from):
        # Derive oddra/m from a sidereal container when transforming.
        if "m" not in self.index_map and axes_from is not None:
            if "ra" in axes_from.index_map:
                nra = len(axes_from.index_map["ra"])
                self.create_index_map("m", np.arange(nra // 2 + 1))
                self.attrs["oddra"] = bool(nra % 2)

    @property
    def mmax(self) -> int:
        return len(self.index_map["m"]) - 1

    @property
    def oddra(self) -> bool:
        return bool(self.attrs.get("oddra", False))


class DataWeightContainer(ContainerBase):
    """Base for containers with a primary data + weight pair."""

    _data_dset_name: ClassVar[str] = "data"
    _weight_dset_name: ClassVar[str] = "weight"

    @property
    def data(self):
        return self.datasets[self._data_dset_name]

    @property
    def weight(self):
        return self.datasets[self._weight_dset_name]


class VisBase(DataWeightContainer):
    """Base for visibility containers (reference containers.py:94)."""

    _data_dset_name = "vis"
    _weight_dset_name = "vis_weight"

    @property
    def vis(self):
        return self.datasets["vis"]

    @property
    def weight(self):
        return self.datasets["vis_weight"]


class VisContainer(VisBase):
    """Visibilities with input/prod/stack index maps (reference containers.py:109).

    ``stack=None`` suppresses inheritance and builds identity stack maps
    from ``prod`` (the ExpandProducts convention, reference
    draco/synthesis/stream.py:216-230).
    """

    _axes = ("input", "prod", "stack")

    def __init__(self, *args, reverse_map_stack=None, **kwargs):
        self._reverse_map_stack = reverse_map_stack
        super().__init__(*args, **kwargs)

    def _convert_axis(self, name, value):
        if name == "input" and np.isscalar(value) and np.issubdtype(type(value), np.integer):
            return np.arange(int(value))
        return super()._convert_axis(name, value)

    def _finalise_axes(self, axes_from):
        super()._finalise_axes(axes_from)
        # Auto-construct full-triangle prod map from inputs if missing
        # (reference containers.py:156-161).
        if "prod" not in self.index_map and "input" in self.index_map:
            nfeed = len(self.index_map["input"])
            self.create_index_map(
                "prod",
                make_prod_map(np.array([[fi, fj] for fi in range(nfeed) for fj in range(fi, nfeed)])),
            )
        stack_arg = self._extra_kwargs.pop("stack", _UNSET)
        if "prod" in self.index_map and (stack_arg is None or "stack" not in self.index_map):
            nprod = len(self.index_map["prod"])
            fwd, rev = default_stack_maps(nprod)
            self.create_index_map("stack", fwd)
            self.create_reverse_map("stack", rev)
        if self._reverse_map_stack is not None:
            self.create_reverse_map("stack", np.asarray(self._reverse_map_stack))
        # Default input axis from prod if missing.
        if "input" not in self.index_map and "prod" in self.index_map:
            prod = self.index_map["prod"]
            ninput = int(max(prod["input_a"].max(), prod["input_b"].max())) + 1
            self.create_index_map("input", np.arange(ninput))

    @property
    def prod(self):
        return self.index_map["prod"]

    @property
    def stack(self):
        return self.index_map["stack"]

    @property
    def is_stacked(self) -> bool:
        return len(self.stack) != len(self.prod)

    @property
    def prodstack(self):
        """Input-pairs representative of each stack entry (conjugation applied)."""
        if not self.is_stacked:
            return self.prod
        t = self.prod[self.index_map["stack"]["prod"]]
        conj = self.stack["conjugate"]
        out = t.copy()
        out["input_a"] = np.where(conj, t["input_b"], t["input_a"])
        out["input_b"] = np.where(conj, t["input_a"], t["input_b"])
        return out

    @property
    def input(self):
        return self.index_map["input"]

    @property
    def nstack(self) -> int:
        return len(self.index_map["stack"])


class SampleVarianceContainer(ContainerBase):
    """Base adding sample mean/variance over a component axis.

    The component axis holds the upper triangle of the real/imag
    covariance: [(real,real), (real,imag), (imag,imag)]
    (reference containers.py:236-360).  The derived views below are host
    numpy arrays, as in the JAX package.
    """

    _axes = ("component",)

    def _finalise_axes(self, axes_from):
        super()._finalise_axes(axes_from)
        if "component" not in self.index_map:
            self.create_index_map(
                "component",
                np.array(
                    [("real", "real"), ("real", "imag"), ("imag", "imag")],
                    dtype=[("component_a", "<U8"), ("component_b", "<U8")],
                ),
            )

    @property
    def component(self):
        return self.index_map["component"]

    @property
    def sample_variance(self):
        if "sample_variance" in self.datasets:
            return self.datasets["sample_variance"]
        raise KeyError("The 'sample_variance' dataset has not been created yet.")

    @property
    def nsample(self):
        if "nsample" in self.datasets:
            return self.datasets["nsample"]
        raise KeyError("The 'nsample' dataset has not been created yet.")

    @property
    def sample_variance_iq(self):
        """Sample variance rotated to the in-phase/quadrature basis."""
        C = np.asarray(self.sample_variance)
        phi = np.angle(np.asarray(self._mean))
        cc, cs, ss = np.cos(phi) ** 2, np.cos(phi) * np.sin(phi), np.sin(phi) ** 2
        Cphi = np.zeros_like(C)
        Cphi[0] = cc * C[0] + 2 * cs * C[1] + ss * C[2]
        Cphi[1] = -cs * C[0] + (cc - ss) * C[1] + cs * C[2]
        Cphi[2] = ss * C[0] - 2 * cs * C[1] + cc * C[2]
        return Cphi

    @property
    def sample_variance_amp_phase(self):
        """Amplitude/phase covariance (valid for small fractional variation)."""
        amp2 = np.abs(np.asarray(self._mean)[np.newaxis, ...]) ** 2
        out = self.sample_variance_iq.copy()
        np.divide(out, amp2, out=out, where=amp2 != 0)
        out[..., :] = np.where(amp2 == 0, 0.0, out)
        return out

    @property
    def sample_weight(self):
        """Inverse variance of the mean estimated from the sample variance."""
        C = np.asarray(self.sample_variance)
        nsample = np.asarray(self.nsample)
        tot = C[0] + C[2]
        out = np.zeros_like(tot)
        np.divide(nsample, tot, out=out, where=tot != 0)
        return out


# The concrete container zoo lives in ``containers_spec`` and is exposed
# from this namespace too, lazily (PEP 562): containers_spec imports the
# base classes from here, so an eager star-import would be circular.
_BASE_ALL = [
    "ContainerBase",
    "Dataset",
    "TODContainer",
    "FreqContainer",
    "SiderealContainer",
    "MContainer",
    "DataWeightContainer",
    "VisBase",
    "VisContainer",
    "SampleVarianceContainer",
    "empty_like",
    "copy_datasets_filter",
    "concatenate_tod",
    "torch_dtype",
    "COMPRESSION",
    "COMPRESSION_OPTS",
]


def __getattr__(name):
    from . import containers_spec as _spec

    if name == "__all__":
        return _BASE_ALL + list(_spec.__all__)
    if name in _spec.__all__:
        return getattr(_spec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    from . import containers_spec as _spec

    return sorted(set(globals()) | set(_BASE_ALL) | set(_spec.__all__))
