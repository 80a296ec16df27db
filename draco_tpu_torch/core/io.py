"""IO tasks: loading maps, catalogs, telescope products, generic containers.

Port of ``draco_tpu.core.io``: reference ``draco/core/io.py`` (LoadMaps:10,
LoadFITSCatalog:76, LoadBeamTransfer:175, LoadProductManager:215,
get_telescope:251, get_beamtransfer:265) plus the
``caput.pipeline.tasklib.io`` helpers draco relies on and the
``tasklib.debug`` provenance tasks.

Containers read from files go to the process default device
(:func:`draco_tpu_torch.device.resolve`), as the beam tensors of
``LoadBeamTransfer`` do.
"""

from __future__ import annotations

import glob as glob_mod
import logging
import os

import numpy as np

from ..device import resolve
from . import config
from .containers import ContainerBase, Map, SpectroscopicCatalog
from .task import ContainerTask, MPILoggedTask, PipelineStopIteration

# 21cm line rest frequency in MHz (caput.astro.constants.nu21 equivalent).
NU21 = 1420.405751768


# ---------------------------------------------------------------------------
# File group config helpers (caput tasklib.io equivalents)
# ---------------------------------------------------------------------------


def list_or_glob(files):
    """Expand a string glob or list of globs into a flat file list."""
    if files is None:
        return None
    if isinstance(files, str):
        matches = sorted(glob_mod.glob(files))
        return matches if matches else [files]
    if isinstance(files, (list, tuple)):
        out = []
        for f in files:
            out.extend(list_or_glob(f))
        return out
    raise config.ConfigError(f"Cannot interpret file list {files!r}")


def list_of_filelists(files):
    """A list of lists of files (glob-expanded)."""
    if not isinstance(files, (list, tuple)):
        raise config.ConfigError("Expected a list of file lists")
    return [list_or_glob(f) for f in files]


def list_of_filegroups(groups):
    """Normalise a file-group config into [{'tag':..., 'files': [...]}, ...].

    A file group is a dict with ``files`` (glob or list) and optional
    ``tag``; a bare string/list is promoted into a single anonymous group
    (reference caput usage in draco/core/io.py:23).
    """
    if isinstance(groups, dict):
        groups = [groups]
    if isinstance(groups, str):
        groups = [{"files": groups}]
    if not isinstance(groups, (list, tuple)):
        raise config.ConfigError(f"Cannot interpret file groups {groups!r}")
    out = []
    for gi, group in enumerate(groups):
        if isinstance(group, str):
            group = {"files": group}
        if "files" not in group:
            raise config.ConfigError(f"File group {group!r} has no 'files'")
        files = list_or_glob(group["files"])
        tag = group.get("tag", f"group_{gi}")
        out.append({"tag": tag, "files": files})
    return out


class SelectionsMixin:
    """Mixin adding axis-selection config for file loading tasks.

    Selections are given as ``<axis>_range: [start, stop, (step)]`` or
    ``<axis>_index: [...]`` entries in the ``selections`` dict param
    (reference caput tasklib.io.SelectionsMixin; usage in
    draco/analysis/transform.py:1848).
    """

    selections = config.dict_prop(None)

    # selection-key suffixes a subclass handles itself
    _sel_extra_suffixes: tuple = ()

    def _resolve_sel(self) -> dict:
        sel = {}
        if not self.selections:
            return sel
        for key, value in self.selections.items():
            if any(key.endswith(sfx) for sfx in self._sel_extra_suffixes):
                continue
            if key.endswith("_range"):
                sel[key[: -len("_range")]] = slice(*value)
            elif key.endswith("_index"):
                sel[key[: -len("_index")]] = np.asarray(value)
            else:
                raise config.ConfigError(f"Unknown selection key {key!r}")
        return sel


# ---------------------------------------------------------------------------
# Generic container loading
# ---------------------------------------------------------------------------


class LoadFilesFromParams(SelectionsMixin, ContainerTask):
    """Load containers from a list of files given in the task params.

    (caput tasklib.io.LoadFilesFromParams; reference usage in
    examples/test.yaml:9-12)

    With ``prefetch: true`` the next file's HDF5 read runs on a background
    thread while the downstream tasks process the current container.
    """

    files = config.Property(proptype=list_or_glob)
    distributed = config.bool_prop(True)
    prefetch = config.bool_prop(False)

    _pending = None
    _pool = None

    def _read(self, fname, device):
        self.log.info("Loading file %s", fname)
        cont = ContainerBase.from_file(
            fname, distributed=self.distributed, sel=self._resolve_sel(), device=device
        )
        cont.attrs.setdefault("tag", os.path.splitext(os.path.basename(fname))[0])
        return cont

    def process(self):
        device = resolve(None)
        if self._pending is not None:
            fut = self._pending
            self._pending = None
            cont = fut.result()
        else:
            if not self.files:
                self._shutdown_pool()
                raise PipelineStopIteration()
            cont = self._read(self.files.pop(0), device)
        if self.prefetch and self.files:
            if self._pool is None:
                import concurrent.futures

                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="draco-tpu-torch-io"
                )
            self._pending = self._pool.submit(self._read, self.files.pop(0), device)
        return cont

    def _shutdown_pool(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


# Reference-compat alias
LoadBasicCont = LoadFilesFromParams


class Save(ContainerTask):
    """Explicitly save the incoming container to disk and pass it through."""

    root = config.str_prop("")

    def process(self, data):
        from ..parallel.multihost import is_leader

        tag = data.attrs.get("tag", self._count)
        fname = f"{self.root}{tag}.h5"
        if is_leader():
            # a multi-process launch runs every task on every process; only
            # the leader writes (as ContainerTask._save_output)
            self.log.info("Saving %s", fname)
            data.save(fname, truncate=self.truncate)
        return data


class Print(ContainerTask):
    """Print incoming containers (debug task)."""

    def process(self, data):
        print(data)
        return data


class PassOn(ContainerTask):
    """Pass the input on unchanged (useful for fan-out wiring)."""

    def process(self, data):
        return data


# ---------------------------------------------------------------------------
# Map / catalog loading (reference draco/core/io.py:10-172)
# ---------------------------------------------------------------------------


class LoadMaps(ContainerTask):
    """Load a series of HEALPix maps, summing maps within each file group.

    (reference draco/core/io.py:10-73)
    """

    maps = config.Property(proptype=list_of_filegroups)

    def process(self):
        if not self.maps:
            raise PipelineStopIteration()
        group = self.maps.pop(0)
        map_stack = None
        for path in group["files"]:
            self.log.debug("Loading file %s", path)
            current = Map.from_file(path)
            if map_stack is None:
                map_stack = current
                continue
            if not np.array_equal(current.freq, map_stack.freq):
                raise RuntimeError("Loaded maps disagree on their frequency axes.")
            if not np.array_equal(np.asarray(current.index_map["pol"]), np.asarray(map_stack.index_map["pol"])):
                # content, not just length: an [XX, YY] map must not sum
                # with an [I, Q] one
                raise RuntimeError("Loaded maps disagree on their polarisation axes.")
            if len(current.index_map["pixel"]) != len(map_stack.index_map["pixel"]):
                raise RuntimeError("Loaded maps disagree on their healpix resolution.")
            map_stack.map[:] += current.map[:]
        map_stack.attrs["tag"] = group["tag"]
        return map_stack


class LoadFITSCatalog(ContainerTask):
    """Load an SDSS-style FITS source catalog (reference draco/core/io.py:76).

    A FITS file needs astropy; ``.h5``/``.npy`` catalogs with RA/DEC/Z
    columns need h5py / numpy only.
    """

    catalogs = config.Property(proptype=list_of_filegroups)
    z_range = config.list_type(float, 2, default=None)
    freq_range = config.list_type(float, 2, default=None)

    def _redshift_window(self):
        """Resolve the configured frequency/redshift bounds (or None)."""
        if self.freq_range:
            hi, lo = self.freq_range[1], self.freq_range[0]
            self.z_range = [NU21 / hi - 1, NU21 / lo - 1]
        if self.z_range:
            self.log.info("Applying redshift selection %.2f <= z <= %.2f", *self.z_range)
        return self.z_range

    def process(self):
        if not self.catalogs:
            raise PipelineStopIteration()
        group = self.catalogs.pop(0)
        window = self._redshift_window()

        stack = []
        for path in group["files"]:
            self.log.debug("Loading file %s", path)
            pos = self._read_catalog(path)
            if window:
                keep = (pos[2] >= window[0]) & (pos[2] <= window[1])
                pos = pos[:, keep]
            stack.append(pos)
        cat_array = np.ascontiguousarray(np.concatenate(stack, axis=-1).astype(np.float64))
        num_objects = cat_array.shape[-1]
        self.log.debug("Constructing catalog with %i objects.", num_objects)

        catalog = SpectroscopicCatalog(object_id=np.arange(num_objects))
        catalog["position"][:]["ra"] = cat_array[0]
        catalog["position"][:]["dec"] = cat_array[1]
        catalog["redshift"][:]["z"] = cat_array[2]
        catalog["redshift"][:]["z_error"] = 0
        catalog.attrs["tag"] = group["tag"]
        return catalog

    @staticmethod
    def _read_catalog(cfile: str) -> np.ndarray:
        if cfile.endswith((".fits", ".fits.gz")):
            try:
                from astropy.io import fits
            except ImportError as e:
                raise ImportError("reading a FITS catalog needs the astropy package") from e
            with fits.open(cfile, mode="readonly") as cat:
                table = cat[1].data
                return np.array([table["RA"], table["DEC"], table["Z"]])
        if cfile.endswith(".npy"):
            return np.load(cfile)
        if cfile.endswith((".h5", ".hdf5")):
            from .containers import _import_h5py

            with _import_h5py().File(cfile, "r") as f:
                return np.array([f["RA"][:], f["DEC"][:], f["Z"][:]])
        raise RuntimeError(f"Unknown catalog format: {cfile}")


# ---------------------------------------------------------------------------
# Telescope products (reference draco/core/io.py:175-276)
# ---------------------------------------------------------------------------


def _require_products(directory):
    if not os.path.exists(directory):
        raise RuntimeError(f"No telescope products found at {directory!r}.")


class LoadBeamTransfer(MPILoggedTask):
    """Load a beam transfer manager from disk (reference draco/core/io.py:175).

    Reads a directory written by either package; one that holds only
    ``telescope.pkl`` is a valid product for the streaming projections.

    Attributes
    ----------
    product_directory : str
        The product directory.
    nside : int
        HEALPix resolution of the beam products.  A directory does not
        record it; left out, it is the smallest power of two with
        2 nside >= lmax + 1, as in the JAX package (512 for lmax 767).
    """

    product_directory = config.str_prop()
    nside = config.int_prop(None)

    def setup(self):
        from ..telescope import beamtransfer

        _require_products(self.product_directory)
        bt = beamtransfer.BeamTransfer(directory=self.product_directory, nside=self.nside)
        tel = bt.telescope
        # always a 3-tuple (feeds may be None): configs wire
        # `out: [tel, bt, feeds]` for any telescope
        return tel, bt, getattr(tel, "feeds", None)

    def process(self):
        raise PipelineStopIteration()


class LoadProductManager(MPILoggedTask):
    """Load a telescope product manager from disk (reference draco/core/io.py:215)."""

    product_directory = config.str_prop()

    def setup(self):
        from ..telescope import manager

        _require_products(self.product_directory)
        return manager.ProductManager.from_config(self.product_directory)

    def process(self):
        raise PipelineStopIteration()


def get_beamtransfer(obj):
    """Coerce a BeamTransfer or ProductManager into a BeamTransfer.

    (reference draco/core/io.py:265)
    """
    from ..telescope.beamtransfer import BeamTransfer
    from ..telescope.manager import ProductManager

    if isinstance(obj, BeamTransfer):
        return obj
    if isinstance(obj, ProductManager):
        return obj.beamtransfer
    raise RuntimeError(f"{obj!r} does not resolve to a BeamTransfer")


def get_telescope(obj):
    """Coerce a ProductManager/BeamTransfer/TransitTelescope into a telescope.

    (reference draco/core/io.py:251)
    """
    from ..telescope.core import TransitTelescope

    try:
        return get_beamtransfer(obj).telescope
    except RuntimeError:
        if isinstance(obj, TransitTelescope):
            return obj
    raise RuntimeError(f"{obj!r} does not resolve to a telescope model")



# ---------------------------------------------------------------------------
# Provenance debug tasks (caput tasklib.debug equivalents)
# ---------------------------------------------------------------------------


class SaveModuleVersions(ContainerTask):
    """Write a YAML dump of module versions (caput tasklib.debug equivalent).

    (reference test/test_write_metadata.py:49)
    """

    root = config.str_prop("versions")

    done = False

    def process(self):
        if self.done:
            raise PipelineStopIteration()
        from .pipeline import dump_config

        versions = self._manager.versions if self._manager else {}
        with open(f"{self.root}_versions.yml", "w") as f:
            f.write(dump_config(versions))
        self.done = True
        raise PipelineStopIteration()


class SaveConfig(ContainerTask):
    """Write a YAML dump of the pipeline config (caput tasklib.debug equivalent).

    (reference test/test_write_metadata.py:52)
    """

    root = config.str_prop("config")

    done = False

    def process(self):
        if self.done:
            raise PipelineStopIteration()
        with open(f"{self.root}_config.yml", "w") as f:
            f.write(self._manager.config_yaml if self._manager else "")
        self.done = True
        raise PipelineStopIteration()


class SetMPILogging(MPILoggedTask):
    """Configure global logging levels (historical reference task name)."""

    level_rank0 = config.str_prop("INFO")
    level_all = config.str_prop("WARNING")

    def read_config(self, config_dict, compare_keys=False):
        """Apply the levels after the config is read.

        One process: it is rank 0, so level_rank0 wins; level_all is what
        every other rank would get.
        """
        super().read_config(config_dict, compare_keys=compare_keys)
        logging.getLogger().setLevel(self.level_rank0.upper())
