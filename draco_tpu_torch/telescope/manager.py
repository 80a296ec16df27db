"""Telescope product manager.

Port of ``draco_tpu.telescope.manager``, the replacement of
``drift.core.manager.ProductManager``: a telescope model and its beam
transfer products, loadable from a YAML-configured product directory (the
``drift-makeproducts`` output layout the reference expects, reference
draco/core/io.py:215-243), with any KL transforms and power-spectrum
estimators its ``kltransform``/``psfisher`` stanzas name.  Product
directories are the JAX package's, so either package reads the other's.

``yaml`` is imported only by :meth:`ProductManager.from_config`.
"""

from __future__ import annotations

import importlib
import os

from .beamtransfer import BeamTransfer
from .core import TransitTelescope

_CORE = "draco_tpu_torch.telescope.core"

_BUILTIN_TELESCOPES = {
    "UnpolarisedCylinder": f"{_CORE}.UnpolarisedCylinderTelescope",
    "PolarisedCylinder": f"{_CORE}.PolarisedCylinderTelescope",
    "UnpolarisedDishArray": f"{_CORE}.UnpolarisedDishArray",
    "PolarisedDishArray": f"{_CORE}.PolarisedDishArray",
    "SimpleUnpolarised": f"{_CORE}.SimpleUnpolarisedTelescope",
    "SimplePolarised": f"{_CORE}.SimplePolarisedTelescope",
}

# reference (drift-makeproducts) and JAX-package module paths accepted verbatim
_MODULE_ALIASES = {
    "drift.telescope.cylinder": _CORE,
    "drift.core.telescope": _CORE,
    "draco_tpu.telescope.core": _CORE,
}

def _resolve_telescope(type_spec):
    """Telescope class from a name, dotted path, or {class, module} dict.

    The dict form mirrors the reference's product configs (reference
    doc/product_params.yaml: ``type: {class: ..., module:
    drift.telescope.cylinder}``); drift and draco_tpu module paths map onto
    this package's telescope module.
    """
    if isinstance(type_spec, dict):
        if "class" not in type_spec:
            raise ValueError(
                "dict-form telescope type spec needs a 'class' key "
                f"(got keys {sorted(type_spec)}); e.g. "
                "type: {class: UnpolarisedCylinder, module: drift.telescope.cylinder}"
            )
        cls_name = type_spec["class"]
        mod_name = type_spec.get("module")
        if mod_name:
            mod_name = _MODULE_ALIASES.get(mod_name, mod_name)
            return getattr(importlib.import_module(mod_name), cls_name)
        type_spec = cls_name
    path = _BUILTIN_TELESCOPES.get(type_spec, type_spec)
    mod_name, _, cls_name = path.rpartition(".")
    return getattr(importlib.import_module(_MODULE_ALIASES.get(mod_name, mod_name)), cls_name)


class ProductManager:
    """Holds telescope + beamtransfer (+ KL transforms, PS estimators)."""

    def __init__(
        self,
        telescope: TransitTelescope,
        beamtransfer: BeamTransfer | None = None,
        directory: str | None = None,
    ):
        self.telescope = telescope
        self.beamtransfer = beamtransfer or BeamTransfer(telescope=telescope)
        self.directory = directory
        self.kltransforms: dict = {}
        self.psestimators: dict = {}
        self._generate_flags: dict = {}

    @classmethod
    def from_config(cls, config_path: str) -> "ProductManager":
        """Load a product directory (or its config YAML).

        Schema::

            config:                            # optional (drift-makeproducts)
              output_directory: products/
            telescope:
              type: PolarisedCylinder          # name or dotted path
              num_cylinders: 2
              ...
            beamtransfer: {...}                # optional BeamTransfer args
            kltransform:                       # optional
              - type: KLTransform
                name: dk
                ...
            psfisher:                          # optional
              - type: MonteCarlo
                name: ps
                klname: dk
                bands: ...
        """
        try:
            import yaml
        except ImportError as e:
            raise ImportError("reading a product config needs the pyyaml package") from e

        if os.path.isdir(config_path):
            directory = config_path
            config_file = os.path.join(config_path, "config.yaml")
        else:
            directory = os.path.dirname(config_path) or "."
            config_file = config_path
        with open(config_file) as f:
            cfg = yaml.safe_load(f)

        # drift-makeproducts configs carry a `config:` stanza with the
        # product output directory (reference test/products_config.yaml)
        drift_cfg = cfg.get("config") or {}
        out_dir = drift_cfg.get("output_directory")
        if out_dir:
            directory = out_dir if os.path.isabs(out_dir) else os.path.join(directory, out_dir)

        tel_cfg = dict(cfg.get("telescope", {}))
        tel = _resolve_telescope(tel_cfg.pop("type", "SimpleUnpolarised")).from_config(tel_cfg)

        bt = BeamTransfer(telescope=tel, **(cfg.get("beamtransfer", {}) or {}))
        bt_dir = os.path.join(directory, "bt")
        if os.path.exists(os.path.join(bt_dir, "beam_p.npy")):
            bt.directory = bt_dir
            bt.load(bt_dir)

        man = cls(tel, bt, directory=directory)
        # the drift config stanza's booleans select which products
        # generate() computes (reference doc/product_params.yaml)
        man._generate_flags = {
            name: bool(drift_cfg.get(name, True)) for name in ("beamtransfers", "kltransform", "psfisher")
        }

        # KL transforms
        if cfg.get("kltransform"):
            from . import kltransform as klmod
        for kl_cfg in cfg.get("kltransform", []) or []:
            kl_cfg = dict(kl_cfg)
            name = kl_cfg.pop("name", kl_cfg.get("type", "kl"))
            kl_cls = getattr(klmod, kl_cfg.pop("type", "KLTransform"))
            man.kltransforms[name] = kl_cls.from_config(kl_cfg, bt)

        # Power spectrum estimators
        if cfg.get("psfisher"):
            from . import psestimation as psmod
        for ps_cfg in cfg.get("psfisher", []) or []:
            ps_cfg = dict(ps_cfg)
            name = ps_cfg.pop("name", "ps")
            klname = ps_cfg.pop("klname", None)
            ps_cfg.pop("type", None)
            kl = man.kltransforms.get(klname) if klname else None
            man.psestimators[name] = psmod.PSEstimation.from_config(ps_cfg, bt, kl)
        return man

    def generate(self, regen: bool = False) -> "ProductManager":
        flags = self._generate_flags
        if flags.get("beamtransfers", True):
            self.beamtransfer.generate(regen=regen)
        if flags.get("kltransform", True):
            for kl in self.kltransforms.values():
                kl.generate(regen=regen)
        if flags.get("psfisher", True):
            for ps in self.psestimators.values():
                ps.generate(regen=regen)
        return self

    def save(self, directory: str | None = None):
        directory = directory or self.directory
        self.beamtransfer.save(os.path.join(directory, "bt"))
