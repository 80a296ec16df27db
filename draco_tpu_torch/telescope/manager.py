"""Telescope product manager.

Port of ``draco_tpu.telescope.manager``, the replacement of
``drift.core.manager.ProductManager``: a telescope model and its beam
transfer products, loadable from a YAML-configured product directory (the
``drift-makeproducts`` output layout the reference expects, reference
draco/core/io.py:215-243).  Product directories are the JAX package's, so
either package reads the other's.  KL transforms and power-spectrum
estimators (``kltransform``/``psfisher`` stanzas) are a later slice of the
port: a config that names them raises.

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

_NOT_PORTED = (
    "the {stanza!r} stanza of a product config is not ported to draco_tpu_torch yet: "
    "KL transforms and power-spectrum estimators are a later slice (ROADMAP.md slice C)"
)


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
    """Holds a telescope and its beam transfer products."""

    def __init__(
        self,
        telescope: TransitTelescope,
        beamtransfer: BeamTransfer | None = None,
        directory: str | None = None,
    ):
        self.telescope = telescope
        self.beamtransfer = beamtransfer or BeamTransfer(telescope=telescope)
        self.directory = directory
        self._generate_beamtransfers = True

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

        for stanza in ("kltransform", "psfisher"):
            if cfg.get(stanza):
                raise NotImplementedError(_NOT_PORTED.format(stanza=stanza))

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
        # the drift config stanza's booleans select what generate() computes
        # (reference doc/product_params.yaml)
        man._generate_beamtransfers = bool(drift_cfg.get("beamtransfers", True))
        return man

    def generate(self, regen: bool = False) -> "ProductManager":
        if self._generate_beamtransfers:
            self.beamtransfer.generate(regen=regen)
        return self

    def save(self, directory: str | None = None):
        directory = directory or self.directory
        self.beamtransfer.save(os.path.join(directory, "bt"))
