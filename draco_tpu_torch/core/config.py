"""Declarative typed configuration properties for pipeline tasks.

Native replacement for the ``caput.config`` system the reference task
library is built on (usage sites e.g. reference ``draco/analysis/delay.py:403-429``,
``draco/synthesis/stream.py:427-433``): class-level :class:`Property`
descriptors declare typed, defaulted parameters which the pipeline manager
binds from the YAML ``params`` section via :meth:`Reader.read_config`.
"""

from __future__ import annotations

import datetime
from typing import Any, Callable


class ConfigError(Exception):
    """Raised when configuration is invalid."""


# Alias matching the reference's exception name so configs/docs translate.
CaputConfigError = ConfigError


class Property:
    """A declarative, typed task attribute settable from a config dict.

    Parameters
    ----------
    default
        Value used when the config does not set this property.  May be a
        callable (evaluated lazily).
    proptype
        Callable applied to the raw config value for casting/validation.
    key
        Config key to read (defaults to the attribute name).
    """

    def __init__(
        self,
        default: Any = None,
        proptype: Callable | None = None,
        key: str | None = None,
    ):
        self.default = default
        self.proptype = (lambda x: x) if proptype is None else proptype
        self.key = key
        self.propname: str | None = None

    def __set_name__(self, owner, name):
        self.propname = name
        if self.key is None:
            self.key = name

    def _default_value(self):
        import copy

        d = self.default
        d = d() if callable(d) else d
        # a fresh copy per instance: handing out the class-level list/
        # dict object itself lets one task's mutation leak into every
        # other instance's default
        if isinstance(d, (list, dict, set)):
            return copy.copy(d)
        return d

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        values = obj.__dict__.setdefault("_config_values", {})
        if self.propname not in values:
            values[self.propname] = self._default_value()
        return values[self.propname]

    def __set__(self, obj, value):
        obj.__dict__.setdefault("_config_values", {})[self.propname] = value

    def _from_config(self, obj, config: dict):
        if self.key in config:
            raw = config[self.key]
            # An explicit YAML null is only meaningful for properties
            # whose DEFAULT is None (reset-to-unset); for any other
            # declared default a blank value is almost always a
            # trailing-colon accident, and silently bypassing the
            # proptype would clobber the default and skip validation.
            if raw is None:
                if self._default_value() is None:
                    self.__set__(obj, None)
                    return
                raise ConfigError(
                    f"Property {self.propname!r} was given an explicit "
                    "null (blank YAML value) but its default is "
                    f"{self._default_value()!r}; set a real value or "
                    "remove the key."
                )
            try:
                val = self.proptype(raw)
            except ConfigError:
                raise
            except Exception as e:  # noqa: BLE001 - surface as config error
                raise ConfigError(
                    f"Error setting property {self.propname!r} "
                    f"from value {raw!r}: {e}"
                ) from e
            self.__set__(obj, val)


class Reader:
    """Mixin supplying :meth:`read_config` to bind Property values."""

    @classmethod
    def _config_properties(cls) -> dict[str, Property]:
        props: dict[str, Property] = {}
        for klass in reversed(cls.__mro__):
            for name, val in vars(klass).items():
                if isinstance(val, Property):
                    props[name] = val
        return props

    @classmethod
    def from_config(cls, config: dict, *args, **kwargs):
        obj = cls(*args, **kwargs)
        obj.read_config(config)
        return obj

    def read_config(self, config: dict, compare_keys: bool = False) -> None:
        """Bind config values onto this instance's Properties.

        Raises :class:`ConfigError` for unknown keys when ``compare_keys``
        is set (used by the pipeline linter).
        """
        if config is None:
            config = {}
        props = self._config_properties()
        if compare_keys:
            known = {p.key for p in props.values()}
            unknown = set(config) - known
            if unknown:
                raise ConfigError(
                    f"Unknown config keys for {type(self).__name__}: "
                    f"{sorted(unknown)}"
                )
        for prop in props.values():
            prop._from_config(self, config)
        self._finalise_config()

    def _finalise_config(self) -> None:
        """Hook run after config binding; override for validation."""


def float_prop(default=None):
    """A float-typed config property (shorthand)."""
    return Property(proptype=float, default=default)


def int_prop(default=None):
    """An int-typed config property (shorthand)."""
    return Property(proptype=int, default=default)


def bool_prop(default=None):
    """A bool-typed config property (shorthand)."""
    return Property(proptype=bool, default=default)


def str_prop(default=None):
    """A str-typed config property (shorthand)."""
    return Property(proptype=str, default=default)


def list_prop(default=None):
    """A list-typed config property (shorthand)."""
    return Property(proptype=list, default=default)


def dict_prop(default=None):
    """A dict-typed config property (shorthand)."""
    return Property(proptype=dict, default=default)


def utc_time(default=None):
    """Property accepting a UNIX float or an ISO/datetime UTC time."""

    def _cast(val):
        if isinstance(val, (int, float)):
            return float(val)
        if isinstance(val, datetime.datetime):
            return val.replace(tzinfo=val.tzinfo or datetime.timezone.utc).timestamp()
        if isinstance(val, str):
            dt = datetime.datetime.fromisoformat(val)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=datetime.timezone.utc)
            return dt.timestamp()
        raise ConfigError(f"Cannot interpret {val!r} as a UTC time")

    return Property(proptype=_cast, default=default)


def enum(options, default=None):
    """Property restricted to a fixed set of values."""
    options = list(options)
    if default is not None and default not in options:
        raise ConfigError(f"enum default {default!r} not in options {options}")

    def _cast(val):
        if val not in options:
            raise ConfigError(f"Value {val!r} not one of {options}")
        return val

    return Property(proptype=_cast, default=default)


def list_type(type_=None, length=None, maxlength=None, default=None):
    """Property that must be a (typed, optionally length-checked) list."""

    def _cast(val):
        if not isinstance(val, (list, tuple)):
            raise ConfigError(f"Expected a list, got {val!r}")
        val = list(val)
        if length is not None and len(val) != length:
            raise ConfigError(f"Expected list of length {length}, got {len(val)}")
        if maxlength is not None and len(val) > maxlength:
            raise ConfigError(f"List longer than maxlength={maxlength}")
        if type_ is not None:
            bad = [v for v in val if not isinstance(v, type_)]
            if bad:
                raise ConfigError(f"List elements {bad!r} not of type {type_}")
        return val

    return Property(proptype=_cast, default=default)


def float_in_range(start, end, default=None):
    """Property for a float restricted to ``[start, end]``."""

    def _cast(val):
        val = float(val)
        if not (start <= val <= end):
            raise ConfigError(f"Value {val} outside range [{start}, {end}]")
        return val

    return Property(proptype=_cast, default=default)


def logging_config(default=None):
    """Property for a logging level name or per-module mapping."""

    def _cast(val):
        if isinstance(val, str):
            return {"root": val}
        if isinstance(val, dict):
            return dict(val)
        raise ConfigError(f"Cannot interpret logging config {val!r}")

    if default is None:
        default = {"root": "INFO"}
    # note: `default or {...}` would discard an explicit empty dict
    return Property(proptype=_cast, default=default)
