"""Base utilities: the error type, typed op parameters and naming scopes.

Counterpart of ``mxnet_tpu/base.py``.  Op attributes arrive as python
values or as the strings a symbol JSON carries; one ``Param`` descriptor
per attribute converts and validates both, so a graph written by either
package normalizes to the same attribute dict.
"""
from __future__ import annotations

import threading

__all__ = ["MXNetError", "ParamError", "Param", "normalize_attrs",
           "attrs_to_strings", "NameManager", "Prefix", "AttrScope"]


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch."""


class ParamError(MXNetError):
    """Raised when an op parameter fails validation."""


class _Required:
    def __repr__(self):
        return "<required>"


REQUIRED = _Required()


def _parse_bool(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no", "none"):
        return False
    raise ParamError("cannot interpret %r as bool" % (v,))


def _parse_tuple(v, elem=int):
    """Parse '(1, 2)' / '[1,2]' / 3 / (1,2) into a tuple of elem type."""
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return (elem(v),)
    if isinstance(v, (tuple, list)):
        return tuple(elem(x) for x in v)
    s = str(v).strip()
    if s in ("None", "null", ""):
        return None
    s = s.strip("()[]")
    if not s:
        return ()
    return tuple(elem(x.strip().strip("LlUu")) for x in s.split(",")
                 if x.strip())


class Param:
    """One typed op parameter (the dmlc::Parameter field)."""

    def __init__(self, ptype, default=REQUIRED, choices=None, doc=""):
        self.ptype = ptype
        self.default = default
        self.choices = choices
        self.doc = doc

    @property
    def required(self):
        return self.default is REQUIRED

    def convert(self, value, name, op_name=""):
        try:
            if value is None and self.ptype in ("shape", "shape_or_none",
                                                "int_or_none",
                                                "float_or_none",
                                                "str_or_none"):
                return None
            if self.ptype is int:
                v = int(value) if not isinstance(value, str) \
                    else int(str(value).strip().strip("LlUu"))
            elif self.ptype is float:
                v = float(value)
            elif self.ptype is bool:
                v = _parse_bool(value)
            elif self.ptype is str:
                v = str(value)
            elif self.ptype in ("shape", "shape_or_none"):
                v = _parse_tuple(value, int)
            elif self.ptype == "float_tuple":
                v = _parse_tuple(value, float)
            elif self.ptype == "int_or_none":
                s = str(value).strip()
                v = None if s in ("None", "null", "") else int(float(s))
            elif self.ptype == "float_or_none":
                s = str(value).strip()
                v = None if s in ("None", "null", "") else float(s)
            elif self.ptype == "str_or_none":
                s = str(value)
                v = None if s in ("None", "null") else s
            else:
                v = value
        except (TypeError, ValueError) as e:
            raise ParamError(
                "%s: parameter %s=%r invalid: %s" % (op_name, name, value, e))
        if self.choices is not None and v is not None and v not in self.choices:
            raise ParamError("%s: parameter %s=%r not in %s"
                             % (op_name, name, v, self.choices))
        return v


def normalize_attrs(params_schema, attrs, op_name=""):
    """Validate/convert an attr dict against a {name: Param} schema.

    Keys starting with ``_`` pass through; other unknown keys raise.
    Defaults are filled in schema order, so the normalized dict (and the
    symbol JSON written from it) has one canonical key order.
    """
    out = {}
    for k, v in attrs.items():
        if k.startswith("_"):
            out[k] = v
            continue
        if k not in params_schema:
            raise ParamError("%s: unknown parameter %r (known: %s)"
                             % (op_name, k, sorted(params_schema)))
        out[k] = params_schema[k].convert(v, k, op_name)
    for k, p in params_schema.items():
        if k not in out:
            if p.required:
                raise ParamError("%s: missing required parameter %r"
                                 % (op_name, k))
            out[k] = p.default
    return out


def attrs_to_strings(attrs):
    """Serialize attrs for symbol JSON (every attr is stored as a string)."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, bool):
            out[k] = "true" if v else "false"
        elif v is None:
            out[k] = "None"
        else:
            out[k] = str(v)
    return out


class NameManager:
    """Automatic unique naming for symbols (python/mxnet/name.py)."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        self._old = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, *args):
        NameManager._current.value = self._old

    @staticmethod
    def current():
        v = getattr(NameManager._current, "value", None)
        if v is None:
            v = NameManager()
            NameManager._current.value = v
        return v


class Prefix(NameManager):
    """A NameManager that puts ``prefix`` before every name (Gluon's
    ``Block.name_scope``)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


class AttrScope:
    """Scope for symbol attributes (python/mxnet/attribute.py)."""

    _current = threading.local()

    def __init__(self, **kwargs):
        self._attr = kwargs
        self._old = None

    def get(self, attr):
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        self._old = getattr(AttrScope._current, "value", None)
        merged = dict(self._old._attr) if self._old else {}
        merged.update(self._attr)
        self._attr = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, *args):
        AttrScope._current.value = self._old

    @staticmethod
    def current():
        v = getattr(AttrScope._current, "value", None)
        if v is None:
            v = AttrScope()
            AttrScope._current.value = v
        return v
