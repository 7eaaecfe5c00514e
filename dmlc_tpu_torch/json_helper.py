"""Declarative JSON object binding (the port of ``dmlc_tpu/json_helper.py``,
dmlc-core's include/dmlc/json.h).

dmlc-core's hand-rolled JSON reader/writer is replaced by stdlib
``json`` (idiomatic Python); what stdlib does NOT give you is the
declarative field contract of ``JSONObjectReadHelper``
(json.h:266-343): declare typed fields once, then reading validates
presence, type, and — in strict mode — rejects unknown keys, instead of
every caller hand-rolling ``obj.get(...)`` checks.

    h = JSONObjectReadHelper(strict=True)
    h.declare_field("name", str)
    h.declare_field("lr", float)
    h.declare_field("tags", list, required=False, default=[])
    cfg = h.read('{"name": "sgd", "lr": 0.1}')

Nested objects bind by passing another helper as the field type.
``read_into(target, data)`` setattr's the fields onto an object —
dmlc-core's pointer-binding idiom.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from .base import DMLCError

__all__ = ["JSONObjectReadHelper"]

_MISSING = object()


class JSONObjectReadHelper:
    """Typed, declarative reader for one JSON object shape."""

    def __init__(self, strict: bool = True):
        # strict: unknown keys are an error (dmlc-core's default —
        # ReadAllFields LOGs FATAL on unknown keys, json.h:320-335)
        self._strict = strict
        self._fields: Dict[str, tuple] = {}

    def declare_field(self, name: str, type_: Any, *, required: bool = True,
                      default: Any = _MISSING) -> "JSONObjectReadHelper":
        """Declare field ``name`` of ``type_`` (a python type, or another
        JSONObjectReadHelper for a nested object).  Optional fields take
        ``default`` (deep-copied per read when mutable)."""
        if not required and default is _MISSING:
            default = None
        self._fields[name] = (type_, required, default)
        return self

    def read_object(self, data) -> Dict[str, Any]:
        """Parse + validate ``data`` (JSON text or an already-parsed
        dict); returns the validated field dict."""
        if isinstance(data, (str, bytes)):
            try:
                data = json.loads(data)
            except json.JSONDecodeError as e:
                raise DMLCError(f"invalid JSON: {e}") from e
        if not isinstance(data, dict):
            raise DMLCError(
                f"expected a JSON object, got {type(data).__name__}")
        if self._strict:
            unknown = set(data) - set(self._fields)
            if unknown:
                raise DMLCError(
                    f"unknown JSON keys {sorted(unknown)}; declared "
                    f"fields: {sorted(self._fields)}")
        out: Dict[str, Any] = {}
        for name, (type_, required, default) in self._fields.items():
            if name not in data:
                if required:
                    raise DMLCError(f"missing required JSON key {name!r}")
                import copy

                out[name] = copy.deepcopy(default)
                continue
            out[name] = self._coerce(name, type_, data[name])
        return out

    def _coerce(self, name: str, type_: Any, value: Any) -> Any:
        if isinstance(type_, JSONObjectReadHelper):
            return type_.read_object(value)
        if type_ is float and isinstance(value, int) \
                and not isinstance(value, bool):
            return float(value)  # JSON has one number type
        if type_ is int and isinstance(value, bool):
            raise DMLCError(f"JSON key {name!r}: expected int, got bool")
        if not isinstance(value, type_):
            raise DMLCError(
                f"JSON key {name!r}: expected {type_.__name__}, got "
                f"{type(value).__name__}")
        return value

    def read_into(self, target: Any, data) -> Any:
        """Read + setattr every field onto ``target`` (the reference's
        field-pointer binding, json.h:276-286)."""
        for name, value in self.read_object(data).items():
            setattr(target, name, value)
        return target

    def write_object(self, obj: Any, *, indent: Optional[int] = None) -> str:
        """Serialize declared fields of an object/dict back to JSON."""
        get = obj.get if isinstance(obj, dict) else \
            lambda n, d=_MISSING: getattr(obj, n, d)
        out = {}
        for name, (type_, required, default) in self._fields.items():
            v = get(name, _MISSING)
            if v is _MISSING:
                if required:
                    raise DMLCError(f"missing field {name!r} on write")
                continue  # absent optional: omit — read restores default
            if isinstance(type_, JSONObjectReadHelper):
                v = json.loads(type_.write_object(v))
            out[name] = v
        return json.dumps(out, indent=indent)
