"""Declarative typed parameter system with ranges, enums, aliases, and docs
(the port's copy of ``dmlc_tpu/param.py``).

Rebuild of reference include/dmlc/parameter.h (Parameter CRTP, 1038 LoC):
  - field declaration w/ default/range/enum/alias/doc
    (DMLC_DECLARE_FIELD, parameter.h:259-274; FieldEntryNumeric ranges
    :644-690; enum support :704-807; AddAlias :443-451)
  - kwargs Init with unknown-key policies kAllowUnknown / kAllMatch /
    kAllowHidden (parameter.h:62-70,381-421)
  - docstring generation (PrintDocString, parameter.h:474-482)
  - __DICT__ / JSON save-load (parameter.h:167-188)

Idiomatic-Python design: instead of CRTP + offset pointer math, a Parameter
subclass declares fields as class attributes built by :func:`field`; a
metaclass collects them. The behavioral contract (validation errors raise
ParamError naming the field, unknown-key policies, alias resolution,
env-var defaults) matches the reference.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Type

from .base import ParamError, get_env

__all__ = ["Parameter", "field", "ParamInitOption"]


class ParamInitOption:
    """Unknown-kwarg policies (parameter.h:62-70)."""

    ALLOW_UNKNOWN = "allow_unknown"   # ignore unknown keys
    ALL_MATCH = "all_match"           # error on any unknown key
    ALLOW_HIDDEN = "allow_hidden"     # unknown keys allowed if they start with '_'


class _FieldDef:
    __slots__ = (
        "name", "type", "default", "has_default", "lower", "upper",
        "enum", "aliases", "describe", "env",
    )

    def __init__(self, type: Type, default: Any, has_default: bool):
        self.name: str = ""
        self.type = type
        self.default = default
        self.has_default = has_default
        self.lower: Optional[Any] = None
        self.upper: Optional[Any] = None
        self.enum: Optional[Dict[str, Any]] = None
        self.aliases: List[str] = []
        self.describe: str = ""
        self.env: Optional[str] = None

    # fluent declaration API mirroring FieldEntry chaining (parameter.h:259+)
    def set_range(self, lower=None, upper=None) -> "_FieldDef":
        self.lower, self.upper = lower, upper
        return self

    def set_lower_bound(self, lower) -> "_FieldDef":
        self.lower = lower
        return self

    def add_enum(self, name: str, value=None) -> "_FieldDef":
        if self.enum is None:
            self.enum = {}
        self.enum[name] = name if value is None else value
        return self

    def add_alias(self, alias: str) -> "_FieldDef":
        self.aliases.append(alias)
        return self

    def set_describe(self, text: str) -> "_FieldDef":
        self.describe = text
        return self

    def set_env(self, env_key: str) -> "_FieldDef":
        """Field default comes from an environment variable if set
        (GetEnv pattern, parameter.h:1026-1036)."""
        self.env = env_key
        return self

    # -- value handling ---------------------------------------------------
    def parse(self, value: Any):
        ty = self.type
        try:
            if ty is bool:
                if isinstance(value, bool):
                    v = value
                elif isinstance(value, str):
                    low = value.strip().lower()
                    if low in ("1", "true", "yes", "on"):
                        v = True
                    elif low in ("0", "false", "no", "off"):
                        v = False
                    else:
                        raise ValueError(value)
                else:
                    v = bool(value)
            elif ty is int and isinstance(value, str):
                v = int(value, 0)
            elif ty is str:
                v = str(value)
            else:
                v = ty(value)
        except (TypeError, ValueError) as exc:
            raise ParamError(
                f"Invalid value {value!r} for parameter {self.name!r} "
                f"(expected {ty.__name__})"
            ) from exc
        return self.check(v)

    def check(self, v):
        if self.enum is not None:
            if v in self.enum:
                v = self.enum[v]
            elif v not in self.enum.values():
                raise ParamError(
                    f"Invalid value {v!r} for parameter {self.name!r}; "
                    f"expected one of {sorted(self.enum)}"
                )
        if self.lower is not None and v < self.lower:
            raise ParamError(
                f"value {v!r} for parameter {self.name!r} out of range "
                f"[{self.lower}, {self.upper if self.upper is not None else 'inf'}]"
            )
        if self.upper is not None and v > self.upper:
            raise ParamError(
                f"value {v!r} for parameter {self.name!r} out of range "
                f"[{self.lower if self.lower is not None else '-inf'}, {self.upper}]"
            )
        return v

    def default_value(self):
        if self.env is not None:
            return get_env(self.env, self.default, self.type)
        return self.default


_SENTINEL = object()


def field(type: Type, default: Any = _SENTINEL) -> _FieldDef:
    """Declare a parameter field (DMLC_DECLARE_FIELD, parameter.h:259).
    Omit ``default`` to make the field required (``set_default`` absent in
    the reference makes Init throw if the key is missing)."""
    return _FieldDef(type, None if default is _SENTINEL else default, default is not _SENTINEL)


class _ParamMeta(type):
    def __new__(mcls, name, bases, ns):
        fields: Dict[str, _FieldDef] = {}
        for base in bases:
            fields.update(getattr(base, "__param_fields__", {}))
        for key, val in list(ns.items()):
            if isinstance(val, _FieldDef):
                val.name = key
                fields[key] = val
                del ns[key]
        ns["__param_fields__"] = fields
        # alias -> canonical map (AddAlias, parameter.h:443-451)
        alias_map: Dict[str, str] = {}
        for key, fd in fields.items():
            for a in fd.aliases:
                alias_map[a] = key
        ns["__param_aliases__"] = alias_map
        return super().__new__(mcls, name, bases, ns)


class Parameter(metaclass=_ParamMeta):
    """Base class for declarative parameter structs (parameter.h:113-284).

    Example::

        class CSVParserParam(Parameter):
            format = field(str, "csv")
            label_column = field(int, -1).set_describe("column of the label")
    """

    __param_fields__: Dict[str, _FieldDef] = {}
    __param_aliases__: Dict[str, str] = {}

    def __init__(self, **kwargs):
        for key, fd in self.__param_fields__.items():
            setattr(self, key, fd.default_value())
        if kwargs:
            self.init(kwargs)

    def init(
        self,
        kwargs: Dict[str, Any],
        option: str = ParamInitOption.ALLOW_UNKNOWN,
    ) -> Dict[str, Any]:
        """Initialize from kwargs; returns unknown entries (InitAllowUnknown,
        parameter.h:381-421). Raises ParamError on bad values, missing
        required fields, or — under ALL_MATCH — unknown keys."""
        fields = self.__param_fields__
        aliases = self.__param_aliases__
        unknown: Dict[str, Any] = {}
        seen = set()
        for key, value in kwargs.items():
            canon = aliases.get(key, key)
            fd = fields.get(canon)
            if fd is None:
                if option == ParamInitOption.ALL_MATCH:
                    raise ParamError(
                        f"unknown parameter {key!r}; candidates: {sorted(fields)}"
                    )
                if option == ParamInitOption.ALLOW_HIDDEN:
                    # hidden keys are dunder-shaped '__name__' and are skipped,
                    # not returned (parameter.h:399-404)
                    if len(key) > 4 and key.startswith("__") and key.endswith("__"):
                        continue
                    raise ParamError(
                        f"unknown parameter {key!r}; candidates: {sorted(fields)}"
                    )
                unknown[key] = value
                continue
            setattr(self, canon, fd.parse(value))
            seen.add(canon)
        for key, fd in fields.items():
            if not fd.has_default and key not in seen:
                raise ParamError(f"required parameter {key!r} is not set")
        return unknown

    def update_dict(self, kwargs: Dict[str, Any]) -> None:
        """UpdateDict (parameter.h:160-166): re-init then write back
        normalized values into the dict."""
        self.init(kwargs)
        for key in self.__param_fields__:
            kwargs[key] = getattr(self, key)

    def to_dict(self) -> Dict[str, Any]:
        """__DICT__ (parameter.h:167-175)."""
        return {k: getattr(self, k) for k in self.__param_fields__}

    def save(self, stream) -> None:
        """JSON save through a Stream (parameter.h:176-181)."""
        data = json.dumps({k: str(v) for k, v in self.to_dict().items()})
        stream.write(data.encode("utf-8"))

    def load(self, stream) -> None:
        """JSON load through a Stream (parameter.h:182-188)."""
        data = json.loads(stream.read(1 << 30).decode("utf-8"))
        self.init(data)

    @classmethod
    def fields(cls) -> Dict[str, _FieldDef]:
        return dict(cls.__param_fields__)

    @classmethod
    def doc_string(cls) -> str:
        """Generated docstring (PrintDocString, parameter.h:474-482)."""
        lines = []
        for key, fd in cls.__param_fields__.items():
            tyname = fd.type.__name__
            extras = []
            if fd.enum is not None:
                extras.append("{'" + "', '".join(sorted(fd.enum)) + "'}")
            if fd.lower is not None or fd.upper is not None:
                extras.append(f"range=[{fd.lower}, {fd.upper}]")
            if fd.has_default:
                extras.append(f"default={fd.default!r}")
            else:
                extras.append("required")
            head = f"{key} : {tyname}"
            if extras:
                head += ", " + ", ".join(extras)
            lines.append(head)
            if fd.describe:
                lines.append(f"    {fd.describe}")
        return "\n".join(lines) + "\n"
