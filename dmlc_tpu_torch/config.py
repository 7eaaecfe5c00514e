"""``key = value`` config-file parser with quoting and proto-text output.

The port of ``dmlc_tpu/config.py`` (dmlc-core's include/dmlc/config.h:40-186
and src/config.cc:14-279):
``#`` comments, quoted strings with escapes, optional multi-value mode
(repeated keys accumulate), order-preserving iteration, and
``to_proto_string`` emission.
"""

from __future__ import annotations

import io
import shlex
from typing import Dict, Iterator, List, Tuple, Union

from .base import DMLCError

__all__ = ["Config"]


class Config:
    def __init__(self, source: Union[str, None] = None, multi_value: bool = False):
        """``source`` may be config text; use :meth:`load_file` for paths
        (Config::LoadFromStream, config.h:58-66)."""
        self._multi = multi_value
        self._order: List[Tuple[str, str]] = []
        self._map: Dict[str, List[str]] = {}
        if source is not None:
            self.load_string(source)

    def load_file(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            self.load_string(f.read())

    def load_string(self, text: str) -> None:
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise DMLCError(f"config line {lineno}: expected 'key = value': {raw!r}")
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip()
            # strip trailing comment unless inside quotes (config.cc tokenizer)
            if value and value[0] in "\"'":
                try:
                    parts = shlex.split(value, comments=True, posix=True)
                except ValueError as exc:
                    raise DMLCError(f"config line {lineno}: bad quoting: {raw!r}") from exc
                value = parts[0] if parts else ""
            else:
                hash_pos = value.find("#")
                if hash_pos >= 0:
                    value = value[:hash_pos].rstrip()
            if not key:
                raise DMLCError(f"config line {lineno}: empty key: {raw!r}")
            self.set_param(key, value)

    def set_param(self, key: str, value) -> None:
        value = str(value)
        if self._multi or key not in self._map:
            self._map.setdefault(key, []).append(value)
        else:
            self._map[key] = [value]
            # replace in order list
            self._order = [(k, v) for (k, v) in self._order if k != key]
        self._order.append((key, value))

    def get_param(self, key: str) -> str:
        if key not in self._map:
            raise DMLCError(f"config: key {key!r} not found")
        return self._map[key][-1]

    def get_all(self, key: str) -> List[str]:
        return list(self._map.get(key, []))

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        return iter(self._order)

    def items(self) -> List[Tuple[str, str]]:
        return list(self._order)

    def to_proto_string(self) -> str:
        """protobuf-text emission (Config::ToProtoString, config.h:96-102)."""
        out = io.StringIO()
        for key, value in self._order:
            escaped = value.replace("\\", "\\\\").replace('"', '\\"')
            out.write(f'{key} : "{escaped}"\n')
        return out.getvalue()
