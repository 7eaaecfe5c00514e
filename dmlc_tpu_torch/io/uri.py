"""URI and URISpec parsing (the port of ``dmlc_tpu/io/uri.py``).

``URI`` splits protocol/host/name (reference src/io/filesys.h:18-52);
``URISpec`` parses the ``path?format=k&a=b#cachefile`` sugar, giving a
cache file the ``.splitN.partI`` suffix per partition
(src/io/uri_spec.h:29-77).
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["URI", "URISpec"]


class URI:
    """protocol/host/name decomposition.

    ``file:///a/b`` -> protocol='file://', host='', name='/a/b'
    ``gs://bucket/x`` -> protocol='gs://', host='bucket', name='/x'
    plain paths get protocol 'file://'.
    """

    def __init__(self, uri: str):
        self.raw = uri
        p = uri.find("://")
        if p < 0:
            self.protocol = "file://"
            self.host = ""
            self.name = uri
        else:
            self.protocol = uri[: p + 3]
            rest = uri[p + 3:]
            if self.protocol == "file://":
                self.host = ""
                self.name = rest
            else:
                slash = rest.find("/")
                if slash < 0:
                    self.host, self.name = rest, ""
                else:
                    self.host, self.name = rest[:slash], rest[slash:]

    def str_uri(self) -> str:
        return self.protocol + self.host + self.name

    def __repr__(self) -> str:
        return f"URI({self.str_uri()!r})"


class URISpec:
    """Parses ``uri?key=value&...#cachefile``.

    ``args`` carries the query parameters (e.g. ``format=csv``);
    ``cache_file``, when present, gets the ``.splitN.partI`` suffix so
    each partition caches to its own file.
    """

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1):
        self.cache_file: Optional[str] = None
        self.args: Dict[str, str] = {}
        s = uri
        if "#" in s:
            s, cache = s.rsplit("#", 1)
            if num_parts != 1:
                cache = f"{cache}.split{num_parts}.part{part_index}"
            self.cache_file = cache
        if "?" in s:
            s, query = s.rsplit("?", 1)
            for kv in query.split("&"):
                if not kv:
                    continue
                if "=" in kv:
                    k, v = kv.split("=", 1)
                else:
                    k, v = kv, ""
                self.args[k] = v
        self.uri = s
