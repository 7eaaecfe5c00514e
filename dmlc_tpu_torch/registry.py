"""Global name->factory registries with aliases and docs (the port's copy
of ``dmlc_tpu/registry.py``).

Rebuild of reference include/dmlc/registry.h:26-306 (Registry<EntryType>,
DMLC_REGISTRY_ENABLE/REGISTER, FunctionRegEntryBase). Python modules are the
natural link-tag mechanism, so DMLC_REGISTRY_FILE_TAG/LINK_TAG (:259-301)
map to plain imports.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, List, Optional, TypeVar

from .base import DMLCError

__all__ = ["Registry", "RegistryEntry"]

T = TypeVar("T")


class RegistryEntry(Generic[T]):
    """name + factory + metadata (FunctionRegEntryBase, registry.h:184-226)."""

    def __init__(self, name: str, body: Callable[..., T]):
        self.name = name
        self.body = body
        self.description = ""
        self.arguments: List[Dict[str, str]] = []
        self.return_type = ""

    def describe(self, text: str) -> "RegistryEntry[T]":
        self.description = text
        return self

    def add_argument(self, name: str, type_info: str, desc: str) -> "RegistryEntry[T]":
        self.arguments.append({"name": name, "type_info_str": type_info, "description": desc})
        return self

    def set_return_type(self, ty: str) -> "RegistryEntry[T]":
        self.return_type = ty
        return self

    def __call__(self, *args, **kwargs) -> T:
        return self.body(*args, **kwargs)


class Registry(Generic[T]):
    """Per-kind global registry (registry.h:26-181). Use
    ``Registry.get('parser')`` for the singleton of a kind."""

    _registries: Dict[str, "Registry"] = {}

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, RegistryEntry[T]] = {}
        self._canonical: Dict[str, str] = {}  # alias -> canonical name

    @classmethod
    def get(cls, kind: str) -> "Registry":
        reg = cls._registries.get(kind)
        if reg is None:
            reg = cls._registries[kind] = Registry(kind)
        return reg

    def register(self, name: str, body: Optional[Callable[..., T]] = None, override: bool = False):
        """Register a factory; usable as decorator::

            @Registry.get('parser').register('libsvm')
            def make_libsvm(...): ...
        """

        def do_register(fn: Callable[..., T]) -> Callable[..., T]:
            if name in self._entries and not override:
                raise DMLCError(f"{self.kind} registry: {name!r} already registered")
            self._entries[name] = RegistryEntry(name, fn)
            self._canonical[name] = name
            return fn

        if body is None:
            return do_register
        do_register(body)
        return self._entries[name]

    def entry(self, name: str) -> RegistryEntry[T]:
        """Fetch the entry object (to attach description/arguments)."""
        found = self.find(name)
        if found is None:
            raise DMLCError(f"{self.kind} registry: {name!r} not found")
        return found

    def add_alias(self, name: str, alias: str) -> None:
        """registry.h:108-118."""
        if name not in self._entries:
            raise DMLCError(f"{self.kind} registry: cannot alias unknown {name!r}")
        if alias in self._canonical and self._canonical[alias] != name:
            raise DMLCError(f"{self.kind} registry: alias {alias!r} already taken")
        self._canonical[alias] = name

    def find(self, name: str) -> Optional[RegistryEntry[T]]:
        canon = self._canonical.get(name)
        return self._entries.get(canon) if canon else None

    def create(self, name: str, *args, **kwargs) -> T:
        e = self.find(name)
        if e is None:
            raise DMLCError(
                f"{self.kind} registry: unknown entry {name!r}; "
                f"known: {self.list_all_names()}"
            )
        return e.body(*args, **kwargs)

    def list_entries(self) -> List[RegistryEntry[T]]:
        return list(self._entries.values())

    def list_all_names(self) -> List[str]:
        return sorted(self._canonical)
