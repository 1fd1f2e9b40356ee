"""MemoryStore: dict-backed byte store for tests and ephemeral in-situ runs.

Anonymous instances (``MemoryStore()``) are private to their creator.
*Named* instances — ``MemoryStore.named("x")``, or any ``mem://x`` URL —
live in a process-global registry, so two ``CZDataset("mem://x")`` handles
in one process share the same bytes: an in-situ writer thread can append
while a serve replica reads, with no filesystem at all.
"""
from __future__ import annotations

import threading

from .base import Store, StoreKeyError, check_key, check_range

__all__ = ["MemoryStore"]


class MemoryStore(Store):
    """In-memory byte store (thread-safe; objects are immutable bytes)."""

    scheme = "mem"

    #: process-global name -> instance registry behind ``mem://`` URLs.
    #: Class-scoped so subclasses (RangeStore) get their own namespace.
    _named: dict[str, "MemoryStore"] = {}
    _named_guard = threading.Lock()

    def __init__(self, name: str | None = None):
        super().__init__()
        self.name = name
        self._objects: dict[str, bytes] = {}
        self._guard = threading.Lock()

    @classmethod
    def named(cls, name: str) -> "MemoryStore":
        """The shared registry instance for ``{scheme}://{name}`` (created
        on first use)."""
        if not name:
            raise ValueError(
                f"{cls.scheme}:// URLs need a name ({cls.scheme}://myds) — "
                "an anonymous store could never be reopened")
        registry = cls.__dict__.get("_named")
        if registry is None:  # first named instance of this subclass
            registry = {}
            setattr(cls, "_named", registry)
        with MemoryStore._named_guard:
            store = registry.get(name)
            if store is None:
                store = registry[name] = cls(name)
        return store

    @classmethod
    def drop(cls, name: str) -> None:
        """Forget a named store (tests/benchmarks reclaiming memory)."""
        with MemoryStore._named_guard:
            cls.__dict__.get("_named", {}).pop(name, None)

    from_url = named

    # -- primitives ----------------------------------------------------------

    def get(self, key, byte_range=None):
        check_key(key)
        with self._guard:
            try:
                data = self._objects[key]
            except KeyError:
                raise StoreKeyError(key) from None
        if byte_range is None:
            return data
        start, end = byte_range
        start = check_range(key, start, len(data))
        return data[start:] if end is None else data[start:int(end)]

    def put(self, key, data):
        check_key(key)
        data = bytes(data)
        with self._guard:
            self._objects[key] = data

    def list(self, prefix=""):
        with self._guard:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key):
        check_key(key)
        with self._guard:
            if self._objects.pop(key, None) is None:
                raise StoreKeyError(key)

    def exists(self, key):
        with self._guard:
            return key in self._objects

    @property
    def url(self) -> str:
        name = self.name if self.name is not None else f"anon-{id(self):x}"
        return f"{self.scheme}://{name}"
