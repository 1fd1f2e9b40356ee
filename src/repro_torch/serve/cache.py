"""Decoded-region LRU for the serving tier (port of ``repro.serve.cache``;
framework-free, the same class).

Sits *above* the store's per-member chunk LRU: a chunk-cache hit still pays
block gather + box assembly, a region-cache hit pays nothing — the array
that answered the last identical query is handed back as-is.  Budgeted in
bytes (decoded regions vary wildly in size, so an entry-count cap would be
meaningless), thread-safe, and entries are frozen read-only so a hit can be
shared across request threads without copies.
"""
from __future__ import annotations

import collections
import threading

import numpy as np

__all__ = ["RegionCache"]


class RegionCache:
    """Byte-budgeted LRU of decoded region arrays.

    Keys are whatever tuple the caller hashes a query down to (the serving
    tier uses ``(quantity, t, lo, hi)``).  Values are numpy arrays; they are
    marked non-writeable on insert, and :meth:`get` returns the shared
    read-only array — callers that need to mutate must copy.

    An array larger than the whole budget is never admitted (it would evict
    everything for a single entry); ``max_bytes <= 0`` disables caching
    entirely while keeping the counters alive.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict[tuple, np.ndarray] = \
            collections.OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key) -> np.ndarray | None:
        with self._lock:
            arr = self._entries.get(key)
            if arr is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return arr

    def put(self, key, arr: np.ndarray) -> bool:
        """Admit one decoded region; returns whether it was cached.

        Admitted arrays are frozen read-only **in place** (when already
        contiguous) — the cache and its callers share one buffer."""
        if arr.nbytes > self.max_bytes:
            return False  # would evict everything for one entry
        arr = np.ascontiguousarray(arr)
        arr.flags.writeable = False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[key] = arr
            self.bytes += arr.nbytes
            while self.bytes > self.max_bytes:
                _, evicted = self._entries.popitem(last=False)
                self.bytes -= evicted.nbytes
                self.evictions += 1
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes = 0

    def stats(self) -> dict:
        with self._lock:
            n = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / n if n else None,
            }

    def __repr__(self) -> str:
        s = self.stats()
        return (f"RegionCache({s['entries']} entries, {s['bytes']}/"
                f"{s['max_bytes']}B, hits={s['hits']} misses={s['misses']})")
