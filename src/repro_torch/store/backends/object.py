"""RangeStore: an object-store-style backend with S3 access semantics.

The test double that keeps the read path honest.  Like a cloud object
store, it permits exactly two data operations:

* **whole-object put** — objects are immutable blobs, there is no seek,
  no append, no rename.  ``put_atomic`` *is* ``put`` (a single PUT is
  atomic), and the CZ2 writer goes through the buffering ``open_write``
  because you cannot patch a footer pointer in place;
* **byte-range get** — ``get(key, byte_range=(off, end))``, the S3
  ``Range: bytes=off-`` request.

Every request is counted (``stats()``) through a shared
:class:`~repro_torch.store.backends.instrument.StoreMeter`, so tests and
benchmarks can assert that a region query fetched *ranges of* a member,
not the member — the access pattern error-bounded compressors are judged
on — and the same tallies surface as ``cz_store_*`` series in the global
metrics registry.  The historical per-instance counters
(``get_requests`` etc.) remain readable as compat properties.  An optional
``latency`` models per-request round-trip cost so a benchmark can
show how chunk caching amortizes a remote store.
"""
from __future__ import annotations

import time

from .base import shared_io_pool
from .instrument import StoreMeter
from .memory import MemoryStore

__all__ = ["RangeStore"]


class RangeStore(MemoryStore):
    """Object-store semantics over in-memory blobs, with request counters."""

    scheme = "range"

    #: distinct ``range://`` namespace (MemoryStore's registry is per-class)
    _named: dict[str, "RangeStore"] = {}

    def __init__(self, name: str | None = None, latency: float = 0.0):
        super().__init__(name)
        self.latency = float(latency)
        self.meter = StoreMeter("range")

    def _request(self) -> None:
        if self.latency:
            time.sleep(self.latency)

    # -- historical counter attributes, now views over the meter ------------

    @property
    def get_requests(self) -> int:
        return self.meter.get_requests

    @property
    def range_requests(self) -> int:
        return self.meter.range_requests

    @property
    def put_requests(self) -> int:
        return self.meter.put_requests

    @property
    def bytes_fetched(self) -> int:
        return self.meter.bytes_fetched

    @property
    def bytes_put(self) -> int:
        return self.meter.bytes_put

    def get(self, key, byte_range=None):
        t0 = time.perf_counter()
        self._request()
        data = super().get(key, byte_range)
        self.meter.record("get", len(data), time.perf_counter() - t0,
                          ranged=byte_range is not None)
        return data

    def get_many(self, requests):
        """Pipelined ranged gets: each request still pays ``latency``, but
        the round trips overlap — what a real object store's concurrent
        range requests buy, and what the prefetch bench measures."""
        reqs = list(requests)
        if len(reqs) < 2:
            return [self.get(k, r) for k, r in reqs]
        pool = shared_io_pool()
        return [f.result()
                for f in [pool.submit(self.get, k, r) for k, r in reqs]]

    def put(self, key, data):
        t0 = time.perf_counter()
        self._request()
        super().put(key, data)
        self.meter.record("put", len(data), time.perf_counter() - t0)

    def stats(self) -> dict:
        """Request/traffic counters since construction."""
        out = self.meter.stats()
        del out["list_requests"]  # not part of the historical shape
        with self._guard:
            out["objects"] = len(self._objects)
            out["bytes_stored"] = sum(map(len, self._objects.values()))
        return out
