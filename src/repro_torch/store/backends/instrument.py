"""Store instrumentation: per-op counters/bytes/latency for any backend.

:class:`RangeStore` proved the idea — its private request/byte tallies are
what lets tests assert that a region query fetched *ranges of* a member.
This module generalizes that accounting to every backend:

* :class:`StoreMeter` — one instance's tally (requests and bytes per op,
  with range gets split out), doubling as the bridge into the process-wide
  :data:`repro_torch.obs.REGISTRY`: every recorded op also lands in the labelled
  metrics ``cz_store_ops_total{backend,op}``,
  ``cz_store_bytes_total{backend,op}`` and the latency histogram
  ``cz_store_op_seconds{backend,op}``.
* :class:`InstrumentedStore` — a delegating wrapper (same shape as
  :class:`FlakyStore`) that times ``get``/``put``/``put_atomic``/``list``/
  ``delete``/``exists`` on any inner :class:`Store` and feeds a meter.
  ``open_write``/``lock`` delegate untouched so :class:`FileStore` keeps
  its streaming, one-chunk-in-memory writer — streaming writes are only
  attributed on backends whose sink commits through ``put``.

``open_store(root, instrument=True)`` wraps any resolved backend.
"""
from __future__ import annotations

import threading
import time

from repro_torch import obs
from repro_torch.obs import FAST_BUCKETS

from .base import Store

__all__ = ["StoreMeter", "InstrumentedStore"]

_OPS = obs.counter("cz_store_ops_total",
                   "Store operations by backend and op.",
                   labelnames=("backend", "op"))
_BYTES = obs.counter("cz_store_bytes_total",
                     "Bytes moved through store ops (payload size).",
                     labelnames=("backend", "op"))
_SECONDS = obs.histogram("cz_store_op_seconds",
                         "Store operation latency by backend and op.",
                         buckets=FAST_BUCKETS,
                         labelnames=("backend", "op"))


class StoreMeter:
    """Request/byte tally for one store instance.

    ``record`` is the single entry point: it bumps the per-instance
    counters (readable via attributes or :meth:`stats`) *and* the global
    registry series for ``backend``.  The attribute names intentionally
    match :class:`RangeStore`'s historical public counters so that class
    can expose its meter through compat properties.
    """

    __slots__ = ("backend", "get_requests", "range_requests", "put_requests",
                 "list_requests", "bytes_fetched", "bytes_put", "_guard")

    def __init__(self, backend: str):
        self.backend = str(backend)
        self.get_requests = 0
        self.range_requests = 0    # subset of get_requests
        self.put_requests = 0     # put + put_atomic
        self.list_requests = 0
        self.bytes_fetched = 0
        self.bytes_put = 0
        self._guard = threading.Lock()

    def record(self, op: str, nbytes: int = 0, seconds: float | None = None,
               ranged: bool = False) -> None:
        """Account one completed operation.

        ``op`` is one of ``get``/``put``/``put_atomic``/``list``/``delete``/
        ``exists``; ``nbytes`` is the payload size (fetched for gets, stored
        for puts); ``seconds`` feeds the latency histogram when the caller
        timed the op.
        """
        with self._guard:
            if op == "get":
                self.get_requests += 1
                if ranged:
                    self.range_requests += 1
                self.bytes_fetched += nbytes
            elif op in ("put", "put_atomic"):
                self.put_requests += 1
                self.bytes_put += nbytes
            elif op == "list":
                self.list_requests += 1
        _OPS.inc(backend=self.backend, op=op)
        if nbytes:
            _BYTES.inc(nbytes, backend=self.backend, op=op)
        if seconds is not None:
            _SECONDS.observe(seconds, backend=self.backend, op=op)

    def stats(self) -> dict:
        """Counters since construction (RangeStore-compatible key names)."""
        with self._guard:
            return {
                "get_requests": self.get_requests,
                "range_requests": self.range_requests,
                "put_requests": self.put_requests,
                "list_requests": self.list_requests,
                "bytes_fetched": self.bytes_fetched,
                "bytes_put": self.bytes_put,
            }


class InstrumentedStore(Store):
    """Delegating store that meters every operation on ``inner``.

    ``backend`` defaults to the inner store's URL scheme (falling back to
    its class name) and becomes the ``backend`` label on the global
    ``cz_store_*`` series; ``.meter`` holds this wrapper's own tally.
    """

    def __init__(self, inner: Store, backend: str | None = None):
        super().__init__()
        self.inner = inner
        label = backend or inner.scheme or type(inner).__name__.lower()
        self.meter = StoreMeter(label)

    def _timed(self, op, fn, *args, nbytes=None, ranged=False):
        t0 = time.perf_counter()
        result = fn(*args)
        dt = time.perf_counter() - t0
        if nbytes is None:
            nbytes = len(result) if op == "get" else 0
        self.meter.record(op, nbytes, dt, ranged=ranged)
        return result

    def get(self, key, byte_range=None):
        return self._timed("get", self.inner.get, key, byte_range,
                           ranged=byte_range is not None)

    def get_many(self, requests):
        """Forward the batch to the inner store (keeping its pipelining)
        and meter each constituent get."""
        reqs = list(requests)
        out = self.inner.get_many(reqs)
        for (_key, rng), data in zip(reqs, out):
            self.meter.record("get", len(data), ranged=rng is not None)
        return out

    def put(self, key, data):
        return self._timed("put", self.inner.put, key, data,
                           nbytes=len(data))

    def put_atomic(self, key, data):
        return self._timed("put_atomic", self.inner.put_atomic, key, data,
                           nbytes=len(data))

    def list(self, prefix=""):
        return self._timed("list", self.inner.list, prefix)

    def delete(self, key):
        return self._timed("delete", self.inner.delete, key)

    def exists(self, key):
        return self._timed("exists", self.inner.exists, key)

    def open_write(self, key):
        return self.inner.open_write(key)

    def lock(self, name):
        return self.inner.lock(name)

    def stats(self) -> dict:
        return self.meter.stats()

    @property
    def url(self) -> str:
        return self.inner.url
