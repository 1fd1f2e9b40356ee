"""Compressed-field region serving: ``(quantity, t, lo, hi)`` queries
against a CZDataset answered through a tiered decode cache (port of
``repro.serve.region``).

The answers, counters and ``stats()`` keys are the reference's.  What the
port adds is the torch ``device`` of the dataset the server opens from a
root (default ``"cuda"``): every cold chunk is decoded there, by the
scheme's decode kernel on the card.

Three tiers answer a query, cheapest first:

1. **decoded-region LRU** (:class:`repro_torch.serve.cache.RegionCache`) — the
   exact box was served before and is still resident: zero decode, zero
   assembly.
2. **chunk LRU** (the store's pooled :class:`FieldReader` caches) — the
   covering chunks are resident: block gather + box assembly only.
3. **decode** — cold chunks are inflated, with concurrent duplicate work
   coalesced by :class:`repro_torch.serve.scheduler.ChunkScheduler` so each chunk
   is decoded once per miss however many requests are waiting on it.

:class:`FieldRegionServer` is transport-agnostic (in-process callers use it
directly; :mod:`repro_torch.serve.http` puts a socket in front) and safe for
concurrent request threads.
"""
from __future__ import annotations

import contextlib
import threading
import time

from repro_torch import DEFAULT_DEVICE, obs
from repro_torch.obs import context as _context
from repro_torch.obs import trace
from repro_torch.obs.sampling import TailSampler

from .cache import RegionCache
from .scheduler import ChunkScheduler, SingleFlight

__all__ = ["FieldRegionServer", "LatencyHistogram", "LATENCY_BUCKETS"]

#: Prometheus-style cumulative bucket bounds, seconds (+Inf is implicit).
#: Same bounds as :data:`repro_torch.obs.DEFAULT_BUCKETS` — kept as a named
#: constant because the serve tier's ``/metrics`` shape predates ``obs``.
LATENCY_BUCKETS = obs.DEFAULT_BUCKETS


class LatencyHistogram(obs.Histogram):
    """The serve tier's request-latency histogram — an
    :class:`repro_torch.obs.Histogram` pre-named for the ``/metrics`` exposition
    (``render_metrics`` registers the live instance, so scraped buckets are
    the ones ``observe`` filled — no copy, no drift).  ``snapshot()``
    (inherited) keeps the historical
    ``{"buckets": [(le, cum), ...], "sum": s, "count": n}`` shape."""

    def __init__(self, buckets=LATENCY_BUCKETS):
        super().__init__("cz_serve_request_seconds", "Region query latency.",
                         buckets=buckets)


class FieldRegionServer:
    """Serves ``(quantity, t, lo, hi)`` region queries from a CZDataset.

    The paper's §2.3 decompressor turned into a query server: the tiered
    cache + single-flight scheduler described in the module docstring, with
    request counters and a latency histogram for ``/metrics``.

    Parameters
    ----------
    dataset:
        A :class:`repro_torch.store.CZDataset` **or** a dataset root — a local
        path, a store URL (``file://``, ``mem://``, ``http://``, any
        registered backend), or a :class:`~repro.store.backends.Store`
        instance (the serve CLI passes a policy-wrapped store this way);
        the serve tier is backend-agnostic.  A root is opened — and
        therefore closed — by this server; a dataset object is borrowed,
        and :meth:`close` leaves it untouched (the caller opened it, the
        caller closes it).
    cache_bytes:
        Byte budget for the decoded-region LRU (``0`` disables it; chunk
        caching below is unaffected).
    max_inflight:
        Cap on *concurrent region decodes* (admission control; ``None`` =
        unbounded).  Deliberately scoped to the decode path only: cache
        hits and flight joins never wait on it, so a burst of cold requests
        cannot serialize the zero-cost hot path behind decodes.
    sample:
        Tail-based trace sampling (on by default): every query runs inside
        a collecting request context and its trace is *kept* only on error
        or slow-tail latency — see :class:`repro_torch.obs.sampling.TailSampler`.
        ``False`` turns the sampler off entirely (requests still get
        correlation IDs at the HTTP front).
    trace_budget_bytes:
        Byte budget for retained tail traces (oldest evicted first).
    trace_slow_ms:
        Fixed slow threshold in milliseconds; ``None`` (default) tracks the
        live p99 of this server's own latency histogram.
    prefetch:
        Chunks each reader fetches ahead of decode during a region query
        (``0`` = off).  Worth enabling over latency-bearing remote stores
        (``http://``); applies only to roots this server opens itself (a
        borrowed CZDataset keeps its own setting).
    device:
        Torch device of the dataset opened from a root (``"cuda"``, the
        default, or ``"cpu"``): its readers decode every cold chunk there.
        ``"cuda"`` without a GPU raises ``RuntimeError``.  A borrowed
        CZDataset keeps its own device.
    """

    def __init__(self, dataset, cache_readers: int = 16,
                 cache_chunks: int = 32, cache_bytes: int = 64 << 20,
                 max_inflight: int | None = None, sample: bool = True,
                 trace_budget_bytes: int = 4 << 20,
                 trace_slow_ms: float | None = None,
                 prefetch: int = 0, device=DEFAULT_DEVICE):
        from repro_torch.store import CZDataset
        from repro_torch.store.backends import Store

        # a path, URL, or bare Store is a *root* we open (and own) a
        # read-only dataset over; a CZDataset instance is borrowed as-is
        self._owns_dataset = isinstance(dataset, (str, bytes, Store)) or \
            hasattr(dataset, "__fspath__")
        if self._owns_dataset:
            root = dataset if isinstance(dataset, Store) else str(dataset)
            dataset = CZDataset(root, mode="r",
                                cache_readers=cache_readers,
                                cache_chunks=cache_chunks,
                                prefetch=prefetch, device=device)
        self.ds = dataset
        self.closed = False
        self.cache = RegionCache(cache_bytes)
        self.admission = (threading.BoundedSemaphore(int(max_inflight))
                          if max_inflight else contextlib.nullcontext())
        self.scheduler = ChunkScheduler(dataset)
        self._region_sf = SingleFlight()
        self._lock = threading.Lock()
        self.queries = 0
        self.bytes_served = 0
        self.latency = LatencyHistogram()
        slow_s = None if trace_slow_ms is None else float(trace_slow_ms) / 1e3
        self.sampler = (TailSampler(self.latency,
                                    budget_bytes=trace_budget_bytes,
                                    slow_s=slow_s)
                        if sample else None)

    # -- queries -----------------------------------------------------------

    def query(self, quantity: str, t: int, lo, hi, copy: bool = True):
        """Decode (or fetch from cache) the box ``[lo, hi)`` of one quantity
        at one timestep.

        ``copy=False`` returns the cache's shared **read-only** array —
        zero-copy for callers that only serialize it (the HTTP tier); the
        default hands back a private writable copy.
        """
        if self.closed:
            raise IOError("FieldRegionServer is closed")
        key = (str(quantity), int(t),
               tuple(int(v) for v in lo), tuple(int(v) for v in hi))
        # correlation scope: the HTTP front opens one per request (and its
        # ID wins); direct in-process callers get one here so the tail
        # sampler sees every query either way
        ctx = _context.current()
        own = (_context.request(collect=True)
               if ctx is None and self.sampler is not None
               else contextlib.nullcontext(ctx))
        with own as ctx:
            t0 = time.perf_counter()
            error = None
            try:
                with trace.span("serve.query", quantity=key[0], t=key[1]):
                    out = self.cache.get(key)
                    if out is None:
                        # coalesce identical in-flight regions, then
                        # chunk-level flights inside read_box take care of
                        # partial overlaps
                        out = self._region_sf.do(
                            key, lambda: self._decode_region(key))
            except BaseException as e:
                error = f"{type(e).__name__}: {e}"
                raise
            finally:
                # observe errors too — the tail sampler's slow threshold
                # and the kept-trace duration must agree with /metrics
                dt = time.perf_counter() - t0
                self.latency.observe(dt)
                if self.sampler is not None:
                    self.sampler.finish(ctx, dt, error=error)
        with self._lock:
            self.queries += 1
            self.bytes_served += out.nbytes
        return out.copy() if copy else out

    def _decode_region(self, key):
        quantity, t, lo, hi = key
        with self.admission:  # only actual decode work queues here
            out = self.scheduler.read_box(quantity, t, lo, hi)
        self.cache.put(key, out)  # freezes `out` read-only
        return out

    def manifest(self) -> dict:
        """The dataset summary served at ``/v1/manifest`` (one serializer
        shared with ``cz-compress inspect --json``)."""
        if self.closed:
            raise IOError("FieldRegionServer is closed")
        return self.ds.describe()

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Flat counter dict: store chunk-cache counters + region-cache,
        scheduler, and request-level counters."""
        s = self.ds.stats()
        lat = self.latency.snapshot()
        with self._lock:
            s.update({
                "queries": self.queries,
                "bytes_served": self.bytes_served,
                "mean_latency_ms": 1e3 * lat["sum"] / max(1, lat["count"]),
            })
        s.update({f"region_cache_{k}": v
                  for k, v in self.cache.stats().items()})
        s.update(self.scheduler.stats())
        s["region_flights_led"] = self._region_sf.led
        s["region_flights_joined"] = self._region_sf.joined
        if self.sampler is not None:
            s.update({f"trace_{k}": v
                      for k, v in self.sampler.stats().items()})
        return s

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Idempotent.  Closes the dataset only when this server opened it
        from a path — a borrowed :class:`CZDataset` stays open for its
        owner."""
        if self.closed:
            return
        self.closed = True
        if self._owns_dataset:
            self.ds.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
