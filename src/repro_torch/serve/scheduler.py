"""Single-flight decode scheduling for concurrent region queries (port of
``repro.serve.scheduler``).

The sglang-style batching analog for a *decompression* server: when many
request threads need the same CZ2 chunk at the same time, exactly one of
them (the *leader*) decodes it; the rest park on a future and share the
result.  Without this, N concurrent cold requests for a hot region decode
every covering chunk up to N times — the store's per-reader LRU only
dedupes *sequential* repeats, and under eviction pressure (small
``cache_chunks``) not even those.

Flights are keyed by ``(member path, chunk index)``: the member path is
stable across the dataset's reader pool (a reader evicted and re-created
mid-flight still coalesces), and chunk granularity means two requests for
*different* boxes that merely share one chunk still split the decode work.

A chunk's decode is :meth:`FieldReader.fetch_chunk` of the port, which
launches the scheme's decode kernel on the reader's torch device: one
launch per chunk decoded, however many requests wait on the flight.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time

import numpy as np

from repro_torch.obs import context as _context
from repro_torch.obs import trace

__all__ = ["SingleFlight", "ChunkScheduler"]


class _Flight:
    """One in-flight computation: the shared future plus the request
    correlation needed for coalescing-aware traces — the leader's request
    ID, and the IDs of every request that parked on this flight instead of
    doing the work itself."""

    __slots__ = ("future", "leader_rid", "followers")

    def __init__(self, leader_rid: str | None):
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        self.leader_rid = leader_rid
        self.followers: list[str] = []


class SingleFlight:
    """Generic duplicate-call suppressor: concurrent :meth:`do` calls with
    the same key run ``fn`` once and all observe its result (or its
    exception).  Calls that arrive after the flight lands run ``fn`` again —
    long-term memory is the *cache's* job, not the scheduler's.

    Coalescing is request-correlated: a follower's request ID is appended
    to the flight (under the lock) and lands on the **leader's**
    ``serve.flight`` span, so a kept tail trace of the leader shows exactly
    which other requests drafted behind it; each follower's own timeline
    gets a ``serve.flight.wait`` span naming the leader it parked on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: dict[object, _Flight] = {}
        self.led = 0        # calls that executed fn
        self.joined = 0     # calls coalesced onto an existing flight

    def in_flight(self, key) -> bool:
        """Whether a flight for ``key`` is currently airborne — the veto the
        reader's prefetcher consults so it never issues a byte-range fetch
        another request's decode is already performing."""
        with self._lock:
            return key in self._flights

    def do(self, key, fn):
        rid = _context.request_id()
        with self._lock:
            flight = self._flights.get(key)
            leader = flight is None
            if leader:
                flight = self._flights[key] = _Flight(rid)
                self.led += 1
            else:
                self.joined += 1
                if rid is not None:
                    flight.followers.append(rid)
        if leader:
            t0 = time.perf_counter_ns()
            try:
                flight.future.set_result(fn())
            except BaseException as e:
                flight.future.set_exception(e)
            finally:
                # land the flight *after* the result is set: late arrivals
                # start a fresh flight (and hit the cache) instead of joining
                # a completed one.  Popping under the lock also freezes the
                # follower list — nobody can join a landed flight.
                with self._lock:
                    self._flights.pop(key, None)
                    followers = list(flight.followers)
                if followers:
                    trace.record("serve.flight", t0, time.perf_counter_ns(),
                                 key=str(key), followers=followers)
            return flight.future.result()
        t0 = time.perf_counter_ns()
        try:
            return flight.future.result()
        finally:
            trace.record("serve.flight.wait", t0, time.perf_counter_ns(),
                         key=str(key), leader=flight.leader_rid)


class ChunkScheduler:
    """Coalesces chunk decodes across all request threads of one dataset.

    Wraps :meth:`FieldReader.read_box` with a ``chunk_getter`` that routes
    every chunk fetch through a :class:`SingleFlight`, so each chunk is
    decoded **once per cache miss** no matter how many requests need it
    concurrently.  Chunk *caching* stays where it was — in the reader's LRU
    (and the region LRU above) — the scheduler only owns in-flight work.
    """

    def __init__(self, dataset):
        self.ds = dataset
        self._sf = SingleFlight()
        self._lock = threading.Lock()
        self.bytes_decoded = 0

    @property
    def flights_led(self) -> int:
        return self._sf.led

    @property
    def flights_joined(self) -> int:
        return self._sf.joined

    def read_box(self, quantity: str, t: int, lo, hi) -> np.ndarray:
        reader = self.ds.reader(quantity, int(t))
        # pin each covering chunk for the duration of this request: under
        # LRU pressure (small cache_chunks + concurrent cross-traffic) the
        # reader's cache alone would let one box re-decode its own chunk
        pinned: dict[int, np.ndarray] = {}

        def get(ci: int) -> np.ndarray:
            out = pinned.get(ci)
            if out is None:
                out = pinned[ci] = self._chunk(reader, ci)
            return out

        return reader.read_box(
            lo, hi, chunk_getter=get,
            prefetch_skip=lambda ci: self._sf.in_flight((reader.path, ci)))

    def _chunk(self, reader, ci: int) -> np.ndarray:
        return self._sf.do((reader.path, ci),
                           lambda: self._fetch(reader, ci))

    def _fetch(self, reader, ci: int) -> np.ndarray:
        out, decoded = reader.fetch_chunk(ci)
        if decoded:  # a real decode, not an LRU hit
            with self._lock:
                self.bytes_decoded += out.nbytes
        return out

    def stats(self) -> dict:
        return {
            "flights_led": self._sf.led,
            "flights_joined": self._sf.joined,
            "bytes_decoded": self.bytes_decoded,
        }
