"""Request-scoped correlation: one ID per request, visible to every tier.

The serve tier's production question — *why was this one query slow?* —
needs every span, metric observation, and log line a request touched to
carry the same identifier.  This module provides that identifier as a
:mod:`contextvars` context: the HTTP front mints (or honors) an
``X-CZ-Request-Id``, enters a :class:`RequestContext`, and everything
downstream on that thread — :class:`FieldRegionServer`,
``ChunkScheduler``/``SingleFlight``, ``FieldReader``, the byte store —
sees it through :func:`request_id` without any parameter plumbing.

A :class:`RequestContext` can also *collect*: when ``collect=True`` every
span recorded while the context is active (via :func:`repro_torch.obs.trace.span`
/ ``trace.record``) is appended to a bounded per-request event list.  That
list is what the tail sampler (:mod:`repro_torch.obs.sampling`) keeps when a
request errors or lands in the latency tail — a complete per-request
timeline at a cost bounded by ``max_events``.

Stdlib only — importable before numpy/jax.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
import threading
import time
import uuid

__all__ = ["RequestContext", "current", "request", "request_id",
           "new_request_id", "clean_id"]

#: IDs a client may supply (anything else is replaced with a minted one):
#: URL/header/filename-safe, bounded length.
_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")

_REQUEST: contextvars.ContextVar["RequestContext | None"] = \
    contextvars.ContextVar("cz_request", default=None)


def new_request_id() -> str:
    """A fresh 16-hex-char request ID."""
    return uuid.uuid4().hex[:16]


def clean_id(value) -> str | None:
    """``value`` if it is a usable client-supplied request ID, else None.

    The HTTP front honors ``X-CZ-Request-Id`` from clients (so a caller can
    correlate its own logs with ours) but never echoes arbitrary bytes back
    into headers, traces, and event lines."""
    if isinstance(value, str) and _ID_RE.fullmatch(value):
        return value
    return None


class RequestContext:
    """One request's identity (+ optional span collection).

    ``events`` holds ``{"name", "ts_us", "dur_us", "args"}`` rows relative
    to the context's start, appended by ``repro_torch.obs.trace`` while the
    context is active and ``collecting``; growth is capped at
    ``max_events`` (overflow counted in ``dropped``, never unbounded).
    ``finished`` is the tail sampler's once-only latch.
    """

    __slots__ = ("rid", "collecting", "max_events", "events", "dropped",
                 "started_ns", "wall_time", "finished", "_lock")

    def __init__(self, rid: str | None = None, collect: bool = False,
                 max_events: int = 512):
        self.rid = rid or new_request_id()
        self.collecting = bool(collect)
        self.max_events = int(max_events)
        self.events: list[dict] = []
        self.dropped = 0
        self.started_ns = time.perf_counter_ns()
        self.wall_time = time.time()
        self.finished = False
        self._lock = threading.Lock()

    def record(self, name: str, t0_ns: int, t1_ns: int,
               args: dict | None = None) -> None:
        """Append one complete span (perf-counter stamps) to this request's
        timeline.  No-op unless collecting; bounded by ``max_events``."""
        if not self.collecting:
            return
        ev = {"name": name,
              "ts_us": round((t0_ns - self.started_ns) / 1e3, 1),
              "dur_us": round((t1_ns - t0_ns) / 1e3, 1)}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(ev)

    def instant(self, name: str, **args) -> None:
        """Mark a point in time on this request's timeline."""
        now = time.perf_counter_ns()
        self.record(name, now, now, args or None)

    def __repr__(self) -> str:
        return (f"RequestContext(rid={self.rid!r}, "
                f"events={len(self.events)}, collecting={self.collecting})")


def current() -> RequestContext | None:
    """The active request context, or None outside any request."""
    return _REQUEST.get()


def request_id() -> str | None:
    """The active request's ID, or None outside any request."""
    ctx = _REQUEST.get()
    return ctx.rid if ctx is not None else None


@contextlib.contextmanager
def request(rid: str | None = None, collect: bool = False,
            max_events: int = 512):
    """Enter a request scope: ``with context.request(rid) as ctx: ...``.

    Nested scopes shadow the outer one (the inner request gets its own ID
    and timeline) and restore it on exit.
    """
    ctx = RequestContext(rid, collect=collect, max_events=max_events)
    token = _REQUEST.set(ctx)
    try:
        yield ctx
    finally:
        _REQUEST.reset(token)
