"""Low-overhead span tracing exported as Chrome trace-event JSON.

The paper's per-stage timing figure, reproduced as a timeline: wrap any
region of work in ``with span("encode", chunk=i):`` (or decorate it with
:func:`traced`) and, when tracing is enabled, a complete event (``"ph":
"X"``) lands on the current thread's track.  :meth:`Tracer.save` writes the
collected events as Chrome trace-event JSON — load the file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` to see per-thread and
per-rank tracks.

A process that is one rank of a group (the rank-parallel snapshot path)
sets its rank once with :func:`set_rank`; every event it records from then
on carries ``rank`` in its ``args``, and :func:`gather_events` brings every
rank's events onto one rank's timeline at the end of a run.

Disabled is the default and costs almost nothing: :func:`span` returns a
shared no-op context manager after one attribute check, so instrumented hot
paths (per-chunk encode, store gets) stay within noise when nobody is
tracing (the ``bench_speed`` overhead budget is < 2%).

Spans nest: each one recorded through the module's helpers carries an
``id`` and the ``parent`` id of the span that caused it in its ``args``
(ids are unique within one process).  The parent is the innermost span
still open on the recording thread, or the ``parent=`` a caller passes,
as the pipeline does for chunk encodes on its pool's threads.  Device
times arrive late: :meth:`Tracer.defer` holds a callable that finishes an
event (the CUDA-event pair of ``repro_torch.kernels._obs.device_span``),
run before the events are next read.

Clocks are monotonic (``time.perf_counter_ns``); each tracer also anchors a
wall-clock epoch at :meth:`Tracer.enable` so traces from *different
processes* can be merged onto one timeline: the cluster engine's worker
ranks each dump a trace file, and the parent folds them in with
:meth:`Tracer.absorb` (or standalone :func:`merge_traces`), one ``pid``
track per rank.

Stdlib only — importable before numpy/jax.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

from repro_torch.obs import context as _context

__all__ = ["Tracer", "TRACER", "span", "traced", "tracing", "enable",
           "disable", "record", "next_id", "current_id", "reset", "save",
           "merge_traces", "set_rank", "gather_events"]


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    """A live span: open on its thread's stack from enter to exit, so the
    spans begun inside it name it as their parent.  ``event`` is the
    tracer's event once the span has closed (``None`` where only a request
    context collected it)."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_id", "_parent", "event")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args
        self.event = None

    def __enter__(self):
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        self._id = self._tracer.new_id()
        stack.append(self._id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = self._tracer._stack()
        if self._id in stack:  # gone only after a reset() inside the span
            stack.remove(self._id)
        self.event = _emit(self._tracer, self._name, self._t0, t1,
                           {**self._args, "id": self._id, "parent": self._parent})
        return False


def _emit(tracer: "Tracer", name: str, t0_ns: int, t1_ns: int,
          args: dict) -> dict | None:
    """Deliver one completed span to the tracer *and* the active request
    context: the request ID is stamped onto the tracer event (so one slow
    query is findable on the Perfetto timeline) and, when the context is
    collecting, the span joins the per-request timeline the tail sampler
    may keep."""
    ctx = _context.current()
    if ctx is not None:
        if args.get("rid") is None:
            args = {**args, "rid": ctx.rid} if args else {"rid": ctx.rid}
        ctx.record(name, t0_ns, t1_ns, args)
    return tracer.record(name, t0_ns, t1_ns, **args)


class Tracer:
    """One process's span collector.

    Thread-safe; every thread gets its own track (``tid``) named after
    ``threading.current_thread().name``.  ``process_name`` labels the
    ``pid`` track in viewers (the cluster engine sets ``"rank N"`` in its
    workers).
    """

    def __init__(self, process_name: str | None = None):
        self.enabled = False
        self.pid = os.getpid()
        self.process_name = process_name or "main"
        #: this process's rank in its group, stamped on every event it
        #: records (``None``: not one rank of a group)
        self.rank = None
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._threads: dict[int, str] = {}
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._deferred: list = []
        self._origin_ns = time.perf_counter_ns()
        self._epoch_us = time.time_ns() // 1000

    # -- lifecycle -----------------------------------------------------------

    def enable(self) -> None:
        """Start collecting (idempotent).  Re-anchors the clock only when
        turning on from scratch, so enable/disable around phases of one run
        share a timeline."""
        with self._lock:
            if not self.enabled and not self._events:
                self._origin_ns = time.perf_counter_ns()
                self._epoch_us = time.time_ns() // 1000
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop all events and re-anchor the clock (enabled state kept)."""
        with self._lock:
            self._events.clear()
            self._threads.clear()
            self._deferred.clear()
            self._local = threading.local()
            self._origin_ns = time.perf_counter_ns()
            self._epoch_us = time.time_ns() // 1000

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **args):
        """Context manager timing one region of work.  A no-op singleton
        when disabled — the enabled check is the only cost."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, args)

    def new_id(self) -> int:
        """A fresh span id (``itertools.count`` steps atomically)."""
        return next(self._ids)

    def _stack(self) -> list:
        """The ids of the spans open on the calling thread, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_id(self) -> int | None:
        """The innermost span open on the calling thread, if any."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def defer(self, finish) -> None:
        """Run ``finish()`` once, before the events are next read: for an
        event whose ``args`` wait on something the host did not wait for
        (the device's time of a span)."""
        with self._lock:
            self._deferred.append(finish)

    def _tid(self) -> int:
        tid = getattr(self._local, "tid", None)
        if tid is None:
            with self._lock:
                tid = self._local.tid = len(self._threads)
                self._threads[tid] = threading.current_thread().name
        return tid

    def record(self, name: str, t0_ns: int, t1_ns: int, **args) -> dict | None:
        """Append one complete event from explicit ``perf_counter_ns``
        stamps — for instrumentation that already timed the work (the
        pipeline's per-chunk path computes bytes/ratio after the fact).
        Returns the event (``None`` while disabled), whose ``args`` a
        :meth:`defer` callable may complete."""
        if not self.enabled:
            return None
        if self.rank is not None and "rank" not in args:
            args["rank"] = self.rank
        ev = {"name": name, "ph": "X", "cat": "repro",
              "ts": (t0_ns - self._origin_ns) / 1e3,
              "dur": (t1_ns - t0_ns) / 1e3,
              "pid": self.pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)
        return ev

    def instant(self, name: str, **args) -> None:
        """Mark a point in time (``"ph": "i"``)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "cat": "repro",
              "ts": (time.perf_counter_ns() - self._origin_ns) / 1e3,
              "pid": self.pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            deferred, self._deferred = self._deferred, []
        for finish in deferred:
            finish()
        with self._lock:
            return [dict(ev) for ev in self._events]

    def _metadata_events(self) -> list[dict]:
        with self._lock:
            threads = dict(self._threads)
        evs = [{"name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
                "args": {"name": self.process_name}}]
        for tid, tname in threads.items():
            evs.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                        "tid": tid, "args": {"name": tname}})
        return evs

    def chrome(self) -> dict:
        """The Chrome trace-event document (``traceEvents`` + metadata).
        Events are sorted by timestamp; ``metadata.epoch_us`` anchors this
        process's monotonic origin to the wall clock for cross-process
        merges."""
        evs = self.events()
        # absorbed child docs contribute their own ph="M" rows (no ts) —
        # metadata leads, timed events sort globally
        meta = [e for e in evs if e.get("ph") == "M"]
        timed = sorted((e for e in evs if e.get("ph") != "M"),
                       key=lambda e: e["ts"])
        return {"traceEvents": self._metadata_events() + meta + timed,
                "displayTimeUnit": "ms",
                "metadata": {"epoch_us": self._epoch_us,
                             "process_name": self.process_name}}

    def save(self, path: str) -> str:
        """Write the Chrome trace JSON; returns ``path``."""
        doc = self.chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def absorb(self, doc: dict, pid=None, process_name: str | None = None
               ) -> int:
        """Fold another process's saved trace document into this tracer,
        shifting its timestamps onto this timeline via the wall-clock
        anchors.  ``pid`` reassigns the absorbed events' track (the cluster
        engine passes the rank number); returns the event count absorbed."""
        shift = (doc.get("metadata", {}).get("epoch_us", self._epoch_us)
                 - self._epoch_us)
        absorbed = []
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            if pid is not None:
                ev["pid"] = pid
            if ev.get("ph") == "M":
                if process_name is not None and \
                        ev.get("name") == "process_name":
                    ev["args"] = {"name": process_name}
            else:
                ev["ts"] = float(ev.get("ts", 0.0)) + shift
            absorbed.append(ev)
        with self._lock:
            self._events.extend(absorbed)
        return len(absorbed)


#: the process-wide tracer (module-level helpers target it).
TRACER = Tracer()


def span(name: str, **args):
    """``with span("encode", chunk=i): ...`` against the process tracer.

    Live when the process tracer is enabled **or** the calling thread is
    inside a collecting request context (the serve tier's tail sampling) —
    otherwise the shared no-op singleton, so uninstrumented runs pay two
    cheap checks."""
    if TRACER.enabled:
        return _Span(TRACER, name, args)
    ctx = _context.current()
    if ctx is not None and ctx.collecting:
        return _Span(TRACER, name, args)
    return _NULL


def record(name: str, t0_ns: int, t1_ns: int, **args) -> dict | None:
    """Record one already-timed span against the process tracer *and* the
    active request context (instrumentation that computes byte counts after
    the fact uses this instead of :func:`span`).  ``id=`` gives the span an
    id taken earlier from :func:`next_id`; ``parent=`` names its parent,
    by default the innermost span open on this thread.  Returns the
    tracer's event, if it recorded one."""
    if TRACER.enabled or _context.current() is not None:
        if "id" not in args:
            args["id"] = TRACER.new_id()
        if "parent" not in args:
            args["parent"] = TRACER.current_id()
        return _emit(TRACER, name, t0_ns, t1_ns, args)
    return None


def next_id() -> int | None:
    """An id for a span to be recorded later with :func:`record`, so that
    spans recorded before it, on any thread, can name it as their parent;
    ``None`` while nothing records."""
    if TRACER.enabled:
        return TRACER.new_id()
    ctx = _context.current()
    return TRACER.new_id() if ctx is not None and ctx.collecting else None


def current_id() -> int | None:
    """The id of the innermost span open on the calling thread, if any."""
    return TRACER.current_id()


def traced(name: str | None = None, **cargs):
    """Decorator form: ``@traced()`` (span named after the function) or
    ``@traced("stage1", scheme="wavelet")``."""
    import functools

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with span(label, **cargs):
                return fn(*a, **k)

        return wrapper

    return deco


def tracing() -> bool:
    return TRACER.enabled


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def reset() -> None:
    TRACER.reset()


def save(path: str) -> str:
    return TRACER.save(path)


def set_rank(rank: int | None) -> None:
    """Stamp ``rank`` on every event this process records from now on."""
    TRACER.rank = None if rank is None else int(rank)


def gather_events(group=None, dst: int = 0) -> list[dict] | None:
    """Every rank's events, on rank ``dst`` of ``group``, ``None`` on the
    others: a collective, called by every rank at the same point.  Each
    rank's events are shifted onto ``dst``'s timeline by the tracers'
    wall-clock anchors (as :meth:`Tracer.absorb` shifts them), so their
    ``ts`` count from ``dst``'s origin; their ``args`` keep each rank's
    ``rank``.  Deferred device times are completed first, on each rank."""
    from repro_torch.dist.collective import gather_objects

    got = gather_objects((TRACER.events(), TRACER._epoch_us), group, dst=dst)
    if got is None:
        return None
    out = []
    for evs, epoch_us in got:
        shift = epoch_us - TRACER._epoch_us
        out += [{**ev, "ts": ev["ts"] + shift} if "ts" in ev else ev for ev in evs]
    return out


def merge_traces(sources, out: str | None = None, pids=None) -> dict:
    """Merge saved trace files (paths or already-loaded documents) into one
    Chrome trace document on a common timeline.

    Timestamps are aligned via each document's ``metadata.epoch_us`` anchor
    (earliest anchor becomes t=0); ``pids`` optionally reassigns each
    source's events to a track (e.g. ``pids=range(nranks)`` for per-rank
    files).  Non-metadata events come out globally sorted by timestamp.
    ``out`` additionally writes the merged document to a file.
    """
    docs = []
    for src in sources:
        if isinstance(src, (str, os.PathLike)):
            with open(src) as f:
                docs.append(json.load(f))
        else:
            docs.append(src)
    if not docs:
        raise ValueError("merge_traces needs at least one source")
    anchors = [d.get("metadata", {}).get("epoch_us", 0) for d in docs]
    base = min(anchors)
    meta: list[dict] = []
    events: list[dict] = []
    for i, (doc, anchor) in enumerate(zip(docs, anchors)):
        pid = None if pids is None else pids[i]
        shift = anchor - base
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            if pid is not None:
                ev["pid"] = pid
            if ev.get("ph") == "M":
                meta.append(ev)
            else:
                ev["ts"] = float(ev.get("ts", 0.0)) + shift
                events.append(ev)
    events.sort(key=lambda e: e["ts"])
    merged = {"traceEvents": meta + events, "displayTimeUnit": "ms",
              "metadata": {"epoch_us": base, "merged_from": len(docs)}}
    if out is not None:
        with open(out, "w") as f:
            json.dump(merged, f)
    return merged
