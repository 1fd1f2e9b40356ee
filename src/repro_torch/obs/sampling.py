"""Always-on tail-based trace sampling for the serve tier.

Head sampling (trace every Nth request) misses exactly the requests worth
keeping; tail sampling records *every* request cheaply and decides at
completion.  The flow:

1. each request runs inside a collecting :class:`~repro_torch.obs.context.
   RequestContext` — every span the request touched lands on its bounded
   per-request timeline;
2. at completion, :meth:`TailSampler.finish` keeps the trace iff the
   request **errored** or its latency landed **at or above the tail
   threshold** — by default the live p99 estimated from the serve tier's
   own ``cz_serve_request_seconds`` histogram (so the definition of "slow"
   tracks the traffic, not a hardcoded constant);
3. kept traces live in a byte-budgeted FIFO (oldest evicted first) exposed
   at ``GET /debug/traces`` / ``/debug/traces/{id}``, and each keep
   attaches an OpenMetrics exemplar to the latency histogram — the
   ``/metrics`` bucket points at the trace that exemplifies it (exemplars
   reach scrapers only on OpenMetrics-negotiated renders; the legacy
   0.0.4 exposition stays exemplar-free).

Everything else is dropped on the floor at request end: steady-state
traffic pays one context allocation and a handful of bounded list appends
per request.

Stdlib only — importable before numpy/jax.
"""
from __future__ import annotations

import collections
import json
import threading
import time

from repro_torch.obs import events as _events
from repro_torch.obs.context import RequestContext
from repro_torch.obs.registry import Histogram

__all__ = ["TailSampler", "chrome_trace"]


class TailSampler:
    """Keep-the-interesting-tail trace retention for one serve front.

    Parameters
    ----------
    latency:
        The live request-latency :class:`~repro_torch.obs.registry.Histogram`
        (the serve tier's ``cz_serve_request_seconds``) — both the source
        of the dynamic slow threshold and the target for exemplars.
    budget_bytes:
        Hard cap on retained trace bytes (JSON-encoded size); oldest
        retained traces are evicted first.
    slow_s:
        Fixed slow threshold in seconds.  ``None`` (default) tracks the
        live ``quantile`` of ``latency`` instead.
    quantile / min_count / default_slow_s:
        Dynamic-threshold shape: the threshold is the upper bound of the
        first bucket whose cumulative count reaches ``quantile`` of the
        total — once at least ``min_count`` requests have been observed;
        before that (cold start) ``default_slow_s`` applies.
    max_traces:
        Secondary cap on the number of retained traces.
    """

    def __init__(self, latency: Histogram, budget_bytes: int = 4 << 20,
                 slow_s: float | None = None, quantile: float = 0.99,
                 min_count: int = 100, default_slow_s: float = 0.25,
                 max_traces: int = 256):
        if not isinstance(latency, Histogram):
            raise TypeError("TailSampler needs the live latency Histogram")
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        self.latency = latency
        self.budget_bytes = int(budget_bytes)
        self.slow_s = None if slow_s is None else float(slow_s)
        self.quantile = float(quantile)
        self.min_count = int(min_count)
        self.default_slow_s = float(default_slow_s)
        self.max_traces = int(max_traces)
        self._lock = threading.Lock()
        self._traces: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._bytes = 0
        self.sampled = 0
        self.kept_error = 0
        self.kept_slow = 0
        self.evicted = 0

    # -- decision ------------------------------------------------------------

    def threshold(self) -> float:
        """The current slow threshold in seconds (fixed or live-quantile)."""
        if self.slow_s is not None:
            return self.slow_s
        snap = self.latency.snapshot()
        total = snap["count"]
        if total < self.min_count:
            return self.default_slow_s
        target = self.quantile * total
        prev = 0.0
        for bound, cum in snap["buckets"]:
            if cum >= target:
                # a request at/above this bucket's bound is in the tail; the
                # +Inf bucket has no usable bound — fall back to the last
                # finite one (keeps a little more than 1 - quantile)
                return prev if bound == float("inf") else bound
            prev = bound
        return self.default_slow_s  # unreachable (last bucket is +Inf)

    def finish(self, ctx: RequestContext | None, duration_s: float,
               error: str | None = None) -> bool:
        """Decide one completed request; returns True iff its trace was
        kept.  Idempotent per context (``ctx.finished`` latch) and safe to
        call with ``ctx=None`` (nothing was collected — a no-op)."""
        if ctx is None or ctx.finished:
            return False
        ctx.finished = True
        with self._lock:
            self.sampled += 1
        reason = ("error" if error is not None
                  else "slow" if duration_s >= self.threshold()
                  else None)
        if reason is None:
            return False
        rec = {
            "request_id": ctx.rid,
            "reason": reason,
            "error": error,
            "duration_ms": round(duration_s * 1e3, 3),
            "wall_time": round(ctx.wall_time, 6),
            "events": list(ctx.events),
            "dropped_events": ctx.dropped,
        }
        rec["bytes"] = len(json.dumps(rec, default=str).encode())
        with self._lock:
            old = self._traces.pop(ctx.rid, None)
            if old is not None:  # client-reused ID: newest wins
                self._bytes -= old["bytes"]
            self._traces[ctx.rid] = rec
            self._bytes += rec["bytes"]
            if reason == "error":
                self.kept_error += 1
            else:
                self.kept_slow += 1
            while self._traces and (self._bytes > self.budget_bytes
                                    or len(self._traces) > self.max_traces):
                _, dropped = self._traces.popitem(last=False)
                self._bytes -= dropped["bytes"]
                self.evicted += 1
        self.latency.exemplar(duration_s, ctx.rid)
        _events.event("trace.kept", level="debug", reason=reason,
                      duration_ms=rec["duration_ms"],
                      trace_bytes=rec["bytes"])
        return True

    # -- readback ------------------------------------------------------------

    def traces(self) -> list[dict]:
        """Summaries of the retained set, oldest first (the
        ``/debug/traces`` listing)."""
        with self._lock:
            items = list(self._traces.values())
        return [{k: r[k] for k in ("request_id", "reason", "error",
                                   "duration_ms", "wall_time", "bytes")}
                | {"events": len(r["events"])}
                for r in items]

    def get(self, request_id: str) -> dict:
        """One retained trace in full (KeyError if not retained)."""
        with self._lock:
            return dict(self._traces[request_id])

    def stats(self) -> dict:
        with self._lock:
            return {
                "sampled": self.sampled,
                "kept_error": self.kept_error,
                "kept_slow": self.kept_slow,
                "evicted": self.evicted,
                "retained": len(self._traces),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "threshold_s": self.threshold(),
            }

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._bytes = 0


def chrome_trace(rec: dict) -> dict:
    """One retained trace record as a Chrome trace-event document — load
    the response of ``/debug/traces/{id}?format=chrome`` straight into
    Perfetto."""
    events = [{"name": ev["name"], "ph": "X", "cat": "repro",
               "ts": ev["ts_us"], "dur": ev["dur_us"], "pid": 0, "tid": 0,
               **({"args": ev["args"]} if ev.get("args") else {})}
              for ev in rec.get("events", [])]
    meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": f"request {rec.get('request_id', '?')}"}}]
    return {"traceEvents": meta + sorted(events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
            "metadata": {"request_id": rec.get("request_id"),
                         "reason": rec.get("reason"),
                         "duration_ms": rec.get("duration_ms"),
                         "epoch_us": int(rec.get("wall_time", time.time())
                                         * 1e6)}}
