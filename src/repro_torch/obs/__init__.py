"""Observability of the port: metrics, traces, events, sampling (a copy of
``repro.obs``, stdlib only).

The metric names, kinds and labels, the Prometheus exposition, the JSON
snapshot, the Chrome trace-event layout and the event records are the
reference's; only the package path differs, so a run of the port reads
like a run of the reference in every tool that reads either.

Five modules:

* :mod:`repro_torch.obs.registry` — thread-safe ``Counter``/``Gauge``/
  ``Histogram`` with labels, a process-wide default ``REGISTRY``, and
  Prometheus text exposition (``render``; ``openmetrics=True`` emits an
  OpenMetrics document with histogram exemplars) / JSON snapshots
  (``snapshot``).
* :mod:`repro_torch.obs.trace` — ``with span("encode", chunk=i):`` span
  API exporting Chrome trace-event JSON (Perfetto-viewable), disabled by
  default at near-zero cost, with cross-process merge.
* :mod:`repro_torch.obs.context` — request-scoped correlation: a
  contextvars request ID stamped onto every span and event a request
  touches, plus bounded per-request span collection.
* :mod:`repro_torch.obs.events` — structured JSON-lines event log (level,
  ts, request_id, fields).
* :mod:`repro_torch.obs.sampling` — tail-based trace sampling: completed
  request traces are kept only on error or above the live latency-tail
  threshold, within a byte budget.

The pipeline, the kernel wrappers and the tuner instrument through this
package; ``python -m repro_torch.launch.compress --trace OUT.json``
writes the trace.
"""
from repro_torch.obs.registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    FAST_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Metric,
    Registry,
    counter,
    gauge,
    histogram,
    parse_prometheus,
    render,
    snapshot,
)
from repro_torch.obs.trace import (  # noqa: F401
    TRACER,
    Tracer,
    merge_traces,
    span,
    traced,
    tracing,
)
from repro_torch.obs import context  # noqa: F401
from repro_torch.obs import events  # noqa: F401
from repro_torch.obs import sampling  # noqa: F401
from repro_torch.obs import trace  # noqa: F401
from repro_torch.obs.context import RequestContext, new_request_id, request_id  # noqa: F401
from repro_torch.obs.events import event  # noqa: F401
from repro_torch.obs.sampling import TailSampler  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "Metric", "Registry", "REGISTRY",
    "DEFAULT_BUCKETS", "FAST_BUCKETS", "counter", "gauge", "histogram",
    "render", "snapshot", "parse_prometheus",
    "Tracer", "TRACER", "span", "traced", "tracing", "trace", "merge_traces",
    "context", "RequestContext", "new_request_id", "request_id",
    "events", "event", "sampling", "TailSampler",
]
