"""Thread-safe metrics registry with Prometheus text exposition.

The one instrumentation substrate every tier reports through: the codec
pipeline (per-chunk encode/decode time, bytes, achieved ratio), the
container reader (fetch vs decode split), the byte-store layer (ops/bytes/
latency per backend), the cluster engine (per-rank phase timing), and the
serve tier's ``/metrics`` endpoint all register here, so one snapshot — or
one scrape — answers where time and bytes went.

Three metric kinds, all label-aware and safe under concurrent updates:

* :class:`Counter` — monotonically increasing totals (``_total`` names);
* :class:`Gauge` — point-in-time values that go both ways;
* :class:`Histogram` — fixed-bucket distributions in the Prometheus shape
  (cumulative ``le`` buckets plus ``_sum``/``_count``).

A :class:`Registry` owns an ordered set of uniquely-named metrics and
renders them as Prometheus text format 0.0.4 (:meth:`Registry.render`),
as an OpenMetrics 1.0 document (``render(openmetrics=True)`` — the only
format in which histogram exemplars are emitted, since the legacy 0.0.4
parser rejects exemplar syntax), or a JSON-able snapshot
(:meth:`Registry.snapshot`).  ``REGISTRY`` is the
process-wide default — module-level :func:`counter` / :func:`gauge` /
:func:`histogram` are get-or-create against it, so instrumented modules
can register at import time and re-imports are idempotent.

Namespace hygiene is enforced at registration: every metric name must
match ``cz_[a-z0-9_]+`` and carry a non-empty help string, so third-party
schemes/backends cannot pollute the exposition (the naming lint in
``tests/test_obs.py`` asserts the same invariant over everything that
actually registered).

Stdlib only — this module must stay importable before numpy/jax.
"""
from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Iterator

__all__ = ["Counter", "Gauge", "Histogram", "Metric", "Registry", "REGISTRY",
           "DEFAULT_BUCKETS", "FAST_BUCKETS", "counter", "gauge", "histogram",
           "render", "snapshot", "parse_prometheus"]

#: required shape of every metric name (the ``cz_`` namespace is the lint).
NAME_RE = re.compile(r"cz_[a-z0-9_]+")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")

#: request-latency bucket bounds, seconds (+Inf is implicit) — the serve
#: tier's histogram shape, also the default for new histograms.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5)

#: finer low end for micro-ops (in-memory store gets, chunk fetches).
FAST_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 1.0)


def _check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.fullmatch(name):
        raise ValueError(
            f"metric name {name!r} must match '{NAME_RE.pattern}' "
            "(cz_ namespace, lowercase, underscores)")
    return name


def _escape(value) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labelstr(names: tuple, values: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Metric:
    """Base: name/help/labelnames validation plus the labelled-series map.

    Series are keyed by the tuple of label *values* in ``labelnames`` order;
    an unlabelled metric has exactly one series keyed ``()`` (created
    eagerly, so exposition always shows it).
    """

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple = ()):
        self.name = _check_name(name)
        if not isinstance(help, str) or not help.strip():
            raise ValueError(f"metric {name!r} needs a non-empty help string")
        self.help = help.strip()
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.fullmatch(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r} on {name!r}")
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}
        if not self.labelnames:
            self._series[()] = self._zero()

    def _zero(self):
        return 0

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {list(self.labelnames)}, "
                f"got {sorted(labels)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _get(self, labels: dict):
        """Current series value under the lock (creates the series)."""
        key = self._key(labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = self._zero()
            return self._series[key]

    def samples(self) -> list[tuple[dict, object]]:
        """``[(labels_dict, value), ...]`` in series-creation order."""
        with self._lock:
            items = list(self._series.items())
        return [(dict(zip(self.labelnames, k)), v) for k, v in items]

    def value(self, **labels):
        """One series' current value (0 / empty if never touched)."""
        return self._get(labels)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.name!r}, "
                f"series={len(self._series)})")


class Counter(Metric):
    """Monotonically increasing total."""

    kind = "counter"

    def inc(self, amount=1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def set_total(self, value, **labels) -> None:
        """Overwrite the running total — for exposition synced from an
        external monotonic snapshot (the serve tier mirrors its request
        counters here at render time), never for live accounting."""
        key = self._key(labels)
        with self._lock:
            self._series[key] = value


class Gauge(Metric):
    """Point-in-time value."""

    kind = "gauge"

    def set(self, value, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = value

    def inc(self, amount=1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def dec(self, amount=1, **labels) -> None:
        self.inc(-amount, **labels)


class _HistSeries:
    __slots__ = ("counts", "sum", "exemplars")

    def __init__(self, nbuckets: int):
        self.counts = [0] * nbuckets   # per-bucket (not cumulative); last=+Inf
        self.sum = 0.0
        self.exemplars: dict | None = None  # lazily {bucket_i: exemplar}


class Histogram(Metric):
    """Fixed-bucket distribution (cumulative ``le`` exposition)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, buckets=DEFAULT_BUCKETS,
                 labelnames: tuple = ()):
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        super().__init__(name, help, labelnames)

    def _zero(self):
        return _HistSeries(len(self.bounds) + 1)

    def observe(self, value: float, **labels) -> None:
        i = bisect.bisect_left(self.bounds, value)
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._zero()
            s.counts[i] += 1
            s.sum += value

    def snapshot(self, **labels) -> dict:
        """``{"buckets": [(le, cumulative), ...], "sum": s, "count": n}``
        with the +Inf bucket last (the shape ``/metrics`` consumers and
        ``FieldRegionServer.stats`` read)."""
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key) or self._zero()
            counts, total = list(s.counts), s.sum
        cum, rows = 0, []
        for bound, c in zip(self.bounds + (float("inf"),), counts):
            cum += c
            rows.append((bound, cum))
        return {"buckets": rows, "sum": total, "count": cum}

    def exemplar(self, value: float, trace_id: str, **labels) -> None:
        """Attach an exemplar to the bucket ``value`` falls in — the
        OpenMetrics link from a ``/metrics`` bucket to a kept trace ID (the
        tail sampler calls this for every retained trace).  One exemplar
        per bucket is kept (latest wins)."""
        i = bisect.bisect_left(self.bounds, value)
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._zero()
            if s.exemplars is None:
                s.exemplars = {}
            s.exemplars[i] = {"trace_id": str(trace_id),
                              "value": float(value),
                              "ts": round(time.time(), 3)}

    def exemplars(self, **labels) -> dict:
        """``{le_bound: {"trace_id", "value", "ts"}}`` for one series
        (empty if none attached)."""
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            ex = dict(s.exemplars) if s is not None and s.exemplars else {}
        bounds = self.bounds + (float("inf"),)
        return {bounds[i]: dict(v) for i, v in ex.items()}

    def load(self, snap: dict, **labels) -> None:
        """Overwrite one series from a :meth:`snapshot`-shaped dict (the
        exposition-sync analog of :meth:`Counter.set_total`)."""
        rows = list(snap["buckets"])
        if len(rows) != len(self.bounds) + 1:
            raise ValueError(
                f"snapshot has {len(rows)} buckets, {self.name} has "
                f"{len(self.bounds) + 1}")
        key = self._key(labels)
        s = self._zero()
        prev = 0
        for i, (_bound, cum) in enumerate(rows):
            s.counts[i] = cum - prev
            prev = cum
        s.sum = snap["sum"]
        with self._lock:
            self._series[key] = s


class Registry:
    """Ordered collection of uniquely-named metrics.

    ``counter``/``gauge``/``histogram`` are get-or-create: re-registering
    the same name returns the existing metric when kind and labelnames
    agree and raises otherwise — so instrumented modules register at import
    and nothing double-counts on re-import.  Exposition (:meth:`render`)
    walks metrics in registration order.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    # -- registration --------------------------------------------------------

    def register(self, metric: Metric) -> Metric:
        """Add an already-constructed metric (e.g. a histogram shared with
        in-process accounting).  Idempotent for the same object; a *name*
        collision with a different object is an error."""
        with self._lock:
            have = self._metrics.get(metric.name)
            if have is None:
                self._metrics[metric.name] = metric
            elif have is not metric:
                raise ValueError(
                    f"metric {metric.name!r} already registered")
        return metric

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> Metric:
        with self._lock:
            have = self._metrics.get(name)
            if have is not None:
                if type(have) is not cls or \
                        have.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{have.kind} with labels {list(have.labelnames)}")
                return have
            m = cls(name, help, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help, buckets=DEFAULT_BUCKETS,
                  labelnames=()) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # -- introspection -------------------------------------------------------

    def get(self, name: str) -> Metric:
        with self._lock:
            return self._metrics[name]

    def names(self) -> list[str]:
        with self._lock:
            return list(self._metrics)

    def __iter__(self) -> Iterator[Metric]:
        with self._lock:
            return iter(list(self._metrics.values()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    def unregister(self, name: str) -> None:
        """Remove one metric (tests cleaning up after themselves)."""
        with self._lock:
            self._metrics.pop(name, None)

    # -- exposition ----------------------------------------------------------

    def render(self, openmetrics: bool = False) -> str:
        """Text exposition, metrics in registration order.

        The default is Prometheus text format 0.0.4 with **no** exemplars —
        the legacy parser (selected by ``text/plain; version=0.0.4``) errors
        on exemplar syntax, which would fail the whole scrape.  With
        ``openmetrics=True`` the output is an OpenMetrics 1.0 document
        instead: counter families drop their ``_total`` suffix in
        HELP/TYPE, histogram buckets carry their exemplars, and the
        document ends with ``# EOF`` — serve it only to scrapers that
        negotiated ``application/openmetrics-text``.
        """
        lines: list[str] = []
        for m in self:
            family, kind = m.name, m.kind
            if openmetrics and kind == "counter":
                if family.endswith("_total"):
                    # OpenMetrics counters: family name is suffix-free, the
                    # sample keeps the _total suffix
                    family = family[:-len("_total")]
                else:
                    kind = "unknown"  # _total-less counter: stay parseable
            lines.append(f"# HELP {family} {m.help}")
            lines.append(f"# TYPE {family} {kind}")
            if isinstance(m, Histogram):
                for labels, _ in m.samples():
                    snap = m.snapshot(**labels)
                    ex = m.exemplars(**labels) if openmetrics else {}
                    values = tuple(labels[k] for k in m.labelnames)
                    for bound, cum in snap["buckets"]:
                        le = "+Inf" if bound == float("inf") else repr(bound)
                        ls = _labelstr(m.labelnames, values, f'le="{le}"')
                        line = f"{m.name}_bucket{ls} {cum}"
                        e = ex.get(bound)
                        if e is not None:
                            # OpenMetrics exemplar syntax: links this bucket
                            # to a kept tail-trace ID in /debug/traces
                            line += (f' # {{trace_id="{_escape(e["trace_id"])}"'
                                     f'}} {e["value"]} {e["ts"]}')
                        lines.append(line)
                    ls = _labelstr(m.labelnames, values)
                    lines.append(f"{m.name}_sum{ls} {snap['sum']}")
                    lines.append(f"{m.name}_count{ls} {snap['count']}")
            else:
                for labels, value in m.samples():
                    values = tuple(labels[k] for k in m.labelnames)
                    lines.append(
                        f"{m.name}{_labelstr(m.labelnames, values)} {value}")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able dump: ``{name: {kind, help, labelnames, samples}}``.
        Histogram samples carry ``buckets``/``sum``/``count`` instead of a
        scalar ``value``."""
        out: dict[str, dict] = {}
        for m in self:
            rows = []
            for labels, value in m.samples():
                if isinstance(m, Histogram):
                    snap = m.snapshot(**labels)
                    rows.append({"labels": labels,
                                 "buckets": [[b, c] for b, c in snap["buckets"]],
                                 "sum": snap["sum"], "count": snap["count"]})
                else:
                    rows.append({"labels": labels, "value": value})
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "labelnames": list(m.labelnames), "samples": rows}
        return out


#: the process-wide default registry (module-level helpers target it).
REGISTRY = Registry()


def counter(name, help, labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help, labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help, buckets=DEFAULT_BUCKETS, labelnames=()) -> Histogram:
    return REGISTRY.histogram(name, help, buckets, labelnames)


def render(openmetrics: bool = False) -> str:
    return REGISTRY.render(openmetrics=openmetrics)


def snapshot() -> dict:
    return REGISTRY.snapshot()


# -- exposition parsing ------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$")
_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _strip_exemplar(line: str) -> str:
    """Drop an OpenMetrics exemplar suffix (``... # {labels} value ts``).

    The ``#`` that starts an exemplar is the first one *outside* quoted
    label values — a ``#`` inside a quoted value (an escaped error message,
    say) is sample content and must survive."""
    in_quotes = False
    i, n = 0, len(line)
    while i < n:
        ch = line[i]
        if in_quotes:
            if ch == "\\":
                i += 1  # escaped char: skip it
            elif ch == '"':
                in_quotes = False
        elif ch == '"':
            in_quotes = True
        elif ch == "#":
            return line[:i].rstrip()
        i += 1
    return line


def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Parse text exposition into ``{name: [(labels, value), ...]}``.

    Histogram sub-series appear under their exposed names
    (``..._bucket``/``..._sum``/``..._count``).  The structured inverse of
    :meth:`Registry.render` — tests and benchmarks use it (via
    ``serve.Client.metrics_dict``) instead of string-grepping exposition
    text.  Both output formats parse: OpenMetrics exemplars are dropped
    (they link buckets to trace IDs for humans/Perfetto; parse keeps the
    sample shape stable) and ``# EOF`` is skipped as a comment.
    """
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = _strip_exemplar(line.strip())
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = {k: v.replace(r'\"', '"').replace(r"\n", "\n")
                   .replace(r"\\", "\\")
                  for k, v in _PAIR_RE.findall(m.group("labels") or "")}
        out.setdefault(m.group("name"), []).append(
            (labels, float(m.group("value"))))
    return out
