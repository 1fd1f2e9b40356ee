"""HTTP front for :class:`FieldRegionServer` — stdlib only, no new deps
(port of ``repro.serve.http``: the same routes, status codes, headers, JSON
bodies and ``/metrics`` expositions; cold chunks decode on the torch
``device`` the server opens its dataset on, the card by default).

The post-hoc region-access pattern, network-facing: analysts pull arbitrary
subdomains out of a compressed CZDataset over plain ``GET``, the way Zarr
grew an HTTP fetch path over its chunk store.

Endpoints
---------

``GET /v1/region/{quantity}/{t}?lo=x,y,z&hi=x,y,z[&format=raw|npy]``
    The decoded box ``[lo, hi)``.  ``raw`` (default) streams C-order bytes
    with ``X-CZ-Shape`` / ``X-CZ-Dtype`` headers; ``npy`` (also selected by
    ``Accept: application/x-npy``) wraps the same bytes in the self-
    describing ``.npy`` container.
``GET /v1/manifest``
    Dataset summary JSON — the same serializer as
    ``cz-compress inspect --json``.
``GET /healthz``
    Liveness probe (``200 ok``).
``GET /metrics``
    Metrics exposition: query count, request-latency histogram, region-
    and chunk-cache hits/misses, bytes decoded vs bytes served, coalesced
    flights, tail-sampling counters, responses by status code.  Content
    negotiated: scrapers whose ``Accept`` header names
    ``application/openmetrics-text`` (Prometheus does by default) get an
    OpenMetrics 1.0 document whose latency buckets carry exemplars
    pointing at kept tail traces; everyone else gets plain text format
    0.0.4, exemplar-free — the legacy parser rejects exemplar syntax.
``GET /debug/traces``
    Tail-sampled trace retention: summaries of every kept trace (errored
    or slow-tail requests only) plus sampler stats.
``GET /debug/traces/{request_id}[?format=chrome]``
    One kept trace in full — ``format=chrome`` re-shapes it as a Chrome
    trace-event document loadable in Perfetto.
``GET /debug/events[?n=50]``
    The tail of the in-process structured event ring.

Request correlation: every response carries an ``X-CZ-Request-Id`` header
— minted per request, or echoed from the client's own header when it sends
a well-formed one — and the same ID is stamped on every span and event the
request touches, kept tail traces included.

Concurrency: one thread per connection (``ThreadingHTTPServer``) with a
bounded decode-admission semaphore (``max_inflight``), and all duplicate
work coalesced by the region server's tiered cache + single-flight
scheduler — N clients hammering one hot region cost one decode.
"""
from __future__ import annotations

import collections
import io
import json
import socket
import sys
import threading
import time
from http.client import HTTPConnection, HTTPException
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from repro_torch import DEFAULT_DEVICE, obs
from repro_torch.obs import context as _context
from repro_torch.obs import events as _events
from repro_torch.obs.sampling import chrome_trace
from repro_torch.store.backends import open_store

from .region import FieldRegionServer

__all__ = ["RegionHTTPServer", "Client", "render_metrics", "main"]


def render_metrics(region: FieldRegionServer,
                   responses: dict[int, int] | None = None,
                   openmetrics: bool = False) -> str:
    """Text-exposition rendering of one region server's counters, through
    :class:`repro_torch.obs.Registry` — Prometheus 0.0.4 by default, OpenMetrics
    1.0 (with latency-bucket exemplars) when ``openmetrics`` is set.

    A fresh registry is assembled per scrape from the server's counter
    snapshot — registration order reproduces the reference's exposition
    name-for-name, help string and labels included — and the server's live
    ``LatencyHistogram`` is registered directly, so the latency buckets are
    exposed without a copy.
    """
    s = region.stats()
    reg = obs.Registry()

    def counter(name, help_, value):
        reg.counter(name, help_).set_total(value)

    counter("cz_serve_queries_total",
            "Region queries answered.", s["queries"])
    counter("cz_serve_bytes_served_total",
            "Decoded bytes returned to clients.", s["bytes_served"])
    counter("cz_serve_bytes_decoded_total",
            "Bytes inflated from compressed chunks (cache misses only).",
            s["bytes_decoded"])
    counter("cz_serve_region_cache_hits_total",
            "Queries answered from the decoded-region LRU.",
            s["region_cache_hits"])
    counter("cz_serve_region_cache_misses_total",
            "Queries that had to assemble their box.",
            s["region_cache_misses"])
    counter("cz_serve_region_cache_evictions_total",
            "Regions evicted from the decoded-region LRU.",
            s["region_cache_evictions"])
    reg.gauge("cz_serve_region_cache_bytes",
              "Bytes resident in the decoded-region LRU."
              ).set(s["region_cache_bytes"])
    counter("cz_serve_chunk_cache_hits_total",
            "Chunk fetches served by the store's chunk LRUs.",
            s["cache_hits"])
    counter("cz_serve_chunk_cache_misses_total",
            "Chunk fetches that decoded (== chunks decoded).",
            s["cache_misses"])
    counter("cz_serve_chunks_decoded_total",
            "Chunks inflated since the server started.", s["chunks_decoded"])
    counter("cz_serve_coalesced_requests_total",
            "Chunk fetches that joined another request's in-flight decode.",
            s["flights_joined"])
    reg.register(region.latency)  # live cz_serve_request_seconds histogram
    if getattr(region, "sampler", None) is not None:
        counter("cz_serve_traces_sampled_total",
                "Requests whose tail-sampling keep/drop decision ran.",
                s["trace_sampled"])
        kept = reg.counter("cz_serve_traces_kept_total",
                           "Tail traces kept, by reason.",
                           labelnames=("reason",))
        kept.set_total(s["trace_kept_error"], reason="error")
        kept.set_total(s["trace_kept_slow"], reason="slow")
        counter("cz_serve_traces_evicted_total",
                "Kept traces evicted by the byte budget.",
                s["trace_evicted"])
        reg.gauge("cz_serve_trace_bytes",
                  "Bytes of tail traces currently retained."
                  ).set(s["trace_bytes"])
    if responses is not None:
        resp = reg.counter("cz_serve_http_responses_total",
                           "HTTP responses by status code.",
                           labelnames=("code",))
        for code in sorted(responses):
            resp.set_total(responses[code], code=code)
    return reg.render(openmetrics=openmetrics)


class _RegionHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "cz-serve/1.0"

    # -- plumbing ----------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet by default; opt-in via server
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def handle(self):
        try:
            super().handle()
        except (BrokenPipeError, ConnectionResetError):
            # a dropped client is routine, not a server error worth a
            # socketserver traceback (e.g. RST between keep-alive requests)
            self.close_connection = True

    def _send(self, code: int, body: bytes, ctype: str,
              headers: dict | None = None) -> None:
        self._responded = True
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        rid = getattr(self, "_rid", None)
        if rid is not None:
            self.send_header("X-CZ-Request-Id", rid)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)
        self.server._count_response(code)

    def _json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(),
                   "application/json; charset=utf-8")

    def _error(self, code: int, msg: str) -> None:
        if getattr(self, "_responded", False):
            # a response already started (e.g. the write itself failed):
            # a second status line would corrupt the stream — just hang up
            self.close_connection = True
            return
        try:
            self._json(code, {"error": msg})
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    # -- routes ------------------------------------------------------------

    def do_GET(self):  # noqa: N802 (http.server API)
        self._responded = False
        self._status = 0
        url = urlparse(self.path)
        sampler = getattr(self.server.region, "sampler", None)
        rid = _context.clean_id(self.headers.get("X-CZ-Request-Id"))
        t0 = time.perf_counter()
        with _context.request(rid, collect=sampler is not None) as ctx:
            self._rid = ctx.rid
            try:
                if url.path == "/healthz":
                    self._send(200, b"ok\n", "text/plain; charset=utf-8")
                elif url.path == "/metrics":
                    om = ("application/openmetrics-text"
                          in self.headers.get("Accept", ""))
                    body = render_metrics(
                        self.server.region,
                        self.server.response_counts(),
                        openmetrics=om).encode()
                    self._send(200, body,
                               "application/openmetrics-text; "
                               "version=1.0.0; charset=utf-8" if om else
                               "text/plain; version=0.0.4; charset=utf-8")
                elif url.path == "/v1/manifest":
                    self._json(200, self.server.region.manifest())
                elif url.path.startswith("/v1/region/"):
                    self._region(url)
                elif url.path.startswith("/debug/"):
                    self._debug(url)
                else:
                    self._error(404, f"no route {url.path}")
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True  # client went away mid-response
            except KeyError as e:
                self._error(404, str(e.args[0]) if e.args else str(e))
            except ValueError as e:
                self._error(400, str(e))
            except Exception as e:  # a bug must not kill the thread pool
                self._error(500, f"{type(e).__name__}: {e}")
            dt = time.perf_counter() - t0
            code = self._status
            _events.event("http.request",
                          level=("error" if code >= 500
                                 else "warn" if code >= 400 else "info"),
                          method="GET", path=url.path, code=code,
                          dur_ms=round(dt * 1e3, 3))
            if sampler is not None and code >= 400:
                # HTTP-layer failures (bad params, unknown routes) never
                # reach query(); finalize them here — the per-context latch
                # keeps this a no-op when query() already decided
                sampler.finish(ctx, dt, error=f"http {code}")

    def do_POST(self):  # noqa: N802
        self._responded = False
        # drain the request body first, or the unread bytes desynchronize
        # this keep-alive connection (they'd parse as the next request line)
        if self.headers.get("Transfer-Encoding"):
            self.close_connection = True
        else:
            length = int(self.headers.get("Content-Length") or 0)
            while length > 0:
                got = self.rfile.read(min(length, 1 << 16))
                if not got:
                    break
                length -= len(got)
        self._error(405, "read-only service: GET only")

    do_PUT = do_DELETE = do_PATCH = do_POST

    def _region(self, url) -> None:
        parts = url.path.split("/")  # ['', 'v1', 'region', quantity, t]
        if len(parts) != 5 or not parts[3] or not parts[4]:
            raise ValueError("expected /v1/region/{quantity}/{t}")
        quantity = parts[3]
        try:
            t = int(parts[4])
        except ValueError:
            raise ValueError(f"timestep must be an integer, got {parts[4]!r}")
        q = parse_qs(url.query)

        def vec(name):
            if name not in q:
                raise ValueError(f"missing query parameter {name}=x,y,z")
            try:
                v = tuple(int(x) for x in q[name][-1].split(","))
            except ValueError:
                raise ValueError(f"{name} must be comma-separated integers")
            if len(v) != 3:
                raise ValueError(f"{name} must have 3 components")
            return v

        lo, hi = vec("lo"), vec("hi")
        fmt = q.get("format", ["raw"])[-1]
        if fmt not in ("raw", "npy"):
            raise ValueError(f"unknown format {fmt!r} (raw or npy)")
        if "application/x-npy" in self.headers.get("Accept", ""):
            fmt = "npy"

        arr = self.server.region.query(quantity, t, lo, hi, copy=False)
        if fmt == "npy":
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arr),
                                      allow_pickle=False)
            self._send(200, buf.getvalue(), "application/x-npy")
        else:
            self._send(200, arr.tobytes(), "application/octet-stream",
                       headers={
                           "X-CZ-Shape": ",".join(map(str, arr.shape)),
                           "X-CZ-Dtype": str(arr.dtype),
                       })

    def _debug(self, url) -> None:
        q = parse_qs(url.query)
        if url.path == "/debug/events":
            try:
                n = int(q.get("n", ["50"])[-1])
            except ValueError:
                raise ValueError("n must be an integer")
            self._json(200, {"events": _events.tail(n)})
            return
        sampler = getattr(self.server.region, "sampler", None)
        if sampler is None:
            raise KeyError("tail sampling is disabled on this server")
        if url.path == "/debug/traces":
            self._json(200, {"traces": sampler.traces(),
                             "stats": sampler.stats()})
            return
        parts = url.path.split("/")  # ['', 'debug', 'traces', request_id]
        if len(parts) != 4 or parts[2] != "traces" or not parts[3]:
            raise ValueError("expected /debug/traces[/{request_id}]")
        rec = sampler.get(parts[3])  # KeyError -> 404
        fmt = q.get("format", ["json"])[-1]
        if fmt == "chrome":
            self._json(200, chrome_trace(rec))
        elif fmt == "json":
            self._json(200, rec)
        else:
            raise ValueError(f"unknown format {fmt!r} (json or chrome)")


class RegionHTTPServer(ThreadingHTTPServer):
    """Threaded HTTP server over one :class:`FieldRegionServer`.

    ``dataset`` is a path (opened and owned), a ``CZDataset`` (borrowed), or
    an existing ``FieldRegionServer`` (borrowed — its caches, counters, and
    admission policy are shared with in-process callers, so ``cache_*`` and
    ``max_inflight`` are ignored).  ``port=0`` binds an ephemeral loopback
    port (tests, benchmarks).  ``max_inflight`` bounds concurrent region
    *decodes* (cache hits never queue behind them) — the admission-control
    knob surfaced as ``--workers`` on the CLI.  ``device`` is the torch
    device of a dataset opened from a path (default ``"cuda"``; a borrowed
    ``CZDataset`` or ``FieldRegionServer`` keeps its own).
    """

    daemon_threads = True

    def __init__(self, dataset, host: str = "127.0.0.1", port: int = 8423,
                 cache_bytes: int = 64 << 20, cache_readers: int = 16,
                 cache_chunks: int = 32, max_inflight: int = 8,
                 verbose: bool = False, sample: bool = True,
                 trace_budget_bytes: int = 4 << 20,
                 trace_slow_ms: float | None = None,
                 prefetch: int = 0, device=DEFAULT_DEVICE):
        self._owns_region = not isinstance(dataset, FieldRegionServer)
        self.region = (FieldRegionServer(dataset, cache_readers=cache_readers,
                                         cache_chunks=cache_chunks,
                                         cache_bytes=cache_bytes,
                                         max_inflight=max(1, int(max_inflight)),
                                         sample=sample,
                                         trace_budget_bytes=trace_budget_bytes,
                                         trace_slow_ms=trace_slow_ms,
                                         prefetch=prefetch, device=device)
                       if self._owns_region else dataset)
        self.verbose = verbose
        self._responses = collections.Counter()
        self._resp_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        self.closed = False
        try:
            super().__init__((host, port), _RegionHandler)
        except Exception:
            if self._owns_region:
                self.region.close()  # don't leak the dataset on a bind error
            raise

    # -- introspection -----------------------------------------------------

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def _count_response(self, code: int) -> None:
        with self._resp_lock:
            self._responses[int(code)] += 1

    def response_counts(self) -> dict[int, int]:
        with self._resp_lock:
            return dict(self._responses)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RegionHTTPServer":
        """Serve on a daemon thread; returns self (``with`` friendly)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="cz-serve", daemon=True)
        self._thread.start()
        return self

    def get_request(self):
        request, addr = super().get_request()
        with self._conn_lock:
            self._conns.add(request)
        return request, addr

    def shutdown_request(self, request):
        with self._conn_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self._thread is not None:
            self.shutdown()
            self._thread.join(timeout=5)
        self.server_close()
        # Sever lingering keep-alive connections so their handler threads
        # exit now — otherwise a client's pooled socket stays "alive" and
        # gets answered by a zombie handler over a closed dataset.
        with self._conn_lock:
            stale = list(self._conns)
            self._conns.clear()
        for request in stale:
            try:
                request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                request.close()
            except OSError:
                pass
        if self._owns_region:
            self.region.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Client:
    """Minimal stdlib client for the region service (tests, examples,
    benchmarks).  One persistent connection per instance — use one Client
    per thread."""

    def __init__(self, url: str, timeout: float = 30.0):
        u = urlparse(url if "//" in url else f"http://{url}")
        self.host, self.port = u.hostname, u.port or 80
        self.timeout = timeout
        self._conn: HTTPConnection | None = None

    def _request(self, path: str,
                 headers: dict | None = None) -> tuple[int, dict, bytes]:
        """The single retry-once helper **every** client GET goes through
        (`/v1/region`, `/v1/manifest`, `/metrics`, `/debug/*`, `/healthz`):
        a request that trips over a stale keep-alive connection — the server
        restarted or idle-timed the socket since the last call — is replayed
        once on a fresh connection.  Safe because the API surface is
        idempotent GETs.  ``http.client`` faults (``CannotSendRequest``
        after a half-drained response, ``BadStatusLine`` on a torn reply)
        get the same treatment as socket-level ``OSError``s: both mean
        "this connection is dead", not "this request failed"."""
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = HTTPConnection(self.host, self.port,
                                            timeout=self.timeout)
            try:
                self._conn.request("GET", path, headers=headers or {})
                r = self._conn.getresponse()
                return r.status, dict(r.getheaders()), r.read()
            except (HTTPException, ConnectionError, OSError):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _ok(self, path: str, headers: dict | None = None
            ) -> tuple[dict, bytes]:
        status, headers, body = self._request(path, headers)
        if status != 200:
            try:
                msg = json.loads(body)["error"]
            except Exception:
                msg = body.decode(errors="replace")
            raise IOError(f"GET {path} -> {status}: {msg}")
        return headers, body

    def region(self, quantity: str, t: int, lo, hi) -> np.ndarray:
        """Fetch one region as a numpy array (``.npy`` wire format)."""
        path = (f"/v1/region/{quantity}/{int(t)}"
                f"?lo={','.join(str(int(v)) for v in lo)}"
                f"&hi={','.join(str(int(v)) for v in hi)}&format=npy")
        _, body = self._ok(path)
        return np.lib.format.read_array(io.BytesIO(body), allow_pickle=False)

    def region_raw(self, quantity: str, t: int, lo, hi) -> np.ndarray:
        """Fetch one region over the raw-bytes wire format (shape/dtype from
        the ``X-CZ-*`` headers)."""
        path = (f"/v1/region/{quantity}/{int(t)}"
                f"?lo={','.join(str(int(v)) for v in lo)}"
                f"&hi={','.join(str(int(v)) for v in hi)}")
        headers, body = self._ok(path)
        shape = tuple(int(v) for v in headers["X-CZ-Shape"].split(","))
        return np.frombuffer(body, dtype=headers["X-CZ-Dtype"]).reshape(shape)

    def manifest(self) -> dict:
        return json.loads(self._ok("/v1/manifest")[1])

    def metrics(self, openmetrics: bool = False) -> str:
        """The ``/metrics`` exposition — 0.0.4 text by default;
        ``openmetrics=True`` negotiates the OpenMetrics document (the one
        carrying latency-bucket exemplars)."""
        hdrs = ({"Accept": "application/openmetrics-text; version=1.0.0"}
                if openmetrics else None)
        return self._ok("/metrics", hdrs)[1].decode()

    def metrics_dict(self) -> dict[str, list[tuple[dict, float]]]:
        """Parsed ``/metrics``: ``{name: [(labels, value), ...]}`` (histogram
        sub-series under their exposed ``_bucket``/``_sum``/``_count``
        names) — the structured alternative to grepping exposition text."""
        return obs.parse_prometheus(self.metrics())

    def metric(self, name: str, labels: dict | None = None) -> float:
        """One sample out of :meth:`metrics` (convenience for tests and
        benchmarks).  Without ``labels`` the metric's un-labelled sample is
        returned; with a label dict, the unique sample whose labels contain
        every given pair (``KeyError`` if none match, ``ValueError`` if the
        match is ambiguous)."""
        samples = self.metrics_dict().get(name)
        if not samples:
            raise KeyError(name)
        if labels is None:
            for lbl, val in samples:
                if not lbl:
                    return val
            raise KeyError(f"{name} has no un-labelled sample "
                           f"(labelled: {[lbl for lbl, _ in samples]})")
        want = {k: str(v) for k, v in labels.items()}
        hits = [val for lbl, val in samples
                if all(lbl.get(k) == v for k, v in want.items())]
        if not hits:
            raise KeyError(f"{name} has no sample matching {labels}")
        if len(hits) > 1:
            raise ValueError(f"{name}: labels {labels} match "
                             f"{len(hits)} samples — add more labels")
        return hits[0]

    def traces(self) -> dict:
        """The ``/debug/traces`` listing: kept tail traces + sampler
        stats."""
        return json.loads(self._ok("/debug/traces")[1])

    def trace(self, request_id: str, chrome: bool = False) -> dict:
        """One kept tail trace in full (``chrome=True`` fetches the
        Perfetto-loadable reshaping)."""
        path = f"/debug/traces/{request_id}"
        if chrome:
            path += "?format=chrome"
        return json.loads(self._ok(path)[1])

    def events(self, n: int = 50) -> list[dict]:
        """The tail of the server's structured event ring."""
        return json.loads(self._ok(f"/debug/events?n={int(n)}")[1])["events"]

    def healthz(self) -> bool:
        return self._request("/healthz")[0] == 200

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def main(argv=None) -> int:
    """``python -m repro_torch.launch.compress serve`` — serve a CZDataset
    over HTTP, decoding on ``--device`` (default ``cuda``)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.compress serve",
        description="HTTP region-query service over a CZDataset: "
                    "/v1/region, /v1/manifest, /healthz, /metrics.")
    ap.add_argument("dataset", help="CZDataset directory or store URL "
                    "(file://, mem://, http://, any registered backend)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8423,
                    help="0 picks an ephemeral port (printed on start)")
    ap.add_argument("--cache-mb", type=float, default=64.0,
                    help="decoded-region LRU budget in MiB (0 disables)")
    ap.add_argument("--workers", type=int, default=8,
                    help="max concurrent region decodes (admission control)")
    ap.add_argument("--cache-readers", type=int, default=16,
                    help="pooled FieldReaders kept open")
    ap.add_argument("--cache-chunks", type=int, default=32,
                    help="LRU chunk slots per reader")
    ap.add_argument("--verbose", action="store_true",
                    help="log one line per request")
    ap.add_argument("--trace", metavar="OUT.json",
                    help="collect spans while serving and write a Chrome "
                         "trace (view in Perfetto) on shutdown")
    ap.add_argument("--no-sample", action="store_true",
                    help="disable always-on tail-based trace sampling")
    ap.add_argument("--trace-budget-mb", type=float, default=4.0,
                    help="byte budget for kept tail traces (MiB)")
    ap.add_argument("--trace-slow-ms", type=float, default=None,
                    help="fixed slow-trace threshold in ms (default: track "
                         "the live p99 of request latency)")
    ap.add_argument("--events", metavar="OUT.jsonl",
                    help="append structured events as JSON lines to a file")
    ap.add_argument("--prefetch", type=int, default=0, metavar="N",
                    help="chunks each reader fetches ahead of decode during "
                         "a region query (0 = off; worth 2-8 over remote "
                         "stores)")
    ap.add_argument("--retries", type=int, default=None, metavar="N",
                    help="store-level retries on transient faults (default: "
                         "2 for remote backends like http://, 0 otherwise; "
                         "0 disables)")
    ap.add_argument("--timeout", type=float, default=None, metavar="SEC",
                    help="per-request store socket timeout and retry "
                         "deadline (default: backend's own)")
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"],
                    help="torch device every cold chunk is decoded on")
    args = ap.parse_args(argv)

    if args.trace:
        obs.trace.enable()
    if args.events:
        _events.configure(path=args.events)
    # resolve the root here (rather than inside CZDataset) when a policy
    # knob is set, so the retry/timeout wrapping is applied exactly once
    dataset = args.dataset
    if args.retries is not None or args.timeout is not None:
        dataset = open_store(dataset, retries=args.retries,
                             timeout=args.timeout)
    srv = RegionHTTPServer(dataset, host=args.host, port=args.port,
                           cache_bytes=int(args.cache_mb * 2**20),
                           cache_readers=args.cache_readers,
                           cache_chunks=args.cache_chunks,
                           max_inflight=args.workers, verbose=args.verbose,
                           sample=not args.no_sample,
                           trace_budget_bytes=int(args.trace_budget_mb
                                                  * 2**20),
                           trace_slow_ms=args.trace_slow_ms,
                           prefetch=args.prefetch, device=args.device)
    qs = ", ".join(srv.region.ds.quantities) or "(empty)"
    print(f"serving {args.dataset} [{qs}] at {srv.url}")
    print(f"  GET {srv.url}/v1/region/{{quantity}}/{{t}}?lo=x,y,z&hi=x,y,z")
    print(f"  GET {srv.url}/v1/manifest | /healthz | /metrics")
    if not args.no_sample:
        print(f"  GET {srv.url}/debug/traces | /debug/traces/{{id}} "
              f"| /debug/events")
    sys.stdout.flush()  # the URL reaches a piped reader before serving blocks
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        srv.close()
        if args.events:
            _events.LOG.close()
        if args.trace:
            obs.trace.disable()
            print(f"trace written to {obs.trace.save(args.trace)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
