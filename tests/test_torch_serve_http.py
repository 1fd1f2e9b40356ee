"""The port's HTTP front (``repro_torch.serve.http``) and the CLI's
``serve`` against the JAX package's (``repro.serve.http``), on the CPU.

The reference's server and the port's (``device="cpu"``) serve the same
datasets side by side: raw at 32^3 as ``tests/test_serve_http.py`` builds
it, and wavelet, zfpx and lorenzo at 16^3 (8^3 blocks, 4 KiB chunks),
each written by the reference from numpy seeded fields.

* Region bodies (``raw`` and ``npy``, and ``npy`` chosen by ``Accept``)
  and their headers are byte-identical; each package's ``Client`` reads
  the other's server.
* ``/v1/manifest`` bodies, and the status codes and JSON error bodies of
  the reference's bad requests (404 route and quantity, 400 on ``lo``,
  ``hi``, ``format`` and ``t``, 405 with the body drained), are identical.
* After the same serial requests, ``/metrics`` has the same names, help
  strings, types, labels and counter values in Prometheus 0.0.4 and in
  OpenMetrics 1.0, and ``stats()`` the same keys and counters.
* Concurrent clients on one cold box coalesce into one decode per chunk,
  driven deterministically (a barrier, decodes gated on an event).
* The CLI: ``serve`` without ``--device`` asks for the card and raises
  here; ``--device cpu`` serves, prints the reference's lines, is read by
  ``stats URL`` and exits 0 on SIGINT.
"""
import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
from http.client import HTTPConnection
from urllib.parse import urlparse

import numpy as np
import pytest
import torch

import repro.serve.http as rhttp
import repro.serve.scheduler as rsched
from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline
from repro.store import CZDataset as RDataset

import repro_torch.serve.http as thttp
import repro_torch.serve.scheduler as tsched
from repro_torch.core.pipeline import Pipeline as TPipeline
from repro_torch.launch import compress as tcli
from repro_torch.serve import Client as TClient
from repro_torch.serve import FieldRegionServer as TRegion
from repro_torch.serve import RegionHTTPServer as TServer

from _serve_gates import Gate, Parked

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
BS = 8
N = 32
N_SCHEME = 16
SPEC_KW = dict(block_size=BS, buffer_bytes=1 << 12)
RNG = np.random.default_rng(42)
FIELDS = {"p": RNG.normal(size=(N, N, N)).astype(np.float32),
          "rho": RNG.normal(size=(N, N, N)).astype(np.float32)}
NEVER_SLOW_MS = 1e9

# the reference's /metrics families, in order (tests/test_obs.py)
METRIC_NAMES = [
    "cz_serve_queries_total", "cz_serve_bytes_served_total",
    "cz_serve_bytes_decoded_total", "cz_serve_region_cache_hits_total",
    "cz_serve_region_cache_misses_total", "cz_serve_region_cache_evictions_total",
    "cz_serve_region_cache_bytes", "cz_serve_chunk_cache_hits_total",
    "cz_serve_chunk_cache_misses_total", "cz_serve_chunks_decoded_total",
    "cz_serve_coalesced_requests_total", "cz_serve_request_seconds",
    "cz_serve_traces_sampled_total", "cz_serve_traces_kept_total",
    "cz_serve_traces_evicted_total", "cz_serve_trace_bytes",
    "cz_serve_http_responses_total",
]


def _smooth(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    f = 40 * np.sin(4 * g[0] + 2 * g[1]) * np.exp(-g[2]) + rng.standard_normal((n, n, n))
    return f.astype(np.float32)


def _make_dataset(root: str, scheme: str = "raw") -> str:
    fields = FIELDS if scheme == "raw" else {"p": _smooth(1, N_SCHEME),
                                             "rho": _smooth(2, N_SCHEME)}
    with RDataset(root, "a", spec=RSpec(scheme=scheme, **SPEC_KW)) as ds:
        for k in range(2):
            ds.append({q: f + np.float32(k) for q, f in fields.items()}, time=float(k))
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_serve_http")
    return {s: _make_dataset(str(base / s), s) for s in ("raw", "wavelet", "zfpx", "lorenzo")}


def _settling(srv):
    """``srv.settle(n)`` waits until ``n`` responses are counted: a handler
    counts its response after writing it, so a client can read a body
    before the server has counted it."""
    cond = threading.Condition()
    count = srv._count_response

    def counted(code):
        count(code)
        with cond:
            cond.notify_all()

    def settle(n):
        with cond:
            assert cond.wait_for(lambda: sum(srv.response_counts().values()) >= n,
                                 timeout=30), srv.response_counts()

    srv._count_response, srv.settle = counted, settle
    return srv


def _servers(root, **kw):
    """The reference's and the port's server over one root, started."""
    kw.setdefault("trace_slow_ms", NEVER_SLOW_MS)
    return (_settling(rhttp.RegionHTTPServer(root, port=0, **kw).start()),
            _settling(TServer(root, port=0, device="cpu", **kw).start()))


def _close(*servers) -> None:
    """Close servers side by side (each waits out its serve loop's poll)."""
    threads = [threading.Thread(target=s.close) for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


@pytest.fixture(scope="module")
def pair(roots):
    servers = {}
    for scheme, root in roots.items():
        servers[scheme] = _servers(root)
    yield servers
    _close(*(s for two in servers.values() for s in two))


def _get(url: str, path: str, headers=None, method: str = "GET", body=None):
    u = urlparse(url)
    conn = HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _same_response(ref_url: str, port_url: str, path: str, **kw):
    """Status, body and headers but the date and the request ID, equal."""
    a, b = _get(ref_url, path, **kw), _get(port_url, path, **kw)
    drop = ("Date", "X-CZ-Request-Id")
    ha = {k: v for k, v in a[1].items() if k not in drop}
    hb = {k: v for k, v in b[1].items() if k not in drop}
    assert (b[0], hb) == (a[0], ha), path
    assert b[2] == a[2], path
    return b


def _region_path(q, t, lo, hi, fmt=None):
    path = (f"/v1/region/{q}/{t}?lo={','.join(map(str, lo))}"
            f"&hi={','.join(map(str, hi))}")
    return path + (f"&format={fmt}" if fmt else "")


BOXES = [("p", 0, (0, 0, 0), (BS, BS, BS)), ("rho", 1, (3, 9, 14), (19, 25, 30)),
         ("p", 1, (0, 0, 0), (N, N, N)), ("p", 0, (5, 0, 31), (6, 32, 32)),
         ("rho", 0, (1, 2, 3), (2, 3, 4)), ("p", 1, (7, 7, 7), (25, 9, 17))]


# ---------------------------------------------------------------------------
# regions: byte-identical bodies and headers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [None, "raw", "npy"])
@pytest.mark.parametrize("box", range(len(BOXES)))
def test_region_responses_identical(pair, box, fmt):
    ref, port = pair["raw"]
    q, t, lo, hi = BOXES[box]
    status, headers, body = _same_response(ref.url, port.url, _region_path(q, t, lo, hi, fmt))
    assert status == 200
    want = FIELDS[q][tuple(slice(a, b) for a, b in zip(lo, hi))] + np.float32(t)
    if fmt == "npy":
        assert headers["Content-Type"] == "application/x-npy"
        assert np.lib.format.read_array(io.BytesIO(body)).tobytes() == want.tobytes()
    else:
        assert headers["X-CZ-Shape"] == ",".join(map(str, want.shape))
        assert headers["X-CZ-Dtype"] == "float32"
        assert body == want.tobytes()


@pytest.mark.parametrize("scheme", ["wavelet", "zfpx", "lorenzo"])
def test_region_responses_identical_per_scheme(pair, roots, scheme):
    ref, port = pair[scheme]
    boxes = [("p", 0, (0, 0, 0), (N_SCHEME,) * 3), ("rho", 1, (3, 1, 2), (13, 15, 9)),
             ("p", 1, (8, 0, 4), (16, 8, 12))]
    with RDataset(roots[scheme]) as ds:
        for q, t, lo, hi in boxes:
            want = ds.read_box(q, t, lo, hi)
            for fmt in ("raw", "npy"):
                _, _, body = _same_response(ref.url, port.url,
                                            _region_path(q, t, lo, hi, fmt))
                if fmt == "raw":
                    assert body == want.tobytes()


def test_accept_header_selects_npy(pair):
    ref, port = pair["raw"]
    path = _region_path("p", 0, (0, 0, 0), (4, 4, 4), "raw")
    _, headers, body = _same_response(ref.url, port.url, path,
                                      headers={"Accept": "application/x-npy"})
    assert headers["Content-Type"] == "application/x-npy"
    assert body.startswith(b"\x93NUMPY")


@pytest.mark.parametrize("direction", ["reference client, port server",
                                       "port client, reference server"])
def test_each_client_reads_the_other_server(pair, direction):
    ref, port = pair["raw"]
    if direction.startswith("reference"):
        client, url = rhttp.Client, port.url
    else:
        client, url = TClient, ref.url
    with client(url) as c:
        assert c.healthz()
        for q, t, lo, hi in BOXES:
            want = (FIELDS[q][tuple(slice(a, b) for a, b in zip(lo, hi))]
                    + np.float32(t)).tobytes()
            assert c.region(q, t, lo, hi).tobytes() == want
            assert c.region_raw(q, t, lo, hi).tobytes() == want
        assert c.manifest()["quantities"]["p"]["shape"] == [N, N, N]
        assert c.metric("cz_serve_queries_total") >= 2 * len(BOXES)
        assert c.metric("cz_serve_http_responses_total", labels={"code": 200}) > 0
        assert "cz_serve_request_seconds_count" in c.metrics_dict()
        assert "traces" in c.traces() and isinstance(c.events(3), list)
        with pytest.raises(IOError, match="404"):
            c.region("vorticity", 0, (0, 0, 0), (1, 1, 1))


def test_manifest_body_identical(pair):
    for scheme, (ref, port) in pair.items():
        status, _, body = _same_response(ref.url, port.url, "/v1/manifest")
        assert status == 200
        with RDataset(ref.region.ds.root) as ds:
            assert json.loads(body) == ds.describe()


def test_healthz_identical(pair):
    ref, port = pair["raw"]
    assert _same_response(ref.url, port.url, "/healthz")[2] == b"ok\n"


# ---------------------------------------------------------------------------
# errors: the same status codes and JSON bodies
# ---------------------------------------------------------------------------

BAD = [
    ("/nope", 404),
    ("/v1/region/vorticity/0?lo=0,0,0&hi=4,4,4", 404),
    ("/v1/region/p/9?lo=0,0,0&hi=4,4,4", 404),
    ("/v1/region/p/0?lo=0,0,0&hi=99,4,4", 400),
    ("/v1/region/p/0?lo=4,4,4&hi=4,8,8", 400),
    ("/v1/region/p/0?lo=0,0&hi=4,4,4", 400),
    ("/v1/region/p/0?hi=4,4,4", 400),
    ("/v1/region/p/0?lo=0,0,0", 400),
    ("/v1/region/p/0?lo=a,b,c&hi=4,4,4", 400),
    ("/v1/region/p/xx?lo=0,0,0&hi=4,4,4", 400),
    ("/v1/region/p/0?lo=0,0,0&hi=4,4,4&format=xml", 400),
    ("/v1/region/p?lo=0,0,0&hi=4,4,4", 400),
    ("/debug/traces/no-such-request", 404),
    ("/debug/events?n=many", 400),
    ("/debug/traces/a/b", 400),
]


@pytest.mark.parametrize("path,code", BAD, ids=[p for p, _ in BAD])
def test_error_status_and_body_identical(pair, path, code):
    ref, port = pair["raw"]
    status, headers, body = _same_response(ref.url, port.url, path)
    assert status == code
    assert headers["Content-Type"] == "application/json; charset=utf-8"
    assert set(json.loads(body)) == {"error"}


@pytest.mark.parametrize("method", ["POST", "PUT", "DELETE", "PATCH"])
def test_write_methods_get_405_and_the_body_is_drained(pair, method):
    bodies = []
    for srv in pair["raw"]:
        u = urlparse(srv.url)
        conn = HTTPConnection(u.hostname, u.port, timeout=30)
        try:
            conn.request(method, "/v1/manifest", body=b"x" * 70000)
            r = conn.getresponse()
            bodies.append((r.status, r.read()))
            conn.request("GET", "/healthz")    # the same keep-alive connection
            r = conn.getresponse()
            assert (r.status, r.read()) == (200, b"ok\n")
        finally:
            conn.close()
    assert bodies[0] == bodies[1]
    assert bodies[1] == (405, b'{"error": "read-only service: GET only"}')


def test_debug_traces_404_when_sampling_is_off(roots):
    ref, port = _servers(roots["raw"], sample=False)
    try:
        status, _, body = _same_response(ref.url, port.url, "/debug/traces")
        assert status == 404 and b"tail sampling is disabled" in body
        assert _get(ref.url, "/debug/events?n=1")[0] == _get(port.url, "/debug/events?n=1")[0] \
            == 200
    finally:
        _close(ref, port)


def test_request_id_echoed_or_minted(pair):
    _, port = pair["raw"]
    _, headers, _ = _get(port.url, "/healthz", headers={"X-CZ-Request-Id": "client-42.a"})
    assert headers["X-CZ-Request-Id"] == "client-42.a"
    for sent in (None, "bad id with spaces", "-leading-dash"):
        _, headers, _ = _get(port.url, "/healthz",
                             headers={} if sent is None else {"X-CZ-Request-Id": sent})
        assert re.fullmatch(r"[0-9a-f]{16}", headers["X-CZ-Request-Id"])


# ---------------------------------------------------------------------------
# /metrics and stats(): the same series after the same requests
# ---------------------------------------------------------------------------

SCRIPT = [_region_path(*b) for b in BOXES] + [_region_path(*BOXES[1]),
                                               _region_path(*BOXES[1], "npy"),
                                               "/v1/manifest", "/healthz"] + \
    [p for p, _ in BAD[:6]] + [_region_path(*BOXES[0])]


def _exposition(text: str):
    """Metadata lines as they are; samples as (name, labels, value), the
    value None where it depends on timing (latency sums and buckets, and
    the retained traces' bytes)."""
    meta, samples, exemplars = [], [], 0
    for line in text.splitlines():
        if line.startswith("#"):
            meta.append(line)
            continue
        if " # " in line:
            exemplars += 1
            line = line.split(" # ")[0]
        key, value = line.rsplit(" ", 1)
        timed = (key.startswith("cz_serve_request_seconds_bucket")
                 or key.startswith("cz_serve_request_seconds_sum")
                 or key.startswith("cz_serve_trace_bytes"))
        samples.append((key, None if timed else float(value)))
    return meta, samples, exemplars


@pytest.fixture
def scripted(roots):
    """A fresh pair of servers after the same serial requests."""
    ref, port = _servers(roots["raw"], cache_chunks=4)
    try:
        for path in SCRIPT:
            assert _get(ref.url, path)[0] == _get(port.url, path)[0], path
        ref.settle(len(SCRIPT))
        port.settle(len(SCRIPT))
        yield ref, port
    finally:
        _close(ref, port)


@pytest.mark.parametrize("openmetrics", [False, True], ids=["prometheus", "openmetrics"])
def test_metrics_identical(scripted, openmetrics):
    ref, port = scripted
    hdrs = {"Accept": "application/openmetrics-text; version=1.0.0"} if openmetrics else {}
    a, b = _get(ref.url, "/metrics", headers=hdrs), _get(port.url, "/metrics", headers=hdrs)
    assert (a[0], a[1]["Content-Type"]) == (b[0], b[1]["Content-Type"])
    ma, sa, ea = _exposition(a[2].decode())
    mb, sb, eb = _exposition(b[2].decode())
    assert mb == ma                          # HELP, TYPE (and EOF) lines, in order
    assert sb == sa                          # names, labels, order, counter values
    families = [line.split()[2] for line in mb if line.startswith("# TYPE")]
    # OpenMetrics names a counter's family without its _total suffix
    assert families == [re.sub("_total$", "", n) if openmetrics else n for n in METRIC_NAMES]
    if openmetrics:                          # the kept error traces' exemplars
        assert ea > 0 and eb > 0 and mb[-1] == "# EOF"
    else:
        assert ea == eb == 0
    samples = dict(sb)
    assert samples["cz_serve_queries_total"] == len(BOXES) + 3
    assert samples['cz_serve_traces_kept_total{reason="error"}'] == 6


def test_stats_identical_after_the_same_requests(scripted):
    ref, port = scripted
    a, b = ref.region.stats(), port.region.stats()
    assert list(b) == list(a)
    drop = ("mean_latency_ms", "trace_bytes")
    assert {k: v for k, v in b.items() if k not in drop} == \
        {k: v for k, v in a.items() if k not in drop}
    assert port.response_counts() == ref.response_counts()


def test_stats_cli_reads_the_servers_metrics(scripted, capsys):
    _, port = scripted
    with pytest.raises(SystemExit) as e:
        tcli.main(["stats", port.url])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "cz_serve_queries_total" in out and "cz_serve_request_seconds" in out


def test_render_metrics_without_responses_identical(scripted):
    ref, port = scripted
    a = _exposition(rhttp.render_metrics(ref.region))
    b = _exposition(thttp.render_metrics(port.region))
    assert b == a
    assert not any("http_responses" in line for line in b[0])


def test_debug_traces_identical_in_shape(roots):
    ref, port = _servers(roots["raw"], trace_slow_ms=0.0)   # every query kept
    try:
        for srv in (ref, port):
            _get(srv.url, _region_path(*BOXES[1]), headers={"X-CZ-Request-Id": "q-1"})
        docs = []
        for srv in (ref, port):
            listing = json.loads(_get(srv.url, "/debug/traces")[2])
            rec = json.loads(_get(srv.url, "/debug/traces/q-1")[2])
            chrome = json.loads(_get(srv.url, "/debug/traces/q-1?format=chrome")[2])
            docs.append((sorted(listing), sorted(listing["stats"]),
                         [t["request_id"] for t in listing["traces"]], sorted(rec),
                         rec["reason"], sorted({e["name"] for e in rec["events"]}),
                         sorted(chrome), sorted({e["name"] for e in chrome["traceEvents"]})))
        assert docs[1] == docs[0]
        assert docs[1][2] == ["q-1"] and docs[1][4] == "slow"
        assert {"serve.query", "fetch"} <= set(docs[1][5])
    finally:
        _close(ref, port)


def test_debug_events_identical_in_shape(pair):
    ref, port = pair["raw"]
    shapes = []
    for srv in (ref, port):
        # one keep-alive connection: its handler logs /nope before it reads
        # the next request
        u = urlparse(srv.url)
        conn = HTTPConnection(u.hostname, u.port, timeout=30)
        try:
            conn.request("GET", "/nope")
            conn.getresponse().read()
            conn.request("GET", "/debug/events?n=1")
            (last,) = json.loads(conn.getresponse().read())["events"]
        finally:
            conn.close()
        shapes.append((sorted(last), last["event"], last["path"], last["code"],
                       last["level"]))
    assert shapes[1] == shapes[0]


# ---------------------------------------------------------------------------
# concurrency over HTTP (deterministic), lifecycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_concurrent_clients_coalesce(roots, pkg, monkeypatch):
    """cache_chunks=1: only the single-flight scheduler keeps 8 clients on
    one cold box to one decode per covering chunk."""
    sched, pipe, server, client = {
        "reference": (rsched, RPipeline, rhttp.RegionHTTPServer, rhttp.Client),
        "port": (tsched, TPipeline, TServer, TClient)}[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    parked = Parked(monkeypatch, sched)
    gate = Gate(monkeypatch, pipe)
    n_clients = 8
    lo, hi = (0, 0, 0), (BS, 3 * BS, BS)
    out = [None] * n_clients
    with server(roots["raw"], port=0, cache_chunks=1, max_inflight=n_clients, **kw).start() \
            as srv:
        covering = srv.region.ds.reader("p", 0).box_chunks(lo, hi)
        barrier = threading.Barrier(n_clients)
        clients = [client(srv.url) for _ in range(n_clients)]
        for c in clients:   # connect one at a time: the listen backlog is 5
            assert c.healthz()

        def fetch(i):
            with clients[i] as c:
                barrier.wait()
                out[i] = c.region("p", 0, lo, hi).tobytes()

        threads = [threading.Thread(target=fetch, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        gate.wait(lambda g: g.entered == 1, "no decode started")
        parked.wait(n_clients - 1)            # every other client joined the flight
        gate.release.set()
        for t in threads:
            t.join(30)
            assert not t.is_alive(), "a client never returned"
        stats = srv.region.stats()
        with client(srv.url) as c:
            decoded = c.metric("cz_serve_chunks_decoded_total")
            coalesced = c.metric("cz_serve_coalesced_requests_total")
    assert out == [FIELDS["p"][:BS, :3 * BS, :BS].tobytes()] * n_clients
    assert stats["chunks_decoded"] == decoded == gate.entered == len(covering) == 3
    assert stats["region_flights_joined"] == n_clients - 1 and coalesced == 0


def test_borrowed_region_server_survives_the_http_close(roots):
    with TRegion(roots["raw"], device="cpu") as region:
        srv = TServer(region, port=0).start()
        with TClient(srv.url) as c:
            c.region("p", 0, (0, 0, 0), (2, 2, 2))
        srv.close()
        assert not region.closed and region.stats()["queries"] == 1


def test_close_severs_keepalive_connections(roots):
    srv = TServer(roots["raw"], port=0, device="cpu").start()
    c = TClient(srv.url, timeout=5)
    assert c.healthz()
    srv.close()
    assert srv.region.closed
    with pytest.raises(OSError):
        c.healthz()
    c.close()


def test_http_server_opens_roots_on_the_card_by_default(roots, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TServer(roots["raw"], port=0)


# ---------------------------------------------------------------------------
# the CLI's serve
# ---------------------------------------------------------------------------

def _flags(main) -> set:
    shown = io.StringIO()
    with contextlib.redirect_stdout(shown), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z-]*)", shown.getvalue()))


def test_serve_flags_are_the_references_plus_device():
    ref = _flags(rhttp.main)
    port = _flags(lambda argv: tcli.main(["serve", *argv]))
    assert port == ref | {"--device"}
    assert {"--host", "--port", "--cache-mb", "--workers", "--cache-readers",
            "--cache-chunks", "--verbose", "--trace", "--no-sample", "--trace-budget-mb",
            "--trace-slow-ms", "--events", "--prefetch", "--retries", "--timeout"} <= ref


def test_serve_without_device_asks_for_the_card(roots, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["serve", roots["raw"], "--port", "0"])


def _serve_once(monkeypatch, server_cls, run) -> tuple[str, object]:
    """Run a CLI ``serve`` whose ``serve_forever`` is interrupted at once
    (as SIGINT does): what it printed and the server it built."""
    built = {}

    def interrupted(self, *a, **k):
        built["srv"] = self
        raise KeyboardInterrupt

    monkeypatch.setattr(server_cls, "serve_forever", interrupted)
    shown = io.StringIO()
    with contextlib.redirect_stdout(shown):
        code = run()
    assert code == 0
    return re.sub(r"127\.0\.0\.1:\d+", "HOST:PORT", shown.getvalue()), built["srv"]


@pytest.mark.parametrize("flags", [[], ["--no-sample", "--verbose"],
                                   ["--cache-mb", "1", "--workers", "2", "--cache-readers",
                                    "3", "--cache-chunks", "5", "--prefetch", "2",
                                    "--retries", "1", "--timeout", "7",
                                    "--trace-budget-mb", "0.5", "--trace-slow-ms", "40"]],
                         ids=["defaults", "no-sample", "options"])
def test_serve_prints_the_references_lines(roots, monkeypatch, flags):
    root = roots["raw"]
    argv = [root, "--port", "0", *flags]

    def port_run():
        with pytest.raises(SystemExit) as e:
            tcli.main(["serve", *argv, "--device", "cpu"])
        return e.value.code

    want, rsrv = _serve_once(monkeypatch, rhttp.RegionHTTPServer, lambda: rhttp.main(argv))
    got, tsrv = _serve_once(monkeypatch, TServer, port_run)
    assert got == want
    assert got.startswith(f"serving {root} [p, rho] at http://HOST:PORT\n")
    assert got.endswith("shutting down\n")
    for name in ("_cache_readers", "_cache_chunks", "_prefetch"):
        assert getattr(tsrv.region.ds, name) == getattr(rsrv.region.ds, name)
    assert tsrv.region.cache.max_bytes == rsrv.region.cache.max_bytes
    assert (tsrv.region.sampler is None) == (rsrv.region.sampler is None)
    assert tsrv.verbose == rsrv.verbose and tsrv.closed and rsrv.closed
    assert type(tsrv.region.ds.store).__name__ == type(rsrv.region.ds.store).__name__


def test_serve_writes_the_trace_and_events(roots, monkeypatch, tmp_path):
    out, events = str(tmp_path / "t.json"), str(tmp_path / "e.jsonl")

    def run():
        with pytest.raises(SystemExit) as e:
            tcli.main(["serve", roots["raw"], "--port", "0", "--device", "cpu",
                       "--trace", out, "--events", events])
        return e.value.code

    shown, _ = _serve_once(monkeypatch, TServer, run)
    assert shown.endswith(f"shutting down\ntrace written to {out}\n")
    with open(out) as f:
        assert "traceEvents" in json.load(f)
    assert os.path.exists(events)


def test_serve_subprocess_on_the_cpu(roots):
    """The CLI as a user runs it: the URL on its first line, a region, the
    ``stats`` of its URL, and exit 0 after SIGINT."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.compress", "serve", roots["raw"],
         "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        first = proc.stdout.readline()
        m = re.fullmatch(r"serving (.+) \[p, rho\] at (http://127\.0\.0\.1:\d+)\n", first)
        assert m, (first, proc.stderr.read() if proc.poll() is not None else "")
        url = m.group(2)
        with TClient(url) as c:
            assert c.healthz()
            assert c.region_raw("rho", 1, (0, 0, 0), (4, 4, 4)).tobytes() == \
                (FIELDS["rho"][:4, :4, :4] + np.float32(1)).tobytes()
        shown = io.StringIO()
        with contextlib.redirect_stdout(shown), pytest.raises(SystemExit) as e:
            tcli.main(["stats", url])
        assert e.value.code == 0
        assert "cz_serve_queries_total" in shown.getvalue()
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert out.endswith("shutting down\n")
