"""The port's region-serving tier (``repro_torch.serve``: ``RegionCache``,
``SingleFlight``, ``ChunkScheduler``, ``FieldRegionServer``) against the JAX
package's (``repro.serve``), on the CPU.

* The same datasets (numpy from a seed, written by the reference: raw at
  32^3, and wavelet, zfpx and lorenzo at 16^3, all in 8^3 blocks and 4 KiB
  chunks) are served by both packages' region servers, the port's at
  ``device="cpu"``.  The same serial queries give byte-identical regions,
  the same exceptions, identical ``stats()`` keys in the same order, and
  equal deterministic counters.
* Coalescing and the admission semaphore are driven deterministically in
  both packages: a ``threading.Barrier`` releases the callers and every
  chunk decode waits on a ``threading.Event`` (``Pipeline.decompress_chunk``
  monkeypatched), and the test waits on conditions that the callers
  signal, never on ``sleep``: a follower parked on a flight, a decode
  entered, a caller at the semaphore.
* The port's server opens a root on ``"cuda"`` by default, so here it
  raises; a borrowed ``CZDataset`` keeps its own device.
"""
import sys
import threading
import types

import numpy as np
import pytest
import torch

import repro.serve as rserve
import repro.serve.region as rregion
import repro.serve.scheduler as rsched
from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline
from repro.obs import trace as rtrace
from repro.store import CZDataset as RDataset

import repro_torch.serve as tserve
import repro_torch.serve.region as tregion
import repro_torch.serve.scheduler as tsched
from repro_torch.core.pipeline import Pipeline as TPipeline
from repro_torch.obs import trace as ttrace
from repro_torch.store import CZDataset as TDataset

from _serve_gates import Gate, Parked

torch.set_num_threads(1)

BS = 8
# 4 KiB buffers: 2 blocks of 8^3 float32 per chunk
KW = dict(block_size=BS, buffer_bytes=1 << 12)
N_RAW = 32      # raw: 64 blocks, 32 chunks per member
N_SCHEME = 16   # the device-capable schemes: 8 blocks, 4 chunks per member
SCHEMES = ["raw", "wavelet", "zfpx", "lorenzo"]

RNG = np.random.default_rng(42)
FIELDS = {"p": RNG.normal(size=(N_RAW,) * 3).astype(np.float32),
          "rho": RNG.normal(size=(N_RAW,) * 3).astype(np.float32)}

# a fixed slow threshold no query reaches: tail sampling keeps errors only,
# so every trace counter is deterministic
NEVER_SLOW_MS = 1e9

PKG = {
    "reference": types.SimpleNamespace(
        serve=rserve, region=rregion, sched=rsched, Pipeline=RPipeline,
        CZDataset=RDataset, trace=rtrace, kw={}, ds_kw={}),
    "port": types.SimpleNamespace(
        serve=tserve, region=tregion, sched=tsched, Pipeline=TPipeline,
        CZDataset=TDataset, trace=ttrace, kw={"device": "cpu"},
        ds_kw={"device": "cpu"}),
}


def _smooth(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    f = 40 * np.sin(4 * g[0] + 2 * g[1]) * np.exp(-g[2]) + rng.standard_normal((n, n, n))
    return f.astype(np.float32)


def _write(root: str, scheme: str) -> str:
    """Two quantities at two timesteps, written by the reference."""
    if scheme == "raw":
        fields = FIELDS
    else:
        fields = {"p": _smooth(1, N_SCHEME), "rho": _smooth(2, N_SCHEME)}
    with RDataset(root, "a", spec=RSpec(scheme=scheme, **KW)) as ds:
        for k in range(2):
            ds.append({q: f + np.float32(k) for q, f in fields.items()}, time=float(k))
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_serve")
    return {s: _write(str(base / s), s) for s in SCHEMES}


def _server(pkg: str, root, **kw):
    p = PKG[pkg]
    kw.setdefault("trace_slow_ms", NEVER_SLOW_MS)
    return p.serve.FieldRegionServer(root, **{**p.kw, **kw})


def _boxes(n: int, seed: int, count: int = 5) -> list:
    rng = np.random.default_rng(seed)
    out = [((0, 0, 0), (BS, BS, BS)), ((0, 0, 0), (n, n, n)),
           ((3, 1, 2), (n - 1, n - 3, n - 2))]
    for _ in range(count):
        lo = rng.integers(0, n - 1, 3)
        hi = [int(rng.integers(a + 1, n + 1)) for a in lo]
        out.append((tuple(int(v) for v in lo), tuple(hi)))
    return out


def _queries(n: int) -> list:
    """A serial query script: boxes, exact repeats (region-cache hits),
    other members, and boxes over chunks already decoded."""
    boxes = _boxes(n, seed=n)
    qs = [("p", 0, *b) for b in boxes]
    qs += [("p", 0, *boxes[0]), ("p", 0, *boxes[2])]          # region hits
    qs += [("rho", 1, *b) for b in boxes[2:5]]
    qs += [("p", 0, (1, 1, 1), (BS - 1, BS - 1, BS - 1))]     # chunk hit
    qs += [("p", 1, *boxes[3]), ("rho", 1, *boxes[2])]
    return qs


def _det(stats: dict) -> dict:
    """``stats()`` less its two timing-dependent values."""
    return {k: v for k, v in stats.items() if k not in ("mean_latency_ms", "trace_bytes")}


def _run_script(srv, script) -> list:
    out = []
    for q, t, lo, hi in script:
        try:
            out.append(srv.query(q, t, lo, hi).tobytes())
        except (KeyError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return out


# ---------------------------------------------------------------------------
# the package's names
# ---------------------------------------------------------------------------

def test_public_names_are_the_references():
    assert tserve.__all__ == rserve.__all__
    assert len(tserve.__all__) == 7
    for name in tserve.__all__:
        assert getattr(tserve, name).__name__ == getattr(rserve, name).__name__
    assert tregion.__all__ == rregion.__all__
    assert tsched.__all__ == rsched.__all__
    assert tregion.LATENCY_BUCKETS == rregion.LATENCY_BUCKETS


def test_latency_histogram_is_the_references():
    t, r = tserve.LatencyHistogram(), rserve.LatencyHistogram()
    assert (t.name, t.help, t.bounds) == (r.name, r.help, r.bounds)
    for v in (0.0004, 0.004, 0.3, 12.0):
        t.observe(v)
        r.observe(v)
    assert t.snapshot() == r.snapshot()


# ---------------------------------------------------------------------------
# RegionCache: the same operations give the same answers and counters
# ---------------------------------------------------------------------------

def _cache_script(cache) -> list:
    a = np.arange(256, dtype=np.float32)  # 1 KiB
    trail = []
    for op, key, arr in [("get", "a", None), ("put", "a", a), ("put", "b", a + 1),
                         ("get", "a", None), ("put", "c", a + 2), ("get", "b", None),
                         ("put", "big", np.ones(4096, np.float32)), ("get", "big", None),
                         ("put", "a", a[::2]), ("get", "c", None), ("get", "a", None)]:
        if op == "put":
            trail.append(("put", key, cache.put(key, arr)))
        else:
            got = cache.get(key)
            trail.append(("get", key, None if got is None else got.tobytes()))
        trail.append(cache.stats())
    trail.append(len(cache))
    trail.append(repr(cache))
    cache.clear()
    trail.append(cache.stats())
    return trail


@pytest.mark.parametrize("budget", [0, 1024, 2048, 3072, 1 << 20])
def test_region_cache_matches_reference(budget):
    assert _cache_script(tserve.RegionCache(budget)) == \
        _cache_script(rserve.RegionCache(budget))


def test_region_cache_freezes_entries_in_place_and_shares_them():
    cache = tserve.RegionCache(1 << 20)
    a = np.ones((4, 4), np.float32)
    assert cache.put("k", a)
    assert not a.flags.writeable           # contiguous: frozen in place
    assert cache.get("k") is a             # the shared buffer, no copy
    b = np.ones((4, 8), np.float32)[:, ::2]
    assert cache.put("s", b)
    got = cache.get("s")
    assert got is not b and got.flags.c_contiguous and not got.flags.writeable
    assert b.flags.writeable               # a strided input is copied, not frozen
    with pytest.raises(ValueError):
        got[0, 0] = 2


def test_region_cache_counts_under_threads():
    cache = tserve.RegionCache(64 * 1024)
    arr = np.zeros(256, np.float32)
    barrier = threading.Barrier(8)

    def work(i):
        barrier.wait()
        for j in range(200):
            cache.put((i, j % 40), arr)
            cache.get((i, (j + 1) % 40))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # switch threads often: a lost update shows
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(interval)
    s = cache.stats()
    assert s["hits"] + s["misses"] == 8 * 200
    assert s["bytes"] == s["entries"] * arr.nbytes <= s["max_bytes"]
    assert s["entries"] == 64


# ---------------------------------------------------------------------------
# SingleFlight: leader, followers, exceptions, in_flight (deterministic)
# ---------------------------------------------------------------------------

def _in_threads(fns) -> tuple[list, list[threading.Thread]]:
    """Start one thread per callable; results (or exceptions) in order."""
    out = [None] * len(fns)

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            out[i] = e

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    return out, threads


def _join(threads) -> None:
    for t in threads:
        t.join(30)
        assert not t.is_alive(), "a caller never returned"


@pytest.mark.parametrize("pkg", list(PKG))
def test_single_flight_leader_and_followers(pkg, monkeypatch):
    sf = PKG[pkg].sched.SingleFlight()
    parked = Parked(monkeypatch, PKG[pkg].sched)
    started, release = threading.Event(), threading.Event()
    calls = []

    def leader_fn():
        started.set()
        assert release.wait(30)
        calls.append("leader")
        return 42

    def follower_fn():  # pragma: no cover - must never run
        calls.append("follower")
        return -1

    out, t1 = _in_threads([lambda: sf.do("k", leader_fn)])
    assert started.wait(30)
    assert sf.in_flight("k") and not sf.in_flight("other")
    out2, t2 = _in_threads([lambda: sf.do("k", follower_fn)] * 3)
    parked.wait(3)
    release.set()
    _join(t1 + t2)
    assert out + out2 == [42] * 4
    assert calls == ["leader"]
    assert (sf.led, sf.joined) == (1, 3)
    assert not sf.in_flight("k")
    assert sf.do("k", lambda: 7) == 7      # landed: a later call runs again
    assert sf.led == 2


@pytest.mark.parametrize("pkg", list(PKG))
def test_single_flight_passes_the_exception_to_every_follower(pkg, monkeypatch):
    sf = PKG[pkg].sched.SingleFlight()
    parked = Parked(monkeypatch, PKG[pkg].sched)
    started, release = threading.Event(), threading.Event()

    def boom():
        started.set()
        assert release.wait(30)
        raise RuntimeError("decode failed")

    out, t1 = _in_threads([lambda: sf.do("k", boom)])
    assert started.wait(30)
    out2, t2 = _in_threads([lambda: sf.do("k", boom)] * 2)
    parked.wait(2)
    release.set()
    _join(t1 + t2)
    assert [type(e) for e in out + out2] == [RuntimeError] * 3
    assert all(str(e) == "decode failed" for e in out + out2)
    assert sf.do("k", lambda: 1) == 1      # a failed flight is not sticky
    assert (sf.led, sf.joined) == (2, 2)


def _flight_spans(pkg: str, monkeypatch) -> list:
    """One leader and two followers, each in its own request context, with
    the trace on: the recorded ``serve.flight`` and ``serve.flight.wait``
    spans' names and fields (times dropped)."""
    p = PKG[pkg]
    ctx = __import__(f"{p.sched.__name__.split('.')[0]}.obs.context",
                     fromlist=["request"])
    sf = p.sched.SingleFlight()
    parked = Parked(monkeypatch, p.sched)
    started, release = threading.Event(), threading.Event()

    def leader():
        with ctx.request("leader-1"):
            return sf.do(("m.cz", 3), lambda: (started.set(), release.wait(30), 5)[2])

    def follower(i):
        with ctx.request(f"follower-{i}"):
            return sf.do(("m.cz", 3), lambda: -1)

    p.trace.reset()
    p.trace.enable()
    try:
        out, t1 = _in_threads([leader])
        assert started.wait(30)
        out2, t2 = _in_threads([lambda: follower(1)])
        parked.wait(1)
        out3, t3 = _in_threads([lambda: follower(2)])
        parked.wait(2)
        release.set()
        _join(t1 + t2 + t3)
    finally:
        p.trace.disable()
    assert out + out2 + out3 == [5, 5, 5]
    spans = []
    for e in p.trace.TRACER.events():
        if e.get("name", "").startswith("serve.flight"):
            args = dict(e.get("args", {}))
            if pkg == "port":  # the port's spans also name themselves and their parent
                assert isinstance(args.pop("id"), int) and args.pop("parent") is None
            spans.append((e["name"], sorted(args.items(), key=str)))
    p.trace.reset()
    return sorted(spans, key=str)


def test_flight_spans_equal_the_references(monkeypatch):
    got = _flight_spans("port", monkeypatch)
    want = _flight_spans("reference", monkeypatch)
    assert got == want
    names = sorted(name for name, _ in got)
    assert names == ["serve.flight", "serve.flight.wait", "serve.flight.wait"]
    lead = dict(next(a for name, a in got if name == "serve.flight"))
    assert lead == {"key": str(("m.cz", 3)), "followers": ["follower-1", "follower-2"],
                    "rid": "leader-1"}
    waits = sorted(dict(a)["rid"] for name, a in got if name == "serve.flight.wait")
    assert waits == ["follower-1", "follower-2"]
    for name, a in got:
        if name == "serve.flight.wait":
            assert dict(a) == {"key": str(("m.cz", 3)), "leader": "leader-1",
                               "rid": dict(a)["rid"]}


# ---------------------------------------------------------------------------
# ChunkScheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheduler_read_box_equals_reference(roots, scheme):
    n = N_RAW if scheme == "raw" else N_SCHEME
    with TDataset(roots[scheme], cache_chunks=2, device="cpu") as tds, \
            RDataset(roots[scheme], cache_chunks=2) as rds:
        ts, rs = tsched.ChunkScheduler(tds), rsched.ChunkScheduler(rds)
        for q, t, lo, hi in _queries(n):
            got = ts.read_box(q, t, lo, hi)
            want = rs.read_box(q, t, lo, hi)
            assert got.tobytes() == want.tobytes()
        assert ts.stats() == rs.stats()
        assert list(ts.stats()) == ["flights_led", "flights_joined", "bytes_decoded"]
        assert (ts.flights_led, ts.flights_joined) == (rs.flights_led, rs.flights_joined)
        assert tds.stats() == rds.stats()


@pytest.mark.parametrize("pkg", list(PKG))
def test_scheduler_pins_a_box_chunks_under_lru_pressure(roots, pkg):
    """cache_chunks=1: a box whose blocks revisit a chunk after another
    still decodes each covering chunk once (the request's pins)."""
    p = PKG[pkg]
    with p.CZDataset(roots["raw"], cache_chunks=1, **p.ds_kw) as ds:
        sched = p.sched.ChunkScheduler(ds)
        lo, hi = (0, 0, 0), (BS, 2 * BS, 2 * BS)   # blocks 0, 1, 4, 5: chunks 0, 0, 2, 2
        r = ds.reader("p", 0)
        covering = r.box_chunks(lo, hi)
        box = sched.read_box("p", 0, lo, hi)
        assert box.tobytes() == FIELDS["p"][:BS, :2 * BS, :2 * BS].tobytes()
        assert ds.stats()["chunks_decoded"] == len(covering) == 2
        assert sched.stats() == {"flights_led": 2, "flights_joined": 0,
                                 "bytes_decoded": 2 * 2 * BS ** 3 * 4}


def test_scheduler_keys_flights_by_member_path(roots, monkeypatch):
    """While a chunk's decode is airborne, ``in_flight((reader.path, ci))``
    is true for it and for nothing else — the veto prefetch consults."""
    gate = Gate(monkeypatch, TPipeline)
    with TDataset(roots["raw"], device="cpu", prefetch=2) as ds:
        sched = tsched.ChunkScheduler(ds)
        r = ds.reader("p", 0)
        seen = {}
        orig = type(r).read_box

        def spy(self, lo, hi, chunk_getter=None, prefetch_skip=None):
            seen["skip"] = prefetch_skip
            return orig(self, lo, hi, chunk_getter=chunk_getter,
                        prefetch_skip=prefetch_skip)

        monkeypatch.setattr(type(r), "read_box", spy)
        out, threads = _in_threads([lambda: sched.read_box("p", 0, (0, 0, 0), (BS, BS, BS))])
        gate.wait(lambda g: g.entered == 1, "the decode never started")
        assert sched._sf.in_flight((r.path, 0))
        assert not sched._sf.in_flight((r.path, 1))
        assert not sched._sf.in_flight((ds.reader("rho", 0).path, 0))
        assert seen["skip"](0) is True and seen["skip"](1) is False
        gate.release.set()
        _join(threads)
        assert out[0].tobytes() == FIELDS["p"][:BS, :BS, :BS].tobytes()
        assert not sched._sf.in_flight((r.path, 0))


# ---------------------------------------------------------------------------
# FieldRegionServer against the reference's, serial queries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_queries_and_stats_equal_reference(roots, scheme):
    n = N_RAW if scheme == "raw" else N_SCHEME
    script = _queries(n) + [("vorticity", 0, (0, 0, 0), (4, 4, 4)),
                            ("p", 9, (0, 0, 0), (4, 4, 4)),
                            ("p", 0, (0, 0, 0), (n + 1, 4, 4))]
    with _server("port", roots[scheme], cache_chunks=4) as t, \
            _server("reference", roots[scheme], cache_chunks=4) as r:
        got, want = _run_script(t, script), _run_script(r, script)
        assert got == want
        ts, rs = t.stats(), r.stats()
    assert list(ts) == list(rs)               # the keys, letter for letter, in order
    assert _det(ts) == _det(rs)
    assert ts["queries"] == len(_queries(n))  # failed queries are not counted
    assert ts["trace_kept_error"] == 3 and ts["trace_sampled"] == len(script)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_query_equals_the_members_read(roots, scheme):
    n = N_RAW if scheme == "raw" else N_SCHEME
    with TDataset(roots[scheme], device="cpu") as ds, \
            _server("port", roots[scheme]) as srv:
        for q, t, lo, hi in _queries(n)[:6]:
            got = srv.query(q, t, lo, hi)
            want = ds.read_box(q, t, lo, hi)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()


def test_three_tiers(roots):
    """Region LRU, then the reader's chunk LRU, then decode."""
    with _server("port", roots["raw"]) as srv:
        lo, hi = (1, 2, 3), (9, 14, 15)       # blocks (0..1, 0..1, 0..1): 4 chunks
        covering = srv.ds.reader("p", 0).box_chunks(lo, hi)
        srv.query("p", 0, lo, hi)
        s = srv.stats()
        assert (s["chunks_decoded"], s["region_cache_misses"]) == (len(covering), 1)
        srv.query("p", 0, lo, hi)             # the same box: region hit
        s = srv.stats()
        assert (s["chunks_decoded"], s["region_cache_hits"], s["cache_hits"]) == \
            (len(covering), 1, 0)
        srv.query("p", 0, (2, 2, 2), (10, 10, 10))   # other box, same chunks
        s = srv.stats()
        assert (s["chunks_decoded"], s["region_cache_misses"]) == (len(covering), 2)
        assert s["cache_hits"] == len(covering)   # each chunk once, from the LRU
        assert s["region_cache_entries"] == 2


def test_query_copy_semantics(roots):
    with _server("port", roots["raw"]) as srv:
        box = srv.query("p", 0, (0, 0, 0), (BS, BS, BS))
        assert box.flags.writeable
        shared = srv.query("p", 0, (0, 0, 0), (BS, BS, BS), copy=False)
        assert not shared.flags.writeable
        assert srv.query("p", 0, (0, 0, 0), (BS, BS, BS), copy=False) is shared
        box[0, 0, 0] = 1e9                    # a private copy: the cache is untouched
        assert srv.query("p", 0, (0, 0, 0), (BS, BS, BS))[0, 0, 0] == FIELDS["p"][0, 0, 0]


def test_manifest_is_the_datasets_describe(roots):
    with _server("port", roots["raw"]) as t, _server("reference", roots["raw"]) as r:
        assert t.manifest() == r.manifest() == t.ds.describe()


@pytest.mark.parametrize("sample", [True, False])
def test_stats_keys_with_and_without_sampling(roots, sample):
    with _server("port", roots["raw"], sample=sample) as t, \
            _server("reference", roots["raw"], sample=sample) as r:
        assert list(t.stats()) == list(r.stats())
        assert (t.sampler is None) == (not sample)
        assert any(k.startswith("trace_") for k in t.stats()) == sample


def test_failed_query_is_kept_as_an_error_trace(roots):
    with _server("port", roots["raw"]) as srv:
        with pytest.raises(ValueError, match="outside field"):
            srv.query("p", 0, (0, 0, 0), (N_RAW + 1, 1, 1))
        kept = srv.sampler.traces()
        assert [k["reason"] for k in kept] == ["error"]
        rec = srv.sampler.get(kept[0]["request_id"])
        assert rec["error"].startswith("ValueError: box")
        assert "serve.query" in [e["name"] for e in rec["events"]]
        assert srv.latency.snapshot()["count"] == 1   # errors are observed too


def test_kept_trace_holds_the_request_spans(roots):
    """trace_slow_ms=0 keeps every query's trace: a cold query's timeline
    has the query span and each chunk's fetch, as the reference's has."""
    names = {}
    for pkg in PKG:
        with _server(pkg, roots["raw"], trace_slow_ms=0.0) as srv:
            srv.query("p", 0, (0, 0, 0), (BS, BS, 2 * BS))
            (kept,) = srv.sampler.traces()
            assert kept["reason"] == "slow"
            names[pkg] = sorted({e["name"] for e in srv.sampler.get(kept["request_id"])["events"]})
    assert names["port"] == names["reference"]
    assert {"serve.query", "fetch"} <= set(names["port"])


# ---------------------------------------------------------------------------
# coalescing and admission, both packages, deterministic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", list(PKG))
def test_concurrent_duplicate_queries_decode_once(roots, pkg, monkeypatch):
    p = PKG[pkg]
    n_clients = 6
    lo, hi = (0, 0, 0), (BS, 3 * BS, BS)       # 3 chunks
    parked = Parked(monkeypatch, p.sched)
    gate = Gate(monkeypatch, p.Pipeline)
    with _server(pkg, roots["raw"], cache_chunks=1, max_inflight=n_clients) as srv:
        covering = srv.ds.reader("p", 0).box_chunks(lo, hi)
        assert len(covering) == 3
        barrier = threading.Barrier(n_clients)

        def q():
            barrier.wait()
            return srv.query("p", 0, lo, hi).tobytes()

        out, threads = _in_threads([q] * n_clients)
        gate.wait(lambda g: g.entered == 1, "no decode started")
        parked.wait(n_clients - 1)            # every other caller joined the flight
        gate.release.set()
        _join(threads)
        s = srv.stats()
    assert out == [FIELDS["p"][:BS, :3 * BS, :BS].tobytes()] * n_clients
    assert s["chunks_decoded"] == gate.entered == len(covering)
    assert (s["queries"], s["region_flights_led"], s["region_flights_joined"]) == \
        (n_clients, 1, n_clients - 1)
    assert (s["region_cache_hits"], s["flights_joined"]) == (0, 0)


@pytest.mark.parametrize("pkg", list(PKG))
def test_overlapping_boxes_share_a_chunk_flight(roots, pkg, monkeypatch):
    """Two different boxes that share their first chunk: one decode of it,
    one chunk-level join, and the union of their chunks decoded once."""
    p = PKG[pkg]
    parked = Parked(monkeypatch, p.sched)
    gate = Gate(monkeypatch, p.Pipeline)
    box_a = ((0, 0, 0), (BS, BS, 2 * BS))      # chunk 0
    box_b = ((0, 0, 0), (BS, 2 * BS, BS))      # chunks 0, 2
    with _server(pkg, roots["raw"], cache_chunks=1) as srv:
        r = srv.ds.reader("p", 0)
        chunks = set(r.box_chunks(*box_a)) | set(r.box_chunks(*box_b))
        barrier = threading.Barrier(2)

        def q(box):
            barrier.wait()
            return srv.query("p", 0, *box).tobytes()

        out, threads = _in_threads([lambda: q(box_a), lambda: q(box_b)])
        gate.wait(lambda g: g.entered == 1, "no decode started")
        parked.wait(1)
        gate.release.set()
        _join(threads)
        s = srv.stats()
    f = FIELDS["p"]
    assert out == [f[:BS, :BS, :2 * BS].tobytes(), f[:BS, :2 * BS, :BS].tobytes()]
    assert s["chunks_decoded"] == len(chunks) == 2
    assert (s["flights_led"], s["flights_joined"]) == (2, 1)
    assert s["region_flights_joined"] == 0


class Admission:
    """Wraps a server's admission semaphore: counts the callers that reached
    it and the ones holding it."""

    def __init__(self, sem):
        self.sem = sem
        self.cond = threading.Condition()
        self.arrived = self.holding = 0

    def __enter__(self):
        with self.cond:
            self.arrived += 1
            self.cond.notify_all()
        self.sem.__enter__()
        with self.cond:
            self.holding += 1
        return self

    def __exit__(self, *exc):
        with self.cond:
            self.holding -= 1
        return self.sem.__exit__(*exc)


@pytest.mark.parametrize("pkg", list(PKG))
def test_admission_bounds_concurrent_decodes_only(roots, pkg, monkeypatch):
    """max_inflight=2 over four members (four readers, whose decodes could
    all run at once): two decode, two wait at the semaphore, and a cached
    box is answered meanwhile without queueing."""
    p = PKG[pkg]
    members = [("p", 0), ("p", 1), ("rho", 0), ("rho", 1)]
    lo, hi = (0, 0, 0), (BS, BS, BS)
    with _server(pkg, roots["raw"], max_inflight=2) as srv:
        warm = srv.query("p", 0, (BS, BS, BS), (2 * BS, 2 * BS, 2 * BS))
        adm = srv.admission = Admission(srv.admission)
        gate = Gate(monkeypatch, p.Pipeline)
        out, threads = _in_threads([lambda m=m: srv.query(*m, lo, hi) for m in members])
        with adm.cond:
            assert adm.cond.wait_for(lambda: adm.arrived == 4, timeout=30)
        gate.wait(lambda g: g.entered == 2, "two decodes never started")
        assert (gate.inside, adm.holding) == (2, 2)
        hit, hit_threads = _in_threads(
            [lambda: srv.query("p", 0, (BS, BS, BS), (2 * BS, 2 * BS, 2 * BS))])
        _join(hit_threads)                    # a region-cache hit never queues
        assert hit[0].tobytes() == warm.tobytes()
        assert adm.arrived == 4 and gate.entered == 2
        gate.release.set()
        _join(threads)
        s = srv.stats()
    assert gate.max_inside == 2 and gate.entered == 4
    for (q, t), got in zip(members, out):
        assert got.tobytes() == (FIELDS[q][:BS, :BS, :BS] + np.float32(t)).tobytes()
    assert s["chunks_decoded"] == 5 and s["region_cache_hits"] == 1


@pytest.mark.parametrize("pkg", list(PKG))
def test_a_failed_decode_reaches_every_coalesced_caller(roots, pkg, monkeypatch):
    p = PKG[pkg]
    parked = Parked(monkeypatch, p.sched)
    gate = Gate(monkeypatch, p.Pipeline, fail=OSError("disk gone"))
    with _server(pkg, roots["raw"]) as srv:
        out, threads = _in_threads([lambda: srv.query("p", 0, (0, 0, 0), (4, 4, 4))] * 3)
        gate.wait(lambda g: g.entered == 1, "no decode started")
        parked.wait(2)
        gate.release.set()
        _join(threads)
        s = srv.stats()
    assert [type(e) for e in out] == [OSError] * 3
    assert s["queries"] == 0 and s["trace_kept_error"] == 3
    assert srv.latency.snapshot()["count"] == 3


# ---------------------------------------------------------------------------
# lifecycle and device
# ---------------------------------------------------------------------------

def test_close_only_closes_an_owned_dataset(roots, tmp_path):
    root = _write(str(tmp_path / "ds"), "raw")
    with TDataset(root, "a", device="cpu") as ds:
        srv = tserve.FieldRegionServer(ds)    # borrowed: keeps its device
        srv.query("p", 0, (0, 0, 0), (BS, BS, BS))
        srv.close()
        assert srv.closed
        ds.read_box("p", 0, (0, 0, 0), (BS, BS, BS))
        ds.append({q: f for q, f in FIELDS.items()})
    srv = _server("port", root)
    r = srv.ds.reader("p", 0)
    srv.close()
    srv.close()                               # idempotent
    assert r.closed and not srv.ds._readers   # owned: the dataset was closed
    msgs = {}
    for pkg in PKG:
        s = _server(pkg, root)
        s.close()
        with pytest.raises(IOError) as q:
            s.query("p", 0, (0, 0, 0), (BS, BS, BS))
        with pytest.raises(IOError) as m:
            s.manifest()
        msgs[pkg] = (str(q.value), str(m.value))
    assert msgs["port"] == msgs["reference"]


def test_server_opens_roots_on_the_card_by_default(roots, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.FieldRegionServer(roots["raw"])
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.FieldRegionServer(roots["raw"], device="cuda")
    with tserve.FieldRegionServer(roots["raw"], device="cpu") as srv:
        assert srv.ds.device == torch.device("cpu")


def test_server_options_reach_the_dataset(roots):
    with _server("port", "file://" + roots["raw"], cache_readers=3, cache_chunks=5,
                 prefetch=2, cache_bytes=1234, max_inflight=None) as srv:
        assert (srv.ds._cache_readers, srv.ds._cache_chunks, srv.ds._prefetch) == (3, 5, 2)
        assert srv.cache.max_bytes == 1234
        assert srv.ds.device == torch.device("cpu")
        assert srv.query("rho", 1, (0, 0, 0), (2, 2, 2)).tobytes() == \
            (FIELDS["rho"][:2, :2, :2] + np.float32(1)).tobytes()
    from repro_torch.store.backends import FileStore

    with _server("port", FileStore(roots["raw"])) as srv:
        assert srv._owns_dataset and srv.ds.quantities == ["p", "rho"]
