"""The port's byte stores (``repro_torch.store.backends``) against the JAX
package's (``repro.store.backends``), on the CPU.

Every comparison runs the same operations on a store of each package and
asserts the same outcomes: the values returned, the exception raised (by
type, with the range error's start and size), the request counters, the
retry layer's backoff schedule, the injected faults and the ``cz_store_*``
series each package records in its own registry.  Concurrency tests start
their threads on a barrier and join with a timeout; nothing sleeps.
"""
import functools
import os
import threading
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import pytest

from repro import obs as robs
from repro.store import backends as rb

from repro_torch import obs as tobs
from repro_torch.store import backends as tb

BACKENDS = ["file", "mem", "range"]
DATA = b"0123456789"


def _make(pkg, kind: str, root):
    if kind == "file":
        return pkg.FileStore(os.fspath(root))
    if kind == "mem":
        return pkg.MemoryStore()
    return pkg.RangeStore()


def _outcome(fn):
    """What one call did: its value, or its exception's type (and, for a
    range error, where it starts and how long the object is)."""
    try:
        return ("ok", fn())
    except (KeyError, OSError, ValueError, TypeError) as e:
        extra = (e.start, e.size) if isinstance(e, (rb.StoreRangeError,
                                                    tb.StoreRangeError)) else ()
        return (type(e).__name__, *extra)


def _script(st) -> list:
    """The Store contract as a list of outcomes: round trip, ranges (short
    read at EOF, start at or past the end, the empty object), missing keys,
    list by prefix, delete, exists, put_atomic, get_many."""
    out = []
    for key, data in (("a/b.bin", DATA), ("a/empty.bin", b""), ("q/t2.cz", b"x"),
                      ("q/t0.cz", b"y"), ("manifest.json", b"{}")):
        out.append(_outcome(lambda k=key, d=data: st.put(k, d)))
    for rng in (None, (2, 5), (4, None), (0, 0), (8, 100), (9, None), (10, None),
                (10, 14), (11, None), (100, None), (5, 5)):
        out.append(_outcome(lambda r=rng: st.get("a/b.bin", r)))
    for key, rng in (("a/empty.bin", None), ("a/empty.bin", (0, None)),
                     ("a/empty.bin", (0, 8)), ("a/empty.bin", (1, None)),
                     ("a/nope.bin", None), ("a/nope.bin", (100, None)),
                     ("a/nope.bin", (0, 4))):
        out.append(_outcome(lambda k=key, r=rng: st.get(k, r)))
    out.append(_outcome(lambda: st.get_many([("a/b.bin", (0, 2)), ("a/b.bin", (8, None)),
                                             ("a/b.bin", None)])))
    for prefix in ("", "q/", "manifest", "zzz"):
        out.append(_outcome(lambda p=prefix: st.list(p)))
    out.append(_outcome(lambda: st.exists("q/t0.cz")))
    out.append(_outcome(lambda: st.delete("q/t0.cz")))
    out.append(_outcome(lambda: st.exists("q/t0.cz")))
    out.append(_outcome(lambda: st.delete("q/t0.cz")))
    out.append(_outcome(lambda: st.put_atomic("manifest.json", b'{"v": 1}')))
    out.append(_outcome(lambda: st.put_atomic("manifest.json", b'{"v": 2}')))
    out.append(_outcome(lambda: st.get("manifest.json")))
    out.append(_outcome(lambda: st.put("a/b.bin", b"xy")))
    out.append(_outcome(lambda: st.get("a/b.bin")))
    out.append(_outcome(lambda: st.list("")))  # no tmp residue
    return out


@pytest.mark.parametrize("kind", BACKENDS)
def test_store_contract_matches_reference(tmp_path, kind):
    ref, port = _make(rb, kind, tmp_path / "r"), _make(tb, kind, tmp_path / "t")
    got = _script(port)
    assert got == _script(ref)
    assert ("StoreRangeError", 10, 10) in got and ("StoreKeyError",) in got
    if kind == "range":
        assert port.stats() == ref.stats()
        assert port.stats()["get_requests"] > 0


@pytest.mark.parametrize("kind", BACKENDS)
def test_open_write_streams_commits_and_tears_nothing(tmp_path, kind):
    for pkg, sub in ((rb, "r"), (tb, "t")):
        st = _make(pkg, kind, tmp_path / sub)
        with st.open_write("p/t0.cz") as f:
            f.write(b"head")
            f.write(b"body")
            f.seek(0)
            f.write(b"H")  # the CZ2 writer seeks back to patch its pointer
        assert st.get("p/t0.cz") == b"Headbody"
        with pytest.raises(RuntimeError):
            with st.open_write("p/t1.cz") as f:
                f.write(b"partial")
                raise RuntimeError("simulated encoder crash")
        # a FileStore streams, so it has the partial file; buffered backends
        # never expose a torn object
        assert st.exists("p/t1.cz") == (kind == "file")


@pytest.mark.parametrize("kind", BACKENDS)
@pytest.mark.parametrize("bad", ["", "/abs", "a//b", "a/../b", ".", "..", "a\\b", None, 7],
                         ids=repr)
def test_bad_keys_rejected_as_reference(tmp_path, kind, bad):
    got = _outcome(lambda: _make(tb, kind, tmp_path / "t").put(bad, b"x"))
    assert got == _outcome(lambda: _make(rb, kind, tmp_path / "r").put(bad, b"x"))
    assert got[0] in ("ValueError", "TypeError")


@pytest.mark.parametrize("kind", BACKENDS)
def test_lock_is_exclusive(tmp_path, kind):
    st = _make(tb, kind, tmp_path / "t")
    counter = {"v": 0}
    start = threading.Barrier(4)

    def bump():
        start.wait(10)
        for _ in range(200):
            with st.lock(".l"):
                v = counter["v"]
                counter["v"] = v + 1

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert counter["v"] == 800


def _http_script(st) -> list:
    return [_outcome(lambda r=rng: st.get(key, r)) for key, rng in (
        ("a/b.bin", None), ("a/b.bin", (2, 5)), ("a/b.bin", (4, None)),
        ("a/b.bin", (0, 0)), ("a/b.bin", (8, 100)), ("a/b.bin", (10, None)),
        ("a/b.bin", (10, 14)), ("a/b.bin", (5, 5)), ("a/empty.bin", None),
        ("a/empty.bin", (0, 8)), ("a/empty.bin", (1, None)), ("a/nope.bin", None),
        ("a/nope.bin", (0, 4)))] + [
        _outcome(lambda: st.exists("a/b.bin")), _outcome(lambda: st.exists("a/nope.bin")),
        _outcome(lambda: st.get_many([("a/b.bin", (0, 2)), ("a/b.bin", (8, None)),
                                      ("a/b.bin", None)])),
        _outcome(lambda: st.put("x.bin", b"nope")), _outcome(lambda: st.delete("a/b.bin")),
        _outcome(lambda: st.list(""))]


@pytest.mark.parametrize("server", ["port", "reference"])
def test_http_store_contract_matches_reference(tmp_path, server):
    """Each package's HttpStore against the same StaticFileServer (the
    port's or the reference's): the same outcomes, ranged requests and
    read-only refusals."""
    os.makedirs(tmp_path / "a")
    (tmp_path / "a" / "b.bin").write_bytes(DATA)
    (tmp_path / "a" / "empty.bin").write_bytes(b"")
    srv_pkg = tb if server == "port" else rb
    with srv_pkg.StaticFileServer(tmp_path) as srv:
        assert srv.url.startswith("http://127.0.0.1:")
        with tb.HttpStore(srv.url) as port, rb.HttpStore(srv.url) as ref:
            got = _http_script(port)
            assert got == _http_script(ref)
            assert got[1] == ("ok", b"234") and got[5] == ("StoreRangeError", 10, 10)
            assert port.stats() == ref.stats()
            assert port.stats()["range_requests"] >= 5


def test_http_store_slices_when_server_ignores_range(tmp_path):
    """The stdlib server answers 200-with-everything to a ranged GET; the
    store slices client-side and stays correct."""
    (tmp_path / "m.json").write_bytes(DATA * 3)
    handler = functools.partial(SimpleHTTPRequestHandler, directory=str(tmp_path))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address[:2]
        with tb.HttpStore(f"http://{host}:{port}") as st:
            assert st.get("m.json", (2, 10)) == (DATA * 3)[2:10]
            assert st.get("m.json", (4, None)) == (DATA * 3)[4:]
            with pytest.raises(tb.StoreRangeError):
                st.get("m.json", (35, None))
    finally:
        srv.shutdown()
        thread.join(timeout=5)
        srv.server_close()
    assert not thread.is_alive()


def _retry(pkg, flaky, **kw):
    kw.setdefault("jitter", 0.0)
    sleeps = []
    return pkg.RetryStore(flaky, sleep=sleeps.append, **kw), sleeps


def _flaky_run(pkg, case: str):
    """One retry scenario on a package's stores; returns what the caller
    saw, the sleeps, the faults injected and the gets issued."""
    if case == "recover":
        flaky = pkg.FlakyStore(pkg.MemoryStore())
        flaky.put("k", b"v")
        rs, sleeps = _retry(pkg, flaky)
        flaky.fail_on_get = flaky.gets + 1
        got = _outcome(lambda: rs.get("k"))
    elif case == "exhaust":
        flaky = pkg.FlakyStore(pkg.MemoryStore(), fail_on_get=1, fail_every=1)
        flaky.put("k", b"v")
        rs, sleeps = _retry(pkg, flaky, retries=3, backoff=0.01, max_backoff=0.04)
        got = _outcome(lambda: rs.get("k"))
    elif case == "deadline":
        flaky = pkg.FlakyStore(pkg.MemoryStore(), fail_on_get=1, fail_every=1)
        flaky.put("k", b"v")
        rs, sleeps = _retry(pkg, flaky, retries=5, backoff=10.0, deadline=0.5)
        got = _outcome(lambda: rs.get("k"))
    elif case == "permanent":
        mem = pkg.MemoryStore()
        mem.put("k", DATA)
        flaky = pkg.FlakyStore(mem)
        rs, sleeps = _retry(pkg, flaky, retries=5)
        got = [_outcome(lambda: rs.get("nope")), _outcome(lambda: rs.get("k", (100, None))),
               _outcome(lambda: rs.delete("nope"))]
    else:  # put faults on every other commit, all absorbed
        flaky = pkg.FlakyStore(pkg.MemoryStore(), fail_on_put=1, fail_every=2)
        rs, sleeps = _retry(pkg, flaky, retries=3)
        for i in range(4):
            rs.put(f"m{i}", b"x" * i)
            rs.put_atomic("manifest.json", bytes([i]))
        with rs.open_write("w.cz") as f:  # the buffered sink commits via put
            f.write(b"streamed")
        got = [rs.get("manifest.json"), rs.get("w.cz"), rs.list("")]
    return got, sleeps, flaky.faults, flaky.gets


@pytest.mark.parametrize("case", ["recover", "exhaust", "deadline", "permanent", "puts"])
def test_retry_policy_matches_reference(case):
    """Recovery, exhaustion (doubling, capped backoff), the deadline and
    permanent errors: the port's RetryStore does what the reference's does,
    and counts the same retries and deadlines in its own registry."""
    def counts(obs):
        return {n: obs.REGISTRY.get(n).value(backend="flakystore", op=op)
                for n in ("cz_store_retries_total", "cz_store_deadline_exceeded_total")
                for op in ("get", "put", "put_atomic")} if obs.REGISTRY.get(
                    "cz_store_retries_total") else {}

    before = (counts(tobs), counts(robs))
    got = _flaky_run(tb, case)
    want = _flaky_run(rb, case)
    assert got == want
    after = (counts(tobs), counts(robs))
    delta = [{k: a[k] - b.get(k, 0) for k in a} for a, b in zip(after, before)]
    assert delta[0] == delta[1]
    if case == "exhaust":
        assert got[1] == [0.01, 0.02, 0.04] and got[3] == 4
    if case == "deadline":
        assert got[0][0] == "StoreDeadlineError" and got[1] == []


@pytest.mark.parametrize("arm", [
    dict(fail_on_get=2), dict(fail_on_get=1, fail_every=3), dict(fail_on_put=2),
    dict(fail_on_op={"delete": 1, "list": 2}),
], ids=["get-once", "get-every-3", "put", "ops"])
def test_flaky_store_faults_match_reference(arm):
    def run(pkg):
        flaky = pkg.FlakyStore(pkg.MemoryStore(), **arm)
        out = [_outcome(lambda i=i: flaky.put(f"k{i}", bytes([i]))) for i in range(3)]
        out += [_outcome(lambda i=i: flaky.get(f"k{i % 3}")) for i in range(7)]
        out.append(_outcome(lambda: flaky.get_many([("k0", None), ("k1", (0, 1))])))
        out += [_outcome(lambda: flaky.list("")) for _ in range(2)]
        out.append(_outcome(lambda: flaky.delete("k0")))
        out.append(_outcome(lambda: flaky.exists("k1")))  # never faulted
        return (out, flaky.faults, flaky.gets, flaky.puts, dict(flaky.op_calls),
                flaky.url.startswith("flaky+mem://anon-"))

    got = run(tb)
    assert got == run(rb)
    assert got[1] >= 1 and any(o[0] == "InjectedFault" for o in got[0])
    assert got[5]


def test_instrumented_store_series_match_reference():
    """The same operations through each package's InstrumentedStore add the
    same amounts to the same ``cz_store_*`` series (each in its own
    registry), and the meters agree."""
    label = "torchport_instr"

    def series(obs):
        out = {}
        for op in ("get", "put", "put_atomic", "list", "delete", "exists"):
            ops_ = obs.REGISTRY.get("cz_store_ops_total")
            nbytes = obs.REGISTRY.get("cz_store_bytes_total")
            secs = obs.REGISTRY.get("cz_store_op_seconds")
            out[op] = (ops_.value(backend=label, op=op), nbytes.value(backend=label, op=op),
                       secs.snapshot(backend=label, op=op)["count"])
        return out

    def run(pkg):
        st = pkg.InstrumentedStore(pkg.MemoryStore(), backend=label)
        st.put("a", DATA)
        st.put_atomic("m", b"{}")
        st.get("a")
        st.get("a", (2, 6))
        st.get_many([("a", (0, 1)), ("a", None)])
        st.list("")
        st.exists("a")
        st.delete("m")
        with st.open_write("w") as f:  # delegates to the inner buffered sink
            f.write(b"abc")
        return st.stats(), st.url.startswith("mem://anon-")

    before = (series(tobs), series(robs)) if tobs.REGISTRY.get("cz_store_ops_total") else None
    got, want = run(tb), run(rb)
    assert got == want
    assert got[0]["get_requests"] == 4 and got[0]["range_requests"] == 2
    after = (series(tobs), series(robs))
    base = before or ({op: (0, 0, 0) for op in after[0]},) * 2
    delta = [{op: tuple(x - y for x, y in zip(a[op], b[op])) for op in a}
             for a, b in zip(after, base)]
    assert delta[0] == delta[1]
    # get_many meters its two gets without timing them
    assert delta[0]["get"][0] == 4 and delta[0]["get"][2] == 2
    assert delta[0]["put"] == (1, len(DATA), 1)


def test_range_store_counts_and_latency_match_reference():
    def run(pkg):
        st = pkg.RangeStore(latency=0.0)
        st.put("a", DATA * 10)
        st.get("a", (0, 12))
        st.get("a")
        st.get_many([("a", (i, i + 3)) for i in range(0, 30, 3)])
        return st.stats(), st.latency, st.get_requests, st.range_requests, st.bytes_fetched

    assert run(tb) == run(rb)
    assert tb.RangeStore(latency=0.002).latency == 0.002


def test_open_store_url_parsing_matches_reference(tmp_path):
    for pkg in (tb, rb):
        st = pkg.open_store(os.path.join(tmp_path, "plain"))
        assert isinstance(st, pkg.FileStore) and st.root.endswith("plain")
        st = pkg.open_store(f"file://{tmp_path}/sub")
        assert isinstance(st, pkg.FileStore) and st.url == f"file://{tmp_path}/sub"
        assert pkg.open_store("mem://torch_urls") is pkg.open_store("mem://torch_urls")
        assert pkg.open_store("mem://torch_urls").url == "mem://torch_urls"
        pkg.MemoryStore.drop("torch_urls")
        r = pkg.open_store("range://torch_urls")
        assert isinstance(r, pkg.RangeStore) and r is not pkg.MemoryStore.named("torch_urls")
        pkg.RangeStore.drop("torch_urls")
        pkg.MemoryStore.drop("torch_urls")
        passthrough = pkg.MemoryStore()
        assert pkg.open_store(passthrough) is passthrough
        h = pkg.open_store("http://127.0.0.1:9/ds")
        assert isinstance(h, pkg.RetryStore) and isinstance(h.inner, pkg.HttpStore)
        assert h.url == "http://127.0.0.1:9/ds" and h.retries == 2
        assert isinstance(pkg.open_store("http://127.0.0.1:9/ds", retries=0), pkg.HttpStore)
        tuned = pkg.open_store("http://127.0.0.1:9/ds", retries=5, timeout=3.0)
        assert tuned.retries == 5 and tuned.deadline == 3.0 and tuned.inner.timeout == 3.0
        local = pkg.open_store(str(tmp_path / "d"), retries=3)
        assert isinstance(local, pkg.RetryStore) and isinstance(local.inner, pkg.FileStore)
        inst = pkg.open_store("mem://torch_urls2", instrument=True)
        assert isinstance(inst, pkg.InstrumentedStore) and inst.meter.backend == "mem"
        pkg.MemoryStore.drop("torch_urls2")
        with pytest.raises(ValueError, match="unknown store scheme 's3'"):
            pkg.open_store("s3://bucket/prefix")
        with pytest.raises(ValueError, match="mem:// URLs need a name"):
            pkg.open_store("mem://")
    assert sorted(tb.STORE_SCHEMES) == sorted(rb.STORE_SCHEMES)


def test_register_third_party_scheme():
    class UpperStore(tb.MemoryStore):
        scheme = "upper"
        _named = {}

    tb.register_store_scheme("upper", UpperStore.from_url)
    try:
        st = tb.open_store("upper://thirdparty")
        assert isinstance(st, UpperStore) and st is tb.open_store("upper://thirdparty")
        assert st.url == "upper://thirdparty"
        assert "upper" not in rb.STORE_SCHEMES  # the registries are separate
    finally:
        tb.STORE_SCHEMES.pop("upper", None)
        UpperStore.drop("thirdparty")
    for bad in ("", "s3://x"):
        with pytest.raises(ValueError, match="invalid store scheme"):
            tb.register_store_scheme(bad, UpperStore.from_url)
