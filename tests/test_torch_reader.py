"""The port's container over the ``Store`` protocol and its random-access
reader (``describe``, ``read_field(store=)``, ``FieldReader``), against the
JAX package's, on the CPU.

* ``describe`` of every committed fixture equals the reference's dict.
* ``FieldReader.read_box`` of seeded random boxes equals the reference's
  ``read_box`` bit for bit for raw, zfpx, lorenzo, szx, auto and wavelet
  (the port's plain wavelet inverse has the reference's host-path bits, as
  ``tests/test_torch_container.py`` holds whole reads), and the port's own
  ``read_field`` slice bit for bit.
* Containers written through any local store backend are the reference's
  bytes; reads through every backend, HTTP included, agree.
* The reader's rules: ``chunks_decoded``, terminal ``close``, the cache,
  the ``cz_reader_*`` series (the same deltas as the reference's), and
  prefetch (same bits, same request and byte counts, evicted and failed
  prefetches refetched).  A failing decode raises out of ``read_box``.
"""
import glob
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import CompressionSpec as RSpec
from repro.core import container as rcont
from repro.store import backends as rb

from repro_torch import obs as tobs
from repro_torch.core import container as tcont
from repro_torch.core import wavelets as twv
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.store import backends as tb

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(DATA, "*.cz")))
N, BS = 32, 8
# 8 KiB buffers: 4 blocks of 8^3 per chunk, 16 chunks per 32^3 field
KW = dict(block_size=BS, buffer_bytes=1 << 13)
SCHEMES = ["raw", "zfpx", "lorenzo", "szx", "auto", "wavelet"]


def _field(seed=0):
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:N, 0:N, 0:N].astype(np.float32) / N
    f = 40 * np.sin(4 * g[0] + 2 * g[1]) * np.exp(-g[2]) + rng.standard_normal((N, N, N))
    return f.astype(np.float32)


FIELD = _field()


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One container per scheme, written by the reference."""
    root = tmp_path_factory.mktemp("reader")
    out = {}
    for scheme in SCHEMES:
        out[scheme] = str(root / f"{scheme}.cz")
        rcont.write_field(out[scheme], FIELD, RSpec(scheme=scheme, **KW))
    return out


def _boxes(seed, n=N, count=6):
    rng = np.random.default_rng(seed)
    out = [((0, 0, 0), (n, n, n)), ((0, 0, 0), (BS, BS, BS))]
    for _ in range(count):
        lo = rng.integers(0, n - 1, 3)
        hi = [int(rng.integers(a + 1, n + 1)) for a in lo]
        out.append((tuple(int(v) for v in lo), tuple(hi)))
    return out


@pytest.mark.parametrize("verify", [False, True], ids=["plain", "verify"])
@pytest.mark.parametrize("name", FIXTURES)
def test_describe_equals_reference_on_fixtures(name, verify):
    path = os.path.join(DATA, f"{name}.cz")
    got = tcont.describe(path, verify=verify)
    want = rcont.describe(path, verify=verify)
    assert got == want
    assert list(got) == list(want)  # key order too
    if verify:
        assert got["crc_ok"] is True


@pytest.mark.parametrize("name", FIXTURES)
def test_read_box_equals_reference_on_fixtures(name):
    path = os.path.join(DATA, f"{name}.cz")
    full = tcont.read_field(path, device="cpu")
    with tcont.FieldReader(path, device="cpu") as t, rcont.FieldReader(path) as r:
        for lo, hi in _boxes(7, n=16):
            got = t.read_box(lo, hi)
            sl = tuple(slice(a, b) for a, b in zip(lo, hi))
            np.testing.assert_array_equal(got, full[sl], strict=True)
            np.testing.assert_array_equal(got, r.read_box(lo, hi), strict=True)
        assert t.chunks_decoded == r.chunks_decoded
        assert (t.cache_hits, t.cache_misses) == (r.cache_hits, r.cache_misses)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_read_box_equals_reference(files, scheme):
    path = files[scheme]
    full = tcont.read_field(path, device="cpu")
    if scheme != "wavelet":  # wavelet: the bound, and the reference's bits below
        assert np.array_equal(full, rcont.read_field(path))
    with tcont.FieldReader(path, device="cpu", cache_chunks=4) as t, \
            rcont.FieldReader(path, cache_chunks=4) as r:
        assert t.nchunks == r.nchunks == 16
        for lo, hi in _boxes(11):
            assert t.box_blocks(lo, hi) == r.box_blocks(lo, hi)
            assert t.box_chunks(lo, hi) == r.box_chunks(lo, hi)
            got = t.read_box(lo, hi)
            np.testing.assert_array_equal(
                got, full[tuple(slice(a, b) for a, b in zip(lo, hi))], strict=True)
            np.testing.assert_array_equal(got, r.read_box(lo, hi), strict=True)
        assert (t.cache_hits, t.cache_misses) == (r.cache_hits, r.cache_misses)
        for b in [(0, 0, 0), (3, 1, 2)]:
            assert t.block_chunk(*b) == r.block_chunk(*b)
            np.testing.assert_array_equal(t.read_block(*b), r.read_block(*b))
        np.testing.assert_array_equal(t.read_all(), full, strict=True)
    bound = {"wavelet": 100e-3, "zfpx": 16e-3, "raw": 0.0}.get(
        scheme, 1e-3 * (1 + 1e-4) + float(np.spacing(np.float32(np.abs(FIELD).max()))))
    assert np.max(np.abs(full - FIELD)) <= bound


def test_chunks_decoded_counts_and_the_cache():
    path = os.path.join(DATA, "cz2_zfpx.cz")
    with tcont.FieldReader(path, device="cpu", cache_chunks=8) as t:
        lo, hi = (0, 0, 0), (8, 8, 8)
        t.read_box(lo, hi)
        assert t.chunks_decoded == len(t.box_chunks(lo, hi)) == 1
        t.read_box(lo, hi)
        assert t.chunks_decoded == 1 and t.cache_hits >= 1
        t.read_box((0, 0, 0), (16, 16, 16))
        assert t.chunks_decoded == t.nchunks == 2
        assert t.fetch_chunk(1)[1] is False  # an LRU hit decodes nothing
    assert t.closed


def test_close_is_terminal():
    path = os.path.join(DATA, "cz2_lorenzo.cz")
    t = tcont.FieldReader(path, device="cpu", prefetch=2)
    t.read_box((0, 0, 0), (4, 4, 4))
    t.close()
    t.close()  # idempotent
    assert t.closed and len(t._cache) == 0
    for fn in (lambda: t.read_box((0, 0, 0), (4, 4, 4)), lambda: t.fetch_chunk(0),
               lambda: t.read_all()):
        with pytest.raises(ValueError, match="closed"):
            fn()


def test_reader_validates_boxes_and_block_batches(tmp_path):
    path = os.path.join(DATA, "cz1_raw.cz")
    with tcont.FieldReader(path, device="cpu") as t, rcont.FieldReader(path) as r:
        for lo, hi in (((0, 0, 0), (17, 4, 4)), ((4, 0, 0), (4, 4, 4)), ((-1, 0, 0), (4, 4, 4))):
            with pytest.raises(ValueError, match="outside field"):
                t.read_box(lo, hi)
            with pytest.raises(ValueError, match="outside field"):
                r.read_box(lo, hi)
    blocks = FIELD.reshape(-1, BS, BS, BS)[:8]
    tcont.write_compressed(str(tmp_path / "b.cz"), blocks, CompressionSpec(scheme="raw", **KW),
                           device="cpu")
    with pytest.raises(ValueError, match="block batch"):
        tcont.FieldReader(str(tmp_path / "b.cz"), device="cpu")
    np.testing.assert_array_equal(tcont.read_field(str(tmp_path / "b.cz"), device="cpu"),
                                  blocks)


@pytest.mark.parametrize("device", ["host", "jax"])
def test_reader_device_is_a_torch_device(device):
    """The reference's ``device`` re-routes the spec; the port's names the
    torch device, and the reference's words are refused."""
    path = os.path.join(DATA, "cz2_zfpx.cz")
    with pytest.raises((ValueError, RuntimeError)):
        tcont.FieldReader(path, device=device)
    with pytest.raises((ValueError, RuntimeError)):
        tcont.read_field(path, device=device)


def _local_stores(pkg, tmp_path, tag):
    return {"file": pkg.FileStore(str(tmp_path / f"{tag}_fs")), "mem": pkg.MemoryStore(),
            "range": pkg.RangeStore()}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_store_writes_are_the_reference_bytes(files, tmp_path, scheme):
    """``write_compressed(store=)`` through FileStore (streamed), MemoryStore
    and RangeStore (one whole-object put) gives the reference's file, and
    ``read_field(store=)`` and ``describe(store=)`` read it back."""
    want = _bytes(files[scheme])
    full = tcont.read_field(files[scheme], device="cpu")
    spec = CompressionSpec(scheme=scheme, **KW)
    for kind, st in _local_stores(tb, tmp_path, "t").items():
        n = tcont.write_compressed("q/f.cz", FIELD, spec, store=st, device="cpu")
        assert n == len(want) and st.get("q/f.cz") == want, kind
        np.testing.assert_array_equal(tcont.read_field("q/f.cz", device="cpu", store=st), full)
        assert tcont.describe("q/f.cz", verify=True, store=st)["crc_ok"] is True
        assert [c for c, _n in tcont.iter_compressed("q/f.cz", store=st)] == \
            [c for c, _n in rcont.iter_compressed(files[scheme])]
    # the reference reads what the port's store holds, and the other way round
    rst = rb.MemoryStore()
    rst.put("f.cz", want)
    np.testing.assert_array_equal(tcont.read_field("f.cz", device="cpu", store=rst), full)


def test_compressed_field_rewrite_and_fsync(tmp_path):
    """A CompressedField (auto's, with ``chunk_schemes``) writes the bytes the
    reference writes for its own, with ``fsync`` on a file and on a buffered
    store, and reads back as the streamed write does."""
    from repro.core import Pipeline as RPipeline
    from repro_torch.core.pipeline import Pipeline

    spec = CompressionSpec(scheme="auto", **KW)
    comp = Pipeline(spec, device="cpu").compress(FIELD)
    a, b, r = (str(tmp_path / f"{k}.cz") for k in "abr")
    tcont.write_compressed(a, FIELD, spec, device="cpu")
    tcont.write_compressed(b, comp, fsync=True)
    rcont.write_compressed(r, RPipeline(RSpec(scheme="auto", **KW)).compress(FIELD), fsync=True)
    assert _bytes(b) == _bytes(r)
    st = tb.MemoryStore()
    tcont.write_compressed("c.cz", comp, fsync=True, store=st)
    assert st.get("c.cz") == _bytes(r)
    np.testing.assert_array_equal(tcont.read_field(b, device="cpu"),
                                  tcont.read_field(a, device="cpu"), strict=True)
    with pytest.raises(TypeError, match="spec is required"):
        tcont.write_compressed(str(tmp_path / "d.cz"), FIELD)


@pytest.mark.parametrize("server", ["port", "reference"])
def test_reads_over_http_equal_the_file(files, server):
    root = os.path.dirname(files["zfpx"])
    srv_pkg = tb if server == "port" else rb
    with srv_pkg.StaticFileServer(root) as srv, tb.HttpStore(srv.url) as st:
        full = tcont.read_field("zfpx.cz", device="cpu", store=st)
        np.testing.assert_array_equal(full, tcont.read_field(files["zfpx"], device="cpu"))
        with tcont.FieldReader("zfpx.cz", device="cpu", store=st, prefetch=4) as t:
            lo, hi = (3, 9, 1), (29, 31, 30)
            np.testing.assert_array_equal(t.read_box(lo, hi), full[3:29, 9:31, 1:30])
        assert st.stats()["range_requests"] >= 2 + len(t.box_chunks(lo, hi))
        assert tcont.describe("zfpx.cz", verify=True, store=st) == \
            rcont.describe(files["zfpx"], verify=True) | {"path": "zfpx.cz"}


def _series(obs):
    snap = {}
    for name in ("cz_reader_chunk_reads_total", "cz_reader_prefetch_chunks_total"):
        m = obs.REGISTRY.get(name)
        for res in ("hit", "miss", "issued", "used", "evicted", "failed"):
            snap[(name, res)] = m.value(result=res) if m else 0.0
    for name in ("cz_reader_fetched_bytes_total",):
        m = obs.REGISTRY.get(name)
        snap[(name, "")] = m.value() if m else 0.0
    for name in ("cz_reader_fetch_seconds", "cz_reader_decode_seconds"):
        m = obs.REGISTRY.get(name)
        snap[(name, "count")] = m.snapshot()["count"] if m else 0
    return snap


@pytest.mark.parametrize("prefetch", [0, 4])
def test_reader_series_equal_reference(files, prefetch):
    """The same reads through each package's FieldReader add the same
    amounts to the same ``cz_reader_*`` series, each in its own registry."""
    path = files["lorenzo"]
    before = (_series(tobs), _series(robs))
    with tcont.FieldReader(path, device="cpu", cache_chunks=4, prefetch=prefetch) as t:
        for lo, hi in _boxes(5):
            t.read_box(lo, hi)
    with rcont.FieldReader(path, cache_chunks=4, prefetch=prefetch) as r:
        for lo, hi in _boxes(5):
            r.read_box(lo, hi)
    after = (_series(tobs), _series(robs))
    delta = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    assert delta[0] == delta[1]
    assert delta[0][("cz_reader_chunk_reads_total", "miss")] == t.chunks_decoded > 0
    assert delta[0][("cz_reader_fetch_seconds", "count")] == t.chunks_decoded
    assert (delta[0][("cz_reader_prefetch_chunks_total", "issued")] > 0) == (prefetch > 0)


def test_prefetch_same_bits_requests_and_bytes(files):
    """Prefetch may reorder fetches but must not change results, request
    counts or fetched bytes (the reference's rule)."""
    blob = _bytes(files["szx"])
    counts, outs = {}, {}
    for pf in (0, 4):
        st = tb.RangeStore()
        st.put("f.cz", blob)
        before = st.stats()
        with tcont.FieldReader("f.cz", device="cpu", store=st, cache_chunks=4, prefetch=pf) as t:
            outs[pf] = [t.read_box((0, 0, 0), (N, N, N)), t.read_box((3, 4, 5), (19, 20, 21))]
        s = st.stats()
        counts[pf] = (s["get_requests"] - before["get_requests"],
                      s["bytes_fetched"] - before["bytes_fetched"])
    assert counts[4] == counts[0]
    for a, b in zip(outs[0], outs[4]):
        np.testing.assert_array_equal(a, b, strict=True)
    np.testing.assert_array_equal(outs[0][0], tcont.read_field(files["szx"], device="cpu"))


def test_prefetched_bytes_are_used(files):
    used0 = tobs.REGISTRY.get("cz_reader_prefetch_chunks_total")
    issued0 = used0.value(result="issued") if used0 else 0
    used0 = used0.value(result="used") if used0 else 0
    with tcont.FieldReader(files["raw"], device="cpu", prefetch=2) as t:
        t.read_box((0, 0, 0), (N, N, N))
    m = tobs.REGISTRY.get("cz_reader_prefetch_chunks_total")
    issued, used = m.value(result="issued") - issued0, m.value(result="used") - used0
    assert issued >= t.nchunks - 2  # the first chunk is fetched directly
    assert used == issued


def test_evicted_prefetches_are_refetched(files):
    m = tobs.REGISTRY.get("cz_reader_prefetch_chunks_total")
    with tcont.FieldReader(files["zfpx"], device="cpu", prefetch=1) as t:  # buffers 2
        evicted0 = m.value(result="evicted") if m else 0
        t._prefetcher.schedule(range(t.nchunks))  # flood far past the bound
        m = tobs.REGISTRY.get("cz_reader_prefetch_chunks_total")
        assert m.value(result="evicted") - evicted0 >= t.nchunks - t._prefetcher.max_buffered
        np.testing.assert_array_equal(t.read_box((0, 0, 0), (N, N, N)),
                                      tcont.read_field(files["zfpx"], device="cpu"))


def test_failed_prefetch_falls_back_to_a_direct_get(files):
    flaky = tb.FlakyStore(tb.MemoryStore())
    flaky.put("f.cz", _bytes(files["lorenzo"]))
    with tcont.FieldReader("f.cz", device="cpu", store=flaky, prefetch=2) as t:
        flaky.fail_on_get = flaky.gets + 1  # poison the prefetch batch
        t._prefetcher.schedule([0])
        m = tobs.REGISTRY.get("cz_reader_prefetch_chunks_total")
        failed0 = m.value(result="failed")
        np.testing.assert_array_equal(t.read_box((0, 0, 0), (BS, BS, BS)),
                                      tcont.read_field(files["lorenzo"], device="cpu")[:BS, :BS, :BS])
        assert m.value(result="failed") - failed0 == 1
        assert flaky.faults == 1


def test_a_failed_read_raises_and_an_intact_cache_retries(files):
    flaky = tb.FlakyStore(tb.MemoryStore())
    flaky.put("f.cz", _bytes(files["raw"]))
    with tcont.FieldReader("f.cz", device="cpu", store=flaky, cache_chunks=16) as t:
        warm = t.read_box((0, 0, 0), (BS, BS, BS))
        flaky.fail_on_get = flaky.gets + 1
        with pytest.raises(tb.InjectedFault):
            t.read_box((0, 0, 0), (N, N, N))
        np.testing.assert_array_equal(t.read_box((0, 0, 0), (BS, BS, BS)), warm)
        np.testing.assert_array_equal(t.read_box((0, 0, 0), (N, N, N)), FIELD)


@pytest.mark.parametrize("prefetch", [0, 4])
def test_a_failing_decode_raises_out_of_read_box(files, monkeypatch, prefetch):
    """The plain inverse stands in for the kernel on the CPU: make it fail as
    a refused launch would on the card.  ``read_box`` and ``read_field``
    raise; nothing catches it, prefetch or not."""
    def refuse(*a, **k):
        raise RuntimeError("kernel launch refused")

    monkeypatch.setattr(twv, "inverse3d", refuse)
    with tcont.FieldReader(files["wavelet"], device="cpu", prefetch=prefetch) as t:
        with pytest.raises(RuntimeError, match="kernel launch refused"):
            t.read_box((0, 0, 0), (N, N, N))
        assert len(t._cache) == 0
    with pytest.raises(RuntimeError, match="kernel launch refused"):
        tcont.read_field(files["wavelet"], device="cpu")


def test_concurrent_readers_share_one_cache(files):
    """More threads than cores, started on a barrier with a short switch
    interval, read the same box through one reader: each covering chunk is
    decoded once, and every result is the same."""
    nthreads = 2 * (os.cpu_count() or 4) + 1
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with tcont.FieldReader(files["zfpx"], device="cpu", cache_chunks=16, prefetch=2) as t:
            lo, hi = (1, 2, 3), (31, 30, 29)
            want = tcont.read_field(files["zfpx"], device="cpu")[1:31, 2:30, 3:29]
            start = threading.Barrier(nthreads)
            outs, errs = [], []

            def query():
                try:
                    start.wait(30)
                    outs.append(t.read_box(lo, hi))
                except Exception as e:  # surfaced after the join
                    errs.append(e)

            threads = [threading.Thread(target=query) for _ in range(nthreads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads) and not errs
            assert len(outs) == nthreads and all(np.array_equal(o, want) for o in outs)
            assert t.chunks_decoded == len(t.box_chunks(lo, hi))
    finally:
        sys.setswitchinterval(interval)
