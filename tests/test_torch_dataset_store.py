"""The port's ``CZDataset`` and ``ShardWriter`` behaviours on the CPU, held to
the reference where the two can run the same operations: what
``tests/test_store.py`` and the dataset half of
``tests/test_store_backends.py`` check of the JAX package.

* Append, reopen and continue, ``refresh``; bad input raises the
  reference's exceptions with its messages.
* Pooled (``workers=4``) and serial members are byte-identical for every
  scheme; a ``ShardWriter`` member is a plain CZ2 container.
* Concurrent readers, hit/miss counters equal to the reference's, eviction
  pressure, and an evicted reader that still serves.
* Dtype tags, and the coercion warnings with the reference's messages.
* Tensor fields write their numpy twins' trees byte for byte, tags and
  warnings included, count no copy on the CPU and are never written to.
* Conformance over ``file``, ``mem://`` and ``range://`` stores, and a torn
  append through a ``FlakyStore``.
* The torch device: checked at once (``"cuda"`` without a GPU raises, in
  both modes), and passed to the writer, every reader and the stats decode.
"""
import concurrent.futures
import os
import shutil
import sys
import warnings

import numpy as np
import pytest
import torch

from repro import store as rstore
from repro.core import CompressionSpec as RSpec

from repro_torch import obs
from repro_torch.core import container as tcont
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.store import (CZDataset, DtypeCoercionWarning, FileStore, FlakyStore,
                               InjectedFault, ManifestError, MemoryStore, RangeStore,
                               ShardWriter)

from test_torch_dataset import APPENDS, FIELDS, KW, N, BS, SCHEMES, tree, write_port, write_ref

torch.set_num_threads(1)

# raw, 1 block of 8^3 per chunk: 8 chunks per member, bit-exact reads
RAW = CompressionSpec(scheme="raw", block_size=BS, buffer_bytes=BS ** 3 * 4)
RAW_REF = RSpec(scheme="raw", block_size=BS, buffer_bytes=BS ** 3 * 4)


def _stepped(k):
    return {q: f + np.float32(k) for q, f in FIELDS.items()}


def _fill(root_or_store, steps=3, workers=1, spec=RAW):
    with CZDataset(root_or_store, "a", spec=spec, workers=workers, device="cpu") as ds:
        for k in range(steps):
            assert ds.append(_stepped(k), time=9.4 + k) == k


def test_append_reopen_region_read_bit_exact(tmp_path):
    root = str(tmp_path / "ds")
    _fill(root, workers=2)
    ds = CZDataset(root, device="cpu")
    assert ds.quantities == ["p", "rho"] and ds.version == 3
    assert ds.timesteps("p") == [0, 1, 2] and ds.shape("rho") == (N, N, N)
    lo, hi = (3, 5, 9), (13, 15, 16)  # block-unaligned
    ref = FIELDS["rho"] + np.float32(2)
    np.testing.assert_array_equal(ds.read_box("rho", 2, lo, hi),
                                  ref[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]], strict=True)
    r = ds.reader("rho", 2)
    assert 0 < r.chunks_decoded < r.nchunks
    before = r.chunks_decoded
    np.testing.assert_array_equal(ds.read_field("rho", 2), ref, strict=True)
    assert r.chunks_decoded > before
    assert ds.stats()["chunks_decoded"] == r.chunks_decoded
    with pytest.raises(IOError, match="read-only"):
        ds.append(_stepped(9))
    ds.close()


def test_append_mode_reopens_and_continues(tmp_path):
    root = str(tmp_path / "ds")
    _fill(root, steps=1)
    with CZDataset(root, "a", device="cpu") as ds:  # the committed spec wins
        assert ds.spec == RAW
        assert ds.append(_stepped(1)) == 1
    with CZDataset(root, device="cpu") as rd:
        with CZDataset(root, "a", device="cpu") as wr:
            wr.append(_stepped(2))
        assert rd.timesteps("p") == [0, 1]
        rd.refresh()
        assert rd.timesteps("p") == [0, 1, 2]
    with rstore.CZDataset(root, "a") as ds:  # the reference continues it too
        assert ds.append(_stepped(3)) == 3
    with CZDataset(root, "a", device="cpu") as ds:
        assert ds.append(_stepped(4)) == 4 and ds.version == 5


def _bad_input_outcomes(pkg, root) -> list:
    kw = {"device": "cpu"} if pkg is not rstore else {}
    spec = RAW if pkg is not rstore else RAW_REF
    out = []

    def outcome(fn):
        try:
            fn()
            out.append("ok")
        except (OSError, ValueError, KeyError) as e:
            out.append((type(e).__name__, str(e)))

    outcome(lambda: pkg.CZDataset(root, "w", **kw))
    with pkg.CZDataset(root, "a", spec=spec, **kw) as ds:
        ds.append(_stepped(0))
        outcome(lambda: ds.append({"p": np.zeros((BS, BS, BS), np.float32)}))
        outcome(lambda: ds.append({"../evil": FIELDS["p"]}))
        outcome(lambda: ds.append({"..": FIELDS["p"]}))
        outcome(lambda: ds.append({}))
        outcome(lambda: ds.append({"p": FIELDS["p"].astype(np.float64)}))
        outcome(lambda: ds.append({"flat": np.zeros((4, 4), np.float32)}))
        outcome(lambda: ds.read_box("p", 7, (0, 0, 0), (4, 4, 4)))
        outcome(lambda: ds.read_box("p", 0, (0, 0, 0), (N + 1, 4, 4)))
        outcome(lambda: ds.read_field("vorticity", 0))
        outcome(lambda: ds.timestep_info("p", 3))
    with pkg.CZDataset(root, **kw) as ds:
        outcome(lambda: ds.append(_stepped(1)))
        outcome(lambda: ds.gc(dry_run=True))
    return out


def test_append_rejects_bad_input_as_the_reference(tmp_path):
    got = _bad_input_outcomes(sys.modules["repro_torch.store"], str(tmp_path / "t"))
    want = _bad_input_outcomes(rstore, str(tmp_path / "r"))
    assert got == want
    assert sum(o != "ok" for o in got) == 12
    assert tree(tmp_path / "t") == tree(tmp_path / "r")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_pooled_and_serial_members_byte_identical(tmp_path, scheme):
    """``workers=4`` (one shared pool for every member's chunks; under auto
    its threads run the trials) writes the serial tree's bytes."""
    write_port(tmp_path / "w1", scheme, stats=True)
    write_port(tmp_path / "w4", scheme, stats=True, workers=4)
    assert tree(tmp_path / "w4") == tree(tmp_path / "w1")


def _as_tensors(appends):
    return [({q: torch.from_numpy(f.copy()) for q, f in fields.items()}, time)
            for fields, time in appends]


# a cube of 2x2x2 blocks, and a column of 4 blocks whose blocked batch is a
# view of the field itself (blockify copies nothing): stage 1 reads the
# caller's memory there and must not write it
SHAPES = {"cube": (N, N, N), "column": (4 * BS, BS, BS)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_tensor_appends_write_the_numpy_trees(tmp_path, scheme, shape):
    """Tensor fields on the dataset's device write their numpy twins' tree
    (members and manifest, ``stats=True``'s records included) byte for
    byte, count no copy on the CPU and are left as they were."""
    size = SHAPES[shape]
    appends = [({q: f.reshape(-1)[:np.prod(size)].reshape(size) for q, f in fields.items()},
                time) for fields, time in APPENDS]
    tensors = _as_tensors(appends)
    kept = [{q: f.clone() for q, f in fields.items()} for fields, _ in tensors]
    copies = obs.REGISTRY.get("cz_copy_bytes_total")
    write_port(tmp_path / "numpy", scheme, stats=True, workers=2, appends=appends)
    before = copies.samples()
    write_port(tmp_path / "tensor", scheme, stats=True, workers=2, appends=tensors)
    assert copies.samples() == before
    assert tree(tmp_path / "tensor") == tree(tmp_path / "numpy")
    for (fields, _), old in zip(tensors, kept):
        assert all(torch.equal(fields[q], old[q]) for q in fields)


def test_shard_writer_member_is_plain_cz2(tmp_path):
    path = str(tmp_path / "m.cz")
    with ShardWriter(RAW, workers=2, device="cpu") as w:
        assert w.write(path, FIELDS["p"], extra_header={"quantity": "p"}) == \
            os.path.getsize(path)
        with pytest.raises(ValueError, match="3D field"):
            w.write(path, FIELDS["p"][0])
    np.testing.assert_array_equal(tcont.read_field(path, device="cpu"), FIELDS["p"])
    with tcont.FieldReader(path, device="cpu") as r:
        assert r.header["quantity"] == "p"
    with rstore.ShardWriter(RAW_REF, workers=2) as w:
        w.write(str(tmp_path / "r.cz"), FIELDS["p"], extra_header={"quantity": "p"})
    assert (tmp_path / "m.cz").read_bytes() == (tmp_path / "r.cz").read_bytes()


def _concurrent(fn, jobs, workers=8):
    """``fn`` over ``jobs`` on more threads than cores, with a short switch
    interval, each result awaited with a timeout."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            futs = [pool.submit(fn, j) for j in jobs]
            return [f.result(timeout=60) for f in futs]
    finally:
        sys.setswitchinterval(old)


def test_concurrent_readers_share_one_dataset(tmp_path):
    root = str(tmp_path / "ds")
    _fill(root, workers=2)
    rng = np.random.default_rng(0)
    jobs = [(q, t, tuple(int(v) for v in lo))
            for q in FIELDS for t in range(3) for lo in rng.integers(0, N - BS, (4, 3))]

    with CZDataset(root, cache_chunks=4, device="cpu") as ds:
        def probe(job):
            q, t, lo = job
            hi = tuple(v + BS for v in lo)
            want = (FIELDS[q] + np.float32(t))[tuple(slice(a, b) for a, b in zip(lo, hi))]
            return np.array_equal(ds.read_box(q, t, lo, hi), want)

        assert all(_concurrent(probe, jobs))
        assert ds.stats()["chunks_decoded"] > 0


def test_concurrent_read_box_under_eviction_pressure(tmp_path):
    """Threads on overlapping unaligned boxes with ``cache_chunks=1`` get the
    serial reads' bytes."""
    root = str(tmp_path / "ds")
    _fill(root, steps=2, workers=2)
    rng = np.random.default_rng(3)
    jobs = [(q, t, tuple(int(v) for v in lo), tuple(int(v) + BS + 1 for v in lo))
            for q in FIELDS for t in range(2) for lo in rng.integers(2, N // 2 - 2, (6, 3))]
    refs = {j: (FIELDS[j[0]] + np.float32(j[1]))[
        tuple(slice(a, b) for a, b in zip(j[2], j[3]))].tobytes() for j in jobs}
    with CZDataset(root, cache_chunks=1, device="cpu") as ds:
        assert all(_concurrent(lambda j: ds.read_box(*j).tobytes() == refs[j], jobs * 4))
        s = ds.stats()
        assert s["cache_misses"] >= s["open_readers"] == 4


def test_stats_counters_equal_the_reference(tmp_path):
    """The same reads through both packages' datasets on one root: the same
    ``stats()`` after each step, through reader eviction and ``close``."""
    root = str(tmp_path / "ds")
    _fill(root)
    boxes = [("p", 0, (0, 0, 0), (BS, BS, BS)), ("p", 0, (0, 0, 0), (BS, BS, BS)),
             ("rho", 1, (1, 2, 3), (15, 9, 10)), ("p", 2, (0, 0, 0), (N, N, N)),
             ("p", 0, (4, 4, 4), (12, 12, 12))]
    seen = []
    for ds in (CZDataset(root, cache_readers=2, cache_chunks=3, device="cpu"),
               rstore.CZDataset(root, cache_readers=2, cache_chunks=3)):
        run = [ds.stats()]
        for q, t, lo, hi in boxes:
            ds.read_box(q, t, lo, hi)
            run.append(ds.stats())
        ds.close()
        run.append(ds.stats())
        seen.append(run)
    assert seen[0] == seen[1]
    assert seen[0][0]["cache_hit_rate"] is None and seen[0][-1]["open_readers"] == 0
    assert seen[0][2]["cache_hits"] == 1 and seen[0][2]["cache_hit_rate"] == 0.5


def test_evicted_reader_still_serves(tmp_path):
    root = str(tmp_path / "ds")
    _fill(root)
    ds = CZDataset(root, cache_readers=1, device="cpu")
    held = ds.reader("p", 0)
    ds.reader("p", 1)  # evicts `held` from the dataset's LRU
    assert not held.closed
    np.testing.assert_array_equal(held.read_box((0, 0, 0), (BS, BS, BS)),
                                  FIELDS["p"][:BS, :BS, :BS])
    assert held.chunks_decoded == 1
    ds.close()  # closes the live reader, not the evicted one
    assert not held.closed
    held.close()
    held.close()  # idempotent
    with pytest.raises(ValueError, match="closed"):
        held.read_box((0, 0, 0), (BS, BS, BS))


def test_manifest_corruption_raises_clear_error(tmp_path):
    root = str(tmp_path / "ds")
    _fill(root, steps=1)
    mpath = os.path.join(root, "manifest.json")
    with open(mpath, "w") as f:
        f.write('{"truncated": ')
    with pytest.raises(ManifestError, match="corrupt manifest"):
        CZDataset(root, device="cpu")
    with pytest.raises(ManifestError):
        CZDataset(root, "a", device="cpu")  # never overwritten
    with open(mpath) as f:
        assert f.read() == '{"truncated": '
    os.remove(mpath)
    with pytest.raises(ManifestError, match="not a CZDataset"):
        CZDataset(root, device="cpu")


# (field dtype, spec scheme) -> whether the append warns
DTYPE_CASES = {"float64-raw": ("float64", "raw", False),
               "float16-raw": ("float16", "raw", False),
               "float64-fpzipx": ("float64", "fpzipx", True),
               "int32-raw": ("int32", "raw", True)}


@pytest.mark.parametrize(
    "case", list(DTYPE_CASES) + [f"{c}-tensor" for c in DTYPE_CASES])
def test_dtype_tags_and_coercion_as_the_reference(tmp_path, case):
    """Each member is tagged with its field's dtype where the scheme takes
    it; otherwise the field is cast to the spec's dtype with a
    ``DtypeCoercionWarning`` carrying the reference's message.  The trees
    are the reference's bytes, also where the port is given the field as a
    tensor (``-tensor``): its dtype is then read from the tensor."""
    as_tensor = case.endswith("-tensor")
    dtype, scheme, warns = DTYPE_CASES[case.removesuffix("-tensor")]
    f = {"p": (FIELDS["p"] * (100 if dtype == "int32" else 1)).astype(dtype)}
    msgs = []
    for pkg, sub in ((sys.modules["repro_torch.store"], "t"), (rstore, "r")):
        spec = (CompressionSpec if sub == "t" else RSpec)(scheme=scheme, **KW)
        kw = {"device": "cpu"} if sub == "t" else {}
        given = ({"p": torch.from_numpy(f["p"])} if as_tensor and sub == "t" else f)
        with pkg.CZDataset(str(tmp_path / sub), "a", spec=spec, **kw) as ds:
            if warns:
                with pytest.warns(pkg.DtypeCoercionWarning) as rec:
                    ds.append(given)
                msgs.append([str(w.message) for w in rec])
            else:
                with warnings.catch_warnings():
                    warnings.simplefilter("error")
                    ds.append(given)
    if warns:
        assert msgs[0] == msgs[1] and len(msgs[0]) == 1
    assert tree(tmp_path / "t") == tree(tmp_path / "r")
    tagged = "float32" if warns else dtype
    with CZDataset(str(tmp_path / "t"), device="cpu") as ds:
        assert ds.dtype("p") == np.dtype(tagged)
        out = ds.read_field("p", 0)
        assert out.dtype == np.dtype(tagged)
        if scheme == "raw" or dtype != "float64":
            np.testing.assert_array_equal(out, f["p"].astype(tagged))
        else:  # fpzipx is lossless at precision 32 on the float32 cast
            np.testing.assert_array_equal(out, f["p"].astype(np.float32))


def test_unknown_spec_device_is_not_coercible():
    import dataclasses

    w = ShardWriter(RAW, device="cpu")
    w.spec = dataclasses.replace(RAW, device="tpu")  # as from a hand-edited manifest
    with pytest.raises(ValueError, match="unknown device 'tpu'"):
        w.spec_for(FIELDS["p"])
    w.close()


# -- conformance over the port's stores ---------------------------------------

BACKENDS = ["file", "mem", "range"]


def _make_store(kind, tmp_path):
    if kind == "file":
        return FileStore(str(tmp_path / "ds"))
    return MemoryStore() if kind == "mem" else RangeStore()


@pytest.mark.parametrize("kind", BACKENDS)
def test_dataset_roundtrip_every_backend(tmp_path, kind):
    st = _make_store(kind, tmp_path)
    _fill(st, steps=2)
    with CZDataset(st, device="cpu") as ds:
        assert ds.quantities == ["p", "rho"]
        for q, f in FIELDS.items():
            np.testing.assert_array_equal(ds.read_field(q, 0), f)
            np.testing.assert_array_equal(ds.read_box(q, 1, (3, 4, 5), (11, 12, 13)),
                                          (f + np.float32(1))[3:11, 4:12, 5:13])


def test_members_byte_identical_across_backends_and_the_reference(tmp_path):
    stores = [_make_store(kind, tmp_path) for kind in BACKENDS]
    for st in stores:
        with CZDataset(st, "a", spec=CompressionSpec(scheme="lorenzo", **KW),
                       device="cpu") as ds:
            for fields, time in APPENDS:
                ds.append(fields, time=time)
    write_ref(tmp_path / "ref", "lorenzo")
    want = tree(tmp_path / "ref")
    for st in stores:
        assert {k: st.get(k) for k in st.list("")} == want, st.url


def test_mem_url_shares_one_registry_instance():
    with CZDataset("mem://torch_conformance", "a", spec=RAW, device="cpu") as w:
        w.append(FIELDS)
        with CZDataset("mem://torch_conformance", device="cpu") as r:
            np.testing.assert_array_equal(r.read_field("rho", 0), FIELDS["rho"])
        t = w.append(FIELDS)
        with CZDataset("mem://torch_conformance", device="cpu") as r:
            assert r.timesteps("p") == [0, t]
    MemoryStore.drop("torch_conformance")


def test_gc_identical_across_backends(tmp_path):
    """The reference's gc case on each of the port's stores, and on a
    directory through both packages: the same orphans, deleted alike."""
    want = ["manifest.json.tmp", "p/t000099.cz", "rho/t000000.cz.rank0.part"]
    stores = [_make_store(kind, tmp_path / kind) for kind in BACKENDS]
    for st in stores:
        _fill(st, steps=2)
        st.put("p/t000099.cz", b"orphan")
        st.put("rho/t000000.cz.rank0.part", b"part")
        st.put("manifest.json.tmp", b"{}")
        with CZDataset(st, device="cpu") as ds:
            assert ds.gc(dry_run=True) == want
        with CZDataset(st, "a", device="cpu") as ds:
            assert ds.gc() == want
            assert ds.gc(dry_run=True) == []
        assert not any(st.exists(k) for k in want)
    shutil.copytree(tmp_path / "file" / "ds", tmp_path / "after")
    with rstore.CZDataset(str(tmp_path / "after")) as ds:
        assert ds.gc(dry_run=True) == []


def test_rangestore_reads_are_byte_ranged():
    """A one-chunk box over the range store fetches byte ranges, not the
    member: the footer and one chunk."""
    st = RangeStore()
    _fill(st, steps=1)
    stored = st.stats()["bytes_stored"]
    before = st.stats()
    with CZDataset(st, cache_chunks=2, device="cpu") as ds:
        box = ds.read_box("p", 0, (0, 0, 0), (BS, BS, BS))
    np.testing.assert_array_equal(box, FIELDS["p"][:BS, :BS, :BS])
    after = st.stats()
    assert after["range_requests"] - before["range_requests"] >= 2
    assert 0 < after["bytes_fetched"] - before["bytes_fetched"] < stored / 4


@pytest.mark.parametrize("arm", ["member", "manifest"])
def test_torn_append_leaves_the_last_committed_state(arm):
    """A fault in a member write or in the manifest commit leaves the
    dataset at its previous commit, with at most orphans gc collects."""
    flaky = FlakyStore(MemoryStore())
    _fill(flaky, steps=2)
    with CZDataset(flaky, "a", device="cpu") as ds:
        if arm == "member":
            flaky.fail_on_put = flaky.puts + 1
        else:
            flaky.fail_on_op = {"put_atomic": flaky.op_calls.get("put_atomic", 0) + 1}
        with pytest.raises(InjectedFault):
            ds.append(_stepped(9))
        flaky.fail_on_put = None
        flaky.fail_on_op = {}
    with CZDataset(flaky, device="cpu") as ds:
        assert ds.timesteps("p") == [0, 1] and ds.version == 2
        np.testing.assert_array_equal(ds.read_field("p", 1), FIELDS["p"] + np.float32(1))
        orphans = ds.gc(dry_run=True)
    assert orphans == ([] if arm == "member" else ["p/t000002.cz", "rho/t000002.cz"])
    with CZDataset(flaky, "a", device="cpu") as ds:
        assert ds.gc() == orphans and ds.gc(dry_run=True) == []
        assert ds.append(_stepped(2)) == 2


def test_close_closes_readers_writer_and_store(tmp_path):
    class ClosingStore(MemoryStore):
        closed = 0

        def close(self):
            self.closed += 1

    st = ClosingStore()
    ds = CZDataset(st, "a", spec=RAW, workers=2, device="cpu")
    ds.append(FIELDS)
    r = ds.reader("p", 0)
    ds.close()
    assert r.closed and st.closed == 1 and ds._writer._pool is None


# -- the torch device ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["r", "a"])
def test_cuda_without_a_gpu_raises_at_once(tmp_path, monkeypatch, mode):
    root = str(tmp_path / "ds")
    _fill(root, steps=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CZDataset(root, mode, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        CZDataset(root, mode)  # the card is the default
    with pytest.raises(RuntimeError, match="cuda"):
        ShardWriter(RAW)
    with pytest.raises(RuntimeError, match="cuda"):
        CZDataset(str(tmp_path / "new"), "a", spec=RAW)
    assert not os.path.exists(tmp_path / "new")  # raised before any write


def test_device_reaches_writer_readers_and_stats_decode(tmp_path, monkeypatch):
    devices = []
    for fn in ("read_field", "write_compressed"):
        real = getattr(tcont, fn)

        def spy(*a, _real=real, **kw):
            devices.append(kw["device"])
            return _real(*a, **kw)

        monkeypatch.setattr(tcont, fn, spy)
    with CZDataset(str(tmp_path / "ds"), "a", spec=RAW, stats=True,
                   device=torch.device("cpu")) as ds:
        ds.append(FIELDS)
        assert ds.reader("p", 0)._pipe.device == torch.device("cpu")
        assert ds._writer.device == torch.device("cpu")
    assert devices == [torch.device("cpu")] * 4  # 2 writes, 2 stats decodes
