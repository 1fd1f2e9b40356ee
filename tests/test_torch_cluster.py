"""The port's cluster tier (``repro_torch.cluster``: ``decompose``,
``ParallelCompressor``, ``RankWriter`` and ``merge_manifests``) against the
JAX package's (``repro.cluster``), on the CPU.

* Rank invariance: for every registered scheme, and for ``auto`` mixing
  schemes across chunks, the shared file at ranks 1, 2 and 4 is the bytes
  of the port's serial writer, which are the reference's serial writer's
  bytes for the same numpy field.
* The engine's other cases as the reference tests them (more ranks than
  chunks, ``extra_header`` and ``plan``, bad rank counts, a failing rank
  that leaves no debris, the spawn default), the device checks (``"cuda"``
  without a GPU raises before any process starts; ``"fork"`` with CUDA
  raises), the spans staged apart from the output, a traced compress that
  absorbs one track per rank, and the ranks' launch counts.
* ``decompose``, ``dims_for``, ``chunk_spans``, ``scatter`` and ``gather``
  give the reference's results and raise its messages.
* ``RankWriter`` and ``merge_manifests`` on the reference's cases, and
  across packages: sidecars and merged manifests are the reference's
  bytes, and each package's merge folds the other's sidecars.
"""
import collections
import dataclasses
import importlib
import json
import multiprocessing
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.cluster import ParallelCompressor as RParallelCompressor
from repro.cluster import RankWriter as RRankWriter
from repro.cluster import merge_manifests as rmerge
from repro.core import SCHEMES as RSCHEMES
from repro.core import CompressionSpec as RSpec
from repro.core import container as rcont
from repro.store import CZDataset as RCZDataset

from repro_torch.cluster import (
    ParallelCompressor,
    RankWriter,
    Subdomain,
    chunk_spans,
    decompose,
    dims_for,
    gather,
    merge_manifests,
    scatter,
)
from repro_torch.cluster import engine as tengine
from repro_torch.cluster import multiwriter as mw
from repro_torch.core import container
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.obs import trace
from repro_torch.store import CZDataset as _CZDataset
from repro_torch.store import ManifestError

from test_pipeline_api import smooth_field

rdec = importlib.import_module("repro.cluster.decompose")  # the package's name is the function

torch.set_num_threads(1)

BS = 16
FIELD = smooth_field(32, seed=3)
SPEC = CompressionSpec(scheme="raw", block_size=BS, buffer_bytes=1 << 14)


def CZDataset(root, mode="r", **kw):
    """The port's dataset on the CPU."""
    return _CZDataset(root, mode, device="cpu", **kw)


def _spec(scheme: str, cls=CompressionSpec, **kw):
    # 16 KiB buffers -> 1 block per chunk at 16^3 float32: 8 chunks, so
    # every rank count below gets a non-trivial span
    return cls(scheme=scheme, eps=1e-3, block_size=BS, buffer_bytes=1 << 14, **kw)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def engine():
    """One shared 4-rank pool on the CPU for the whole module: each rank's
    interpreter and torch import are paid once."""
    with ParallelCompressor(4, device="cpu") as pc:
        yield pc


# -- rank invariance ---------------------------------------------------------

@pytest.mark.parametrize("scheme", sorted(RSCHEMES))
def test_rank_invariance_byte_identical(engine, scheme, tmp_path):
    ref = tmp_path / "ref.cz"
    rcont.write_field(str(ref), FIELD, _spec(scheme, RSpec))
    serial = tmp_path / "serial.cz"
    n_serial = container.write_field(str(serial), FIELD, _spec(scheme), device="cpu")
    assert _bytes(serial) == _bytes(ref), f"{scheme}: serial writer != reference"
    for ranks in (1, 2, 4):
        path = tmp_path / f"r{ranks}.cz"
        assert engine.compress(str(path), FIELD, _spec(scheme), ranks=ranks) == n_serial
        assert _bytes(path) == _bytes(ref), \
            f"{scheme} ranks={ranks} differs from the serial writer"
    dec = container.read_field(str(tmp_path / "r4.cz"), device="cpu")
    assert dec.shape == FIELD.shape


def test_rank_invariance_auto_mixed_schemes(engine, tmp_path):
    """``auto``'s per-chunk choices mix schemes and stay a function of the
    chunk's content, never of the rank: every rank count writes the
    reference's serial bytes."""
    rng = np.random.default_rng(7)
    field = np.asarray(FIELD, np.float32).copy()
    field[:16, :16, :16] = 0.125
    field[16:, 16:, 16:] = rng.normal(0, 0.4, (16, 16, 16)).astype(np.float32)
    extra = {"target": "rel=1e-4"}
    ref = tmp_path / "ref.cz"
    rcont.write_field(str(ref), field, _spec("auto", RSpec, extra=extra))
    spec = _spec("auto", extra=extra)
    n_serial = container.write_field(str(tmp_path / "serial.cz"), field, spec, device="cpu")
    assert _bytes(tmp_path / "serial.cz") == _bytes(ref)
    for ranks in (1, 2, 4):
        path = tmp_path / f"r{ranks}.cz"
        assert engine.compress(str(path), field, spec, ranks=ranks) == n_serial
        assert _bytes(path) == _bytes(ref), f"auto ranks={ranks} differs from serial"
    d = container.describe(str(tmp_path / "r4.cz"))
    assert len(d["schemes"]) >= 2, f"expected a scheme mix, got {d['schemes']}"
    assert sum(d["schemes"].values()) == len(d["chunks"])
    dec = container.read_field(str(tmp_path / "r4.cz"), device="cpu")
    rngv = float(field.max() - field.min())
    assert np.max(np.abs(field - dec)) <= 1e-4 * rngv * (1 + 1e-6)


def test_engine_takes_a_tensor_field(engine, tmp_path):
    """A field already on the compressor's device (a tensor) is written as
    its numpy copy is."""
    path = tmp_path / "t.cz"
    engine.compress(str(path), torch.from_numpy(FIELD.copy()), _spec("wavelet"), ranks=4)
    rcont.write_field(str(tmp_path / "ref.cz"), FIELD, _spec("wavelet", RSpec))
    assert _bytes(path) == _bytes(tmp_path / "ref.cz")


# -- the engine's other cases ------------------------------------------------

def test_engine_more_ranks_than_chunks(engine, tmp_path):
    """Ranks beyond the chunk count contribute zero bytes, not corruption."""
    spec = CompressionSpec(scheme="raw", block_size=BS, buffer_bytes=1 << 22)
    container.write_field(str(tmp_path / "s.cz"), FIELD, spec, device="cpu")
    engine.compress(str(tmp_path / "p.cz"), FIELD, spec, ranks=4)
    assert _bytes(tmp_path / "s.cz") == _bytes(tmp_path / "p.cz")
    # 3 chunks over 4 ranks: the last rank's span is empty
    spec = CompressionSpec(scheme="lorenzo", block_size=BS, buffer_bytes=3 << 14)
    rcont.write_field(str(tmp_path / "ref.cz"), FIELD,
                      RSpec(scheme="lorenzo", block_size=BS, buffer_bytes=3 << 14))
    engine.compress(str(tmp_path / "p3.cz"), FIELD, spec, ranks=4)
    assert _bytes(tmp_path / "p3.cz") == _bytes(tmp_path / "ref.cz")


def test_engine_extra_header_and_plan(engine, tmp_path):
    spec = _spec("raw")
    path = str(tmp_path / "h.cz")
    engine.compress(path, FIELD, spec, extra_header={"quantity": "p"}, ranks=2, fsync=True)
    with container.FieldReader(path, device="cpu") as r:
        assert r.header["quantity"] == "p"
    rcont.write_compressed(str(tmp_path / "ref.cz"), FIELD, _spec("raw", RSpec),
                           extra_header={"quantity": "p"})
    assert _bytes(path) == _bytes(tmp_path / "ref.cz")
    plan = engine.plan(FIELD.shape, spec, ranks=4)
    assert [p["rank"] for p in plan] == [0, 1, 2, 3]
    assert sum(p["nblocks"] for p in plan) == 8  # 32^3 / 16^3
    assert plan[0]["blocks"][0] == 0
    rpc = RParallelCompressor(4)  # no pool: plan starts none
    for shape, buf, ranks in [((32, 32, 32), 1 << 14, 4), ((64, 32, 48), 3 << 14, 3),
                              ((32, 32, 32), 1 << 22, 2), ((16, 16, 16), 1 << 14, 1)]:
        assert engine.plan(shape, CompressionSpec(block_size=BS, buffer_bytes=buf), ranks) == \
            rpc.plan(shape, RSpec(block_size=BS, buffer_bytes=buf), ranks)


def test_engine_rejects_bad_ranks(engine):
    with pytest.raises(ValueError, match="ranks"):
        engine.compress("/tmp/x.cz", FIELD, SPEC, ranks=8)
    with pytest.raises(ValueError, match="ranks"):
        engine.compress("/tmp/x.cz", FIELD, SPEC, ranks=0)
    with pytest.raises(ValueError, match="ranks"):
        ParallelCompressor(0, device="cpu")
    assert repr(engine) == "ParallelCompressor(ranks=4, start='spawn', pool=live)"


@pytest.fixture
def staging(tmp_path, monkeypatch):
    """The system's temporary directory, where the engine stages the spans,
    pointed at a directory of the test's own."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    return tmp


def test_engine_worker_failure_leaves_no_debris(engine, tmp_path, staging):
    """A rank hitting an encode error (szx refuses this eps for FIELD's
    magnitude inside stage 1, in the ranks, after the parent validated the
    spec) propagates and leaks no part file, span file, trace file or stub."""
    bad = CompressionSpec(scheme="szx", eps=1e-12, block_size=BS, buffer_bytes=1 << 14)
    out = tmp_path / "out"
    out.mkdir()
    path = str(out / "fail.cz")
    with pytest.raises(ValueError, match="too small"):
        engine.compress(path, FIELD, bad, ranks=2)
    assert os.listdir(out) == [] and os.listdir(staging) == []
    trace.reset()
    trace.enable()
    try:
        with pytest.raises(ValueError, match="too small"):
            engine.compress(path, FIELD, bad, ranks=4)
    finally:
        trace.disable()
        trace.reset()
    assert os.listdir(out) == [] and os.listdir(staging) == []


def test_spans_are_staged_apart_from_the_output(engine, tmp_path, staging, monkeypatch):
    """The ranks' spans go through a private directory under the system's
    temporary directory, never beside the output file, and it is gone after
    the compress."""
    seen = []
    real_save = np.save

    def save(file, arr, *a, **k):
        seen.append(os.path.dirname(file))
        return real_save(file, arr, *a, **k)

    monkeypatch.setattr(tengine.np, "save", save)
    out = tmp_path / "out"
    out.mkdir()
    engine.compress(str(out / "s.cz"), FIELD, _spec("raw"), ranks=4)
    assert len(seen) == 4 and len(set(seen)) == 1
    assert os.path.dirname(seen[0]) == str(staging)
    assert os.listdir(out) == ["s.cz"] and os.listdir(staging) == []


def test_traced_compress_absorbs_one_track_per_rank(engine, tmp_path):
    trace.reset()
    trace.enable()
    try:
        engine.compress(str(tmp_path / "t.cz"), FIELD, _spec("wavelet"), ranks=2)
        doc = trace.TRACER.chrome()
    finally:
        trace.disable()
        trace.reset()
    assert sorted(os.listdir(tmp_path)) == ["t.cz"]  # rank traces absorbed, removed
    evs = doc["traceEvents"]
    names = {(e["pid"], e["args"]["name"]) for e in evs if e["name"] == "process_name"}
    assert {(0, "rank 0"), (1, "rank 1")} <= names
    for r in (0, 1):
        mine = [e for e in evs if e["pid"] == r and e["ph"] == "X"]
        enc = [e for e in mine if e["name"] == "encode" and e["args"].get("rank") == r]
        assert len(enc) == 1 and enc[0]["args"]["nblocks"] == 4
        assert set(enc[0]["args"]["stage_s"]) == {"stage1", "serialize", "stage2_encode"}
        # on the CPU the wrapper runs its plain version: no launch to count
        assert enc[0]["args"]["launches"] == {} == enc[0]["args"]["launches_by_side"]
        assert [e["args"]["rank"] for e in mine if e["name"] == "commit"] == [r]
        assert [e["args"]["rank"] for e in mine if e["name"] == "span_read"] == [r]
        # stage 1's forward transform, then its selection of the kept details
        kernels = [e for e in mine if e["name"].startswith("kernel.")]
        assert [(e["args"]["kernel"], e["args"]["device"]) for e in kernels] == \
            [("wavelet_forward", "cpu"), ("wavelet_pack", "cpu")]
    parent = {e["name"] for e in evs if e["pid"] not in (0, 1) and e["ph"] == "X"}
    assert {"host_copy", "span_write", "encode", "exscan", "commit"} <= parent


def test_rank_launch_counts_are_the_launch_sites_deltas(monkeypatch):
    """What a rank's ``encode`` span reports as its launches is the change
    of its own process's launch-site counts (``launched`` and the
    wrappers' per-side counters) across the encode, and nothing else."""
    from repro_torch.kernels import _obs, lorenzo, wavelet3d

    monkeypatch.setattr(wavelet3d, "LAUNCHES_BY_SIDE", collections.Counter())
    monkeypatch.setattr(lorenzo, "LAUNCHES_BY_SIDE", collections.Counter())
    calls = _obs._CALLS
    saved = {k: v for k, v in calls._series.items()}
    try:
        _obs.launched("zfpx_encode")
        calls0, sides0 = tengine._launch_counts()
        _obs.launched("wavelet_forward")
        wavelet3d.LAUNCHES_BY_SIDE["wavelet3d_forward", 32] += 1
        _obs.launched("lorenzo_encode")
        _obs.launched("lorenzo_encode")
        lorenzo.LAUNCHES_BY_SIDE["lorenzo_encode", 16] += 2
        calls.inc(kernel="wavelet_inverse", device="cpu")  # a plain call: not a launch
        calls1, sides1 = tengine._launch_counts()
    finally:
        calls._series.clear()
        calls._series.update(saved)
    assert tengine._delta(calls1, calls0) == {"wavelet_forward": 1, "lorenzo_encode": 2}
    assert tengine._delta(sides1, sides0) == {"wavelet3d_forward n=32": 1,
                                              "lorenzo_encode n=16": 2}


def test_engine_default_start_method(monkeypatch):
    assert ParallelCompressor(2, device="cpu")._start == "spawn"
    assert "spawn" in multiprocessing.get_all_start_methods()
    monkeypatch.setenv("REPRO_CLUSTER_START", "forkserver")
    assert ParallelCompressor(2, device="cpu")._start == "forkserver"
    assert ParallelCompressor(2, "spawn", device="cpu")._start == "spawn"


# -- the device checks -------------------------------------------------------

def test_cuda_without_a_gpu_raises_before_any_process(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = multiprocessing.active_children()
    with pytest.raises(RuntimeError, match="cuda"):
        ParallelCompressor(2)  # the card is the default
    with pytest.raises(RuntimeError, match="cuda"):
        ParallelCompressor(2, device="cuda")
    root = str(tmp_path / "ds")
    with CZDataset(root, "a", spec=SPEC):
        pass
    with pytest.raises(RuntimeError, match="cuda"):
        RankWriter(root, 0, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        RankWriter(root, 0)
    assert multiprocessing.active_children() == before


def test_fork_with_cuda_raises(monkeypatch):
    """A forked rank cannot re-initialize the parent's CUDA runtime, so
    ``"fork"`` with a CUDA device is refused up front, by argument or by
    the environment."""
    monkeypatch.setattr(tengine, "torch_device", lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="fork"):
        ParallelCompressor(2, start_method="fork", device="cuda")
    monkeypatch.setenv("REPRO_CLUSTER_START", "fork")
    with pytest.raises(ValueError, match="fork"):
        ParallelCompressor(2, device="cuda")
    assert ParallelCompressor(2, start_method="spawn", device="cuda")._start == "spawn"


# -- decomposition against the reference -------------------------------------

def _subs(subs) -> list[dict]:
    return [dataclasses.asdict(s) for s in subs]


@pytest.mark.parametrize("layout", ["slab", "pencil", "brick"])
@pytest.mark.parametrize("shape,ranks", [
    ((96, 64, 32), 5),   # unequal axes, rank count that divides nothing
    ((96, 64, 32), 6),
    ((32, 96, 64), 2),
    ((64, 64, 64), 1),
    ((128, 64, 32), 8),
])
def test_decompose_scatter_gather_equal_reference(layout, shape, ranks):
    subs = decompose(shape, ranks, BS, layout)
    assert _subs(subs) == _subs(rdec.decompose(shape, ranks, BS, layout))
    assert [s.shape for s in subs] == [tuple(s.shape) for s in
                                       rdec.decompose(shape, ranks, BS, layout)]
    assert [s.nblocks(BS) for s in subs] == [s.nblocks(BS) for s in
                                             rdec.decompose(shape, ranks, BS, layout)]
    assert sum(s.nvoxels for s in subs) == int(np.prod(shape))
    field = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    parts = scatter(field, subs)
    for got, want in zip(parts, rdec.scatter(field, rdec.decompose(shape, ranks, BS, layout))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gather(parts, subs), field)
    np.testing.assert_array_equal(gather(parts, subs, shape), field)


def test_dims_for_and_chunk_spans_equal_reference():
    for ranks in range(1, 25):
        for ndims in (1, 2, 3):
            assert dims_for(ranks, ndims) == rdec.dims_for(ranks, ndims)
    assert dims_for(12, 3) == (3, 2, 2)
    for nchunks in (0, 1, 2, 5, 7, 8, 128):
        for ranks in (1, 2, 3, 4, 7):
            spans = chunk_spans(nchunks, ranks)
            assert spans == rdec.chunk_spans(nchunks, ranks)
            lens = [hi - lo for lo, hi in spans]
            assert max(lens) - min(lens) <= 1


def _raise_msg(fn, *a):
    with pytest.raises(ValueError) as exc:
        fn(*a)
    return str(exc.value)


@pytest.mark.parametrize("case", ["oversplit", "layout", "dims", "block_size",
                                  "parts", "part_shape"])
def test_decompose_errors_are_the_reference_errors(case):
    sub2 = ([Subdomain(0, (0, 0, 0), (16, 32, 32)), Subdomain(1, (16, 0, 0), (32, 32, 32))],
            [rdec.Subdomain(0, (0, 0, 0), (16, 32, 32)),
             rdec.Subdomain(1, (16, 0, 0), (32, 32, 32))])
    parts = [np.zeros((16, 32, 32), np.float32), np.zeros((16, 16, 32), np.float32)]
    args = {"oversplit": ("decompose", ((32, 32, 32), 3, BS, "slab")),
            "layout": ("decompose", ((32, 32, 32), 2, BS, "diagonal")),
            "dims": ("dims_for", (0, 3)),
            "block_size": ("decompose", ((30, 32, 32), 2, 12, "slab")),
            "parts": ("gather", None),
            "part_shape": ("gather", None)}[case]
    name, a = args
    if name == "gather":
        t = (parts[:1] if case == "parts" else parts, sub2[0])
        r = (parts[:1] if case == "parts" else parts, sub2[1])
        assert _raise_msg(gather, *t) == _raise_msg(rdec.gather, *r)
    else:
        assert _raise_msg(globals()[name], *a) == _raise_msg(getattr(rdec, name), *a)


# -- rank writers and the merge ----------------------------------------------

def _make_dataset(root, spec=SPEC):
    with CZDataset(root, "a", spec=spec):
        pass  # coordinator creates the dataset (manifest + committed spec)


def _rw(root, rank, **kw):
    return RankWriter(root, rank, device="cpu", **kw)


def test_rank_writers_merge_into_one_manifest(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    fields = {0: {"p": FIELD}, 1: {"rho": FIELD + 1}}
    for rank, fs in fields.items():
        with _rw(root, rank) as w:
            for t in range(2):
                w.append({q: f + np.float32(t) for q, f in fs.items()}, t=t, time=9.4 + t)
            assert w.pending == 2
    with CZDataset(root) as ds:
        assert ds.quantities == []
    assert merge_manifests(root) == 4
    with CZDataset(root) as ds:
        assert ds.quantities == ["p", "rho"]
        assert ds.timesteps("p") == [0, 1]
        np.testing.assert_array_equal(ds.read_field("rho", 1), (FIELD + 1) + np.float32(1))
        assert ds.version == 1
    with CZDataset(root, "a") as ds:
        assert ds.append({"p": FIELD, "rho": FIELD}) == 2
    assert merge_manifests(root) == 0


def test_merge_crash_midway_leaves_dataset_readable(tmp_path, monkeypatch):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with CZDataset(root, "a") as ds:
        ds.append({"p": FIELD})
    with _rw(root, 0) as w:
        w.append({"p": FIELD + 1}, t=1)

    def boom(*a, **k):
        raise RuntimeError("simulated crash before the manifest commit")

    monkeypatch.setattr(mw, "write_manifest", boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        merge_manifests(root)
    monkeypatch.undo()
    with CZDataset(root) as ds:
        assert ds.timesteps("p") == [0]
    assert merge_manifests(root) == 1
    with CZDataset(root) as ds:
        assert ds.timesteps("p") == [0, 1]
        np.testing.assert_array_equal(ds.read_field("p", 1), FIELD + 1)


def test_merge_conflict_and_missing_member_raise(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with _rw(root, 0) as w0, _rw(root, 1) as w1:
        w0.append({"p": FIELD}, t=0)
        w1.append({"p": FIELD + 1}, t=0)
    with pytest.raises(ManifestError, match="merge conflict"):
        merge_manifests(root)
    with CZDataset(root) as ds:
        assert ds.quantities == []
    os.unlink(os.path.join(root, "manifest.rank1.json"))
    os.unlink(os.path.join(root, "p", "t000000.r0.cz"))
    with pytest.raises(ManifestError, match="missing member"):
        merge_manifests(root)


def test_rank_writer_refuses_member_overwrite(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with _rw(root, 0) as w:
        w.append({"p": FIELD}, t=0)
    merge_manifests(root)
    with _rw(root, 0) as w:
        with pytest.raises(IOError, match="already exists"):
            w.append({"p": FIELD + 1}, t=0)
    with CZDataset(root) as ds:
        np.testing.assert_array_equal(ds.read_field("p", 0), FIELD)


def test_merge_keeps_entries_committed_during_merge(tmp_path, monkeypatch):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with _rw(root, 0) as w:
        w.append({"p": FIELD}, t=0)
    real = mw.read_rank_manifest
    state = {"calls": 0}

    def racy(r, rank):
        state["calls"] += 1
        side = real(r, rank)
        if state["calls"] == 1:  # rank commits t=1 right after the scan read
            with _rw(root, 0) as w2:
                w2.append({"p": FIELD + 1}, t=1)
        return side

    monkeypatch.setattr(mw, "read_rank_manifest", racy)
    assert merge_manifests(root) == 1
    monkeypatch.undo()
    assert [e["t"] for e in real(root, 0)["entries"]] == [1]
    assert merge_manifests(root) == 1
    with CZDataset(root) as ds:
        assert ds.timesteps("p") == [0, 1]


def test_append_on_stale_handle_preserves_merged_entries(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    ds = CZDataset(root, "a")
    with _rw(root, 0) as w:
        w.append({"p": FIELD}, t=0)
    assert merge_manifests(root) == 1
    assert ds.append({"p": FIELD + 1}) == 1
    ds.close()
    with CZDataset(root) as ds2:
        assert ds2.timesteps("p") == [0, 1]
        np.testing.assert_array_equal(ds2.read_field("p", 0), FIELD)


def test_long_lived_writer_does_not_resurrect_merged_entries(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with _rw(root, 0) as w:
        w.append({"p": FIELD}, t=0)
        assert merge_manifests(root) == 1
        assert w.pending == 0
        w.append({"p": FIELD + 1}, t=1)
        assert w.pending == 1
        assert [e["t"] for e in mw.read_rank_manifest(root, 0)["entries"]] == [1]
        assert merge_manifests(root) == 1
        assert w.pending == 0
    with CZDataset(root) as ds:
        assert ds.timesteps("p") == [0, 1]


def test_sidecar_entry_missing_key_is_manifest_error(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with _rw(root, 0) as w:
        w.append({"p": FIELD}, t=0)
    side_path = os.path.join(root, "manifest.rank0.json")
    with open(side_path) as f:
        side = json.load(f)
    del side["entries"][0]["time"]
    with open(side_path, "w") as f:
        json.dump(side, f)
    with pytest.raises(ManifestError, match="missing 'time'"):
        merge_manifests(root)


def test_rank_writer_rejects_bad_appends(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with _rw(root, 0) as w:
        w.append({"p": FIELD}, t=0)
        with pytest.raises(ValueError, match="already appended"):
            w.append({"p": FIELD}, t=0)
        for evil in ("../evil", "..", "."):
            with pytest.raises(ValueError, match="invalid quantity"):
                w.append({evil: FIELD}, t=1)
        with pytest.raises(ValueError, match="at least one"):
            w.append({}, t=1)
    with pytest.raises(ValueError, match="rank must be >= 0"):
        _rw(root, -1)
    with pytest.raises(ManifestError):
        _rw(os.path.join(tmp_path, "nowhere"), 0)


def test_merge_rejects_dtype_drift(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with CZDataset(root, "a") as ds:
        ds.append({"p": FIELD})  # commits p as float32
        with pytest.raises(ValueError, match="dtype"):
            ds.append({"p": FIELD.astype(np.float64)})  # direct path too
    with _rw(root, 0) as w:
        w.append({"p": FIELD.astype(np.float64)}, t=1)
    with pytest.raises(ManifestError, match="dtype"):
        merge_manifests(root)


def test_gc_reclaims_orphans_but_keeps_sidecar_members(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with CZDataset(root, "a") as ds:
        ds.append({"p": FIELD})
    with open(os.path.join(root, "p", "t000099.cz"), "wb") as f:
        f.write(b"CZ2\0garbage")
    with open(os.path.join(root, "manifest.json.tmp"), "w") as f:
        f.write("{")
    os.makedirs(os.path.join(root, "rho"))
    with open(os.path.join(root, "rho", "t000000.cz.rank0.part"), "wb") as f:
        f.write(b"\0" * 8)
    with _rw(root, 1) as w:
        w.append({"p": FIELD + 1}, t=1)
    with CZDataset(root) as ds:
        listed = ds.gc(dry_run=True)
        assert sorted(listed) == ["manifest.json.tmp", "p/t000099.cz",
                                  "rho/t000000.cz.rank0.part"]
    with CZDataset(root, "a") as ds:
        assert ds.gc() == listed
        assert ds.gc(dry_run=True) == []
    assert not os.path.exists(os.path.join(root, "rho"))
    assert merge_manifests(root) == 1
    with CZDataset(root) as ds:
        assert ds.timesteps("p") == [0, 1]
        np.testing.assert_array_equal(ds.read_field("p", 1), FIELD + 1)


def test_rank_writer_stats(tmp_path):
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    with _rw(root, 0, stats=True) as w:
        w.append({"p": FIELD}, t=0)
    merge_manifests(root)
    with CZDataset(root) as ds:
        assert ds.timestep_info("p", 0)["psnr"] is None  # raw is lossless
        assert ds.timestep_info("p", 0)["max_err"] == 0.0


def test_rank_writer_reaches_its_device(tmp_path, monkeypatch):
    """The writer's device reaches the ShardWriter and the stats decode."""
    root = os.path.join(tmp_path, "ds")
    _make_dataset(root)
    seen = []
    real = mw.container.read_field

    def spy(rel, device, store):
        seen.append(device)
        return real(rel, device=device, store=store)

    monkeypatch.setattr(mw.container, "read_field", spy)
    with _rw(root, 0, stats=True) as w:
        assert w.device == torch.device("cpu") and w._writer.device == w.device
        w.append({"p": FIELD}, t=0)
    assert seen == [torch.device("cpu")]


# -- across packages ---------------------------------------------------------

def _tree(root) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            out[os.path.relpath(path, root).replace(os.sep, "/")] = _bytes(path)
    return out


#: the rank appends of the cross-package cases: (rank, fields, t, time)
RANK_APPENDS = [(0, {"p": FIELD}, 0, 9.4), (1, {"rho": FIELD + 1}, 0, 9.4),
                (0, {"p": FIELD + 2}, 1, None), (1, {"rho": FIELD * 2}, 1, 9.5)]


def _appends(root, writer_cls, **kw):
    writers = {}
    try:
        for rank, fields, t, time in RANK_APPENDS:
            if rank not in writers:
                writers[rank] = writer_cls(root, rank, stats=True, **kw)
            writers[rank].append(fields, t=t, time=time)
    finally:
        for w in writers.values():
            w.close()


def _port_tree(root, scheme):
    _make_dataset(root, _spec(scheme))
    _appends(root, RankWriter, device="cpu")


def _ref_tree(root, scheme):
    with RCZDataset(root, "a", spec=_spec(scheme, RSpec)):
        pass
    _appends(root, RRankWriter)


@pytest.mark.parametrize("scheme", ["raw", "lorenzo", "zfpx"])
def test_sidecars_and_merges_are_the_reference_bytes(tmp_path, scheme):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    _port_tree(port, scheme)
    _ref_tree(ref, scheme)
    assert _tree(port) == _tree(ref)  # members and sidecars
    assert {k for k in _tree(port) if k.startswith("manifest.rank")} == \
        {"manifest.rank0.json", "manifest.rank1.json"}
    assert merge_manifests(port) == rmerge(ref) == 4
    assert _tree(port) == _tree(ref)  # merged manifest, sidecars retired


@pytest.mark.parametrize("merger", ["port", "ref"])
def test_each_merge_folds_the_other_packages_sidecars(tmp_path, merger):
    """Sidecars one package wrote, merged by the other, give the tree the
    writing package's own merge gives."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    if merger == "port":
        _ref_tree(a, "lorenzo")
        _ref_tree(b, "lorenzo")
        assert merge_manifests(a) == 4 and rmerge(b) == 4
    else:
        _port_tree(a, "lorenzo")
        _port_tree(b, "lorenzo")
        assert rmerge(a) == 4 and merge_manifests(b) == 4
    assert _tree(a) == _tree(b)
    with CZDataset(a) as ds, RCZDataset(b) as rds:
        assert ds.quantities == rds.quantities == ["p", "rho"]
        for q in ("p", "rho"):
            assert ds.timestep_info(q) == rds.timestep_info(q)
            for t in (0, 1):
                np.testing.assert_array_equal(ds.read_field(q, t), rds.read_field(q, t))
