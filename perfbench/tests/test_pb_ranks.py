"""The cell over ranks on the CPU at a small size: the driver's whole run in
two and in four processes, its failure where the program has no group
snapshots, the shared reference against a member whose rank spans are
swapped, and the four cluster readers on a hand-made record."""
import json
import struct

import numpy as np
import pytest

from perfbench.harness import bench
from perfbench.reference import cz_w3ai as ref
from perfbench.reference import cz_w3ai_shared as shared

CELL = "insitu.euler512.w3ai.ranks4.every10"
READERS = ("exscan_ms", "rank_wait_ms", "shared_write_ms", "commit_ms")


def _small(ranks: int) -> dict:
    spec = bench.load_cell(CELL).config["spec"]
    # 64^3 a rank: 8 blocks of 32^3, 2 a chunk (256 KiB buffers)
    return {"n": 64, "ranks": ranks, "spec": {**spec, "buffer_bytes": 1 << 18}}


@pytest.mark.parametrize("ranks,trace", [(2, False), (4, True)])
def test_the_run_over_ranks_is_correct(ranks, trace):
    out = bench.run_cell(CELL, 2 ** 31 + 17, 0.3, trace, device="cpu",
                         overrides=_small(ranks))
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"coef_gap", "err_bound", "tags_off", "replay_off",
                                  "offsets_off"}
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert out["device"]["count"] == 4
    rec = out["_record"]
    assert rec["ranks"] == ranks and rec["steps"] == 10 * rec["snapshots"]
    if trace:
        assert set(out["metrics"]) == set(READERS)
        assert {s["args"]["rank"] for s in rec["spans"]} == set(range(ranks))
    else:
        mcell = ranks * 64 ** 3 * rec["steps"] / rec["window_s"] / 1e6
        assert out["metrics"]["insitu_mcell_s"]["value"] == pytest.approx(mcell)
        assert set(out["metrics"]) == {"insitu_mcell_s", "setup_s"}


def test_a_program_without_group_snapshots_fails_before_any_rank(monkeypatch):
    from perfbench.harness.drivers import insitu_ranks
    from repro_torch import ckpt

    class Old:
        def __init__(self, ds_dir, every=1, spec=None, workers=1, device="cuda"):
            pass
    monkeypatch.setattr(ckpt, "FieldSnapshotter", Old)
    monkeypatch.setattr(insitu_ranks.subprocess, "Popen", None)  # nothing may start
    with pytest.raises(RuntimeError, match="no process group"):
        bench.run_cell(CELL, 5, 0.3, False, device="cpu", overrides=_small(2))


def _member(tmp_path, fields):
    """A member of the slabs stacked, as the ranks write it (the serial
    writer's bytes), and each rank's bytes in it."""
    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec

    path = str(tmp_path / "m.cz")
    container.write_field(path, np.concatenate(fields), CompressionSpec(buffer_bytes=1 << 18),
                          device="cpu")
    buf, hdr = shared._read(path)
    spans = shared.rank_chunk_spans(hdr, [8] * len(fields))
    return path, buf, hdr, spans, [sum(hdr["chunk_sizes"][a:b]) for a, b in spans]


def _swapped(path, buf, hdr, spans):
    """The member with rank 0's and rank 1's chunks swapped, bytes and
    chunk table alike (every CRC still holds)."""
    sizes = hdr["chunk_sizes"]
    starts = np.concatenate([[12], 12 + np.cumsum(sizes)])
    order = list(range(*spans[1])) + list(range(*spans[0])) + \
        [i for a, b in spans[2:] for i in range(a, b)]
    data = b"".join(buf[starts[i]:starts[i] + sizes[i]] for i in order)
    foot = {k: ([v[i] for i in order] if k.startswith("chunk_") else v) for k, v in hdr.items()}
    out = path.replace(".cz", ".swapped.cz")
    with open(out, "wb") as f:
        f.write(ref.MAGIC + struct.pack("<Q", 12 + len(data)) + data + json.dumps(foot).encode())
    return out


def test_offsets_off_catches_swapped_rank_spans(tmp_path):
    rng = np.random.default_rng(3)
    fields = [np.full((64, 64, 64), 3.0, np.float32),
              (rng.standard_normal((64, 64, 64)) * 10).astype(np.float32)]
    path, buf, hdr, spans, rank_bytes = _member(tmp_path, fields)
    shapes = [(64, 64, 64)] * 2
    assert rank_bytes[0] * 20 < rank_bytes[1]
    assert shared.offsets_off([path], shapes, rank_bytes) == 0
    control = _swapped(path, buf, hdr, spans)
    assert shared.offsets_off([control], shapes, rank_bytes) > 0
    # and the control's rank 0 decodes rank 1's slab
    coeffs, _ = shared.read_rank(control, 0, [8, 8], "cpu")
    import torch
    j = ref.judge_field(torch.from_numpy(fields[0]), coeffs, 1e-3, 100.0)
    assert j["coef_gap"] > 2.0 and j["err_bound"] > 1.0
    # a rank that reports other bytes than its chunks hold is caught too
    assert shared.offsets_off([path], shapes, [rank_bytes[0] + 1, rank_bytes[1]]) == 1


def _span(name, ts, dur_ms, rank, **args):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur_ms * 1e3,
            "args": {"rank": rank, **args}}


def test_the_cluster_readers_on_a_hand_made_record():
    spans = []
    for k, key in enumerate(["p/t000001.cz", "rho/t000001.cz", "p/t000002.cz"]):
        for r, ms in enumerate([1.0 + k, 51.0 + k, 11.0 + k, 31.0 + k]):
            spans.append(_span("cluster.exscan", 1e6 * k + r, ms, r, key=key))
            spans.append(_span("cluster.write_at", 1e6 * k + 100 + r, 2.0 * r + k, r))
    spans += [_span("cluster.commit", 1e6 * k + 500, 20.0 + k, 0) for k in range(3)]
    spans.append(_span("cluster.commit", 9e6, 999.0, 1))   # not rank 0's: left out
    rec = {"spans": spans}
    got = {name: bench._reader(name)(rec) for name in READERS}
    assert got == {"exscan_ms": 2.0, "rank_wait_ms": 50.0, "shared_write_ms": 7.0,
                   "commit_ms": 21.0}
    assert all(bench._reader(name)({"spans": []}) is None for name in READERS)
    assert all(bench._reader(name)({}) is None for name in READERS)
