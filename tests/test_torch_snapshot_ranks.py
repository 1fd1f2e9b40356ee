"""In-situ snapshots over ranks: ``FieldSnapshotter`` and ``CZDataset`` with a
process group, on the CPU, in four spawned gloo processes.

Each rank hands in one 64^3 slab of a 256x64x64 field (slabs along axis 0,
blocks of 32, 256 KiB buffers: 2 blocks a chunk, 4 chunks a rank); one slab
is constant and one noise, so the ranks' compressed sizes differ.

* each shared member is the serial writer's member of the gathered field,
  byte for byte, the port's and the JAX package's, and the manifest is the
  serial dataset's;
* ``read_box`` across a rank boundary reads what the serial dataset reads;
* a rank that raises (a slab that is not whole blocks; a failed write-at)
  makes every rank raise, with nothing committed, and the group goes on;
* the spans carry their rank, rank 0 gathers them, and the counters count
  each rank's bytes and each collective;
* without a group the members are the JAX package's, as before.

Every spawn has its own timeout, and the group's collectives one shorter
still, so a rank that hangs fails the test instead of the run.  The ranks
import nothing of the JAX package; the tests import it inside themselves.
"""
import datetime
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import container
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.store import CZDataset

torch.set_num_threads(1)

RANKS, N, EPS = 4, 64, 1e-3
SPEC = dict(eps=EPS, block_size=32, buffer_bytes=1 << 18)
#: seconds a spawn may take, and a collective within it
SPAWN_S, GROUP_S = 150, 60


def _global_field() -> dict:
    """p (smooth, rank 1's slab constant, rank 2's noise) and rho."""
    rng = np.random.default_rng(7)
    g = np.mgrid[0:RANKS * N, 0:N, 0:N].astype(np.float32) / N
    p = 50 * np.sin(5 * g[0] + g[1]) * np.exp(-g[2]) + rng.standard_normal(g[0].shape) * 0.01
    p = p.astype(np.float32)
    p[N:2 * N] = 3.0
    p[2 * N:3 * N] = rng.standard_normal((N, N, N)).astype(np.float32) * 10
    rho = (1000 + 20 * np.cos(3 * g[0] - g[2])).astype(np.float32)
    return {"p": p, "rho": rho}


def _slab(field: np.ndarray, rank: int) -> torch.Tensor:
    return torch.from_numpy(field[rank * N:(rank + 1) * N].copy())


def _entry(fn, rank, world, out, args):
    """A spawned rank: ``fn(rank, out, *args)`` in a gloo group; what it
    returns, or what it raised, in ``rank{r}.json``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/init", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=GROUP_S))
    try:
        res = fn(rank, out, *args)
    except BaseException as e:  # noqa: BLE001 - reported to the test
        res = {"raised": f"{type(e).__name__}: {e}"}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _spawn(fn, tmp_path, *args) -> list[dict]:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, RANKS, str(tmp_path), args))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_S
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive, f"rank(s) {alive} still running after {SPAWN_S} s"
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(RANKS)]


def _counters(*names) -> dict:
    from repro_torch import obs

    out = {}
    for name in names:
        for labels, value in obs.REGISTRY.get(name).samples():
            out[f"{name}{json.dumps(labels, sort_keys=True)}"] = value
    return out


def _sound_rank(rank, out):
    """Two collective snapshots of p and rho, traced; rank 0 saves every
    rank's spans."""
    import torch.distributed as dist

    from repro_torch.ckpt import FieldSnapshotter
    from repro_torch.obs import trace

    fields = _global_field()
    trace.reset()
    trace.enable()
    snap = FieldSnapshotter(os.path.join(out, "ds"), every=1, spec=CompressionSpec(**SPEC),
                            workers=2, device="cpu", group=dist.group.WORLD)
    ts = [snap.maybe_snapshot({q: _slab(f, rank) for q, f in fields.items()}, step)
          for step in (0, 1)]
    snap.close()
    evs = trace.gather_events(dist.group.WORLD)
    trace.disable()
    if rank == 0:
        with open(os.path.join(out, "events.json"), "w") as f:
            json.dump(evs, f)
    return {"ts": ts,
            "counters": _counters("cz_shared_write_bytes_total", "cz_collective_calls_total")}


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    res = _spawn(_sound_rank, out)
    assert all("raised" not in r for r in res), res
    return {"out": out, "res": res, "fields": _global_field()}


def _serial(tmp_path, fields) -> CZDataset:
    ds = CZDataset(str(tmp_path / "serial"), "a", spec=CompressionSpec(**SPEC), workers=2,
                   device="cpu")
    for step in (0, 1):
        ds.append(fields, time=float(step))
    return ds


def test_shared_members_are_the_serial_members_bytes(sound, tmp_path):
    out, fields = sound["out"], sound["fields"]
    assert [r["ts"] for r in sound["res"]] == [[0, 1]] * RANKS
    ser = _serial(tmp_path, fields)
    for q in fields:
        for t in (0, 1):
            rel = f"{q}/t{t:06d}.cz"
            assert (out / "ds" / rel).read_bytes() == (tmp_path / "serial" / rel).read_bytes()
    assert json.loads((out / "ds" / "manifest.json").read_text()) == \
        json.loads((tmp_path / "serial" / "manifest.json").read_text())
    ser.close()


def test_shared_members_are_the_reference_writers_bytes(sound, tmp_path):
    from repro.core import CompressionSpec as RSpec
    from repro.store import CZDataset as RDataset

    ref = RDataset(str(tmp_path / "ref"), "a", spec=RSpec(**SPEC), workers=2)
    for step in (0, 1):
        ref.append(sound["fields"], time=float(step))
    ref.close()
    for q in sound["fields"]:
        for t in (0, 1):
            rel = f"{q}/t{t:06d}.cz"
            assert (sound["out"] / "ds" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes()


def test_ranks_with_very_different_payloads(sound):
    by_rank = [sound["res"][r]["counters"][f'cz_shared_write_bytes_total{{"rank": "{r}"}}']
               for r in range(RANKS)]
    assert by_rank[1] * 20 < by_rank[2]     # the constant slab against the noise
    dec = container.read_field(str(sound["out"] / "ds" / "p" / "t000001.cz"), device="cpu")
    assert np.max(np.abs(dec - sound["fields"]["p"])) <= 100 * EPS


def test_read_box_across_a_rank_boundary(sound, tmp_path):
    ser = _serial(tmp_path, sound["fields"])
    ds = CZDataset(str(sound["out"] / "ds"), "r", device="cpu")
    for lo, hi in [((N - 5, 3, 0), (N + 7, 40, N)), ((2 * N - 1, 0, 10), (3 * N + 1, N, 20))]:
        got = ds.read_box("p", 1, lo, hi)
        np.testing.assert_array_equal(got, ser.read_box("p", 1, lo, hi))
        want = sound["fields"]["p"][tuple(slice(a, b) for a, b in zip(lo, hi))]
        assert np.max(np.abs(got - want)) <= 100 * EPS
    ds.close()
    ser.close()


def test_spans_and_counters_carry_their_rank(sound):
    evs = json.loads((sound["out"] / "events.json").read_text())
    spans = [e for e in evs if e.get("ph") == "X"]
    assert spans and all("rank" in e["args"] for e in spans)
    for name, per_rank in [("cluster.exscan", 4), ("cluster.write_at", 4), ("snapshot", 2)]:
        for r in range(RANKS):
            assert sum(e["name"] == name and e["args"]["rank"] == r for e in spans) == per_rank
    assert sorted({e["args"]["rank"] for e in spans if e["name"] == "cluster.commit"}) == [0]
    assert sum(e["name"] == "cluster.commit" for e in spans) == 2
    keys = {e["args"]["key"] for e in spans if e["name"] == "cluster.exscan"}
    assert keys == {"p/t000000.cz", "rho/t000000.cz", "p/t000001.cz", "rho/t000001.cz"}
    for r, res in enumerate(sound["res"]):
        c = res["counters"]
        mine = sum(e["args"]["bytes"] for e in spans
                   if e["name"] == "cluster.write_at" and e["args"]["rank"] == r)
        assert c[f'cz_shared_write_bytes_total{{"rank": "{r}"}}'] == mine > 0
        ops = {k.split('"op": "')[1].split('"')[0]: v for k, v in c.items()
               if k.startswith("cz_collective_calls_total")}
        # an exscan a member, a gather and a broadcast a commit, a broadcast
        # to open, a gather of the spans
        assert ops == {"exscan": 4, "gather": 3, "broadcast": 3}
    # every rank's spans on rank 0's timeline: the ranks' exscans of one
    # member end together (the last rank to arrive releases them all)
    ends = {}
    for e in spans:
        if e["name"] == "cluster.exscan":
            ends.setdefault(e["args"]["key"], []).append(e["ts"] + e["dur"])
    assert all(max(v) - min(v) < 1e6 for v in ends.values())  # within a second


def _failing_rank(rank, out):
    """Two appends that fail on one rank, then one that commits."""
    import torch.distributed as dist

    from repro_torch.ckpt import FieldSnapshotter

    fields = _global_field()
    snap = FieldSnapshotter(os.path.join(out, "ds"), every=1, spec=CompressionSpec(**SPEC),
                            device="cpu", group=dist.group.WORLD)
    said = {}
    slab = _slab(fields["p"], rank)
    bad = slab[:, :, :48] if rank == 2 else slab      # not whole blocks
    t0 = time.monotonic()
    try:
        snap.maybe_snapshot({"p": slab, "rho": bad}, 0)
    except Exception as e:  # noqa: BLE001
        said["shape"] = f"{type(e).__name__}: {e}"
    real = container.write_at
    if rank == 3:
        def broken(*a, **k):
            raise OSError("disk full")
        container.write_at = broken
    try:
        snap.maybe_snapshot({"p": slab}, 0)
    except Exception as e:  # noqa: BLE001
        said["write_at"] = f"{type(e).__name__}: {e}"
    said["seconds"] = time.monotonic() - t0
    container.write_at = real
    said["t"] = snap.maybe_snapshot({"p": slab}, 5)
    snap.close()
    return said


def test_a_rank_that_raises_makes_every_rank_raise(tmp_path):
    res = _spawn(_failing_rank, tmp_path)
    assert all("raised" not in r for r in res), res
    for r, said in enumerate(res):
        assert said.keys() >= {"shape", "write_at"}, (r, said)
        assert said["seconds"] < GROUP_S  # at the next collective, not a timeout
    assert "ValueError" in res[2]["shape"]
    assert all("rank(s) [2] failed" in res[r]["shape"] for r in (0, 1, 3))
    assert "OSError: disk full" in res[3]["write_at"]
    assert all("rank 3 failed its write-at" in res[r]["write_at"] for r in (0, 1, 2))
    # nothing of the failed appends was committed or left behind; the group
    # went on, and the next snapshot is timestep 0
    assert [r["t"] for r in res] == [0] * RANKS
    ds = CZDataset(str(tmp_path / "ds"), "r", device="cpu")
    assert ds.quantities == ["p"] and ds.timestep_info("p")[0]["time"] == 5.0
    assert sorted(os.listdir(tmp_path / "ds" / "p")) == ["t000000.cz"]
    assert not (tmp_path / "ds" / "rho").exists() or not os.listdir(tmp_path / "ds" / "rho")
    ds.close()


def test_group_none_keeps_todays_member_bytes(tmp_path):
    from repro.ckpt.checkpoint import FieldSnapshotter as RSnap
    from repro.core import CompressionSpec as RSpec

    from repro_torch.ckpt import FieldSnapshotter

    fields = _global_field()
    mine = FieldSnapshotter(str(tmp_path / "port"), every=1, spec=CompressionSpec(**SPEC),
                            workers=2, device="cpu")
    ref = RSnap(str(tmp_path / "ref"), every=1, spec=RSpec(**SPEC), workers=2)
    for step in (0, 3):
        assert mine.maybe_snapshot({q: torch.from_numpy(f) for q, f in fields.items()},
                                   step) == ref.maybe_snapshot(fields, step)
    mine.close()
    ref.close()
    for q in fields:
        for t in (0, 1):
            rel = f"{q}/t{t:06d}.cz"
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes()
