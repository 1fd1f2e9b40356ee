"""In-situ loop over ranks: every rank advances the solver on its own card
and the ranks snapshot their QoIs together, every ``every`` steps, into one
shared file per quantity, through the program's ``FieldSnapshotter`` over
a process group.

The harness process is rank 0.  It starts ranks 1 .. ``ranks - 1`` as
processes of their own (``python -m perfbench.harness.drivers.insitu_ranks
JOB RANK``), rank ``r`` on card ``r`` (``CUDA_VISIBLE_DEVICES``), and all of
them join one gloo group on localhost, with a timeout of ``TIMEOUT_S`` on
the rendezvous and on every collective.  If a rank fails, or rank 0 does,
rank 0 kills the others; a rank whose parent is gone ends itself.  Before
it starts any process, rank 0 checks that the program can snapshot over a
group at all, and fails at once where it cannot.

Set-up (``setup_s``, rank 0's): each rank's producer state from the seed
and its rank (the cloud placed by both), one ``dt`` for every rank (the
least of their CFL steps, one all-reduce), one warm-up step and one
warm-up snapshot at step 0 on every rank.  The window starts at that
snapshot boundary on every rank (a barrier); after each snapshot rank 0
decides whether the window is over and tells the others (a broadcast), so
the window holds whole cycles of ``every`` steps and one collective
snapshot each.  ``insitu_mcell_s`` is ``ranks x n^3`` cells times the
steps over rank 0's window.  ``memory_peak_bytes`` is the fullest card's
peak.  A traced run profiles rank 0's card only; the program's spans of
every rank reach rank 0 at the window's end (``obs.trace.gather_events``).

Once the window has closed, each rank judges its own slab of every
snapshot taken, against the field it handed in: it replays its producer
(``replay_off``) and hands each replayed slab with its chunks of the shared
member to the reference (``reference/cz_w3ai_shared.py``: ``coef_gap``,
``err_bound``).  Rank 0 checks the manifest's time tags (``tags_off``) and
each snapshot's layout (``offsets_off``), with the bytes each rank
reported writing (its ``cz_shared_write_bytes_total{rank}`` over the
snapshot).
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from perfbench.harness import arith, bench
from perfbench.harness.devtrace import Window, reduce_trace
from perfbench.harness.drivers.insitu import _fingerprints
from perfbench.producers import euler3d
from perfbench.reference import cz_w3ai as ref
from perfbench.reference import cz_w3ai_shared as shared

__all__ = ["run", "TIMEOUT_S"]

#: seconds a rank waits at the rendezvous or at any collective
TIMEOUT_S = 120
#: seconds rank 0 waits for the other ranks to exit after a sound run
EXIT_S = 60


def _require_group_snapshots() -> None:
    """Fail at once where the program cannot snapshot over a group."""
    import inspect

    from repro_torch.ckpt import FieldSnapshotter

    if "group" not in inspect.signature(FieldSnapshotter).parameters:
        raise RuntimeError("the program's FieldSnapshotter takes no process group: "
                           "it has no rank-parallel snapshots")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cards() -> list[str]:
    import torch

    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    if seen:
        return [c.strip() for c in seen.split(",") if c.strip()]
    return [str(i) for i in range(torch.cuda.device_count())]


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device: str) -> bench.Run:
    _require_group_snapshots()
    ranks = int(cell.config["ranks"])
    root = bench.data_dir(cell.name)
    job = {"cell": {"name": cell.name, "chips": cell.chips, "config": cell.config,
                    "traffic": cell.traffic, "end_to_end": [], "per_layer": []},
           "seed": seed, "seconds": seconds, "trace": trace, "device": device,
           "ranks": ranks, "init": f"tcp://127.0.0.1:{_free_port()}", "root": str(root)}
    job_path = root / "job.json"
    job_path.write_text(json.dumps(job))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(bench.ROOT / "src"), str(bench.ROOT)]
                                        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cards = _cards() if device == "cuda" else []
    procs = []
    try:
        for r in range(1, ranks):
            if cards:
                env["CUDA_VISIBLE_DEVICES"] = cards[r % len(cards)]
            with open(root / f"rank{r}.log", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "perfbench.harness.drivers.insitu_ranks",
                     str(job_path), str(r)], cwd=bench.ROOT, env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        out = _rank_main(0, job)
        deadline = time.monotonic() + EXIT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        bad = [(r, p.returncode) for r, p in enumerate(procs, 1) if p.returncode]
        if bad:
            raise RuntimeError(f"rank(s) exited with {bad}")
        return out
    except BaseException:
        for r, p in enumerate(procs, 1):
            if p.poll() is None:
                p.kill()
            p.wait()
            tail = (root / f"rank{r}.log").read_bytes()[-2000:].decode(errors="replace")
            print(f"rank {r} (exit {p.returncode}):\n{tail}", file=sys.stderr)
        raise


def _watch_parent() -> None:
    """End this rank when the process that started it is gone."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(3)
    threading.Thread(target=watch, daemon=True).start()


def _shared_bytes(rank: int) -> float:
    """The bytes this rank has written into shared files so far (the
    program's count)."""
    return bench.program_counters().get(f"cz_shared_write_bytes_total{{rank={rank}}}", 0)


def _rank_main(rank: int, job: dict) -> bench.Run | None:
    import torch
    import torch.distributed as dist

    # the host's cores shared out among the ranks, as MPI places them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // job["ranks"]))
    dist.init_process_group("gloo", init_method=job["init"], rank=rank,
                            world_size=job["ranks"],
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        return _loop(rank, job)
    finally:
        dist.destroy_process_group()


def _loop(rank: int, job: dict) -> bench.Run | None:
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import FieldSnapshotter
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.obs import trace as ptrace

    cfg, traffic = job["cell"]["config"], job["cell"]["traffic"]
    seed, seconds, trace, device = job["seed"], job["seconds"], job["trace"], job["device"]
    ranks, group = job["ranks"], dist.group.WORLD
    n, every, qois = int(cfg["n"]), int(traffic["every"]), list(traffic["qois"])
    spec = CompressionSpec(**cfg["spec"])
    bench.reset_peak(device)

    U = _start(cfg, seed, rank, device)
    dt = torch.tensor([euler3d.cfl_dt(U, float(cfg["cfl"]))], dtype=torch.float64)
    dist.all_reduce(dt, op=dist.ReduceOp.MIN)
    dt = float(dt)
    root = Path(job["root"]) / "snapshots"
    snap = FieldSnapshotter(str(root), every=every, spec=spec, workers=int(cfg["workers"]),
                            device=device, group=group)
    taken, wrote = [], []   # (step, fingerprints), bytes this rank wrote a snapshot
    U = euler3d.step(U, dt)                   # warm-up step: state of step 0
    fields = euler3d.qoi_fields(U, qois)
    taken.append((0, _fingerprints(fields)))
    bench.sync(device)
    w0 = _shared_bytes(rank)
    snap.maybe_snapshot(fields, 0)
    wrote.append(_shared_bytes(rank) - w0)
    bench.sync(device)

    if trace:
        ptrace.reset()
        ptrace.enable()
    steps = 0
    stop = torch.zeros(1, dtype=torch.int64)
    counters0 = bench.program_counters()
    with Window(trace and rank == 0, device) as win:
        dist.barrier()   # every rank's window starts here, rank 0's profiler running
        win.t0_ns = time.perf_counter_ns()
        setup_s = bench.process_age_s()
        while True:
            steps += 1
            with win.span("step"):
                U = euler3d.step(U, dt)
            if steps % every:
                continue
            fields = euler3d.qoi_fields(U, qois)
            taken.append((steps, _fingerprints(fields)))
            bench.sync(device)
            w0 = _shared_bytes(rank)
            with win.span("snapshot"):
                snap.maybe_snapshot(fields, steps)
            wrote.append(_shared_bytes(rank) - w0)
            if rank == 0:
                stop[0] = (time.perf_counter_ns() - win.t0_ns) / 1e9 >= seconds
            dist.broadcast(stop, src=0)
            if stop[0]:
                break
        bench.sync(device)
        window_s = win.close()
    counters = bench.counter_deltas(counters0, bench.program_counters())
    spans = []
    if trace:
        ptrace.disable()
        spans = ptrace.gather_events(group) or []
    peak = bench.peak_bytes(device)
    snap.close()
    del U, fields
    taken = [(s, fp.tolist()) for s, fp in taken]

    # -- the judgement, once the window has closed and the state is freed --
    t_check = time.perf_counter()
    judged = _judge_rank(rank, root, cfg, job, dt, taken, qois, device)
    mine = {"peak": peak, "counters": counters, "wrote": wrote, "judged": judged,
            "forbidden": bench.forbidden_modules(), "window_s": window_s,
            "check_s": time.perf_counter() - t_check,
            "snapshot_s": [(b - a) / 1e9 for name, a, b in win.spans if name == "snapshot"]}
    got = [None] * ranks if rank == 0 else None
    dist.gather_object(mine, got, dst=0)
    if rank != 0:
        return None

    card = bench.power_limit() if device == "cuda" else device
    forbidden = sorted({m for g in got[1:] for m in g["forbidden"]})  # run.py checks rank 0
    if forbidden:
        raise RuntimeError(f"forbidden modules loaded in a rank: {', '.join(forbidden)}")
    out = bench.Run()
    out.memory_peak_bytes = max(g["peak"] for g in got)
    rate = arith.mcell_rate(ranks * n ** 3, steps, window_s)
    out.metrics = {"insitu_mcell_s": rate, "setup_s": setup_s}
    out.attempted = (len(taken) - 1) * len(qois)
    snap_spans = [(a, b) for name, a, b in win.spans if name == "snapshot"]
    snap_s = [(b - a) / 1e9 for a, b in snap_spans]
    out.lines += [
        f"card {card} (rank 0), {ranks} ranks",
        f"window {window_s!r} s, {steps} steps of dt {dt!r}, {len(snap_s)} snapshots",
        f"snapshot s {[round(s, 4) for s in snap_s]}",
        f"solver and snapshot s {window_s - sum(snap_s)!r} {sum(snap_s)!r}",
        f"snapshot share {100 * sum(snap_s) / window_s!r} %",
        f"peak bytes by rank {[g['peak'] for g in got]}",
        f"snapshot s by rank {[round(sum(g['snapshot_s']), 4) for g in got]}",
        f"window s by rank {[g['window_s'] for g in got]}",
        f"insitu_mcell_s {rate!r}; setup_s {setup_s!r}",
    ]
    out.checks = _judge_all(root, cfg, got, taken, qois, out)
    out.lines.append(f"reference check {max(g['check_s'] for g in got):.2f} s over "
                     f"{len(taken)} snapshots x {len(qois)} QoIs x {ranks} ranks "
                     "(the replay with it)")
    merged: dict = {}
    for g in got:
        for k, v in g["counters"].items():
            merged[k] = merged.get(k, 0) + v
    out.record = {"window_s": window_s, "steps": steps, "every": every, "qois": qois,
                  "n": n, "ranks": ranks, "block_size": spec.block_size,
                  "snapshots": len(snap_s),
                  "harness_spans": [{"name": "snapshot", "t0_ns": a, "t1_ns": b}
                                    for a, b in snap_spans],
                  "spans": spans, "counters": merged, "card": card,
                  "peak_bytes_by_rank": [g["peak"] for g in got]}
    if trace:
        own = [s for s in spans if s.get("args", {}).get("rank", 0) == 0]
        dtr = reduce_trace(win, own, ptrace.TRACER._origin_ns)
        out.record["device_trace"] = dtr
        out.record["breakdown"] = dtr.pop("breakdown")
    return out


def _start(cfg: dict, seed: int, rank: int, device):
    return euler3d.init_bubble_cloud(int(cfg["n"]), cfg["cloud"], [seed, rank], device,
                                     p_ambient=cfg["p_ambient"], p_bubble=cfg["p_bubble"],
                                     rho_liquid=cfg["rho_liquid"], rho_gas=cfg["rho_gas"])


def _judge_rank(rank, root, cfg, job, dt, taken, qois, device) -> dict:
    """This rank's slab of every snapshot taken, replayed and judged."""
    eps, factor = float(cfg["spec"]["eps"]), float(cfg["guarantee"]["bound_factor"])
    n, bs, ranks = int(cfg["n"]), int(cfg["spec"]["block_size"]), job["ranks"]
    rank_nblocks = [(n // bs) ** 3] * ranks
    out = {"coef_gap": 0.0, "err_bound": 0.0, "replay_off": 0, "failed": 0, "lines": []}
    try:
        manifest = ref.read_manifest(str(root))
    except (OSError, ValueError, KeyError) as e:
        out["lines"].append(f"rank {rank}: manifest unreadable: {e}")
        manifest = {}
    U, at = _start(cfg, job["seed"], rank, device), -1
    for s, fp in taken:
        while at < s:
            U, at = euler3d.step(U, dt), at + 1
        fields = euler3d.qoi_fields(U, qois)
        out["replay_off"] += sum(a != b for a, b in zip(_fingerprints(fields).tolist(), fp))
        for q in qois:
            rec = next((r for r in manifest.get(q, []) if r["time"] == float(s)), None)
            if rec is None:
                out["failed"] += 1
                continue
            try:
                coeffs, _hdr = shared.read_rank(str(root / rec["file"]), rank, rank_nblocks,
                                                device)
            except (OSError, ValueError, KeyError) as e:
                out["lines"].append(f"rank {rank} step {s} {q}: {e}")
                out["failed"] += 1
                continue
            j = ref.judge_field(fields[q], coeffs, eps, factor)
            out["coef_gap"] = max(out["coef_gap"], j["coef_gap"])
            out["err_bound"] = max(out["err_bound"], j["err_bound"])
            del coeffs, j
        del fields
    return out


def _judge_all(root, cfg, got, taken, qois, out: bench.Run) -> dict:
    """Rank 0's judgement: every rank's numbers, the manifest's time tags,
    and each snapshot's layout against the bytes each rank wrote."""
    limits = cfg["check"]
    n = int(cfg["n"])
    for g in got:
        out.lines += g["judged"]["lines"]
        out.failed += g["judged"]["failed"]
    try:
        manifest = ref.read_manifest(str(root))
    except (OSError, ValueError, KeyError) as e:
        out.lines.append(f"manifest unreadable: {e}")
        manifest = {}
    want = [(i, float(s)) for i, (s, _fp) in enumerate(taken)]
    tags_off, offsets_off = 0, 0
    for q in qois:
        have = [(r["t"], r["time"]) for r in manifest.get(q, [])]
        tags_off += sum(a != b for a, b in zip(have, want)) + abs(len(have) - len(want))
        out.lines.append(f"{q} stored bytes by snapshot {[r['bytes'] for r in manifest.get(q, [])]}")
    for i, (s, _fp) in enumerate(taken):
        recs = [next((r for r in manifest.get(q, []) if r["time"] == float(s)), None)
                for q in qois]
        if None in recs:
            continue  # counted as failed by the ranks
        try:
            offsets_off += shared.offsets_off([str(root / r["file"]) for r in recs],
                                              [(n, n, n)] * len(got),
                                              [g["wrote"][i] for g in got])
        except (OSError, ValueError, KeyError) as e:
            out.lines.append(f"step {s}: layout unreadable: {e}")
            out.failed += 1
    out.lines.append(f"bytes written by rank, a snapshot: {[g['wrote'] for g in got]}")
    return {"coef_gap": (max(g["judged"]["coef_gap"] for g in got), limits["coef_gap"]),
            "err_bound": (max(g["judged"]["err_bound"] for g in got), limits["err_bound"]),
            "tags_off": (tags_off, limits["tags_off"]),
            "replay_off": (sum(g["judged"]["replay_off"] for g in got), limits["replay_off"]),
            "offsets_off": (offsets_off, limits["offsets_off"])}


def main(argv: list[str]) -> int:
    """A rank other than 0: ``JOB RANK``."""
    _watch_parent()
    job = json.loads(Path(argv[0]).read_text())
    _rank_main(int(argv[1]), job)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
