"""In-situ loop: the solver advances on the card while the program's
``FieldSnapshotter`` compresses its QoIs every ``every`` steps.

Set-up (counted in ``setup_s``): the producer's state from the seed, a
fixed ``dt`` from its CFL condition, one warm-up step and one warm-up
snapshot at step 0 (which builds and loads the program's kernel).  The
window then starts at that snapshot boundary and ends at the first
snapshot that completes after ``seconds``: it holds whole cycles of
``every`` steps and one snapshot each.  ``insitu_mcell_s`` is the cells
advanced per second over the whole window, the snapshots in it.

Every snapshot taken, the warm-up's too, is judged once the window has
closed and the card's peak has been read, against the field handed in at
its step: the window keeps only each field's fingerprint (the sum of its
float32 words as integers), and the judgement replays the producer from
the seed with the same ``dt``, checks each replayed field against its
fingerprint, and hands it to the reference, which reads the dataset's
manifest and each member file itself (see ``reference/``).
"""
from __future__ import annotations

import time


from perfbench.harness import arith, bench
from perfbench.harness.devtrace import Window, reduce_trace
from perfbench.producers import euler3d
from perfbench.reference import cz_w3ai as ref

__all__ = ["run"]


def _start(cfg: dict, seed: int, device):
    return euler3d.init_bubble_cloud(int(cfg["n"]), cfg["cloud"], seed, device,
                                     p_ambient=cfg["p_ambient"], p_bubble=cfg["p_bubble"],
                                     rho_liquid=cfg["rho_liquid"], rho_gas=cfg["rho_gas"])


def _fingerprints(fields: dict):
    """Each field's float32 words summed as integers, on the field's device
    (exact, so a replay either matches it or does not)."""
    import torch

    return torch.stack([f.view(torch.int32).sum(dtype=torch.int64) for f in fields.values()])


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device: str) -> bench.Run:
    from repro_torch.ckpt import FieldSnapshotter
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.obs import trace as ptrace

    cfg, traffic = cell.config, cell.traffic
    n, every, qois = int(cfg["n"]), int(traffic["every"]), list(traffic["qois"])
    spec = CompressionSpec(**cfg["spec"])
    out = bench.Run()
    card = bench.power_limit() if device == "cuda" else device
    bench.reset_peak(device)

    U = _start(cfg, seed, device)
    dt = euler3d.cfl_dt(U, float(cfg["cfl"]))
    root = bench.data_dir(cell.name)
    snap = FieldSnapshotter(str(root), every=every, spec=spec, workers=int(cfg["workers"]),
                            device=device)
    taken = []   # (step, the fingerprints of the fields handed in)
    U = euler3d.step(U, dt)                   # warm-up step: state of step 0
    fields = euler3d.qoi_fields(U, qois)
    taken.append((0, _fingerprints(fields)))
    bench.sync(device)
    snap.maybe_snapshot(fields, 0)
    bench.sync(device)

    if trace:
        ptrace.reset()
        ptrace.enable()
    steps = 0
    counters0 = bench.program_counters()
    with Window(trace, device) as win:
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
            with win.span("snapshot"):
                snap.maybe_snapshot(fields, steps)
            if (time.perf_counter_ns() - win.t0_ns) / 1e9 >= seconds:
                break
        bench.sync(device)
        window_s = win.close()
    counters = bench.counter_deltas(counters0, bench.program_counters())
    spans = []
    if trace:
        ptrace.disable()
        spans = ptrace.TRACER.events()
    out.memory_peak_bytes = bench.peak_bytes(device)
    snap.close()
    del U, fields
    taken = [(s, fp.tolist()) for s, fp in taken]

    rate = arith.mcell_rate(n ** 3, steps, window_s)
    out.metrics = {"insitu_mcell_s": rate, "setup_s": setup_s}
    out.attempted = (len(taken) - 1) * len(qois)
    snap_spans = [(a, b) for name, a, b in win.spans if name == "snapshot"]
    snap_s = [(b - a) / 1e9 for a, b in snap_spans]
    out.lines += [
        f"card {card}",
        f"window {window_s!r} s, {steps} steps of dt {dt!r}, {len(snap_s)} snapshots",
        f"snapshot s {[round(s, 4) for s in snap_s]}",
        f"solver and snapshot s {window_s - sum(snap_s)!r} {sum(snap_s)!r}",
        f"snapshot share {100 * sum(snap_s) / window_s!r} %",
        f"insitu_mcell_s {rate!r}; setup_s {setup_s!r}",
    ]

    # -- the judgement, once the window has closed and the state is freed --
    t_check = time.perf_counter()
    out.checks = _judge(root, cfg, seed, dt, every, taken, qois, device, out)
    out.lines.append(f"reference check {time.perf_counter() - t_check:.2f} s over "
                     f"{len(taken)} snapshots x {len(qois)} QoIs (the replay with it)")
    out.record = {"window_s": window_s, "steps": steps, "every": every, "qois": qois,
                  "n": n, "block_size": spec.block_size, "snapshots": len(snap_s),
                  "harness_spans": [{"name": "snapshot", "t0_ns": a, "t1_ns": b}
                                    for a, b in snap_spans],
                  "spans": spans, "counters": counters, "card": card}
    if trace:
        dtr = reduce_trace(win, spans, ptrace.TRACER._origin_ns)
        out.record["device_trace"] = dtr
        out.record["breakdown"] = dtr.pop("breakdown")
    return out


def _judge(root, cfg, seed, dt, every, taken, qois, device, out: bench.Run) -> dict:
    eps, factor = float(cfg["spec"]["eps"]), float(cfg["guarantee"]["bound_factor"])
    limits = cfg["check"]
    try:
        manifest = ref.read_manifest(str(root))
    except (OSError, ValueError, KeyError) as e:
        out.lines.append(f"manifest unreadable: {e}")
        manifest = {}
    want = [(i, float(s)) for i, (s, _fp) in enumerate(taken)]
    tags_off, coef_gap, err_bound, replay_off = 0, 0.0, 0.0, 0
    for q in qois:
        have = [(r["t"], r["time"]) for r in manifest.get(q, [])]
        tags_off += sum(a != b for a, b in zip(have, want)) + abs(len(have) - len(want))
        out.lines.append(f"{q} stored bytes by snapshot {[r['bytes'] for r in manifest.get(q, [])]}")
    U, at = _start(cfg, seed, device), -1
    for s, fp in taken:
        while at < s:
            U, at = euler3d.step(U, dt), at + 1
        fields = euler3d.qoi_fields(U, qois)
        replay_off += sum(a != b for a, b in zip(_fingerprints(fields).tolist(), fp))
        for q in qois:
            rec = next((r for r in manifest.get(q, []) if r["time"] == float(s)), None)
            if rec is None:
                out.failed += 1
                continue
            try:
                coeffs, _hdr = ref.read_cz(str(root / rec["file"]), device)
            except (OSError, ValueError, KeyError) as e:
                out.lines.append(f"step {s} {q}: {e}")
                out.failed += 1
                continue
            j = ref.judge_field(fields[q], coeffs, eps, factor)
            coef_gap = max(coef_gap, j["coef_gap"])
            err_bound = max(err_bound, j["err_bound"])
            del coeffs, j
        last = {q: (float(f.min()), float(f.max())) for q, f in fields.items()}
        del fields
    if taken:
        out.lines.append(f"step {taken[-1][0]} (min, max) by QoI {last}")
    return {"coef_gap": (coef_gap, limits["coef_gap"]),
            "err_bound": (err_bound, limits["err_bound"]),
            "tags_off": (tags_off, limits["tags_off"]),
            "replay_off": (replay_off, limits["replay_off"])}
