"""Ex-situ loop: the program's CZ tool writes each QoI of one snapshot to
its own file and reads it back onto the card, a closed loop, the QoIs in an
order drawn from the seed.

Set-up (counted in ``setup_s``): the snapshot's fields on the card, and one
warm-up write and read of the traffic's ``warm_qoi``.  The window counts
whole cycles of every QoI, at least one, and ends at the first cycle to
complete after ``seconds``; each cycle writes over the same paths.

``cr`` is the QoIs' raw bytes over their files' bytes in a cycle (every
cycle's files must be the same bytes), ``psnr_db`` the mean over the QoIs
of Eq. (1)'s PSNR of what ``read_field`` gave back against the field
written.  Once the window has closed, the reference decodes each QoI's
file of the last cycle itself and holds it, and what ``read_field`` gave,
to the field written.
"""
from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from perfbench.harness import arith, bench
from perfbench.harness.devtrace import Window, reduce_trace
from perfbench.producers import cavitation
from perfbench.reference import cz_w3ai as ref

__all__ = ["run"]


def _crc(path) -> int:
    with open(path, "rb") as f:
        return zlib.crc32(f.read()) & 0xFFFFFFFF


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device: str) -> bench.Run:
    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.obs import trace as ptrace

    cfg, traffic = cell.config, cell.traffic
    spec = CompressionSpec(**cfg["spec"])
    workers = int(cfg["workers"])
    out = bench.Run()
    card = bench.power_limit() if device == "cuda" else device
    bench.reset_peak(device)

    fields = cavitation.cavitation_fields(cfg["cloud"], float(traffic["t_us"]), seed, device)
    qois = list(traffic["qois"])
    order = [qois[i] for i in np.random.default_rng(seed).permutation(len(qois))]
    root = bench.data_dir(cell.name)
    paths = {q: root / f"{q}.cz" for q in qois}

    def op(q: str, win: Window):
        t0 = time.perf_counter()
        with win.span("write"):
            nbytes = container.write_field(str(paths[q]), fields[q], spec, workers=workers,
                                           device=device)
        t1 = time.perf_counter()
        with win.span("read"):
            back = torch.from_numpy(container.read_field(str(paths[q]), device=device)).to(device)
            bench.sync(device)
        return nbytes, back, t1 - t0, time.perf_counter() - t1

    op(traffic["warm_qoi"], Window(False, device))   # warm-up: one write and read back
    if trace:
        ptrace.reset()
        ptrace.enable()
    counters0 = bench.program_counters()
    cycles, outs, ops = 0, {}, []
    with Window(trace, device) as win:
        setup_s = bench.process_age_s()
        while True:
            for q in order:
                try:
                    nbytes, outs[q], w_s, r_s = op(q, win)
                except (OSError, ValueError, RuntimeError) as e:
                    out.failed += 1
                    out.lines.append(f"cycle {cycles} {q}: {e!r}")
                    break
                ops.append({"cycle": cycles, "qoi": q, "bytes": int(nbytes),
                            "crc": _crc(paths[q]), "write_s": w_s, "read_s": r_s})
            else:
                cycles += 1
                if (time.perf_counter_ns() - win.t0_ns) / 1e9 >= seconds:
                    break
                continue
            break
        window_s = win.close()
    counters = bench.counter_deltas(counters0, bench.program_counters())
    spans = []
    if trace:
        ptrace.disable()
        spans = ptrace.TRACER.events()
    out.attempted = len(ops) + out.failed
    out.memory_peak_bytes = bench.peak_bytes(device)

    first = {o["qoi"]: o for o in ops if o["cycle"] == 0}
    cycle_off = sum((o["bytes"], o["crc"]) != (first[o["qoi"]]["bytes"], first[o["qoi"]]["crc"])
                    for o in ops if o["qoi"] in first)
    raw = sum(fields[q].numel() * 4 for q in first)
    stored = sum(o["bytes"] for o in first.values())
    cr = arith.compression_ratio(raw, stored) if cycles else float("nan")
    out.lines += [f"card {card}",
                  f"window {window_s!r} s, {cycles} cycles of {order}"]
    for q in qois:
        mine = [o for o in ops if o["qoi"] == q]
        if mine:
            out.lines.append(
                f"{q}: {mine[0]['bytes']} B, CR {fields[q].numel() * 4 / mine[0]['bytes']!r}, "
                f"write s {[round(o['write_s'], 4) for o in mine]}, "
                f"read s {[round(o['read_s'], 4) for o in mine]}")

    # -- the judgement, once the window has closed --
    eps, factor = float(cfg["spec"]["eps"]), float(cfg["guarantee"]["bound_factor"])
    coef_gap = err_bound = read_gap = 0.0
    psnrs = []
    t_check = time.perf_counter()
    for q in qois:
        if q not in outs:
            out.failed += 1
            continue
        x, back = fields[q], outs[q]
        diff = back.double() - x.double()
        psnrs.append(arith.psnr_eq1(float(x.max()) - float(x.min()), float((diff * diff).mean())))
        del diff
        try:
            coeffs, _hdr = ref.read_cz(str(paths[q]), device)
        except (OSError, ValueError, KeyError) as e:
            out.lines.append(f"{q}: {e}")
            out.failed += 1
            continue
        j = ref.judge_field(x, coeffs, eps, factor)
        coef_gap = max(coef_gap, j["coef_gap"])
        err_bound = max(err_bound, j["err_bound"])
        read_gap = max(read_gap, float((back - j["decoded"]).abs().max()) / eps)
        del coeffs, j
    psnr = sum(psnrs) / len(psnrs) if psnrs else float("nan")
    out.lines.append(f"reference check {time.perf_counter() - t_check:.2f} s; "
                     f"psnr by QoI {dict(zip([q for q in qois if q in outs], psnrs))}")
    out.lines.append(f"cr {cr!r}; psnr_db {psnr!r}; setup_s {setup_s!r}")
    limits = cfg["check"]
    out.checks = {"coef_gap": (coef_gap, limits["coef_gap"]),
                  "err_bound": (err_bound, limits["err_bound"]),
                  "read_gap": (read_gap, limits["read_gap"]),
                  "cycle_bytes_off": (cycle_off, limits["cycle_bytes_off"])}
    out.metrics = {"cr": cr, "psnr_db": psnr, "setup_s": setup_s}
    out.record = {"window_s": window_s, "cycles": cycles, "order": order, "ops": ops,
                  "counters": counters, "spans": spans, "card": card}
    if trace:
        dtr = reduce_trace(win, spans, ptrace.TRACER._origin_ns)
        out.record["device_trace"] = dtr
        out.record["breakdown"] = dtr.pop("breakdown")
    return out
