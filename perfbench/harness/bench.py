"""One run of one cell: find the cell's files by name, run its driver,
judge its outputs, read its metrics, and print one result line.

Everything a cell needs is found through ``BENCHMARK.json`` at the root of
the checkout: the workload names a configuration (``configs/<file>``) and
a traffic mix (``traffic/<traffic>.json``, whose ``driver`` names the loop
in ``harness/drivers/``), and each per-layer metric is read by
``metrics/<name>.py``'s ``read(record)``, which returns ``None`` where it
finds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / "perfbench"
#: top-level module names that no run may load: the JAX stack and the
#: package the port was made from, and the repository's older benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")

__all__ = ["Cell", "Run", "load_cell", "run_cell", "forbidden_modules", "result_line"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclass
class Run:
    """What a driver hands back: the counts, the end-to-end numbers, the
    checks (name -> (value, limit)), the record the per-layer readers
    read, and the lines of host timings printed before the result."""
    attempted: int = 0
    failed: int = 0
    metrics: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)
    record: dict = field(default_factory=dict)
    lines: list = field(default_factory=list)
    memory_peak_bytes: int = 0


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell named ``workload`` with its configuration, traffic and the
    metrics it reports, from ``BENCHMARK.json``."""
    if bench is None:
        with open(ROOT / "BENCHMARK.json") as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(PERFBENCH / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)

    def here(m: dict) -> bool:
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (Linux's ``/proc``), else since
    the harness was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def data_dir(name: str) -> Path:
    """A run's scratch directory under ``TMPDIR`` at a fixed name, emptied
    first: every run writes its files over the same paths.  Without
    ``TMPDIR`` there is no place of the run's own to write: an error."""
    tmp = os.environ.get("TMPDIR")
    if not tmp:
        raise RuntimeError("TMPDIR is not set: the benchmark writes only under it")
    base = Path(tmp) / "perfbench" / name
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    return base


def program_counters() -> dict:
    """Every counter of the program's registry now, one entry per label set
    (``name{k=v,...}``, or the bare name for a counter without labels)."""
    from repro_torch import obs

    out = {}
    for metric in obs.REGISTRY:
        if not isinstance(metric, obs.Counter):
            continue
        for labels, value in metric.samples():
            tag = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            out[f"{metric.name}{{{tag}}}" if tag else metric.name] = value
    return out


def counter_deltas(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def sync(device: str) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def reset_peak(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device: str) -> int:
    """The card's peak of allocated bytes since :func:`reset_peak`."""
    if device != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  PERFBENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, bench: dict | None = None) -> dict:
    """Run one cell once and return its result (the dict the result line
    prints).  ``overrides`` replaces keys of the configuration (the tests'
    small sizes); ``device`` is where the producer, the program and the
    reference run (the command line always asks for ``"cuda"``)."""
    cell = load_cell(workload, bench)
    if overrides:
        cell.config = {**cell.config, **overrides}
    driver = importlib.import_module(f"perfbench.harness.drivers.{cell.traffic['driver']}")
    run: Run = driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = _reader(m["name"])(run.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run.metrics[m["name"]], "unit": m["unit"]}
    correct = run.failed == 0 and all(_passes(v, lim) for v, lim in run.checks.values())
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": _device_name(device), "count": cell.chips,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if trace:
        dt = run.record.get("device_trace", {})
        dev["busy_s"] = dt.get("busy_s", 0.0)
        dev["window_s"] = dt.get("window_s", run.record.get("window_s", 0.0))
    out = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace and run.record.get("breakdown"):
        out["breakdown"] = run.record["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    out["_lines"] = run.lines
    out["_record"] = run.record
    return out


def _passes(value: float, limit: float) -> bool:
    return value is not None and value == value and value <= limit


def _device_name(device: str) -> str:
    if device == "cuda":
        import torch

        return torch.cuda.get_device_name(0)
    return device


def result_line(out: dict) -> str:
    return json.dumps({k: v for k, v in out.items() if not k.startswith("_")})


def check_lines(out: dict) -> list[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in out["checks"].items()]


def save_record(out: dict, workload: str, seed: int, trace: bool) -> Path:
    """The run's host timings and record, under ``build/perfbench/records``
    in the checkout."""
    d = ROOT / "build" / "perfbench" / "records"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{workload}.s{seed}.t{int(trace)}.json"
    rec = {k: v for k, v in out["_record"].items() if k != "spans"}
    with open(path, "w") as f:
        json.dump({"result": json.loads(result_line(out)), "lines": out["_lines"],
                   "record": rec}, f, default=str)
    return path
