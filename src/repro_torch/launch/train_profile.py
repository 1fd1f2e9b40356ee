"""Where a train step's time goes: ``train_step`` timed per batch size, and
one step under ``torch.profiler``.

For each batch size in ``--batches``: one step to warm up, then
``--steps`` synchronized steps of ``build_train_step``'s ``train_step`` on a
1x1 mesh at ``ModelSettings()``'s defaults, on ``batch_at``'s data.  Then one more
step of the last batch size runs under the profiler, which counts the host's kernel launches
(``cudaLaunchKernel`` calls), the kernels and their summed device time;
the device's busy share is that time over the median unprofiled step of
the same batch size (the profiler slows the host several fold).  Prints
one JSON object; ``--out DIR`` also writes the profiler's tables, by
device and by host time, to ``DIR/train_profile.txt``.

On a machine with the card::

    PYTHONPATH=src python -m repro_torch.launch.train_profile --seq 4096

``--device cpu --reduced --seq 32`` runs it on the CPU (no device time).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.schemes import torch_device
from repro_torch.data.tokens import DataConfig, batch_at
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ModelSettings
from repro_torch.train.optim import OptConfig
from repro_torch.train.step import build_train_step, init_train_state

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile_step(step, state, batch, dev):
    """(state, profile summary, profiler) of one step under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        _sync(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launches = sum(1 for e in prof.events() if e.name in LAUNCH_CALLS)
    device_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    return state, {"profiled_wall_s": wall, "kernels": len(kernels),
                   "launch_calls": launches, "device_s": device_s}, prof


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batches", default="1,4", help="comma-separated batch sizes")
    ap.add_argument("--steps", type=int, default=2, help="timed steps per batch size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    dev = torch_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh = make_mesh((1, 1), ("data", "model"), device=dev)
    step, _, _ = build_train_step(cfg, mesh, settings=ModelSettings(),
                                  opt=OptConfig(lr=1e-3, warmup_steps=20, total_steps=100))
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    result = {"arch": cfg.name, "seq": args.seq, "settings": "ModelSettings() defaults",
              "ms_per_step": {}}
    for b in map(int, args.batches.split(",")):
        data = DataConfig(vocab=cfg.vocab, batch=b, seq=args.seq, seed=0)
        ms = []
        for i in range(1 + args.steps):
            batch = {k: torch.from_numpy(v) for k, v in batch_at(data, i).items()}
            _sync(dev)
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        result["ms_per_step"][b] = ms
    warm_ms = statistics.median(ms[1:])
    state, summary, prof = _profile_step(step, state, batch, dev)
    result["profile"] = {"batch": b, **summary, "warm_ms": warm_ms,
                         "busy_share": summary["device_s"] / (warm_ms / 1e3)}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        table = prof.key_averages()
        with open(os.path.join(args.out, "train_profile.txt"), "w") as f:
            f.write(table.table(sort_by="self_cuda_time_total", row_limit=30))
            f.write(table.table(sort_by="self_cpu_time_total", row_limit=30))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
