"""End-to-end training driver with fault tolerance (port of
``repro.launch.train``).

Runs on the card by default (``--device cuda``); ``--device cpu --reduced``
(a tiny same-family config) runs anywhere.  The step is the mesh step's
``jit_for`` on a 1x1 ("data", "model") mesh, as the reference driver's.
Deterministic resumable data, compressed checkpoints (fpzipx) with atomic
commit and retention, auto-resume from the latest, preemption (SIGTERM)
checkpointing, a straggler watchdog, and fault injection for tests
(``--fail-at-step``).
Its lines are the reference driver's.

    python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 200 --ckpt-dir /tmp/ck --ckpt-every 50
    # kill it mid-run, re-run the same command -> resumes from the latest step
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.ckpt import Checkpointer
from repro_torch.configs import ARCHS, reduced as reduce_cfg
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.core.schemes import torch_device
from repro_torch.data.tokens import DataConfig, batch_at
from repro_torch.dist.fault import PreemptionHandler, StragglerWatchdog
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ModelSettings
from repro_torch.train.optim import OptConfig
from repro_torch.train.step import build_train_step, init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-scheme", default="fpzipx",
                    help="checkpoint codec: fpzipx|wavelet|szx|raw")
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--fail-at-step", type=int, default=0,
                    help="fault injection: hard-exit at this step (tests)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--data-branching", type=int, default=8)
    ap.add_argument("--data-regimes", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    dev = torch_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_cfg(cfg)
    st = ModelSettings(q_chunk=32, kv_chunk=64, ce_chunk=64, remat="none",
                       compute_dtype=torch.float32)
    opt = OptConfig(lr=args.lr, warmup_steps=20, total_steps=max(args.steps, 100))
    mesh = make_mesh((1, 1), ("data", "model"), device=dev)

    data_cfg = DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                          seed=args.seed, branching=args.data_branching,
                          n_regimes=args.data_regimes)

    _, jit_for, _ = build_train_step(cfg, mesh, settings=st, opt=opt, donate=True)
    batch0 = {k: torch.from_numpy(v) for k, v in batch_at(data_cfg, 0).items()}
    frames = None
    if cfg.family == "encdec":
        rng = np.random.default_rng(0)
        frames = torch.from_numpy(
            rng.standard_normal((args.batch, cfg.enc_frames, cfg.d_model))
            .astype(np.float32)).to(dev)
        batch0["frames"] = frames
    train_step = jit_for(batch0)

    # --- state init or resume -------------------------------------------
    ckpt = None
    start_step = 0
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                             device=dev)
    if args.ckpt_dir:
        spec = (CompressionSpec(scheme=args.ckpt_scheme, precision=32,
                                block_size=16, shuffle="byte")
                if args.ckpt_scheme != "raw" else CompressionSpec(scheme="raw"))
        ckpt = Checkpointer(args.ckpt_dir, every=args.ckpt_every, spec=spec, device=dev)
        restored, rstep = ckpt.resume(state) if args.resume else (None, None)
        if restored is not None:
            state = restored
            start_step = int(rstep)
            print(f"[resume] from step {start_step}")

    preempt = PreemptionHandler()
    watchdog = StragglerWatchdog()
    losses = []

    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v) for k, v in batch_at(data_cfg, step).items()}
        if frames is not None:
            batch["frames"] = frames
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        rep = watchdog.observe(step, time.time() - t0)
        if rep.action != "ok":
            print(f"[straggler] step {step}: {rep.step_time:.2f}s "
                  f"({rep.ratio:.1f}x median) -> {rep.action}")
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.time()-t0:.2f}s)")
        if ckpt:
            m = ckpt.maybe_save(state, step + 1)
            if m:
                print(f"[ckpt] step {step+1} CR={m['cr']:.2f}")
        if args.fail_at_step and step + 1 == args.fail_at_step:
            print(f"[fault-injection] hard exit at step {step+1}")
            sys.exit(17)
        if preempt.preempted:
            if ckpt:
                ckpt.maybe_save(state, step + 1, force=True)
                print(f"[preempt] checkpointed step {step+1}, exiting")
            sys.exit(0)

    if ckpt:
        ckpt.maybe_save(state, args.steps, force=True)
    first = float(np.mean(losses[:5])) if len(losses) >= 5 else losses[0]
    last = float(np.mean(losses[-5:]))
    print(f"done: loss {first:.4f} -> {last:.4f} over {len(losses)} steps")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"losses": losses, "first": first, "last": last,
                       "steps": len(losses)}, f)
    return first, last


if __name__ == "__main__":
    main()
