"""Batched serving driver: prefill a batch of prompts, then decode tokens
(port of ``repro.launch.serve``).

Runs on the card by default (``--device cuda``); ``--device cpu --reduced``
runs here.  Random weights from a ``torch.Generator`` seeded with
``--seed``; the prompt is the reference's (numpy, the same seed).  The
decoder steps over the prompt to fill the cache, then decodes greedily.

    python -m repro_torch.launch.serve --device cpu --reduced
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced as reduce_cfg
from repro_torch.core.schemes import torch_device
from repro_torch.models import ModelSettings, cache_spec, decode_step, init_params

#: the reference driver's settings: small chunks, no remat, float32
SETTINGS = ModelSettings(q_chunk=16, kv_chunk=16, remat="none",
                         compute_dtype=torch.float32)


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor      # (B, max_new) int32, the greedy continuation
    logits: torch.Tensor      # (B, 1, V) float32, the last step's
    cache: dict               # the filled decode cache
    seconds: float            # prompt_len + max_new decode steps, synchronized


def generate(params, cfg, prompt: torch.Tensor, max_new: int) -> Generation:
    """Step the decoder over ``prompt`` (B, P) on ``params``' device, then
    decode ``max_new`` tokens greedily (``argmax``: the first maximum)."""
    dev = params["embed"].device
    B, P = prompt.shape
    cache = cache_spec(cfg, B, P + max_new, dtype=torch.float32, mode="zeros", device=dev)
    prompt = prompt.to(dev)
    t0 = time.perf_counter()
    for i in range(P):
        logits, cache = decode_step(params, cache, prompt[:, i:i + 1], i, cfg, SETTINGS)
    generated = []
    for i in range(max_new):
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        generated.append(nxt)
        logits, cache = decode_step(params, cache, nxt, P + i, cfg, SETTINGS)
    out = torch.cat(generated, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return Generation(out, logits, cache, time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    dev = torch_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_cfg(cfg)
    B = args.batch
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, args.prompt_len)).astype(np.int32))
    with torch.inference_mode():
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                             device=dev)
        gen = generate(params, cfg, prompt, args.max_new)
    out = gen.tokens.cpu().numpy()
    toks = B * (args.prompt_len + args.max_new)
    dt = gen.seconds
    print(f"decoded {tuple(out.shape)} in {dt:.2f}s ({toks/dt:.1f} tok/s incl. prefill)")
    print("sample:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
