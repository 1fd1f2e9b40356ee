"""AdamW with global-norm clipping and cosine LR schedule (port of
``repro.train.optim``), over the port's nested-dict trees.

Every quantity the reference computes in float32 is a float32 tensor here
too: the schedule, ``b1 ** t`` and ``b2 ** t`` are tensor ops on the step,
and a Python constant meets a float32 tensor rounded to float32, as a
weakly typed constant does in jnp.  The schedule follows the reference's
jitted step, where XLA turns each division by a constant into a product
and fuses a multiply-add.  m and v are float32 whatever the
parameters' dtype; ``step`` is a 0-d int32 tensor.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_map

__all__ = ["OptConfig", "init_opt_state", "adamw_step", "lr_at"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _recip(d: int) -> float:
    """1/d rounded to float32: XLA compiles a division by a constant into a
    product with the constant's float32 reciprocal, and so does the
    reference's jitted step."""
    return float(np.float32(1) / np.float32(d))


def lr_at(cfg: OptConfig, step):
    """The learning rate at ``step`` (an int or an integer tensor) as a 0-d
    float32 tensor: linear warm-up, then cosine decay to ``min_lr_frac``."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.tensor(float(step), dtype=torch.float32)
    warm = cfg.lr * torch.clamp((step + 1) * _recip(max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    * _recip(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    # min_lr_frac + (1 - min_lr_frac) * 0.5 * (1 + cos(pi t)), the multiply-add
    # fused as XLA's CPU backend fuses it: one rounding, from float64 (the
    # product of two float32 values is exact there)
    half = float(np.float32((1 - cfg.min_lr_frac) * 0.5))
    cos = ((1 + torch.cos(math.pi * t)).double() * half
           + float(np.float32(cfg.min_lr_frac))).float()
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params):
    """m and v as float32 zeros beside every leaf, and step 0 (int32) on
    the parameters' device."""
    dev = next(tree_leaves(params))[1].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(tree):
    total = None
    for _, g in tree_leaves(tree):
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _unzip(tree, i):
    """The ``i``-th of the tuples at a dict tree's leaves."""
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return tree[i]


def adamw_step(params, grads, opt_state, cfg: OptConfig):
    """Returns (new_params, new_opt_state, metrics).  New tensors; the
    inputs are left as they are."""
    return adamw_update(params, grads, opt_state, cfg, _global_norm(grads))


def adamw_update(params, grads, opt_state, cfg: OptConfig, gnorm):
    """:func:`adamw_step` with the grads' global norm given: a sharded step
    passes the norm over every rank's blocks, and updates its blocks."""
    step = opt_state["step"]
    # a tensor numerator: torch computes ``scalar / tensor`` as a reciprocal
    # times the scalar, two roundings where jnp divides once
    clip = torch.full_like(gnorm, cfg.clip_norm)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    grads = tree_map(lambda g: (g * scale).to(g.dtype), grads)

    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).to(torch.float32)
    lr = lr_at(cfg, step)
    c1 = 1 - b1 ** t
    c2 = 1 - b2 ** t

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * g32 * g32
        mh = m2 / c1
        vh = v2 / c2
        p2 = p - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p)
        return p2.to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_state = {"m": _unzip(out, 1), "v": _unzip(out, 2), "step": step + 1}
    return _unzip(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}
