"""Mixture-of-Experts FFN: GShard-style grouped dispatch with capacity
(port of ``repro.models.moe``).

Tokens are processed in groups of ``cfg.moe_group``; per group each token's
top-k experts get a capacity slot (rank = order within the group, tokens
over capacity are dropped — combine weight 0).  Dispatch and combine are
dense einsums with static shapes, as in the reference.

Aux losses (load-balance + router z-loss) are returned for the train loss.
"""
from __future__ import annotations

import torch

from .common import gelu, swiglu_act

__all__ = ["moe_ffn", "dense_ffn"]


def dense_ffn(x, p, cfg):
    if cfg.act == "swiglu":
        h = swiglu_act(torch.einsum("...d,df->...f", x, p["w1"]),
                       torch.einsum("...d,df->...f", x, p["w3"]))
    else:
        h = gelu(torch.einsum("...d,df->...f", x, p["w1"]))
    return torch.einsum("...f,fd->...d", h, p["w2"])


def _expert_ffn(xin, p, cfg):
    """xin (E, N, D) -> (E, N, D), expert weights stacked on axis 0."""
    if cfg.act == "swiglu":
        h = swiglu_act(torch.einsum("end,edf->enf", xin, p["we1"]),
                       torch.einsum("end,edf->enf", xin, p["we3"]))
    else:
        h = gelu(torch.einsum("end,edf->enf", xin, p["we1"]))
    return torch.einsum("enf,efd->end", h, p["we2"])


def _one_hot(idx, n: int):
    """``F.one_hot(idx, n).float()`` as one comparison: the same ops on
    every tensor (``F.one_hot`` reads the indices' range back to the host
    first, except on fake tensors), so a counted dry run sees the ops the
    card runs."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x, p, cfg):
    """x (B, S, D) -> (out (B, S, D), aux_losses dict)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    g = min(cfg.moe_group, B * S)
    N = B * S
    G = N // g
    assert N % g == 0, f"tokens {N} not divisible by moe group {g}"
    C = max(4, -(-g * K * int(cfg.capacity_factor * 100) // 100 // E))

    xg = x.reshape(G, g, D)
    logits = torch.einsum("gnd,de->gne", xg, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, K)                                # (G,g,K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    onehot = _one_hot(top_e, E)                                   # (G,g,K,E)
    # rank of each assignment within its expert (priority: token order, then k)
    flat = onehot.reshape(G, g * K, E)
    rank = torch.cumsum(flat, dim=1) - flat                       # exclusive
    keep = (rank < C) * flat                                      # (G,gK,E)
    rank = torch.where(keep > 0, rank, 0.0)
    pos_oh = _one_hot(rank.long(), C) * keep[..., None]
    # (G, gK, E, C) -> fold k back onto tokens
    pos_oh = pos_oh.reshape(G, g, K, E, C)
    combine = (pos_oh * top_p[..., None, None]).sum(2)            # (G,g,E,C)
    dispatch = (pos_oh.sum(2) > 0).to(x.dtype)                    # (G,g,E,C)

    expert_in = torch.einsum("gnec,gnd->gecd", dispatch, xg)      # (G,E,C,D)
    ein = expert_in.permute(1, 0, 2, 3).reshape(E, G * C, D)
    eout = _expert_ffn(ein, p, cfg)
    eout = eout.reshape(E, G, C, D).permute(1, 0, 2, 3)           # (G,E,C,D)
    out = torch.einsum("gecd,gnec->gnd", eout, combine.to(x.dtype))

    if cfg.shared_expert:
        out = out + dense_ffn(x, {"w1": p["ws1"], "w3": p["ws3"], "w2": p["ws2"]},
                              cfg).reshape(G, g, D)

    # aux losses (Switch/GShard style)
    density = flat.reshape(G, g, K, E).sum(2).mean(1)             # (G,E) token fraction
    mean_prob = probs.mean(1)                                     # (G,E)
    lb = (density * mean_prob).sum(-1).mean() * (E ** 2) / K
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    dropped = 1.0 - (keep.sum() / torch.clamp(flat.sum(), min=1.0))
    aux = {"load_balance": lb, "router_z": z, "drop_fraction": dropped}
    return out.reshape(B, S, D), aux
