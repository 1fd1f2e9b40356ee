"""Analytic FLOPs accounting per (arch x shape) — the roofline's yardstick
(a copy of ``repro.models.costs`` over the port's configs).

``model_flops`` implements the assignment formula (6*N*tokens for train with
N = active non-embedding params; 2*N*tokens for decode).  ``detailed_flops``
adds the attention quadratic term and the train multiplier (fwd + 2x bwd +
remat recompute), giving the "useful compute" that the loop-aware HLO FLOPs
are compared against: HLO/useful > 1 means redundant compute (masked-causal
waste, replicated attention on unshardable head counts, remat).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig

__all__ = ["model_flops", "detailed_flops", "matmul_params"]


def matmul_params(cfg: ArchConfig, active: bool = True) -> int:
    """Active parameters that participate in matmuls (excludes the embedding
    gather; the LM head counts, tied or not, since it is a matmul)."""
    from repro_torch.models import count_params

    n = count_params(cfg, active_only=active)
    n -= cfg.vocab * cfg.d_model          # embedding gather
    if cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model      # tied head still does the matmul
    return n


def _tokens(cfg: ArchConfig, shape: ShapeConfig) -> int:
    if shape.kind == "decode":
        return shape.global_batch          # one new token per sequence
    return shape.global_batch * shape.seq_len


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Assignment MODEL_FLOPS: 6*N*tokens (train), 2*N*tokens (inference)."""
    n = matmul_params(cfg)
    t = _tokens(cfg, shape)
    if shape.kind == "train":
        return 6.0 * n * t
    return 2.0 * n * t


def _attention_flops_fwd(cfg: ArchConfig, shape: ShapeConfig,
                         masked_full: bool) -> float:
    """QK^T + AV flops, global, forward, per full model."""
    B, S = shape.global_batch, shape.seq_len
    Hhd = cfg.n_heads * cfg.hd
    if cfg.family == "ssm":
        # rwkv6 wkv state update+readout: ~4 flops per state element per token
        return 4.0 * B * S * cfg.d_model * cfg.hd * 1.0
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // cfg.attn_period
    if shape.kind == "decode":
        flops = 4.0 * B * Hhd * S * n_attn_layers
        if cfg.family == "hybrid":
            # + mamba state update per non-attn layer
            nm = cfg.n_layers - n_attn_layers
            flops += 6.0 * B * cfg.ssm_expand * cfg.d_model * cfg.d_state * nm
        return flops
    causal_factor = 1.0 if masked_full else 0.5
    flops = 4.0 * B * S * S * Hhd * n_attn_layers * causal_factor
    if cfg.family == "hybrid":
        nm = cfg.n_layers - n_attn_layers
        flops += 6.0 * B * S * cfg.ssm_expand * cfg.d_model * cfg.d_state * nm
    if cfg.family == "encdec":
        F = cfg.enc_frames
        flops += 4.0 * B * F * F * Hhd * cfg.encoder_layers      # encoder self
        flops += 4.0 * B * S * F * Hhd * cfg.n_layers            # cross
    return flops


def detailed_flops(cfg: ArchConfig, shape: ShapeConfig, *,
                   attn_impl: str = "masked", remat: str = "full") -> dict:
    """Global (all-device) flops decomposition."""
    t = _tokens(cfg, shape)
    n = matmul_params(cfg)
    matmul_fwd = 2.0 * n * t
    attn_fwd = _attention_flops_fwd(cfg, shape, masked_full=(attn_impl == "masked"))
    fwd = matmul_fwd + attn_fwd
    if shape.kind == "train":
        mult = 3.0 + (1.0 if remat == "full" else 0.0)   # fwd + 2 bwd (+ remat)
        total = fwd * mult
    else:
        total = fwd
    return {
        "matmul_fwd": matmul_fwd,
        "attn_fwd": attn_fwd,
        "fwd": fwd,
        "total": total,
        "model_flops": model_flops(cfg, shape),
    }
