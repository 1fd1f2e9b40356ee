"""jamba-v0.1-52b — hybrid Mamba+attention 1:7, MoE 16e top-2 every other
layer [arXiv:2403.19887]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_period=2,
    ssm_kind="mamba",
    attn_period=8,       # 1 attention layer per 8 (1:7 mamba:attn interleave)
    d_state=16,
    notes="decode: O(1) mamba state + KV cache on 4 attn layers -> long_500k runs",
)
