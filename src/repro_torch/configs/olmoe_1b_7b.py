"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
)
