"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]. Early-fusion frontend stubbed."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    shared_expert=True,
    notes="MoE top-1 routed + always-on shared expert (llama4 style)",
)
