"""qwen3-32b — dense GQA with qk-norm [hf:Qwen/Qwen3]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    head_dim=128,
)
