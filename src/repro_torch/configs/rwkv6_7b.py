"""rwkv6-7b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # wkv heads of dim 64
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    ssm_kind="rwkv6",
    notes="linear recurrence; decode state is O(1) -> long_500k runs",
)
