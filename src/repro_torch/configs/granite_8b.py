"""granite-8b — llama-arch dense code model [arXiv:2405.04324]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
)
