"""chameleon-34b — early-fusion VLM backbone [arXiv:2405.09818].

Dense decoder; the VQ image tokenizer is a stub (image tokens are ordinary
ids inside the 65536 vocab, per the assignment: frontend provides token ids).
Chameleon uses qk-norm for training stability — enabled here.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    rope_theta=1e4,
    notes="early-fusion VQ image tokens enter as vocab ids (frontend stubbed)",
)
