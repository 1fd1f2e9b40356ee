"""whisper-small — encoder-decoder ASR backbone [arXiv:2212.04356].

The conv audio frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, frames, d_model).  Positions are sinusoidal
on both sides (whisper uses sinusoidal encoder / learned decoder positions;
we use sinusoidal everywhere so parameter shapes are independent of the
assigned synthetic sequence lengths — noted in DESIGN.md)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    encoder_layers=12,
    enc_frames=1500,
    act="gelu",
)
