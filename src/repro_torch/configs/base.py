"""Architecture + input-shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; the four assigned
input shapes are ``ShapeConfig``s.  ``reduced()`` produces the CPU-smoke-test
variant of an architecture (same family/topology, tiny dims).  A copy of
``repro.configs.base``; the parameter counts come from the port's models.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False         # qwen2.5
    qk_norm: bool = False          # qwen3
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False    # llama4-style always-on expert
    moe_period: int = 1            # MoE every `moe_period` layers (jamba: 2)
    capacity_factor: float = 1.25
    moe_group: int = 512           # GShard dispatch group size (tokens)
    # SSM / hybrid
    ssm_kind: str = ""             # "rwkv6" | "mamba"
    attn_period: int = 0           # hybrid: 1 attention layer per `attn_period`
    d_state: int = 16
    ssm_expand: int = 2
    conv_kernel: int = 4
    # encoder-decoder
    encoder_layers: int = 0
    enc_frames: int = 1500         # stub audio frontend output length
    # misc
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode at 500k context without O(S^2) attention state?

        True for SSM and hybrid archs (decode state is O(1) per Mamba/RWKV
        layer; jamba's few attention layers keep a cache but decode is O(S)
        per token, not O(S^2))."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameters (analytic)."""
        from repro_torch.models.registry import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params

        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason) for an (arch x shape) dry-run cell."""
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md §4)"
    return True, ""


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests."""
    return dataclasses.replace(
        arch,
        n_layers=max(2, min(4, arch.attn_period or 2) * (2 if arch.family == "hybrid" else 1)),
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if arch.n_kv_heads < arch.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        n_experts=min(arch.n_experts, 4),
        top_k=min(arch.top_k, 2),
        moe_group=32,
        encoder_layers=2 if arch.encoder_layers else 0,
        enc_frames=24 if arch.encoder_layers else 1500,
        d_state=8,
        attn_period=min(arch.attn_period, 4) if arch.attn_period else 0,
    )
