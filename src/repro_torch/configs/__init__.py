"""Config registry: one module per assigned architecture (a copy of
``repro.configs``, whose dataclasses need no framework)."""
from . import (
    chameleon_34b,
    granite_8b,
    jamba_v0_1_52b,
    llama4_scout_17b_a16e,
    olmoe_1b_7b,
    qwen25_32b,
    qwen3_32b,
    rwkv6_7b,
    smollm_135m,
    whisper_small,
)
from .base import SHAPES, ArchConfig, ShapeConfig, cell_applicable, reduced  # noqa: F401

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        chameleon_34b,
        llama4_scout_17b_a16e,
        olmoe_1b_7b,
        qwen25_32b,
        qwen3_32b,
        smollm_135m,
        granite_8b,
        rwkv6_7b,
        jamba_v0_1_52b,
        whisper_small,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
