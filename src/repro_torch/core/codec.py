"""Codec facade over the scheme registry and Pipeline (port of
``repro.core.codec``).

The seed-era entry points ``compress_field``, ``decompress_field``,
``compress_blocks``, ``decompress_blocks`` and ``analyze_field`` as thin
wrappers over :class:`Pipeline`, each with the torch ``device`` it runs on
(default ``"cuda"``).  New code should use :class:`Pipeline`.
"""
from __future__ import annotations

from typing import Any

from repro_torch import DEFAULT_DEVICE

from .pipeline import (  # noqa: F401  (re-exports)
    CODEC_FORMAT,
    CompressedField,
    CompressionSpec,
    Pipeline,
)
from .schemes import SCHEMES  # noqa: F401  (live registry view)

__all__ = ["CompressionSpec", "CompressedField", "Pipeline", "CODEC_FORMAT",
           "compress_field", "decompress_field", "compress_blocks",
           "decompress_blocks", "analyze_field", "SCHEMES"]


def compress_blocks(blocks, spec: CompressionSpec, extra_header: dict | None = None,
                    device=DEFAULT_DEVICE) -> CompressedField:
    return Pipeline(spec, device=device).compress_blocks(blocks, extra_header)


def decompress_blocks(comp: CompressedField, device=DEFAULT_DEVICE):
    return Pipeline(comp.spec, device=device).decompress_blocks(comp)


def compress_field(field, spec: CompressionSpec, device=DEFAULT_DEVICE) -> CompressedField:
    return Pipeline(spec, device=device).compress_field(field)


def decompress_field(comp: CompressedField, device=DEFAULT_DEVICE):
    return Pipeline(comp.spec, device=device).decompress(comp)


def analyze_field(field, spec: CompressionSpec, device=DEFAULT_DEVICE) -> dict[str, Any]:
    """Compress + decompress + measure (CR, PSNR, error bound) in one call."""
    return Pipeline(spec, device=device).analyze(field)
