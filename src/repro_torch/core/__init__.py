"""Core codec of the port (counterpart of ``repro.core``).

Module map: ``blocks`` (field <-> blocks), ``wavelets``, ``threshold``,
``zfpx``, ``szx`` and ``fpzipx`` (the stage-1 math, plain PyTorch, with
``_xla`` for the reference's float semantics), ``shuffle``, ``lossless`` and
``metrics`` (host numpy), ``schemes/`` (the registry with ``wavelet``,
``zfpx``, ``lorenzo``, ``szx``, ``fpzipx``, ``raw`` and ``auto``),
``pipeline`` (``CompressionSpec``, ``Pipeline``), ``codec`` (the
``compress_field``/``decompress_field`` facade) and ``container`` (CZ2
files over the ``Store`` protocol, ``describe``, ``FieldReader``).

The reference's package-level names (``CompressionSpec``, ``Pipeline``,
``psnr``, ...) resolve lazily (PEP 562): importing this package imports no
submodule, so the kernels can depend on ``wavelets`` without a cycle.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "CODEC_FORMAT": ".pipeline",
    "DTYPES": ".pipeline",
    "CompressedField": ".pipeline",
    "CompressionSpec": ".pipeline",
    "Pipeline": ".pipeline",
    "DEVICES": ".schemes",
    "SCHEMES": ".schemes",
    "Scheme": ".schemes",
    "get_scheme": ".schemes",
    "register_scheme": ".schemes",
    "analyze_field": ".codec",
    "compress_blocks": ".codec",
    "compress_field": ".codec",
    "decompress_blocks": ".codec",
    "decompress_field": ".codec",
    "compression_ratio": ".metrics",
    "mse": ".metrics",
    "psnr": ".metrics",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value  # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
