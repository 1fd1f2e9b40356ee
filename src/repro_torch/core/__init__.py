"""Core codec of the port (counterpart of ``repro.core``).

Module map: ``blocks`` (field <-> blocks), ``wavelets``, ``threshold``,
``zfpx`` and ``szx`` (the stage-1 math, plain PyTorch, with ``_xla`` for the
reference's float semantics), ``shuffle``, ``lossless`` and ``metrics``
(host numpy), ``schemes/`` (the registry with ``wavelet``, ``zfpx``,
``lorenzo``, ``szx`` and ``raw``), ``pipeline`` (``CompressionSpec``,
``Pipeline``) and ``container`` (CZ2 files).  Import the modules directly:
this package imports nothing eagerly, so the kernels can depend on
``wavelets`` without a cycle.
"""
