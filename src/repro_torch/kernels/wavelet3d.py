"""Forward and inverse 3D wavelet kernels for Hopper, and their wrappers.

Replaces the Pallas TPU kernels ``repro/kernels/wavelet3d.py::
wavelet3d_forward`` and ``::wavelet3d_inverse`` (``_call``/``_kernel``):
the multi-level separable lifting DWT of ``(B, n, n, n)`` float32 blocks,
Mallat ``[s | d]`` layout, for w4i, w4l and w3ai.

The kernels are hand-written CUDA C++ (``csrc/wavelet3d.cu``), built at
first use by :mod:`._build`, for every power-of-two block side n >= 8, the
reference's range.  Up to n = 64 a thread-block cluster holds one block
in shared memory, a slab of planes per CTA (1, 1, 4 and 16 CTAs at n = 8,
16, 32, 64), and lifts it line by line as a 3- or 4-tap stencil with the
one-sided boundary weights of ``wavelets._predict_table``; lines that
cross the slabs go through distributed shared memory.  From n = 128 a block does not fit in a
cluster, and a staged kernel lifts one axis of one level per launch
through device memory.  What bounds them on the card is device-memory
traffic: up to n = 64 each block is read once and written once (4 n^3
bytes each way) for about 14 flops per element.

The kernels compute what the plain version computes, operation by
operation, with XLA's subnormal flush, so on the card they give the CPU's
bits.  Each block is computed by its own CTAs alone, so a block's output
bits do not depend on the batch it came in (the Pallas kernel's do).

Each wrapper routes by the tensor's device: a CPU tensor goes to the plain
PyTorch version (:func:`repro_torch.core.wavelets.forward3d` /
``inverse3d``); a CUDA tensor launches the kernel or raises.  Each call
that launched the kernels (one launch, or one per level and axis from
n = 128) counts one in ``cz_kernel_calls_total{kernel, device="cuda"}``
(:mod:`._obs`), and nothing else does; ``LAUNCHES_BY_SIDE`` counts the
same calls per (wrapper, block side), exactly when several threads launch
(the tuner's trials do).
"""
from __future__ import annotations

import collections
import ctypes
import threading

import numpy as np
import torch

from repro_torch.core import wavelets as wv

from . import _build
from ._obs import instrument, launched

__all__ = ["wavelet3d_forward", "wavelet3d_inverse", "LAUNCHES_BY_SIDE"]

#: kernel launches per (wrapper, block side); clear it to count one run's
LAUNCHES_BY_SIDE: collections.Counter = collections.Counter()
#: each kernel's label in cz_kernel_calls_total (the reference's)
_LABELS = {"wavelet3d_forward": "wavelet_forward", "wavelet3d_inverse": "wavelet_inverse"}

_COUNT_LOCK = threading.Lock()

_KINDS = {"w4i": 0, "w4l": 1, "w3ai": 2}
_WEIGHTS: dict[tuple, torch.Tensor] = {}
_WEIGHTS_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("wavelet3d")
        for fn in (lib.wavelet3d_forward_launch, lib.wavelet3d_inverse_launch):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.wavelet3d_error_string.argtypes = [ctypes.c_int]
        lib.wavelet3d_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def tap_weights(kind: str, n: int, levels: int) -> np.ndarray:
    """The kernel's weight table: float32 ``W`` of ``_predict_table`` for each
    level's coarse length, level after level, row after row.

    The kernel computes each row's stencil start itself as
    ``clip(i - 1, 0, m - taps)``; this checks that the table's ``idx`` is
    exactly that, so table and kernel cannot drift apart silently.
    """
    parts = []
    for lvl in range(levels):
        m = (n >> lvl) // 2
        idx, W = wv._predict_table(kind, m)
        taps = idx.shape[1]
        start = np.clip(np.arange(m) - 1, 0, m - taps)
        if not np.array_equal(idx, start[:, None] + np.arange(taps)):
            raise RuntimeError(f"{kind} m={m}: stencil starts differ from the kernel's")
        parts.append(W.astype(np.float32).reshape(-1))
    w = np.concatenate(parts)
    if np.any((w != 0) & (np.abs(w) < np.finfo(np.float32).tiny)):
        raise RuntimeError(f"{kind} n={n}: a subnormal weight (the kernel reads weights unflushed)")
    return w


def _device_weights(kind: str, n: int, levels: int, device) -> torch.Tensor:
    key = (kind, n, levels, str(device))
    with _WEIGHTS_LOCK:
        w = _WEIGHTS.get(key)
        if w is None:
            w = _WEIGHTS[key] = torch.from_numpy(tap_weights(kind, n, levels)).to(device)
    return w


def _launch(name: str, blocks: torch.Tensor, kind: str,
            levels: int | None) -> torch.Tensor:
    if blocks.dim() != 4 or not (blocks.shape[1] == blocks.shape[2] == blocks.shape[3]):
        raise ValueError(f"{name}: expected (B, n, n, n) blocks, got {tuple(blocks.shape)}")
    if blocks.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 blocks, got {blocks.dtype}")
    n = blocks.shape[-1]
    if n < 8 or n & (n - 1):
        raise ValueError(f"{name}: block side {n} is not a power of two >= 8")
    if kind not in _KINDS:
        raise ValueError(f"{name}: unknown wavelet {kind!r}")
    levels = wv.default_levels(n, levels)
    if blocks.device.type != "cuda":
        raise ValueError(f"{name}: blocks on {blocks.device}; the kernel runs on CUDA, "
                         "the plain version on the CPU")
    if not blocks.is_contiguous() or blocks.data_ptr() % 16:
        raise ValueError(f"{name}: blocks must be contiguous and 16-byte aligned")
    out = torch.empty_like(blocks)
    if blocks.shape[0] == 0:
        return out
    w = _device_weights(kind, n, levels, blocks.device)
    fn = getattr(_lib(), f"{name}_launch")
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        rc = fn(blocks.data_ptr(), out.data_ptr(), w.data_ptr(), w.numel(),
                blocks.shape[0], n, _KINDS[kind], levels, stream)
    if rc != 0:
        msg = _lib().wavelet3d_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")
    launched(_LABELS[name])
    with _COUNT_LOCK:
        LAUNCHES_BY_SIDE[name, n] += 1
    return out


@instrument("wavelet_forward")
def wavelet3d_forward(blocks: torch.Tensor, kind: str = "w3ai",
                      levels: int | None = None) -> torch.Tensor:
    """Forward multi-level 3D DWT of (B, n, n, n) blocks."""
    if blocks.device.type == "cpu":
        return wv.forward3d(blocks, kind, levels)
    return _launch("wavelet3d_forward", blocks, kind, levels)


@instrument("wavelet_inverse")
def wavelet3d_inverse(blocks: torch.Tensor, kind: str = "w3ai",
                      levels: int | None = None) -> torch.Tensor:
    """Inverse of :func:`wavelet3d_forward`."""
    if blocks.device.type == "cpu":
        return wv.inverse3d(blocks, kind, levels)
    return _launch("wavelet3d_inverse", blocks, kind, levels)
