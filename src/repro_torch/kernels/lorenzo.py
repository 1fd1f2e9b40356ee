"""Lorenzo encode and decode kernels for Hopper, and their wrappers.

Replaces the Pallas TPU kernels ``repro/kernels/lorenzo.py::
lorenzo_encode_pallas`` (``_enc_kernel``) and ``::lorenzo_decode_pallas``
(``_dec_kernel``): compensated dual quantization of ``(B, n, n, n)``
float32 blocks onto the 2*eps grid fused with the 3D Lorenzo residual
(three first differences), and back (three inclusive prefix sums, then
``* 2 eps``).

The kernels are hand-written CUDA C++ (``csrc/lorenzo.cu``), built at first
use by :mod:`._build`.  Encode runs one thread per column of a block and
quantizes each value of the 2x2 corner it needs again, rather than sharing
q through memory.  Decode is one launch whose design follows n alone: up to
n = 64, each block is loaded once into shared memory (TMA bulk copies),
scanned there along all three axes and dequantized as it is stored, by one
CTA that holds whole blocks (n <= 16), or by a thread-block cluster whose
CTAs each hold a slab of planes and add the totals of the slabs below
through distributed shared memory (n = 32: 8 CTAs, n = 64: 16); above 64, a
staged path of three passes through global memory.  Any ``n >= 1`` works;
:func:`decode_design` says which design a side gets.
What bounds them on the card is device-memory traffic: 4 bytes read and 4
written per element.

The kernels hold the plain version's bits exactly, and so the reference's
on the CPU: they take the same float32 ``inv`` and ``two``
(:func:`repro_torch.core.szx.grid`), compute the compensation as one FMA,
add the correction in float32, flush subnormals and saturate the
float -> int32 conversion as XLA does.  Past quantization all is wrapping
int32 arithmetic, exact in any order.

Each wrapper routes by the tensor's device: a CPU tensor goes to the plain
PyTorch version (:func:`repro_torch.core.szx.encode` / ``decode``); a CUDA
tensor launches the kernel or raises.  Each launch on the card counts one
in ``cz_kernel_calls_total{kernel, device="cuda"}`` (:mod:`._obs`), one
per call (the staged path's three passes count as one launch of the
decode), and nothing else does; ``LAUNCHES_BY_SIDE`` counts the same
launches per (wrapper, block side), exactly when several threads launch.
"""
from __future__ import annotations

import collections
import ctypes
import threading

import torch

from repro_torch.core import szx

from . import _build
from ._obs import instrument, launched

__all__ = ["lorenzo_encode", "lorenzo_decode", "decode_design", "LAUNCHES_BY_SIDE"]

#: kernel launches per (wrapper, block side); clear it to count one run's
LAUNCHES_BY_SIDE: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("lorenzo")
        ptr = ctypes.c_void_p
        lib.lorenzo_encode_launch.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_float, ctypes.c_float, ptr]
        lib.lorenzo_decode_launch.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_float, ptr]
        for fn in (lib.lorenzo_encode_launch, lib.lorenzo_decode_launch):
            fn.restype = ctypes.c_int
        for fn in (lib.lorenzo_decode_planes_per_cta, lib.lorenzo_decode_cluster_ctas):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.lorenzo_error_string.argtypes = [ctypes.c_int]
        lib.lorenzo_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name: str, src: torch.Tensor, dtype: torch.dtype, out_dtype: torch.dtype,
            *scalars: float) -> torch.Tensor:
    if src.dim() != 4 or not (src.shape[1] == src.shape[2] == src.shape[3]):
        raise ValueError(f"{name}: expected (B, n, n, n) blocks, got {tuple(src.shape)}")
    if src.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype} blocks, got {src.dtype}")
    if src.shape[-1] < 1:
        raise ValueError(f"{name}: empty block side")
    if src.device.type != "cuda":
        raise ValueError(f"{name}: blocks on {src.device}; the kernel runs on CUDA, "
                         "the plain version on the CPU")
    if not src.is_contiguous():
        raise ValueError(f"{name}: blocks must be contiguous")
    out = torch.empty(src.shape, dtype=out_dtype, device=src.device)
    if src.shape[0] == 0:
        return out
    fn = getattr(_lib(), f"{name}_launch")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(src.data_ptr(), out.data_ptr(), src.shape[0], src.shape[-1], *scalars, stream)
    if rc != 0:
        msg = _lib().lorenzo_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")
    launched(name)
    with _COUNT_LOCK:
        LAUNCHES_BY_SIDE[name, src.shape[-1]] += 1
    return out


@instrument("lorenzo_encode")
def lorenzo_encode(blocks: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """(B, n, n, n) float32 -> int32 Lorenzo residuals of the same shape."""
    if blocks.device.type == "cpu":
        return szx.encode(blocks, eps)
    return _launch("lorenzo_encode", blocks, torch.float32, torch.int32, *szx.grid(eps))


@instrument("lorenzo_decode")
def lorenzo_decode(residuals: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Inverse of :func:`lorenzo_encode` -> (B, n, n, n) float32."""
    if residuals.device.type == "cpu":
        return szx.decode(residuals, eps)
    return _launch("lorenzo_decode", residuals, torch.int32, torch.float32,
                   szx.grid(eps)[1])


def decode_design(n: int) -> dict:
    """The design :func:`lorenzo_decode` launches on the card at block side
    n, as the kernel library chooses it: the cluster kernel with its planes
    per CTA and CTAs per block, or the staged path."""
    lib = _lib()
    planes = lib.lorenzo_decode_planes_per_cta(n)
    if planes == 0:
        return {"design": "staged", "planes_per_cta": None, "cluster_ctas": None}
    return {"design": "cluster", "planes_per_cta": planes,
            "cluster_ctas": lib.lorenzo_decode_cluster_ctas(n)}
