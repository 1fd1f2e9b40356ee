"""zfpx encode and decode kernels for Hopper, and their wrappers.

Replaces the Pallas TPU kernels ``repro/kernels/zfp_transform.py::
zfpx_encode_pallas`` (``_encode_kernel``) and ``::zfpx_decode_pallas``
(``_decode_kernel``): per 4^3 cell of ``(B, n, n, n)`` float32 blocks, the
block-floating-point quantization, the ZFP integer lifting on three axes,
the total-sequency reorder and the eps-derived plane truncation, and back.

The kernels are hand-written CUDA C++ (``csrc/zfp_transform.cu``), built at
first use by :mod:`._build`.  One thread holds one cell in registers; cells
are independent, so any ``n % 4 == 0`` works, 64 included.  What bounds
them on the card is device-memory traffic: 4 bytes read and 4 written per
element, plus an int32 ``emax`` per cell; the q rows are staged through
shared memory so that they leave (and enter) the CTA coalesced.

The kernels hold the plain version's integer streams and decoded bits
exactly, and so the reference's on the CPU: the scale ``2^k`` comes from
the same table (:func:`repro_torch.core.zfpx.exp2_table`), and the source
flushes subnormals and saturates the float -> int32 conversion as XLA
does.

Each wrapper routes by the tensor's device: a CPU tensor goes to the plain
PyTorch version (:func:`repro_torch.core.zfpx.encode` / ``decode``); a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel launches
per wrapper, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import zfpx as zf

from . import _build

__all__ = ["zfpx_encode", "zfpx_decode", "LAUNCHES"]

#: kernel launches per wrapper; set to 0 to count one run's launches
LAUNCHES = {"zfpx_encode": 0, "zfpx_decode": 0}

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("zfp_transform")
        ptr = ctypes.c_void_p
        lib.zfpx_encode_launch.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int, ptr]
        lib.zfpx_decode_launch.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong,
                                           ctypes.c_int, ptr]
        for fn in (lib.zfpx_encode_launch, lib.zfpx_decode_launch):
            fn.restype = ctypes.c_int
        lib.zfpx_error_string.argtypes = [ctypes.c_int]
        lib.zfpx_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device}; the kernel runs on one CUDA "
                             "device, the plain version on the CPU")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")


def _run(name: str, fn, *args) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                stream)
    if rc != 0:
        msg = _lib().zfpx_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES[name] += 1


def _encode_launch(blocks: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    name = "zfpx_encode"
    if blocks.dim() != 4 or not (blocks.shape[1] == blocks.shape[2] == blocks.shape[3]):
        raise ValueError(f"{name}: expected (B, n, n, n) blocks, got {tuple(blocks.shape)}")
    if blocks.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 blocks, got {blocks.dtype}")
    b, n = blocks.shape[0], blocks.shape[-1]
    if n < 4 or n % 4:
        raise ValueError(f"{name}: block side {n} is not a multiple of 4")
    _check_cuda(name, blocks)
    nc = (n // 4) ** 3
    emax = torch.empty((b, nc), dtype=torch.int32, device=blocks.device)
    q = torch.empty((b, nc, 64), dtype=torch.int32, device=blocks.device)
    if b:
        _run(name, _lib().zfpx_encode_launch, blocks, zf.exp2_table(blocks.device),
             emax, q, b, n, zf.log_eps(eps))
    return emax, q


def _decode_launch(emax: torch.Tensor, q: torch.Tensor, n: int) -> torch.Tensor:
    name = "zfpx_decode"
    if n < 4 or n % 4:
        raise ValueError(f"{name}: block side {n} is not a multiple of 4")
    b, nc = emax.shape[0], (n // 4) ** 3
    if tuple(emax.shape) != (b, nc) or tuple(q.shape) != (b, nc, 64):
        raise ValueError(f"{name}: expected emax ({b}, {nc}) and q ({b}, {nc}, 64) for "
                         f"n = {n}, got {tuple(emax.shape)} and {tuple(q.shape)}")
    if emax.dtype != torch.int32 or q.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 emax and q, got {emax.dtype}, {q.dtype}")
    _check_cuda(name, emax, q)
    out = torch.empty((b, n, n, n), dtype=torch.float32, device=q.device)
    if b:
        _run(name, _lib().zfpx_decode_launch, emax, q, zf.exp2_table(q.device), out, b, n)
    return out


def zfpx_encode(blocks: torch.Tensor, eps: float = 1e-3
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, n, n) float32 -> (emax (B, nc) int32, q (B, nc, 64) int32)."""
    if blocks.device.type == "cpu":
        return zf.encode(blocks, eps)
    return _encode_launch(blocks, eps)


def zfpx_decode(emax: torch.Tensor, q: torch.Tensor, eps: float = 1e-3,
                n: int = 32) -> torch.Tensor:
    """Inverse of :func:`zfpx_encode` -> (B, n, n, n) float32.  ``eps`` is
    not needed to decode (the truncation is already in ``q``); it is kept
    for the reference's signature."""
    if q.device.type == "cpu" and emax.device.type == "cpu":
        return zf.decode(emax, q, eps, n)
    return _decode_launch(emax, q, n)
