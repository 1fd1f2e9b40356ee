"""Significance packing of wavelet coefficients on the card, and its wrapper.

Replaces no TPU kernel.  The reference selects the significant details on
the host: stage 1 hands serialize the dense coefficients and a byte per
cell of mask, and serialize takes ``coeffs[mask]`` and ``np.packbits`` of
the mask.  This kernel moves that selection onto the card, so that stage 1
brings down only what the payload holds (``csrc/wavelet_pack.cu``, built at
first use by :mod:`._build`).  What bounds it on the card is device-memory
traffic: each coefficient is read once, the mask is written at one bit a
cell and each significant detail is read and written once more; the design
notes are in the source.

:func:`wavelet_pack` takes ``(B, n, n, n)`` float32 coefficients (the
forward transform's), ``eps`` and the level count, and returns four tensors
on the coefficients' device:

- ``counts`` ``(B,)`` int32: each block's number of significant details
  (the bits of the payload's u32 counts);
- ``packed`` ``(B, n^3 / 8)`` uint8: each block's significance mask in C
  order, packed as ``np.packbits`` packs it (cell ``8k`` at bit 7 of byte
  ``k``); ``n^3`` is a multiple of 8, so blocks pack independently;
- ``coarse`` ``(B, c, c, c)`` float32: the coarse corners, as bits;
- ``details`` ``(D,)`` float32: every block's significant details, block
  after block, C order inside a block, as bits; block ``b``'s start at the
  exclusive prefix sum of ``counts``.

A detail is significant under :func:`repro_torch.core.threshold.
significant_mask`'s test: a detail cell with ``|c| >= eps``, ``eps`` rounded
to float32 as torch's comparison rounds it.  The wrapper routes by the
tensor's device: a CPU tensor goes to the plain PyTorch version
(:func:`pack_plain`); a CUDA tensor launches the kernels or raises.  On the
card the wrapper reads the detail total back (8 bytes, counted in
``cz_copy_bytes_total{site="wavelet_pack.total"}``) to size the detail
stream exactly, so it waits for the card once.  Each call that launched
counts one in ``cz_kernel_calls_total{kernel="wavelet_pack",
device="cuda"}`` (its three launches are one group), and nothing else does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import threshold
from repro_torch.core import wavelets as wv

from . import _build
from ._obs import count_copy, instrument, launched

__all__ = ["wavelet_pack", "pack_plain"]

# np.packbits' weights: the first of eight cells in the byte's top bit
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("wavelet_pack")
        ptr = ctypes.c_void_p
        lib.wavelet_pack_tiles_per_block.argtypes = [ctypes.c_int]
        lib.wavelet_pack_tiles_per_block.restype = ctypes.c_longlong
        lib.wavelet_pack_mask_launch.argtypes = [ptr, ctypes.c_longlong, ctypes.c_int,
                                                 ctypes.c_int, ctypes.c_float, ptr, ptr, ptr,
                                                 ptr, ptr, ptr]
        lib.wavelet_pack_select_launch.argtypes = [ptr, ctypes.c_longlong, ctypes.c_int, ptr,
                                                   ptr, ptr, ptr]
        for fn in (lib.wavelet_pack_mask_launch, lib.wavelet_pack_select_launch):
            fn.restype = ctypes.c_int
        lib.wavelet_pack_error_string.argtypes = [ctypes.c_int]
        lib.wavelet_pack_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def pack_plain(coeffs: torch.Tensor, eps: float, levels: int | None = None):
    """The plain PyTorch version of :func:`wavelet_pack`, on any device."""
    nblk, n = coeffs.shape[0], coeffs.shape[-1]
    c = wv.coarse_side(n, levels)
    mask = threshold.significant_mask(coeffs, eps, levels)
    counts = mask.reshape(nblk, -1).sum(-1, dtype=torch.int32)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=coeffs.device)
    packed = (mask.reshape(nblk, -1, 8).to(torch.uint8) * weights).sum(-1, dtype=torch.uint8)
    return counts, packed, coeffs[:, :c, :c, :c].contiguous(), coeffs[mask]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().wavelet_pack_error_string(rc).decode()
        raise RuntimeError(f"wavelet_pack {what} launch failed: {msg} (cudaError {rc})")


def _launch(coeffs: torch.Tensor, eps: float, levels: int | None):
    if coeffs.dim() != 4 or not (coeffs.shape[1] == coeffs.shape[2] == coeffs.shape[3]):
        raise ValueError(f"wavelet_pack: expected (B, n, n, n) coefficients, "
                         f"got {tuple(coeffs.shape)}")
    if coeffs.dtype != torch.float32:
        raise TypeError(f"wavelet_pack: expected float32 coefficients, got {coeffs.dtype}")
    n = coeffs.shape[-1]
    if n < 8 or n & (n - 1):
        raise ValueError(f"wavelet_pack: block side {n} is not a power of two >= 8")
    c = n >> wv.default_levels(n, levels)
    if coeffs.device.type != "cuda":
        raise ValueError(f"wavelet_pack: coefficients on {coeffs.device}; the kernel runs "
                         "on CUDA, the plain version on the CPU")
    if not coeffs.is_contiguous():
        raise ValueError("wavelet_pack: coefficients must be contiguous")
    nblk, dev = coeffs.shape[0], coeffs.device
    counts = torch.empty(nblk, dtype=torch.int32, device=dev)
    packed = torch.empty((nblk, n ** 3 // 8), dtype=torch.uint8, device=dev)
    coarse = torch.empty((nblk, c, c, c), dtype=torch.float32, device=dev)
    if nblk == 0:
        return counts, packed, coarse, torch.empty(0, dtype=torch.float32, device=dev)
    lib = _lib()
    ntiles = nblk * lib.wavelet_pack_tiles_per_block(n)
    tile_counts = torch.empty(ntiles, dtype=torch.int32, device=dev)
    offsets = torch.empty(ntiles + 1, dtype=torch.int64, device=dev)
    # torch compares a float32 tensor with a Python float in float32
    eps32 = torch.tensor(eps, dtype=torch.float32).item()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.wavelet_pack_mask_launch(coeffs.data_ptr(), nblk, n, c, eps32,
                                            packed.data_ptr(), coarse.data_ptr(),
                                            tile_counts.data_ptr(), offsets.data_ptr(),
                                            counts.data_ptr(), stream), "mask")
        total = offsets[-1:]
        count_copy(total, "cpu", "wavelet_pack.total")
        details = torch.empty(int(total.item()), dtype=torch.float32, device=dev)
        _check(lib.wavelet_pack_select_launch(coeffs.data_ptr(), nblk, n, packed.data_ptr(),
                                              offsets.data_ptr(), details.data_ptr(), stream),
               "select")
    launched("wavelet_pack")
    return counts, packed, coarse, details


@instrument("wavelet_pack")
def wavelet_pack(coeffs: torch.Tensor, eps: float, levels: int | None = None):
    """``(counts, packed, coarse, details)`` of (B, n, n, n) coefficients;
    see the module docstring."""
    if coeffs.device.type == "cpu":
        return pack_plain(coeffs, eps, levels)
    return _launch(coeffs, eps, levels)
