"""Data shuffling and bit zeroing (port of ``repro.core.shuffle``, host side).

Byte shuffling transposes the byte planes of a homogeneous value stream so
that "boring" high bytes group together, which improves the lossless stage.
Bit zeroing clears the least significant mantissa bits of detail
coefficients (Z4/Z8 in the paper).  These run on host byte buffers at the
I/O boundary, :func:`zero_low_bits` on tensors of any device; their output
is byte-identical to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "byte_shuffle",
    "byte_unshuffle",
    "bit_shuffle",
    "bit_unshuffle",
    "zero_low_bits",
    "zero_low_bits_np",
]


def byte_shuffle(buf: bytes | np.ndarray, itemsize: int) -> bytes:
    a = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) else np.asarray(buf, np.uint8)
    if a.size % itemsize:
        raise ValueError(f"buffer size {a.size} not divisible by itemsize {itemsize}")
    return a.reshape(-1, itemsize).T.tobytes()


def byte_unshuffle(buf: bytes | np.ndarray, itemsize: int) -> bytes:
    a = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) else np.asarray(buf, np.uint8)
    if a.size % itemsize:
        raise ValueError(f"buffer size {a.size} not divisible by itemsize {itemsize}")
    return a.reshape(itemsize, -1).T.tobytes()


def bit_shuffle(buf: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(buf, dtype=np.uint8)
    bits = np.unpackbits(a.reshape(-1, itemsize), axis=1, bitorder="little")
    return np.packbits(bits.T, bitorder="little").tobytes()


def bit_unshuffle(buf: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(buf, dtype=np.uint8)
    nbits = itemsize * 8
    bits = np.unpackbits(a, bitorder="little").reshape(nbits, -1)
    return np.packbits(bits.T, axis=1, bitorder="little").tobytes()


def zero_low_bits_np(values: np.ndarray, nbits: int) -> np.ndarray:
    """Clear the ``nbits`` least significant bits of float32 values (host)."""
    if nbits == 0:
        return values
    u = values.astype(np.float32).view(np.uint32)
    u = u & np.uint32(~((1 << nbits) - 1) & 0xFFFFFFFF)
    return u.view(np.float32)


def zero_low_bits(values: torch.Tensor, nbits: int) -> torch.Tensor:
    """Tensor variant of :func:`zero_low_bits_np`: the float32 values'
    bits as int32, the mask applied (subnormals and signed zeros kept as
    bits), on the values' device."""
    if nbits == 0:
        return values
    mask = ~((1 << nbits) - 1) & 0xFFFFFFFF
    mask -= (mask >> 31) << 32          # the same 32 bits as a signed int32
    return (values.to(torch.float32).view(torch.int32) & mask).view(torch.float32)
