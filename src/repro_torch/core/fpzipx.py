"""``fpzipx`` — FPZIP-style predictive float compression (port of
``repro.core.fpzipx``): lossless, or lossy by bits of precision.

The exact integer pipeline of the reference:

1. total-order map of float32 bit patterns onto uint32 codes (monotone in
   the float ordering, negatives included);
2. optional precision cut: keep the ``precision`` most significant bits
   (32 = bit-exact lossless);
3. wrapping 3D Lorenzo difference of the codes (block-local);
4. host stage 2: byte shuffle + zlib (in the scheme).

There is no float arithmetic, only bit reinterpretation and wrapping
integer sums, so none of XLA's float rules apply and nothing is flushed: a
NaN payload, a signed zero and a subnormal survive the lossless round trip.

Every uint32 code is held as the **int32 bit pattern** of the same 32 bits:
torch's uint32 has few operations on the card.  So the sign-bit test
``u >= 0x80000000`` reads ``u < 0``, and the precision cut, a logical
``(u >> drop) << drop`` in the reference, is a mask of the high bits
(``>>`` on int32 is arithmetic).  The ops run on the tensor's device.
"""
from __future__ import annotations

import torch

from .szx import lorenzo_fwd, lorenzo_inv

__all__ = ["encode", "decode", "float_to_ordered", "ordered_to_float"]

_SIGN = -(2 ** 31)   # 0x80000000 as an int32


def float_to_ordered(x: torch.Tensor) -> torch.Tensor:
    """Monotone map float32 -> uint32 code (as int32 bits), sign-aware."""
    i = x.to(torch.float32).view(torch.int32)
    return torch.where(i >= 0, i ^ _SIGN, ~i)


def ordered_to_float(u: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`float_to_ordered`."""
    return torch.where(u < 0, u ^ _SIGN, ~u).view(torch.float32)


def _high_bits_mask(precision: int) -> int:
    """``(0xFFFFFFFF >> drop) << drop`` as an int32 value: the ``precision``
    most significant bits set (none when ``precision <= 0``)."""
    drop = 32 - precision
    if drop >= 32:
        return 0
    m = (0xFFFFFFFF << drop) & 0xFFFFFFFF
    return m - (1 << 32) if m >= 1 << 31 else m


def _truncate(u: torch.Tensor, precision: int) -> torch.Tensor:
    if precision >= 32:
        return u
    return u & _high_bits_mask(precision)


def encode(blocks: torch.Tensor, precision: int = 32) -> torch.Tensor:
    """blocks (B, n, n, n) float32 -> Lorenzo deltas of the codes, the
    reference's uint32 stream as int32 bits (wrapping)."""
    return lorenzo_fwd(_truncate(float_to_ordered(blocks), precision))


def decode(deltas: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode` -> (B, n, n, n) float32."""
    return ordered_to_float(lorenzo_inv(deltas.to(torch.int32)))
