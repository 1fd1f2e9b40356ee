"""The reference's float semantics, which are XLA's on the CPU, in torch.

The integer-exact codecs (``zfpx``, ``szx``/``lorenzo``) are held to the
reference's bits, and the reference runs its float math under XLA's CPU
backend: subnormal inputs read as zero, subnormal results flush to a zero
of the same sign, and float -> int32 conversion saturates with NaN -> 0.
torch on neither device does this, so the plain versions write it out with
these helpers; the CUDA kernels do the same in their sources.
"""
from __future__ import annotations

import torch

__all__ = ["FLT_MIN", "flush", "flush_", "to_int32"]

FLT_MIN = 2.0 ** -126   # smallest normal float32
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values -> a zero of the same sign: ``x`` times 1.0
    or 0.0 (three passes over ``x``, where a ``where`` takes four)."""
    return x * x.abs().ge_(FLT_MIN)


def flush_(x: torch.Tensor) -> torch.Tensor:
    """:func:`flush` in place, for a tensor the caller owns (a fresh result:
    no new allocation)."""
    return x.mul_(x.abs().ge_(FLT_MIN))


def to_int32(v: torch.Tensor) -> torch.Tensor:
    """Saturating float32 -> int32 of integral values, NaN -> 0."""
    hi = v >= 2.0 ** 31
    lo = v < -(2.0 ** 31)
    ok = ~(hi | lo | torch.isnan(v))
    q = torch.where(ok, v, 0.0).to(torch.int32)
    q = torch.where(hi, _I32_MAX, q)
    return torch.where(lo, _I32_MIN, q)
