"""``szx`` — SZ-style error-bounded predictive quantization (port of
``repro.core.szx``).

Dual quantization, as cuSZ does it on GPUs: quantize first onto the 2*eps
grid, then take the exact integer 3D Lorenzo difference:

    q = round(x / (2 eps))           (int32)
    r = (I - Sx)(I - Sy)(I - Sz) q   (three axis-wise finite differences)

Decoding is three inclusive prefix sums.  Everything after quantization is
wrapping int32 arithmetic, a ring, so it is exact in any order of summation.
Prediction is block-local: each (bs, bs, bs) block is differenced alone.

:func:`encode` and :func:`decode` are the plain PyTorch version of the
hand-written kernels in :mod:`repro_torch.kernels.lorenzo`: the CPU path
runs them, the szx scheme runs them on any device, and the card compares
the kernels against them.  They hold the reference's bits, and so follow
its float semantics, which are XLA's on the CPU (:mod:`._xla`):

* ``inv = 1/(2 eps)`` and ``two = 2 eps`` are taken in double and rounded
  once to float32, as JAX rounds a Python scalar; a subnormal ``two`` reads
  as 0 (then every q is NaN -> 0 and the field decodes to 0);
* ``jnp.round`` rounds half to even (``torch.round`` does too);
* XLA fuses the compensation ``x - q * two`` into one FMA, rounded once: a
  float32 multiply then subtract differs.  The product of two float32
  values is exact in float64, and so is the difference here (|x| and
  |q * two| are within a factor of two of each other, or q = 0), so taking
  it in float64 and rounding to float32 is the FMA's single rounding;
* the correction is added to q in float32, not int32: past |q| = 2^24 the
  sum rounds, and the reference keeps that rounding;
* subnormal inputs read as 0 and subnormal results flush to zero; the
  float -> int32 conversion saturates with NaN -> 0.
"""
from __future__ import annotations

import functools

import torch

from ._xla import flush, to_int32

__all__ = ["encode", "decode", "quantize", "lorenzo_fwd", "lorenzo_inv",
           "max_eps_ratio", "check_eps", "grid"]

# |q| must fit int32 with headroom for the 3D diff (factor <= 8).
_Q_LIMIT = 2 ** 27


def max_eps_ratio() -> float:
    """Smallest allowed eps relative to max|x|: eps >= max|x| / (2*_Q_LIMIT)."""
    return 1.0 / (2.0 * _Q_LIMIT)


@functools.lru_cache(maxsize=None)
def grid(eps: float) -> tuple[float, float]:
    """``(inv, two)``: ``1/(2 eps)`` and ``2 eps`` rounded once to float32
    (``inv`` may overflow to inf), a subnormal ``two`` flushed to 0.  The
    kernels take these two numbers as they are; cached, since the wrappers
    ask for them at every call."""
    vals = flush(torch.tensor([1.0 / (2.0 * eps), 2.0 * eps], dtype=torch.float64).float())
    return float(vals[0]), float(vals[1])


def lorenzo_fwd(q: torch.Tensor) -> torch.Tensor:
    """3D Lorenzo residual over the trailing three axes (wrapping int32)."""
    for ax in (-3, -2, -1):
        q = torch.diff(q, dim=ax, prepend=torch.zeros_like(q.narrow(ax, 0, 1)))
    return q


def lorenzo_inv(r: torch.Tensor) -> torch.Tensor:
    """Inverse: inclusive cumsum along each axis (wrapping int32)."""
    for ax in (-1, -2, -3):
        r = torch.cumsum(r, dim=ax, dtype=torch.int32)
    return r


def quantize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 -> int32 q on the 2*eps grid, compensated as the reference."""
    inv, two = grid(eps)
    x = flush(x.to(torch.float32))
    q = torch.round(flush(x * inv))
    err = flush((x.double() - q.double() * two).float())  # one rounding: XLA's FMA
    return to_int32(q + torch.round(flush(err * inv)))


def encode(blocks: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """blocks (B, n, n, n) float32 -> int32 Lorenzo residuals (B, n, n, n)."""
    return lorenzo_fwd(quantize(blocks, eps))


def decode(residuals: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Inverse of :func:`encode` -> (B, n, n, n) float32."""
    _, two = grid(eps)
    return flush(lorenzo_inv(residuals.to(torch.int32)).to(torch.float32) * two)


def check_eps(fields_absmax: float, eps: float) -> None:
    if eps <= 0:
        raise ValueError("szx requires eps > 0 (error-bounded lossy codec)")
    if fields_absmax / (2.0 * eps) >= _Q_LIMIT:
        raise ValueError(
            f"eps={eps} too small for data with max|x|={fields_absmax}: "
            f"quantized values would overflow int32 (need eps >= "
            f"{fields_absmax * max_eps_ratio():.3e})"
        )
