"""The benchmark's yardstick arithmetic: rates, ratios, PSNR, a kernel's
bytes and bound.

Copied here, never imported from the program, so that no change to the
program can move the yardstick: PSNR is the paper's Eq. (1) (CubismZ,
arXiv:1903.07761), the wavelet kernel's bytes and bound are counted from
its shapes as the repository's smoke script counts them, against the
H100 SXM data sheet's peaks.
"""
from __future__ import annotations

import math

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS_PER_S", "mcell_rate", "compression_ratio",
           "psnr_eq1", "wavelet_levels", "wavelet_bytes", "wavelet_flops",
           "wavelet_bound_ms", "roofline_pct"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32, outside the tensor cores


def mcell_rate(cells: int, steps: int, seconds: float) -> float:
    """Million cell updates per second: ``cells`` x ``steps`` over the
    window's ``seconds``."""
    if steps <= 0 or seconds <= 0:
        raise ValueError(f"no whole cycle in the window ({steps} steps, {seconds} s)")
    return cells * steps / seconds / 1e6


def compression_ratio(raw_bytes: int, stored_bytes: int) -> float:
    """Raw bytes over the bytes kept on disk (whole files, footers included)."""
    if stored_bytes <= 0:
        raise ValueError("nothing stored")
    return raw_bytes / stored_bytes


def psnr_eq1(value_range: float, mse: float) -> float:
    """The paper's Eq. (1): ``20 log10(range / (2 sqrt(MSE)))`` in dB, with
    the range ``max - min`` of the original field."""
    if mse <= 0:
        return math.inf
    return 20.0 * math.log10(value_range / (2.0 * math.sqrt(mse)))


def wavelet_levels(n: int) -> int:
    """Levels of the default transform of an ``n``^3 block: halve while the
    side is at least 8 (the coarse side stays >= 4)."""
    lv = 0
    while n >= 8:
        n //= 2
        lv += 1
    return lv


def wavelet_bytes(nblocks: int, n: int) -> int:
    """Device bytes of one transform launch: each float32 block read once
    and written once."""
    return 2 * nblocks * n ** 3 * 4


def wavelet_flops(nblocks: int, n: int, levels: int | None = None) -> int:
    """Float32 operations of one w3ai transform: per output pair of each 1D
    step the stencil's multiplies and adds plus the split/merge (8), 3 axes
    per level."""
    levels = wavelet_levels(n) if levels is None else levels
    return nblocks * sum(3 * (n >> lv) ** 3 // 2 * 8 for lv in range(levels))


def wavelet_bound_ms(nblocks: int, n: int) -> tuple[float, str]:
    """The least time of one launch on the card: the larger of its bytes
    over HBM bandwidth and its operations over the float32 peak, and which."""
    t_bytes = wavelet_bytes(nblocks, n) / HBM_BYTES_PER_S * 1e3
    t_ops = wavelet_flops(nblocks, n) / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def roofline_pct(bound_ms: float, launches: int, device_ms: float) -> float | None:
    """A kernel's share of its roofline in %: ``launches`` bounds over the
    device time they took; ``None`` where the trace saw none."""
    if launches <= 0 or device_ms <= 0:
        return None
    return 100.0 * bound_ms * launches / device_ms
