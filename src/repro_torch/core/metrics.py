"""Quality metrics: PSNR (paper Eq. 1) and compression ratio (port of
``repro.core.metrics``; host numpy)."""
from __future__ import annotations

import numpy as np

__all__ = ["mse", "psnr", "compression_ratio"]


def mse(ref, dec) -> float:
    r = np.asarray(ref, np.float64)
    d = np.asarray(dec, np.float64)
    return float(np.mean((r - d) ** 2))


def psnr(ref, dec) -> float:
    """PSNR per the paper's Eq. (1): 20*log10( range / (2*sqrt(MSE)) )."""
    r = np.asarray(ref, np.float64)
    rng = float(r.max() - r.min())
    m = mse(ref, dec)
    if m == 0.0:
        return float("inf")
    return 20.0 * np.log10(rng / (2.0 * np.sqrt(m)))


def compression_ratio(raw_bytes: int, compressed_bytes: int) -> float:
    return raw_bytes / max(1, compressed_bytes)
