"""Threshold decimation of wavelet detail coefficients (port of
``repro.core.threshold``).

Detail coefficients with magnitude below the tolerance are dropped, which
bounds the decimation error by eps; the approximation corner (coarsest
level) is never thresholded.  Both functions run on the device of
``coeffs``.
"""
from __future__ import annotations

import torch

from . import wavelets as wv

__all__ = ["threshold_details", "significant_mask"]


def _detail_mask_for(x: torch.Tensor, levels: int | None) -> torch.Tensor:
    return torch.from_numpy(wv.detail_mask(x.shape[-1], levels)).to(x.device)


def threshold_details(coeffs: torch.Tensor, eps: float,
                      levels: int | None = None) -> torch.Tensor:
    """Zero detail coefficients with |c| < eps; keep the approximation corner."""
    dm = _detail_mask_for(coeffs, levels)
    keep = (~dm) | (coeffs.abs() >= eps)
    return torch.where(keep, coeffs, torch.zeros((), dtype=coeffs.dtype,
                                                 device=coeffs.device))


def significant_mask(coeffs: torch.Tensor, eps: float,
                     levels: int | None = None) -> torch.Tensor:
    """Boolean mask of coefficients that survive decimation (details only)."""
    dm = _detail_mask_for(coeffs, levels)
    return dm & (coeffs.abs() >= eps)
