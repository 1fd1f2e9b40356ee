"""Threshold decimation of wavelet detail coefficients (port of
``repro.core.threshold``).

Detail coefficients with magnitude below the tolerance are dropped, which
bounds the decimation error by eps; the approximation corner (coarsest
level) is never thresholded.  ``topk_details`` is the fixed-shape variant
(a static number of kept coefficients, as gradient compression wants);
its selection is a stable descending sort of the magnitudes, so ties keep
the lower index first, as ``lax.top_k`` does.  Every function runs on the
device of ``coeffs``.
"""
from __future__ import annotations

import torch

from . import wavelets as wv

__all__ = ["threshold_details", "significant_mask", "topk_details", "scatter_topk"]


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


def topk_largest(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last dim, largest
    first and ties to the lower index (``lax.top_k``'s order): the head
    of a stable descending sort."""
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices[..., :k]


def topk_details(coeffs: torch.Tensor, k: int, levels: int | None = None):
    """Keep the k largest-|.| detail coefficients per block (fixed shapes).

    coeffs: (..., n, n, n).  Returns (values (..., k), flat_indices (...,
    k) int32, coarse (..., c, c, c))."""
    n = coeffs.shape[-1]
    c = wv.coarse_side(n, levels)
    dm = _detail_mask_for(coeffs, levels).reshape(-1)
    flat = coeffs.reshape(*coeffs.shape[:-3], n * n * n)
    mag = torch.where(dm, flat.abs(), torch.full((), -torch.inf, dtype=flat.dtype,
                                                 device=flat.device))
    idx = topk_largest(mag, k)
    vals = torch.gather(flat, -1, idx)
    return vals, idx.to(torch.int32), coeffs[..., :c, :c, :c]


def scatter_topk(vals: torch.Tensor, idx: torch.Tensor, coarse: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Inverse of :func:`topk_details`: rebuild a dense coefficient cube."""
    batch = vals.shape[:-1]
    flat = torch.zeros((*batch, n * n * n), dtype=vals.dtype, device=vals.device)
    flat.scatter_(-1, idx.long(), vals)
    cube = flat.reshape(*batch, n, n, n)
    c = coarse.shape[-1]
    cube[..., :c, :c, :c] = coarse
    return cube
