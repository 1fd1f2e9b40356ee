"""3D wavelet transforms "on the interval" (port of ``repro.core.wavelets``).

The paper's three wavelet types as separable, multi-level, block-local
lifting transforms:

* ``w4i``  — 4th-order interpolating: odd samples predicted by cubic
             Lagrange interpolation of the even (coarse) samples;
* ``w4l``  — ``w4i`` plus the update ``s_i += (d_{i-1} + d_i)/4``;
* ``w3ai`` — 3rd-order average-interpolating (the paper's best performer):
             the coarse signal is the pairwise cell average.

Near block edges the stencil is shifted inside the block and its weights are
solved for the shifted evaluation point, so blocks never need halo data.
The weight derivation below is kept verbatim from the reference, in numpy
float64, so both packages use bit-identical tables; the weights are cast to
float32 where they meet the data, as the reference does.

The torch functions here are the plain version of the hand-written kernels
in :mod:`repro_torch.kernels.wavelet3d`: the CPU path runs them, and the
card compares the kernels against them.  Layout is Mallat ``[s | d]``,
recursing on the leading corner, over the trailing three axes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ._xla import flush, flush_

__all__ = [
    "WAVELETS",
    "max_levels",
    "default_levels",
    "forward3d",
    "inverse3d",
    "detail_mask",
    "coarse_side",
]

WAVELETS = ("w4i", "w4l", "w3ai")

_INTERP_TAPS = 4   # cubic Lagrange (4th-order interpolating)
_AVG_TAPS = 3      # quadratic average-interpolation (3rd order)


# ---------------------------------------------------------------------------
# Weight derivation (numpy, cached; exact boundary handling by construction)
# ---------------------------------------------------------------------------

def _lagrange_weights(points: np.ndarray, t: float) -> np.ndarray:
    """Weights w with p(t) = sum_j w_j f(points_j) for the interpolating poly."""
    pts = np.asarray(points, dtype=np.float64)
    w = np.ones_like(pts)
    for j in range(len(pts)):
        for k in range(len(pts)):
            if j != k:
                w[j] *= (t - pts[k]) / (pts[j] - pts[k])
    return w


def _avg_interp_weights(cells: np.ndarray, a: float, b: float) -> np.ndarray:
    """Weights w with avg(p,[a,b]) = sum_j w_j avg(p, [c_j, c_j+1]).

    ``p`` is the unique quadratic matching the given cell averages.  Solved via
    the monomial-moment system M[k, j] = avg_{cell j}(t^k), rhs_k = avg_{[a,b]}(t^k).
    """
    cells = np.asarray(cells, dtype=np.float64)
    k = np.arange(len(cells), dtype=np.float64)[:, None]          # basis degree
    lo, hi = cells[None, :], cells[None, :] + 1.0
    M = (hi ** (k + 1) - lo ** (k + 1)) / (k + 1)                  # cell width 1
    rhs = (b ** (k[:, 0] + 1) - a ** (k[:, 0] + 1)) / ((k[:, 0] + 1) * (b - a))
    return np.linalg.solve(M, rhs)


@functools.lru_cache(maxsize=None)
def _predict_table(kind: str, m: int) -> tuple[np.ndarray, np.ndarray]:
    """(idx, W): predicted odd value i = sum_j W[i, j] * s[idx[i, j]].

    ``m`` is the coarse length.  For interpolating wavelets the odd sample
    2i+1 sits at coarse coordinate i + 0.5; for average-interpolating
    wavelets we predict the average over the right half-cell [i+0.5, i+1).
    """
    taps = _INTERP_TAPS if kind in ("w4i", "w4l") else _AVG_TAPS
    if m < taps:
        raise ValueError(f"coarse length {m} < stencil {taps} for {kind}")
    idx = np.zeros((m, taps), dtype=np.int32)
    W = np.zeros((m, taps), dtype=np.float64)
    for i in range(m):
        start = int(np.clip(i - 1, 0, m - taps))
        idx[i] = np.arange(start, start + taps)
        if kind in ("w4i", "w4l"):
            W[i] = _lagrange_weights(idx[i].astype(np.float64), i + 0.5)
        else:  # w3ai: coarse cell j covers [j, j+1); predict avg over right half
            W[i] = _avg_interp_weights(idx[i].astype(np.float64), i + 0.5, i + 1.0)
    return idx, W


# ---------------------------------------------------------------------------
# 1D lifting steps along the last axis
# ---------------------------------------------------------------------------

# The reference's host path runs each jnp operation eagerly under XLA on the
# CPU, which reads subnormal operands as zero and flushes subnormal results
# to a zero of the same sign.  So every operand and every result of the
# arithmetic below is flushed; copies (slices, cat, stack) are not, and pass
# a subnormal through as XLA's do.  A value is flushed where it enters the
# arithmetic as read (fe, fo, fs, fd below); the helpers take flushed
# operands and flush their result, so no value is flushed twice (flushing
# is idempotent).  The weights and the constants 0.25, 0.5 and 2.0 are
# normal.  The CUDA kernels do the same, operation by operation.

def _add(a: torch.Tensor, b) -> torch.Tensor:
    return flush_(a + b)


def _sub(a: torch.Tensor, b) -> torch.Tensor:
    return flush_(a - b)


def _mul(a: torch.Tensor, b) -> torch.Tensor:
    return flush_(a * b)


def _predict(fs: torch.Tensor, kind: str) -> torch.Tensor:
    """Predicted odd values from the flushed coarse values ``fs``: the taps'
    products summed left to right from +0.0, as XLA's reduction sums them
    (a -0.0 first product gives +0.0)."""
    m = fs.shape[-1]
    idx, W = _predict_table(kind, m)
    taps = idx.shape[1]
    w_t = torch.from_numpy(np.ascontiguousarray(W.T, dtype=np.float32)).to(fs.device)
    acc = None
    for j in range(taps):
        # fs[..., idx[:, j]]: row i reads fs[clip(i - 1, 0, m - taps) + j]
        tap = torch.cat([fs[..., j:j + 1], fs[..., j:j + m - taps + 1],
                         fs[..., m - taps + j:m - taps + j + 1].expand(
                             *fs.shape[:-1], taps - 2)], dim=-1)
        p = _mul(tap, w_t[j])
        acc = p + 0.0 if acc is None else _add(acc, p)
    return acc


def _lift_update(fd: torch.Tensor) -> torch.Tensor:
    """s-update term (d_{i-1} + d_i)/4, one-sided at the left boundary."""
    dm1 = torch.cat([fd[..., :1], fd[..., :-1]], dim=-1)  # d_{-1} := d_0
    return _mul(_add(dm1, fd), 0.25)


def _fwd_step_last(x: torch.Tensor, kind: str) -> torch.Tensor:
    e, o = x[..., 0::2], x[..., 1::2]
    fo = flush(o)
    if kind in ("w4i", "w4l"):
        s = e                  # the even samples' bits, unflushed
        fs = flush(s)
        d = _sub(fo, _predict(fs, kind))
        if kind == "w4l":
            s = _add(fs, _lift_update(d))
    else:  # w3ai
        s = _mul(_add(flush(e), fo), 0.5)
        d = _sub(fo, _predict(s, kind))
    return torch.cat([s, d], dim=-1)


def _inv_step_last(x: torch.Tensor, kind: str) -> torch.Tensor:
    m = x.shape[-1] // 2
    s, d = x[..., :m], x[..., m:]
    fs, fd = flush(s), flush(d)
    if kind == "w4l":
        s = fs = _sub(fs, _lift_update(fd))
    o = _add(fd, _predict(fs, kind))
    e = _sub(_mul(fs, 2.0), o) if kind == "w3ai" else s
    return torch.stack([e, o], dim=-1).reshape(*x.shape[:-1], 2 * m)


def _step(x: torch.Tensor, axis: int, kind: str, inverse: bool) -> torch.Tensor:
    x = torch.movedim(x, axis, -1)
    x = (_inv_step_last if inverse else _fwd_step_last)(x, kind)
    return torch.movedim(x, -1, axis)


# ---------------------------------------------------------------------------
# Multi-level separable 3D transform over trailing (n, n, n) axes
# ---------------------------------------------------------------------------

def max_levels(n: int) -> int:
    """Deepest level count keeping the coarse side >= 4 (stencil support)."""
    lv = 0
    while n >= 8:
        n //= 2
        lv += 1
    return lv


def default_levels(n: int, levels: int | None) -> int:
    lv = max_levels(n) if levels is None else levels
    if lv < 1 or lv > max_levels(n):
        raise ValueError(f"levels={levels} invalid for side {n}")
    return lv


def coarse_side(n: int, levels: int | None = None) -> int:
    return n >> default_levels(n, levels)


def forward3d(x: torch.Tensor, kind: str = "w3ai",
              levels: int | None = None) -> torch.Tensor:
    """Multi-level separable 3D DWT over the trailing three axes."""
    n = x.shape[-1]
    levels = default_levels(n, levels)
    out = x
    for lvl in range(levels):
        c = n >> lvl
        sub = out[..., :c, :c, :c]
        for axis in (-3, -2, -1):
            sub = _step(sub, axis, kind, inverse=False)
        if c == n:
            out = sub          # a new tensor: the caller's input is untouched
        else:
            out[..., :c, :c, :c] = sub
    return out


def inverse3d(x: torch.Tensor, kind: str = "w3ai",
              levels: int | None = None) -> torch.Tensor:
    n = x.shape[-1]
    levels = default_levels(n, levels)
    out = x.clone()            # updated in place below, level by level
    for lvl in reversed(range(levels)):
        c = n >> lvl
        sub = out[..., :c, :c, :c]
        for axis in (-1, -2, -3):
            sub = _step(sub, axis, kind, inverse=True)
        out[..., :c, :c, :c] = sub
    return out


def detail_mask(n: int, levels: int | None = None) -> np.ndarray:
    """Boolean (n,n,n) mask: True where a coefficient is a *detail* coeff.

    The approximation corner ``[0:c, 0:c, 0:c]`` (c = n >> levels) is False —
    it is always stored at full precision and never thresholded.
    """
    c = coarse_side(n, levels)
    mask = np.ones((n, n, n), dtype=bool)
    mask[:c, :c, :c] = False
    return mask
