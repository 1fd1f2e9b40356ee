"""Shared model building blocks: norms, RoPE, positions, param makers
(port of ``repro.models.common``)."""
from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Maker", "rmsnorm", "rope", "sinusoidal_positions", "gelu", "swiglu_act",
           "einsum", "tree_map", "tree_leaves"]

#: Set while an attention product in score space runs (:func:`score_block`):
#: ``True`` where the product makes a (qc, kc) score block, the block itself
#: where the product reads one.  It changes no value; the op counter of
#: :mod:`repro_torch.launch.hlo_analysis` reads it.
SCORE_BLOCK: contextvars.ContextVar = contextvars.ContextVar("score_block", default=None)


@contextlib.contextmanager
def score_block(operand=None):
    """Marks the products run inside as score-space: with no ``operand``
    they make a score block, else they read ``operand``, a score block."""
    token = SCORE_BLOCK.set(True if operand is None else operand)
    try:
        yield
    finally:
        SCORE_BLOCK.reset(token)


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of nested dicts, lists and tuples; with ``rest``,
    on the leaves of equally shaped trees side by side, as ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree, path=()):
    """(path, leaf) pairs of nested dicts in JAX's order: keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


class Maker:
    """Dual-mode parameter factory: shape-only specs or real init.

    ``"spec"`` makes tensors on the ``meta`` device (shape and dtype, no
    storage), ``"init"`` real ones on ``device``.  Both run the same builder
    code, so the trees are identical leaf for leaf.  ``"init"`` draws from an
    explicit ``torch.Generator`` (on its own device; the result moves to
    ``device``) with the reference's kinds and scales: ``zeros``, ``ones``,
    or a standard normal times ``scale``, by default ``fan_in ** -0.5`` with
    fan-in ``shape[-2]`` (``shape[-1]`` for a vector).
    """

    def __init__(self, mode: str, generator: torch.Generator | None = None,
                 dtype=torch.float32, device="cpu"):
        assert mode in ("spec", "init")
        if mode == "init" and generator is None:
            raise ValueError("Maker('init') needs a torch.Generator")
        self.mode = mode
        self.dtype = dtype
        self.device = device
        self._gen = generator

    def __call__(self, shape, kind: str = "normal", scale: float | None = None):
        shape = tuple(shape)
        if self.mode == "spec":
            return torch.empty(shape, dtype=self.dtype, device="meta")
        if kind == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if kind == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = fan_in ** -0.5
        x = torch.randn(shape, generator=self._gen, dtype=torch.float32,
                        device=self._gen.device)
        return (x * scale).to(device=self.device, dtype=self.dtype)


def einsum(eq: str, *ops):
    """``torch.einsum`` with ``jnp.einsum``'s promotion of mixed dtypes (a
    float32 query against a bfloat16 cache), which torch refuses."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def rmsnorm(x, w, eps: float = 1e-5):
    """Variance in float32, ``rsqrt``, back to ``x``'s dtype, then ``* w``."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w


def _rope_freqs(hd: int, theta: float, positions):
    half = hd // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = 1.0 / (theta ** (ar / half))
    ang = positions.float()[..., None] * freq  # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def rope(x, positions, theta: float = 1e4):
    """Half-split RoPE (not interleaved). x: (..., S, H, hd); positions:
    broadcastable to (..., S)."""
    hd = x.shape[-1]
    cos, sin = _rope_freqs(hd, theta, positions)
    cos = cos[..., :, None, :]  # (..., S, 1, half)
    sin = sin[..., :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, offset: int = 0, device="cpu"):
    """Sinusoidal table (seq, d), computed in numpy as the reference does."""
    pos = np.arange(offset, offset + seq, dtype=np.float32)
    half = d // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32) / max(half - 1, 1))
    ang = pos[:, None] * freq[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    # the reference's jnp.asarray rounds numpy's (possibly float64) table
    return torch.from_numpy(table.astype(np.float32)).to(device)


def sinusoidal_position_at(pos, d: int, device="cpu"):
    """Single-position sinusoidal embedding in float32 ops (decode path)."""
    half = d // 2
    freq = torch.exp(-torch.log(torch.tensor(10000.0, device=device))
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))
    ang = torch.as_tensor(pos, device=device).float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)])


def gelu(x):
    return F.gelu(x, approximate="tanh")


def swiglu_act(gate, up):
    return F.silu(gate) * up
