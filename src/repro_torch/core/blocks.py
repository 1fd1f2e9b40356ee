"""Block-structured layout for 3D fields (port of ``repro.core.blocks``).

A field of shape (nx, ny, nz) is cut into cubic blocks of side ``bs`` (a
power of two).  Blocks are independent compression units: the "on the
interval" wavelets need no halo, so a kernel can give each block its own
CTA.  Both functions take a torch tensor (on any device) or a numpy array
and return the same kind.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["blockify", "unblockify", "num_blocks", "check_block_size"]


def check_block_size(bs: int) -> None:
    if bs < 4 or (bs & (bs - 1)) != 0:
        raise ValueError(f"block size must be a power of 2 and >= 4, got {bs}")


def num_blocks(shape: tuple[int, int, int], bs: int) -> tuple[int, int, int]:
    check_block_size(bs)
    for s in shape:
        if s % bs != 0:
            raise ValueError(f"field shape {shape} not divisible by block size {bs}")
    return tuple(s // bs for s in shape)


def _permute(a, axes):
    return a.permute(*axes) if isinstance(a, torch.Tensor) else np.transpose(a, axes)


def blockify(field, bs: int):
    """(nx, ny, nz) -> (n_blocks, bs, bs, bs), C-order block raster."""
    nx, ny, nz = field.shape
    bx, by, bz = num_blocks((nx, ny, nz), bs)
    f = _permute(field.reshape(bx, bs, by, bs, bz, bs), (0, 2, 4, 1, 3, 5))
    return f.reshape(bx * by * bz, bs, bs, bs)


def unblockify(blocks, shape: tuple[int, int, int]):
    """(n_blocks, bs, bs, bs) -> (nx, ny, nz); inverse of :func:`blockify`."""
    bs = blocks.shape[-1]
    nx, ny, nz = shape
    bx, by, bz = num_blocks((nx, ny, nz), bs)
    f = _permute(blocks.reshape(bx, by, bz, bs, bs, bs), (0, 3, 1, 4, 2, 5))
    return f.reshape(nx, ny, nz)
