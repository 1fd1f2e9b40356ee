"""Carry parameter and cache trees between the JAX package and the port.

Both packages key their trees the same way (nested dicts of arrays), so a
conversion is leaf for leaf: :func:`from_reference` takes the reference's
tree (numpy arrays, or anything ``np.asarray`` reads, such as JAX arrays)
to torch tensors on a device, :func:`to_reference` takes a port tree back
to numpy.  bfloat16 travels as its bits, so neither direction needs
``ml_dtypes`` unless a bfloat16 numpy array is asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.schemes import torch_device

from .common import tree_map

__all__ = ["from_reference", "to_reference"]


def _to_torch(leaf, dev):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def _to_numpy(leaf):
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # a bfloat16 numpy array needs its dtype

        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def from_reference(tree, device=DEFAULT_DEVICE):
    """The reference's parameter or cache tree as torch tensors on
    ``device``, key for key."""
    dev = torch_device(device)
    return tree_map(lambda a: _to_torch(a, dev), tree)


def to_reference(tree):
    """A port tree back to numpy arrays, key for key."""
    return tree_map(_to_numpy, tree)
