"""Carry parameter and cache trees between the JAX package and the port.

Both packages key their trees the same way (nested dicts of arrays), so a
conversion is leaf for leaf: :func:`from_reference` takes the reference's
tree (numpy arrays, or anything ``np.asarray`` reads, such as JAX arrays)
to torch tensors on a device, :func:`to_reference` takes a port tree back
to numpy.  :func:`state_from_reference` and :func:`state_to_reference` carry
a whole train state (``params``, ``m``, ``v``, ``step``, and ``residual``
with gradient compression) and check its form: m, v and residual float32,
step a 0-d int32.  bfloat16 travels as its bits, so
neither direction needs ``ml_dtypes`` unless a bfloat16 numpy array is
asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.schemes import torch_device

from .common import tree_leaves, tree_map

__all__ = ["from_reference", "to_reference", "state_from_reference", "state_to_reference"]


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


_STATE_KEYS = ("m", "params", "step", "v")
_COMPRESSED_KEYS = ("m", "params", "residual", "step", "v")   # with grad_compress


def _check_state(state, float32, int32) -> None:
    keys = tuple(sorted(state))
    if keys not in (_STATE_KEYS, _COMPRESSED_KEYS):
        raise ValueError(f"a train state has the keys {_STATE_KEYS} (and 'residual' with "
                         f"grad_compress), not {keys}")
    for k in sorted({"m", "v", "residual"} & set(keys)):
        bad = [a.dtype for _, a in tree_leaves(state[k]) if a.dtype != float32]
        if bad:
            raise ValueError(f"train state {k!r} must be float32, has {bad[0]}")
    if state["step"].dtype != int32 or tuple(state["step"].shape) != ():
        raise ValueError(f"train state 'step' must be a 0-d int32, is {state['step'].dtype} "
                         f"of shape {tuple(state['step'].shape)}")


def state_from_reference(state, device=DEFAULT_DEVICE):
    """The reference's train state (``init_train_state``'s tree, or a
    jitted step's) as the port's, on ``device``."""
    out = from_reference(state, device)
    _check_state(out, torch.float32, torch.int32)
    return out


def state_to_reference(state):
    """The port's train state as numpy arrays, the reference's tree."""
    out = to_reference(state)
    _check_state(out, np.float32, np.int32)
    return out
