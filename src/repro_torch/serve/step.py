"""Serve-step builders: batched single-token decode and prompt prefill on
one torch device (port of ``repro.serve.step``).

Each builder returns ``fn`` with the reference's call signature.  The
reference jits ``fn`` over a mesh; the port runs it eagerly on ``device``
(the mesh and its shardings arrive with ROADMAP items 10b and 10c).
The parameters and the cache must already lie on ``device``; tokens and
frames are moved there.
``donate_cache=True`` updates the caller's cache in place, as the
reference's donated buffers are; ``False`` decodes into a clone and leaves
the caller's cache as it was.  The compressed-field analogue,
:class:`~repro_torch.serve.region.FieldRegionServer`, is re-exported here
as the reference re-exports it.
"""
from __future__ import annotations

import torch

from repro_torch.core.schemes import torch_device
from repro_torch.models import ModelSettings, decode_step, prefill

from .region import FieldRegionServer  # noqa: F401  (the reference's re-export)

__all__ = ["build_decode_step", "build_prefill_step", "FieldRegionServer"]


def build_decode_step(cfg, device, *, settings: ModelSettings = ModelSettings(),
                      donate_cache: bool = True):
    """decode(params, cache, token, pos) -> (logits, new_cache)."""
    dev = torch_device(device)

    @torch.no_grad()
    def fn(params, cache, token, pos):
        if not donate_cache:
            cache = {k: v.clone() for k, v in cache.items()}
        return decode_step(params, cache, token.to(dev), pos, cfg, settings)

    return fn


def build_prefill_step(cfg, device, *, settings: ModelSettings = ModelSettings()):
    """prefill(params, tokens, frames=None) -> last-position logits (B, V)."""
    dev = torch_device(device)

    @torch.no_grad()
    def fn(params, tokens, frames=None):
        return prefill(params, tokens.to(dev), cfg, settings,
                       enc_inputs=None if frames is None else frames.to(dev))

    return fn
