"""Serve-step builders: batched single-token decode and prompt prefill over
a device mesh (port of ``repro.serve.step``).

Each builder returns ``(fn, jit_for)`` as the reference's does.  ``fn``
runs eagerly on whole trees on the mesh's device.  ``jit_for`` lays the
inputs out by ``param_shardings``, ``cache_shardings`` and
``batch_shardings`` (the reference's in-shardings): its step takes this
rank's blocks, gathers them at use, runs ``fn`` on the whole batch and
returns the logits whole and the cache as this rank's block.  On a mesh of
one device every block is the whole tensor and nothing is gathered.
Tokens and frames are moved to the mesh's device.  ``donate_cache=True``
updates the caller's cache in place, as the reference's donated buffers
are; ``False`` decodes into a copy and leaves the caller's cache as it
was.  The compressed-field analogue,
:class:`~repro_torch.serve.region.FieldRegionServer`, is re-exported here
as the reference re-exports it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models import ModelSettings, decode_step, prefill
from repro_torch.train.sharding import (batch_shardings, cache_shardings, gather_tree,
                                        local_tree, param_shardings)

from .region import FieldRegionServer  # noqa: F401  (the reference's re-export)

__all__ = ["build_decode_step", "build_prefill_step", "FieldRegionServer"]


def build_decode_step(cfg, mesh, *, settings: ModelSettings = ModelSettings(),
                      donate_cache: bool = True):
    """decode(params, cache, token, pos) -> (logits, new_cache)."""
    dev = torch.device(mesh.device_type)

    @torch.no_grad()
    def fn(params, cache, token, pos):
        if not donate_cache:
            cache = {k: v.clone() for k, v in cache.items()}
        return decode_step(params, cache, token.to(dev), pos, cfg, settings)

    def jit_for(param_tree, cache_tree, token_spec):
        param_sh = param_shardings(param_tree, mesh, hybrid=(cfg.family == "hybrid"))
        cache_sh = cache_shardings(cache_tree, mesh)
        token_sh = batch_shardings(token_spec, mesh)

        def step(params, cache, token, pos):
            whole = gather_tree(cache, cache_sh)
            logits, new = fn(gather_tree(params, param_sh), whole,
                             token_sh.gather(token.to(dev)), pos)
            new = local_tree(new, cache_sh)
            if donate_cache:
                new = {k: v if v is cache[k] else cache[k].copy_(v) for k, v in new.items()}
            return logits, new

        return step

    return fn, jit_for


def build_prefill_step(cfg, mesh, *, settings: ModelSettings = ModelSettings()):
    """prefill(params, tokens, frames=None) -> last-position logits (B, V)."""
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    nb = 1
    for a in baxes:
        nb *= sizes[a]
    settings = dataclasses.replace(settings, batch_axes=baxes, n_model=sizes["model"],
                                   n_batch=nb)
    dev = torch.device(mesh.device_type)

    @torch.no_grad()
    def fn(params, tokens, frames=None):
        return prefill(params, tokens.to(dev), cfg, settings,
                       enc_inputs=None if frames is None else frames.to(dev))

    def jit_for(param_tree, batch_specs):
        """Returns (step, the number of its arguments: 2, or 3 with frames)."""
        param_sh = param_shardings(param_tree, mesh, hybrid=(cfg.family == "hybrid"))
        batch_sh = batch_shardings(batch_specs, mesh)

        def step(params, tokens, frames=None):
            whole = gather_tree(params, param_sh)
            tokens = batch_sh["tokens"].gather(tokens.to(dev))
            if frames is not None:
                frames = batch_sh["frames"].gather(frames.to(dev))
            return fn(whole, tokens, frames)

        return step, 3 if "frames" in batch_specs else 2

    return fn, jit_for
