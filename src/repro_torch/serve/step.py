"""Serve-step builders: batched single-token decode and prompt prefill over
a device mesh (port of ``repro.serve.step``).

Each builder returns ``(fn, jit_for)`` as the reference's does.  ``fn``
runs eagerly on whole trees on the mesh's device.  ``jit_for`` lays the
inputs out by ``param_shardings``, ``cache_shardings`` and
``batch_shardings`` (the reference's in-shardings) and partitions the
compute, ZeRO-3 as the reference states it: its step takes this rank's
blocks and computes this rank's rows, gathering one layer's parameters at
a time inside the layer loop.  Decode keeps the cache in its block: the
rank whose slice of the KV sequence holds ``pos`` writes the new KV, each
rank attends over its slice and the "model" ranks merge their partial
softmaxes; a recurrent state is gathered over "model" one layer at a
time.  A MoE layer whose groups span ranks (decode's few rows) gathers
its input rows.  The logits come back whole (the rows gathered), the
cache as this rank's block.  On a mesh of one device every block is the
whole tensor and the step is ``fn``.  Tokens and frames are moved to the
mesh's device.  ``donate_cache=True`` updates the caller's cache in place,
as the reference's donated buffers are; ``False`` decodes into a copy and
leaves the caller's cache as it was.  The compressed-field analogue,
:class:`~repro_torch.serve.region.FieldRegionServer`, is re-exported here
as the reference re-exports it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models import ModelSettings, decode_step, prefill
from repro_torch.train.sharding import (NamedSharding, Partition, PartitionSpec,
                                        batch_shardings, cache_shardings, param_shardings,
                                        sharded_tree)

from .region import FieldRegionServer  # noqa: F401  (the reference's re-export)

__all__ = ["build_decode_step", "build_prefill_step", "FieldRegionServer"]


def _cache_rows(cache_sh):
    """The partition-spec entry of the cache's batch dim (every leaf has
    the same batch, so the same entry)."""
    name, sh = next(iter(cache_sh.items()))
    return sh.spec[2 if name in ("ssm", "conv") else 1]


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
        if mesh.size() == 1:
            return fn
        param_sh = param_shardings(param_tree, mesh, hybrid=(cfg.family == "hybrid"))
        cache_sh = cache_shardings(cache_tree, mesh)
        token_sh = batch_shardings(token_spec, mesh)
        rows = _cache_rows(cache_sh)
        part = Partition(mesh, rows, cache_sh)

        @torch.no_grad()
        def step(params, cache, token, pos):
            token = token.to(dev)
            if token_sh.spec[0] != rows:    # the cache's rows, not the tokens'
                token = NamedSharding(mesh, PartitionSpec(rows, None)).local(
                    token_sh.gather(token))
            work = cache if donate_cache else {k: v.clone() for k, v in cache.items()}
            logits, new = decode_step(sharded_tree(params, param_sh), work, token, pos, cfg,
                                      settings, part)
            return part.all_rows(logits), new

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
        nargs = 3 if "frames" in batch_specs else 2
        if mesh.size() == 1:
            return fn, nargs
        param_sh = param_shardings(param_tree, mesh, hybrid=(cfg.family == "hybrid"))
        part = Partition(mesh, batch_shardings(batch_specs, mesh)["tokens"].spec[0])

        @torch.no_grad()
        def step(params, tokens, frames=None):
            logits = prefill(sharded_tree(params, param_sh), tokens.to(dev), cfg, settings,
                             enc_inputs=None if frames is None else frames.to(dev),
                             part=part)
            return part.all_rows(logits)

        return step, nargs

    return fn, jit_for
