"""Train-step builder: loss -> grads -> (optional compressed cross-pod
reduce) -> AdamW over a device mesh (port of ``repro.train.step``).

The mesh is a ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`) and the state
is laid out by :func:`train_state_shardings`.  ZeRO-3 as the reference
states it: a rank holds its blocks of the parameters and moments and its
rows of the batch.  The model takes the parameters as
``train.sharding.TrainBlock`` leaves and gathers one layer's slice whole
at a time, inside the layer (with remat, again in the backward); the
gather's backward reduces that layer's gradient into the moments' block
as the backward produces it (reduce-scatter over a batch axis that splits
the leaf, all-reduce over one that does not, averaged over the batch
ranks; the "model" ranks compute the same rows, so their equal gradients
are sliced).  Autograd differentiates per-layer anchors of the moments'
block shape, so the gradients come out as blocks, and the micro-batches
accumulate into float32 blocks; AdamW runs on the blocks.  The attention
backward is the hand-written one of :mod:`repro_torch.models.attention`.
The global-norm clip sums the squares of every leaf's blocks once (a rank
adds a leaf only where its coordinate is 0 on each axis the leaf is
replicated over) in one all-reduce.  With ``grad_compress`` set and a
"pod" axis present, the backward reduces each layer's gradient over the
pod's "data" ranks alone, and the blocks of the pod's mean gradient and of
the residual go through
:func:`~repro_torch.train.grad_compress.compress_blocks` (top-k with error
feedback across pods, one piece of a leaf gathered whole inside the pod at
a time).  On a mesh of one device every block is the whole tensor and the
step is the single-device step: nothing is gathered and no collective
runs.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.schemes import torch_device
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models import ModelSettings, init_params, lm_loss, param_specs
from repro_torch.models.common import tree_leaves, tree_map

from .optim import OptConfig, _recip, adamw_update, init_opt_state
from .sharding import (TrainBlock, _axes, _n_stack_dims, _with_path, _zip_map,
                       batch_shardings, gather_tree, local_tree, path_str, state_shardings)

__all__ = ["build_train_step", "train_state_specs", "train_state_shardings",
           "init_train_state"]


def train_state_specs(cfg, dtype=torch.float32, grad_compress=None, param_dtype=None):
    """The train state as ``meta`` tensors: params (``param_dtype`` or
    ``dtype``), m and v (``dtype``), step (int32, 0-d), and with
    ``grad_compress`` the error-feedback ``residual`` (``dtype``)."""
    mv = param_specs(cfg, dtype)
    state = {"params": param_specs(cfg, param_dtype or dtype), "m": mv, "v": mv,
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    if grad_compress:
        state["residual"] = mv  # error-feedback memory
    return state


def train_state_shardings(cfg, mesh, grad_compress=None, mode: str = "fsdp",
                          param_dtype=None):
    return state_shardings(
        train_state_specs(cfg, grad_compress=grad_compress, param_dtype=param_dtype),
        mesh, hybrid=(cfg.family == "hybrid"), mode=mode)


def init_train_state(cfg, generator: torch.Generator, grad_compress=None,
                     device=DEFAULT_DEVICE):
    """Random parameters from ``generator`` and a fresh optimizer state
    (and a zero residual with ``grad_compress``), all on ``device``."""
    params = init_params(cfg, generator, device=torch_device(device))
    state = {"params": params, **init_opt_state(params)}
    if grad_compress:
        state["residual"] = tree_map(torch.zeros_like, params)
    return state


def _value_and_grad(params, batch, cfg, settings):
    """(loss, metrics, grads) of ``lm_loss`` at ``params``, detached; a leaf
    the loss does not reach gets zeros, as ``jax.grad`` gives it."""
    p = tree_map(lambda a: a.detach().requires_grad_(True), params)
    live = [a for _, a in tree_leaves(p)]
    with torch.enable_grad():
        loss, metrics = lm_loss(p, batch, cfg, settings)
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    by_leaf = dict(zip(map(id, live), grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda a: by_leaf[id(a)], p)


def _axes_sum(x, mesh, axes) -> tuple[torch.Tensor, int]:
    """``x`` summed over each of ``axes``' groups (a new tensor, ``x``
    itself where every group has size 1); and the count of ranks summed."""
    sizes, n = axis_sizes(mesh), 1
    for a in axes:
        if sizes[a] > 1:
            x = x.clone() if n == 1 else x
            dist.all_reduce(x, group=mesh.get_group(a))
            n *= sizes[a]
    return x, n


def _mean(x, mesh, axes):
    x, n = _axes_sum(x, mesh, axes)
    return x if n == 1 else x * _recip(n)


def _batch_mean(loss, metrics, grads, mesh, axes):
    """The loss, metrics and whole grads averaged over ``axes``."""
    return (_mean(loss, mesh, axes), {k: _mean(v, mesh, axes) for k, v in metrics.items()},
            tree_map(lambda g: _mean(g, mesh, axes), grads))


def _stack_dims(path, block, hybrid: bool) -> int:
    """The leading stack dims of a parameter's block (never split)."""
    return min(_n_stack_dims(path_str(path), hybrid), block.dim() - 1) if block.dim() else 0


def _anchor(shape, n_stack: int, dtype, device):
    """One leaf per layer (nested lists over ``n_stack`` stack dims) of a
    block's layer shape: zero-strided zeros that autograd differentiates
    in a :class:`TrainBlock`'s place."""
    if n_stack == 0:
        return torch.zeros((), dtype=dtype, device=device).expand(shape).requires_grad_(True)
    return [_anchor(shape[1:], n_stack - 1, dtype, device) for _ in range(shape[0])]


def _flat(x) -> list:
    return [a for y in x for a in _flat(y)] if isinstance(x, list) else [x]


def _stacked(anchor, grads: dict):
    """The grads of ``anchor``'s leaves, stacked back into the block."""
    if isinstance(anchor, list):
        return torch.stack([_stacked(a, grads) for a in anchor])
    return grads[id(anchor)]


def _block_value_and_grad(blocks, batch, cfg, settings, param_sh, grad_sh, reduce_over):
    """(loss, metrics, grads) of ``lm_loss`` at this rank's parameter
    ``blocks`` over its rows: the grads are the batch ranks' mean, in
    ``grad_sh``'s blocks, reduced layer by layer as the backward makes
    them (:class:`TrainBlock`)."""
    hybrid = cfg.family == "hybrid"

    def leaf(path, block, sh, gsh):
        anchor = _anchor(gsh.shard_shape(_whole_shape(block, sh)),
                         _stack_dims(path, block, hybrid), block.dtype, block.device)
        return TrainBlock(block.detach(), sh, anchor, gsh, reduce_over)

    tree = _with_path(lambda path, b: leaf(path, b, _at(param_sh, path), _at(grad_sh, path)),
                      blocks)
    live = [t.anchor for _, t in tree_leaves(tree)]
    anchors = [a for x in live for a in _flat(x)]
    with torch.enable_grad():
        loss, metrics = lm_loss(tree, batch, cfg, settings)
        grads = torch.autograd.grad(loss, anchors, allow_unused=True, materialize_grads=True)
    by_id = dict(zip(map(id, anchors), grads))
    del grads
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _zip_map(lambda t, _: _stacked(t.anchor, by_id), tree,
                                            blocks)


def _whole_shape(block, sh) -> tuple:
    """The global shape of ``block`` under ``sh``."""
    return tuple(s * sh._block(d)[1] for d, s in enumerate(block.shape))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _relayout(tree, src, dst, hybrid: bool):
    """Blocks under ``src`` -> blocks under ``dst`` (the ``"tp"``
    parameters' and moments' placements differ), one layer's slice of a
    leaf whole at a time."""
    def one(block, a, b, n_stack):
        if a.spec == b.spec:
            return block
        if n_stack == 0:
            return b.local(a.gather(block))
        return torch.stack([one(x, a.sub(1), b.sub(1), n_stack - 1) for x in block])

    def leaf(path, block):
        return one(block, _at(src, path), _at(dst, path), _stack_dims(path, block, hybrid))

    return _with_path(leaf, tree)


def _sharded_norm(grads, shardings, mesh):
    """The global norm of a tree of blocks: each leaf's squares counted once
    over the mesh (by the ranks at coordinate 0 on every axis the leaf is
    replicated over), summed in one all-reduce."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    total = None
    for (_, g), (_, sh) in zip(tree_leaves(grads), tree_leaves(shardings)):
        used = {a for part in sh.spec for a in _axes(part)}
        if any(c != 0 for a, c in coord.items() if a not in used):
            continue
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=next(tree_leaves(grads))[1].device)
    if mesh.size() > 1:
        dist.all_reduce(total)
    return torch.sqrt(total)


def _block_shapes(specs, shardings) -> dict:
    return {p: sh.shard_shape(s.shape) for (p, s), (_, sh)
            in zip(tree_leaves(specs), tree_leaves(shardings))}


def _check_blocks(tree, shapes: dict, what: str) -> None:
    got = {p: tuple(a.shape) for p, a in tree_leaves(tree)}
    if got != shapes:
        bad = {path_str(p): (got.get(p), shapes.get(p)) for p in set(got) | set(shapes)
               if got.get(p) != shapes.get(p)}
        raise ValueError(f"{what}: not this rank's blocks (got, want): {bad}")


def build_train_step(cfg, mesh, *, settings: ModelSettings = ModelSettings(),
                     opt: OptConfig = OptConfig(), grad_compress: str | None = None,
                     donate: bool = True, micro_batches: int = 1,
                     sharding_mode: str = "fsdp", param_dtype=None):
    """Returns ``(train_step, jit_for, state_sh)``.

    ``jit_for(batch_specs)`` (the global batch's shapes) returns
    ``step(state, batch) -> (state, metrics)`` over this rank's blocks of
    the state (laid out by ``state_sh``) and its rows of the batch (its
    ``batch_shardings`` block); metrics carry the reference's keys
    (``loss``, ``ce``, the aux losses, ``grad_norm``, ``lr``, and with the
    compressed branch ``grad_compress_ratio`` and ``grad_compress_leaves``)
    as 0-d tensors.  ``train_step(state, batch)`` takes and returns the
    whole state and batch (every rank passes the same), through ``step``.

    ``micro_batches > 1`` splits a rank's rows along the first axis and sums
    the micro-batches' grads in float32, then scales by ``1/micro_batches``.
    ``donate=True`` writes the new state into the given tensors (the
    reference's donated buffers); ``False`` leaves them as they were.
    ``param_dtype`` sets the parameters' dtype in the state's specs and
    shardings, as in the reference."""
    from . import grad_compress as gc

    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    nb = 1
    for a in baxes:
        nb *= sizes[a]
    settings = dataclasses.replace(settings, batch_axes=baxes, n_model=sizes["model"],
                                   n_batch=nb)
    multi_pod = "pod" in mesh.mesh_dim_names
    dev = torch.device(mesh.device_type)
    specs = train_state_specs(cfg, grad_compress=grad_compress, param_dtype=param_dtype)
    state_sh = train_state_shardings(cfg, mesh, grad_compress=grad_compress,
                                     mode=sharding_mode, param_dtype=param_dtype)
    state_shapes = _block_shapes(specs, state_sh)
    # the grads reduce to the moments' placement, where AdamW runs
    moment_sh = state_sh["m"]
    whole_params = mesh.size() == 1    # every block the whole tensor
    same_layout = whole_params or all(
        a.spec == b.spec for (_, a), (_, b)
        in zip(tree_leaves(state_sh["params"]), tree_leaves(moment_sh)))
    hybrid = cfg.family == "hybrid"
    # the compressed branch reduces within a pod: over its "data" ranks
    compressed = bool(grad_compress) and multi_pod
    if compressed:
        settings = gc._pod_settings(settings, sizes["pod"])
        baxes = settings.batch_axes
    reduce_over = (mesh, baxes, settings.n_batch)

    def grads_one(params, batch):
        if whole_params:
            return _value_and_grad(params, batch, cfg, settings)
        return _block_value_and_grad(params, batch, cfg, settings, state_sh["params"],
                                     moment_sh, reduce_over)

    def grads_of(params, batch):
        if micro_batches == 1:
            return grads_one(params, batch)
        mb = {k: v.reshape(micro_batches, v.shape[0] // micro_batches, *v.shape[1:])
              for k, v in batch.items()}
        # float32 blocks of the moments' placement
        g_acc = _with_path(lambda path, a: torch.zeros(
            _at(moment_sh, path).shard_shape(_whole_shape(a, _at(state_sh["params"], path))),
            dtype=torch.float32, device=a.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(micro_batches):
            loss, _, g = grads_one(params, {k: v[i] for k, v in mb.items()})
            g_acc = tree_map(lambda a, b: a + b.to(torch.float32), g_acc, g)
            loss_sum = loss_sum + loss
        inv = 1.0 / micro_batches
        loss = loss_sum * inv
        return loss, {"ce": loss}, tree_map(lambda a: a * inv, g_acc)

    def local_step(state, batch):
        loss, metrics, grads = grads_of(state["params"], batch)
        loss, metrics = _mean(loss, mesh, baxes), {k: _mean(v, mesh, baxes)
                                                   for k, v in metrics.items()}
        residual = state.get("residual")
        if compressed:
            (loss, metrics), grads, residual, cmx = gc.compress_blocks(
                loss, metrics, grads, residual, moment_sh, mesh, method=grad_compress)
            metrics = {**metrics, **cmx}
        with torch.no_grad():
            p = state["params"] if same_layout else _relayout(
                state["params"], state_sh["params"], moment_sh, hybrid)
            new_p, opt_state, om = adamw_update(
                p, grads, {"m": state["m"], "v": state["v"], "step": state["step"]}, opt,
                _sharded_norm(grads, moment_sh, mesh))
            if not same_layout:
                new_p = _relayout(new_p, moment_sh, state_sh["params"], hybrid)
            new_state = {"params": new_p, **opt_state}
            if residual is not None:
                new_state["residual"] = residual
            if donate:
                tree_map(lambda old, new: old.copy_(new), state, new_state)
                new_state = state
        return new_state, {"loss": loss, **metrics, **om}

    def jit_for(batch_specs):
        batch_sh = batch_shardings(batch_specs, mesh)
        batch_shapes = _block_shapes(batch_specs, batch_sh)

        def step(state, batch):
            _check_blocks(state, state_shapes, "the train state")
            _check_blocks(batch, batch_shapes, "the batch")
            return local_step(state, {k: v.to(dev) for k, v in batch.items()})

        return step

    def train_step(state, batch):
        local = local_tree(state, state_sh)
        new, metrics = jit_for(batch)(local, local_tree(batch, batch_shardings(batch, mesh)))
        new = gather_tree(new, state_sh)
        if donate:
            new = tree_map(lambda old, x: x if x is old else old.copy_(x), state, new)
        return new, metrics

    return train_step, jit_for, state_sh
