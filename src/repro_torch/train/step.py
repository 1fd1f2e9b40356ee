"""Train-step builder: loss -> grads -> AdamW on one torch device (port of
``repro.train.step``, without a mesh).

The reference jits the step over a mesh with explicit shardings and returns
``(train_step, jit_for, state_sh)``; the port runs ``train_step`` eagerly on
``device`` and returns it alone, as :mod:`repro_torch.serve.step`'s builders
do (the mesh arrives with ROADMAP item 10b-ii).  Gradients come from
``torch.autograd.grad`` on the leaves of ``state["params"]``; the
attention backward is the hand-written one of
:mod:`repro_torch.models.attention`.  Cross-pod gradient compression
(``grad_compress``) is ROADMAP item 10c.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.schemes import torch_device
from repro_torch.models import ModelSettings, init_params, lm_loss, param_specs
from repro_torch.models.common import tree_leaves, tree_map

from .optim import OptConfig, adamw_step, init_opt_state

__all__ = ["build_train_step", "train_state_specs", "init_train_state"]


def _no_grad_compress(grad_compress) -> None:
    if grad_compress:
        raise NotImplementedError(
            f"grad_compress={grad_compress!r}: gradient compression is ROADMAP item 10c")


def train_state_specs(cfg, dtype=torch.float32, grad_compress=None, param_dtype=None):
    """The train state as ``meta`` tensors: params (``param_dtype`` or
    ``dtype``), m and v (``dtype``), step (int32, 0-d)."""
    _no_grad_compress(grad_compress)
    mv = param_specs(cfg, dtype)
    return {"params": param_specs(cfg, param_dtype or dtype), "m": mv, "v": mv,
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def init_train_state(cfg, generator: torch.Generator, grad_compress=None,
                     device=DEFAULT_DEVICE):
    """Random parameters from ``generator`` and a fresh optimizer state,
    all on ``device``."""
    _no_grad_compress(grad_compress)
    params = init_params(cfg, generator, device=torch_device(device))
    return {"params": params, **init_opt_state(params)}


def build_train_step(cfg, device, *, settings: ModelSettings = ModelSettings(),
                     opt: OptConfig = OptConfig(), grad_compress: str | None = None,
                     donate: bool = True, micro_batches: int = 1, param_dtype=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics with
    the reference's keys: ``loss``, ``ce``, the aux losses, ``grad_norm``
    and ``lr`` (0-d tensors).

    ``micro_batches > 1`` splits the batch along its first axis and sums
    the micro-batches' grads in float32, then scales by ``1/micro_batches``,
    as the reference's scan does.  ``donate=True`` writes the new params, m,
    v and step into the state's tensors (the reference's donated buffers);
    ``False`` leaves the caller's state as it was.  ``param_dtype`` (the
    reference's low-precision parameters under a mesh) is ROADMAP item
    10b-ii: anything but ``None`` raises."""
    _no_grad_compress(grad_compress)
    if param_dtype is not None:
        raise NotImplementedError(
            f"param_dtype={param_dtype!r}: parameters in another dtype than the "
            "optimizer's come with the mesh, ROADMAP item 10b-ii")
    dev = torch_device(device)
    settings = dataclasses.replace(settings, n_model=1, n_batch=1)

    def value_and_grad(params, batch):
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        live = [a for _, a in tree_leaves(p)]
        with torch.enable_grad():
            loss, metrics = lm_loss(p, batch, cfg, settings)
            # a leaf the loss does not reach gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        by_leaf = dict(zip(map(id, live), grads))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda a: by_leaf[id(a)], p)

    def grads_of(params, batch):
        if micro_batches == 1:
            return value_and_grad(params, batch)
        mb = {k: v.reshape(micro_batches, v.shape[0] // micro_batches, *v.shape[1:])
              for k, v in batch.items()}
        g_acc = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
                         params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(micro_batches):
            loss, _, g = value_and_grad(params, {k: v[i] for k, v in mb.items()})
            g_acc = tree_map(lambda a, b: a + b.to(torch.float32), g_acc, g)
            loss_sum = loss_sum + loss
        inv = 1.0 / micro_batches
        loss = loss_sum * inv
        return loss, {"ce": loss}, tree_map(lambda a: a * inv, g_acc)

    def train_step(state, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        loss, metrics, grads = grads_of(state["params"], batch)
        with torch.no_grad():
            params, opt_state, om = adamw_step(
                state["params"], grads,
                {"m": state["m"], "v": state["v"], "step": state["step"]}, opt)
            new_state = {"params": params, **opt_state}
            if donate:
                tree_map(lambda old, new: old.copy_(new), state, new_state)
                new_state = state
        return new_state, {"loss": loss, **metrics, **om}

    return train_step

