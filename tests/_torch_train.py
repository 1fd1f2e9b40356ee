"""Shared by tests/test_torch_train_grads*.py: the port's loss gradients
(``repro_torch.models.lm_loss`` under ``torch.autograd``, through the
hand-written flash backward) against the reference's
``jax.value_and_grad(lm_loss)``, on the CPU, for each reduced config.

Weights are the reference's ``init_params``, carried over by
``models.convert``; the batch is numpy-seeded; float32.  Tolerance: the
loss and aux values within rtol 1e-5; every grad leaf within 1e-4 of that
leaf's largest |grad| (absolute), and rtol 1e-4.
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.configs as rconfigs
import repro.models as R

import repro_torch.configs as tconfigs
import repro_torch.models as T
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import from_reference

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-4
NAMES = sorted(rconfigs.ARCHS)
RST = R.ModelSettings(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none",
                      compute_dtype=jnp.float32)
TST = T.ModelSettings(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none",
                      compute_dtype=torch.float32)


def make_batch(cfg, B=2, S=32, seed=0):
    """numpy arrays, as tests/test_models_smoke.py's ``make_batch`` draws them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def port_value_and_grad(params, batch, cfg, st):
    p = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    leaves = [a for _, a in tree_leaves(p)]
    loss, metrics = T.lm_loss(p, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, st)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss, metrics, {path: g for (path, _), g in zip(tree_leaves(p), grads)}


@functools.lru_cache(maxsize=None)
def _reference(name):
    rcfg = rconfigs.reduced(rconfigs.ARCHS[name])
    rp = jax.jit(R.init_params, static_argnums=0)(rcfg, jax.random.PRNGKey(0))
    batch = make_batch(rcfg, seed=1)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: R.lm_loss(p, b, rcfg, RST), has_aux=True))(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, rp), batch, float(loss),
            {k: float(v) for k, v in metrics.items()},
            dict(tree_leaves(jax.tree.map(np.asarray, grads))))


def check_loss_and_grads(name):
    """The port's loss, aux values and every grad leaf against the reference's."""
    rp, batch, want_loss, want_metrics, want_grads = _reference(name)
    tcfg = tconfigs.reduced(tconfigs.ARCHS[name])
    loss, metrics, grads = port_value_and_grad(from_reference(rp, device="cpu"), batch,
                                               tcfg, TST)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    for k, w in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), w, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert sorted(grads) == sorted(want_grads)
    for path, g in grads.items():
        w = want_grads[path]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SCALE * float(np.abs(w).max()),
                                   err_msg="/".join(path))


