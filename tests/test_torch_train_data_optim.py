"""The port's training data, cost model and optimizer (``repro_torch.data``,
``repro_torch.models.costs``, ``repro_torch.train.optim``) against the JAX
package's, on the CPU.

Tolerances: batches bit for bit; costs equal.  ``lr_at`` against the
reference's jitted one (as its train step runs it): the warm-up bit for
bit (XLA turns the division by a constant into a product with its float32
reciprocal and fuses a multiply-add, and so does the port), the decay
within one float32 ulp of the peak ``cfg.lr``: XLA's float32 ``cos`` and
torch's differ in the last bit for ~5% of arguments, and near the end of
the decay ``1 + cos(pi t)`` cancels, which turns that bit into a few ulps
of the smaller rate.  One
``adamw_step`` within rtol 1e-6 and atol 1e-6 times each leaf's largest
|value| (XLA fuses the update and may contract it into FMAs, one rounding
where the port rounds twice), its ``lr`` as ``lr_at``'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as rconfigs
from repro.data import tokens as rtokens
from repro.models import costs as rcosts
from repro.train import optim as roptim

import repro_torch.configs as tconfigs
from repro_torch.data import tokens as ttokens
from repro_torch.models import costs as tcosts
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import optim as toptim

OPT_RTOL, OPT_ATOL_SCALE = 1e-6, 1e-6


# ---------------------------------------------------------------------------
# data/tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(vocab=64, batch=4, seq=32, seed=9),
    dict(vocab=49152, batch=8, seq=64, seed=0),
    dict(vocab=1000, batch=3, seq=17, seed=5, n_regimes=2, branching=3),
])
def test_batch_at_is_the_references(kw):
    rcfg, tcfg = rtokens.DataConfig(**kw), ttokens.DataConfig(**kw)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
    for step in (0, 1, 5, 99, 12345):
        want, got = rtokens.batch_at(rcfg, step), ttokens.batch_at(tcfg, step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_data_deterministic_and_learnable_structure():
    """The port's copy of tests/test_ckpt_fault.py's test of the same name."""
    cfg = ttokens.DataConfig(vocab=64, batch=4, seq=32, seed=9)
    a = ttokens.batch_at(cfg, 5)
    b = ttokens.batch_at(cfg, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = ttokens.batch_at(cfg, 6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


# ---------------------------------------------------------------------------
# models/costs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(rconfigs.ARCHS))
def test_costs_are_the_references(name):
    rcfg, tcfg = rconfigs.get_arch(name), tconfigs.get_arch(name)
    for active in (True, False):
        assert tcosts.matmul_params(tcfg, active) == rcosts.matmul_params(rcfg, active)
    for shape in rconfigs.SHAPES:
        rs, ts = rconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
        assert tcosts.model_flops(tcfg, ts) == rcosts.model_flops(rcfg, rs)
        for impl in ("masked", "triangular"):
            for remat in ("full", "none"):
                assert (tcosts.detailed_flops(tcfg, ts, attn_impl=impl, remat=remat)
                        == rcosts.detailed_flops(rcfg, rs, attn_impl=impl, remat=remat))


# ---------------------------------------------------------------------------
# train/optim
# ---------------------------------------------------------------------------

def _lr_close(got, want, cfg, warm) -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got[warm], want[warm])
    np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(np.float32(cfg.lr)))


@pytest.mark.parametrize("cfg", [
    roptim.OptConfig(),
    roptim.OptConfig(lr=1e-3, warmup_steps=20, total_steps=100),
    roptim.OptConfig(lr=3e-3, warmup_steps=0, total_steps=7, min_lr_frac=0.25),
    roptim.OptConfig(lr=0.1, warmup_steps=5, total_steps=5),
], ids=["default", "train_cli", "no_warmup", "warmup_is_total"])
def test_lr_at_matches_the_reference(cfg):
    tcfg = toptim.OptConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, cfg.total_steps + 6, dtype=np.int32)
    warm = steps < cfg.warmup_steps
    want = np.asarray(jax.jit(jax.vmap(lambda s: roptim.lr_at(cfg, s)))(jnp.asarray(steps)))
    got = np.stack([toptim.lr_at(tcfg, torch.tensor(s)).numpy() for s in steps])
    _lr_close(got, want, cfg, warm)
    # a Python int step gives the same
    py = [toptim.lr_at(tcfg, int(s)) for s in steps]
    assert all(lr.dtype == torch.float32 and lr.shape == () for lr in py)
    np.testing.assert_array_equal(np.stack([lr.numpy() for lr in py]), got)


def _tree(rng, scale):
    return {"a": {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
                  "b": (rng.standard_normal((5,)) * scale).astype(np.float32)},
            "emb": (rng.standard_normal((11, 3)) * scale).astype(np.float32),
            "z": {"deep": {"x": (rng.standard_normal((2, 3, 4)) * scale).astype(np.float32)}}}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


@pytest.mark.parametrize("grad_scale,clipped", [(0.01, False), (3.0, True)])
@pytest.mark.parametrize("step", [0, 7, 150])
def test_adamw_step_matches_the_reference(grad_scale, clipped, step):
    rng = np.random.default_rng(step + int(grad_scale * 100))
    cfg = roptim.OptConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    tcfg = toptim.OptConfig(**dataclasses.asdict(cfg))
    params, grads = _tree(rng, 1.0), _tree(rng, grad_scale)
    m, v = _tree(rng, 0.1), tree_map(lambda a: np.abs(a), _tree(rng, 0.01))
    ostate = {"m": m, "v": v, "step": np.int32(step)}

    wp, ws, wmet = jax.jit(lambda p, g, o: roptim.adamw_step(p, g, o, cfg))(
        params, grads, jax.tree.map(jnp.asarray, ostate))
    tstate = {"m": _t(m), "v": _t(v), "step": torch.tensor(step, dtype=torch.int32)}
    gp, gs, gmet = toptim.adamw_step(_t(params), _t(grads), tstate, tcfg)

    gnorm = float(wmet["grad_norm"])
    assert (gnorm > cfg.clip_norm) == clipped
    np.testing.assert_allclose(gmet["grad_norm"].numpy(), np.asarray(wmet["grad_norm"]),
                               rtol=OPT_RTOL)
    _lr_close(gmet["lr"].numpy()[None], np.asarray(wmet["lr"])[None], cfg,
              [step < cfg.warmup_steps])
    assert gs["step"].dtype == torch.int32 and int(gs["step"]) == step + 1
    for got, want in ((gp, wp), (gs["m"], ws["m"]), (gs["v"], ws["v"])):
        want = dict(tree_leaves(jax.tree.map(np.asarray, want)))
        for path, leaf in tree_leaves(got):
            w = want[path]
            assert leaf.dtype == torch.float32
            np.testing.assert_allclose(leaf.numpy(), w, rtol=OPT_RTOL,
                                       atol=OPT_ATOL_SCALE * np.abs(w).max(),
                                       err_msg="/".join(path))
    # the inputs are left as they were
    np.testing.assert_array_equal(tstate["m"]["emb"].numpy(), m["emb"])


def test_init_opt_state():
    params = _t(_tree(np.random.default_rng(0), 1.0))
    params["half"] = torch.ones(3, dtype=torch.bfloat16)
    st = toptim.init_opt_state(params)
    assert st["step"].dtype == torch.int32 and st["step"].shape == () and int(st["step"]) == 0
    for k in ("m", "v"):
        for path, leaf in tree_leaves(st[k]):
            p = dict(tree_leaves(params))[path]
            assert leaf.shape == p.shape and leaf.dtype == torch.float32
            assert not leaf.any()
