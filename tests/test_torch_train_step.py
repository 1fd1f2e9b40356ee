"""The port's train step (``repro_torch.train.step``) against the
reference's ``build_train_step`` on a 1x1 mesh, on the CPU, and the port's
remat, state specs and state conversion.

The reference's state comes from its ``init_train_state`` and is carried
into the port by ``models.convert.state_from_reference``; batches are
``data.tokens.batch_at``'s.  float32.  Tolerances after one step, each
against the leaf's (or value's) scale, its largest |value|: grad_norm
rtol 1e-5; m within 1e-4 (m = 0.1 g, the grads' tolerance in
tests/_torch_train.py) and v within 2e-4 of the scale (v = 0.05 g^2, twice
the relative error of g); lr as ``lr_at``'s (within one ulp of the peak
rate).  Each new parameter within ``lr min(2, 2e-4 max|m| / (|m| + (1 -
b1) eps))`` plus 1e-6 of the leaf's scale: at step 0 Adam's update is
``lr r`` with ``r = g / (|g| + eps)`` in (-1, 1), and ``|dr| <= |dg| / (|g|
+ eps)``, so a grad that may move by 1e-4 of its scale moves ``r`` by at
most that over ``|g| + eps``, and by 2 at most (a sign flip near 0).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as rconfigs
import repro.models as R
from repro.data.tokens import DataConfig
from repro.launch.mesh import make_mesh
from repro.train import optim as roptim
from repro.train import step as rstep

import repro_torch.configs as tconfigs
import repro_torch.models as T
from repro_torch.data.tokens import batch_at
from repro_torch.launch.mesh import make_mesh as tmake_mesh
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import state_from_reference, state_to_reference
from repro_torch.models.transformer import LanguageModel
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep

from _torch_mesh import end_the_world_it_started  # noqa: F401  (autouse)
from _torch_train import TST, make_batch, port_value_and_grad

torch.set_num_threads(1)

GNORM_RTOL = 1e-5
M_SCALE, V_SCALE, P_SCALE = 1e-4, 2e-4, 1e-6
RST = R.ModelSettings(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none",
                      compute_dtype=jnp.float32)
OPT = roptim.OptConfig(lr=1e-3, warmup_steps=20, total_steps=100)
STEP_ARCHS = ("smollm-135m", "olmoe-1b-7b")


def cpu_step(cfg, **kw):
    """The port's step on a CPU 1x1 mesh: ``jit_for`` of the batch's
    shapes, which are every batch's here."""
    _, jit_for, _ = tstep.build_train_step(cfg, tmake_mesh((1, 1), ("data", "model"),
                                                           device="cpu"), **kw)

    def step(state, batch):
        return jit_for(batch)(state, batch)

    return step


@functools.lru_cache(maxsize=None)
def _reference_step(name, micro_batches):
    """(state before, batch, state after, metrics) of the reference's jitted
    step, as numpy."""
    cfg = rconfigs.reduced(rconfigs.ARCHS[name])
    mesh = make_mesh((1, 1), ("data", "model"))
    state = jax.jit(rstep.init_train_state, static_argnums=0)(cfg, jax.random.PRNGKey(3))
    batch = batch_at(DataConfig(vocab=cfg.vocab, batch=4, seq=16, seed=2), 3)
    _, jit_for, _ = rstep.build_train_step(cfg, mesh, settings=RST, opt=OPT, donate=False,
                                           micro_batches=micro_batches)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh:
        fn = jit_for(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jbatch))
        new, metrics = fn(state, jbatch)
    as_np = functools.partial(jax.tree.map, np.asarray)
    return as_np(state), batch, as_np(new), {k: np.asarray(v) for k, v in metrics.items()}


def _close_scaled(got, want, scale_tol, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_tol * scale, err_msg=what)


@pytest.mark.parametrize("micro_batches", [1, 2])
@pytest.mark.parametrize("name", STEP_ARCHS)
def test_one_train_step_matches_the_reference(name, micro_batches):
    before, batch, want, wmet = _reference_step(name, micro_batches)
    tcfg = tconfigs.reduced(tconfigs.ARCHS[name])
    state = state_from_reference(before, device="cpu")
    fn = cpu_step(tcfg, settings=TST, opt=toptim.OptConfig(**dataclasses.asdict(OPT)),
                  donate=False, micro_batches=micro_batches)
    new, met = fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(met) == sorted(wmet)
    np.testing.assert_allclose(met["grad_norm"].item(), wmet["grad_norm"], rtol=GNORM_RTOL)
    np.testing.assert_allclose(met["loss"].item(), wmet["loss"], rtol=1e-5)
    np.testing.assert_array_equal(met["lr"].numpy(), wmet["lr"])   # step 0: the warm-up
    got = state_to_reference(new)
    assert int(got["step"]) == int(want["step"]) == 1
    lr = float(wmet["lr"])
    # m = (1 - b1) g at step 0: the grads as the optimizer saw them
    m_want = dict(tree_leaves(want["m"]))
    for path, m in tree_leaves(got["m"]):
        what = "/".join(path)
        mw = m_want[path]
        _close_scaled(m, mw, M_SCALE, f"m {what}")
        _close_scaled(dict(tree_leaves(got["v"]))[path],
                      dict(tree_leaves(want["v"]))[path], V_SCALE, f"v {what}")
        p, wp = dict(tree_leaves(got["params"]))[path], dict(tree_leaves(want["params"]))[path]
        w0 = dict(tree_leaves(before["params"]))[path]
        moved = np.minimum(2, 2 * M_SCALE * np.abs(mw).max()
                           / (np.abs(mw) + (1 - OPT.b1) * OPT.eps))
        assert (np.abs(p - wp) <= lr * moved + P_SCALE * np.abs(w0).max()).all(), what


def test_donate_updates_the_state_in_place():
    cfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
    batch = {k: torch.from_numpy(v) for k, v in
             batch_at(DataConfig(vocab=cfg.vocab, batch=2, seq=16), 0).items()}
    fresh = tstep.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    keep = tree_map(torch.clone, fresh)
    kept, _ = cpu_step(cfg, settings=TST, donate=False)(fresh, batch)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(fresh),
                                                          tree_leaves(keep)))
    donated, met = cpu_step(cfg, settings=TST, donate=True)(fresh, batch)
    assert donated is fresh and int(fresh["step"]) == 1
    for (_, a), (_, b) in zip(tree_leaves(donated), tree_leaves(kept)):
        assert torch.equal(a, b)
    assert sorted(met) == ["ce", "drop_fraction", "grad_norm", "load_balance", "loss", "lr",
                           "router_z"]


@pytest.mark.parametrize("name", sorted(rconfigs.ARCHS))
def test_remat_modes_give_the_same_grads(name):
    """``none``, ``full`` (each layer checkpointed) and ``dots`` (its 2-D
    products saved) recompute the same values: equal grads, while ``full``
    keeps fewer tensors for the backward than ``none``."""
    cfg = tconfigs.reduced(tconfigs.ARCHS[name])
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch(cfg, seed=2)
    out, saved = {}, {}
    for remat in ("none", "full", "dots"):
        st = dataclasses.replace(TST, remat=remat)
        packed = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t,
                                                      lambda t: t):
            out[remat] = port_value_and_grad(params, batch, cfg, st)
        saved[remat] = len(packed)
    for remat in ("full", "dots"):
        assert out[remat][0].item() == out["none"][0].item()
        for path, g in out["none"][2].items():
            assert torch.equal(out[remat][2][path], g), (remat, path)
    assert saved["full"] < saved["none"], saved


@pytest.mark.parametrize("name", sorted(rconfigs.ARCHS))
def test_train_step_grads_finite(name):
    """The port's copy of tests/test_models_smoke.py's test of the same name."""
    cfg = tconfigs.reduced(tconfigs.ARCHS[name])
    params = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    loss, _, grads = port_value_and_grad(params, make_batch(cfg, seed=1), cfg, TST)
    assert np.isfinite(loss.item())
    for g in grads.values():
        assert torch.isfinite(g).all()
    # at least some gradient signal reaches the embedding
    assert grads[("embed",)].abs().max().item() > 0


@pytest.mark.parametrize("name", sorted(rconfigs.ARCHS))
def test_train_state_specs_are_the_references(name):
    rcfg, tcfg = rconfigs.get_arch(name), tconfigs.get_arch(name)
    want = dict(tree_leaves(rstep.train_state_specs(rcfg, param_dtype=jnp.bfloat16)))
    got = tstep.train_state_specs(tcfg, param_dtype=torch.bfloat16)
    assert sorted(want) == [p for p, _ in tree_leaves(got)]
    for path, leaf in tree_leaves(got):
        assert leaf.device.type == "meta" and tuple(leaf.shape) == want[path].shape
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path


def test_grad_compress_names_its_roadmap_item():
    """``grad_compress`` builds: the state gains the error-feedback residual
    (float32 zeros beside every parameter), and a step without a "pod"
    axis takes the normal branch and keeps the residual as it was."""
    cfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
    specs = tstep.train_state_specs(cfg, grad_compress="topk")
    assert sorted(specs) == ["m", "params", "residual", "step", "v"]
    assert [p for p, _ in tree_leaves(specs["residual"])] == \
        [p for p, _ in tree_leaves(specs["params"])]
    state = tstep.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   grad_compress="topk", device="cpu")
    assert all(a.dtype == torch.float32 and not a.any()
               for _, a in tree_leaves(state["residual"]))
    batch = {k: torch.from_numpy(v) for k, v in
             batch_at(DataConfig(vocab=cfg.vocab, batch=2, seq=16), 0).items()}
    new, met = cpu_step(cfg, settings=TST, grad_compress="topk", donate=False)(state, batch)
    assert "grad_compress_ratio" not in met
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves(new["residual"]), tree_leaves(state["residual"])))


def test_param_dtype_names_its_roadmap_item():
    """``param_dtype`` sets the parameters' dtype in the state's specs and
    shardings, as the reference's does (m and v stay float32)."""
    cfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
    rcfg = rconfigs.reduced(rconfigs.ARCHS["smollm-135m"])
    mesh = tmake_mesh((1, 1), ("data", "model"), device="cpu")
    _, _, state_sh = tstep.build_train_step(cfg, mesh, param_dtype=torch.bfloat16)
    want = rstep.train_state_shardings(rcfg, make_mesh((1, 1), ("data", "model")),
                                       param_dtype=jnp.bfloat16)
    want = {tuple(k.key for k in p): tuple(sh.spec)
            for p, sh in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {p: tuple(sh.spec) for p, sh in tree_leaves(state_sh)} == want
    assert state_sh == tstep.train_state_shardings(cfg, mesh, param_dtype=torch.bfloat16)
    specs = tstep.train_state_specs(cfg, param_dtype=torch.bfloat16)
    assert {a.dtype for _, a in tree_leaves(specs["params"])} == {torch.bfloat16}
    assert {a.dtype for _, a in tree_leaves(specs["m"])} == {torch.float32}


def test_state_conversion_checks_its_form():
    before, *_ = _reference_step("smollm-135m", 1)
    state = state_from_reference(before, device="cpu")
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    back = state_to_reference(state)
    for (p, a), (q, b) in zip(tree_leaves(back), tree_leaves(before)):
        assert p == q and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    bad = dict(before, step=np.int64(0))
    with pytest.raises(ValueError, match="int32"):
        state_from_reference(bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        state_from_reference({"params": before["params"]}, device="cpu")


def test_language_model_trains_only_when_asked():
    cfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
    serve = LanguageModel(cfg, device="cpu")
    assert not any(p.requires_grad for p in serve.parameters())
    model = LanguageModel(cfg, device="cpu", trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, seed=0).items()}
    loss, _ = model.loss(batch)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
