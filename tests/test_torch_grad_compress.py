"""The port's gradient compression (``repro_torch.train.grad_compress``,
``repro_torch.core.threshold.topk_details``/``scatter_topk``) against the
reference's, on the CPU.

* tests/test_grad_compress.py's three cases, ported.
* ``topk_compress``, ``topk_decompress``, ``topk_details`` and
  ``scatter_topk`` equal the reference's bit for bit on the same inputs:
  random values, ties (the lower index first, as ``lax.top_k``), padding,
  ``_BLOCK = 256``, a tiny leaf, subnormals and signed zeros (the
  reference's scatter-add flushes them, XLA's CPU semantics).
* ``pod_compressed_grads``'s branches on a mesh of one pod, on given grads
  (the model's value-and-grad swapped for them): a tiny leaf sent dense, a
  leaf split along its leading dim at a lowered ``_SPLIT``, the rest
  compressed whole, each equal bit for bit to the reference's functions
  applied as the reference's branches apply them.
* One compressed train step of the reduced smollm against the reference's:
  on a (1, 1, 1) ("pod", "data", "model") mesh in-process, and on a
  (2, 1, 1) mesh in two gloo processes against the reference on two XLA
  host devices (a subprocess with ``--xla_force_host_platform_device_count
  =2`` set before JAX is imported; the script takes the mesh's shape).
  The two grads differ by float noise,
  so a block's selection may flip where an entry's |corrected| is within
  the grads' tolerance (1e-4 of the leaf's largest |grad|, plus 1e-4 of
  the threshold) of that block's k-th largest |corrected|: such entries
  are allowed to differ; every other value of m, v, the residual and the
  params is held to tests/test_torch_train_step.py's tolerances.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as rconfigs
import repro.core.threshold as rthr
import repro.models as R
import repro.train.grad_compress as rgc
from repro.data.tokens import DataConfig
from repro.launch.mesh import make_mesh as rmake_mesh
from repro.train import optim as roptim
from repro.train import step as rstep

import repro_torch.configs as tconfigs
import repro_torch.core.threshold as tthr
import repro_torch.train.grad_compress as tgc
from repro_torch.data.tokens import batch_at
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import state_from_reference, state_to_reference
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep

from _torch_mesh import end_the_world_it_started  # noqa: F401  (autouse)
from _torch_mesh import spawn, step_rank, unflatten
from _torch_train import TST

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = np.float32(1e-40)
RST = R.ModelSettings(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none",
                      compute_dtype=jnp.float32)
OPT = roptim.OptConfig(lr=1e-3, warmup_steps=20, total_steps=100)
GRAD_TOL = 1e-4            # tests/_torch_train.py: grads within 1e-4 of the leaf's scale
M_SCALE, V_SCALE, P_SCALE = 1e-4, 2e-4, 1e-6   # tests/test_torch_train_step.py's


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# tests/test_grad_compress.py, ported
# ---------------------------------------------------------------------------

def test_topk_roundtrip_keeps_largest():
    g = t(np.random.default_rng(0).standard_normal(1024).astype(np.float32))
    vals, idx = tgc.topk_compress(g, ratio=8)
    assert vals.shape == (1, 128)  # one 2^20 block covers the whole leaf
    dense = tgc.topk_decompress(vals, idx, (1024,))
    np.testing.assert_allclose(dense[idx[0].long()].numpy(), vals[0].numpy(), rtol=1e-6)
    # kept magnitudes dominate dropped ones
    thresh = vals.abs().min().item()
    keep = torch.zeros(1024, dtype=torch.bool)
    keep[idx[0].long()] = True
    assert g[~keep].abs().max().item() <= thresh + 1e-6


def test_topk_multiblock_roundtrip(monkeypatch):
    """Leaves larger than one block: block-local selection + exact scatter."""
    monkeypatch.setattr(tgc, "_BLOCK", 256)
    g = t(np.random.default_rng(1).standard_normal(1000).astype(np.float32))  # pad path
    vals, idx = tgc.topk_compress(g, ratio=4)
    assert vals.shape == (4, 64)
    dense = tgc.topk_decompress(vals, idx, (1000,))
    nz = dense != 0
    np.testing.assert_allclose(dense[nz].numpy(), g[nz].numpy(), rtol=1e-6)


def test_error_feedback_converges_quadratic():
    """EF-compressed SGD must converge on a quadratic like dense SGD does."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((64, 64)).astype(np.float32) / 8
    A = t(A @ A.T + 0.5 * np.eye(64, dtype=np.float32))
    b = t(rng.standard_normal(64).astype(np.float32))
    x_star = torch.linalg.solve(A, b)

    def run(compressed):
        x, r = torch.zeros(64), torch.zeros(64)
        for _ in range(400):
            g = A @ x - b
            if compressed:
                corrected = g + r
                vals, idx = tgc.topk_compress(corrected, ratio=8)
                sent = tgc.topk_decompress(vals, idx, (64,))
                r = corrected - sent
                g = sent
            x = x - 0.1 * g
        return torch.linalg.norm(x - x_star).item()

    dense_err, comp_err = run(False), run(True)
    assert comp_err < 1e-2, comp_err
    assert comp_err < max(dense_err * 50, 1e-2)


# ---------------------------------------------------------------------------
# bit for bit against the reference's functions
# ---------------------------------------------------------------------------

def _ties(n, seed):
    """Values from a few magnitudes, both signs and zeros: many ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, n) * np.float32(0.5)).astype(np.float32)


def _subnormal(n, seed):
    """Subnormals of both signs, signed zeros, tiny normals and ties."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, TINY, -TINY, 3 * TINY, -2 * TINY, 1.2e-38, -1.5e-38,
                     1.0, -1.0], np.float32)
    return pool[rng.integers(0, len(pool), n)]


CASES = {
    "normal-1024-r8": (lambda: np.random.default_rng(0).standard_normal(1024), 8, None),
    "normal-3x50x7-r4": (lambda: np.random.default_rng(1).standard_normal((3, 50, 7)), 4, None),
    "ties-4096-r16": (lambda: _ties(4096, 2), 16, None),
    "ties-padded-1000-r4-block256": (lambda: _ties(1000, 3), 4, 256),
    "normal-padded-1000-r4-block256": (lambda: np.random.default_rng(4).standard_normal(1000),
                                       4, 256),
    "tiny-10-r32": (lambda: np.random.default_rng(5).standard_normal(10), 32, None),
    "subnormal-2048-r8": (lambda: _subnormal(2048, 6), 8, None),
    "subnormal-padded-700-r2-block256": (lambda: _subnormal(700, 7), 2, 256),
    "zeros-300-r4": (lambda: np.zeros(300), 4, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_topk_compress_and_decompress_are_the_references(case, monkeypatch):
    make, ratio, block = CASES[case]
    g = np.asarray(make(), np.float32)
    if block is not None:
        monkeypatch.setattr(tgc, "_BLOCK", block)
        monkeypatch.setattr(rgc, "_BLOCK", block)
    wv, wi = rgc.topk_compress(jnp.asarray(g), ratio)
    gv, gi = tgc.topk_compress(t(g), ratio)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(bits(gv.numpy()), bits(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    want = rgc.topk_decompress(wv, wi, g.shape)
    got = tgc.topk_decompress(gv, gi, g.shape)
    assert tuple(got.shape) == g.shape
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("levels", [None, 1])
@pytest.mark.parametrize("kind", ["normal", "ties", "subnormal"])
def test_topk_details_and_scatter_are_the_references(kind, levels):
    """(3, 2) blocks of 8^3 and 16^3; at n 8 also k 460, more than its 448
    details at one level (the coarse corner's -inf picks, lowest index
    first)."""
    for n, k in ((8, 40), (8, 460), (16, 100)):
        size = 6 * n ** 3
        x = {"normal": lambda: np.random.default_rng(8).standard_normal(size),
             "ties": lambda: _ties(size, 9), "subnormal": lambda: _subnormal(size, 10)}[kind]()
        x = np.asarray(x, np.float32).reshape(3, 2, n, n, n)
        want = rthr.topk_details(jnp.asarray(x), k, levels)
        got = tthr.topk_details(t(x), k, levels)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(bits(a.numpy()), bits(b))
        back = tthr.scatter_topk(*got, n)
        np.testing.assert_array_equal(bits(back.numpy()),
                                      bits(rthr.scatter_topk(*want, n)))


# ---------------------------------------------------------------------------
# pod_compressed_grads's branches, one pod
# ---------------------------------------------------------------------------

def _ref_one_small(g, r, ratio):
    corrected = jnp.asarray(g).astype(jnp.float32) + jnp.asarray(r)
    vals, idx = rgc.topk_compress(corrected, ratio)
    sent = rgc.topk_decompress(vals, idx, g.shape)
    return np.asarray(sent), np.asarray(corrected - sent)


def _ref_one(g, r, ratio, split):
    """The reference's per-leaf branches on one pod (``one`` in its body)."""
    if g.size < 4 * ratio:
        return g, np.zeros_like(r)
    if g.size < split:
        return _ref_one_small(g, r, ratio)
    outs = [_ref_one_small(a, b, ratio) for a, b in zip(g.reshape(g.shape[0], -1),
                                                         r.reshape(r.shape[0], -1))]
    return (np.stack([o[0] for o in outs]).reshape(g.shape),
            np.stack([o[1] for o in outs]).reshape(g.shape))


def test_pod_branches_are_the_references(monkeypatch):
    rng = np.random.default_rng(11)
    shapes = {"tiny": (5, 3), "whole": (700,), "stack": (4, 96, 5), "subnormal": (64, 9)}
    grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads["subnormal"] = _subnormal(64 * 9, 12).reshape(64, 9)
    resid = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    resid["subnormal"] = _subnormal(64 * 9, 13).reshape(64, 9)
    monkeypatch.setattr(tgc, "_BLOCK", 128)
    monkeypatch.setattr(rgc, "_BLOCK", 128)
    monkeypatch.setattr(tgc, "_SPLIT", 1024)     # "stack" (1920) goes slice by slice
    monkeypatch.setattr(tstep, "_value_and_grad", lambda p, b, cfg, st: (
        torch.tensor(2.5), {"ce": torch.tensor(2.5)}, {k: t(v) for k, v in grads.items()}))
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    (loss, metrics), got, new_r, cmx = tgc.pod_compressed_grads(
        None, params, {k: t(v) for k, v in resid.items()}, {}, None, TST, mesh,
        method="topk8")
    assert loss.item() == 2.5 and metrics["ce"].item() == 2.5
    assert {k: v.item() for k, v in cmx.items()} == {"grad_compress_ratio": 8.0,
                                                      "grad_compress_leaves": 4.0}
    for k in shapes:
        wg, wr = _ref_one(grads[k], resid[k], 8, 1024)
        np.testing.assert_array_equal(bits(got[k].numpy()), bits(wg), err_msg=k)
        np.testing.assert_array_equal(bits(new_r[k].numpy()), bits(wr), err_msg=k)


# ---------------------------------------------------------------------------
# one compressed train step against the reference's
# ---------------------------------------------------------------------------

def _batch(cfg):
    return batch_at(DataConfig(vocab=cfg.vocab, batch=4, seq=16, seed=2), 3)


def _ref_state(cfg):
    init = jax.jit(rstep.init_train_state, static_argnums=(0, 2))
    return jax.tree.map(np.asarray, init(cfg, jax.random.PRNGKey(3), "topk32"))


def _thresholds(g, ratio):
    """Each entry's block's k-th largest |g| (the selection threshold)."""
    flat = np.abs(g.reshape(-1))
    bl = min(tgc._BLOCK, flat.size)
    pad = (-flat.size) % bl
    rows = np.concatenate([flat, np.zeros(pad, flat.dtype)]).reshape(-1, bl)
    k = max(1, bl // ratio)
    kth = -np.sort(-rows, axis=1)[:, k - 1]
    return np.repeat(kth, bl)[:flat.size].reshape(g.shape)


def _near_threshold(g, ratio):
    """Where a selection may flip: |g| within the grads' tolerance of its
    block's threshold (False everywhere for a leaf sent dense)."""
    if g.size < 4 * ratio:
        return np.zeros(g.shape, bool)
    th = _thresholds(g, ratio)
    tol = GRAD_TOL * np.abs(g).max() + GRAD_TOL * th
    return np.abs(np.abs(g) - th) <= tol


def _check_step(got, gmet, want, wmet, before, flips, resid_flips):
    """m, v, params and the residual of a compressed step against the
    reference's, outside the entries whose selection may flip."""
    np.testing.assert_allclose(gmet["loss"], wmet["loss"], rtol=1e-5)
    np.testing.assert_allclose(gmet["grad_norm"], wmet["grad_norm"], rtol=1e-4)
    assert gmet["lr"] == wmet["lr"]
    assert gmet["grad_compress_ratio"] == wmet["grad_compress_ratio"] == 32
    assert gmet["grad_compress_leaves"] == wmet["grad_compress_leaves"]
    lr = float(wmet["lr"])
    leaves = {k: dict(tree_leaves(want[k])) for k in ("m", "v", "params", "residual")}
    w0 = dict(tree_leaves(before["params"]))
    n_flips = 0
    for path, m in tree_leaves(got["m"]):
        ok = ~flips[path]
        n_flips += int(flips[path].sum())
        mw = leaves["m"][path]
        scale = max(np.abs(mw).max(), 1e-30)
        assert (np.abs(m - mw)[ok] <= M_SCALE * scale).all(), ("m", path)
        v, vw = dict(tree_leaves(got["v"]))[path], leaves["v"][path]
        assert (np.abs(v - vw)[ok] <= V_SCALE * max(np.abs(vw).max(), 1e-30)).all(), path
        p, pw = dict(tree_leaves(got["params"]))[path], leaves["params"][path]
        moved = np.minimum(2, 2 * M_SCALE * scale / (np.abs(mw) + (1 - OPT.b1) * OPT.eps))
        bound = lr * moved + P_SCALE * np.abs(w0[path]).max()
        assert (np.abs(p - pw)[ok] <= bound[ok]).all(), ("params", path)
        r, rw = dict(tree_leaves(got["residual"]))[path], leaves["residual"][path]
        rok = ~resid_flips[path]
        rscale = GRAD_TOL * max(np.abs(rw).max(), np.abs(r).max(), 1e-30)
        assert (np.abs(r - rw)[rok] <= rscale).all(), ("residual", path)
    return n_flips


def test_compressed_step_one_pod_matches_the_reference():
    """(1, 1, 1): the top-k branch without an exchange."""
    rcfg = rconfigs.reduced(rconfigs.ARCHS["smollm-135m"])
    tcfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
    before, batch = _ref_state(rcfg), _batch(rcfg)
    rmesh = rmake_mesh((1, 1, 1), ("pod", "data", "model"))
    _, jit_for, _ = rstep.build_train_step(rcfg, rmesh, settings=RST, opt=OPT,
                                           grad_compress="topk32", donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with rmesh:
        fn = jit_for(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jbatch))
        want, wmet = fn(before, jbatch)
    want = jax.tree.map(np.asarray, want)
    wmet = {k: np.asarray(v) for k, v in wmet.items()}

    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    opt = toptim.OptConfig(**dataclasses.asdict(OPT))
    _, tjit, state_sh = tstep.build_train_step(tcfg, mesh, settings=TST, opt=opt,
                                               grad_compress="topk32", donate=False)
    state = state_from_reference(before, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    new, met = tjit(tbatch)(state, tbatch)
    assert sorted(met) == sorted(wmet)
    # the port's own grads: the corrected gradient at step 1 (a zero residual)
    _, _, g = tstep._value_and_grad(state["params"], tbatch, tcfg,
                                    dataclasses.replace(TST, batch_axes=("data",)))
    flips = {p: _near_threshold(a.numpy(), 32) for p, a in tree_leaves(g)}
    got = state_to_reference(new)
    n = _check_step(got, {k: v.numpy() for k, v in met.items()}, want, wmet, before,
                    flips, flips)
    # the port's own step 1: what it sent plus what it kept is its grad
    for path, a in tree_leaves(g):
        r = dict(tree_leaves(new["residual"]))[path]
        sent = dict(tree_leaves(new["m"]))[path]
        assert ((sent != 0) & (r != 0)).sum() == 0, path   # sent xor kept
    assert n < 0.01 * sum(a.numel() for _, a in tree_leaves(g)), n


REF_SCRIPT = r"""
import math, os, sys
shape = tuple(int(n) for n in sys.argv[2].split(","))
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={math.prod(shape)}"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax, jax.numpy as jnp
import repro.configs as rconfigs
import repro.models as R
from repro.data.tokens import DataConfig, batch_at
from repro.launch.mesh import make_mesh
from repro.train import optim as roptim, step as rstep
cfg = rconfigs.reduced(rconfigs.ARCHS["smollm-135m"])
st = R.ModelSettings(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none",
                     compute_dtype=jnp.float32)
opt = roptim.OptConfig(lr=1e-3, warmup_steps=20, total_steps=100)
state = jax.jit(rstep.init_train_state, static_argnums=(0, 2))(
    cfg, jax.random.PRNGKey(3), "topk32")
batch = {k: jnp.asarray(v) for k, v in
         batch_at(DataConfig(vocab=cfg.vocab, batch=4, seq=16, seed=2), 3).items()}
mesh = make_mesh(shape, ("pod", "data", "model"))
_, jit_for, _ = rstep.build_train_step(cfg, mesh, settings=st, opt=opt,
                                       grad_compress="topk32", donate=False)
with mesh:
    fn = jit_for(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batch))
    new, met = fn(state, batch)
flat = {}
for name, tree in (("before", state), ("after", new)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat[name + "/" + "/".join(k.key for k in path)] = np.asarray(leaf)
for k, v in met.items():
    flat["metric/" + k] = np.asarray(v)
np.savez(sys.argv[1], **flat)
"""


def test_compressed_step_two_pods_matches_the_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(tmp_path / "ref.npz"), "2,1,1"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    flat = dict(np.load(tmp_path / "ref.npz"))
    before, want = unflatten(flat, "before"), unflatten(flat, "after")
    wmet = unflatten(flat, "metric")
    rcfg = rconfigs.reduced(rconfigs.ARCHS["smollm-135m"])
    batch = _batch(rcfg)
    ranks = spawn(step_rank, 2, tmp_path, before, batch, (2, 1, 1), ("pod", "data", "model"),
                  {"grad_compress": "topk32"}, True)
    np.testing.assert_array_equal(ranks[0]["rows/tokens"], batch["tokens"][:2])
    np.testing.assert_array_equal(ranks[1]["rows/tokens"], batch["tokens"][2:])
    # the pods end with the same params, m and v (bit for bit); each keeps
    # its own residual
    for k in ranks[0]:
        if k.startswith(("after/", "metric/")) and not k.startswith("after/residual/"):
            np.testing.assert_array_equal(bits(ranks[0][k]), bits(ranks[1][k]), err_msg=k)
    got = unflatten(ranks[0], "after")
    gmet = unflatten(ranks[0], "metric")
    near = [{p: _near_threshold(a, 32) for p, a in tree_leaves(unflatten(r, "grad"))}
            for r in ranks]
    either = {p: near[0][p] | near[1][p] for p in near[0]}
    # the reference's residual is its first pod's
    n = _check_step(got, gmet, want, wmet, before, either, near[0])
    assert n < 0.02 * sum(a.size for _, a in tree_leaves(got["m"])), n
