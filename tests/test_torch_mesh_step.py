"""The port's mesh (``repro_torch.launch.mesh``) and its train step over a
mesh of two or four gloo processes (``repro_torch.train.step``'s
``jit_for``) against the reference's single-device step on the global
batch, on the CPU.

The reference's step runs on a 1x1 mesh through its ``jit_for`` (batch 4 x
16 tokens of ``batch_at``'s data, reduced smollm, float32); its state
before the step goes to the spawned ranks, which take their blocks of it
(``train_state_shardings``) and their rows of the batch
(``batch_shardings``), step once, and write their blocks, the gathered
state and the metrics.  Each rank gathers one layer's parameters at a
time and reduces that layer's grads into the moments' blocks in the
backward.  Meshes: ("data", "model") (2, 1), which splits the batch and a
second dim of each leaf over "data" (reduce-scatters the grads), also
with ``micro_batches=2``; (1, 2), which splits the leaves over "model"
(the ranks compute the same rows), in ``fsdp`` and in ``tp`` mode (the
parameters' placement is not the moments'), ``tp`` also with
``micro_batches=2``; and (2, 2), both at once, also with
``micro_batches=2``.  Tolerances are
tests/test_torch_train_step.py's: loss and grad_norm rtol 1e-5; m within
1e-4 and v within 2e-4 of the leaf's scale; each parameter within ``lr
min(2, 2e-4 max|m| / (|m| + (1 - b1) eps))`` plus 1e-6 of the leaf's
scale.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import repro.configs as rconfigs
import repro.models as R
from repro.data.tokens import DataConfig
from repro.launch.mesh import make_mesh as rmake_mesh
from repro.train import optim as roptim
from repro.train import step as rstep

from repro_torch.data.tokens import batch_at
from repro_torch.launch import mesh as tmesh
from repro_torch.models.common import tree_leaves

from _torch_mesh import OPT, end_the_world_it_started  # noqa: F401  (autouse)
from _torch_mesh import serve_rank, spawn, step_rank, unflatten

GNORM_RTOL = 1e-5
#: tests/test_torch_llm_serve.py's float32 tolerance: rtol, and atol times
#: the largest |value|
SERVE_RTOL, SERVE_ATOL_SCALE = 1e-4, 1e-5
M_SCALE, V_SCALE, P_SCALE = 1e-4, 2e-4, 1e-6
RST = R.ModelSettings(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none",
                      compute_dtype=jnp.float32)
ROPT = roptim.OptConfig(**OPT)


@functools.lru_cache(maxsize=None)
def _reference_step(micro_batches):
    """(state before, batch, state after, metrics) of the reference's jitted
    step on one device, as numpy."""
    cfg = rconfigs.reduced(rconfigs.ARCHS["smollm-135m"])
    mesh = rmake_mesh((1, 1), ("data", "model"))
    state = jax.jit(rstep.init_train_state, static_argnums=0)(cfg, jax.random.PRNGKey(3))
    batch = batch_at(DataConfig(vocab=cfg.vocab, batch=4, seq=16, seed=2), 3)
    _, jit_for, _ = rstep.build_train_step(cfg, mesh, settings=RST, opt=ROPT, donate=False,
                                           micro_batches=micro_batches)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh:
        fn = jit_for(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jbatch))
        new, metrics = fn(state, jbatch)
    as_np = functools.partial(jax.tree.map, np.asarray)
    return as_np(state), batch, as_np(new), {k: np.asarray(v) for k, v in metrics.items()}


def _blocks(whole, spec, sizes):
    """Every rank's block of ``whole`` under ``spec``, in rank order
    (ranks numbered row-major over the mesh)."""
    names = list(sizes)
    out = []
    for rank in range(int(np.prod(list(sizes.values())))):
        coord = dict(zip(names, np.unravel_index(rank, tuple(sizes.values()))))
        x = whole
        for d, part in enumerate(spec):
            if part is not None:
                n = x.shape[d] // sizes[part]
                x = np.take(x, range(coord[part] * n, (coord[part] + 1) * n), axis=d)
        out.append(x)
    return out


def _close_scaled(got, want, scale_tol, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_tol * scale, err_msg=what)


MESHES = {
    "data2": ((2, 1), {}),
    "data2-micro2": ((2, 1), {"micro_batches": 2}),
    "model2": ((1, 2), {}),
    "model2-tp": ((1, 2), {"sharding_mode": "tp"}),
    "model2-tp-micro2": ((1, 2), {"sharding_mode": "tp", "micro_batches": 2}),
    "data2-model2": ((2, 2), {}),
    "data2-model2-micro2": ((2, 2), {"micro_batches": 2}),
}


@pytest.mark.parametrize("case", sorted(MESHES))
def test_two_rank_step_matches_the_single_device_reference(tmp_path, case):
    shape, kw = MESHES[case]
    before, batch, want, wmet = _reference_step(kw.get("micro_batches", 1))
    world = int(np.prod(shape))
    ranks = spawn(step_rank, world, tmp_path, before, batch, shape, ("data", "model"), kw,
                  False)
    sizes = dict(zip(("data", "model"), shape))
    # each rank holds its placement's block, and its rows of the batch
    split = False
    for key in ranks[0]:
        if not key.startswith("whole/"):
            continue
        path = key[len("whole/"):]
        spec = json.loads(str(ranks[0][f"spec/{path}"]))
        split |= any(p is not None and sizes[p] > 1 for p in spec)
        for r, block in enumerate(_blocks(ranks[0][key], spec, sizes)):
            np.testing.assert_array_equal(ranks[r][f"after/{path}"], block, err_msg=path)
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=path)
    assert split, "no leaf is split over the mesh"
    for r in range(world):
        d = r // sizes["model"]
        rows = batch["tokens"] if sizes["data"] == 1 else batch["tokens"][2 * d:2 * d + 2]
        np.testing.assert_array_equal(ranks[r]["rows/tokens"], rows)
    got, met = unflatten(ranks[0], "whole"), unflatten(ranks[0], "metric")
    assert sorted(met) == sorted(wmet)
    np.testing.assert_allclose(met["grad_norm"], wmet["grad_norm"], rtol=GNORM_RTOL)
    np.testing.assert_allclose(met["loss"], wmet["loss"], rtol=1e-5)
    np.testing.assert_array_equal(met["lr"], wmet["lr"])
    assert int(got["step"]) == 1
    lr = float(wmet["lr"])
    for path, m in tree_leaves(got["m"]):
        what = "/".join(path)
        mw = dict(tree_leaves(want["m"]))[path]
        _close_scaled(m, mw, M_SCALE, f"m {what}")
        _close_scaled(dict(tree_leaves(got["v"]))[path],
                      dict(tree_leaves(want["v"]))[path], V_SCALE, f"v {what}")
        p, wp = dict(tree_leaves(got["params"]))[path], dict(tree_leaves(want["params"]))[path]
        w0 = dict(tree_leaves(before["params"]))[path]
        moved = np.minimum(2, 2 * M_SCALE * np.abs(mw).max()
                           / (np.abs(mw) + (1 - ROPT.b1) * ROPT.eps))
        assert (np.abs(p - wp) <= lr * moved + P_SCALE * np.abs(w0).max()).all(), what


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["data2", "model2"])
def test_serve_builders_over_two_ranks(tmp_path, shape):
    """The serve builders' ``jit_for`` on each rank's blocks (params over
    "model" or "data", the cache's batch over "data" and length over
    "model", the tokens' batch over "data") gives the logits of ``fn`` on
    the whole trees, and writes each rank's cache block in place.  Bit for
    bit where a rank computes what ``fn`` computes: prefill on the
    model-only mesh, its parameters gathered one layer at a time.  A rank
    of the data-only mesh computes its own row (the CPU's one-row products
    round apart from the two-row ones), and decode over the KV sequence
    split across "model" merges the ranks' partial softmaxes by
    log-sum-exp: those are held to ``fn`` within
    tests/test_torch_llm_serve.py's float32 tolerance."""
    for r, out in enumerate(spawn(serve_rank, 2, tmp_path, shape)):
        pairs = [("prefill", shape == (1, 2))]
        for i in range(3):
            assert bool(out[f"decode{i}/in_place"]), (r, i)
            pairs += [(f"decode{i}", False)] + [(f"decode{i}/cache/{k}", False)
                                                for k in ("k", "v")]
        for what, exact in pairs:
            got, want = out[f"{what}/got"], out[f"{what}/want"]
            if exact:
                np.testing.assert_array_equal(got, want, err_msg=f"{r} {what}")
            else:
                np.testing.assert_allclose(got, want, rtol=SERVE_RTOL,
                                           atol=SERVE_ATOL_SCALE * float(np.abs(want).max()),
                                           err_msg=f"{r} {what}")


def test_a_single_process_gets_a_world_of_one():
    """No ``MASTER_ADDR``: a mesh of one device starts a world of one on
    gloo, and a second mesh uses it."""
    assert not dist.is_initialized()   # the earlier modules ended theirs
    mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert mesh.device_type == "cpu"
    three = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    assert tmesh.batch_axes(three) == ("pod", "data")
    assert tmesh.axis_sizes(three) == {"pod": 1, "data": 1, "model": 1}


def test_mesh_size_must_match_the_world():
    tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match=r"4 devices .* world of 1 ranks"):
        tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.make_mesh((1, 1), ("data",), device="cpu")
    with pytest.raises(RuntimeError, match="256 devices .* world of 1 ranks"):
        tmesh.make_production_mesh(device="cpu")


def test_a_mesh_of_many_without_a_world_raises(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="needs a world of 2 ranks"):
        tmesh.make_mesh((2, 1), ("data", "model"), device="cpu")


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh((1, 1), ("data", "model"))          # the card is the default
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh((1, 1), ("data", "model"), device="cuda")


def test_a_step_checks_its_blocks():
    """The state and the batch must be this rank's blocks of the shapes
    ``jit_for`` was given; ``train_step`` takes whole trees."""
    import repro_torch.configs as tconfigs
    from repro_torch.models import ModelSettings
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep

    cfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
    st = ModelSettings(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none",
                       compute_dtype=torch.float32)
    mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    train_step, jit_for, state_sh = tstep.build_train_step(
        cfg, mesh, settings=st, opt=toptim.OptConfig(**OPT), donate=False)
    state = tstep.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             batch_at(DataConfig(vocab=cfg.vocab, batch=4, seq=16), 0).items()}
    step = jit_for(batch)
    with pytest.raises(ValueError, match="the batch"):
        step(state, {k: v[:2] for k, v in batch.items()})
    with pytest.raises(ValueError, match="the train state"):
        step(dict(state, residual=state["m"]), batch)
    a, ma = step(state, batch)
    b, mb = train_step(state, batch)
    for (p, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y), p
    assert {k: v.item() for k, v in ma.items()} == {k: v.item() for k, v in mb.items()}
    assert sorted(state_sh) == ["m", "params", "step", "v"]
    assert dataclasses.is_dataclass(state_sh["params"]["embed"])
