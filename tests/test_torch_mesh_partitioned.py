"""The partitioned compute over two gloo ranks against the reference's
one-device steps, one reduced config of each family (dense, MoE, rwkv6,
hybrid jamba, encdec), on the CPU: the serve builders, and the train
step's loss gradients.

Each rank holds its blocks of the reference's weights and of the decode
cache and computes its rows, gathering one layer's parameters at a time.
On the ("data", "model") (1, 2) mesh the KV sequence (8 positions, 4 a
rank), the frames' keys and values (encdec), the recurrent states' heads
or ``Di`` and the parameters split over "model": the rank whose slice
holds ``pos`` writes the new KV, the ranks merge their partial softmaxes
(log-sum-exp), a state is gathered one layer at a time.  On (2, 1) the
two rows split over "data", and a MoE layer whose groups span both rows
gathers its input rows.  The cache before each decode step is random
(numpy, seeded), so every position holds keys; ``pos`` is 1 (in the first
rank's slice: the second rank's slice lies wholly past it, every score
there masked), 4 (the boundary: the first position of the second slice)
and 6 (in the last slice).  The logits and each rank's cache block are
held to the reference's ``build_decode_step`` and ``build_prefill_step``
within tests/test_torch_llm_serve.py's float32 tolerance: rtol 1e-4 and
atol 1e-5 of the largest |value|.

Training: each rank takes its blocks of the reference's weights and its
rows of tests/_torch_train.py's batch, gathers one layer at a time inside
each layer's checkpoint (remat "full": again in the backward) and reduces
each layer's grads into the moments' blocks as the backward makes them.
Its blocks are held to the reference's ``jax.value_and_grad`` grads cut
to them, at tests/test_torch_train_grads.py's tolerance (1e-4 of the
leaf's largest |grad|, rtol 1e-4; loss and metrics rtol 1e-5), on (1, 2)
and, where the loss is the rows' mean, on (2, 1): the MoE families' aux
losses and capacity are per rank's rows (ROADMAP §3), so their data split
is not the reference's number.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro.configs as rconfigs
import repro.models as R
from repro.launch.mesh import make_mesh
from repro.serve import step as rstep

from _torch_mesh import SERVE_MESHES, grads_rank, partitioned_rank
from _torch_train import GRAD_ATOL_SCALE, GRAD_RTOL, LOSS_RTOL
from _torch_train import _reference as _reference_grads

RTOL, ATOL_SCALE = 1e-4, 1e-5
RST = R.ModelSettings(q_chunk=16, kv_chunk=16, remat="none", compute_dtype=jnp.float32)
ARCHS = {"dense": "smollm-135m", "moe": "olmoe-1b-7b", "rwkv6": "rwkv6-7b",
         "hybrid": "jamba-v0.1-52b", "encdec": "whisper-small"}
B, S, PROMPT = 2, 8, 8
POSITIONS = {"first-slice": 1, "boundary": 4, "last-slice": 6}


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SCALE * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _blocks(whole, spec, sizes):
    """Every rank's block of ``whole`` under ``spec`` (a tuple of axis
    names or None per dim), in rank order over the (data, model) mesh."""
    out = []
    for rank in range(int(np.prod(list(sizes.values())))):
        coord = dict(zip(sizes, np.unravel_index(rank, tuple(sizes.values()))))
        x = whole
        for d, part in enumerate(spec):
            if part is not None and sizes[part] > 1:
                n = x.shape[d] // sizes[part]
                x = np.take(x, range(coord[part] * n, (coord[part] + 1) * n), axis=d)
        out.append(x)
    return out


def _cache_spec(name, shape, sizes):
    """``train.sharding.cache_shardings``' rule for one leaf, by hand."""
    spec = [None] * len(shape)
    bdim, sdim = (2, 3 if name == "ssm" else 4) if name in ("ssm", "conv") else \
        (1, len(shape) - 1 if name in ("x_tm", "x_cm") else 2)
    if shape[bdim] % sizes["data"] == 0:
        spec[bdim] = "data"
    if shape[sdim] % sizes["model"] == 0:
        spec[sdim] = "model"
    return spec


@functools.lru_cache(maxsize=None)
def _run(family, tmp):
    """The reference's results and the two ranks' for ``family``."""
    import pathlib

    from _torch_mesh import spawn

    rcfg = rconfigs.reduced(rconfigs.ARCHS[ARCHS[family]])
    rng = np.random.default_rng(7)
    params = jax.tree.map(np.asarray, R.init_params(rcfg, jax.random.PRNGKey(0)))
    specs = R.cache_spec(rcfg, B, S, dtype=jnp.float32, mode="spec")
    cache = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
             for k, v in specs.items()}
    toks = rng.integers(0, rcfg.vocab, (B, PROMPT)).astype(np.int32)
    frames = None
    if rcfg.family == "encdec":
        frames = rng.standard_normal((B, rcfg.enc_frames, rcfg.d_model)).astype(np.float32)
    mesh = make_mesh((1, 1), ("data", "model"))
    rpre, _ = rstep.build_prefill_step(rcfg, mesh, settings=RST)
    rdec, _ = rstep.build_decode_step(rcfg, mesh, settings=RST)
    rdec = jax.jit(rdec)
    want = {"prefill": np.asarray(jax.jit(rpre)(
        params, jnp.asarray(toks), None if frames is None else jnp.asarray(frames)))}
    for pos in POSITIONS.values():
        logits, new = rdec(params, {k: jnp.asarray(v) for k, v in cache.items()},
                           jnp.asarray(toks[:, :1]), jnp.int32(pos))
        want[f"pos{pos}/logits"] = np.asarray(logits)
        for k, v in new.items():
            want[f"pos{pos}/cache/{k}"] = np.asarray(v)
    path = pathlib.Path(tmp) / family
    path.mkdir()
    ranks = spawn(partitioned_rank, 2, path, ARCHS[family], params, cache, toks, frames,
                  tuple(POSITIONS.values()))
    return want, ranks


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned")
    return lambda family: _run(family, str(tmp))


@pytest.mark.parametrize("mesh", sorted(SERVE_MESHES))
@pytest.mark.parametrize("where", sorted(POSITIONS))
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_decode_matches_the_reference(run, family, where, mesh):
    want, ranks = run(family)
    pos = POSITIONS[where]
    sizes = dict(zip(("data", "model"), SERVE_MESHES[mesh]))
    split = False
    for r, got in enumerate(ranks):
        _close(got[f"{mesh}/pos{pos}/logits"], want[f"pos{pos}/logits"], f"rank {r} logits")
    for key in want:
        if not key.startswith(f"pos{pos}/cache/"):
            continue
        name = key.rsplit("/", 1)[1]
        spec = _cache_spec(name, want[key].shape, sizes)
        split |= any(p is not None and sizes[p] > 1 for p in spec)
        for r, block in enumerate(_blocks(want[key], spec, sizes)):
            got = ranks[r][f"{mesh}/pos{pos}/cache/{name}"]
            assert got.shape == block.shape, (r, name, got.shape, block.shape)
            _close(got, block, f"rank {r} cache {name}")
    assert split, "no cache leaf is split over the mesh"


@pytest.mark.parametrize("mesh", sorted(SERVE_MESHES))
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_prefill_matches_the_reference(run, family, mesh):
    want, ranks = run(family)
    for r, got in enumerate(ranks):
        _close(got[f"{mesh}/prefill"], want["prefill"], f"rank {r} prefill")


@functools.lru_cache(maxsize=None)
def _grads(family, tmp):
    import pathlib

    from _torch_mesh import spawn

    params, batch, loss, metrics, grads = _reference_grads(ARCHS[family])
    meshes = dict(SERVE_MESHES) if family in ("dense", "rwkv6", "encdec") else \
        {"model2": SERVE_MESHES["model2"]}
    path = pathlib.Path(tmp) / f"grads-{family}"
    path.mkdir()
    ranks = spawn(grads_rank, 2, path, ARCHS[family], params, batch, meshes, "full")
    return (loss, metrics, grads), meshes, ranks


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_train_grads_match_the_reference(tmp_path_factory, family):
    import json

    (wloss, wmet, wgrads), meshes, ranks = _grads(family, str(tmp_path_factory.getbasetemp()))
    for tag, shape in meshes.items():
        sizes = dict(zip(("data", "model"), shape))
        split = False
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got[f"{tag}/loss"], wloss, rtol=LOSS_RTOL)
            for k, w in wmet.items():
                np.testing.assert_allclose(got[f"{tag}/metric/{k}"], w, rtol=LOSS_RTOL,
                                           atol=1e-7, err_msg=k)
        for path, w in wgrads.items():
            key = "/".join(path)
            spec = json.loads(str(ranks[0][f"{tag}/spec/{key}"]))
            split |= any(p is not None and sizes[p] > 1 for p in spec)
            scale = float(np.abs(w).max())
            for r, block in enumerate(_blocks(w, spec, sizes)):
                np.testing.assert_allclose(ranks[r][f"{tag}/grad/{key}"], block, rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL_SCALE * scale,
                                           err_msg=f"{tag} rank {r} {key}")
        assert split, f"{tag}: no leaf is split over the mesh"
