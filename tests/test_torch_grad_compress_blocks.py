"""The compressed cross-pod branch over blocks
(``repro_torch.train.grad_compress.compress_blocks``) against the whole
path, on the CPU.

* Eight gloo ranks on a (2, 2, 2) ("pod", "data", "model") mesh, with
  ``_BLOCK`` 64, ``_SPLIT`` 4096, ``_PIECE`` 1024 and ``_EXCHANGE`` 4096
  bytes, ``topk4``, on given per-pod gradients and residuals: each rank's
  blocks of the new gradient and residual equal, bit for bit, its block of
  the whole path's (the same function on whole leaves) and of the old
  per-unit reduction (each unit through ``topk_compress`` and
  ``topk_decompress``, the pods' payloads summed in pod order), for a leaf
  under ``_SPLIT`` split over both axes (and one padded), a stacked leaf
  over ``_SPLIT`` (runs of its slices), an embed-like leaf split on dim 0
  into 512 slices of 10, a lm_head-like leaf of padded slices, a slice
  taken in pieces along a dim split over "data", a slice cut at an expert
  dim split over "model", a slice whose blocks a "data" split cuts through
  (its smallest run of whole blocks, over ``_PIECE``), a slice that is not
  a whole number of blocks (whole), a leaf under ``_SPLIT`` over ``_PIECE``
  cut into pieces, and tiny leaves sent dense.
* The pod exchanges, counted by wrapping ``_pod_gather``: the planned
  batches of each leaf, never one a slice (the embed-like leaf's 512
  slices take 2), and one for the loss.
* The plans of the ten configs on the 2x16x16 mesh (a fake world of 512):
  pieces partition each block, each at most ``_PIECE`` elements but where
  a "data" split cuts through every run of whole blocks (jamba's and
  llama4's ``moe/we2``), and a few exchanges a leaf (qwen3-32b: 25 for
  its 14 leaves, where slice by slice took 315018).
"""
import itertools
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.train.grad_compress as tgc
from repro_torch.core._xla import flush
from repro_torch.train.optim import _recip

from _torch_mesh import end_the_world_it_started  # noqa: F401  (autouse)
from _torch_mesh import compress_rank, spawn

torch.set_num_threads(1)

CONSTS = {"_BLOCK": 64, "_SPLIT": 4096, "_PIECE": 1024, "_EXCHANGE": 4096}
METHOD, RATIO = "topk4", 4
#: leaf -> whole shape; the placement rule (hybrid: "blocks/moe/*" has two
#: stack dims) splits them as their comments say over data 2 x model 2
SHAPES = {
    "head": (24, 40),                 # whole unit, 15 blocks, split on both axes
    "proj": (20, 34),                 # whole unit, padded, split on both axes
    "big": (48, 80),                  # whole unit over _PIECE: 6 runs of 4 local rows
    "blocks/attn/wq": (8, 32, 24),    # 8 slices of 12 blocks, one a piece
    "blocks/attn/wo": (2, 30, 70),    # slices of 2100, not whole blocks: each whole
    "blocks/ffn/w1": (2, 32, 64),     # slices over _PIECE: runs along the "data" dim
    "blocks/moe/we1": (2, 2, 2, 32, 32),   # cut below the "model"-split expert dim
    "blocks/moe/we2": (2, 2, 2, 72, 8),    # "data" splits blocks: runs of 1152 > _PIECE
    "embed": (512, 10),               # 512 slices of 10 (one block each), dim 0 split
    "lm_head": (10, 450),             # 10 padded slices, two units a piece
    "norm": (3, 5),                   # tiny, whole on every rank
    "bias": (14,),                    # tiny, split over "model"
}


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _inputs(seed):
    rng = np.random.default_rng(seed)
    grads, resid = [], []
    for pod in range(2):
        g, r = {}, {}
        for k, s in SHAPES.items():
            x = rng.standard_normal(s).astype(np.float32)
            # ties, zeros and subnormals among the values
            flat = x.reshape(-1)
            flat[::7] = np.float32(0.5) * rng.integers(-2, 3, flat[::7].size)
            flat[3::11] = np.float32(1e-40)
            g[k] = x
            r[k] = (rng.standard_normal(s) * 0.3).astype(np.float32)
        grads.append(g)
        resid.append(r)
    return grads, resid


def _old_reduction(grads, resid):
    """The reduction as it was before pieces: each unit through
    ``topk_compress``/``topk_decompress``, the payloads summed in pod order
    (the module's constants are set by the caller)."""
    t = lambda a: torch.from_numpy(np.array(a, copy=True))   # noqa: E731

    def unit(g, r):
        corrected = flush(flush(t(g)) + flush(t(r)))
        sent = tgc.topk_decompress(*tgc.topk_compress(corrected, RATIO), g.shape)
        return sent, corrected - sent

    out = {}
    for k in SHAPES:
        g = [grads[p][k] for p in range(2)]
        r = [resid[p][k] for p in range(2)]
        if g[0].size < 4 * RATIO:
            total = t(g[0]) + t(g[1])
            mean = flush(total * _recip(2))
            out[k] = (mean, [torch.zeros(g[0].shape)] * 2)
            continue
        per_pod = []
        for p in range(2):
            if g[p].size < tgc._SPLIT:
                per_pod.append(unit(g[p], r[p]))
            else:
                outs = [unit(a, b) for a, b in zip(g[p].reshape(g[p].shape[0], -1),
                                                   r[p].reshape(r[p].shape[0], -1))]
                per_pod.append((torch.stack([o[0] for o in outs]).reshape(g[p].shape),
                                torch.stack([o[1] for o in outs]).reshape(g[p].shape)))
        mean = flush(flush(per_pod[0][0] + per_pod[1][0]) * _recip(2))
        out[k] = (mean, [per_pod[0][1], per_pod[1][1]])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    grads, resid = _inputs(0)
    tmp = tmp_path_factory.mktemp("blocks")
    return grads, resid, spawn(compress_rank, 8, tmp, (2, 2, 2), grads, resid, CONSTS,
                               METHOD, True)


def _local(rank: int, spec_of, whole: np.ndarray, k: str) -> np.ndarray:
    """Rank ``rank``'s block of ``whole`` (mesh (2, 2, 2), rank = pod * 4 +
    data * 2 + model) under the placement rule."""
    coord = {"pod": rank // 4, "data": rank // 2 % 2, "model": rank % 2}
    x = whole
    for d, axis in enumerate(spec_of[k]):
        if axis is not None:
            n = x.shape[d] // 2
            x = np.take(x, range(coord[axis] * n, (coord[axis] + 1) * n), axis=d)
    return x


@pytest.fixture(scope="module")
def specs():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.sharding import param_shardings

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        sh = param_shardings({k: np.empty(s) for k, s in SHAPES.items()}, mesh, hybrid=True)
        return {k: tuple(v.spec) for k, v in sh.items()}
    finally:
        dist.destroy_process_group()


def test_the_leaves_are_split_as_the_cases_need(specs):
    assert specs["head"] == ("data", "model") and specs["proj"] == ("data", "model")
    assert specs["embed"] == ("model", "data") and specs["lm_head"] == ("data", "model")
    assert specs["blocks/moe/we1"] == (None, None, "model", "data", None)
    assert specs["blocks/moe/we2"] == (None, None, "model", "data", None)
    assert specs["bias"] == ("model",) and specs["norm"] == (None, None)


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_blocks_equal_the_whole_path_bit_for_bit(ranks, specs, leaf, monkeypatch):
    for k, v in CONSTS.items():
        monkeypatch.setattr(tgc, k, v)
    grads, resid, outs = ranks
    want_g, want_r = _old_reduction(grads, resid)[leaf]
    for rank, out in enumerate(outs):
        pod = rank // 4
        got_g, got_r = out[f"block/g/{leaf}"], out[f"block/r/{leaf}"]
        np.testing.assert_array_equal(bits(got_g), bits(out[f"whole/g/{leaf}"]), err_msg=leaf)
        np.testing.assert_array_equal(bits(got_r), bits(out[f"whole/r/{leaf}"]), err_msg=leaf)
        np.testing.assert_array_equal(bits(got_g), bits(_local(rank, specs, want_g.numpy(), leaf)),
                                      err_msg=leaf)
        np.testing.assert_array_equal(
            bits(got_r), bits(_local(rank, specs, want_r[pod].numpy(), leaf)), err_msg=leaf)


def test_the_pieces_are_the_cases(ranks):
    """(exchanges, pieces, largest piece's elements) of each leaf's plan."""
    plan = {k[len("plan/"):]: tuple(v) for k, v in ranks[2][0].items() if k.startswith("plan/")}
    assert plan["head"] == (1, 1, 960) and plan["proj"] == (1, 1, 680)
    assert plan["big"] == (2, 6, 640)
    assert plan["blocks/attn/wq"] == (3, 8, 768)
    assert plan["blocks/attn/wo"] == (2, 2, 2100)       # whole slices, over _PIECE
    assert plan["blocks/ffn/w1"] == (2, 4, 1024)
    assert plan["blocks/moe/we1"] == (4, 8, 1024)
    assert plan["blocks/moe/we2"] == (2, 4, 1152)       # the smallest run of whole blocks
    assert plan["embed"] == (2, 8, 640)
    assert plan["lm_head"] == (3, 5, 900)
    assert plan["norm"] == plan["bias"] == (1, 0, 0)


def test_exchanges_follow_the_plan_never_one_a_slice(ranks):
    """Each leaf's ``_pod_gather`` calls are its planned batches, on every
    rank and on both paths; the 512 slices of the embed-like leaf take 2,
    and the loss one more."""
    for out in ranks[2]:
        for k, s in SHAPES.items():
            planned = int(out[f"plan/{k}"][0])
            assert int(out[f"exchanges/block/{k}"]) == planned, k
            slices = s[0] if math.prod(s) >= CONSTS["_SPLIT"] else 1
            assert planned <= 4 and (slices < 4 or planned < slices), k
        assert int(out["exchanges/block/embed"]) == 2
        assert int(out["exchanges/block/loss"]) == int(out["exchanges/whole/loss"]) == 1


def test_the_loss_is_the_pods_mean(ranks):
    for out in ranks[2]:
        assert out["block/loss"] == out["whole/loss"] == np.float32(0.5)


# ---------------------------------------------------------------------------
# the plans of the ten configs on the production pod mesh
# ---------------------------------------------------------------------------

#: leaves whose pieces exceed _PIECE: the "data" split cuts through every
#: run of whole blocks shorter than one expert layer's (every expert)
OVER_PIECE = {("jamba-v0.1-52b", "blocks/moe/we2"), ("llama4-scout-17b-a16e", "blocks/moe/we2")}


@pytest.fixture(scope="module")
def production_plans():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import param_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.step import train_state_shardings

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        out = {}
        for arch, cfg in sorted(ARCHS.items()):
            sh = train_state_shardings(cfg, mesh, grad_compress="topk32")["m"]
            specs = {"/".join(p): s for p, s in tree_leaves(param_specs(cfg))}
            shs = {"/".join(p): s for p, s in tree_leaves(sh)}
            blocks = {p: torch.empty(shs[p].shard_shape(s.shape), device="meta")
                      for p, s in specs.items()}
            counts = {p: [shs[p]._block(d)[1] for d in range(s.dim())]
                      for p, s in specs.items()}
            plans = {p[0]: plan for p, plan in tgc.compress_plan(blocks, shs).items()}
            out[arch] = (plans, specs, blocks, counts)
        return out
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["chameleon-34b", "granite-8b", "jamba-v0.1-52b",
                                  "llama4-scout-17b-a16e", "olmoe-1b-7b", "qwen2.5-32b",
                                  "qwen3-32b", "rwkv6-7b", "smollm-135m", "whisper-small"])
def test_production_plans_partition_the_blocks(production_plans, arch):
    plans, specs, blocks, counts = production_plans[arch]
    for name, plan in plans.items():
        path = name
        spec, block = specs[path], blocks[path]
        if plan.tiny:
            assert spec.numel() < 4 * 32
            continue
        # each element of the rank's block in exactly one piece
        cover = np.zeros(tuple(block.shape), np.int8) if block.numel() < 1 << 24 else None
        total = 0
        for piece in plan.pieces:
            shape = tuple(len(range(*s.indices(n))) for s, n in zip(piece.index, block.shape))
            total += math.prod(shape)
            assert piece.shape == tuple(a * c for a, c in zip(shape, counts[path]))
            if cover is not None:
                cover[piece.index] += 1
            if (arch, name) not in OVER_PIECE:
                assert piece.elements <= tgc._PIECE, (name, piece.shape)
        assert total == block.numel(), name
        assert cover is None or (cover == 1).all(), name
        # every piece's rows are whole blocks of its units
        unit = spec.numel() // spec.shape[0] if spec.numel() >= tgc._SPLIT else spec.numel()
        for piece in plan.pieces:
            assert piece.rows * plan.bl >= piece.elements
            assert piece.rows * plan.bl == piece.elements or piece.units * unit == piece.elements
        # a few exchanges a leaf: its payload in _EXCHANGE-byte batches
        payload = tgc.payload_bytes({"x": spec})
        assert len(plan.batches) <= 1 + payload // tgc._EXCHANGE, name
    if arch == "qwen3-32b":
        assert sum(1 if p.tiny else len(p.batches) for p in plans.values()) == 25
        assert len(plans) == 14
    for arch_, name in OVER_PIECE:
        if arch_ == arch:
            big = max(p.elements for p in plans[name].pieces)
            assert tgc._PIECE < big <= 4 * tgc._PIECE, (name, big)


def test_a_piece_sorts_at_most_piece_elements_a_call(monkeypatch):
    """``_select`` sorts rows ``_PIECE`` elements at a time and gives what
    one sort gives."""
    seen = []
    real = tgc.topk_largest

    def counted(mag, k):
        seen.append(mag.numel())
        return real(mag, k)

    rows = torch.from_numpy(np.random.default_rng(3).standard_normal((37, 64)).astype(np.float32))
    monkeypatch.setattr(tgc, "topk_largest", counted)
    want = tgc._select(rows, 4)
    assert seen == [37 * 64]
    seen.clear()
    monkeypatch.setattr(tgc, "_PIECE", 640)
    got = tgc._select(rows, 4)
    assert seen == [640, 640, 640, 448]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cut_pieces_gather_into_whole_blocks(monkeypatch):
    """The rows of every piece :func:`_cut` gives, gathered as
    ``NamedSharding.gather`` concatenates the ranks' parts (each split dim
    in rank order), are the unit's blocks, each contiguous and aligned:
    runs of whole units of one rank, and where a split cuts through blocks
    the smallest run that holds whole ones."""
    monkeypatch.setattr(tgc, "_PIECE", 640)
    for shape, counts in (((48, 80), (2, 2)), ((2, 2, 72, 8), (1, 2, 2, 1)),
                          ((2, 4, 48, 24), (1, 2, 2, 1)), ((3, 2, 64, 6), (1, 1, 2, 1))):
        bl = 64
        local = [s // c for s, c in zip(shape, counts)]
        pieces = tgc._cut(shape, counts, local, 0, bl)
        assert pieces, shape
        index = np.arange(math.prod(shape)).reshape(shape)
        seen = []
        for ix in pieces:
            pos = [[k * n + i for k in range(c) for i in range(*s.indices(n))]
                   for s, n, c in zip(ix, local, counts)]
            rows = index[np.ix_(*pos)].reshape(-1, bl)
            assert (rows[:, 0] % bl == 0).all(), (shape, ix)
            assert (np.diff(rows, axis=1) == 1).all(), (shape, ix)
            seen.extend(rows[:, 0] // bl)
        assert sorted(seen) == list(range(math.prod(shape) // bl)), shape
