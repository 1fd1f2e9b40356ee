"""The port's op counter (``repro_torch.launch.hlo_analysis``), the port's
stand-in for the reference's HLO parser.

Hand-made functions whose counts are known exactly (flops, unfused and
fused bytes, transcendentals, the score blocks, live bytes) and each
collective's per-device output bytes on a ``fake``-backend world of 4.
Then the ten reduced configs' train, prefill and decode steps on a 1x1
mesh: the counter's flops over the port's step against
``repro.launch.hlo_analysis.analyze_hlo`` on the reference's compiled step
of the same config, settings and shapes (``unknown_trip_whiles == 0``
asserted).  Tolerance: prefill and decode equal exactly; a train step's
count may exceed the reference's by at most 5% and never falls short.
The excess is the port's recompute: torch's checkpoint reruns a layer up
to its last op that saves a tensor for the backward, where XLA drops every
recomputed product the backward does not read and merges repeated ones
(PERF.md names the products, config by config), and one rank-1 gradient
product that XLA rewrites into a multiply.
"""
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import repro.configs as rconfigs
import repro.models as R
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_mesh as rmake_mesh
from repro.serve import step as rserve
from repro.train import step as rstep

import repro_torch.configs as tconfigs
import repro_torch.models as T
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch.mesh import make_mesh as tmake_mesh
from repro_torch.models.common import score_block
from repro_torch.serve import step as tserve
from repro_torch.train import step as tstep

from _torch_mesh import end_the_world_it_started  # noqa: F401  (autouse)

torch.set_num_threads(1)

ARCH_NAMES = sorted(rconfigs.ARCHS)
KINDS = ("train", "prefill", "decode")
B, S, CHUNK = 2, 32, 16         # two q chunks by two kv chunks
TRAIN_EXCESS = 0.05             # the most a train count may exceed the reference's
F32 = 4


def _f(*shape):
    return torch.from_numpy(np.random.default_rng(sum(shape)).standard_normal(shape)
                            .astype(np.float32))


def test_a_matmul_and_an_exp_counted_exactly():
    a, b = _f(8, 16), _f(16, 4)
    out, st = ha.count_ops(lambda a, b: torch.exp(a @ b), a, b)
    assert torch.equal(out, torch.exp(a @ b))
    assert st.flops == 2 * 8 * 16 * 4
    mm = F32 * (8 * 4 + 8 * 16 + 16 * 4)            # result + both operands
    assert st.hbm_bytes == mm + F32 * (32 + 32)      # exp writes 32, reads 32
    assert st.hbm_bytes_fused == mm                  # the elementwise exp fuses
    assert st.transcendentals == 32
    assert st.attn_score_bytes == 0 and st.unknown_trip_whiles == 0
    assert st.collective_bytes == 0
    assert set(st.collectives) == {"all-reduce", "all-gather", "reduce-scatter",
                                   "all-to-all", "collective-permute"}


def test_views_empty_and_arange_count_no_bytes():
    x = _f(6, 10)

    def fn(x):
        torch.empty((100, 100))
        torch.arange(50)
        return x.t().reshape(10, 6)[2:5].unsqueeze(0)

    _, st = ha.count_ops(fn, x)
    assert st.hbm_bytes == st.hbm_bytes_fused == st.flops == st.transcendentals == 0


def test_batched_and_fused_matmuls():
    a, b, c = _f(3, 5, 7), _f(3, 7, 2), _f(5, 2)

    def fn(a, b, c):
        return torch.bmm(a, b), torch.addmm(c, a[0], b[0])

    _, st = ha.count_ops(fn, a, b, c)
    assert st.flops == 2 * 3 * 5 * 7 * 2 + 2 * 5 * 7 * 2
    bmm = F32 * (3 * 5 * 2 + 3 * 5 * 7 + 3 * 7 * 2)
    addmm = F32 * (5 * 2 + 5 * 2 + 5 * 7 + 7 * 2)
    assert st.hbm_bytes_fused == st.hbm_bytes == bmm + addmm


def test_data_movement_in_the_fused_model():
    table, idx = _f(50, 8), torch.tensor([3, 1, 4, 1, 5])
    y, z = _f(4, 10), _f(4, 3)
    upd = _f(5, 8)

    def gather(table, idx):
        return torch.embedding(table, idx)

    _, st = ha.count_ops(gather, table, idx)
    assert st.hbm_bytes_fused == 2 * F32 * 5 * 8                 # read + write the rows
    assert st.hbm_bytes == F32 * 5 * 8 + F32 * 50 * 8 + 8 * 5   # result + table + idx

    def index_add(table, idx, upd):
        return table.index_add(0, idx, upd)

    _, st = ha.count_ops(index_add, table, idx, upd)
    assert st.hbm_bytes_fused == 2 * F32 * 5 * 8                 # the updates, twice

    def slice_update(y, z):
        y[:, 2:5] = z
        return y

    _, st = ha.count_ops(slice_update, y.clone(), z)
    assert st.hbm_bytes_fused == 2 * F32 * 4 * 3                 # the update, twice
    assert st.hbm_bytes == 3 * F32 * 4 * 3                       # copy_: dst, dst, src

    def whole_copy(y):
        return torch.empty_like(y).copy_(y)

    _, st = ha.count_ops(whole_copy, y)
    assert st.hbm_bytes_fused == 0 and st.hbm_bytes == 3 * F32 * 40

    _, st = ha.count_ops(lambda y: torch.sort(y, dim=-1), y)
    assert st.hbm_bytes_fused == st.hbm_bytes == F32 * 40 + 8 * 40 + F32 * 40


@pytest.mark.parametrize("fn,n", [
    (torch.tanh, 40), (torch.sigmoid, 40), (torch.rsqrt, 40), (torch.erf, 40),
    (torch.sqrt, 40), (torch.log1p, 40), (lambda x: torch.softmax(x, -1), 40),
    (lambda x: torch.nn.functional.silu(x), 40), (lambda x: x ** 0.5, 40),
    (lambda x: x ** 2, 0), (torch.square, 0), (lambda x: x * x + 1, 0),
    (lambda x: torch.logsumexp(x, -1), 40 + 4),
], ids=["tanh", "sigmoid", "rsqrt", "erf", "sqrt", "log1p", "softmax", "silu",
        "pow_half", "pow_2", "square", "polynomial", "logsumexp"])
def test_transcendentals(fn, n):
    _, st = ha.count_ops(fn, _f(4, 10).abs())
    assert st.transcendentals == n


def test_score_blocks_are_the_marked_products():
    q, k, v = _f(2, 3, 4), _f(2, 5, 4), _f(2, 5, 4)

    def attn(q, k, v):
        with score_block():
            s = torch.einsum("bqd,bkd->bqk", q, k)      # makes a (3, 5) block a batch
        p = torch.softmax(s, -1)
        with score_block(p):
            o = torch.einsum("bqk,bkd->bqd", p, v)      # reads it
        return q @ q.transpose(1, 2), o                 # unmarked

    _, st = ha.count_ops(attn, q, k, v)
    assert st.attn_score_bytes == 2 * F32 * 2 * 3 * 5
    assert st.flops == 2 * (2 * 2 * 3 * 4 * 5) + 2 * 2 * 3 * 4 * 3


def test_live_and_peak_bytes_follow_the_storages():
    def fn():
        x = torch.ones(1000)                # 4000
        y = x * 2                           # 8000 live
        del x                               # 4000
        v = y[10:20]                        # a view: nothing new
        z = torch.ones(250)                 # 5000
        return y, z, v

    counter = ha.OpCounter()
    with counter:
        out = fn()
    assert counter.peak_bytes == 8000 and counter.live_bytes == 5000
    del out
    assert counter.live_bytes == 0


@pytest.fixture
def world_of_four():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_each_collective_counts_its_per_device_output(world_of_four):
    x = _f(6, 5)

    def fn(x):
        parts = [torch.empty_like(x) for _ in range(4)]
        dist.all_gather(parts, x)                                # 4 x 120 bytes
        whole = torch.empty((24, 5))
        with warnings.catch_warnings():     # renamed *_single in newer torch
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(whole, x)                # 480
            dist.reduce_scatter_tensor(torch.empty((1, 5)), x[:4].contiguous())  # 20
        dist.all_reduce(x)                                       # 120
        block = torch.empty((2, 5))
        dist.reduce_scatter(block, list(torch.cat([x, x[:2]]).chunk(4)))   # 40
        out = torch.empty((4, 5))
        dist.all_to_all_single(out, x[:4].contiguous())          # 80
        return parts

    _, st = ha.count_ops(fn, x)
    c = st.collectives
    assert c["all-gather"] == {"bytes": 480 + 480, "count": 2}
    assert c["all-reduce"] == {"bytes": 120, "count": 1}
    assert c["reduce-scatter"] == {"bytes": 40 + 20, "count": 2}
    assert c["all-to-all"] == {"bytes": 80, "count": 1}
    assert c["collective-permute"] == {"bytes": 0, "count": 0}
    assert st.collective_bytes == 480 + 480 + 120 + 60 + 80


def test_fake_and_real_tensors_count_alike():
    """The dry run counts on fake tensors; the same step on real ones gives
    the same stats and the same peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = tconfigs.reduced(tconfigs.ARCHS["olmoe-1b-7b"])
    st = T.ModelSettings(q_chunk=CHUNK, kv_chunk=CHUNK)
    _, jit_for, _ = tstep.build_train_step(cfg, tmake_mesh((1, 1), ("data", "model"),
                                                           device="cpu"),
                                           settings=st, donate=False)
    specs = T.input_batch_specs(cfg, tconfigs.ShapeConfig("t", S, B, "train"))
    step = jit_for(specs)
    state = tstep.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(specs, cfg)
    real = ha.OpCounter()
    with real:
        step(state, batch)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_state = {k: _tree(mode, v) for k, v in state.items()}
        fake_batch = _tree(mode, batch)
        fake = ha.OpCounter()
        with fake:
            step(fake_state, fake_batch)
    assert fake.stats == real.stats
    assert fake.peak_bytes == real.peak_bytes


def _tree(mode, tree):
    if isinstance(tree, dict):
        return {k: _tree(mode, v) for k, v in tree.items()}
    return mode.from_tensor(tree)


def _batch(specs, cfg):
    rng = np.random.default_rng(0)
    out = {}
    for k, v in specs.items():
        if v.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(0, cfg.vocab, v.shape).astype(np.int32))
        else:
            out[k] = torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)
                                      ).to(v.dtype)
    return out


@pytest.fixture(scope="module")
def meshes():
    return rmake_mesh((1, 1), ("data", "model")), tmake_mesh((1, 1), ("data", "model"),
                                                             device="cpu")


def _reference_flops(cfg, shape, mesh) -> float:
    st = R.ModelSettings(q_chunk=CHUNK, kv_chunk=CHUNK)
    bs = R.input_batch_specs(cfg, shape)
    with mesh:
        if shape.kind == "train":
            _, jit_for, _ = rstep.build_train_step(cfg, mesh, settings=st, donate=False)
            compiled = jit_for(bs).lower(rstep.train_state_specs(cfg), bs).compile()
        elif shape.kind == "prefill":
            ps = R.param_specs(cfg)
            _, jit_for = rserve.build_prefill_step(cfg, mesh, settings=st)
            jitted, nargs = jit_for(ps, bs)
            compiled = (jitted.lower(ps, bs["tokens"], bs["frames"]) if nargs == 3
                        else jitted.lower(ps, bs["tokens"])).compile()
        else:
            ps = R.param_specs(cfg)
            _, jit_for = rserve.build_decode_step(cfg, mesh, settings=st, donate_cache=True)
            compiled = jit_for(ps, bs["cache"], bs["token"]).lower(
                ps, bs["cache"], bs["token"], jax.ShapeDtypeStruct((), jnp.int32)).compile()
    la = analyze_hlo(compiled.as_text())
    assert la.unknown_trip_whiles == 0
    return la.flops


def _port_flops(cfg, shape, mesh) -> float:
    st = T.ModelSettings(q_chunk=CHUNK, kv_chunk=CHUNK)
    specs = T.input_batch_specs(cfg, shape)
    g = torch.Generator().manual_seed(0)
    if shape.kind == "train":
        _, jit_for, _ = tstep.build_train_step(cfg, mesh, settings=st, donate=False)
        state = tstep.init_train_state(cfg, g, device="cpu")
        _, stats = ha.count_ops(jit_for(specs), state, _batch(specs, cfg))
    elif shape.kind == "prefill":
        params = T.init_params(cfg, g, device="cpu")
        _, jit_for = tserve.build_prefill_step(cfg, mesh, settings=st)
        step, _ = jit_for(params, specs)
        batch = _batch(specs, cfg)
        _, stats = ha.count_ops(step, params, batch["tokens"], batch.get("frames"))
    else:
        params = T.init_params(cfg, g, device="cpu")
        _, jit_for = tserve.build_decode_step(cfg, mesh, settings=st)
        cache = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs["cache"].items()}
        token = _batch({"token": specs["token"]}, cfg)["token"]
        _, stats = ha.count_ops(jit_for(params, specs["cache"], specs["token"]),
                                params, cache, token, S - 1)
    return stats.flops


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_flops_against_the_references_compiled_step(meshes, arch, kind):
    rmesh, tmesh = meshes
    want = _reference_flops(rconfigs.reduced(rconfigs.ARCHS[arch]),
                            rconfigs.ShapeConfig("x", S, B, kind), rmesh)
    got = _port_flops(tconfigs.reduced(tconfigs.ARCHS[arch]),
                      tconfigs.ShapeConfig("x", S, B, kind), tmesh)
    if kind == "train":
        assert want <= got <= want * (1 + TRAIN_EXCESS), (got, want, got / want - 1)
    else:
        assert got == want, (got, want)
