"""The port's LLM stack (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package's (``repro.configs``, ``repro.models``), on the CPU.

Inputs come from numpy with a fixed seed; weights come from the
reference's ``init_params`` and cross through ``models.convert``.  The
reference runs through its own jit path, as tests/test_models_smoke.py
runs it (eager jnp would also compile every op on first use).

Tolerance, float32: rtol = 1e-4 and atol = 1e-5 times the output's scale
(its largest |value|).

bfloat16 keeps an 8-bit significand: a unit in the last place is 2^-7 of a
value at most, and one rounding moves a value by at most u = 2^-8 of it.
The reference under jit fuses elementwise chains and, by default, rounds
once at their end (XLA's excess precision), while the port, eagerly, rounds
after each op; and XLA's CPU backend lowers ``jax.nn.sigmoid`` as
1 / (1 + exp(-x)) and ``jax.nn.gelu`` op by op, each rounded to bfloat16,
where ``torch.sigmoid``, ``F.silu`` and ``F.gelu`` round once.  So:
- Rounding for rounding: the reference compiled without excess precision
  (eager for ``rmsnorm``), the port's bf16 sigmoid, silu and gelu swapped
  for twins that round as XLA's CPU lowering does (``xla_cpu_rounding``),
  every other op as shipped.  ``rmsnorm``, modules (attention, decode
  attention, FFN, MoE, RWKV and Mamba mixers) and whole models
  (``prefill``, ``decode_step``, the cache):
  bfloat16 results equal but for at most 1% of elements, each within one
  ulp at the scale (2^-7 of the largest |value|): a float32 exp or tanh
  that differs in its last bits can flip one rounding upstream.  float32
  results (SSM states, aux) within the float32 tolerance.  A cast moved
  anywhere on the path changes far more than 1% of the elements.
- As shipped, against the reference's default jit: both paths sit within
  the reference's own bfloat16 error ``d`` (its largest |bf16 - float32| on
  the same weights and inputs) of the float32 result, so they lie within
  2 max(d, 4u x scale) of each other.  The logits must be bfloat16 values,
  as the reference's bf16 head gives them.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import repro.configs as rconfigs
import repro.models as R
from repro.models import attention as rattn
from repro.models import common as rcommon
from repro.models import moe as rmoe
from repro.models import ssm as rssm

import repro_torch.configs as tconfigs
import repro_torch.models as T
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.models.transformer import LanguageModel

torch.set_num_threads(1)

RTOL, ATOL_SCALE = 1e-4, 1e-5
BF16_RTOL, BF16_U = 2.0 ** -7, 2.0 ** -8
BF16_ATOL_SCALE = 4 * BF16_U
BF16_MAX_UNEQUAL = 0.01   # share of bf16 elements that may differ, rounding for rounding
NAMES = sorted(rconfigs.ARCHS)
RST = R.ModelSettings(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none",
                      compute_dtype=jnp.float32)
TST = T.ModelSettings(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none",
                      compute_dtype=torch.float32)


def t(a, dtype=None):
    """numpy -> torch on the CPU."""
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def close(got, want, what="", rtol=RTOL, atol_scale=ATOL_SCALE):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale, err_msg=what)


def close_tree(got, want, what=""):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            close_tree(got[k], want[k], f"{what}/{k}")
        else:
            close(got[k], want[k], f"{what}/{k}")


@functools.lru_cache(maxsize=None)
def ref_params(cfg, seed=0):
    """The reference's weights (jitted: eager init takes seconds a config)."""
    return jax.jit(R.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(seed))


def port_params(ref):
    return from_reference(jax.tree.map(np.asarray, ref), device="cpu")


def pair(name):
    return rconfigs.reduced(rconfigs.ARCHS[name]), tconfigs.reduced(tconfigs.ARCHS[name])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_configs_are_the_references(name):
    rcfg, tcfg = rconfigs.get_arch(name), tconfigs.get_arch(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(tconfigs.reduced(tcfg)) == dataclasses.asdict(rconfigs.reduced(rcfg))
    assert (tcfg.hd, tcfg.is_subquadratic) == (rcfg.hd, rcfg.is_subquadratic)
    for shape in rconfigs.SHAPES:
        assert (tconfigs.cell_applicable(tcfg, tconfigs.SHAPES[shape])
                == rconfigs.cell_applicable(rcfg, rconfigs.SHAPES[shape]))
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 16), (2, 7, 4, 64)])
def test_rmsnorm(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = rcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    close(tcommon.rmsnorm(t(x), t(w), 1e-5), want, "f32")
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = rcommon.rmsnorm(xb, wb, 1e-5)
    got = tcommon.rmsnorm(t(x, torch.bfloat16), t(w, torch.bfloat16), 1e-5)
    assert got.dtype == torch.bfloat16
    _bits_close(got, want, "bf16")


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("offset", [0, 1000])
def test_rope(theta, offset):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (np.arange(7) + offset)[None, :]
    want = rcommon.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(tcommon.rope(t(x), t(pos), theta), want)
    # half-split: rotating by position 0 is the identity
    assert torch.equal(tcommon.rope(t(x), torch.zeros((1, 7), dtype=torch.int64), theta),
                       t(x))


@pytest.mark.parametrize("seq,d,offset", [(5, 16, 0), (24, 64, 3), (7, 6, 100)])
def test_sinusoidal_tables(seq, d, offset):
    want = np.asarray(rcommon.sinusoidal_positions(seq, d, offset))
    got = tcommon.sinusoidal_positions(seq, d, offset)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)  # the same numpy code
    for pos in (0, 3, seq + offset):
        want1 = rcommon.sinusoidal_position_at(jnp.int32(pos), d)
        close(tcommon.sinusoidal_position_at(pos, d), want1, f"pos {pos}")


def test_gelu_is_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    close(tcommon.gelu(t(x)), rcommon.gelu(jnp.asarray(x)))
    close(tcommon.swiglu_act(t(x), t(x[::-1])), rcommon.swiglu_act(jnp.asarray(x),
                                                                   jnp.asarray(x[::-1])))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, causal):
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * hd ** -0.5
    if causal:
        m = torch.tril(torch.ones((Sq, k.shape[1]), dtype=torch.bool), k.shape[1] - Sq)
        s = torch.where(m, s, -1e30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v)
    return o.reshape(B, Sq, Hq, hd)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["masked", "triangular", "cp"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,qc,kc", [
    (2, 64, 4, 2, 16, 16, 32),
    (1, 96, 6, 3, 8, 32, 48),
    (2, 40, 4, 4, 16, 16, 12),     # chunks that do not divide S
])
def test_flash_attention(causal, impl, B, S, Hq, Hkv, hd, qc, kc):
    rng = np.random.default_rng(B * S + Hq)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for H in (Hq, Hkv, Hkv))
    got = tattn.flash_attention(t(q), t(k), t(v), causal=causal, q_chunk=qc,
                                kv_chunk=kc, impl=impl)
    want = rattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, q_chunk=qc, kv_chunk=kc, impl=impl)
    close(got, want, "against the reference")
    close(got, naive_attention(t(q), t(k), t(v), causal).numpy(), "against a naive softmax")


def test_flash_attention_q_offset_and_lse():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 32, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, 32, 1, 8)).astype(np.float32)
    for impl in ("masked", "triangular", "cp"):
        out, lse = tattn._flash_fwd_impl(t(q), t(k), t(v), True, 8, 8, 16, impl)
        rout, rlse = rattn._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           True, 8, 8, 16, impl)
        close(out, rout, impl)
        close(lse, rlse, impl)


@pytest.mark.parametrize("name", ["smollm-135m", "qwen2.5-32b", "qwen3-32b", "whisper-small"])
def test_decode_attention_clamps_pos(name):
    rcfg, tcfg = pair(name)
    p = ref_params(rcfg)["blocks"]
    p = jax.tree.map(lambda a: np.asarray(a[0]), p["dec"]["attn"] if "dec" in p else p["attn"])
    rng = np.random.default_rng(2)
    B, S = 2, 8
    x = rng.standard_normal((B, 1, rcfg.d_model)).astype(np.float32)
    cache = {k: rng.standard_normal((B, S, rcfg.n_kv_heads, rcfg.hd)).astype(np.float32)
             for k in ("k", "v")}
    for pos in (0, 3, S - 1, S, S + 3):   # pos >= S writes at S - 1, masks nothing
        want_out, want_cache = jax.jit(
            lambda x, p, c, pos: rattn.decode_attention(x, p, rcfg, c, pos))(
            jnp.asarray(x), p, cache, jnp.int32(pos))
        tc = {k: t(v) for k, v in cache.items()}
        got_out, got_cache = tattn.decode_attention(t(x), {k: t(v) for k, v in p.items()},
                                                    tcfg, tc, pos)
        close(got_out, want_out, f"pos {pos}")
        close_tree(got_cache, want_cache, f"pos {pos}")
        assert got_cache["k"] is tc["k"]   # written in place


def test_attention_shard_modes():
    rcfg, tcfg = pair("smollm-135m")
    p = jax.tree.map(lambda a: np.asarray(a[0]), ref_params(rcfg)["blocks"]["attn"])
    x = np.random.default_rng(3).standard_normal((2, 32, rcfg.d_model)).astype(np.float32)
    tp = {k: t(v) for k, v in p.items()}
    for shard in ("auto", "cp", "replicate", "heads"):
        want = jax.jit(lambda x, p: rattn.attention(x, p, rcfg, q_chunk=8, kv_chunk=16,
                                                    attn_shard=shard))(x, p)
        close(tattn.attention(t(x), tp, tcfg, q_chunk=8, kv_chunk=16, attn_shard=shard),
              want, shard)
    # over a model axis the reference's modes are sharding constraints, layout
    # hints: the port's values are those of one device
    for shard in ("replicate", "heads", "cp"):
        one = tattn.attention(t(x), tp, tcfg, q_chunk=8, kv_chunk=16, attn_shard=shard)
        two = tattn.attention(t(x), tp, tcfg, q_chunk=8, kv_chunk=16, attn_shard=shard,
                              n_model=2, batch_axes=("pod", "data"))
        assert torch.equal(one, two), shard
    q = t(x.reshape(2, 32, 4, rcfg.d_model // 4))
    assert torch.equal(tattn.flash_attention(q, q, q, causal=True, shard_axes=("data", "model")),
                       tattn.flash_attention(q, q, q, causal=True))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,unbalanced", [
    ("olmoe-1b-7b", False), ("llama4-scout-17b-a16e", False), ("jamba-v0.1-52b", False),
    ("olmoe-1b-7b", True), ("llama4-scout-17b-a16e", True)])
def test_moe_ffn(name, unbalanced):
    rcfg, tcfg = pair(name)
    blocks = ref_params(rcfg)["blocks"]
    lead = (0, 0) if rcfg.family == "hybrid" else (0,)
    p = jax.tree.map(lambda a: np.asarray(a[lead]), blocks["moe"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, rcfg.d_model)).astype(np.float32)
    if unbalanced:   # a router that sends nearly every token to expert 0
        p["router"] = p["router"].copy()
        p["router"][:, 0] = np.abs(x).mean() * 10
        x = np.abs(x)
    want, want_aux = jax.jit(lambda x, p: rmoe.moe_ffn(x, p, rcfg))(x, p)
    got, got_aux = tmoe.moe_ffn(t(x), {k: t(v) for k, v in p.items()}, tcfg)
    close(got, want)
    for k in want_aux:
        close(got_aux[k], want_aux[k], k)
    if unbalanced:
        assert float(got_aux["drop_fraction"]) > 0.2


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    for k in (1, 2, 3):
        rv, ri = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe._top_k(t(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


# ---------------------------------------------------------------------------
# SSM mixers
# ---------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: np.asarray(a[0]), tree)


def test_rwkv_sequential_and_chunked_with_carried_state():
    rcfg, tcfg = pair("rwkv6-7b")
    blocks = ref_params(rcfg)["blocks"]
    tm = _layer0(blocks["tm"])
    rng = np.random.default_rng(6)
    for k in tm:   # non-trivial token shift, decay and bonus
        if k.startswith("mu_") or k in ("w0", "u"):
            tm[k] = rng.uniform(-0.5, 0.5, tm[k].shape).astype(np.float32)
    B, S, D = 2, 16, rcfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    state = rng.standard_normal((B, rcfg.n_heads, rcfg.hd, rcfg.hd)).astype(np.float32)
    x_prev = rng.standard_normal((B, 1, D)).astype(np.float32)
    rp, tp = jax.tree.map(jnp.asarray, tm), {k: t(v) for k, v in tm.items()}
    want, (ws, wx) = jax.jit(lambda *a: rssm.rwkv6_timemix(*a[:2], rcfg, *a[2:]))(
        x, rp, state, x_prev)
    got, (gs, gx) = tssm.rwkv6_timemix(t(x), tp, tcfg, t(state), t(x_prev))
    close(got, want, "sequential")
    close(gs, ws, "state")
    np.testing.assert_array_equal(gx.numpy(), x[:, -1:])   # the raw last input
    cw, (cs, _) = jax.jit(lambda *a: rssm.rwkv6_timemix_chunked(*a[:2], rcfg, *a[2:],
                                                                chunk=4))(x, rp, state, x_prev)
    cg, (cgs, _) = tssm.rwkv6_timemix_chunked(t(x), tp, tcfg, t(state), t(x_prev), chunk=4)
    close(cg, cw, "chunked")
    close(cgs, cs, "chunked state")
    close(cg, want, "chunked against sequential")
    # decode is the one-step time-mix; its carry feeds the next step
    d1, (s1, x1) = tssm.rwkv6_decode(t(x[:, :1]), tp, tcfg, t(state), t(x_prev))
    d2, (s2, _) = tssm.rwkv6_decode(t(x[:, 1:2]), tp, tcfg, s1, x1)
    dec = jax.jit(lambda *a: rssm.rwkv6_decode(*a[:2], rcfg, *a[2:]))
    w1, (ws1, wx1) = dec(x[:, :1], rp, state, x_prev)
    w2, (ws2, _) = dec(x[:, 1:2], rp, ws1, wx1)
    close(torch.cat([d1, d2], 1), np.concatenate([w1, w2], 1), "two decode steps")
    close(s2, ws2, "state after two decode steps")
    cm = _layer0(blocks["cm"])
    cm["mu_ck"] = rng.uniform(0, 1, D).astype(np.float32)
    want, wx = jax.jit(lambda *a: rssm.rwkv6_channelmix(*a[:2], rcfg, *a[2:]))(
        x, cm, x_prev)
    got, gx = tssm.rwkv6_channelmix(t(x), {k: t(v) for k, v in cm.items()}, tcfg, t(x_prev))
    close(got, want, "channel mix")


def test_mamba_with_conv_state():
    rcfg, tcfg = pair("jamba-v0.1-52b")
    p = jax.tree.map(lambda a: np.asarray(a[0, 0]), ref_params(rcfg)["blocks"]["mamba"])
    rng = np.random.default_rng(7)
    p["A_log"] = rng.uniform(-1, 1, p["A_log"].shape).astype(np.float32)
    p["dt_bias"] = rng.uniform(-1, 1, p["dt_bias"].shape).astype(np.float32)
    B, S, D = 2, 8, rcfg.d_model
    Di = rcfg.ssm_expand * D
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    state = rng.standard_normal((B, Di, rcfg.d_state)).astype(np.float32)
    conv = rng.standard_normal((B, rcfg.conv_kernel - 1, Di)).astype(np.float32)
    rp, tp = jax.tree.map(jnp.asarray, p), {k: t(v) for k, v in p.items()}
    for args in ((), (state, conv)):
        want, (ws, wc) = jax.jit(lambda *a: rssm.mamba_mix(*a[:2], rcfg, *a[2:]))(
            x, rp, *args)
        got, (gs, gc) = tssm.mamba_mix(t(x), tp, tcfg, *(t(a) for a in args))
        close(got, want, f"{len(args)} states")
        close(gs, ws, "ssm state")
        close(gc, wc, "conv state")
    d, (ds, dc) = tssm.mamba_decode(t(x[:, :1]), tp, tcfg, t(state), t(conv))
    want, (ws, wc) = jax.jit(lambda *a: rssm.mamba_decode(*a[:2], rcfg, *a[2:]))(
        x[:, :1], rp, state, conv)
    close(d, want, "decode")
    close(dc, wc, "decode conv state")


# ---------------------------------------------------------------------------
# whole models, every family
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def _ref_cache(cfg, B, S, seed=1):
    cache = R.cache_spec(cfg, B, S, dtype=jnp.float32, mode="zeros")
    if cfg.family == "encdec":   # encoder KV, as a prefill would leave it
        rng = np.random.default_rng(seed)
        cache = {**cache, **{k: jnp.asarray(rng.standard_normal(cache[k].shape), jnp.float32)
                             for k in ("xk", "xv")}}
    return cache


@pytest.mark.parametrize("name", NAMES)
def test_reduced_model_prefill_loss_and_decode(name):
    rcfg, tcfg = pair(name)
    rp = ref_params(rcfg)
    tp = port_params(rp)
    batch = _batch(rcfg)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: t(v) for k, v in batch.items()}

    want = jax.jit(lambda p, b: R.prefill(p, b["tokens"], rcfg, RST,
                                          enc_inputs=b.get("frames")))(rp, rb)
    got = T.prefill(tp, tb["tokens"], tcfg, TST, enc_inputs=tb.get("frames"))
    close(got, want, "prefill")

    wl, wm = jax.jit(lambda p, b: R.lm_loss(p, b, rcfg, RST))(rp, rb)
    gl, gm = T.lm_loss(tp, tb, tcfg, TST)
    close(gl, wl, "loss")
    assert sorted(gm) == sorted(wm)
    for k in wm:
        close(gm[k], wm[k], k)

    # eight teacher-forced decode steps, logits and caches after each
    B, S = 2, 12
    rc = _ref_cache(rcfg, B, S)
    tc = from_reference(jax.tree.map(np.asarray, rc), device="cpu")
    step = jax.jit(lambda p, c, tok, pos: R.decode_step(p, c, tok, pos, rcfg, RST))
    for i in range(8):
        tok = batch["tokens"][:, i:i + 1]
        wlog, rc = step(rp, rc, jnp.asarray(tok), jnp.int32(i))
        glog, tc = T.decode_step(tp, tc, t(tok), i, tcfg, TST)
        close(glog, wlog, f"decode step {i}")
        close_tree(tc, rc, f"cache after step {i}")


@pytest.mark.parametrize("name,settings", [
    ("smollm-135m", dict(attn_impl="triangular")),
    ("qwen3-32b", dict(attn_shard="cp")),
    ("jamba-v0.1-52b", dict(attn_impl="triangular", q_chunk=8, kv_chunk=8)),
    ("rwkv6-7b", dict(rwkv_chunk=8)),
])
def test_reduced_model_settings(name, settings):
    rcfg, tcfg = pair(name)
    rp = ref_params(rcfg, seed=1)
    batch = _batch(rcfg, seed=1)
    rst = dataclasses.replace(RST, **settings)
    tst = dataclasses.replace(TST, **settings)
    want = jax.jit(lambda p, tok: R.prefill(p, tok, rcfg, rst))(rp, jnp.asarray(batch["tokens"]))
    close(T.prefill(port_params(rp), t(batch["tokens"]), tcfg, tst), want)


def _bf16(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


def _tbf16(tree):
    return {k: t(v, torch.bfloat16) for k, v in tree.items()}


def _rounded(fn):
    """``fn`` jitted with every bfloat16 op rounded as written (XLA's
    excess precision off), compiled on first call."""
    compiled = {}

    def run(*args):
        if "fn" not in compiled:
            compiled["fn"] = jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled["fn"](*args)
    return run


_F_SILU, _F_GELU, _SIGMOID = F.silu, F.gelu, torch.sigmoid


def _rb(a):
    """Round float32 to bfloat16 and back."""
    return a.to(torch.bfloat16).float()


def _xla_sigmoid(x):
    if x.dtype != torch.bfloat16:
        return _SIGMOID(x)
    return _rb(1 / _rb(1 + _rb(torch.exp(-x.float())))).to(torch.bfloat16)


def _xla_silu(x, inplace=False):
    if x.dtype != torch.bfloat16:
        return _F_SILU(x)
    return (x.float() * _xla_sigmoid(x).float()).to(torch.bfloat16)


def _xla_gelu(x, approximate="none"):
    if x.dtype != torch.bfloat16:
        return _F_GELU(x, approximate=approximate)
    assert approximate == "tanh"
    xf = x.float()
    c0, c1 = _rb(torch.tensor(np.sqrt(2 / np.pi))), _rb(torch.tensor(0.044715))
    x3 = _rb(_rb(xf * xf) * xf)
    cdf = _rb(0.5 * _rb(1 + _rb(torch.tanh(_rb(c0 * _rb(xf + _rb(c1 * x3)))))))
    return (xf * cdf).to(torch.bfloat16)


@pytest.fixture
def xla_cpu_rounding(monkeypatch):
    """The port's bf16 sigmoid, silu and gelu, rounded op by op as XLA's
    CPU backend lowers ``jax.nn.sigmoid``, ``jax.nn.silu`` and
    ``jax.nn.gelu(approximate=True)`` (constants in bfloat16)."""
    monkeypatch.setattr(torch, "sigmoid", _xla_sigmoid)
    monkeypatch.setattr(F, "silu", _xla_silu)
    monkeypatch.setattr(F, "gelu", _xla_gelu)


def _bits_close(got, want, what, bf16=None):
    """bfloat16 values (``bf16``, by default the reference's dtype): equal
    but for at most BF16_MAX_UNEQUAL of them, each within one ulp at the
    scale; float32: the float32 tolerance."""
    if bf16 is None:
        bf16 = want.dtype == jnp.bfloat16
    if not bf16:
        close(got, want, what)
        return
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g, w, rtol=0, atol=BF16_RTOL * scale, err_msg=what)
    unequal = float(np.mean(g != w))
    assert unequal <= BF16_MAX_UNEQUAL, f"{what}: {unequal:.4f} of the elements differ"


def _bf16_module_case(case, rng):
    """(port outputs, reference outputs) of one module in bfloat16."""
    bf = torch.bfloat16
    if case.startswith(("attention", "decode_attention", "dense_ffn")):
        name = case.split(":")[1]
        rcfg, tcfg = pair(name)
        blocks = ref_params(rcfg)["blocks"]
        blocks = blocks["dec"] if "dec" in blocks else blocks
        kind = "mlp" if case.startswith("dense_ffn") else "attn"
        p = _layer0(blocks[kind])
        x = rng.standard_normal((2, 16, rcfg.d_model)).astype(np.float32)
        if kind == "mlp":
            return ((tmoe.dense_ffn(t(x, bf), _tbf16(p), tcfg),),
                    (_rounded(lambda x, p: rmoe.dense_ffn(x, p, rcfg))(_bf16(x), _bf16(p)),))
        if case.startswith("attention"):
            return ((tattn.attention(t(x, bf), _tbf16(p), tcfg, q_chunk=8, kv_chunk=8),),
                    (_rounded(lambda x, p: rattn.attention(x, p, rcfg, q_chunk=8, kv_chunk=8))(
                        _bf16(x), _bf16(p)),))
        cache = {k: rng.standard_normal((2, 8, rcfg.n_kv_heads, rcfg.hd)).astype(np.float32)
                 for k in ("k", "v")}
        got, gc = tattn.decode_attention(t(x[:, :1], bf), _tbf16(p), tcfg, _tbf16(cache), 3)
        want, wc = _rounded(lambda x, p, c: rattn.decode_attention(x, p, rcfg, c, 3))(
            _bf16(x[:, :1]), _bf16(p), _bf16(cache))
        return (got, gc["k"], gc["v"]), (want, wc["k"], wc["v"])
    if case.startswith("moe"):
        rcfg, tcfg = pair(case.split(":")[1])
        lead = (0, 0) if rcfg.family == "hybrid" else (0,)
        p = jax.tree.map(lambda a: np.asarray(a[lead]), ref_params(rcfg)["blocks"]["moe"])
        x = rng.standard_normal((2, 32, rcfg.d_model)).astype(np.float32)
        got, gaux = tmoe.moe_ffn(t(x, bf), _tbf16(p), tcfg)
        want, waux = _rounded(lambda x, p: rmoe.moe_ffn(x, p, rcfg))(_bf16(x), _bf16(p))
        return ((got,) + tuple(gaux[k] for k in sorted(waux)),
                (want,) + tuple(waux[k] for k in sorted(waux)))
    if case.startswith("rwkv"):
        rcfg, tcfg = pair("rwkv6-7b")
        blocks = ref_params(rcfg)["blocks"]
        B, S, D = 2, 16, rcfg.d_model
        x = rng.standard_normal((B, S, D)).astype(np.float32)
        x_prev = rng.standard_normal((B, 1, D)).astype(np.float32)
        if case == "rwkv_channelmix":
            cm = _layer0(blocks["cm"])
            cm["mu_ck"] = rng.uniform(0, 1, D).astype(np.float32)
            got, _ = tssm.rwkv6_channelmix(t(x, bf), _tbf16(cm), tcfg, t(x_prev, bf))
            want, _ = _rounded(lambda *a: rssm.rwkv6_channelmix(*a[:2], rcfg, *a[2:]))(
                _bf16(x), _bf16(cm), _bf16(x_prev))
            return (got,), (want,)
        tm = _layer0(blocks["tm"])
        for k in tm:
            if k.startswith("mu_") or k in ("w0", "u"):
                tm[k] = rng.uniform(-0.5, 0.5, tm[k].shape).astype(np.float32)
        state = rng.standard_normal((B, rcfg.n_heads, rcfg.hd, rcfg.hd)).astype(np.float32)
        if case == "rwkv_decode":
            x = x[:, :1]
        tfn = tssm.rwkv6_decode if case == "rwkv_decode" else tssm.rwkv6_timemix
        rfn = rssm.rwkv6_decode if case == "rwkv_decode" else rssm.rwkv6_timemix
        got, (gs, _) = tfn(t(x, bf), _tbf16(tm), tcfg, t(state), t(x_prev, bf))
        want, (ws, _) = _rounded(lambda *a: rfn(*a[:2], rcfg, *a[2:]))(
            _bf16(x), _bf16(tm), jnp.asarray(state), _bf16(x_prev))
        return (got, gs), (want, ws)
    rcfg, tcfg = pair("jamba-v0.1-52b")   # mamba_mix, mamba_decode
    p = jax.tree.map(lambda a: np.asarray(a[0, 0]), ref_params(rcfg)["blocks"]["mamba"])
    p["A_log"] = rng.uniform(-1, 1, p["A_log"].shape).astype(np.float32)
    p["dt_bias"] = rng.uniform(-1, 1, p["dt_bias"].shape).astype(np.float32)
    B, S, D = 2, 8, rcfg.d_model
    Di = rcfg.ssm_expand * D
    x = rng.standard_normal((B, 1 if case == "mamba_decode" else S, D)).astype(np.float32)
    state = rng.standard_normal((B, Di, rcfg.d_state)).astype(np.float32)
    conv = rng.standard_normal((B, rcfg.conv_kernel - 1, Di)).astype(np.float32)
    tfn = tssm.mamba_decode if case == "mamba_decode" else tssm.mamba_mix
    rfn = rssm.mamba_decode if case == "mamba_decode" else rssm.mamba_mix
    got, (gs, gc) = tfn(t(x, bf), _tbf16(p), tcfg, t(state), t(conv, bf))
    want, (ws, wc) = _rounded(lambda *a: rfn(*a[:2], rcfg, *a[2:]))(
        _bf16(x), _bf16(p), jnp.asarray(state), _bf16(conv))
    return (got, gs, gc), (want, ws, wc)


@pytest.mark.parametrize("case", [
    "attention:smollm-135m", "attention:qwen3-32b", "decode_attention:whisper-small",
    "dense_ffn:smollm-135m", "dense_ffn:whisper-small", "moe:olmoe-1b-7b",
    "moe:llama4-scout-17b-a16e", "moe:jamba-v0.1-52b", "rwkv_timemix", "rwkv_decode",
    "rwkv_channelmix", "mamba_mix", "mamba_decode"])
def test_bf16_modules(case, xla_cpu_rounding):
    """Each module in bfloat16 against the reference's, rounding for
    rounding, on the same bfloat16 inputs and weights: outputs in the
    reference's dtypes, bf16 ones equal but for a few one-ulp roundings."""
    got, want = _bf16_module_case(case, np.random.default_rng(8))
    for i, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (case, i, g.dtype, w.dtype)
        _bits_close(g, w, f"{case} output {i}")


def _close_bf16(got, want, want32, what):
    """``got`` (port, bf16 path) within 2 max(d, 4u x scale) of ``want``
    (reference, bf16 path), d the reference's max |bf16 - float32|."""
    got = got.detach().float().numpy()
    want, want32 = np.asarray(want, np.float32), np.asarray(want32, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    d = float(np.abs(want - want32).max())
    tol = 2 * max(d, BF16_ATOL_SCALE * scale)
    diff = float(np.abs(got - want).max())
    assert diff <= tol, f"{what}: max |port - ref| {diff} > {tol} (d {d}, scale {scale})"


def _bf16_values(x):
    return torch.equal(x, x.to(torch.bfloat16).float())


def _bf16_run(name, ref_wrap, n_steps=4):
    """(port, reference) of one reduced config under the default bfloat16
    settings: prefill logits, then per teacher-forced decode step its
    logits and the bf16 cache after it; the reference jitted by
    ``ref_wrap`` and given the same converted weights and cache."""
    rcfg, tcfg = pair(name)
    rp = ref_params(rcfg)
    tp = port_params(rp)
    batch = _batch(rcfg, S=16)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    rst = R.ModelSettings(q_chunk=8, kv_chunk=8, remat="none")
    tst = T.ModelSettings(q_chunk=8, kv_chunk=8, remat="none")
    assert rst.compute_dtype == jnp.bfloat16 and tst.compute_dtype == torch.bfloat16
    want = [ref_wrap(lambda p, b: R.prefill(p, b["tokens"], rcfg, rst,
                                            enc_inputs=b.get("frames")))(rp, rb)]
    got = [T.prefill(tp, t(batch["tokens"]), tcfg, tst,
                     enc_inputs=t(batch["frames"]) if "frames" in batch else None)]
    B, S = 2, 12
    rc = jax.tree.map(lambda a, s: a.astype(s.dtype), _ref_cache(rcfg, B, S),
                      R.cache_spec(rcfg, B, S))
    tc = from_reference(jax.tree.map(np.asarray, rc), device="cpu")
    step = ref_wrap(lambda p, c, tok, pos: R.decode_step(p, c, tok, pos, rcfg, rst))
    for i in range(n_steps):
        tok = batch["tokens"][:, i:i + 1]
        wlog, rc = step(rp, rc, jnp.asarray(tok), jnp.int32(i))
        glog, tc = T.decode_step(tp, tc, t(tok), i, tcfg, tst)
        want.append((wlog, rc))
        got.append((glog, tree_map(torch.clone, tc)))   # the port writes the cache in place
    return got, want


def _close_bf16(got, want, want32, what):
    """``got`` (port, bf16 path) within 2 max(d, 4u x scale) of ``want``
    (reference, bf16 path), d the reference's max |bf16 - float32|."""
    got = got.detach().float().numpy()
    want, want32 = np.asarray(want, np.float32), np.asarray(want32, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    d = float(np.abs(want - want32).max())
    tol = 2 * max(d, BF16_ATOL_SCALE * scale)
    diff = float(np.abs(got - want).max())
    assert diff <= tol, f"{what}: max |port - ref| {diff} > {tol} (d {d}, scale {scale})"


def _bf16_values(x):
    return torch.equal(x, x.to(torch.bfloat16).float())


@pytest.mark.parametrize("name", NAMES)
def test_reduced_model_bf16(name):
    """The default settings' bfloat16 compute, as shipped, on every reduced
    config: prefill logits, four teacher-forced decode steps with a
    bfloat16 cache, and the cache after each, against the reference's
    jitted bf16 path on the same converted weights, within twice the
    reference's own bf16 error (module docstring)."""
    got, want = _bf16_run(name, jax.jit)
    # the reference's float32 path on the same weights, inputs and cache values
    rcfg, _ = pair(name)
    rp = ref_params(rcfg)
    batch = _batch(rcfg, S=16)
    rst32 = R.ModelSettings(q_chunk=8, kv_chunk=8, remat="none", compute_dtype=jnp.float32)
    want32 = jax.jit(lambda p, b: R.prefill(p, b["tokens"], rcfg, rst32,
                                            enc_inputs=b.get("frames")))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert got[0].dtype == torch.float32 and _bf16_values(got[0])
    _close_bf16(got[0], want[0], want32, "prefill")
    rc32 = _ref_cache(rcfg, 2, 12)
    step32 = jax.jit(lambda p, c, tok, pos: R.decode_step(p, c, tok, pos, rcfg, rst32))
    for i, ((glog, tc), (wlog, rc)) in enumerate(zip(got[1:], want[1:])):
        wlog32, rc32 = step32(rp, rc32, jnp.asarray(batch["tokens"][:, i:i + 1]), jnp.int32(i))
        assert glog.dtype == torch.float32 and _bf16_values(glog)
        _close_bf16(glog, wlog, wlog32, f"decode step {i}")
        for k in rc:
            assert str(tc[k].dtype).split(".")[-1] == str(rc[k].dtype), (k, tc[k].dtype)
            _close_bf16(tc[k], rc[k], rc32[k], f"cache {k} after step {i}")


@pytest.mark.parametrize("name", NAMES)
def test_reduced_model_bf16_rounding_for_rounding(name, xla_cpu_rounding):
    """The same runs with the reference's bf16 ops each rounded as written
    and the port's activations rounded as XLA's CPU backend lowers them:
    bf16 logits and caches equal but for a few one-ulp roundings, float32
    SSM states within the float32 tolerance."""
    got, want = _bf16_run(name, _rounded)
    _bits_close(got[0], want[0], "prefill", bf16=True)
    for i, ((glog, tc), (wlog, rc)) in enumerate(zip(got[1:], want[1:])):
        _bits_close(glog, wlog, f"decode step {i}", bf16=True)
        for k in rc:
            _bits_close(tc[k], rc[k], f"cache {k} after step {i}")


# ---------------------------------------------------------------------------
# parameter trees, counts and specs
# ---------------------------------------------------------------------------

def _shapes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, path + (k,)))
        return out
    return {"/".join(path): (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_and_counts(name):
    rcfg, tcfg = rconfigs.ARCHS[name], tconfigs.ARCHS[name]
    specs = T.param_specs(tcfg)
    assert all(leaf.device.type == "meta" for _, leaf in tree_leaves(specs))
    assert _shapes(specs) == _shapes(R.param_specs(rcfg))
    assert T.count_params(tcfg) == R.count_params(rcfg) == tcfg.param_count()
    assert (T.count_params(tcfg, active_only=True) == R.count_params(rcfg, active_only=True)
            == tcfg.active_param_count())
    small = tconfigs.reduced(tcfg)
    assert _shapes(T.cache_spec(small, 2, 8)) == _shapes(R.cache_spec(rconfigs.reduced(rcfg),
                                                                      2, 8))
    for shape in tconfigs.SHAPES:
        assert (_shapes(T.input_batch_specs(small, tconfigs.SHAPES[shape]))
                == _shapes(R.input_batch_specs(rconfigs.reduced(rcfg), rconfigs.SHAPES[shape])))


def test_init_params_kinds_and_scales():
    _, cfg = pair("jamba-v0.1-52b")
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(p) == _shapes(T.param_specs(cfg))
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))
    assert not p["blocks"]["mamba"]["dt_bias"].any()
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    w = p["blocks"]["attn"]["wq"]           # fan-in shape[-2] = d_model
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(p["blocks"]["mamba"]["conv_w"].std().item() - 0.5) < 0.05
    again = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(pa == pb and torch.equal(a, b)
               for (pa, a), (pb, b) in zip(tree_leaves(p), tree_leaves(again)))
    half = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.bfloat16)
    assert half["embed"].dtype == torch.bfloat16


def test_convert_round_trip_with_bfloat16():
    rcfg, _ = pair("smollm-135m")
    rp = R.init_params(rcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tp = from_reference(rp, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    back = to_reference(tp)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(rp)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16), b.view(np.uint16))


def test_language_model_module():
    rcfg, tcfg = pair("smollm-135m")
    m = LanguageModel(tcfg, TST, device="cpu", generator=torch.Generator().manual_seed(3))
    keys = set(m.state_dict())
    assert keys == {"params." + k.replace("/", ".") for k in _shapes(T.param_specs(tcfg))}
    rp = R.init_params(rcfg, jax.random.PRNGKey(0))

    def load(dst, src):
        for k, v in src.items():
            load(dst[k], v) if isinstance(v, dict) else dst[k].copy_(v)

    with torch.no_grad():
        load(m.tree(), port_params(rp))
    toks = _batch(rcfg)["tokens"]
    with torch.no_grad():
        close(m(t(toks)), R.prefill(rp, jnp.asarray(toks), rcfg, RST))
        cache = T.cache_spec(tcfg, 2, 4, dtype=torch.float32, mode="zeros", device="cpu")
        logits, _ = m.decode_step(cache, t(toks[:, :1]), 0)
    assert logits.shape == (2, 1, tcfg.vocab)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = pair("smollm-135m")
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        T.cache_spec(cfg, 2, 8, mode="zeros")
    with pytest.raises(RuntimeError, match="cuda"):
        from_reference({"a": np.zeros(2, np.float32)})
