"""Model composition: layer stacks, LM loss, prefill and decode paths
(port of ``repro.models.transformer``).

One code path per *family* (dense/vlm, moe, ssm, hybrid, encdec), all built
from the same primitives.  Parameters are nested dicts of stacked leaves
(leading layer/period dim), key for key the reference's tree; the layer
scan is a Python loop over that leading dimension.  When a grad is needed,
``remat`` checkpoints each layer as the reference's ``jax.checkpoint``
policies do (:func:`_remat`).

Serving updates the decode cache in place: ``decode_step`` writes each
layer's new KV row and recurrent state into the cache's tensors and
returns them, as the reference's serve step does with a donated cache.
Each cache leaf keeps its dtype.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.schemes import torch_device

from . import ssm
from .attention import attention, decode_attention, flash_attention
from .common import (Maker, einsum, rmsnorm, score_block, sinusoidal_position_at,
                     sinusoidal_positions, tree_leaves, tree_map)
from .moe import dense_ffn, moe_ffn

__all__ = ["ModelSettings", "param_specs", "init_params", "lm_loss",
           "prefill", "decode_step", "cache_spec", "count_params", "LanguageModel"]


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    attn_impl: str = "masked"       # masked | triangular | cp
    q_chunk: int = 256
    kv_chunk: int = 512
    ce_chunk: int = 1024
    remat: str = "full"             # none | dots | full (only where a grad is needed)
    compute_dtype: Any = torch.bfloat16
    rwkv_chunk: int = 0             # 0 = sequential loop; >0 = chunked WKV
    attn_shard: str = "auto"        # auto | replicate | heads | cp
    # distribution-aware fields: the reference's sharding constraints over a
    # mesh, layout hints that change no value; the port gathers at use and
    # computes a rank's rows whole, so they do nothing here
    act_shard: str = "seq"          # none | seq | hidden — layer-boundary
    batch_axes: tuple = ("data",)   # mesh axes sharding the batch dim
    n_model: int = 1                # "model" axis size (1 = no constraint)
    n_batch: int = 1


# ---------------------------------------------------------------------------
# Parameter construction (spec/init dual mode via Maker)
# ---------------------------------------------------------------------------

def _attn_leaves(mk, cfg, lead=()):
    Hq, Hkv, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    p = {
        "wq": mk((*lead, D, Hq * hd)),
        "wk": mk((*lead, D, Hkv * hd)),
        "wv": mk((*lead, D, Hkv * hd)),
        "wo": mk((*lead, Hq * hd, D)),
    }
    if cfg.qkv_bias:
        p |= {"bq": mk((*lead, Hq * hd), "zeros"),
              "bk": mk((*lead, Hkv * hd), "zeros"),
              "bv": mk((*lead, Hkv * hd), "zeros")}
    if cfg.qk_norm:
        p |= {"qnorm": mk((*lead, hd), "ones"), "knorm": mk((*lead, hd), "ones")}
    return p


def _mlp_leaves(mk, cfg, lead=()):
    D, F = cfg.d_model, cfg.d_ff
    p = {"w1": mk((*lead, D, F)), "w2": mk((*lead, F, D))}
    if cfg.act == "swiglu":
        p["w3"] = mk((*lead, D, F))
    return p


def _moe_leaves(mk, cfg, lead=()):
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": mk((*lead, D, E)),
        "we1": mk((*lead, E, D, F)),
        "we2": mk((*lead, E, F, D)),
    }
    if cfg.act == "swiglu":
        p["we3"] = mk((*lead, E, D, F))
    if cfg.shared_expert:
        p |= {"ws1": mk((*lead, D, F)), "ws2": mk((*lead, F, D)),
              "ws3": mk((*lead, D, F))}
    return p


def _rwkv_leaves(mk, cfg, lead=()):
    D, H, hd, F = cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff
    lr = 64  # low-rank width of the data-dependent decay
    tm = {
        **{f"mu_{n}": mk((*lead, D), "zeros") for n in "rkvwg"},
        "wr": mk((*lead, D, D)), "wk": mk((*lead, D, D)), "wv": mk((*lead, D, D)),
        "wg": mk((*lead, D, D)), "wo": mk((*lead, D, D)),
        "ww1": mk((*lead, D, lr)), "ww2": mk((*lead, lr, D)),
        "w0": mk((*lead, D), "zeros"),
        "u": mk((*lead, H, hd), "zeros"),
        "gn": mk((*lead, D), "ones"),
    }
    cm = {
        "mu_ck": mk((*lead, D), "zeros"), "mu_cr": mk((*lead, D), "zeros"),
        "ck": mk((*lead, D, F)), "cv": mk((*lead, F, D)), "cr": mk((*lead, D, D)),
    }
    return {"tm": tm, "cm": cm}


def _mamba_leaves(mk, cfg, lead=()):
    D = cfg.d_model
    Di = cfg.ssm_expand * D
    ds, K = cfg.d_state, cfg.conv_kernel
    dtr = max(8, D // 16)
    return {
        "in_proj": mk((*lead, D, 2 * Di)),
        "conv_w": mk((*lead, Di, K), scale=0.5),
        "conv_b": mk((*lead, Di), "zeros"),
        "x_bc": mk((*lead, Di, 2 * ds)),
        "w_dt1": mk((*lead, Di, dtr)),
        "w_dt2": mk((*lead, dtr, Di)),
        "dt_bias": mk((*lead, Di), "zeros"),
        "A_log": mk((*lead, Di, ds), "zeros"),
        "Dskip": mk((*lead, Di), "ones"),
        "out_proj": mk((*lead, Di, D)),
    }


def _blocks_params(mk, cfg):
    L, D = cfg.n_layers, cfg.d_model
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return {"ln1": mk((L, D), "ones"), "ln2": mk((L, D), "ones"),
                "attn": _attn_leaves(mk, cfg, (L,)), "mlp": _mlp_leaves(mk, cfg, (L,))}
    if fam == "moe":
        return {"ln1": mk((L, D), "ones"), "ln2": mk((L, D), "ones"),
                "attn": _attn_leaves(mk, cfg, (L,)), "moe": _moe_leaves(mk, cfg, (L,))}
    if fam == "ssm":  # rwkv6
        return {"ln1": mk((L, D), "ones"), "ln2": mk((L, D), "ones"),
                **_rwkv_leaves(mk, cfg, (L,))}
    if fam == "hybrid":  # jamba periods
        P = cfg.n_layers // cfg.attn_period
        nm = cfg.attn_period - 1                    # mamba layers per period
        nf = cfg.attn_period // cfg.moe_period      # moe ffns per period
        nd = cfg.attn_period - nf                   # dense ffns per period
        return {
            "mamba_ln": mk((P, nm, D), "ones"),
            "mamba": _mamba_leaves(mk, cfg, (P, nm)),
            "attn_ln": mk((P, D), "ones"),
            "attn": _attn_leaves(mk, cfg, (P,)),
            "mlp_ln": mk((P, nd, D), "ones"),
            "mlp": _mlp_leaves(mk, cfg, (P, nd)),
            "moe_ln": mk((P, nf, D), "ones"),
            "moe": _moe_leaves(mk, cfg, (P, nf)),
        }
    if fam == "encdec":
        Le = cfg.encoder_layers
        enc = {"ln1": mk((Le, D), "ones"), "ln2": mk((Le, D), "ones"),
               "attn": _attn_leaves(mk, cfg, (Le,)), "mlp": _mlp_leaves(mk, cfg, (Le,))}
        dec = {"ln1": mk((L, D), "ones"), "lnx": mk((L, D), "ones"),
               "ln2": mk((L, D), "ones"),
               "attn": _attn_leaves(mk, cfg, (L,)),
               "xattn": _attn_leaves(mk, cfg, (L,)),
               "mlp": _mlp_leaves(mk, cfg, (L,))}
        return {"enc": enc, "dec": dec, "enc_norm": mk((D,), "ones")}
    raise ValueError(f"unknown family {fam}")


def _top_params(mk, cfg):
    D, V = cfg.d_model, cfg.vocab
    p = {"embed": mk((V, D), scale=0.02), "blocks": _blocks_params(mk, cfg),
         "final_norm": mk((D,), "ones")}
    if not cfg.tie_embeddings:
        p["lm_head"] = mk((D, V), scale=D ** -0.5)
    return p


def param_specs(cfg, dtype=torch.float32):
    """The parameter tree as ``meta`` tensors (shapes and dtypes only)."""
    return _top_params(Maker("spec", dtype=dtype), cfg)


def init_params(cfg, generator: torch.Generator, device=DEFAULT_DEVICE,
                dtype=torch.float32):
    """Random parameters on ``device``, drawn from ``generator``."""
    return _top_params(Maker("init", generator, dtype=dtype, device=torch_device(device)),
                       cfg)


def count_params(cfg, active_only: bool = False) -> int:
    total = 0
    for path, leaf in tree_leaves(param_specs(cfg)):
        n = 1
        for s in leaf.shape:
            n *= s
        if active_only and "/we" in "/".join(path):
            n = n * (cfg.top_k / cfg.n_experts)
        total += n
    return int(total)


def _layer(tree, i):
    """The i-th slice of every stacked leaf."""
    return tree_map(lambda a: a[i], tree)


def _n_stacked(tree) -> int:
    return next(tree_leaves(tree))[1].shape[0]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _zero_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance": z, "router_z": z, "drop_fraction": z}


def _ffn_or_moe(x, bp, cfg, moe_key="moe"):
    if moe_key in bp:
        return moe_ffn(x, bp[moe_key], cfg)
    return dense_ffn(x, bp["mlp"], cfg), _zero_aux(x.device)


def _attention(x, p, cfg, st, causal=True, impl=None):
    return attention(x, p, cfg, causal=causal, impl=impl or st.attn_impl,
                     q_chunk=st.q_chunk, kv_chunk=st.kv_chunk,
                     attn_shard=st.attn_shard, batch_axes=st.batch_axes,
                     n_model=st.n_model)


def _decoder_body(x, bp, cfg, st: ModelSettings):
    """One dense/moe decoder layer; returns (x, aux)."""
    x = x + _attention(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, st)
    y, aux = _ffn_or_moe(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp, cfg)
    return x + y, aux


def _rwkv_body(x, bp, cfg, st):
    xin = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if st.rwkv_chunk > 0 and x.shape[1] % st.rwkv_chunk == 0:
        h, _ = ssm.rwkv6_timemix_chunked(xin, bp["tm"], cfg, chunk=st.rwkv_chunk)
    else:
        h, _ = ssm.rwkv6_timemix(xin, bp["tm"], cfg)
    x = x + h
    y, _ = ssm.rwkv6_channelmix(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["cm"], cfg)
    return x + y, _zero_aux(x.device)


def _hybrid_period_body(x, bp, cfg, st):
    """One jamba period: attn_period sublayers (mamba x (p-1), attn x 1 at
    ``attn_period // 2``), the FFN MoE where ``i % moe_period == 1``.  With
    remat, each mamba mixer is also checkpointed on its own, as the
    reference does: its time loop keeps every step's values for the
    backward otherwise."""
    P_at = cfg.attn_period
    attn_pos = P_at // 2
    aux_acc = _zero_aux(x.device)
    mi = di = oi = 0

    def mamba_fn(xin, lp):
        return ssm.mamba_mix(xin, lp, cfg)[0]

    if st.remat != "none" and torch.is_grad_enabled():
        mamba_fn = functools.partial(checkpoint, mamba_fn, use_reentrant=False)
    for i in range(P_at):
        if i == attn_pos:
            h = _attention(rmsnorm(x, bp["attn_ln"], cfg.norm_eps), bp["attn"], cfg, st)
        else:
            h = mamba_fn(rmsnorm(x, bp["mamba_ln"][mi], cfg.norm_eps),
                         _layer(bp["mamba"], mi))
            mi += 1
        x = x + h
        if i % cfg.moe_period == 1:
            y, aux = moe_ffn(rmsnorm(x, bp["moe_ln"][oi], cfg.norm_eps),
                             _layer(bp["moe"], oi), cfg)
            aux_acc = {k: aux_acc[k] + aux[k] for k in aux_acc}
            oi += 1
        else:
            y = dense_ffn(rmsnorm(x, bp["mlp_ln"][di], cfg.norm_eps),
                          _layer(bp["mlp"], di), cfg)
            di += 1
        x = x + y
    return x, aux_acc


def _enc_body(x, bp, cfg, st):
    x = x + _attention(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, st,
                       causal=False, impl="masked")
    y = dense_ffn(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["mlp"], cfg)
    return x + y, _zero_aux(x.device)


def _cross_attention(x, enc_out, p, cfg, st):
    """Decoder cross-attention: q from x, k/v from encoder output."""
    B, S, D = x.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.einsum("bsd,dh->bsh", x, p["wq"]).reshape(B, S, Hq, hd)
    k = torch.einsum("bsd,dh->bsh", enc_out, p["wk"]).reshape(B, -1, Hkv, hd)
    v = torch.einsum("bsd,dh->bsh", enc_out, p["wv"]).reshape(B, -1, Hkv, hd)
    o = flash_attention(q, k, v, causal=False, q_chunk=st.q_chunk,
                        kv_chunk=st.kv_chunk)
    return torch.einsum("bsh,hd->bsd", o.reshape(B, S, -1), p["wo"])


def _dec_body(x, enc_out, bp, cfg, st):
    x = x + _attention(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, st)
    x = x + _cross_attention(rmsnorm(x, bp["lnx"], cfg.norm_eps), enc_out,
                             bp["xattn"], cfg, st)
    y = dense_ffn(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["mlp"], cfg)
    return x + y, _zero_aux(x.device)


#: the 2-D products that ``remat="dots"`` saves, the reading of JAX's
#: ``checkpoint_dots_with_no_batch_dims`` in aten ops; batched ones recompute
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, remat: str):
    """``body`` checkpointed per layer: ``"full"`` saves nothing of it,
    ``"dots"`` its 2-D products; ``"none"``, or no grad needed, runs it as
    it is."""
    if remat == "none" or not torch.is_grad_enabled():
        return body
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {remat!r}")


def _scan_blocks(x, blocks, body, st: ModelSettings):
    """Run ``body`` over the stacked layers, each checkpointed as
    ``st.remat`` says; the aux values are averaged over layers."""
    body = _remat(body, st.remat)
    auxs = []
    for i in range(_n_stacked(blocks)):
        x, aux = body(x, _layer(blocks, i))
        auxs.append(aux)
    return x, {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def _cast_blocks(blocks, dtype):
    return tree_map(lambda a: a.to(dtype), blocks)


def forward_hidden(params, tokens, cfg, st: ModelSettings, enc_inputs=None):
    """tokens (B,S) int -> (hidden (B,S,D), aux).  For encdec, enc_inputs
    is the stubbed frame-embedding tensor (B, frames, D)."""
    cdt = st.compute_dtype
    x = params["embed"][tokens.long()].to(cdt)
    dev = x.device
    fam = cfg.family
    if fam == "encdec":
        e = enc_inputs.to(cdt) + sinusoidal_positions(
            enc_inputs.shape[1], cfg.d_model, device=dev).to(cdt)
        e, _ = _scan_blocks(e, _cast_blocks(params["blocks"]["enc"], cdt),
                            lambda a, bp: _enc_body(a, bp, cfg, st), st)
        enc_out = rmsnorm(e, params["blocks"]["enc_norm"].to(cdt), cfg.norm_eps)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, device=dev).to(cdt)
        h, aux = _scan_blocks(x, _cast_blocks(params["blocks"]["dec"], cdt),
                              lambda a, bp: _dec_body(a, enc_out, bp, cfg, st), st)
    else:
        body = {
            "dense": _decoder_body, "vlm": _decoder_body, "moe": _decoder_body,
            "ssm": _rwkv_body, "hybrid": _hybrid_period_body,
        }[fam]
        h, aux = _scan_blocks(x, _cast_blocks(params["blocks"], cdt),
                              lambda a, bp: body(a, bp, cfg, st), st)
    return rmsnorm(h, params["final_norm"].to(cdt), cfg.norm_eps), aux


def _chunked_ce(h, labels, head, chunk):
    B, S, D = h.shape
    nc = max(1, S // chunk)
    c = S // nc
    hc = h.reshape(B, nc, c, D)
    lc = labels.long().reshape(B, nc, c)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        logits = torch.einsum("bsd,dv->bsv", hc[:, i], head).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[:, i][..., None])[..., 0]
        tot = tot + (lse - gold).sum()
    return tot / (B * S)


def _head(params, cfg, dtype):
    if cfg.tie_embeddings:
        return params["embed"].to(dtype).T
    return params["lm_head"].to(dtype)


def lm_loss(params, batch, cfg, st: ModelSettings = ModelSettings()):
    """batch: dict(tokens (B,S), labels (B,S) [, frames (B,F,D)]) ->
    (loss, {"ce", "load_balance", "router_z", "drop_fraction"}), 0-d
    tensors; differentiable in the parameters that require a grad."""
    h, aux = forward_hidden(params, batch["tokens"], cfg, st,
                            enc_inputs=batch.get("frames"))
    ce = _chunked_ce(h, batch["labels"], _head(params, cfg, st.compute_dtype),
                     st.ce_chunk)
    loss = ce + 0.01 * aux["load_balance"] + 0.001 * aux["router_z"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------

def cache_spec(cfg, batch: int, seq: int, dtype=torch.bfloat16, mode="spec",
               device=DEFAULT_DEVICE):
    """Decode-state tree for one serve step: ``meta`` tensors (``"spec"``)
    or zeros on ``device`` (``"zeros"``).  SSM states are always float32."""
    if mode == "spec":
        def mk(shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device="meta")
    else:
        dev = torch_device(device)

        def mk(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)
    L, D = cfg.n_layers, cfg.d_model
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return {"k": mk((L, batch, seq, Hkv, hd)), "v": mk((L, batch, seq, Hkv, hd))}
    if fam == "ssm":
        return {"wkv": mk((L, batch, cfg.n_heads, hd, hd), torch.float32),
                "x_tm": mk((L, batch, 1, D)), "x_cm": mk((L, batch, 1, D))}
    if fam == "hybrid":
        P = cfg.n_layers // cfg.attn_period
        nm = cfg.attn_period - 1
        Di = cfg.ssm_expand * D
        return {
            "ssm": mk((P, nm, batch, Di, cfg.d_state), torch.float32),
            "conv": mk((P, nm, batch, cfg.conv_kernel - 1, Di)),
            "k": mk((P, batch, seq, Hkv, hd)), "v": mk((P, batch, seq, Hkv, hd)),
        }
    if fam == "encdec":
        F = cfg.enc_frames
        return {"k": mk((L, batch, seq, Hkv, hd)), "v": mk((L, batch, seq, Hkv, hd)),
                "xk": mk((L, batch, F, Hkv, hd)), "xv": mk((L, batch, F, Hkv, hd))}
    raise ValueError(fam)


def _kv(cache, i):
    return {"k": cache["k"][i], "v": cache["v"][i]}


def _decode_dense(x, blocks, cfg, cache, pos):
    for i in range(_n_stacked(blocks)):
        bp = _layer(blocks, i)
        h, _ = decode_attention(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"],
                                cfg, _kv(cache, i), pos)
        x = x + h
        y, _ = _ffn_or_moe(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp, cfg)
        x = x + y
    return x


def _decode_rwkv(x, blocks, cfg, cache):
    for i in range(_n_stacked(blocks)):
        bp = _layer(blocks, i)
        h, (s2, xtm2) = ssm.rwkv6_decode(rmsnorm(x, bp["ln1"], cfg.norm_eps),
                                         bp["tm"], cfg, cache["wkv"][i], cache["x_tm"][i])
        x = x + h
        y, xcm2 = ssm.rwkv6_channelmix(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["cm"],
                                       cfg, cache["x_cm"][i])
        x = x + y
        cache["wkv"][i].copy_(s2)
        cache["x_tm"][i].copy_(xtm2)
        cache["x_cm"][i].copy_(xcm2)
    return x


def _decode_hybrid(x, blocks, cfg, cache, pos):
    P_at = cfg.attn_period
    attn_pos = P_at // 2
    for pi in range(_n_stacked(blocks)):
        bp = _layer(blocks, pi)
        mi = di = oi = 0
        for i in range(P_at):
            if i == attn_pos:
                h, _ = decode_attention(rmsnorm(x, bp["attn_ln"], cfg.norm_eps),
                                        bp["attn"], cfg, _kv(cache, pi), pos)
            else:
                sst, cst = cache["ssm"][pi, mi], cache["conv"][pi, mi]
                h, (s2, c2) = ssm.mamba_decode(rmsnorm(x, bp["mamba_ln"][mi], cfg.norm_eps),
                                               _layer(bp["mamba"], mi), cfg, sst, cst)
                sst.copy_(s2)
                cst.copy_(c2)
                mi += 1
            x = x + h
            if i % cfg.moe_period == 1:
                y, _ = moe_ffn(rmsnorm(x, bp["moe_ln"][oi], cfg.norm_eps),
                               _layer(bp["moe"], oi), cfg)
                oi += 1
            else:
                y = dense_ffn(rmsnorm(x, bp["mlp_ln"][di], cfg.norm_eps),
                              _layer(bp["mlp"], di), cfg)
                di += 1
            x = x + y
    return x


def _decode_encdec(x, blocks, cfg, cache, pos):
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B = x.shape[0]
    G = Hq // Hkv
    for i in range(_n_stacked(blocks)):
        bp = _layer(blocks, i)
        h, _ = decode_attention(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"],
                                cfg, _kv(cache, i), pos)
        x = x + h
        # cross-attention against precomputed encoder KV
        xk, xv = cache["xk"][i], cache["xv"][i]
        xq = torch.einsum("bsd,dh->bsh", rmsnorm(x, bp["lnx"], cfg.norm_eps),
                          bp["xattn"]["wq"]).reshape(B, 1, Hq, hd)
        qg = xq.reshape(B, 1, Hkv, G, hd)
        with score_block():
            s = einsum("bqhgd,bkhd->bhgqk", qg, xk).float() * hd ** -0.5
        w = torch.softmax(s, dim=-1).to(xv.dtype)
        with score_block(w):
            o = torch.einsum("bhgqk,bkhd->bqhgd", w, xv)
        x = x + einsum("bsh,hd->bsd", o.reshape(B, 1, Hq * hd), bp["xattn"]["wo"])
        y = dense_ffn(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["mlp"], cfg)
        x = x + y
    return x


def decode_step(params, cache, token, pos, cfg, st: ModelSettings = ModelSettings()):
    """token (B,1) int, pos int -> (logits (B,1,V) f32, cache).  The cache's
    tensors are updated in place and returned."""
    pos = int(pos)
    cdt = st.compute_dtype
    x = params["embed"][token.long()].to(cdt)
    fam = cfg.family
    blocks = _cast_blocks(params["blocks"] if fam != "encdec"
                          else params["blocks"]["dec"], cdt)
    if fam in ("dense", "vlm", "moe"):
        x = _decode_dense(x, blocks, cfg, cache, pos)
    elif fam == "ssm":
        x = _decode_rwkv(x, blocks, cfg, cache)   # positions implicit in recurrence
    elif fam == "hybrid":
        x = _decode_hybrid(x, blocks, cfg, cache, pos)
    elif fam == "encdec":
        x = x + sinusoidal_position_at(pos, cfg.d_model, device=x.device).to(cdt)
        x = _decode_encdec(x, blocks, cfg, cache, pos)
    else:
        raise ValueError(fam)
    h = rmsnorm(x, params["final_norm"].to(cdt), cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, _head(params, cfg, cdt))
    return logits.float(), cache


def prefill(params, tokens, cfg, st: ModelSettings = ModelSettings(),
            enc_inputs=None):
    """Forward over the prompt; returns the last position's logits (B, V)."""
    h, _ = forward_hidden(params, tokens, cfg, st, enc_inputs=enc_inputs)
    logits = torch.einsum("bd,dv->bv", h[:, -1], _head(params, cfg, st.compute_dtype))
    return logits.float()


# ---------------------------------------------------------------------------
# nn.Module front
# ---------------------------------------------------------------------------

class _ParamTree(nn.Module):
    """A nested dict of tensors as submodules and parameters, key for key."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _ParamTree(v, trainable))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=trainable))

    def tree(self) -> dict:
        out = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


class LanguageModel(nn.Module):
    """The parameter tree of ``cfg`` as an ``nn.Module`` (``state_dict`` keys
    are the tree's paths joined by dots), over the functions above.  The
    parameters require a grad only with ``trainable=True``: serving runs
    without one."""

    def __init__(self, cfg, settings: ModelSettings = ModelSettings(),
                 device=DEFAULT_DEVICE, generator: torch.Generator | None = None,
                 dtype=torch.float32, trainable: bool = False):
        super().__init__()
        dev = torch_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg, self.settings = cfg, settings
        self.params = _ParamTree(init_params(cfg, generator, device=dev, dtype=dtype),
                                 trainable)

    def tree(self) -> dict:
        """The parameters as the nested dict the functions take."""
        return self.params.tree()

    def forward(self, tokens, frames=None):
        """Last-position logits of the prompt (``prefill``)."""
        return prefill(self.tree(), tokens, self.cfg, self.settings, enc_inputs=frames)

    def loss(self, batch):
        return lm_loss(self.tree(), batch, self.cfg, self.settings)

    def decode_step(self, cache, token, pos):
        return decode_step(self.tree(), cache, token, pos, self.cfg, self.settings)
