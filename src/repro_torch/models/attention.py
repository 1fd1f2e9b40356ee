"""GQA attention: chunked streaming-softmax (flash-style) with a hand-written
backward (port of ``repro.models.attention``).

Plain torch ops in the reference's chunk structure.  Forward: an outer loop
over query chunks, an inner loop over KV chunks carrying the running (max,
denominator, accumulator), so no (S, S) score tensor is materialized.

Backward (the reference's custom VJP): a ``torch.autograd.Function`` whose
forward runs the chunk loops without taping them and saves only (q, k, v,
out, logsumexp); its backward recomputes each score block from the saved
logsumexp, chunk by chunk (the FlashAttention recipe).  Autograd through the
loops would keep every probability block alive for the backward.

Causal modes:
* ``impl="masked"``      — every q-chunk scans all kv chunks;
* ``impl="triangular"``  — q-chunk i scans only kv chunks [0..i] forward;
                           the backward scans all of them under the mask,
                           as the reference's does;
* ``impl="cp"``          — all q chunks at once, one loop over kv chunks
                           (the reference's context-parallel form, here on
                           one device).

The reference's mesh sharding constraints (``attn_shard``, ``shard_axes``)
are layout hints; on a mesh the port gathers the parameters at use and
computes a rank's rows whole (:mod:`repro_torch.train.step`), so they
change nothing here.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .common import einsum, rmsnorm, rope, score_block

__all__ = ["attention", "decode_attention", "flash_attention"]

NEG_INF = -1e30


def _divisor_chunk(chunk: int, S: int) -> int:
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def _mask_block(s, qi, ki, qc, kc, q_offset):
    qpos = q_offset + qi * qc + torch.arange(qc, device=s.device)
    kpos = ki * kc + torch.arange(kc, device=s.device)
    mask = kpos[None, :] <= qpos[:, None]
    return torch.where(mask[None, None, None], s, NEG_INF)


def _fwd_qchunk(qblk, kg, vg, qi, nk_hi, *, causal, qc, kc, q_offset, scale):
    """One q chunk over kv chunks [0..nk_hi). qblk (B,qc,Hkv,G,hd).
    Returns (out (B,qc,Hkv,G,hd) f32, lse (B,Hkv,G,qc) f32)."""
    B, _, Hkv, G, hd = qblk.shape
    dev = qblk.device
    m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, qc, hd), dtype=torch.float32, device=dev)
    for ki in range(nk_hi):
        kblk, vblk = kg[:, ki], vg[:, ki]
        with score_block():
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk).float() * scale
        if causal:
            s = _mask_block(s, qi, ki, qc, kc, q_offset)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pb = p.to(vblk.dtype)
        with score_block(pb):
            pv = torch.einsum("bhgqk,bkhd->bhgqd", pb, vblk).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4), lse  # (B,qc,Hkv,G,hd), (B,Hkv,G,qc)


def _cp_mask(s, nq, qc, kc, ki, q_offset):
    dev = s.device
    qpos = (q_offset + (torch.arange(nq, device=dev) * qc)[:, None]
            + torch.arange(qc, device=dev)[None, :])
    kpos = ki * kc + torch.arange(kc, device=dev)
    mask = kpos[None, None, :] <= qpos[:, :, None]          # (nq, qc, kc)
    return torch.where(mask[None, :, None, None, :, :], s, NEG_INF)


def _fwd_cp(qg, kg, vg, *, causal, qc, kc, q_offset, scale):
    """All q chunks vectorized (dim 1), one loop over kv chunks."""
    B, nq, _, Hkv, G, hd = qg.shape
    nk = kg.shape[1]
    dev = qg.device
    m = torch.full((B, nq, Hkv, G, qc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, nq, Hkv, G, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nq, Hkv, G, qc, hd), dtype=torch.float32, device=dev)
    for ki in range(nk):
        kblk, vblk = kg[:, ki], vg[:, ki]
        with score_block():
            s = torch.einsum("bnqhgd,bkhd->bnhgqk", qg, kblk).float() * scale
        if causal:
            s = _cp_mask(s, nq, qc, kc, ki, q_offset)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pb = p.to(vblk.dtype)
        with score_block(pb):
            pv = torch.einsum("bnhgqk,bkhd->bnhgqd", pb, vblk)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 1, 4, 2, 3, 5)                       # (B,nq,qc,Hkv,G,hd)
    return out, lse                                          # lse (B,nq,Hkv,G,qc)


def _chunks(q, k, q_chunk, kv_chunk):
    """(qc, kc, nq, nk, G, scale) of one call."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qc = _divisor_chunk(q_chunk, Sq)
    kc = _divisor_chunk(kv_chunk, Skv)
    return qc, kc, Sq // qc, Skv // kc, Hq // Hkv, hd ** -0.5


def _flash_fwd_impl(q, k, v, causal, q_chunk, kv_chunk, q_offset, impl):
    """(out (B,Sq,Hq,hd) in q's dtype, lse (B,nq,Hkv,G,qc) f32)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qc, kc, nq, nk, G, scale = _chunks(q, k, q_chunk, kv_chunk)
    qg = q.reshape(B, nq, qc, Hkv, G, hd)
    kg = k.reshape(B, nk, kc, Hkv, hd)
    vg = v.reshape(B, nk, kc, Hkv, hd)

    kw = dict(causal=causal, qc=qc, kc=kc, q_offset=q_offset, scale=scale)
    if impl == "cp":
        out, lse = _fwd_cp(qg, kg, vg, **kw)
        return out.reshape(B, Sq, Hq, hd).to(q.dtype), lse
    outs, lses = [], []
    for qi in range(nq):
        if impl == "triangular" and causal:
            hi = min(nk, -(-((qi + 1) * qc) // kc))
        else:
            hi = nk
        o, lse = _fwd_qchunk(qg[:, qi], kg, vg, qi, hi, **kw)
        outs.append(o)
        lses.append(lse)
    out = torch.stack(outs, 1)          # (B,nq,qc,Hkv,G,hd)
    lse = torch.stack(lses, 1)          # (B,nq,Hkv,G,qc)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype), lse


def _bwd_cp(q, k, v, out, lse, dout, *, causal, qc, kc, q_offset, scale):
    """All q chunks at once, one loop over kv chunks."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    nq, nk = Sq // qc, Skv // kc
    qg = q.reshape(B, nq, qc, Hkv, G, hd)
    dog = dout.reshape(B, nq, qc, Hkv, G, hd)
    kg = k.reshape(B, nk, kc, Hkv, hd)
    vg = v.reshape(B, nk, kc, Hkv, hd)
    Drow = (dout.float() * out.float()).sum(-1)
    Drow = Drow.reshape(B, nq, qc, Hkv, G).permute(0, 1, 3, 4, 2)
    dq = torch.zeros((B, nq, qc, Hkv, G, hd), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, nk, kc, Hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for ki in range(nk):
        kblk, vblk = kg[:, ki], vg[:, ki]
        with score_block():
            s = torch.einsum("bnqhgd,bkhd->bnhgqk", qg, kblk).float() * scale
        if causal:
            s = _cp_mask(s, nq, qc, kc, ki, q_offset)
        p = torch.exp(s - lse[..., None])
        pb = p.to(dog.dtype)
        with score_block(pb):
            dv[:, ki] = torch.einsum("bnhgqk,bnqhgd->bkhd", pb, dog).float()
        with score_block():
            dp = torch.einsum("bnqhgd,bkhd->bnhgqk", dog, vblk).float()
        ds = p * (dp - Drow[..., None])
        dsk, dsq = ds.to(kblk.dtype), ds.to(qg.dtype)
        with score_block(dsk):
            dq_c = torch.einsum("bnhgqk,bkhd->bnqhgd", dsk, kblk)
        with score_block(dsq):
            dk[:, ki] = torch.einsum("bnhgqk,bnqhgd->bkhd", dsq, qg).float() * scale
        dq = dq + dq_c.float() * scale
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.reshape(B, Skv, Hkv, hd).to(k.dtype),
            dv.reshape(B, Skv, Hkv, hd).to(v.dtype))


def _flash_bwd(q, k, v, out, lse, dout, causal, q_chunk, kv_chunk, q_offset, impl):
    """(dq, dk, dv) from the saved (q, k, v, out, lse): every score block
    recomputed from ``lse``; each q chunk scans every kv chunk."""
    qc, kc, nq, nk, G, scale = _chunks(q, k, q_chunk, kv_chunk)
    kw = dict(causal=causal, qc=qc, kc=kc, q_offset=q_offset, scale=scale)
    if impl == "cp":
        return _bwd_cp(q, k, v, out, lse, dout, **kw)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, nq, qc, Hkv, G, hd)
    kg = k.reshape(B, nk, kc, Hkv, hd)
    vg = v.reshape(B, nk, kc, Hkv, hd)
    dog = dout.reshape(B, nq, qc, Hkv, G, hd)
    # D_i = rowsum(dout * out) per query position
    Drow = (dout.float() * out.float()).sum(-1)
    Drow = Drow.reshape(B, nq, qc, Hkv, G).permute(0, 1, 3, 4, 2)  # (B,nq,Hkv,G,qc)
    dk = torch.zeros((B, nk, kc, Hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for qi in range(nq):
        qblk, doblk, lse_i, D_i = qg[:, qi], dog[:, qi], lse[:, qi], Drow[:, qi]
        dq_i = torch.zeros((B, qc, Hkv, G, hd), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            kblk, vblk = kg[:, ki], vg[:, ki]
            with score_block():
                s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk).float() * scale
            if causal:
                s = _mask_block(s, qi, ki, qc, kc, q_offset)
            p = torch.exp(s - lse_i[..., None])                    # (B,Hkv,G,qc,kc)
            pb = p.to(doblk.dtype)
            with score_block(pb):
                dv_j = torch.einsum("bhgqk,bqhgd->bkhd", pb, doblk)
            with score_block():
                dp = torch.einsum("bqhgd,bkhd->bhgqk", doblk, vblk).float()
            ds = p * (dp - D_i[..., None])
            dsk, dsq = ds.to(kblk.dtype), ds.to(qblk.dtype)
            with score_block(dsk):
                dq_c = torch.einsum("bhgqk,bkhd->bqhgd", dsk, kblk)
            with score_block(dsq):
                dk_j = torch.einsum("bhgqk,bqhgd->bkhd", dsq, qblk)
            dq_i = dq_i + dq_c.float() * scale
            dk[:, ki] += dk_j.float() * scale
            dv[:, ki] += dv_j.float()
        dqs.append(dq_i)
    dq = torch.stack(dqs, 1).reshape(B, Sq, Hq, hd)
    return (dq.to(q.dtype), dk.reshape(B, Skv, Hkv, hd).to(k.dtype),
            dv.reshape(B, Skv, Hkv, hd).to(v.dtype))


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the forward's chunk
    loops are not taped, the backward recomputes from (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, q_offset, impl):
        out, lse = _flash_fwd_impl(q, k, v, causal, q_chunk, kv_chunk, q_offset, impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.settings = (causal, q_chunk, kv_chunk, q_offset, impl)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout.contiguous(), *ctx.settings)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool, q_chunk: int = 256,
                    kv_chunk: int = 512, impl: str = "masked",
                    q_offset: int = 0, shard_axes=None):
    """q (B,Sq,Hq,hd); k,v (B,Skv,Hkv,hd); Hq = Hkv*G -> (B,Sq,Hq,hd).

    When a grad is needed it runs through the hand-written backward
    (:class:`_Flash`).  ``shard_axes`` (the reference's context-parallel
    mesh axes) is a layout hint there, a sharding constraint on the q-chunk
    grid; the port gathers the parameters at use and computes every chunk
    on the rank, so it changes nothing here."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, causal, q_chunk, kv_chunk, q_offset, impl)
    out, _ = _flash_fwd_impl(q, k, v, causal, q_chunk, kv_chunk, q_offset, impl)
    return out


def _project_qkv(x, p, cfg, positions, use_rope=True):
    B, S, D = x.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.einsum("bsd,dh->bsh", x, p["wq"])
    k = torch.einsum("bsd,dh->bsh", x, p["wk"])
    v = torch.einsum("bsd,dh->bsh", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, Hq, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qnorm"], cfg.norm_eps)
        k = rmsnorm(k, p["knorm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(x, p, cfg, *, causal=True, impl="masked", q_chunk=256,
              kv_chunk=512, attn_shard="auto", batch_axes=("data",),
              n_model=1):
    """Full-sequence attention (train/prefill). x: (B,S,D).

    ``attn_shard="cp"`` computes with the context-parallel impl, as the
    reference does on any mesh.  ``"replicate"`` and ``"heads"`` (and
    ``"cp"``'s ``shard_axes``) with ``n_model > 1`` are the reference's
    sharding constraints on q/k/v over ``batch_axes`` and "model": layout
    hints, which change no value.  The port gathers the parameters at use
    and computes a rank's rows whole, so they do nothing here."""
    B, S, D = x.shape
    use_rope = cfg.family != "encdec"
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(x, p, cfg, positions, use_rope)
    if attn_shard == "cp":
        impl = "cp"
    o = flash_attention(q, k, v, causal=causal, impl=impl,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
    return torch.einsum("bsh,hd->bsd", o.reshape(B, S, -1), p["wo"])


def decode_attention(x, p, cfg, cache, pos: int):
    """Single-token decode. x: (B,1,D); cache: dict(k,v) (B,S,Hkv,hd).

    The new KV is written into ``cache`` in place at ``pos``, clamped into
    [0, S-1] as ``lax.dynamic_update_slice_in_dim`` clamps it; attention
    masks positions > ``pos`` (unclamped).  Returns (out, cache)."""
    B, _, D = x.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = cache["k"].shape[1]
    use_rope = cfg.family != "encdec"
    positions = torch.full((B, 1), pos, device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, positions, use_rope)
    at = min(max(pos, 0), S - 1)
    k, v = cache["k"], cache["v"]
    k[:, at:at + 1] = k_new
    v[:, at:at + 1] = v_new
    G = Hq // Hkv
    qg = q.reshape(B, 1, Hkv, G, hd)
    with score_block():
        s = einsum("bqhgd,bkhd->bhgqk", qg, k).float() * hd ** -0.5
    mask = torch.arange(S, device=x.device)[None, None, None, None, :] <= pos
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    with score_block(w):
        o = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    out = einsum("bsh,hd->bsd", o.reshape(B, 1, Hq * hd), p["wo"])
    return out, {"k": k, "v": v}
