"""Attention-free mixers: RWKV6 (Finch) time-mix and Mamba selective SSM
(port of ``repro.models.ssm``).

Both run in their *recurrent* form, a Python loop over time of torch ops
(the reference's ``lax.scan``) — exact for decode (one step) and for a
prompt.  RWKV6 also has the chunk-parallel (GLA-style) form.

RWKV6 time-mix (per head h, head dim d):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: d x d per head)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with data-dependent decay  w_t = exp(-exp(w0 + tanh(x_t W_a) W_b)).

Mamba (diagonal selective SSM):
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t h_t + D x_t
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import einsum, rmsnorm

__all__ = ["rwkv6_timemix", "rwkv6_timemix_chunked", "rwkv6_channelmix",
           "rwkv6_decode", "mamba_mix", "mamba_decode"]


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _token_shift(x, mu, x_prev=None):
    """lerp(x_t, x_{t-1}, mu); x (B,S,D). x_prev: (B,1,D) carry for decode."""
    if x_prev is None:
        prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    else:
        prev = x_prev
    return x + mu * (prev - x)


def _rwkv_proj(x, p, cfg, x_prev=None):
    H, hd = cfg.n_heads, cfg.hd
    r = einsum("bsd,de->bse", _token_shift(x, p["mu_r"], x_prev), p["wr"])
    k = einsum("bsd,de->bse", _token_shift(x, p["mu_k"], x_prev), p["wk"])
    v = einsum("bsd,de->bse", _token_shift(x, p["mu_v"], x_prev), p["wv"])
    g = F.silu(einsum("bsd,de->bse", _token_shift(x, p["mu_g"], x_prev), p["wg"]))
    xw = _token_shift(x, p["mu_w"], x_prev)
    dd = einsum("bsk,kd->bsd", torch.tanh(einsum("bsd,dk->bsk", xw, p["ww1"])), p["ww2"])
    logw = -torch.exp(torch.clamp(p["w0"] + dd, -8.0, 4.0).float())   # log decay < 0
    w = torch.exp(logw)                                                # (B,S,D) in (0,1)
    B_, S, D = x.shape
    shp = (B_, S, H, hd)
    return tuple(a.reshape(shp) for a in (r, k, v, w, g))


def _wkv_step(S, inputs):
    """S (B,H,dk,dv); r,k,v,w (B,H,d)."""
    r, k, v, w, u = inputs
    kv = k[..., :, None] * v[..., None, :]               # (B,H,dk,dv)
    out = einsum("bhk,bhkv->bhv", r, S + u[None, :, :, None] * kv)
    S_new = w[..., :, None] * S + kv
    return S_new, out


def _rwkv_out(o, g, p, cfg, x):
    """Per-head group norm, the gate, then the output projection."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    o = rmsnorm(o, p["gn"].reshape(H, hd), cfg.norm_eps)
    o = (o.reshape(B, S, D) * g.reshape(B, S, D)).to(x.dtype)
    return einsum("bsd,de->bse", o, p["wo"])


def rwkv6_timemix(x, p, cfg, state=None, x_prev=None):
    """x (B,S,D) -> (out, (new_state, new_x_prev)). State (B,H,hd,hd) f32;
    ``new_x_prev`` is the raw last input ``x[:, -1:]``."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    r, k, v, w, g = _rwkv_proj(x, p, cfg, x_prev)
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    u = p["u"].float()                                    # (H,hd) bonus
    r, k, v, w = (a.float() for a in (r, k, v, w))
    outs = []
    for t in range(S):
        state, out = _wkv_step(state, (r[:, t], k[:, t], v[:, t], w[:, t], u))
        outs.append(out)
    o = torch.stack(outs, 1)                              # (B,S,H,hd)
    return _rwkv_out(o, g, p, cfg, x), (state, x[:, -1:, :])


def rwkv6_timemix_chunked(x, p, cfg, state=None, x_prev=None, chunk: int = 16):
    """Chunk-parallel WKV (GLA-style), exactly the sequential recurrence up
    to float rounding.  Per chunk (all per-channel decays):

      l       = cumsum(log w)                 (inclusive), l_ex = l - log w
      A[t,s]  = sum_d r[t,d] k[s,d] exp(l_ex[t,d] - l[s,d])   for s < t
      A[t,t]  = (r_t * u) . k_t                               (bonus)
      out     = A @ v + (r * exp(l_ex)) @ S_in
      S_out   = exp(l_last) * S_in + (k * exp(l_last - l))^T @ v
    """
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    c = chunk
    assert S % c == 0, f"seq {S} % chunk {c} != 0"
    r, k, v, w, g = _rwkv_proj(x, p, cfg, x_prev)
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    u = p["u"].float()

    nc = S // c

    def to_chunks(a):  # (B,S,H,hd) -> (nc, B, H, c, hd) f32
        return a.reshape(B, nc, c, H, hd).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc = to_chunks(r), to_chunks(k), to_chunks(v)
    lw = torch.log(torch.clamp(to_chunks(w), min=1e-38))

    causal = torch.tril(torch.ones((c, c), dtype=torch.float32, device=x.device), -1)
    eye = torch.eye(c, dtype=torch.float32, device=x.device)
    outs = []
    for i in range(nc):
        r_, k_, v_, lw_ = rc[i], kc[i], vc[i], lw[i]              # (B,H,c,hd)
        l = torch.cumsum(lw_, dim=2)
        l_ex = l - lw_
        # the masked s >= t exponents are clamped so they cannot overflow to
        # inf (inf * 0 mask = NaN)
        E2 = torch.exp(torch.clamp(
            l_ex[:, :, :, None, :] - l[:, :, None, :, :], max=0.0))  # (B,H,t,s,d)
        A = einsum("bhtd,bhsd,bhtsd->bhts", r_, k_, E2)
        A = A * causal
        diag = einsum("bhtd,bhtd->bht", r_ * u[None, :, None, :], k_)
        A = A + diag[..., None] * eye
        out = einsum("bhts,bhsv->bhtv", A, v_)
        # inter-chunk: state contribution
        out = out + einsum("bhtd,bhdv->bhtv", r_ * torch.exp(l_ex), state)
        # state update
        l_last = l[:, :, -1:, :]                                  # (B,H,1,hd)
        kdec = k_ * torch.exp(l_last - l)
        state = (torch.exp(l_last[:, :, 0, :])[..., None] * state
                 + einsum("bhsd,bhsv->bhdv", kdec, v_))
        outs.append(out)
    o = torch.stack(outs, 0).permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)
    return _rwkv_out(o, g, p, cfg, x), (state, x[:, -1:, :])


def rwkv6_decode(x, p, cfg, state, x_prev):
    """Single-token decode: x (B,1,D)."""
    return rwkv6_timemix(x, p, cfg, state=state, x_prev=x_prev)


def rwkv6_channelmix(x, p, cfg, x_prev=None):
    xk = _token_shift(x, p["mu_ck"], x_prev)
    xr = _token_shift(x, p["mu_cr"], x_prev)
    r = torch.sigmoid(einsum("bsd,de->bse", xr, p["cr"]))
    k = einsum("bsd,df->bsf", xk, p["ck"])
    k = torch.square(torch.relu(k))
    return r * einsum("bsf,fd->bsd", k, p["cv"]), x[:, -1:, :]


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba_proj(x, p, cfg, conv_state=None):
    """Returns (conv'd activation u, gate z, dt, Bc, Cc, new_conv_state)."""
    B_, S, D = x.shape
    Di = cfg.ssm_expand * D
    K = cfg.conv_kernel
    xz = einsum("bsd,de->bse", x, p["in_proj"])          # (B,S,2Di)
    u, z = xz[..., :Di], xz[..., Di:]
    # causal depthwise conv along time
    if conv_state is None:
        pad = torch.zeros((B_, K - 1, Di), dtype=u.dtype, device=u.device)
    else:
        pad = conv_state
    uc = torch.cat([pad, u], dim=1)                      # (B,S+K-1,Di)
    new_conv_state = (uc[:, -(K - 1):, :] if K > 1
                      else torch.zeros((B_, 0, Di), dtype=u.dtype, device=u.device))
    conv = sum(uc[:, i: i + S, :] * p["conv_w"][:, i] for i in range(K))  # from 0
    u = F.silu(conv + p["conv_b"])
    bc = einsum("bse,en->bsn", u, p["x_bc"])             # (B,S,2*dstate)
    ds = cfg.d_state
    Bc, Cc = bc[..., :ds], bc[..., ds:]
    dt = einsum("bse,er->bsr", u, p["w_dt1"])
    dt = einsum("bsr,re->bse", dt, p["w_dt2"]) + p["dt_bias"]
    dt32 = dt.float()
    dt = torch.logaddexp(dt32, torch.zeros_like(dt32))  # jax.nn.softplus
    return u, z, dt, Bc, Cc, new_conv_state


def mamba_mix(x, p, cfg, state=None, conv_state=None):
    """x (B,S,D) -> (out, (ssm_state (B,Di,ds) f32, conv_state))."""
    B_, S, D = x.shape
    Di = cfg.ssm_expand * D
    ds = cfg.d_state
    u, z, dt, Bc, Cc, new_conv = _mamba_proj(x, p, cfg, conv_state)
    A = -torch.exp(p["A_log"].float())                   # (Di,ds) negative
    if state is None:
        state = torch.zeros((B_, Di, ds), dtype=torch.float32, device=x.device)
    h = state
    ys = []
    for t in range(S):
        u_, dt_, B_t, C_t = u[:, t], dt[:, t], Bc[:, t], Cc[:, t]  # (B,Di),(B,Di),(B,ds),(B,ds)
        a = torch.exp(dt_[..., None] * A[None])           # (B,Di,ds)
        bx = dt_[..., None] * B_t[:, None, :] * u_[..., None].float()
        h = a * h + bx
        ys.append(einsum("bdn,bn->bd", h, C_t.float()))
    y = torch.stack(ys, 1).to(x.dtype)                    # (B,S,Di)
    y = y + u * p["Dskip"]
    y = y * F.silu(z)
    out = einsum("bse,ed->bsd", y, p["out_proj"])
    return out, (h, new_conv)


def mamba_decode(x, p, cfg, state, conv_state):
    return mamba_mix(x, p, cfg, state=state, conv_state=conv_state)
