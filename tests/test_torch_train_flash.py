"""The port's flash-attention backward (``repro_torch.models.attention``)
against ``jax.grad`` of the reference's ``flash_attention`` (its custom
VJP), and against autograd through the port's own chunk loops, on the CPU.

Inputs are numpy draws, float32.  Tolerance: rtol 1e-4 and atol 1e-5 times
the largest |grad| of each of dq, dk, dv (the port's float32 tolerance
against the reference, tests/test_torch_models.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as rattn

from repro_torch.models import attention as tattn

torch.set_num_threads(1)

RTOL, ATOL_SCALE = 1e-4, 1e-5

# (impl, causal, G, q_offset, S, q_chunk, kv_chunk); chunks that do not
# divide S shrink to the largest divisor below them, as in the reference
CASES = [
    ("masked", True, 1, 0, 24, 8, 16),
    ("masked", True, 2, 5, 30, 7, 9),
    ("masked", False, 2, 0, 24, 16, 8),
    ("masked", False, 1, 3, 21, 5, 7),
    ("triangular", True, 1, 0, 24, 8, 16),
    ("triangular", True, 2, 0, 30, 7, 9),
    ("triangular", True, 2, 4, 24, 8, 8),
    ("triangular", False, 2, 0, 24, 8, 16),
    ("cp", True, 1, 0, 24, 8, 16),
    ("cp", True, 2, 6, 30, 7, 9),
    ("cp", False, 2, 0, 24, 16, 8),
    ("cp", False, 1, 2, 21, 5, 7),
]
IDS = [f"{c[0]}-{'causal' if c[1] else 'full'}-G{c[2]}-off{c[3]}-S{c[4]}" for c in CASES]


def _inputs(G, S, seed):
    rng = np.random.default_rng(seed)
    B, Hkv, hd = 2, 2, 8
    q = rng.standard_normal((B, S, Hkv * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, Hkv * G, hd)).astype(np.float32)
    return q, k, v, do


def _close(got, want, what):
    got = got.detach().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_SCALE * scale, err_msg=what)


def _port_grads(fn, q, k, v, do):
    qt, kt, vt = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v))
    out = fn(qt, kt, vt)
    return out, torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_backward_matches_jax_grad(case):
    impl, causal, G, off, S, qc, kc = case
    q, k, v, do = _inputs(G, S, seed=S * 10 + G + off)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, impl=impl, q_offset=off)

    def f(q, k, v):
        return rattn.flash_attention(q, k, v, **kw)

    want_out, vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    out, got = _port_grads(lambda *a: tattn.flash_attention(*a, **kw), q, k, v, do)
    _close(out, np.asarray(want_out), "out")
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w, name)


# The reference's triangular forward scans kv chunks up to (qi + 1) * qc and
# ignores q_offset, while its backward takes every kv chunk under the mask:
# with q_offset > 0 its custom VJP is not the gradient of its forward.  The
# port copies both halves (test above), so that case is left out here.
CONSISTENT = [c for c in CASES if not (c[0] == "triangular" and c[1] and c[3] > 0)]


@pytest.mark.parametrize("case", CONSISTENT,
                         ids=[i for c, i in zip(CASES, IDS) if c in CONSISTENT])
def test_flash_backward_matches_autograd_through_the_loops(case):
    impl, causal, G, off, S, qc, kc = case
    q, k, v, do = _inputs(G, S, seed=S * 10 + G + off + 1)
    out, got = _port_grads(lambda *a: tattn.flash_attention(
        *a, causal=causal, q_chunk=qc, kv_chunk=kc, impl=impl, q_offset=off), q, k, v, do)
    ref, want = _port_grads(lambda *a: tattn._flash_fwd_impl(
        *a, causal, qc, kc, off, impl)[0], q, k, v, do)
    assert torch.equal(out, ref)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w.numpy(), name)


@pytest.mark.parametrize("impl", ["masked", "triangular", "cp"])
def test_flash_saves_only_q_k_v_out_lse(impl):
    """The Function saves (q, k, v, out, lse) and nothing else: the chunk
    loops are not taped."""
    q, k, v, _ = _inputs(2, 24, seed=7)
    qt, kt, vt = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v))
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tattn.flash_attention(qt, kt, vt, causal=True, q_chunk=8, kv_chunk=8, impl=impl)
    assert len(packed) == 5
    assert packed[0] is qt and packed[1] is kt and packed[2] is vt
    assert torch.equal(packed[3], out)
    nq = 1 if impl == "cp" else 3
    lse_shape = (2, 3, 2, 2, 8) if impl == "cp" else (2, nq, 2, 2, 8)
    assert tuple(packed[4].shape) == lse_shape and packed[4].dtype == torch.float32
    assert type(out.grad_fn).__name__ == "_FlashBackward"


def test_flash_without_grad_takes_the_plain_loops():
    q, k, v, _ = _inputs(1, 16, seed=3)
    qt, kt, vt = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v))
    with torch.no_grad():
        out = tattn.flash_attention(qt, kt, vt, causal=True, q_chunk=8, kv_chunk=8)
    assert out.grad_fn is None
    plain = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                                  q_chunk=8, kv_chunk=8)
    assert plain.grad_fn is None and torch.equal(out, plain)


def test_sharded_attention_still_raises_naming_the_mesh_item():
    """The reference's sharding hints (``shard_axes``; ``attn_shard``
    "heads"/"replicate" over a model axis) change no value, forward or
    backward: the port gathers at use and computes a rank's rows whole."""
    q, k, v, _ = _inputs(1, 16, seed=3)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.flash_attention(q, k, v, causal=True, shard_axes=("data", "model"))
    plain = tattn.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, plain)
    g = torch.autograd.grad(out.sum(), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(g, torch.autograd.grad(plain.sum(), (q, k, v))))
    import repro_torch.configs as tconfigs
    import repro_torch.models as T

    cfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")["blocks"]["attn"]
    p = {name: a[0] for name, a in p.items()}
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator().manual_seed(1))
    for shard in ("heads", "replicate"):
        assert torch.equal(tattn.attention(x, p, cfg, attn_shard=shard, n_model=2),
                           tattn.attention(x, p, cfg, attn_shard=shard))