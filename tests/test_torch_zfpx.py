"""The port's zfpx path against the JAX package, on the CPU, bit for bit.

The reference is integer-exact (``repro/core/schemes/zfpx.py``), so the
port is held to its ``emax`` and ``q`` streams and to the bits of its
decoded field, edge cells included, through

* ``repro.core.zfpx.encode/decode`` (jit on the CPU), and
* the Pallas kernels in interpret mode (``repro.kernels.ops``), as the JAX
  package's own tests run them.

Both follow XLA's float semantics on the CPU: subnormals read and flush to
zero, float -> int32 saturates with NaN -> 0, and ``exp2`` of an integer is
``exp(k ln 2)``, not ``2^k``.  The edge cells below are where a port that
ignores them differs: a subnormal max, ``emax <= -100`` (an infinite
scale), ``emax = 128`` (clipped to int8 127 on write), an all-zero cell.

Inputs are made with numpy from a seed: uniform in [-50, 50], each block
scaled by a power of two, so cells span a range of exponents.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline
from repro.core import container as rcont
from repro.core import zfpx as rzfpx
from repro.core.schemes import get_scheme as rget_scheme
from repro.kernels import ops as rops

from repro_torch.core import container as tcont
from repro_torch.core import zfpx as tzfpx
from repro_torch.core.pipeline import CompressionSpec, Pipeline
from repro_torch.core.schemes import get_scheme
from repro_torch.kernels import ops as tops
from repro_torch.kernels import zfp_transform as tkern

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 runs without hypothesis
    from _hypothesis_compat import given, settings, st

# one intra-op thread: the suite runs in parallel worker processes, and
# oversubscribed CPU threads slow small torch ops by orders of magnitude
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SIDES = (4, 8, 12, 16, 32, 64)
EPSS = (1e-4, 1e-3, 1e-2)


def _blocks(b: int, n: int, seed: int, amp: float = 50.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.uniform(-amp, amp, (b, n, n, n))
    x *= np.exp2(rng.integers(-12, 12, (b, 1, 1, 1)))
    return x.astype(np.float32)


def _cell(b: int, i: int = 0):
    """Index of cell i along the first axis of block b."""
    return (b, slice(4 * i, 4 * i + 4), slice(0, 4), slice(0, 4))


#: edge cell -> (its values from u uniform in [-1, 1), the emax it must get)
EDGES = {
    # max below the smallest normal: XLA reads it as 0, so emax = -127
    "subnormal_max": (lambda u: u * np.float32(1e-39), -127),
    # emax <= -100: 2^(28 - emax) overflows to inf, q saturates, and zeros
    # and subnormals (read as 0) give 0 * inf -> NaN -> 0
    "emax_le_minus_100": (lambda u: np.select(
        [np.abs(u) < 0.15, np.abs(u) < 0.3], [0 * u, np.sign(u) * np.float32(1e-39)],
        u * np.float32(2.0 ** -101)), -101),
    # subnormals in a cell of emax -98: read as 0, not scaled by 2^126 to 1
    "subnormal_in_small_cell": (lambda u: np.where(
        np.abs(u) < 0.5, np.sign(u) * np.float32(1.1e-38), u * np.float32(2.0 ** -98)), -98),
    # |x| >= 2^127: emax = 128, which the scheme clips to int8 127
    "emax_128": (lambda u: u * np.float32(2.0 ** 127 * 1.9), 128),
    "all_zero": (lambda u: u * 0, -127),
}


def _with_edge(name: str, n: int, seed: int) -> np.ndarray:
    x = _blocks(2, n, seed)
    u = np.random.default_rng(seed + 1).uniform(-1, 1, (4, 4, 4)).astype(np.float32)
    x[_cell(1, 0)] = EDGES[name][0](u).astype(np.float32)
    return x


def _port(x: np.ndarray, eps: float):
    e, q = tops.zfpx_encode(torch.from_numpy(x), eps=eps)
    d = tops.zfpx_decode(e, q, eps=eps, n=x.shape[-1])
    return e.numpy(), q.numpy(), d.numpy()


def _assert_same_bits(got: np.ndarray, want: np.ndarray) -> None:
    """Equal values and equal float bits (signs of zero included)."""
    np.testing.assert_array_equal(got, want, strict=True)
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _check_against_reference(x: np.ndarray, eps: float, pallas: bool = True) -> None:
    n = x.shape[-1]
    e, q, d = _port(x, eps)
    e_ref, q_ref = map(np.asarray, rzfpx.encode(x, eps=eps))
    _assert_same_bits(e, e_ref)
    _assert_same_bits(q, q_ref)
    _assert_same_bits(d, np.asarray(rzfpx.decode(e_ref, q_ref, eps=eps, n=n)))
    if pallas:
        e_pl, q_pl = map(np.asarray, rops.zfpx_encode(x, eps=eps, interpret=True))
        _assert_same_bits(e, e_pl)
        _assert_same_bits(q, q_pl)
        d_pl = rops.zfpx_decode(e_pl, q_pl, eps=eps, n=n, interpret=True)
        _assert_same_bits(d, np.asarray(d_pl))


@pytest.mark.parametrize("eps", EPSS)
@pytest.mark.parametrize("n", SIDES)
def test_encode_decode_bit_exact(n, eps):
    _check_against_reference(_blocks(1 if n == 64 else 2, n, seed=n), eps)


@pytest.mark.parametrize("eps", (1e-3, 0.0))  # eps = 0 truncates no planes
@pytest.mark.parametrize("n", (4, 8))
@pytest.mark.parametrize("edge", list(EDGES))
def test_edge_cells_bit_exact(edge, n, eps):
    x = _with_edge(edge, n, seed=7)
    assert int(rzfpx.encode(x, eps=eps)[0][1, 0]) == EDGES[edge][1]
    _check_against_reference(x, eps=eps)


@settings(max_examples=15, deadline=None)
@given(b=st.integers(1, 3), n=st.sampled_from([4, 8, 12, 16, 20, 24]),
       eps=st.sampled_from([1e-6, 1e-4, 1e-3, 1e-2, 0.5]), seed=st.integers(0, 2**16),
       amp=st.sampled_from([1e-30, 1e-3, 1.0, 50.0, 1e6, 1e30]))
def test_parity_property(b, n, eps, seed, amp):
    """Only valid sides are drawn: the codec takes n % 4 == 0."""
    _check_against_reference(_blocks(b, n, seed, amp), eps, pallas=False)


def test_exp2_table_is_the_references_exp2():
    """The scale table holds XLA's float32 exp2 of every integer it can be
    asked for; outside the table the reference gives 0 and inf."""
    k = np.arange(-200, 201, dtype=np.int32)
    want = np.asarray(jax.jit(lambda k: jnp.exp2(k.astype(jnp.float32)))(k))
    got = tzfpx._exp2(torch.from_numpy(k)).numpy()
    _assert_same_bits(got, want)
    exact = np.ldexp(np.float64(1), k[(k >= -126) & (k <= 127)])
    assert (got[(k >= -126) & (k <= 127)] != exact.astype(np.float32)).sum() > 100


def test_sequency_perm_and_lifting_equal_reference():
    np.testing.assert_array_equal(tzfpx.sequency_perm(), rzfpx.sequency_perm(), strict=True)
    rng = np.random.default_rng(3)
    q = rng.integers(-(2 ** 31), 2 ** 31, (64, 4, 4, 4)).astype(np.int32)  # wraps too
    fwd = tzfpx.fwd_lift_cell(torch.from_numpy(q))
    _assert_same_bits(fwd.numpy(), np.asarray(rzfpx.fwd_lift_cell(jnp.asarray(q))))
    inv = tzfpx.inv_lift_cell(torch.from_numpy(q))
    _assert_same_bits(inv.numpy(), np.asarray(rzfpx.inv_lift_cell(jnp.asarray(q))))


def test_lift_unlift_round_trip_int32():
    """Near-lossless on the quantizer's range, as the reference's own test
    states it (tests/test_codecs.py)."""
    q = np.random.default_rng(4).integers(-(2 ** 27), 2 ** 27, (64, 4, 4, 4))
    q = torch.from_numpy(q.astype(np.int32))
    r = tzfpx.inv_lift_cell(tzfpx.fwd_lift_cell(q))
    assert r.dtype == torch.int32
    assert int((r - q).abs().max()) <= 32


# -- the scheme ---------------------------------------------------------------

def _field(n=32, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    f = 50 * np.sin(5 * g[0] + g[1]) * np.exp(-g[2]) + rng.standard_normal((n, n, n)) * 0.01
    return f.astype(np.float32)


SPECS = [dict(scheme="zfpx"),
         dict(scheme="zfpx", eps=1e-4, block_size=16, buffer_bytes=1 << 15),
         dict(scheme="zfpx", eps=1e-2, block_size=8, shuffle="bit", stage2="lzma",
              buffer_bytes=1 << 12)]
IDS = ["default", "eps1e-4-16", "eps1e-2-8-bit-lzma"]


@pytest.mark.parametrize("kw", SPECS, ids=IDS)
def test_scheme_round_trip_within_bound(kw):
    f = _field(seed=1)
    spec = CompressionSpec(**kw)
    pipe = Pipeline(spec, device="cpu")
    dec = pipe.decompress(pipe.compress(f))
    bound = get_scheme("zfpx").error_bound(spec)
    assert bound == 16 * spec.eps == rget_scheme("zfpx").error_bound(RSpec(**kw))
    assert dec.shape == f.shape and np.max(np.abs(dec - f)) <= bound


@pytest.mark.parametrize("kw", SPECS, ids=IDS)
def test_chunks_equal_reference(kw):
    f = _field(seed=2)
    want = RPipeline(RSpec(**kw)).compress(f)
    got = Pipeline(CompressionSpec(**kw), device="cpu").compress(f)
    assert json.dumps(got.header) == json.dumps(want.header)
    assert got.chunks == want.chunks


def test_serialize_clips_emax_128_as_the_reference():
    x = _with_edge("emax_128", 8, seed=9)
    spec = CompressionSpec(scheme="zfpx", block_size=8)
    s1 = get_scheme("zfpx").stage1(torch.from_numpy(x), spec)
    assert s1["emax"].max() == 128
    rs1 = rget_scheme("zfpx").stage1(x, RSpec(scheme="zfpx", block_size=8))
    payload = get_scheme("zfpx").serialize(s1, 0, 2, spec)
    assert payload == rget_scheme("zfpx").serialize(rs1, 0, 2, RSpec(scheme="zfpx",
                                                                      block_size=8))
    assert np.frombuffer(payload[:16], np.int8).max() == 127
    got = get_scheme("zfpx").deserialize(payload, 2, spec, torch.device("cpu"))
    want = rget_scheme("zfpx").deserialize(payload, 2, RSpec(scheme="zfpx", block_size=8))
    _assert_same_bits(got, np.asarray(want))


def test_port_file_is_byte_identical_and_cross_reads(tmp_path):
    f = _field(seed=3)
    spec = dict(scheme="zfpx", block_size=16, buffer_bytes=1 << 15)
    tpath, rpath = str(tmp_path / "t.cz"), str(tmp_path / "r.cz")
    tcont.write_field(tpath, f, CompressionSpec(**spec), device="cpu")
    rcont.write_field(rpath, f, RSpec(**spec))
    assert (tmp_path / "t.cz").read_bytes() == (tmp_path / "r.cz").read_bytes()
    # each package reads the other's file, to the same bits
    by_ref = rcont.read_field(tpath, device="host")
    by_port = tcont.read_field(rpath, device="cpu")
    _assert_same_bits(by_port, by_ref)
    assert np.max(np.abs(by_port - f)) <= 16 * 1e-3


def test_cz2_zfpx_fixture_decodes_bit_exact():
    dec = tcont.read_field(os.path.join(DATA, "cz2_zfpx.cz"), device="cpu")
    _assert_same_bits(dec, np.load(os.path.join(DATA, "cz2_zfpx.decoded.npy")))


# -- the wrappers ---------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,err,match", [
    ((2, 6, 6, 6), torch.float32, ValueError, "multiple of 4"),
    ((2, 8, 8, 4), torch.float32, ValueError, r"\(B, n, n, n\)"),
    ((2, 8, 8, 8), torch.float64, TypeError, "float32"),
    ((2, 64, 64, 64), torch.float32, ValueError, "CUDA"),  # n = 64 is taken
])
def test_encode_wrapper_refuses_what_the_kernel_does_not_take(shape, dtype, err, match):
    """Checked before anything reaches the card, so these run on ``meta``
    tensors here: the wrapper refuses them exactly as on a CUDA tensor."""
    with pytest.raises(err, match=match):
        tkern.zfpx_encode(torch.empty(shape, dtype=dtype, device="meta"))


@pytest.mark.parametrize("nc,n,dtype,err,match", [
    (8, 12, torch.int32, ValueError, "expected emax"),
    (8, 8, torch.int64, TypeError, "int32"),
    (8, 8, torch.int32, ValueError, "CUDA"),
])
def test_decode_wrapper_refuses_what_the_kernel_does_not_take(nc, n, dtype, err, match):
    emax = torch.empty((2, nc), dtype=dtype, device="meta")
    q = torch.empty((2, nc, 64), dtype=dtype, device="meta")
    with pytest.raises(err, match=match):
        tkern.zfpx_decode(emax, q, n=n)
