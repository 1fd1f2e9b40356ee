"""The port's fpzipx path against the JAX package, on the CPU, bit for bit.

fpzipx has no float arithmetic: a monotone float32 -> uint32 map, an
optional precision cut, and a wrapping 3D Lorenzo difference.  So the port
is held to the reference's delta stream and chunk bytes exactly, at every
precision, and its lossless round trip (precision 32) to the input's bits:
NaN payloads, signed zeros, subnormals, infinities and the float32
extremes included.  The port keeps the codes as int32 bit patterns; the
precision cut there is a mask, the reference's logical shift.

Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline
from repro.core import container as rcont
from repro.core import fpzipx as rfpz
from repro.core.schemes import get_scheme as rget_scheme

from repro_torch.core import container as tcont
from repro_torch.core import fpzipx as tfpz
from repro_torch.core.pipeline import CompressionSpec, Pipeline
from repro_torch.core.schemes import get_scheme

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 runs without hypothesis
    from _hypothesis_compat import given, settings, st

torch.set_num_threads(1)

FLT_MAX = np.finfo(np.float32).max
#: edge values of the lossless round trip: name -> float32 bit patterns
EDGES = {
    "nan_payloads": np.array([0x7FC12345, 0xFFC00001, 0x7F800001, 0x7FFFFFFF], np.uint32),
    "signed_zeros": np.array([0x00000000, 0x80000000], np.uint32),
    "subnormals": np.array([0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF, 0x000116C2],
                           np.uint32),
    "infinities": np.array([np.inf, -np.inf], np.float32).view(np.uint32),
    "extremes": np.array([FLT_MAX, -FLT_MAX, np.finfo(np.float32).tiny, 1.0],
                         np.float32).view(np.uint32),
}


def _blocks(b: int, n: int, seed: int, amp: float = 50.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-amp, amp, (b, n, n, n)).astype(np.float32)


def _with_edges(edges: np.ndarray, n: int = 8, seed: int = 1) -> np.ndarray:
    """Random blocks with the edge patterns scattered through them."""
    x = _blocks(3, n, seed)
    flat = x.reshape(-1).view(np.uint32)
    rng = np.random.default_rng(seed)
    at = rng.choice(flat.size, 16 * edges.size, replace=False)
    flat[at] = np.tile(edges, 16)
    return x


@pytest.mark.parametrize("precision", [32, 16, 8, 1])
def test_delta_stream_equals_reference(precision):
    x = _with_edges(np.concatenate(list(EDGES.values())))
    want = np.asarray(rfpz.encode(jnp.asarray(x), precision=precision))
    got = tfpz.encode(torch.from_numpy(x), precision=precision).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("precision", [32, 16, 8])
def test_chunk_bytes_equal_reference(precision, n):
    x = _blocks(6, n, seed=precision + n)
    x[1] *= 1e30
    x[2] *= 1e-39  # subnormal values
    kw = dict(scheme="fpzipx", precision=precision, block_size=n,
              buffer_bytes=2 * 4 * n ** 3)
    want = RPipeline(RSpec(**kw)).compress(x)
    got = Pipeline(CompressionSpec(**kw), device="cpu").compress(x)
    assert got.chunks == want.chunks
    assert got.header == want.header


@pytest.mark.parametrize("edge", list(EDGES))
def test_lossless_round_trip_is_bit_exact(edge):
    x = _with_edges(EDGES[edge])
    dec = tfpz.decode(tfpz.encode(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(dec.view(np.uint32), x.view(np.uint32))
    pipe = Pipeline(CompressionSpec(scheme="fpzipx", block_size=8), device="cpu")
    back = pipe.decompress(pipe.compress(x))
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))
    ref = np.asarray(rfpz.decode(rfpz.encode(jnp.asarray(x))))
    np.testing.assert_array_equal(ref.view(np.uint32), x.view(np.uint32))


def test_precision_cut_decodes_as_the_reference():
    x = _blocks(2, 8, seed=9)
    for p in (24, 16, 12):
        d = np.asarray(rfpz.encode(jnp.asarray(x), precision=p))
        want = np.asarray(rfpz.decode(jnp.asarray(d)))
        got = tfpz.decode(torch.from_numpy(d.view(np.int32).copy())).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_container_bytes_and_cross_decode(tmp_path):
    f = _blocks(1, 16, seed=4)[0]
    spec = dict(scheme="fpzipx", block_size=8, buffer_bytes=1 << 12)
    rcont.write_field(str(tmp_path / "r.cz"), f, RSpec(**spec))
    tcont.write_field(str(tmp_path / "t.cz"), f, CompressionSpec(**spec), device="cpu")
    assert (tmp_path / "t.cz").read_bytes() == (tmp_path / "r.cz").read_bytes()
    got = tcont.read_field(str(tmp_path / "r.cz"), device="cpu")
    np.testing.assert_array_equal(got.view(np.uint32), f.view(np.uint32))


def test_scheme_contract_equals_reference():
    t, r = get_scheme("fpzipx"), rget_scheme("fpzipx")
    for p in (32, 16):
        assert t.error_bound(CompressionSpec(scheme="fpzipx", precision=p)) == \
            r.error_bound(RSpec(scheme="fpzipx", precision=p))
        assert t.params(CompressionSpec(scheme="fpzipx", precision=p)) == \
            r.params(RSpec(scheme="fpzipx", precision=p))
    assert t.error_bound(CompressionSpec(scheme="fpzipx")) is None
    with pytest.raises(ValueError, match="float32 bit pattern"):
        CompressionSpec(scheme="fpzipx", dtype="float64").validate()
    with pytest.raises(ValueError, match="float32 bit pattern"):
        RSpec(scheme="fpzipx", dtype="float64").validate()


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), precision=st.integers(1, 32),
       n=st.sampled_from([1, 2, 3, 4, 5]))
def test_property_random_bit_patterns(seed, precision, n):
    bits = np.random.default_rng(seed).integers(0, 2 ** 32, (2, n, n, n), dtype=np.uint32)
    x = bits.view(np.float32)
    want = np.asarray(rfpz.encode(jnp.asarray(x), precision=precision))
    got = tfpz.encode(torch.from_numpy(x.copy()), precision=precision)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back = tfpz.decode(got).numpy().view(np.uint32)
    np.testing.assert_array_equal(back, np.asarray(rfpz.decode(jnp.asarray(want))).view(np.uint32))
    if precision == 32:
        np.testing.assert_array_equal(back, bits)
