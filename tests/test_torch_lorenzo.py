"""The port's lorenzo and szx paths against the JAX package, on the CPU, bit
for bit.

The reference's residuals are integer-exact (``repro/core/szx.py``), so the
port is held to its int32 residuals and to the bits of its decoded field,
through

* ``repro.core.szx.encode/decode`` (jit on the CPU), and
* the Pallas kernels in interpret mode (``repro.kernels.ops``), as the JAX
  package's own tests run them.

Both follow XLA's float semantics on the CPU.  Each ``test_trap_*`` below
pins one place where a port that ignores them differs, and shows on the
same input that the naive computation does differ from the reference:
the compensation ``x - q * 2eps`` is one FMA; the correction is added in
float32, which rounds past |q| = 2^24; rounding is half to even; NaN
quantizes to 0; subnormal inputs, products and results flush to zero.

Inputs are made with numpy from a seed.  The round trip is held to the
reference's own bound, ``eps * (1 + 1e-4) + spacing(max|x|)``
(``tests/test_kernels.py``): past |q| = 2^24 float32 cannot keep a bare
``eps``.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline
from repro.core import container as rcont
from repro.core import szx as rszx
from repro.core.schemes import get_scheme as rget_scheme
from repro.kernels import ops as rops

from repro_torch.core import container as tcont
from repro_torch.core import szx as tszx
from repro_torch.core.pipeline import CompressionSpec, Pipeline
from repro_torch.core.schemes import get_scheme
from repro_torch.kernels import lorenzo as tkern
from repro_torch.kernels import ops as tops
from repro_torch.launch import lorenzo_decode_designs as designs

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 runs without hypothesis
    from _hypothesis_compat import given, settings, st

# one intra-op thread: the suite runs in parallel worker processes, and
# oversubscribed CPU threads slow small torch ops by orders of magnitude
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SIDES = (4, 6, 8, 10, 12, 16, 20, 32)
EPSS = (1e-4, 1e-3, 1e-1, 2e-7)     # 2e-7 at amplitude 50: |q| > 2^24
AMPS = (50.0, 1e3, 3e4)


def _blocks(b: int, n: int, seed: int, amp: float = 50.0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-amp, amp, (b, n, n, n)).astype(np.float32)


def _fits(amp: float, eps: float) -> bool:
    """Whether ``check_eps`` takes data of this amplitude at this eps."""
    return amp / (2 * eps) < 2 ** 27


def _bound(x: np.ndarray, eps: float) -> float:
    return eps * (1 + 1e-4) + float(np.spacing(np.float32(np.max(np.abs(x)))))


def _assert_same_bits(got: np.ndarray, want: np.ndarray) -> None:
    """Equal values and equal float bits (signs of zero included)."""
    np.testing.assert_array_equal(got, want, strict=True)
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _port(x: np.ndarray, eps: float) -> tuple[np.ndarray, np.ndarray]:
    r = tops.lorenzo_encode(torch.from_numpy(x), eps=eps)
    return r.numpy(), tops.lorenzo_decode(r, eps=eps).numpy()


def _reference(x: np.ndarray, eps: float, pallas: bool = True):
    """The reference's residuals and decoded field: jit, and the Pallas
    kernels in interpret mode, which must agree with each other."""
    r = np.asarray(rszx.encode(x, eps=eps))
    d = np.asarray(rszx.decode(r, eps=eps))
    if pallas:
        _assert_same_bits(np.asarray(rops.lorenzo_encode(x, eps=eps, interpret=True)), r)
        _assert_same_bits(np.asarray(rops.lorenzo_decode(r, eps=eps, interpret=True)), d)
    return r, d


def _check_against_reference(x: np.ndarray, eps: float, pallas: bool = True):
    r, d = _port(x, eps)
    r_ref, d_ref = _reference(x, eps, pallas)
    _assert_same_bits(r, r_ref)
    _assert_same_bits(d, d_ref)
    return r, d


@pytest.mark.parametrize("eps", EPSS)
@pytest.mark.parametrize("n", SIDES)
def test_encode_decode_bit_exact(n, eps):
    """Every side, odd ones too, at every amplitude the quantizer takes."""
    for amp in AMPS:
        if not _fits(amp, eps):
            continue
        x = _blocks(1 if n == 32 else 2, n, seed=n, amp=amp)
        _, d = _check_against_reference(x, eps)
        assert np.max(np.abs(d - x)) <= _bound(x, eps)


@settings(max_examples=15, deadline=None)
@given(b=st.integers(1, 4), n=st.sampled_from([1, 2, 3, 4, 6, 8, 10, 12, 16]),
       eps=st.sampled_from([1e-4, 1e-3, 1e-1, 2e-7]), seed=st.integers(0, 2**16),
       scale=st.floats(1e-2, 1e3))
def test_parity_property(b, n, eps, seed, scale):
    """As ``tests/test_kernels.py::test_lorenzo_parity_property``, against
    the jit reference, with every scale capped to what ``check_eps`` takes."""
    scale = min(scale, 0.99 * 2 ** 27 * 2 * eps)
    x = _blocks(b, n, seed, scale)
    _, d = _check_against_reference(x, eps, pallas=False)
    assert float(np.max(np.abs(d - x))) <= _bound(x, eps)


# -- the traps: where XLA's semantics differ from a naive port ------------------

def _naive_q(x: np.ndarray, eps: float, *, fma=True, float_add=True, even=True,
             nan_to_zero=True, flush=True) -> np.ndarray:
    """The quantizer in torch with one of the reference's semantics switched
    off; with all of them on, it is the reference's quantizer."""
    x = torch.from_numpy(x)
    inv, two = tszx.grid(eps)
    if flush:
        x = torch.where(x.abs() < 2.0 ** -126, x * 0.0, x)
    else:
        two = float(np.float32(2.0 * eps))  # a subnormal 2 eps kept
    rnd = torch.round if even else (lambda v: torch.floor(v + 0.5))  # half up
    q = rnd(x * inv)
    err = (x.double() - q.double() * two).float() if fma else x - q * two
    c = rnd(err * inv)
    if not float_add:
        return (q.to(torch.int32) + c.to(torch.int32)).numpy()
    s = q + c
    if nan_to_zero:
        s = torch.nan_to_num(s, nan=0.0)
    return s.to(torch.int32).numpy()


def _q_of(r: np.ndarray) -> np.ndarray:
    """The quantized values behind residuals (the reference's inverse)."""
    return np.asarray(rszx.lorenzo_inv(r))


def test_trap_fused_compensation():
    """``err = x - q * 2eps`` is rounded once (XLA's FMA): a float32
    multiply, then subtract, gives other q at amplitude 3e4."""
    x, eps = _blocks(2, 8, seed=1, amp=3e4), 1e-3
    r, _ = _check_against_reference(x, eps)
    assert (_naive_q(x, eps, fma=False) != _q_of(r)).sum() > 0
    np.testing.assert_array_equal(_naive_q(x, eps), _q_of(r))


def test_trap_float32_add_past_2_24():
    """At eps 2e-7 and amplitude 50, |q| reaches 1.25e8 > 2^24: the
    correction is added in float32, which rounds; an int32 add differs."""
    x, eps = _blocks(2, 8, seed=2, amp=50.0), 2e-7
    r, d = _check_against_reference(x, eps)
    assert np.abs(_q_of(r)).max() > 2 ** 24
    assert (_naive_q(x, eps, float_add=False) != _q_of(r)).sum() > 0
    assert np.max(np.abs(d - x)) <= _bound(x, eps)


def test_trap_exact_halves_round_to_even():
    """x on the half-grid, (k + 1/2) * 2eps exactly: half to even, as
    ``jnp.round``; rounding half away from zero differs."""
    k = np.random.default_rng(3).integers(-1000, 1000, (2, 6, 6, 6))
    x, eps = (k + 0.5).astype(np.float32), 0.5
    r, _ = _check_against_reference(x, eps)
    assert (_q_of(r) % 2 == 0).all()
    assert (_naive_q(x, eps, even=False) != _q_of(r)).sum() > 0


def test_trap_nan_quantizes_to_zero():
    """NaN gets past ``check_eps`` and quantizes to q = 0 (XLA's convert);
    torch's CPU cast would give -2^31."""
    x, eps = _blocks(2, 6, seed=4), 1e-3
    x[0, 1, 2, 3] = x[1, 5, 5, 5] = np.nan
    rget_scheme("lorenzo").stage1(x, RSpec(scheme="lorenzo"))  # no ValueError
    get_scheme("lorenzo").stage1(torch.from_numpy(x), CompressionSpec(scheme="lorenzo"))
    r, _ = _check_against_reference(x, eps)
    assert _q_of(r)[0, 1, 2, 3] == _q_of(r)[1, 5, 5, 5] == 0
    assert _naive_q(x, eps, nan_to_zero=False)[0, 1, 2, 3] == -2 ** 31


@pytest.mark.parametrize("eps", (1e-40, 5e-39))
def test_trap_subnormal_inputs(eps):
    """Subnormal inputs with a subnormal 2 eps: XLA reads both as 0, so the
    reference decodes to exact zeros.  At eps 1e-40, 1/(2 eps) is inf and
    every q is NaN -> 0; at 5e-39 it is finite, and unflushed inputs would
    give q = +-1."""
    x = (np.random.default_rng(5).uniform(-1, 1, (2, 6, 6, 6)) * 1.1e-38).astype(np.float32)
    with warnings.catch_warnings():  # JAX's own overflow of 1/(2 eps) to inf
        warnings.simplefilter("ignore", RuntimeWarning)
        r, d = _check_against_reference(x, eps)
    assert not r.any() and not d.any()
    assert (_naive_q(x, eps, flush=False, nan_to_zero=False) != 0).any()


@pytest.mark.parametrize("eps", (5e-39, 1e-42))
def test_trap_subnormal_decode_products(eps):
    """``float(q) * 2eps`` below 2^-126: 2 eps is subnormal, read as 0, so
    the product is a zero of q's sign, never a subnormal."""
    r = np.random.default_rng(6).integers(-3, 4, (2, 6, 6, 6)).astype(np.int32)
    d = tops.lorenzo_decode(torch.from_numpy(r), eps=eps).numpy()
    want = np.asarray(rszx.decode(r, eps=eps))
    _assert_same_bits(d, want)
    _assert_same_bits(np.asarray(rops.lorenzo_decode(r, eps=eps, interpret=True)), want)
    q = _q_of(r)
    assert not d.any() and (np.signbit(d) == (q < 0)).all()
    naive = q.astype(np.float32) * np.float32(2.0 * eps)
    assert (naive != 0).any()


def test_lorenzo_fwd_inv_identity_wrapping():
    """Exact on all of int32, wrapping included, and equal to the
    reference's differences and prefix sums."""
    q = np.random.default_rng(7).integers(-(2 ** 31), 2 ** 31, (3, 5, 5, 5)).astype(np.int32)
    fwd = tszx.lorenzo_fwd(torch.from_numpy(q))
    _assert_same_bits(fwd.numpy(), np.asarray(rszx.lorenzo_fwd(q)))
    _assert_same_bits(tszx.lorenzo_inv(fwd).numpy(), q)
    inv = tszx.lorenzo_inv(torch.from_numpy(q))
    _assert_same_bits(inv.numpy(), np.asarray(rszx.lorenzo_inv(q)))


@pytest.mark.parametrize("source", ["int32", "encode"])
@pytest.mark.parametrize("n", [64, 128])
def test_decode_bit_exact_where_the_card_designs_split(n, source):
    """On the card the decode is a cluster kernel up to n = 64 and a staged
    path above: at 64 and 128 the plain decode, the kernels' oracle, equals
    the Pallas kernel in interpret mode bit for bit, on residuals over all
    of int32 and on the residuals of an encode."""
    if source == "int32":
        r = np.random.default_rng(n).integers(-(2 ** 31), 2 ** 31, (1, n, n, n)).astype(np.int32)
    else:
        x = _blocks(1, n, seed=n)
        r = np.array(rszx.encode(x, eps=1e-3))  # writable: torch.from_numpy warns otherwise
        _assert_same_bits(tops.lorenzo_encode(torch.from_numpy(x), eps=1e-3).numpy(), r)
    d = tops.lorenzo_decode(torch.from_numpy(r), eps=1e-3).numpy()
    _assert_same_bits(d, np.asarray(rops.lorenzo_decode(r, eps=1e-3, interpret=True)))
    if source == "encode":
        assert np.max(np.abs(d - x)) <= _bound(x, 1e-3)


@pytest.mark.parametrize("absmax,eps", [(50.0, 1e-7), (1e3, 0.0), (1e3, -1.0), (1.0, 1e-9)])
def test_check_eps_raises_as_the_reference(absmax, eps):
    with pytest.raises(ValueError) as want:
        rszx.check_eps(absmax, eps)
    with pytest.raises(ValueError) as got:
        tszx.check_eps(absmax, eps)
    assert str(got.value) == str(want.value)
    assert tszx.max_eps_ratio() == rszx.max_eps_ratio()


# -- the schemes -----------------------------------------------------------------

def _field(n=32, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    f = 50 * np.sin(5 * g[0] + g[1]) * np.exp(-g[2]) + rng.standard_normal((n, n, n)) * 0.01
    return f.astype(np.float32)


SPECS = [dict(eps=1e-3),
         dict(eps=1e-4, block_size=16, buffer_bytes=1 << 15),
         dict(eps=1e-2, block_size=8, shuffle="bit", stage2="lzma", buffer_bytes=1 << 12)]
IDS = ["default", "eps1e-4-16", "eps1e-2-8-bit-lzma"]


@pytest.mark.parametrize("kw", SPECS, ids=IDS)
@pytest.mark.parametrize("scheme", ["lorenzo", "szx"])
def test_scheme_round_trip_within_bound(scheme, kw):
    f = _field(seed=1)
    spec = CompressionSpec(scheme=scheme, **kw)
    pipe = Pipeline(spec, device="cpu")
    dec = pipe.decompress(pipe.compress(f))
    bound = get_scheme(scheme).error_bound(spec)
    assert bound == spec.eps == rget_scheme(scheme).error_bound(RSpec(scheme=scheme, **kw))
    assert dec.shape == f.shape and np.max(np.abs(dec - f)) <= _bound(f, spec.eps)


@pytest.mark.parametrize("kw", SPECS, ids=IDS)
@pytest.mark.parametrize("scheme", ["lorenzo", "szx"])
def test_chunks_equal_reference(scheme, kw):
    f = _field(seed=2)
    want = RPipeline(RSpec(scheme=scheme, **kw)).compress(f)
    got = Pipeline(CompressionSpec(scheme=scheme, **kw), device="cpu").compress(f)
    assert json.dumps(got.header) == json.dumps(want.header)
    assert got.chunks == want.chunks


def test_szx_outliers_serialize_as_the_reference():
    """Residuals past int8 go to the escaped, shuffled int32 outlier list."""
    x = _blocks(2, 8, seed=8, amp=1e3)
    spec = CompressionSpec(scheme="szx", block_size=8, eps=1e-3)
    rspec = RSpec(scheme="szx", block_size=8, eps=1e-3)
    s1 = get_scheme("szx").stage1(torch.from_numpy(x), spec)
    payload = get_scheme("szx").serialize(s1, 0, 2, spec)
    assert payload == rget_scheme("szx").serialize(rget_scheme("szx").stage1(x, rspec),
                                                   0, 2, rspec)
    assert np.frombuffer(payload[:4], np.uint32)[0] > 0
    got = get_scheme("szx").deserialize(payload, 2, spec, torch.device("cpu"))
    _assert_same_bits(got, np.asarray(rget_scheme("szx").deserialize(payload, 2, rspec)))


def test_device_capability_as_the_reference():
    """lorenzo has the kernels; szx runs its plain math on any device and
    records ``host``, as the reference's szx does."""
    assert get_scheme("lorenzo").device_capable is True
    assert get_scheme("szx").device_capable is False
    pipe = Pipeline(CompressionSpec(scheme="szx", device="jax"), device="cpu")
    assert pipe.base_header()["scheme_params"] == {"eps": 1e-3, "device": "host"}


@pytest.mark.parametrize("scheme", ["lorenzo", "szx"])
def test_stage1_check_eps_as_the_reference(scheme):
    x = _blocks(1, 8, seed=9, amp=50.0)
    kw = dict(scheme=scheme, block_size=8, eps=1e-7)
    with pytest.raises(ValueError) as want:
        rget_scheme(scheme).stage1(x, RSpec(**kw))
    with pytest.raises(ValueError) as got:
        get_scheme(scheme).stage1(torch.from_numpy(x), CompressionSpec(**kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("scheme", ["lorenzo", "szx"])
def test_port_file_is_byte_identical_and_cross_reads(tmp_path, scheme):
    f = _field(seed=3)
    spec = dict(scheme=scheme, block_size=16, buffer_bytes=1 << 15)
    tpath, rpath = str(tmp_path / "t.cz"), str(tmp_path / "r.cz")
    tcont.write_field(tpath, f, CompressionSpec(**spec), device="cpu")
    rcont.write_field(rpath, f, RSpec(**spec))
    assert (tmp_path / "t.cz").read_bytes() == (tmp_path / "r.cz").read_bytes()
    # each package reads the other's file, to the same bits
    by_ref = rcont.read_field(tpath, device="host")
    by_port = tcont.read_field(rpath, device="cpu")
    _assert_same_bits(by_port, by_ref)
    assert np.max(np.abs(by_port - f)) <= _bound(f, 1e-3)


@pytest.mark.parametrize("stem", ["cz2_lorenzo", "cz1_szx"])
def test_fixture_decodes_bit_exact(stem):
    dec = tcont.read_field(os.path.join(DATA, f"{stem}.cz"), device="cpu")
    _assert_same_bits(dec, np.load(os.path.join(DATA, f"{stem}.decoded.npy")))


def test_cz1_szx_reads_through_decode_spec():
    """Format 1 wrote szx's outliers unshuffled: ``decode_spec`` reads them
    so, and the reference agrees."""
    spec = CompressionSpec(scheme="szx")
    for fmt, shuffle in ((1, "none"), (2, "byte"), (3, "byte")):
        assert get_scheme("szx").decode_spec(spec, fmt).shuffle == shuffle
        assert rget_scheme("szx").decode_spec(RSpec(scheme="szx"), fmt).shuffle == shuffle
    assert get_scheme("lorenzo").decode_spec(spec, 1) is spec
    path = os.path.join(DATA, "cz1_szx.cz")
    with open(path, "rb") as fh:
        header = tcont._read_header(fh)[0]
    assert header["format"] == 1 and header["spec"]["shuffle"] == "byte"
    # read as the current format, the unshuffled outliers decode wrong
    pipe = Pipeline(CompressionSpec.from_json(header["spec"]), device="cpu")
    chunk, nblk = next(tcont.iter_compressed(path))
    assert not np.array_equal(pipe.decompress_chunk(chunk, nblk, 3),
                              pipe.decompress_chunk(chunk, nblk, 1))


# -- the wrappers ---------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,err,match", [
    ((2, 8, 8, 4), torch.float32, ValueError, r"\(B, n, n, n\)"),
    ((2, 8, 8, 8), torch.float64, TypeError, "float32"),
    ((2, 6, 6, 6), torch.float32, ValueError, "CUDA"),    # any n is taken
    ((2, 64, 64, 64), torch.float32, ValueError, "CUDA"),  # 64 too
])
def test_encode_wrapper_refuses_what_the_kernel_does_not_take(shape, dtype, err, match):
    """Checked before anything reaches the card, so these run on ``meta``
    tensors here: the wrapper refuses them exactly as on a CUDA tensor."""
    with pytest.raises(err, match=match):
        tkern.lorenzo_encode(torch.empty(shape, dtype=dtype, device="meta"))


@pytest.mark.parametrize("shape,dtype,err,match", [
    ((2, 8, 4, 8), torch.int32, ValueError, r"\(B, n, n, n\)"),
    ((2, 8, 8, 8), torch.int64, TypeError, "int32"),
    ((2, 5, 5, 5), torch.int32, ValueError, "CUDA"),
    ((1, 128, 128, 128), torch.int32, ValueError, "CUDA"),  # the staged path's side too
])
def test_decode_wrapper_refuses_what_the_kernel_does_not_take(shape, dtype, err, match):
    with pytest.raises(err, match=match):
        tkern.lorenzo_decode(torch.empty(shape, dtype=dtype, device="meta"))


def _cuda_launches() -> dict:
    from repro_torch import obs

    calls = obs.REGISTRY.get("cz_kernel_calls_total")
    return {k: calls.value(kernel=k, device="cuda") for k in ("lorenzo_encode", "lorenzo_decode")}


def test_wrappers_count_no_launch_on_the_cpu():
    """The launch counts count kernel launches only: a CPU call runs the
    plain version and leaves both the per-wrapper count on the card
    (``cz_kernel_calls_total{device="cuda"}``) and the per-side count as
    they were."""
    before, by_side = _cuda_launches(), dict(tkern.LAUNCHES_BY_SIDE)
    x = torch.from_numpy(_blocks(2, 8, seed=5))
    tkern.lorenzo_decode(tkern.lorenzo_encode(x))
    assert _cuda_launches() == before and dict(tkern.LAUNCHES_BY_SIDE) == by_side


@pytest.mark.parametrize("name", sorted(designs.VARIANTS))
def test_decode_design_variants_patch_the_kernel_source(name):
    """The design study builds each variant from the decode's source: each
    replacement finds its text exactly once, and only ``kept`` is the
    source unchanged."""
    src, got = designs.SOURCE.read_text(), designs.variant_source(name)
    assert (got == src) == (name == "kept")
    for _old, new in designs.VARIANTS[name]:
        assert new in got
