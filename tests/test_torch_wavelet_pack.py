"""The wavelet scheme's packed stage 1 against the serialize it replaced and
against the JAX package's, on the CPU, byte for byte.

Stage 1 selects the significant details where the coefficients lie
(``ops.wavelet_pack``: per-block counts, the mask packed to bits, the
coarse corners and one stream of the significant details), and serialize
cuts each chunk out of those by slicing.  The oracle is the parent's stage 1
and serialize, frozen below: the dense coefficients and a bool mask on the
host, ``coeffs[mask]`` and ``np.packbits``.  Every payload must also be the
reference's (``repro.core.schemes`` ``wavelet``), but at the edge values
(the float32 neighbours of +-eps, -0.0, NaN), where the frozen copy alone
is the oracle, since the coefficients are set by hand after the transform.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline
from repro.core.schemes import get_scheme as rget_scheme

from repro_torch import obs
from repro_torch.core import shuffle as shuf
from repro_torch.core import threshold, wavelets
from repro_torch.core.pipeline import CompressionSpec, Pipeline
from repro_torch.core.schemes import get_scheme, shuffle_bytes
from repro_torch.core.schemes import wavelet as wscheme
from repro_torch.kernels import ops

# one intra-op thread: the suite runs in parallel worker processes, and
# oversubscribed CPU threads slow small torch ops by orders of magnitude
torch.set_num_threads(1)

NBLK = {16: 6, 32: 3, 64: 2}


# -- the parent's stage 1 and serialize, frozen ------------------------------

def _frozen_stage1(coeffs: torch.Tensor, spec) -> dict:
    mask = threshold.significant_mask(coeffs, spec.eps, spec.levels)
    coeffs_np, mask_np = coeffs.numpy(), mask.numpy()
    c = wavelets.coarse_side(spec.block_size, spec.levels)
    return {"mask": mask_np, "coeffs": coeffs_np, "coarse": coeffs_np[..., :c, :c, :c]}


def _frozen_serialize(s1, lo, hi, spec) -> bytes:
    mask = s1["mask"][lo:hi]
    coeffs = s1["coeffs"][lo:hi]
    coarse = s1["coarse"][lo:hi].astype(np.float32)
    details = coeffs[mask].astype(np.float32)
    if spec.zero_bits:
        details = shuf.zero_low_bits_np(details, spec.zero_bits)
    counts = mask.reshape(mask.shape[0], -1).sum(-1).astype(np.uint32)
    values = np.concatenate([coarse.reshape(-1), details])
    return (
        counts.tobytes()
        + np.packbits(mask.reshape(-1)).tobytes()
        + shuffle_bytes(values.tobytes(), spec.shuffle, 4)
    )


# -- inputs -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _blocks(n: int) -> np.ndarray:
    """Smooth blocks with noise near eps, so details fall on both sides of
    the threshold; one block is all zero (coarse only)."""
    rng = np.random.default_rng(n)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    out = []
    for b in range(NBLK[n]):
        smooth = 10 * np.sin((b + 2) * g[0]) * np.cos(3 * g[1]) + g[2] ** 2
        out.append(smooth + rng.standard_normal((n, n, n)) * 10.0 ** -(2 + b % 3))
    out[1] = np.zeros((n, n, n))
    return np.stack(out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_s1(n: int, levels, wavelet: str = "w3ai"):
    return rget_scheme("wavelet").stage1(_blocks(n), RSpec(block_size=n, levels=levels,
                                                           wavelet=wavelet))


def _ranges(nblk: int, bpc: int = 2) -> list[tuple[int, int]]:
    """Pipeline chunks of ``bpc`` blocks, then ranges that are not: a
    single block, a run across chunk ends, all blocks."""
    chunks = [(lo, min(lo + bpc, nblk)) for lo in range(0, nblk, bpc)]
    return chunks + [(1, 2), (1, nblk), (0, nblk), (nblk - 1, nblk)]


def _spec(n, levels=None, **kw):
    return CompressionSpec(block_size=n, levels=levels, **kw)


CASES = [(n, lv, zb, sh) for n in (16, 32, 64) for lv in (None, 2)
         for zb in (0, 4, 8) for sh in ("none", "byte", "bit")]


@pytest.mark.parametrize("n,levels,zero_bits,shuffle", CASES,
                         ids=[f"n{n}-L{lv}-Z{zb}-{sh}" for n, lv, zb, sh in CASES])
def test_packed_serialize_is_the_frozen_and_the_reference_bytes(n, levels, zero_bits,
                                                                shuffle):
    spec = _spec(n, levels, zero_bits=zero_bits, shuffle=shuffle)
    rspec = RSpec(block_size=n, levels=levels, zero_bits=zero_bits, shuffle=shuffle)
    sch = get_scheme("wavelet")
    x = torch.from_numpy(_blocks(n))
    s1 = sch.stage1(x, spec)
    frozen = _frozen_stage1(ops.wavelet_forward(x, "w3ai", levels), spec)
    ref = _reference_s1(n, levels)
    for lo, hi in _ranges(NBLK[n]):
        got = sch.serialize(s1, lo, hi, spec)
        assert got == _frozen_serialize(frozen, lo, hi, spec), (lo, hi)
        assert got == rget_scheme("wavelet").serialize(ref, lo, hi, rspec), (lo, hi)


RANGES = [(0, 2), (2, 4), (4, 6), (0, 1), (3, 4), (5, 6), (1, 5), (0, 6), (3, 6),
          (4, 99), (-2, 6), (-5, -1)]


@pytest.mark.parametrize("lo,hi", RANGES, ids=[f"{lo}-{hi}" for lo, hi in RANGES])
def test_any_range_serializes_as_numpy_slices_it(lo, hi):
    """Any ``[lo, hi)``, read as a numpy slice reads it: the pipeline's
    chunks, a single block, all blocks, ranges across chunk ends, past the
    end and from the end."""
    spec = _spec(16, wavelet="w4i", zero_bits=4)
    x = torch.from_numpy(_blocks(16))
    s1 = get_scheme("wavelet").stage1(x, spec)
    frozen = _frozen_stage1(ops.wavelet_forward(x, "w4i", None), spec)
    assert (get_scheme("wavelet").serialize(s1, lo, hi, spec)
            == _frozen_serialize(frozen, lo, hi, spec))


def _edge_coeffs(eps: float, n: int = 16, nblk: int = 3) -> torch.Tensor:
    """Coefficients at the threshold's edges, in detail and coarse cells:
    +-eps in float32 and its float32 neighbours, +-0.0, NaN of both signs
    and a payload, +-inf, a subnormal; the rest noise around eps."""
    rng = np.random.default_rng(7)
    e = np.float32(eps)
    edge = np.array([e, -e, np.nextafter(e, np.float32(0)), np.nextafter(e, np.float32(1)),
                     -np.nextafter(e, np.float32(0)), -np.nextafter(e, np.float32(1)),
                     0.0, -0.0, np.inf, -np.inf, np.float32(1e-40)], np.float32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001], np.uint32).view(np.float32)
    edge = np.concatenate([edge, nans])
    x = (rng.standard_normal((nblk, n, n, n)) * 2 * eps).astype(np.float32)
    flat = x.reshape(nblk, -1)
    for b in range(nblk):
        cells = rng.choice(n ** 3, size=4 * edge.size, replace=False)
        flat[b, cells] = np.tile(edge, 4)
        flat[b, : edge.size] = edge  # the first cells lie in the coarse corner too
    x[2] = 0.0
    x[2, 5, 6, 7] = -0.0
    return torch.from_numpy(x)


EDGE_EPS = (1e-3, 7e-4, 0.0)  # float32(7e-4) < 7e-4: torch compares in float32


@pytest.mark.parametrize("eps", EDGE_EPS)
@pytest.mark.parametrize("zero_bits,shuffle", [(0, "none"), (8, "byte"), (4, "bit")])
def test_edge_values_serialize_as_the_frozen_copy(monkeypatch, eps, zero_bits, shuffle):
    coeffs = _edge_coeffs(eps)
    spec = _spec(16, eps=eps, zero_bits=zero_bits, shuffle=shuffle)
    monkeypatch.setattr(wscheme.ops, "wavelet_forward", lambda x, kind, levels: coeffs)
    s1 = get_scheme("wavelet").stage1(torch.zeros_like(coeffs), spec)
    frozen = _frozen_stage1(coeffs, spec)
    for lo, hi in _ranges(3, bpc=1):
        assert (get_scheme("wavelet").serialize(s1, lo, hi, spec)
                == _frozen_serialize(frozen, lo, hi, spec)), (lo, hi)


@pytest.mark.parametrize("eps", EDGE_EPS)
def test_plain_pack_is_numpys_selection(eps):
    """The plain version's four outputs: the frozen mask's counts and
    packbits per block, the coarse corners and ``coeffs[mask]`` as bits."""
    coeffs = _edge_coeffs(eps)
    counts, packed, coarse, details = ops.wavelet_pack(coeffs, eps, None)
    frozen = _frozen_stage1(coeffs, _spec(16, eps=eps))
    mask, c = frozen["mask"], wavelets.coarse_side(16)
    assert counts.dtype == torch.int32 and packed.dtype == torch.uint8
    assert np.array_equal(counts.numpy(), mask.reshape(3, -1).sum(-1))
    assert np.array_equal(packed.numpy(), np.packbits(mask.reshape(3, -1), axis=-1))
    assert np.array_equal(coarse.numpy().view(np.uint32),
                          frozen["coeffs"][:, :c, :c, :c].view(np.uint32))
    assert np.array_equal(details.numpy().view(np.uint32),
                          frozen["coeffs"][mask].view(np.uint32))


@pytest.mark.parametrize("n", [16, 32])
def test_all_zero_batch_is_coarse_only(n):
    x = torch.zeros((3, n, n, n))
    spec = _spec(n)
    s1 = get_scheme("wavelet").stage1(x, spec)
    assert not s1["counts"].any() and s1["details"].size == 0
    ref = rget_scheme("wavelet").stage1(x.numpy(), RSpec(block_size=n))
    frozen = _frozen_stage1(ops.wavelet_forward(x, "w3ai", None), spec)
    for lo, hi in _ranges(3, bpc=2):
        got = get_scheme("wavelet").serialize(s1, lo, hi, spec)
        assert got == _frozen_serialize(frozen, lo, hi, spec)
        assert got == rget_scheme("wavelet").serialize(ref, lo, hi, RSpec(block_size=n))


def _field(n=64, seed=3):
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    f = 100 * np.sin(4 * g[0]) * np.cos(3 * g[1]) + 10 * g[2] ** 2
    return (f + rng.standard_normal((n, n, n)) * 0.01).astype(np.float32)


PIPE_SPECS = [dict(buffer_bytes=1 << 16),
              dict(block_size=16, wavelet="w4i", shuffle="bit", zero_bits=4,
                   buffer_bytes=3 << 14)]


@pytest.mark.parametrize("kw", PIPE_SPECS, ids=["defaults-4chunks", "n16-w4i-bit-z4"])
def test_pipeline_chunks_are_the_references(kw):
    f = _field()
    want = RPipeline(RSpec(**kw)).compress(f)
    got = Pipeline(CompressionSpec(**kw), device="cpu", workers=2).compress(f)
    assert len(got.chunks) > 1 and got.chunks == want.chunks


@pytest.mark.parametrize("bad,err,match", [
    (dict(n=24), ValueError, "side 24"),
    (dict(levels=4), ValueError, "levels=4"),
    (dict(dtype=torch.float64), TypeError, "float32"),
    ({}, ValueError, "CUDA"),
])
def test_pack_refuses_what_the_kernel_does_not_take(bad, err, match):
    """Checked before anything reaches the card, so these run on ``meta``
    tensors here: the wrapper refuses them as on a CUDA tensor."""
    n = bad.get("n", 32)
    x = torch.empty((2, n, n, n), dtype=bad.get("dtype", torch.float32), device="meta")
    with pytest.raises(err, match=match):
        ops.wavelet_pack(x, 1e-3, bad.get("levels"))


def test_pack_on_the_cpu_counts_no_launch():
    calls = obs.REGISTRY.get("cz_kernel_calls_total")
    before = calls.value(kernel="wavelet_pack", device="cuda")
    cpu_before = calls.value(kernel="wavelet_pack", device="cpu")
    get_scheme("wavelet").stage1(torch.from_numpy(_blocks(16)), _spec(16))
    assert calls.value(kernel="wavelet_pack", device="cuda") == before
    assert calls.value(kernel="wavelet_pack", device="cpu") == cpu_before + 1
