"""Stage-1 math of the PyTorch port against the JAX package: the wavelet
weight tables, the plain transforms (the kernels' plain version) against
``repro.core.wavelets``, and the host codecs byte for byte.

Inputs are uniform in [-50, 50], made with numpy from a seed and handed to
both packages.  Tolerances are those of ``tests/test_kernels.py``: forward
``rtol=1e-5, atol=2e-3``, round trip ``atol=1e-4 * amplitude``.  Only
``levels <= max_levels(n)`` are drawn: other level counts are invalid.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import blocks as rblocks
from repro.core import lossless as rlossless
from repro.core import metrics as rmetrics
from repro.core import shuffle as rshuffle
from repro.core import threshold as rthreshold
from repro.core import wavelets as rwv

from repro_torch.core import blocks as tblocks
from repro_torch.core import lossless as tlossless
from repro_torch.core import metrics as tmetrics
from repro_torch.core import shuffle as tshuffle
from repro_torch.core import threshold as tthreshold
from repro_torch.core import wavelets as twv
from repro_torch.kernels import ops as tops

# one intra-op thread: the suite runs in parallel worker processes, and
# oversubscribed CPU threads slow small torch ops by orders of magnitude
torch.set_num_threads(1)

AMP = 50.0
FWD_TOL = dict(rtol=1e-5, atol=2e-3)
RT_TOL = dict(rtol=1e-5, atol=1e-4 * AMP)

CASES = [(kind, n, lv) for kind in rwv.WAVELETS for n in (8, 16, 32)
         for lv in range(1, rwv.max_levels(n) + 1)]
CASE_IDS = [f"{k}-n{n}-L{lv}" for k, n, lv in CASES]


def _blocks(b, n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-AMP, AMP, (b, n, n, n)).astype(np.float32)


@pytest.mark.parametrize("kind", rwv.WAVELETS)
@pytest.mark.parametrize("m", [4, 8, 16])
def test_predict_table_is_bit_exact(kind, m):
    ridx, rW = rwv._predict_table(kind, m)
    tidx, tW = twv._predict_table(kind, m)
    np.testing.assert_array_equal(tidx, ridx, strict=True)
    np.testing.assert_array_equal(tW, rW, strict=True)


@pytest.mark.parametrize("kind,n,levels", CASES, ids=CASE_IDS)
def test_plain_transform_matches_reference(kind, n, levels):
    x = _blocks(3, n, seed=n * 10 + levels)
    want = np.asarray(rwv.forward3d(jnp.asarray(x), kind, levels))
    got = tops.wavelet_forward(torch.from_numpy(x), kind, levels).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    back = tops.wavelet_inverse(torch.from_numpy(got), kind, levels).numpy()
    np.testing.assert_allclose(
        back, np.asarray(rwv.inverse3d(jnp.asarray(want), kind, levels)), **FWD_TOL)
    np.testing.assert_allclose(back, x, **RT_TOL)


def test_plain_inverse_leaves_its_input_alone():
    x = torch.from_numpy(_blocks(2, 16, seed=3))
    keep = x.clone()
    twv.inverse3d(x, "w4l", 2)
    twv.forward3d(x, "w4l", 2)
    assert torch.equal(x, keep)


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_blocks_bit_exact(bs):
    f = np.random.default_rng(bs).standard_normal((32, 16, 48)).astype(np.float32)
    want = rblocks.blockify(f, bs)
    np.testing.assert_array_equal(tblocks.blockify(f, bs), want, strict=True)
    np.testing.assert_array_equal(
        tblocks.blockify(torch.from_numpy(f), bs).numpy(), want, strict=True)
    np.testing.assert_array_equal(
        tblocks.unblockify(torch.from_numpy(want), f.shape).numpy(), f, strict=True)
    np.testing.assert_array_equal(tblocks.unblockify(want, f.shape), f, strict=True)


@pytest.mark.parametrize("levels", [None, 1, 2])
def test_mask_and_threshold_bit_exact(levels):
    c = _blocks(4, 16, seed=7) * 1e-4  # many coefficients near eps = 1e-3
    eps = 1e-3
    want_mask = np.asarray(rthreshold.significant_mask(jnp.asarray(c), eps, levels))
    got_mask = tthreshold.significant_mask(torch.from_numpy(c), eps, levels).numpy()
    np.testing.assert_array_equal(got_mask, want_mask, strict=True)
    assert 0 < got_mask.sum() < got_mask.size
    want = np.asarray(rthreshold.threshold_details(jnp.asarray(c), eps, levels))
    got = tthreshold.threshold_details(torch.from_numpy(c), eps, levels).numpy()
    np.testing.assert_array_equal(got, want, strict=True)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_shuffle_bit_exact(itemsize):
    buf = np.random.default_rng(itemsize).integers(0, 256, 96 * 8, np.uint8).tobytes()
    for name in ("byte_shuffle", "byte_unshuffle", "bit_shuffle", "bit_unshuffle"):
        assert getattr(tshuffle, name)(buf, itemsize) == getattr(rshuffle, name)(buf, itemsize)
    v = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    for nbits in (0, 4, 8):
        np.testing.assert_array_equal(tshuffle.zero_low_bits_np(v, nbits),
                                      rshuffle.zero_low_bits_np(v, nbits), strict=True)


@pytest.mark.parametrize("method", sorted(rlossless.METHODS))
def test_lossless_bit_exact(method):
    buf = np.random.default_rng(1).standard_normal(4096).astype(np.float32).tobytes()
    enc = tlossless.encode(buf, method)
    assert enc == rlossless.encode(buf, method)
    assert tlossless.decode(enc, method) == buf


def test_metrics_match():
    rng = np.random.default_rng(2)
    ref = rng.standard_normal((8, 8, 8)).astype(np.float32)
    dec = ref + rng.standard_normal(ref.shape).astype(np.float32) * 1e-3
    assert tmetrics.mse(ref, dec) == rmetrics.mse(ref, dec)
    assert tmetrics.psnr(ref, dec) == rmetrics.psnr(ref, dec)
    assert tmetrics.psnr(ref, ref) == float("inf")
    assert tmetrics.compression_ratio(100, 7) == rmetrics.compression_ratio(100, 7)
