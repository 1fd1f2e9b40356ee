"""The plain wavelet transforms of the port against the reference's host
path, bit for bit.

The reference's host path (``repro.core.schemes.wavelet`` with
``device="host"``) calls ``repro.core.wavelets.forward3d``/``inverse3d``
eagerly: each jnp operation runs on its own under XLA on the CPU, which
reads subnormal operands as zero and flushes subnormal results to a zero of
the same sign.  The port's plain version (``repro_torch.core.wavelets``),
which the CUDA kernels reproduce operation by operation, follows that, so
the two agree bit for bit, -0.0 and +0.0 apart included, at amplitude 50
and where the values or their intermediates are subnormal (1e-36, 1e-39).

Inputs are uniform in [-amplitude, amplitude], made with numpy from a seed
and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import wavelets as rwv

from repro_torch.core import wavelets as twv

# one intra-op thread: the suite runs in parallel worker processes, and
# oversubscribed CPU threads slow small torch ops by orders of magnitude
torch.set_num_threads(1)

AMPLITUDES = (50.0, 1e-36, 1e-39)
# (n, levels, blocks): every level count up to n = 32; n = 64 at its first
# and last level count and n = 128 at one level, one block each
SIDES = ([(n, lv, 2) for n in (8, 16, 32) for lv in range(1, rwv.max_levels(n) + 1)]
         + [(64, 1, 1), (64, 4, 1), (128, 1, 1)])
CASES = [(amp, kind, n, lv, b) for amp in AMPLITUDES for kind in rwv.WAVELETS
         for n, lv, b in SIDES]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


@pytest.mark.parametrize("amp,kind,n,levels,b", CASES,
                         ids=[f"{a:g}-{k}-n{n}-L{lv}" for a, k, n, lv, _ in CASES])
def test_plain_transform_bits_equal_reference_host_path(amp, kind, n, levels, b):
    rng = np.random.default_rng(n * 10 + levels)
    x = (rng.uniform(-1.0, 1.0, (b, n, n, n)) * amp).astype(np.float32)
    want = np.array(rwv.forward3d(jnp.asarray(x), kind, levels))  # writable
    got = twv.forward3d(torch.from_numpy(x), kind, levels).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want), strict=True)
    back_want = np.asarray(rwv.inverse3d(jnp.asarray(want), kind, levels))
    back = twv.inverse3d(torch.from_numpy(want), kind, levels).numpy()
    np.testing.assert_array_equal(_bits(back), _bits(back_want), strict=True)
