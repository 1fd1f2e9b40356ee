"""The port's cavitation generator (torch, on the CPU here) against the
numpy generator of the JAX package.

Every random draw is the same; the field math runs in torch float32.  The
two differ only by float32 rounding: tanh, exp and the FFT round
differently, and torch divides by a scalar through its reciprocal.  Errors
of a few float32 ulps in the volume fraction a2 (about 6e-7) are scaled by
the liquid density (1000) into rho, so the tolerance is relative to each
field's largest magnitude: |port - numpy| <= 4e-6 * max|numpy|, with
margin over the 1.3e-6 observed at n = 32 and 64.
"""
import numpy as np
import pytest
import torch

from repro.fields import cavitation as rcav

from repro_torch.fields import cavitation as tcav

# one intra-op thread: the suite runs in parallel worker processes, and
# oversubscribed CPU threads slow small torch ops by orders of magnitude
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("t", [4.7, 9.4])
def test_generator_matches_numpy(n, t):
    want = rcav.cavitation_fields(rcav.CloudConfig(n=n), t)
    got = tcav.cavitation_fields(tcav.CloudConfig(n=n), t, device="cpu")
    assert list(got) == list(want) == list(tcav.QOIS)
    for q, ref in want.items():
        x = got[q].numpy()
        assert x.shape == ref.shape and x.dtype == ref.dtype
        np.testing.assert_allclose(x, ref, rtol=0, atol=4e-6 * np.abs(ref).max(),
                                   err_msg=q)


def test_bubble_draws_are_identical():
    cfg = rcav.CloudConfig(n=16)
    for a, b in zip(rcav._bubbles(cfg), tcav._bubbles(tcav.CloudConfig(n=16))):
        np.testing.assert_array_equal(a, b, strict=True)
