"""The port's kernel wrappers (``repro_torch.kernels``) against the Pallas
kernels of the JAX package, run as the JAX tests run them on the CPU, in
interpret mode.  On the CPU each wrapper runs its kernel's plain version;
the CUDA kernels themselves are held against that plain version on the
card by ``chip_smoke.py``.

Inputs are uniform in [-50, 50], made with numpy from a seed.  Tolerances
are those of ``tests/test_kernels.py``: forward ``rtol=1e-5, atol=2e-3``,
round trip ``atol=1e-4 * amplitude``.  Every kind, n in {8, 16, 32, 64} and
every valid level count is covered.
"""
import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

from repro.core import wavelets as rwv
from repro.kernels import ops as rops

from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import wavelet3d as tkern

# one intra-op thread: the suite runs in parallel worker processes, and
# oversubscribed CPU threads slow small torch ops by orders of magnitude
torch.set_num_threads(1)

AMP = 50.0
FWD_TOL = dict(rtol=1e-5, atol=2e-3)
RT_TOL = dict(rtol=1e-5, atol=1e-4 * AMP)

CASES = [(kind, n, lv) for kind in rwv.WAVELETS for n in (8, 16, 32, 64)
         for lv in range(1, rwv.max_levels(n) + 1)]


@pytest.mark.parametrize("kind,n,levels", CASES,
                         ids=[f"{k}-n{n}-L{lv}" for k, n, lv in CASES])
def test_wavelet_wrappers_match_pallas_interpret(kind, n, levels):
    b = 1 if n == 64 else 2  # a 64^3 block is 1 MiB
    x = np.random.default_rng(n + levels).uniform(-AMP, AMP, (b, n, n, n)).astype(np.float32)
    want = rops.wavelet_forward(x, kind=kind, levels=levels, interpret=True)
    got = tops.wavelet_forward(torch.from_numpy(x), kind, levels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    back_want = rops.wavelet_inverse(want, kind=kind, levels=levels, interpret=True)
    back = tops.wavelet_inverse(got, kind, levels).numpy()
    np.testing.assert_allclose(back, np.asarray(back_want), **RT_TOL)
    np.testing.assert_allclose(back, x, **RT_TOL)


@pytest.mark.parametrize("n,levels", [(8, 1), (16, 2), (32, 3)])
def test_kernel_weight_table_is_predict_table_in_float32(n, levels):
    for kind in rwv.WAVELETS:
        want = np.concatenate([
            rwv._predict_table(kind, (n >> lv) // 2)[1].astype(np.float32).ravel()
            for lv in range(levels)])
        np.testing.assert_array_equal(tkern.tap_weights(kind, n, levels), want,
                                      strict=True)


@pytest.mark.parametrize("bad,err,match", [
    (dict(n=24), ValueError, "side 24"),  # not a power of two
    (dict(levels=4), ValueError, "levels=4"),  # deeper than max_levels(32)
    (dict(kind="haar"), ValueError, "haar"),
    (dict(dtype=torch.float64), TypeError, "float32"),
    ({}, ValueError, "CUDA"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad, err, match):
    """Checked before anything reaches the card, so these run on ``meta``
    tensors here: the wrappers refuse them exactly as on a CUDA tensor."""
    n = bad.get("n", 32)
    x = torch.empty((2, n, n, n), dtype=bad.get("dtype", torch.float32), device="meta")
    with pytest.raises(err, match=match):
        tkern._launch("wavelet3d_forward", x, bad.get("kind", "w3ai"),
                      bad.get("levels"))


def test_kernels_build_into_the_checkout_or_a_user_cache(tmp_path, monkeypatch):
    root = pathlib.Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR == root / "build" / "repro_torch_kernels"
    # an installed copy of the package builds into the user's cache, never
    # next to its own sources
    site = tmp_path / "site-packages" / "repro_torch" / "kernels"
    site.mkdir(parents=True)
    shutil.copy(_build.__file__, site / "_build.py")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    spec = importlib.util.spec_from_file_location("_installed_build", site / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.BUILD_DIR == tmp_path / "cache" / "repro_torch_kernels"


def _cuda_launches() -> dict:
    from repro_torch import obs

    calls = obs.REGISTRY.get("cz_kernel_calls_total")
    return {k: calls.value(kernel=k, device="cuda") for k in ("wavelet_forward", "wavelet_inverse")}


def test_wavelet_wrappers_count_no_launch_on_the_cpu():
    """The launch counts count kernel launches only: a CPU call runs the
    plain version and leaves both the per-wrapper count on the card
    (``cz_kernel_calls_total{device="cuda"}``) and the per-side count as
    they were."""
    before, by_side = _cuda_launches(), dict(tkern.LAUNCHES_BY_SIDE)
    x = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (2, 8, 8, 8)).astype(np.float32))
    tkern.wavelet3d_inverse(tkern.wavelet3d_forward(x, "w3ai", 1), "w3ai", 1)
    assert _cuda_launches() == before and dict(tkern.LAUNCHES_BY_SIDE) == by_side
