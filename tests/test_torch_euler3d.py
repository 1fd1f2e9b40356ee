"""The port's mini Euler solver (``repro_torch.fields.euler3d``) against the
JAX package's (``repro.fields.euler3d``), on the CPU at n = 16-128.

* ``init_bubble_cloud`` is the reference's state bit for bit, also at sizes
  where the port evaluates each bubble only inside its support (n >= 64).
* ``primitives``, ``_rusanov_div``, one ``step`` and ``cfl_dt`` agree with
  the reference's jit path within ``rtol = 1e-6`` and ``atol = 1e-6`` of the
  largest magnitude of the reference's result: about 8 float32 ulps of it.
  They are not bit-equal because XLA's CPU backend contracts ``a * b + c``
  into one FMA inside its fusions (one rounding where torch rounds twice)
  and flushes subnormals; the readings here are 1-4 ulps.
* ``run`` for 20 steps agrees within ten times that (``1e-5``), which leaves
  room for those per-step roundings to accumulate.
* The reference's own properties hold on the port: conservation to 1e-4 of
  the scale, positive pressure, motion after 30 steps
  (``tests/test_fields.py``).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.fields import euler3d as ref
from repro_torch.fields import EulerConfig, init_bubble_cloud, primitives, run, step
from repro_torch.fields import euler3d as port

torch.set_num_threads(1)

STEP_TOL = 1e-6     # rtol, and atol as a fraction of max |reference|
RUN_TOL = 1e-5      # 20 steps


def _close(got, want, tol: float) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@functools.cache
def _state(n: int, nb: int, which: str) -> np.ndarray:
    """The reference's initial state (no motion), or after 10 steps."""
    U0 = np.asarray(ref.init_bubble_cloud(ref.EulerConfig(n=n, n_bubbles=nb)))
    return U0 if which == "initial" else np.asarray(ref.run(jnp.asarray(U0), 10))


CASES = [(n, nb, which) for (n, nb) in ((16, 4), (32, 3)) for which in ("initial", "moving")]


def _pair(n, nb, which):
    U = _state(n, nb, which)
    return jnp.asarray(U), torch.from_numpy(U.copy())


@pytest.mark.parametrize("n,nb", [(16, 8), (32, 3), (32, 8), (64, 8), (128, 8), (128, 1)])
def test_init_bubble_cloud_bit_equal(n, nb):
    want = np.asarray(ref.init_bubble_cloud(ref.EulerConfig(n=n, n_bubbles=nb)))
    got = init_bubble_cloud(EulerConfig(n=n, n_bubbles=nb), device="cpu")
    assert got.dtype == torch.float32 and got.shape == (5, n, n, n)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_config_and_names_match_the_reference():
    assert port.GAMMA == ref.GAMMA
    assert EulerConfig().__dict__ == ref.EulerConfig().__dict__
    assert port.__all__ == ref.__all__


@pytest.mark.parametrize("n,nb,which", CASES)
def test_primitives_match(n, nb, which):
    ju, tu = _pair(n, nb, which)
    for got, want in zip(primitives(tu), jax.jit(ref.primitives)(ju)):
        _close(got, want, STEP_TOL)


@pytest.mark.parametrize("n,nb,which", CASES)
def test_rusanov_div_matches(n, nb, which):
    ju, tu = _pair(n, nb, which)
    want = jax.jit(ref._rusanov_div, static_argnums=1)(ju, 1.0 / n)
    _close(port._rusanov_div(tu, 1.0 / n), want, STEP_TOL)


@pytest.mark.parametrize("n,nb,which", CASES)
def test_step_matches(n, nb, which):
    ju, tu = _pair(n, nb, which)
    dt = ref.cfl_dt(ju)
    _close(step(tu, dt), ref.step(ju, dt), STEP_TOL)


@pytest.mark.parametrize("n,nb,which", CASES)
def test_cfl_dt_matches(n, nb, which):
    ju, tu = _pair(n, nb, which)
    got, want = port.cfl_dt(tu), ref.cfl_dt(ju)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=STEP_TOL)


@pytest.mark.parametrize("dt", [None, 5e-4])
def test_run_20_steps_matches(dt):
    U0 = _state(32, 3, "initial")
    _close(run(torch.from_numpy(U0.copy()), 20, dt=dt), ref.run(jnp.asarray(U0), 20, dt=dt),
           RUN_TOL)


def test_conservation_and_positive_pressure():
    U0 = init_bubble_cloud(EulerConfig(n=32, n_bubbles=3), device="cpu")
    U = run(U0, steps=20, dt=port.cfl_dt(U0))
    assert torch.isfinite(U).all()
    for comp in range(5):
        tot0, tot1 = float(U0[comp].sum()), float(U[comp].sum())
        scale = max(float(U0[comp].abs().sum()), float(U[comp].abs().sum()), 1.0)
        assert abs(tot1 - tot0) <= 1e-4 * scale, comp
    assert float(primitives(U)[2].min()) > 0.0


def test_waves_propagate():
    U = run(init_bubble_cloud(EulerConfig(n=32, n_bubbles=3), device="cpu"), steps=30)
    assert float((U[1:4] ** 2).sum()) > 1e-8


def test_runs_on_the_state_device_and_cuda_without_a_gpu_raises(monkeypatch):
    U = init_bubble_cloud(EulerConfig(n=16, n_bubbles=2), device="cpu")
    assert step(U, 1e-4).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_bubble_cloud(EulerConfig(n=16, n_bubbles=2))
