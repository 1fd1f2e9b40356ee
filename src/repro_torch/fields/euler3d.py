"""Mini 3D compressible Euler solver (finite volume, Rusanov, RK2) in torch
(port of ``repro.fields.euler3d``).

Stands in for Cubism-MPCF as the *data producer* for in-situ compression
(paper Fig. 12): an ideal-gas bubble-collapse configuration evolves while
the I/O hook compresses QoI snapshots.  Periodic box, conservative update:
mass, momentum and energy are conserved to float32 rounding.

State layout: (5, n, n, n) = [rho, rho*u, rho*v, rho*w, E], float32 on the
state's own device; every function below runs there as plain torch ops
(the reference's are pure jnp: there is no kernel to port).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.schemes import torch_device

__all__ = ["EulerConfig", "init_bubble_cloud", "step", "run", "primitives", "cfl_dt"]

GAMMA = 1.4
# A bubble's indicator 0.5 * (1 - tanh(z)) is below 4e-11 past z = 12
# interface widths; there it cannot change any float32 value of the state
# (below), so it is evaluated only inside each bubble's box of that reach.
_SUPPORT_Z = 12.0


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    n: int = 64
    n_bubbles: int = 8
    p_ambient: float = 10.0
    p_bubble: float = 0.5
    rho_liquid: float = 1.0
    rho_gas: float = 0.05
    seed: int = 7


def init_bubble_cloud(cfg: EulerConfig, device=DEFAULT_DEVICE) -> torch.Tensor:
    """The reference's initial state, bit for bit, on ``device``.

    The bubbles come from ``np.random.default_rng(cfg.seed)`` in the
    reference's order, and each bubble's indicator is the reference's numpy
    expression (the same float64 operations per cell).  It is evaluated only
    inside the box where ``(d - r) / (1.5 / n) <= 12``: outside, the
    reference's value is below 4e-11, so its running maximum differs from
    this one's only where every bubble's indicator is that small, and there
    rho, p and E round to the same float32 as at chi = 0 (the nearest
    float32 rounding boundaries lie 3e-8 of chi away).  The maximum and the
    rho/p/E formulas run on ``device`` in float64: each is one IEEE operation
    per cell, as in numpy, so the float32 state is the reference's.
    """
    dev = torch_device(device)
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n
    ax = (np.arange(n) + 0.5) / n
    chi = torch.zeros((n, n, n), dtype=torch.float64, device=dev)
    for _ in range(cfg.n_bubbles):
        c = rng.uniform(0.3, 0.7, 3)
        r = rng.uniform(0.04, 0.09)
        reach = r + _SUPPORT_Z * (1.5 / n)
        box = []
        for k in range(3):  # ax is increasing: the cells in reach are a slice
            idx = np.nonzero(np.abs(ax - c[k]) <= reach)[0]
            box.append(slice(int(idx[0]), int(idx[-1]) + 1))
        box = tuple(box)
        x, y, z = (ax[s] for s in box)
        d = np.sqrt((x[:, None, None] - c[0]) ** 2 + (y[None, :, None] - c[1]) ** 2
                    + (z[None, None, :] - c[2]) ** 2)
        ind = torch.from_numpy(0.5 * (1 - np.tanh((d - r) / (1.5 / n)))).to(dev)
        chi[box] = torch.maximum(chi[box], ind)
    rho = cfg.rho_liquid * (1 - chi) + cfg.rho_gas * chi
    p = cfg.p_ambient * (1 - chi) + cfg.p_bubble * chi
    E = p / (GAMMA - 1)
    U = torch.zeros((5, n, n, n), dtype=torch.float32, device=dev)
    U[0] = rho
    U[4] = E
    return U


def primitives(U: torch.Tensor):
    rho = U[0]
    vel = U[1:4] / rho
    ke = 0.5 * rho * torch.sum(vel**2, dim=0)
    p = (GAMMA - 1) * (U[4] - ke)
    return rho, vel, p


def _flux(U: torch.Tensor, axis: int) -> torch.Tensor:
    rho, vel, p = primitives(U)
    un = vel[axis]
    return torch.stack([
        rho * un,
        U[1] * un + (p if axis == 0 else 0.0),
        U[2] * un + (p if axis == 1 else 0.0),
        U[3] * un + (p if axis == 2 else 0.0),
        (U[4] + p) * un,
    ])


def _rusanov_div(U: torch.Tensor, dx: float) -> torch.Tensor:
    """sum_axis d(F)/dx with local Lax-Friedrichs (Rusanov) fluxes, periodic."""
    rho, vel, p = primitives(U)
    c = torch.sqrt(GAMMA * torch.clamp(p, min=1e-8) / rho)
    div = torch.zeros_like(U)
    for axis in range(3):
        sp = torch.abs(vel[axis]) + c                     # wave speed
        F = _flux(U, axis)
        ax = axis + 1                                     # state axis offset
        Up = torch.roll(U, -1, dims=ax)
        Fp = torch.roll(F, -1, dims=ax)
        a = torch.maximum(sp, torch.roll(sp, -1, dims=axis))
        Fface_hi = 0.5 * (F + Fp) - 0.5 * a[None] * (Up - U)  # face i+1/2
        Fface_lo = torch.roll(Fface_hi, 1, dims=ax)           # face i-1/2
        div = div + (Fface_hi - Fface_lo) / dx
    return div


def step(U: torch.Tensor, dt: float) -> torch.Tensor:
    """One RK2 (Heun) step of size ``dt``."""
    dx = 1.0 / U.shape[-1]
    k1 = -_rusanov_div(U, dx)
    U1 = U + dt * k1
    k2 = -_rusanov_div(U1, dx)
    return U + 0.5 * dt * (k1 + k2)


def cfl_dt(U: torch.Tensor, cfl: float = 0.35) -> float:
    rho, vel, p = primitives(U)
    c = torch.sqrt(GAMMA * torch.clamp(p, min=1e-8) / rho)
    smax = float(torch.max(torch.abs(vel) + c[None]))
    # dimension-unsplit 3D update: stability needs dt <= cfl * dx / (3 * smax)
    return cfl * (1.0 / U.shape[-1]) / (3.0 * smax)


def run(U: torch.Tensor, steps: int, dt: float | None = None) -> torch.Tensor:
    """Advance ``steps`` with a fixed (or CFL-derived) dt; returns final state."""
    if dt is None:
        dt = cfl_dt(U)
    for _ in range(steps):
        U = step(U, dt)
    return U
