"""The in-situ cells' data producer: a frozen copy of the repository's mini
3D compressible Euler solver (finite volume, Rusanov fluxes, RK2 (Heun),
ideal gas, periodic box), in plain torch on the card.

It stands in for the simulation code (the paper's Cubism-MPCF) that runs
beside the compressor.  The copy lives with the benchmark so that the
producer's cost is the same for every version of the program under test:
no change to the program can speed up or slow down the stand-in.

State: ``(5, n, n, n)`` float32 ``[rho, rho u, rho v, rho w, E]``.  The
initial state is a liquid at rest at pressure ``p_ambient`` holding the
paper's Table 1 cloud: the bubbles' centres and lognormal radii are those
of the ex-situ snapshot's cloud (:func:`perfbench.producers.cavitation.
bubble_cloud`), each filled with gas at ``p_bubble``.  The indicator of
each bubble is ``(1 - tanh((d - r) / w)) / 2`` with the interface width
``w = 1.5 / n``, evaluated in float64 inside the box where it exceeds 4e-11
and combined by maximum.  The run's seed then moves the whole cloud: it
orders the three axes and shifts the periodic box by a whole number of
cells along each.  Every seed so runs the same cloud, the same physics and
the same amount of work, placed elsewhere against the compressor's 32^3
blocks.  Every step is deterministic on the card (elementwise operations,
rolls and fixed-order reductions), so a replay from the seed gives the
same fields bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.producers.cavitation import bubble_cloud

__all__ = ["GAMMA", "init_bubble_cloud", "primitives", "step", "cfl_dt", "qoi_fields"]

GAMMA = 1.4
_SUPPORT_Z = 12.0


def init_bubble_cloud(n: int, cloud: dict, seed: int, device, *, p_ambient: float,
                      p_bubble: float, rho_liquid: float, rho_gas: float) -> torch.Tensor:
    """The initial ``n``^3 state on ``device``: ``cloud`` holds the cloud's
    sizes (``n_bubbles``, ``cloud_radius``, ``r_mean``, ``r_sigma``,
    ``cloud_seed``), ``seed`` places it."""
    centers, radii = bubble_cloud(int(cloud["n_bubbles"]), float(cloud["cloud_radius"]),
                                  float(cloud["r_mean"]), float(cloud["r_sigma"]),
                                  int(cloud["cloud_seed"]))
    ax = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    chi = torch.zeros((n, n, n), dtype=torch.float64, device=device)
    width = 1.5 / n
    for c, r in zip(centers.astype(np.float64), radii.astype(np.float64)):
        reach = r + _SUPPORT_Z * width
        box = []
        for k in range(3):
            idx = np.nonzero(np.abs((np.arange(n) + 0.5) / n - c[k]) <= reach)[0]
            box.append(slice(int(idx[0]), int(idx[-1]) + 1))
        x, y, z = (ax[s] for s in box)
        d = torch.sqrt((x[:, None, None] - c[0]) ** 2 + (y[None, :, None] - c[1]) ** 2
                       + (z[None, None, :] - c[2]) ** 2)
        ind = 0.5 * (1 - torch.tanh((d - r) / width))
        box = tuple(box)
        chi[box] = torch.maximum(chi[box], ind)
    place = np.random.default_rng(seed)
    order = [int(a) for a in place.permutation(3)]
    shift = [int(v) for v in place.integers(0, n, 3)]
    chi = torch.roll(chi.permute(*order), shifts=shift, dims=(0, 1, 2))
    rho = rho_liquid * (1 - chi) + rho_gas * chi
    p = p_ambient * (1 - chi) + p_bubble * chi
    U = torch.zeros((5, n, n, n), dtype=torch.float32, device=device)
    U[0] = rho
    U[4] = p / (GAMMA - 1)
    return U


def primitives(U: torch.Tensor):
    rho = U[0]
    vel = U[1:4] / rho
    ke = 0.5 * rho * torch.sum(vel ** 2, dim=0)
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
    rho, vel, p = primitives(U)
    c = torch.sqrt(GAMMA * torch.clamp(p, min=1e-8) / rho)
    div = torch.zeros_like(U)
    for axis in range(3):
        sp = torch.abs(vel[axis]) + c
        F = _flux(U, axis)
        ax = axis + 1
        Up = torch.roll(U, -1, dims=ax)
        Fp = torch.roll(F, -1, dims=ax)
        a = torch.maximum(sp, torch.roll(sp, -1, dims=axis))
        Fface_hi = 0.5 * (F + Fp) - 0.5 * a[None] * (Up - U)
        Fface_lo = torch.roll(Fface_hi, 1, dims=ax)
        div = div + (Fface_hi - Fface_lo) / dx
    return div


def step(U: torch.Tensor, dt: float) -> torch.Tensor:
    """One RK2 (Heun) step of size ``dt``."""
    dx = 1.0 / U.shape[-1]
    k1 = -_rusanov_div(U, dx)
    U1 = U + dt * k1
    k2 = -_rusanov_div(U1, dx)
    return U + 0.5 * dt * (k1 + k2)


def cfl_dt(U: torch.Tensor, cfl: float) -> float:
    """The largest stable step for the unsplit 3D update at Courant number
    ``cfl``: ``cfl dx / (3 max(|u| + c))``."""
    rho, vel, p = primitives(U)
    c = torch.sqrt(GAMMA * torch.clamp(p, min=1e-8) / rho)
    smax = float(torch.max(torch.abs(vel) + c[None]))
    return cfl * (1.0 / U.shape[-1]) / (3.0 * smax)


def qoi_fields(U: torch.Tensor, qois) -> dict[str, torch.Tensor]:
    """The quantities snapshotted, each a fresh float32 tensor on the
    state's device: ``p`` (pressure), ``rho`` (density)."""
    rho, _vel, p = primitives(U)
    have = {"p": p, "rho": rho.clone()}
    return {q: have[q] for q in qois}
