"""Synthetic cloud-cavitation QoI fields (p, rho, E, alpha2), computed on
the device (port of ``repro.fields.cavitation``).

A cloud of bubbles with lognormal radii placed uniformly in a sphere inside
a cubic domain, evolved through collapse (pressure shocks emitted around
t_c ~ 7 us) and rebound; statistics follow the paper's Table 1.

Every random draw is the reference's: the bubble cloud and the white noise
come from ``np.random.default_rng`` with the same seeds, in the same order.
The ``(n, n, n)`` math — the bubble loop, ``tanh``/``exp``, the spectral
low-pass filter and the QoI formulas — runs in torch float32 on the device,
so a 512^3 snapshot takes seconds on the card instead of minutes in numpy.
Results agree with the numpy generator to float32 rounding: the
transcendentals and the FFT round differently on each backend.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.schemes import torch_device

__all__ = ["CloudConfig", "cavitation_fields", "QOIS", "PAPER_TIMES"]

QOIS = ("p", "rho", "E", "a2")
# Paper snapshots: 5k steps (pre-collapse) and 10k steps (post-collapse peak).
PAPER_TIMES = {"5k": 4.7, "10k": 9.4}
_T_COLLAPSE = 7.0  # us, paper: "peak of the collapse happens around t = 7 us"


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    n: int = 128                # grid points per side
    n_bubbles: int = 70         # paper: 70-bubble cloud for 512^3
    cloud_radius: float = 0.35  # fraction of domain side
    r_mean: float = 0.035       # lognormal mean bubble radius (domain units)
    r_sigma: float = 0.35       # lognormal sigma
    seed: int = 1234
    gamma: float = 1.4
    p_ambient: float = 100.0
    p_min: float = 49.0
    rho_liquid: float = 1000.0
    rho_gas: float = 16.0
    sound_speed: float = 0.12   # domain units / us
    shock_amp: float = 1500.0


def _lowpass_noise(n: int, rng: np.random.Generator, device: torch.device,
                   cutoff: float = 0.08) -> torch.Tensor:
    """Band-limited unit-variance noise via spectral truncation; the white
    noise is the reference's draw, the filter runs on ``device``."""
    white = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))
    F = torch.fft.rfftn(white.to(device))
    f64 = dict(dtype=torch.float64, device=device)
    kx = torch.fft.fftfreq(n, **f64)[:, None, None]
    ky = torch.fft.fftfreq(n, **f64)[None, :, None]
    kz = torch.fft.rfftfreq(n, **f64)[None, None, :]
    k = torch.sqrt(kx**2 + ky**2 + kz**2)
    # numpy multiplies the complex64 spectrum by the float64 filter in
    # complex128 and rounds once; do the same
    F = (F.to(torch.complex128) * torch.exp(-((k / cutoff) ** 2))).to(torch.complex64)
    out = torch.fft.irfftn(F, s=(n, n, n), dim=(0, 1, 2))
    return out / (float(out.double().std(correction=0)) + 1e-12)


def _bubbles(cfg: CloudConfig) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(cfg.seed)
    # uniform in a sphere
    u = rng.standard_normal((cfg.n_bubbles, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    rad = cfg.cloud_radius * rng.uniform(0, 1, cfg.n_bubbles) ** (1 / 3)
    centers = 0.5 + u * rad[:, None]
    radii = rng.lognormal(np.log(cfg.r_mean), cfg.r_sigma, cfg.n_bubbles)
    return centers.astype(np.float32), radii.astype(np.float32)


def _radius_at(r0: np.ndarray, dist_c: np.ndarray, t: float) -> tuple[np.ndarray, np.ndarray]:
    """Rayleigh-like collapse + rebound; outer bubbles collapse first.

    Returns (R(t), t_collapse per bubble)."""
    tc = _T_COLLAPSE * (0.75 + 0.5 * (1.0 - dist_c))  # outer (dist_c~1) earlier
    x = np.clip(1.0 - (t / tc) ** 2, 0.0, None) ** (1.0 / 3.0)
    rebound = 0.35 * np.clip((t - tc) / (0.45 * tc), 0.0, 1.0) ** 0.5
    R = r0 * np.maximum(x, rebound)
    return np.maximum(R, 0.02 * r0), tc


def cavitation_fields(cfg: CloudConfig = CloudConfig(), t: float = 4.7,
                      device=DEFAULT_DEVICE) -> dict[str, torch.Tensor]:
    """QoI snapshot at time ``t`` (microseconds): float32 (n, n, n) tensors
    on ``device``.  Per-bubble scalars are computed on the host in numpy
    float32 exactly as the reference computes them."""
    dev = torch_device(device)
    n = cfg.n
    rng = np.random.default_rng(cfg.seed + int(t * 1000))
    centers, radii = _bubbles(cfg)
    dist_c = np.linalg.norm(centers - 0.5, axis=1) / cfg.cloud_radius
    R, tc = _radius_at(radii, np.clip(dist_c, 0, 1), t)

    ax = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
    X = ax[:, None, None]
    Y = ax[None, :, None]
    Z = ax[None, None, :]
    iw = 1.5 / n  # interface width

    a2 = torch.zeros((n, n, n), dtype=torch.float32, device=dev)
    p_gas = torch.zeros_like(a2)
    shock = torch.zeros_like(a2)
    cs_t = cfg.sound_speed

    for c, r0, r, tci in zip(centers, radii, R, tc):
        d = torch.sqrt((X - float(c[0])) ** 2 + (Y - float(c[1])) ** 2
                       + (Z - float(c[2])) ** 2)
        chi = 0.5 * (1.0 - torch.tanh((d - float(r)) / iw))  # 1 inside bubble
        a2 = a2 + chi - a2 * chi                               # fuzzy union
        # adiabatic gas pressure rises as the bubble shrinks
        pg = (cfg.p_min * 0.5) * (r0 / r) ** (3 * (cfg.gamma - 1) * 0.35)
        p_gas += chi * float(pg)
        # outward shock annulus after this bubble's collapse; the front fades
        # as it propagates and leaves a smooth elevated-pressure wake behind
        if t > tci:
            front = (t - tci) * cs_t
            strength = cfg.shock_amp * (r0 / cfg.r_mean) ** 1.5
            fade = np.exp(-(((t - tci) / 1.0) ** 2))
            amp = strength * fade / (1.0 + 12.0 * front)
            if amp > 1e-3:
                shock += float(amp) * torch.exp(-(((d - float(front)) / (2.5 * iw)) ** 2))
            wake = 0.04 * strength / (1.0 + 30.0 * (t - tci) ** 2)
            if wake > 1e-4:
                shock += float(wake) * torch.exp(-((d / float(front + 0.08)) ** 2))

    a2 = torch.clamp(a2, 0.0, 1.0)
    bg = _lowpass_noise(n, rng, dev)
    p = cfg.p_ambient * (1.0 + 2e-5 * bg) - (cfg.p_ambient - cfg.p_min) * a2 + p_gas * a2 + shock
    p = torch.clamp(p, min=cfg.p_min)

    rho = cfg.rho_liquid * (1.0 + 2e-5 * bg) * (1.0 - a2) + cfg.rho_gas * a2 * (
        1.0 + 0.5 * torch.clamp(shock / cfg.shock_amp, 0, 1)
    )

    # stiffened-gas-flavoured total energy + kinetic contribution near shocks
    kin = 0.5 * rho * (0.02 * cfg.sound_speed * shock / (cfg.p_ambient)) ** 2
    E = p / (cfg.gamma - 1.0) + 0.12 * rho + kin

    return {"p": p, "rho": rho, "E": E, "a2": a2}
