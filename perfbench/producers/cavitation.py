"""The ex-situ cell's data: a frozen copy of the repository's synthetic
cloud-cavitation snapshot (the paper's Table 1 cloud: 70 bubbles with
lognormal radii placed uniformly in a sphere, collapsing near t = 7 us and
rebounding, each collapse sending out a pressure shock), in plain torch on
the card.

The bubble cloud is the paper's, drawn as the repository draws it (numpy,
``cloud_seed``).  The band-limited background noise of p and rho is drawn
from the run's seed with a ``torch.Generator`` on the card, so each seed
gives another snapshot of the same cloud at the same time, of the same
size and statistics.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["QOIS", "bubble_cloud", "cavitation_fields"]

QOIS = ("p", "rho", "E", "a2")
_T_COLLAPSE = 7.0


def _lowpass_noise(n: int, seed: int, device, cutoff: float = 0.08) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    white = torch.randn((n, n, n), generator=gen, device=device, dtype=torch.float32)
    F = torch.fft.rfftn(white)
    del white
    f64 = dict(dtype=torch.float64, device=device)
    kx = torch.fft.fftfreq(n, **f64)[:, None, None]
    ky = torch.fft.fftfreq(n, **f64)[None, :, None]
    kz = torch.fft.rfftfreq(n, **f64)[None, None, :]
    filt = torch.exp(-((torch.sqrt(kx ** 2 + ky ** 2 + kz ** 2) / cutoff) ** 2))
    F = F * filt.to(torch.float32)
    out = torch.fft.irfftn(F, s=(n, n, n), dim=(0, 1, 2))
    return out / (float(out.double().std(correction=0)) + 1e-12)


def bubble_cloud(n_bubbles: int, cloud_radius: float, r_mean: float, r_sigma: float,
                 cloud_seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The paper's cloud: ``n_bubbles`` centres uniform in a sphere of
    ``cloud_radius`` about the box's middle, and lognormal radii (float32)."""
    rng = np.random.default_rng(cloud_seed)
    u = rng.standard_normal((n_bubbles, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    rad = cloud_radius * rng.uniform(0, 1, n_bubbles) ** (1 / 3)
    centers = 0.5 + u * rad[:, None]
    radii = rng.lognormal(np.log(r_mean), r_sigma, n_bubbles)
    return centers.astype(np.float32), radii.astype(np.float32)


def _radius_at(r0: np.ndarray, dist_c: np.ndarray, t: float):
    tc = _T_COLLAPSE * (0.75 + 0.5 * (1.0 - dist_c))
    x = np.clip(1.0 - (t / tc) ** 2, 0.0, None) ** (1.0 / 3.0)
    rebound = 0.35 * np.clip((t - tc) / (0.45 * tc), 0.0, 1.0) ** 0.5
    R = r0 * np.maximum(x, rebound)
    return np.maximum(R, 0.02 * r0), tc


def cavitation_fields(cfg: dict, t: float, seed: int, device) -> dict[str, torch.Tensor]:
    """The QoI snapshot at time ``t`` (us): float32 ``(n, n, n)`` tensors
    p, rho, E and a2 (the gas fraction) on ``device``.  ``cfg`` holds the
    cloud's sizes (the configuration file's ``cloud``)."""
    n = int(cfg["n"])
    gamma, p_amb, p_min = cfg["gamma"], cfg["p_ambient"], cfg["p_min"]
    rho_l, rho_g, cs, shock_amp = (cfg["rho_liquid"], cfg["rho_gas"], cfg["sound_speed"],
                                   cfg["shock_amp"])
    centers, radii = bubble_cloud(cfg["n_bubbles"], cfg["cloud_radius"], cfg["r_mean"],
                                  cfg["r_sigma"], cfg["cloud_seed"])
    dist_c = np.linalg.norm(centers - 0.5, axis=1) / cfg["cloud_radius"]
    R, tc = _radius_at(radii, np.clip(dist_c, 0, 1), t)

    ax = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    X, Y, Z = ax[:, None, None], ax[None, :, None], ax[None, None, :]
    iw = 1.5 / n
    a2 = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    p_gas = torch.zeros_like(a2)
    shock = torch.zeros_like(a2)
    for c, r0, r, tci in zip(centers, radii, R, tc):
        d = torch.sqrt((X - float(c[0])) ** 2 + (Y - float(c[1])) ** 2 + (Z - float(c[2])) ** 2)
        chi = 0.5 * (1.0 - torch.tanh((d - float(r)) / iw))
        a2 = a2 + chi - a2 * chi
        pg = (p_min * 0.5) * (r0 / r) ** (3 * (gamma - 1) * 0.35)
        p_gas += chi * float(pg)
        if t > tci:
            front = (t - tci) * cs
            strength = shock_amp * (r0 / cfg["r_mean"]) ** 1.5
            fade = np.exp(-(((t - tci) / 1.0) ** 2))
            amp = strength * fade / (1.0 + 12.0 * front)
            if amp > 1e-3:
                shock += float(amp) * torch.exp(-(((d - float(front)) / (2.5 * iw)) ** 2))
            wake = 0.04 * strength / (1.0 + 30.0 * (t - tci) ** 2)
            if wake > 1e-4:
                shock += float(wake) * torch.exp(-((d / float(front + 0.08)) ** 2))
    a2 = torch.clamp(a2, 0.0, 1.0)
    bg = _lowpass_noise(n, seed, device)
    p = p_amb * (1.0 + 2e-5 * bg) - (p_amb - p_min) * a2 + p_gas * a2 + shock
    p = torch.clamp(p, min=p_min)
    rho = rho_l * (1.0 + 2e-5 * bg) * (1.0 - a2) + rho_g * a2 * (
        1.0 + 0.5 * torch.clamp(shock / shock_amp, 0, 1))
    kin = 0.5 * rho * (0.02 * cs * shock / p_amb) ** 2
    E = p / (gamma - 1.0) + 0.12 * rho + kin
    return {"p": p, "rho": rho, "E": E, "a2": a2}
