"""Where stage 1 runs (port of ``repro.core.schemes._device``).

The reference routes by the spec's ``device`` knob and falls back to its
host path, with a warning, when Pallas is missing.  The port routes by the
torch device the data lies on: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain PyTorch version (the kernel wrappers in
:mod:`repro_torch.kernels` make that choice themselves).  There is no
fallback: asking for ``"cuda"`` without a GPU raises.

``spec.device`` keeps the reference's words so that headers stay readable
by the reference, which validates them: ``"jax"`` records that stage 1 ran
on the scheme's kernel path, ``"host"`` that it ran on the plain path.  The
torch device itself is an argument, never a spec field.
"""
from __future__ import annotations

import torch

__all__ = ["DEVICES", "check_device", "torch_device", "resolved_device"]

#: devices a spec may record (validated everywhere, as in the reference)
DEVICES = ("host", "jax")


def check_device(device: str) -> None:
    """Raise ValueError on a device name outside :data:`DEVICES`."""
    if device not in DEVICES:
        raise ValueError(f"unknown device {device!r}; one of {DEVICES}")


def torch_device(device) -> torch.device:
    """The torch device an entry point runs on: ``"cuda"`` (the default of
    every entry point) or ``"cpu"``.  ``"cuda"`` without a usable GPU raises
    ``RuntimeError`` rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run the plain path")
    return dev


def resolved_device(device: torch.device, device_capable: bool) -> str:
    """What a header records for stage 1 on ``device``: ``"jax"`` when the
    scheme has a kernel path and the data is on the card, else ``"host"``."""
    return "jax" if device_capable and device.type == "cuda" else "host"
