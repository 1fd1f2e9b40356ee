"""PyTorch/CUDA port of the CubismZ-style compression framework (``repro``).

The package mirrors ``repro``'s module layout (``core/``, ``kernels/``,
``fields/``, ``launch/``) so each module's counterpart is found under the
same relative path.  It imports neither JAX nor anything of ``repro``: what
it needs from there is copied.

Entry points take an explicit torch ``device``; the card is the default.
Asking for ``"cuda"`` on a machine without a GPU raises ``RuntimeError`` —
the port never quietly runs on the CPU.  Tests pass ``device="cpu"``, which
runs every kernel's plain PyTorch version instead of the kernel.
"""
from __future__ import annotations

__all__ = ["DEFAULT_DEVICE"]

#: device every entry point uses unless the caller names another
DEFAULT_DEVICE = "cuda"
