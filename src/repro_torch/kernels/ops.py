"""Public kernel entry points (port of ``repro.kernels.ops``).

The reference wraps each Pallas kernel in ``jax.jit`` and compile/execute
metrics.  PyTorch runs eagerly and this slice carries no metrics, so these
are the kernel wrappers themselves: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs its plain PyTorch version.
"""
from __future__ import annotations

from .lorenzo import lorenzo_decode, lorenzo_encode
from .wavelet3d import wavelet3d_forward as wavelet_forward
from .wavelet3d import wavelet3d_inverse as wavelet_inverse
from .zfp_transform import zfpx_decode, zfpx_encode

__all__ = ["wavelet_forward", "wavelet_inverse", "zfpx_encode", "zfpx_decode",
           "lorenzo_encode", "lorenzo_decode"]
