"""Hand-written Hopper kernels of the port, built from ``csrc/`` at first use.

``ops`` is the public entry point, and its seven wrappers are re-exported
here; ``wavelet3d``, ``wavelet_pack``, ``zfp_transform`` and ``lorenzo``
hold the wrappers, their launch counts and the source notes; ``_obs`` the
wrappers' call metrics; ``ref`` the plain versions under the reference's
oracle names.
"""
from .ops import (  # noqa: F401
    lorenzo_decode,
    lorenzo_encode,
    wavelet_forward,
    wavelet_inverse,
    wavelet_pack,
    zfpx_decode,
    zfpx_encode,
)

__all__ = ["wavelet_forward", "wavelet_inverse", "wavelet_pack", "zfpx_encode",
           "zfpx_decode", "lorenzo_encode", "lorenzo_decode"]
