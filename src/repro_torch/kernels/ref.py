"""The kernels' oracles under the reference's names (port of
``repro.kernels.ref``): each is the plain PyTorch version that the CPU
runs and that the card holds its kernel against."""
from __future__ import annotations

import torch

from repro_torch.core import szx, wavelets, zfpx

__all__ = [
    "wavelet3d_forward_ref",
    "wavelet3d_inverse_ref",
    "zfpx_encode_ref",
    "zfpx_decode_ref",
    "lorenzo_encode_ref",
    "lorenzo_decode_ref",
]


def wavelet3d_forward_ref(blocks, kind="w3ai", levels=None):
    return wavelets.forward3d(torch.as_tensor(blocks, dtype=torch.float32), kind, levels)


def wavelet3d_inverse_ref(blocks, kind="w3ai", levels=None):
    return wavelets.inverse3d(torch.as_tensor(blocks, dtype=torch.float32), kind, levels)


def zfpx_encode_ref(blocks, eps=1e-3):
    return zfpx.encode(torch.as_tensor(blocks, dtype=torch.float32), eps=eps)


def zfpx_decode_ref(emax, q, eps=1e-3, n=32):
    return zfpx.decode(torch.as_tensor(emax), torch.as_tensor(q), eps=eps, n=n)


def lorenzo_encode_ref(blocks, eps=1e-3):
    return szx.encode(torch.as_tensor(blocks, dtype=torch.float32), eps=eps)


def lorenzo_decode_ref(residuals, eps=1e-3):
    return szx.decode(torch.as_tensor(residuals, dtype=torch.int32), eps=eps)
