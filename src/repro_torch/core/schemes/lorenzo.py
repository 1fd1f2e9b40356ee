"""Lorenzo-predictor scheme (port of ``repro.core.schemes.lorenzo``):
dual-quantized 3D Lorenzo residuals, int32 stream.

Stage 1 quantizes onto the 2*eps grid and takes the exact integer 3D
Lorenzo difference, the transform ``szx`` uses, but the byte layout keeps
the full int32 residual stream (shuffled, then stage-2 coded) instead of
szx's int8 + escape coding.

Stage 1 runs on the batch's device and brings the residuals to the host;
decode sends each chunk's residuals to the device.  On a CUDA device both
transforms are the hand-written kernels.  Their residuals and decoded bits
equal the plain version's, which equal the reference's, so containers
written on the card, on the CPU or by the reference decode to the same
bits.  The error bound ``|x - xhat| <= eps`` holds up to float32's own
spacing of ``max|x|`` (past ``|q| = 2^24`` the grid is coarser than 2 eps).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

from .. import szx as _szx
from . import Scheme, register_scheme, shuffle_bytes, unshuffle_bytes


@register_scheme
class LorenzoScheme(Scheme):
    name = "lorenzo"
    device_capable = True

    def validate(self, spec) -> None:
        if spec.eps <= 0:
            raise ValueError(
                "lorenzo requires eps > 0 (error-bounded lossy codec)")

    def params(self, spec) -> dict:
        return {"eps": spec.eps, **super().params(spec)}

    def error_bound(self, spec) -> float:
        return spec.eps

    def check(self, blocks, spec) -> None:
        _szx.check_eps(float(blocks.to(torch.float32).abs().max()), spec.eps)

    def stage1(self, blocks, spec):
        x = blocks.to(torch.float32).contiguous()
        self.check(x, spec)
        return {"res": ops.lorenzo_encode(x, eps=spec.eps).cpu().numpy()}

    def serialize(self, s1, lo, hi, spec) -> bytes:
        r = s1["res"][lo:hi].astype(np.int32, copy=False)
        return shuffle_bytes(r.tobytes(), spec.shuffle, 4)

    def deserialize(self, payload, nblk, spec, device):
        n = spec.block_size
        r = np.frombuffer(unshuffle_bytes(payload, spec.shuffle, 4),
                          np.int32).copy()  # writable: torch.from_numpy warns otherwise
        r = torch.from_numpy(r.reshape(nblk, n, n, n)).to(device)
        return ops.lorenzo_decode(r, eps=spec.eps).cpu().numpy()
