"""ZFP-style fixed-accuracy scheme (port of ``repro.core.schemes.zfpx``):
4^3 cells, block-floating-point + integer lifting.

Byte layout per chunk, identical to the reference: per-cell exponents (i8,
clipped to ±127) followed by the shuffled quantized-coefficient stream
(i32).

Stage 1 runs on the batch's device and brings ``emax`` and ``q`` to the
host; decode sends each chunk's streams to the device.  On a CUDA device
both transforms are the hand-written kernels.  Their integer streams equal
the plain version's, which equal the reference's, so containers written on
the card, on the CPU or by the reference decode to the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

from . import Scheme, register_scheme, shuffle_bytes, unshuffle_bytes


@register_scheme
class ZfpxScheme(Scheme):
    name = "zfpx"
    device_capable = True

    #: conformance contract: the eps-derived bit-plane truncation keeps the
    #: per-cell quantization error within a small multiple of eps (block
    #: floating point + lifting gain), as in the reference
    BOUND_FACTOR = 16.0

    def validate(self, spec) -> None:
        if spec.block_size % 4:
            raise ValueError("zfpx needs block_size % 4 == 0")

    def params(self, spec) -> dict:
        return {"eps": spec.eps, **super().params(spec)}

    def error_bound(self, spec) -> float:
        return self.BOUND_FACTOR * spec.eps

    def stage1(self, blocks, spec):
        x = blocks.to(torch.float32).contiguous()
        emax, q = ops.zfpx_encode(x, eps=spec.eps)
        return {"emax": emax.cpu().numpy(), "q": q.cpu().numpy()}

    def serialize(self, s1, lo, hi, spec) -> bytes:
        emax = np.clip(s1["emax"][lo:hi], -127, 127).astype(np.int8)
        q = s1["q"][lo:hi].astype(np.int32)
        return emax.tobytes() + shuffle_bytes(q.tobytes(), spec.shuffle, 4)

    def deserialize(self, payload, nblk, spec, device):
        n = spec.block_size
        nc = (n // 4) ** 3
        emax = np.frombuffer(payload[: nblk * nc], np.int8).astype(np.int32)
        q = np.frombuffer(unshuffle_bytes(payload[nblk * nc:], spec.shuffle, 4),
                          np.int32).copy()  # writable: torch.from_numpy warns otherwise
        emax = torch.from_numpy(emax.reshape(nblk, nc)).to(device)
        q = torch.from_numpy(q.reshape(nblk, nc, 64)).to(device)
        return ops.zfpx_decode(emax, q, eps=spec.eps, n=n).cpu().numpy()
