"""FPZIP-style lossless/near-lossless scheme (port of
``repro.core.schemes.fpzipx``): predictive delta coding of the monotone
ordered-uint map of float32, bit-exact at ``precision=32``.

Byte layout per chunk, identical to the reference: one shuffled u32 delta
stream.  Like the reference's, this scheme has no kernel of its own
(headers record ``"host"``): stage 1 and decode run
:func:`repro_torch.core.fpzipx.encode` / ``decode`` as torch ops on the
batch's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import fpzipx as _fpz
from . import Scheme, register_scheme, shuffle_bytes, unshuffle_bytes


@register_scheme
class FpzipxScheme(Scheme):
    name = "fpzipx"

    def validate(self, spec) -> None:
        if spec.dtype != "float32":
            raise ValueError(
                "fpzipx predicts on the float32 bit pattern; its lossless "
                f"guarantee does not hold for dtype={spec.dtype!r} — use the "
                "'raw' scheme for other dtypes")

    def params(self, spec) -> dict:
        return {"precision": spec.precision, **super().params(spec)}

    def error_bound(self, spec):
        # precision=32 is the lossless configuration; truncated-precision
        # error depends on value magnitudes, so no absolute bound is declared
        return None if spec.precision >= 32 else float("inf")

    def stage1(self, blocks, spec):
        x = blocks.to(torch.float32).contiguous()  # a trial's sample is strided
        delta = _fpz.encode(x, precision=spec.precision)
        return {"delta": delta.cpu().numpy().view(np.uint32)}

    def serialize(self, s1, lo, hi, spec) -> bytes:
        d = s1["delta"][lo:hi].astype(np.uint32)
        return shuffle_bytes(d.tobytes(), spec.shuffle, 4)

    def deserialize(self, payload, nblk, spec, device):
        n = spec.block_size
        d = np.frombuffer(unshuffle_bytes(payload, spec.shuffle, 4),
                          np.int32).copy()  # writable: torch.from_numpy warns otherwise
        d = torch.from_numpy(d.reshape(nblk, n, n, n)).to(device)
        return _fpz.decode(d).cpu().numpy()
