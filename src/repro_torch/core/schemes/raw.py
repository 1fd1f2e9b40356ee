"""Identity scheme (port of ``repro.core.schemes.raw``): blocks passed
straight to shuffle + stage 2, in the spec's dtype, so a round trip is
bit-exact and a container's bytes match the reference's byte for byte.
"""
from __future__ import annotations

import numpy as np

from . import Scheme, register_scheme, shuffle_bytes, unshuffle_bytes


@register_scheme
class RawScheme(Scheme):
    name = "raw"

    def stage1(self, blocks, spec):
        return {"raw": blocks.cpu().numpy().astype(spec.np_dtype, copy=False)}

    def serialize(self, s1, lo, hi, spec) -> bytes:
        dt = spec.np_dtype
        buf = s1["raw"][lo:hi].astype(dt, copy=False).tobytes()
        return shuffle_bytes(buf, spec.shuffle, dt.itemsize)

    def deserialize(self, payload, nblk, spec, device):
        n = spec.block_size
        dt = spec.np_dtype
        raw = np.frombuffer(unshuffle_bytes(payload, spec.shuffle, dt.itemsize),
                            dt)
        return raw.reshape(nblk, n, n, n).copy()
