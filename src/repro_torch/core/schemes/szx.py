"""SZ-style scheme (port of ``repro.core.schemes.szx``): Lorenzo-predicted
residuals, int8 stream + int32 outliers.

Byte layout per chunk, identical to the reference: outlier count (u32), the
int8 residual stream (value -128 marks an escaped outlier), then the
shuffled int32 outlier values.

Format note: container format 1 wrote the outlier stream *unshuffled*
(``spec.shuffle`` was silently ignored for szx); format 2 shuffles it like
every other scheme.  :meth:`decode_spec` keeps v1 payloads reading
bit-exact.

Like the reference's, this scheme has no kernel of its own
(``device_capable = False``, and headers record ``"host"``): stage 1 and
decode run the plain :func:`repro_torch.core.szx.encode` / ``decode`` as
torch ops on the batch's device, as the reference's jnp math runs wherever
JAX places the array.  The ``lorenzo`` scheme is the one with the kernel;
its residuals are the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import szx as _szx
from . import Scheme, register_scheme, shuffle_bytes, unshuffle_bytes


@register_scheme
class SzxScheme(Scheme):
    name = "szx"

    def params(self, spec) -> dict:
        return {"eps": spec.eps, **super().params(spec)}

    def error_bound(self, spec) -> float:
        return spec.eps

    def decode_spec(self, spec, fmt: int):
        if fmt < 2 and spec.shuffle != "none":
            return dataclasses.replace(spec, shuffle="none")
        return spec

    def check(self, blocks, spec) -> None:
        _szx.check_eps(float(blocks.to(torch.float32).abs().max()), spec.eps)

    def stage1(self, blocks, spec):
        x = blocks.to(torch.float32)
        self.check(x, spec)
        return {"res": _szx.encode(x, eps=spec.eps).cpu().numpy()}

    def serialize(self, s1, lo, hi, spec) -> bytes:
        r = s1["res"][lo:hi].reshape(-1)
        small = np.abs(r) <= 127
        stream = np.where(small, r, -128).astype(np.int8)
        outliers = r[~small].astype(np.int32)
        return (
            np.uint32(outliers.size).tobytes()
            + stream.tobytes()
            + shuffle_bytes(outliers.tobytes(), spec.shuffle, 4)
        )

    def deserialize(self, payload, nblk, spec, device):
        n = spec.block_size
        n_out = int(np.frombuffer(payload[:4], np.uint32)[0])
        nvals = nblk * n * n * n
        stream = np.frombuffer(payload[4 : 4 + nvals], np.int8)
        outliers = np.frombuffer(
            unshuffle_bytes(payload[4 + nvals : 4 + nvals + 4 * n_out],
                            spec.shuffle, 4),
            np.int32,
        )
        r = stream.astype(np.int32)
        esc = stream == -128
        r[esc] = outliers
        r = torch.from_numpy(r.reshape(nblk, n, n, n)).to(device)
        return _szx.decode(r, eps=spec.eps).cpu().numpy()
