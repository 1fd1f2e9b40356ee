"""Wavelet + threshold scheme, the paper's compressor (port of
``repro.core.schemes.wavelet``).

Stage 1: 3D wavelet transform per block, significance mask at |c| >= eps,
optional Z4/Z8 low-bit zeroing of detail coefficients.  Byte layout per
chunk, identical to the reference: per-block detail counts (u32), packed
significance bitmask, then the coarse corner + significant details as one
shuffled float32 stream.

The blocks stay on their device through the forward transform and the
selection (``ops.wavelet_pack``: counts, packed mask, coarse corners and
the stream of significant details; trace span ``stage1.transform``).  Only
those four come to the host (``stage1.to_host``, their bytes in
``cz_copy_bytes_total``), and serialize cuts each chunk's bytes out of them
by slicing.  On the card both spans carry the card's time.  On decode each
chunk's coefficients go to the device for the inverse transform.  On a CUDA
device the transforms and the selection are the hand-written kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _obs as kobs
from repro_torch.kernels import ops

from .. import shuffle as shuf
from .. import wavelets
from . import Scheme, register_scheme, shuffle_bytes, unshuffle_bytes


@register_scheme
class WaveletScheme(Scheme):
    name = "wavelet"
    device_capable = True

    #: conformance contract: |x - xhat| <= BOUND_FACTOR * eps (the
    #: reference's factor: thresholding at |c| < eps amplifies through the
    #: synthesis stencils across levels)
    BOUND_FACTOR = 100.0

    def validate(self, spec) -> None:
        if spec.wavelet not in wavelets.WAVELETS:
            raise ValueError(f"unknown wavelet {spec.wavelet}")

    def params(self, spec) -> dict:
        return {"wavelet": spec.wavelet, "eps": spec.eps,
                "levels": spec.levels, "zero_bits": spec.zero_bits,
                **super().params(spec)}

    def error_bound(self, spec) -> float:
        return self.BOUND_FACTOR * spec.eps

    def check(self, blocks, spec) -> None:
        # the reference validates the level count only in its transform
        wavelets.default_levels(spec.block_size, spec.levels)

    def stage1(self, blocks, spec):
        self.check(blocks, spec)
        with kobs.device_span("stage1.transform", blocks.device):
            x = blocks.to(torch.float32).contiguous()
            coeffs = ops.wavelet_forward(x, kind=spec.wavelet, levels=spec.levels)
            packed = ops.wavelet_pack(coeffs, spec.eps, spec.levels)
        with kobs.device_span("stage1.to_host", blocks.device):
            for t in packed:
                kobs.count_copy(t, "cpu", "stage1.to_host")
            counts, bits, coarse, details = (t.cpu().numpy() for t in packed)
        counts = counts.view(np.uint32)
        return {
            "counts": counts,
            "packed": bits,
            "coarse": coarse,
            "details": details,
            # block b's details start at offsets[b]
            "offsets": np.concatenate([[0], np.cumsum(counts, dtype=np.int64)]),
        }

    def serialize(self, s1, lo, hi, spec) -> bytes:
        counts = s1["counts"]
        lo, hi, _ = slice(lo, hi).indices(len(counts))  # numpy's reading of [lo:hi]
        details = s1["details"][s1["offsets"][lo]:s1["offsets"][hi]]
        if spec.zero_bits:
            details = shuf.zero_low_bits_np(details, spec.zero_bits)
        values = np.concatenate([s1["coarse"][lo:hi].reshape(-1), details])
        return (
            counts[lo:hi].tobytes()
            + s1["packed"][lo:hi].tobytes()
            + shuffle_bytes(values.tobytes(), spec.shuffle, 4)
        )

    def deserialize(self, payload, nblk, spec, device):
        n = spec.block_size
        c = wavelets.coarse_side(n, spec.levels)
        off = 4 * nblk  # skip per-block counts (redundant with the mask)
        mask_bytes = nblk * n * n * n // 8
        mask = np.unpackbits(np.frombuffer(payload[off : off + mask_bytes], np.uint8))
        mask = mask[: nblk * n * n * n].astype(bool).reshape(nblk, n, n, n)
        off += mask_bytes
        values = np.frombuffer(
            unshuffle_bytes(payload[off:], spec.shuffle, 4), np.float32
        )
        ncoarse = nblk * c * c * c
        coarse = values[:ncoarse].reshape(nblk, c, c, c)
        details = values[ncoarse:]
        coeffs = np.zeros((nblk, n, n, n), np.float32)
        coeffs[mask] = details
        coeffs[:, :c, :c, :c] = coarse
        x = torch.from_numpy(coeffs).to(device)
        return ops.wavelet_inverse(x, kind=spec.wavelet, levels=spec.levels).cpu().numpy()
