"""``zfpx`` — ZFP-style fixed-accuracy transform codec (port of
``repro.core.zfpx``).

Keeps ZFP's structure (Lindstrom 2014): 4x4x4 cells; block-floating-point
with a common max exponent ``emax`` per cell and fixed-point quantization
``q = round(x * 2^(SCALE_BITS - emax))`` into int32; the range-contracting
ZFP integer lifting along each axis; total-sequency coefficient order; and
bit-plane truncation derived from the absolute tolerance ``eps``.  The
truncation shift is a deterministic function of ``(emax, eps)``, so only
``emax`` and the truncated coefficients travel.

:func:`encode` and :func:`decode` are the plain PyTorch version of the
hand-written kernels in :mod:`repro_torch.kernels.zfp_transform`: the CPU
path runs them, and the card compares the kernels against them.

The reference is integer-exact across devices, and so is this port, under
the reference's float semantics, which are XLA's:

* subnormal float32 values are read as zero (in ``amax`` and in the cells)
  and subnormal results are flushed to a zero of the same sign (the decode
  scale and the decoded values);
* float -> int32 conversion saturates, and maps NaN to 0.  A cell with
  ``emax < -99`` has an infinite scale, so its ``q`` holds saturated values
  (and 0 where ``0 * inf`` is NaN);
* int32 arithmetic wraps in two's complement, and ``>>`` is arithmetic;
* ``exp2`` of an integer is not ``2^k`` but XLA's ``exp(k ln 2)``, kept
  here as a table (:data:`_EXP2_BITS`).

torch on neither device flushes subnormals nor saturates, so both are
written out here (:mod:`._xla`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ._xla import flush, to_int32

__all__ = [
    "SCALE_BITS",
    "sequency_perm",
    "encode",
    "decode",
    "fwd_lift_cell",
    "inv_lift_cell",
]

SCALE_BITS = 28          # q = round(x * 2^(SCALE_BITS - emax)); |q| <= 2^28
_GUARD_BITS = 2          # transform error guard when converting eps -> planes
_ZERO_EMAX = -127        # emax marker for all-zero cells


@functools.lru_cache(maxsize=None)
def sequency_perm() -> np.ndarray:
    """Permutation ordering 4^3 coefficients by total sequency i+j+k."""
    idx = np.arange(64)
    i, j, k = idx // 16, (idx // 4) % 4, idx % 4
    order = np.lexsort((k, j, i, i + j + k))
    return order.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _perm(device: torch.device, inverse: bool) -> torch.Tensor:
    p = sequency_perm()
    if inverse:
        p = np.argsort(p)
    return torch.from_numpy(p.astype(np.int64)).to(device)


def _lift4(x, y, z, w):
    """ZFP forward lifting of a 4-vector (int32, range-contracting)."""
    x = x + w; x = x >> 1; w = w - x
    z = z + y; z = z >> 1; y = y - z
    x = x + z; x = x >> 1; z = z - x
    w = w + y; w = w >> 1; y = y - w
    w = w + (y >> 1); y = y - (w >> 1)
    return x, y, z, w


def _unlift4(x, y, z, w):
    y = y + (w >> 1); w = w - (y >> 1)
    y = y + w; w = w << 1; w = w - y
    z = z + x; x = x << 1; x = x - z
    y = y + z; z = z << 1; z = z - y
    w = w + x; x = x << 1; x = x - w
    return x, y, z, w


def _apply_axis(cells, axis, fn):
    c = torch.movedim(cells, axis, -1)
    out = torch.stack(fn(c[..., 0], c[..., 1], c[..., 2], c[..., 3]), dim=-1)
    return torch.movedim(out, -1, axis)


def fwd_lift_cell(cells: torch.Tensor) -> torch.Tensor:
    """Forward 3D lifting over trailing (4,4,4) axes of an int32 tensor."""
    for ax in (-3, -2, -1):
        cells = _apply_axis(cells, ax, _lift4)
    return cells


def inv_lift_cell(cells: torch.Tensor) -> torch.Tensor:
    for ax in (-1, -2, -3):
        cells = _apply_axis(cells, ax, _unlift4)
    return cells


def _to_cells(blocks: torch.Tensor) -> torch.Tensor:
    b, n = blocks.shape[0], blocks.shape[-1]
    m = n // 4
    c = blocks.reshape(b, m, 4, m, 4, m, 4)
    c = c.permute(0, 1, 3, 5, 2, 4, 6)
    return c.reshape(b, m * m * m, 4, 4, 4)


def _from_cells(cells: torch.Tensor, n: int) -> torch.Tensor:
    b = cells.shape[0]
    m = n // 4
    c = cells.reshape(b, m, m, m, 4, 4, 4)
    c = c.permute(0, 1, 4, 2, 5, 3, 6)
    return c.reshape(b, n, n, n)


def log_eps(eps: float) -> int:
    """``floor(log2 eps)``, in float64 on the host; -126 for ``eps <= 0``."""
    return int(np.floor(np.log2(eps))) if eps > 0 else -126


def _drop_bits(emax: torch.Tensor, eps: float) -> torch.Tensor:
    """Truncation shift per cell: deterministic in (emax, eps)."""
    # grid unit is 2^(emax - SCALE_BITS); dropping p planes errs <= ~2^p units.
    p = log_eps(eps) - (emax - SCALE_BITS) - _GUARD_BITS
    return p.clamp(0, 31)


#: float32 bits of the reference's ``exp2(k)`` for the integers k = -127 .. 128,
#: as XLA evaluates it on the CPU: ``exp(k * 0.693147182)``, which misses
#: 2^k by up to 67 ulp at 220 of these k, gives 0 at k <= -126 (flushed)
#: and ``inf`` at 128.  Below the table the scale is 0, above it ``inf``.
#: ``tests/test_torch_zfpx.py`` holds the table against ``jnp.exp2``.
_EXP2_BITS = np.array([
    0x00000000, 0x00000000, 0x0100001a, 0x0180000e, 0x02000002, 0x027fffec, 0x02ffffd4, 0x0380001e,
    0x04000012, 0x04800006, 0x04fffff4, 0x057fffdc, 0x05ffffc4, 0x06800016, 0x0700000a, 0x077ffffc,
    0x07ffffe4, 0x087fffcc, 0x0900001a, 0x0980000e, 0x0a000002, 0x0a7fffed, 0x0affffd5, 0x0b7fffbd,
    0x0c000012, 0x0c800006, 0x0cfffff5, 0x0d7fffdd, 0x0dffffc5, 0x0e800016, 0x0f00000a, 0x0f7ffffd,
    0x0fffffe5, 0x107fffcd, 0x1100001b, 0x1180000f, 0x12000003, 0x127fffed, 0x1300000b, 0x137ffffd,
    0x13ffffe5, 0x14800007, 0x14fffff5, 0x157fffdd, 0x16000003, 0x167fffed, 0x1700000b, 0x177ffffd,
    0x17ffffe5, 0x18800007, 0x18fffff6, 0x1980000f, 0x1a000003, 0x1a7fffee, 0x1b00000b, 0x1b7ffffe,
    0x1bffffe6, 0x1c800007, 0x1cfffff6, 0x1d7fffde, 0x1e000003, 0x1e7fffee, 0x1f00000b, 0x1f7ffffe,
    0x1fffffe6, 0x20800007, 0x20fffff6, 0x2180000f, 0x22000003, 0x227fffee, 0x2300000b, 0x237ffffe,
    0x23ffffe6, 0x24800007, 0x24fffff6, 0x257fffde, 0x26000003, 0x267fffee, 0x2700000b, 0x277ffffe,
    0x27ffffe6, 0x28800007, 0x28fffff7, 0x297fffff, 0x2a000003, 0x2a7fffef, 0x2afffff7, 0x2b7fffff,
    0x2c000003, 0x2c800007, 0x2cfffff7, 0x2d7fffff, 0x2e000003, 0x2e7fffef, 0x2efffff7, 0x2f7fffff,
    0x30000004, 0x30800008, 0x30fffff7, 0x317fffff, 0x32000004, 0x327fffef, 0x32fffff7, 0x337fffff,
    0x34000004, 0x347fffff, 0x34fffff7, 0x357fffff, 0x36000004, 0x367fffff, 0x36fffff7, 0x377fffff,
    0x38000004, 0x38800000, 0x38fffff8, 0x39800000, 0x3a000000, 0x3a800000, 0x3b000000, 0x3b800000,
    0x3c000000, 0x3c800000, 0x3d000000, 0x3d800000, 0x3e000000, 0x3e800000, 0x3f000000, 0x3f800000,
    0x40000000, 0x40800000, 0x41000000, 0x41800000, 0x42000000, 0x42800000, 0x43000000, 0x43800000,
    0x44000000, 0x44800000, 0x45000000, 0x45800000, 0x46000004, 0x46800000, 0x46fffff8, 0x47800000,
    0x48000004, 0x48800000, 0x48fffff9, 0x49800000, 0x4a000004, 0x4a800000, 0x4afffff9, 0x4b800000,
    0x4c000004, 0x4c800008, 0x4cfffff9, 0x4d800000, 0x4e000004, 0x4e7ffff1, 0x4efffff9, 0x4f800001,
    0x50000005, 0x50800009, 0x50fffff9, 0x51800001, 0x52000005, 0x527ffff1, 0x52fffff9, 0x53800001,
    0x54000005, 0x54800009, 0x54fffff9, 0x55800001, 0x56000005, 0x567ffff1, 0x5700000d, 0x57800001,
    0x57ffffea, 0x58800009, 0x58fffffa, 0x59800011, 0x5a000005, 0x5a7ffff2, 0x5b00000d, 0x5b800001,
    0x5bffffea, 0x5c800009, 0x5cfffffa, 0x5d7fffe2, 0x5e000005, 0x5e7ffff2, 0x5f00000d, 0x5f800001,
    0x5fffffea, 0x60800009, 0x60fffffa, 0x61800011, 0x62000005, 0x627ffff2, 0x6300000d, 0x63800001,
    0x63ffffea, 0x64800009, 0x64fffffa, 0x657fffe2, 0x66000005, 0x667ffff2, 0x6700000d, 0x67800001,
    0x67ffffeb, 0x68800009, 0x68fffffb, 0x69800011, 0x6a000005, 0x6a7ffff3, 0x6b00000d, 0x6b800001,
    0x6bffffeb, 0x6c800009, 0x6cfffffb, 0x6d7fffe3, 0x6dffffcb, 0x6e80001a, 0x6f00000e, 0x6f800002,
    0x6fffffeb, 0x707fffd3, 0x7100001e, 0x71800012, 0x72000006, 0x727ffff3, 0x72ffffdb, 0x73800022,
    0x74000016, 0x7480000a, 0x74fffffb, 0x757fffe3, 0x75ffffcb, 0x7680001a, 0x7700000e, 0x77800002,
    0x77ffffec, 0x787fffd4, 0x7900001e, 0x79800012, 0x7a000006, 0x7a7ffff4, 0x7affffdc, 0x7b7fffc4,
    0x7c000016, 0x7c80000a, 0x7cfffffc, 0x7d7fffe4, 0x7dffffcc, 0x7e80001a, 0x7f00000e, 0x7f800000,
], np.uint32)
_EXP2_KMIN, _EXP2_KMAX = -127, 128


@functools.lru_cache(maxsize=None)
def exp2_table(device: torch.device) -> torch.Tensor:
    """:data:`_EXP2_BITS` as a float32 tensor on ``device``."""
    return torch.from_numpy(_EXP2_BITS.view(np.float32).copy()).to(device)


def _exp2(k: torch.Tensor) -> torch.Tensor:
    """The reference's float32 ``exp2`` of an int32 tensor of integers."""
    idx = k.clamp(_EXP2_KMIN, _EXP2_KMAX) - _EXP2_KMIN
    return exp2_table(k.device)[idx.long()]


def encode(blocks: torch.Tensor, eps: float = 1e-3
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """blocks (B, n, n, n) float32 -> (emax (B, nc) int32, q (B, nc, 64) int32)."""
    cells = flush(_to_cells(blocks.to(torch.float32)))       # (B, nc, 4,4,4)
    amax = cells.abs().amax(dim=(-3, -2, -1))                  # (B, nc)
    _, e = torch.frexp(amax)                                   # amax = m * 2^e
    emax = torch.where(amax > 0, e, _ZERO_EMAX).to(torch.int32)
    scale = _exp2(SCALE_BITS - emax)
    q = to_int32(torch.round(cells * scale[..., None, None, None]))
    q = fwd_lift_cell(q)
    q = q.reshape(*q.shape[:-3], 64)[..., _perm(q.device, False)]
    p = _drop_bits(emax, eps)[..., None]
    q = torch.where(emax[..., None] == _ZERO_EMAX, 0, (q >> p) << p)
    return emax, q


def decode(emax: torch.Tensor, q: torch.Tensor, eps: float = 1e-3,
           n: int = 32) -> torch.Tensor:
    """Inverse of :func:`encode` -> (B, n, n, n) float32."""
    cells = q[..., _perm(q.device, True)].reshape(*q.shape[:-1], 4, 4, 4)
    cells = inv_lift_cell(cells)
    scale = _exp2(emax - SCALE_BITS)
    out = flush(cells.to(torch.float32) * scale[..., None, None, None])
    out = torch.where((emax == _ZERO_EMAX)[..., None, None, None], 0.0, out)
    return _from_cells(out, n)
