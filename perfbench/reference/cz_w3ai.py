"""Plain reference of the paper's compressor and of its files: CubismZ's
default build (w3ai wavelets on 32^3 blocks, threshold at eps, byte
shuffle, zlib, 4 MB chunks), and the CZ2 container and dataset manifest
that hold it.

It imports nothing of the program under test and takes nothing it made
but the files it judges: it parses the container's footer and chunk table
itself, checks each chunk's CRC, inflates the chunks with zlib, undoes the
byte shuffle, scatters the significant coefficients by the mask, and runs
its own w3ai transform in plain torch, in float32 (or, for the control, in
a lower precision).

The w3ai transform (third-order average-interpolating lifting "on the
interval"): along an axis, the coarse half is the pairwise mean ``(e + o)
/ 2`` and the detail is ``o`` minus the quadratic average-interpolation of
the right half-cell from three neighbouring coarse cells, shifted inside
the block at its edges; the layout is Mallat ``[s | d]``, three axes a
level, recursing on the coarse corner while the side is at least 8.
Subnormal operands and results are flushed to zero, as the paper's
reference code does under XLA on the CPU, and the stencil's products are
summed left to right from +0.0.
"""
from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import struct
import zlib

import numpy as np
import torch

__all__ = ["levels_for", "forward3d", "inverse3d", "blockify", "unblockify",
           "detail_mask", "kept_coeffs", "read_cz", "read_manifest", "judge_field",
           "MAGIC"]

MAGIC = b"CZ2\0"
_PTR = struct.Struct("<Q")
_FLT_MIN = 2.0 ** -126


# -- the transform --------------------------------------------------------

def levels_for(n: int) -> int:
    lv = 0
    while n >= 8:
        n //= 2
        lv += 1
    return lv


@functools.lru_cache(maxsize=None)
def _weights(m: int) -> np.ndarray:
    """(m, 3) float64 weights: row i predicts the mean over [i + 1/2, i + 1)
    of the quadratic whose cell means over cells start .. start + 2 are the
    coarse values, ``start = clip(i - 1, 0, m - 3)``."""
    W = np.zeros((m, 3))
    for i in range(m):
        start = min(max(i - 1, 0), m - 3)
        cells = np.arange(start, start + 3, dtype=np.float64)
        k = np.arange(3, dtype=np.float64)[:, None]
        M = ((cells[None, :] + 1.0) ** (k + 1) - cells[None, :] ** (k + 1)) / (k + 1)
        a, b = i + 0.5, i + 1.0
        rhs = (b ** (k[:, 0] + 1) - a ** (k[:, 0] + 1)) / ((k[:, 0] + 1) * (b - a))
        W[i] = np.linalg.solve(M, rhs)
    return W


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to a zero of their sign (x times 0 or 1)."""
    return x * (x.abs() >= _FLT_MIN) if x.dtype == torch.float32 else x


def _predict(s: torch.Tensor) -> torch.Tensor:
    m = s.shape[-1]
    W = torch.from_numpy(_weights(m).astype(np.float32)).to(s.device, s.dtype)
    start = np.clip(np.arange(m) - 1, 0, m - 3)
    acc = None
    for j in range(3):
        idx = torch.from_numpy(start + j).to(s.device)
        term = _flush(s.index_select(-1, idx) * W[:, j])
        acc = term + 0.0 if acc is None else _flush(acc + term)
    return acc


def _fwd_last(x: torch.Tensor) -> torch.Tensor:
    e, o = _flush(x[..., 0::2]), _flush(x[..., 1::2])
    s = _flush(_flush(e + o) * 0.5)
    d = _flush(o - _predict(s))
    return torch.cat([s, d], dim=-1)


def _inv_last(x: torch.Tensor) -> torch.Tensor:
    m = x.shape[-1] // 2
    s, d = _flush(x[..., :m]), _flush(x[..., m:])
    o = _flush(d + _predict(s))
    e = _flush(_flush(s * 2.0) - o)
    return torch.stack([e, o], dim=-1).reshape(*x.shape[:-1], 2 * m)


def _along(x: torch.Tensor, axis: int, fn) -> torch.Tensor:
    return torch.movedim(fn(torch.movedim(x, axis, -1)), -1, axis)


def forward3d(blocks: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """w3ai forward of ``(B, n, n, n)`` blocks computed in ``dtype``;
    float32 coefficients out."""
    n = blocks.shape[-1]
    out = blocks.to(dtype).clone()
    for lvl in range(levels_for(n)):
        c = n >> lvl
        sub = out[..., :c, :c, :c]
        for axis in (-3, -2, -1):
            sub = _along(sub, axis, _fwd_last)
        out[..., :c, :c, :c] = sub
    return out.to(torch.float32)


def inverse3d(coeffs: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """w3ai inverse of ``(B, n, n, n)`` coefficients computed in ``dtype``;
    float32 blocks out."""
    n = coeffs.shape[-1]
    out = coeffs.to(dtype).clone()
    for lvl in reversed(range(levels_for(n))):
        c = n >> lvl
        sub = out[..., :c, :c, :c]
        for axis in (-1, -2, -3):
            sub = _along(sub, axis, _inv_last)
        out[..., :c, :c, :c] = sub
    return out.to(torch.float32)


def blockify(field: torch.Tensor, bs: int) -> torch.Tensor:
    nx, ny, nz = field.shape
    f = field.reshape(nx // bs, bs, ny // bs, bs, nz // bs, bs).permute(0, 2, 4, 1, 3, 5)
    return f.reshape(-1, bs, bs, bs)


def unblockify(blocks: torch.Tensor, shape) -> torch.Tensor:
    bs = blocks.shape[-1]
    nx, ny, nz = shape
    f = blocks.reshape(nx // bs, ny // bs, nz // bs, bs, bs, bs).permute(0, 3, 1, 4, 2, 5)
    return f.reshape(nx, ny, nz)


def detail_mask(n: int, device) -> torch.Tensor:
    c = n >> levels_for(n)
    m = torch.ones((n, n, n), dtype=torch.bool, device=device)
    m[:c, :c, :c] = False
    return m


def kept_coeffs(blocks: torch.Tensor, eps: float,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """What the compressor keeps of ``blocks``: the forward transform with
    every detail coefficient under ``eps`` in magnitude set to zero."""
    c = forward3d(blocks, dtype)
    drop = detail_mask(blocks.shape[-1], blocks.device) & (c.abs() < eps)
    return c.masked_fill_(drop, 0.0)


# -- the files ------------------------------------------------------------

def _footer(buf: bytes) -> dict:
    if buf[:4] != MAGIC:
        raise ValueError("not a CZ2 container")
    (ptr,) = _PTR.unpack(buf[4:12])
    return json.loads(buf[ptr:])


def _chunk_coeffs(payload: bytes, nblk: int, n: int, c: int, device) -> torch.Tensor:
    """One chunk's coefficients: per-block counts (u32, skipped), the packed
    significance mask of every coefficient (big-endian bits), then the
    coarse corners and the significant details as one byte-shuffled
    float32 stream."""
    off = 4 * nblk
    mask_bytes = nblk * n ** 3 // 8
    bits = torch.from_numpy(np.frombuffer(payload, np.uint8, mask_bytes, off).copy()).to(device)
    shifts = torch.arange(7, -1, -1, device=device, dtype=torch.uint8)
    mask = ((bits[:, None] >> shifts) & 1).bool().reshape(nblk, n, n, n)
    planes = np.frombuffer(payload, np.uint8, offset=off + mask_bytes)
    values = np.ascontiguousarray(planes.reshape(4, -1).T).view(np.float32).reshape(-1)
    values = torch.from_numpy(values.copy()).to(device)
    ncoarse = nblk * c ** 3
    coeffs = torch.zeros((nblk, n, n, n), dtype=torch.float32, device=device)
    if int(mask.sum()) != values.numel() - ncoarse:
        raise ValueError("mask and value stream disagree")
    coeffs[mask] = values[ncoarse:]
    coeffs[:, :c, :c, :c] = values[:ncoarse].reshape(nblk, c, c, c)
    return coeffs


def read_cz(path: str, device, threads: int = 4) -> tuple[torch.Tensor, dict]:
    """A container's coefficient blocks ``(B, n, n, n)`` on ``device`` and
    its footer.  Refuses any scheme, wavelet, shuffle or stage 2 but the
    configuration's, a chunk whose CRC32 differs, and a short file."""
    with open(path, "rb") as f:
        buf = f.read()
    hdr = _footer(buf)
    spec = hdr["spec"]
    want = {"scheme": "wavelet", "wavelet": "w3ai", "shuffle": "byte",
            "stage2": "zlib", "zero_bits": 0, "levels": None, "dtype": "float32"}
    got = {k: spec.get(k) for k in want}
    if got != want:
        raise ValueError(f"{path}: spec {got}, the reference reads {want}")
    n = int(spec["block_size"])
    c = n >> levels_for(n)
    chunks, off = [], 12
    for size, crc in zip(hdr["chunk_sizes"], hdr["chunk_crc32"]):
        chunk = buf[off:off + size]
        if len(chunk) != size or (zlib.crc32(chunk) & 0xFFFFFFFF) != crc:
            raise ValueError(f"{path}: chunk at byte {off} fails its CRC")
        chunks.append(chunk)
        off += size
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        payloads = list(pool.map(zlib.decompress, chunks))
    coeffs = torch.cat([_chunk_coeffs(p, nb, n, c, device)
                        for p, nb in zip(payloads, hdr["chunk_nblocks"])])
    if coeffs.shape[0] != hdr["nblocks"]:
        raise ValueError(f"{path}: {coeffs.shape[0]} blocks, footer says {hdr['nblocks']}")
    return coeffs, hdr


def read_manifest(root: str) -> dict:
    """The dataset's committed manifest: ``{quantity: [timestep records]}``."""
    with open(os.path.join(root, "manifest.json")) as f:
        m = json.load(f)
    if m.get("magic") != "CZDS":
        raise ValueError(f"{root}: not a dataset manifest")
    return {q: list(ent["timesteps"]) for q, ent in m["quantities"].items()}


# -- the judgement ----------------------------------------------------------

def judge_field(field: torch.Tensor, coeffs: torch.Tensor, eps: float,
                bound_factor: float, ref_dtype: torch.dtype = torch.float32) -> dict:
    """Hold one compressed field to the reference.

    ``coeffs`` are the coefficient blocks the compressor kept (as read back
    from its file).  Returns ``coef_gap``, the largest distance between them
    and the reference's own kept coefficients of ``field``, in units of
    ``eps``; ``err_bound``, the largest error of the reference's decode of
    them against ``field``, as a share of the configuration's bound
    ``bound_factor * eps``; and the PSNR of that decode (Eq. (1))."""
    n = coeffs.shape[-1]
    blocks = blockify(field, n)
    ref = kept_coeffs(blocks, eps, ref_dtype)
    coef_gap = float((coeffs - ref).abs().max()) / eps
    del ref
    dec = unblockify(inverse3d(coeffs), field.shape)
    diff = (dec.double() - field.double())
    err = float(diff.abs().max())
    mse = float((diff * diff).mean())
    rng = float(field.max()) - float(field.min())
    return {"coef_gap": coef_gap, "err_bound": err / (bound_factor * eps),
            "mse": mse, "range": rng, "decoded": dec}
