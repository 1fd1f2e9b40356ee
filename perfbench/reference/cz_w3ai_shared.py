"""Plain reference of a member that several ranks wrote into one shared file:
the paper's in-situ layout, where every rank compresses its own slab and an
Exscan over the ranks' compressed sizes places its chunks.

It imports nothing of the program under test and reuses ``cz_w3ai``'s own
CZ2 parser, zlib and w3ai.  Ranks hold slabs along axis 0, stacked in rank
order, so rank ``r``'s blocks are one contiguous span of the global block
raster; the reference finds each rank's chunks from the footer's chunk
table and the ranks' block counts, and

* :func:`read_rank` decodes one rank's chunks only, into the coefficient
  blocks of its slab (judged against the slab the rank handed in with
  ``cz_w3ai.judge_field``);
* :func:`offsets_off` counts what is wrong with the layout of one
  snapshot's members: a rank boundary inside a chunk (the chunk records
  are not contiguous in rank order), a rank whose first chunk does not
  start at the exclusive scan of the lower ranks' bytes, a global shape or
  block count other than the ranks' slabs make, a footer that does not
  follow the last chunk, and a rank whose chunks over the members hold
  other than the bytes it reported writing.
"""
from __future__ import annotations

import concurrent.futures
import zlib

import numpy as np
import torch

from perfbench.reference import cz_w3ai as ref

__all__ = ["rank_chunk_spans", "read_rank", "offsets_off"]

_DATA = 12  # the magic and the footer pointer


def _read(path: str) -> tuple[bytes, dict]:
    with open(path, "rb") as f:
        buf = f.read()
    return buf, ref._footer(buf)


def rank_chunk_spans(hdr: dict, rank_nblocks: list[int]) -> list[tuple[int, int]] | None:
    """Each rank's chunks ``[lo, hi)`` in the footer's table, or ``None``
    where a rank boundary falls inside a chunk."""
    ends = np.cumsum([0] + list(hdr["chunk_nblocks"]))
    where = {int(b): i for i, b in enumerate(ends)}
    bounds = np.cumsum([0] + list(rank_nblocks))
    if any(int(b) not in where for b in bounds):
        return None
    return [(where[int(a)], where[int(b)]) for a, b in zip(bounds, bounds[1:])]


def _check_spec(path: str, hdr: dict) -> int:
    spec = hdr["spec"]
    want = {"scheme": "wavelet", "wavelet": "w3ai", "shuffle": "byte",
            "stage2": "zlib", "zero_bits": 0, "levels": None, "dtype": "float32"}
    got = {k: spec.get(k) for k in want}
    if got != want:
        raise ValueError(f"{path}: spec {got}, the reference reads {want}")
    return int(spec["block_size"])


def read_rank(path: str, rank: int, rank_nblocks: list[int], device,
              threads: int = 4) -> tuple[torch.Tensor, dict]:
    """Rank ``rank``'s coefficient blocks ``(B, n, n, n)`` on ``device``,
    from its chunks of the shared member, and the footer.  Refuses what
    ``cz_w3ai.read_cz`` refuses, and a table whose chunks straddle ranks."""
    buf, hdr = _read(path)
    n = _check_spec(path, hdr)
    c = n >> ref.levels_for(n)
    spans = rank_chunk_spans(hdr, rank_nblocks)
    if spans is None:
        raise ValueError(f"{path}: a chunk straddles two ranks' blocks")
    lo, hi = spans[rank]
    sizes = hdr["chunk_sizes"]
    off = _DATA + sum(sizes[:lo])
    chunks = []
    for size, crc in zip(sizes[lo:hi], hdr["chunk_crc32"][lo:hi]):
        chunk = buf[off:off + size]
        if len(chunk) != size or (zlib.crc32(chunk) & 0xFFFFFFFF) != crc:
            raise ValueError(f"{path}: chunk at byte {off} fails its CRC")
        chunks.append(chunk)
        off += size
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        payloads = list(pool.map(zlib.decompress, chunks))
    coeffs = torch.cat([ref._chunk_coeffs(p, nb, n, c, device)
                        for p, nb in zip(payloads, hdr["chunk_nblocks"][lo:hi])])
    if coeffs.shape[0] != rank_nblocks[rank]:
        raise ValueError(f"{path}: rank {rank} has {coeffs.shape[0]} blocks, "
                         f"its slab {rank_nblocks[rank]}")
    return coeffs, hdr


def offsets_off(paths: list[str], rank_shapes: list[tuple[int, int, int]],
                rank_bytes: list[int]) -> int:
    """Faults in the layout of one snapshot's shared members (``paths``, one
    a quantity), where rank ``r`` handed in a slab of ``rank_shapes[r]``
    and reported writing ``rank_bytes[r]`` bytes over all of them."""
    faults, written = 0, [0] * len(rank_shapes)
    for path in paths:
        buf, hdr = _read(path)
        n = _check_spec(path, hdr)
        nblocks = [int(np.prod([s // n for s in shape])) for shape in rank_shapes]
        want_shape = [sum(s[0] for s in rank_shapes), *rank_shapes[0][1:]]
        faults += int(list(hdr.get("field_shape", [])) != want_shape)
        faults += int(hdr["nblocks"] != sum(nblocks))
        sizes = hdr["chunk_sizes"]
        (ptr,) = ref._PTR.unpack(buf[4:12])
        faults += int(ptr != _DATA + sum(sizes))
        spans = rank_chunk_spans(hdr, nblocks)
        if spans is None:
            faults += 1
            continue
        own = [sum(sizes[lo:hi]) for lo, hi in spans]
        scan = np.concatenate([[0], np.cumsum(own)[:-1]])
        starts = [_DATA + sum(sizes[:lo]) for lo, _hi in spans]
        faults += sum(int(s != _DATA + e) for s, e in zip(starts, scan))
        written = [w + o for w, o in zip(written, own)]
    faults += sum(int(w != b) for w, b in zip(written, rank_bytes))
    return faults
