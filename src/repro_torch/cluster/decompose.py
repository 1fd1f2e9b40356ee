"""3D domain decomposition into per-rank block-aligned subdomains (a copy
of ``repro.cluster.decompose``, over the port's ``core.blocks``).

The paper's cluster tier assigns each MPI rank a block-structured subdomain
of the global grid.  Three layouts (all cuts land on block boundaries, so a
subdomain blockifies independently of its neighbours — no halo exchange):

* ``slab``   — 1D split along x (the classic I/O decomposition),
* ``pencil`` — 2D split along x and y,
* ``brick``  — 3D split along x, y and z (most surface-balanced).

:func:`dims_for` balances the rank grid like ``MPI_Dims_create``;
:func:`scatter`/:func:`gather` move a parent-held field to/from subdomain
parts (the multiprocessing stand-in for a distributed allocation).

:func:`chunk_spans` is the second, 1-D decomposition the shared-file engine
uses: the serial chunk stream (one chunk per aggregation buffer, in global
block-raster order) is split into contiguous per-rank spans.  Rank cuts land
on *chunk* boundaries, which is what makes the parallel single-file assembly
bit-identical to the serial writer for any rank count.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.blocks import num_blocks

__all__ = ["Subdomain", "LAYOUTS", "dims_for", "decompose", "scatter",
           "gather", "chunk_spans"]

LAYOUTS = ("slab", "pencil", "brick")


@dataclasses.dataclass(frozen=True)
class Subdomain:
    """One rank's half-open box ``[lo, hi)`` of the global grid."""

    rank: int
    lo: tuple[int, int, int]
    hi: tuple[int, int, int]

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(b - a for a, b in zip(self.lo, self.hi))

    @property
    def slices(self) -> tuple[slice, slice, slice]:
        return tuple(slice(a, b) for a, b in zip(self.lo, self.hi))

    @property
    def nvoxels(self) -> int:
        return int(np.prod(self.shape))

    def nblocks(self, block_size: int) -> int:
        return int(np.prod(num_blocks(self.shape, block_size)))


def _prime_factors_desc(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return sorted(out, reverse=True)


def dims_for(ranks: int, ndims: int) -> tuple[int, ...]:
    """Balanced rank-grid factorization (``MPI_Dims_create`` analogue).

    Greedily assigns prime factors (largest first) to the currently smallest
    dimension; returns dims sorted descending so the x axis gets the most
    parts.  ``dims_for(12, 3) == (3, 2, 2)``.
    """
    if ranks < 1 or ndims < 1:
        raise ValueError(f"need ranks >= 1 and ndims >= 1, got {ranks}, {ndims}")
    dims = [1] * ndims
    for p in _prime_factors_desc(ranks):
        dims[int(np.argmin(dims))] *= p
    return tuple(sorted(dims, reverse=True))


def _splits(n: int, parts: int) -> list[int]:
    """parts+1 monotone boundaries dividing ``n`` units as evenly as possible."""
    return [i * n // parts for i in range(parts + 1)]


def decompose(shape: tuple[int, int, int], ranks: int, block_size: int,
              layout: str = "slab") -> list[Subdomain]:
    """Split ``shape`` into ``ranks`` block-aligned subdomains.

    Subdomains are disjoint, cover the grid exactly, and are ordered by rank
    in C order over the rank grid.  Raises if an axis has fewer block layers
    than the layout wants parts (use a flatter layout or fewer ranks).
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    nb = num_blocks(tuple(shape), block_size)
    nd = {"slab": 1, "pencil": 2, "brick": 3}[layout]
    # match the biggest rank-grid factor to the axis with the most block
    # layers (among the layout's split axes) so short leading axes don't
    # spuriously reject feasible rank counts
    order = sorted(range(nd), key=lambda a: -nb[a])
    dims = [1, 1, 1]
    for ax, d in zip(order, dims_for(ranks, nd)):
        dims[ax] = d
    for d, n, ax in zip(dims, nb, "xyz"):
        if d > n:
            raise ValueError(
                f"layout {layout!r} cuts axis {ax} into {d} parts but it has "
                f"only {n} blocks of side {block_size}")
    cuts = [[b * block_size for b in _splits(n, d)] for n, d in zip(nb, dims)]
    subs, rank = [], 0
    for i in range(dims[0]):
        for j in range(dims[1]):
            for k in range(dims[2]):
                subs.append(Subdomain(
                    rank,
                    (cuts[0][i], cuts[1][j], cuts[2][k]),
                    (cuts[0][i + 1], cuts[1][j + 1], cuts[2][k + 1])))
                rank += 1
    return subs


def scatter(field: np.ndarray, subs: list[Subdomain]) -> list[np.ndarray]:
    """Extract each rank's contiguous subdomain part from a global field."""
    field = np.asarray(field)
    return [np.ascontiguousarray(field[s.slices]) for s in subs]


def gather(parts: list[np.ndarray], subs: list[Subdomain],
           shape: tuple[int, int, int] | None = None) -> np.ndarray:
    """Reassemble subdomain parts into the global field (inverse of scatter)."""
    if len(parts) != len(subs):
        raise ValueError(f"{len(parts)} parts for {len(subs)} subdomains")
    if shape is None:
        shape = tuple(max(s.hi[a] for s in subs) for a in range(3))
    out = np.empty(shape, np.asarray(parts[0]).dtype)
    for part, s in zip(parts, subs):
        part = np.asarray(part)
        if part.shape != s.shape:
            raise ValueError(
                f"rank {s.rank} part has shape {part.shape}, subdomain {s.shape}")
        out[s.slices] = part
    return out


def chunk_spans(nchunks: int, ranks: int) -> list[tuple[int, int]]:
    """Contiguous per-rank spans ``[lo, hi)`` over the serial chunk stream.

    Balanced to within one chunk; spans may be empty when ``ranks > nchunks``
    (those ranks simply contribute zero bytes to the shared file).
    """
    bounds = _splits(nchunks, max(1, int(ranks)))
    return list(zip(bounds, bounds[1:]))
