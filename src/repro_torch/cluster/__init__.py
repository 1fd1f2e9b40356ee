"""``repro_torch.cluster`` — the rank-parallel compression tier (counterpart
of ``repro.cluster``).

The layer between the codec pipeline (``repro_torch.core``) and the dataset
store (``repro_torch.store``): it is what turns one-process compression into
the paper's cluster workflow, where every MPI rank compresses its
block-structured share of the grid concurrently and the results land in
shared, single-file-per-quantity output with negligible coordination.

Three modules:

* :mod:`~repro_torch.cluster.decompose` — block-aligned 3D domain
  decomposition (slab / pencil / brick rank grids, ``MPI_Dims_create``-style
  balancing, scatter/gather) plus the 1-D chunk-span partition the engine
  writes with;
* :mod:`~repro_torch.cluster.engine` — :class:`ParallelCompressor`: N worker
  processes encode their spans through ``Pipeline.iter_chunks`` on a torch
  device, an ``MPI_Exscan``-style exclusive scan
  (``repro_torch.dist.offsets``) places each rank's bytes, and the
  assembled shared CZ2 file is bit-identical to the serial writer for any
  rank count;
* :mod:`~repro_torch.cluster.multiwriter` — :class:`RankWriter` sidecar
  manifests (``manifest.rank{r}.json``) for contention-free in-situ append,
  and the atomic, idempotent :func:`merge_manifests` that folds them into
  the CZDataset manifest.
"""
from .decompose import (  # noqa: F401
    LAYOUTS,
    Subdomain,
    chunk_spans,
    decompose,
    dims_for,
    gather,
    scatter,
)
from .engine import ParallelCompressor  # noqa: F401
from .multiwriter import RankWriter, merge_manifests  # noqa: F401

__all__ = ["Subdomain", "LAYOUTS", "decompose", "dims_for", "scatter",
           "gather", "chunk_spans", "ParallelCompressor", "RankWriter",
           "merge_manifests"]
