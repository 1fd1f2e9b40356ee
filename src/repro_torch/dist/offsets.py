"""Exclusive prefix-sum offsets for parallel writers (MPI_Exscan analogue;
port of ``repro.dist.offsets``).

The paper's cluster layer computes each rank's byte offset into the shared
per-quantity output file as an exclusive scan over the compressed buffer
sizes.  ``exclusive_offsets_np`` is the single-process version (a copy of
the reference's); ``exclusive_offsets_sharded`` runs the same collective
over a ``torch.distributed`` process group: each process scans its own
shard locally and adds the total of all preceding shards, from one
all-gather of per-shard totals — the two-phase Exscan a multi-host fleet
would execute.  ``exscan_rows`` is the same collective as the rank-parallel
snapshot path runs it: one row of int64 words a process, its byte total
first, so that the one all-gather that places the bytes also carries what
every rank has to agree on.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["exclusive_offsets_np", "exclusive_offsets_sharded", "exscan_rows"]


def exclusive_offsets_np(sizes) -> np.ndarray:
    """offsets[i] = sum(sizes[:i]); offsets[0] = 0."""
    s = np.asarray(sizes, np.int64)
    out = np.zeros_like(s)
    if s.size > 1:
        np.cumsum(s[:-1], out=out[1:])
    return out


def exclusive_offsets_sharded(local_sizes, group=None) -> torch.Tensor:
    """This process's slice of the exclusive scan over every process's sizes.

    Each process of ``group`` (default: the world group, which must be
    initialized) passes its own shard of the sizes as a 1-D int64 tensor,
    in rank order, and gets back ``cumsum(local) - local + base``, where
    ``base`` is the sum of the shards of the lower ranks (one all-gather of
    the per-shard totals, O(processes) bytes).  The shards concatenated in
    rank order scan to ``exclusive_offsets_np`` of the concatenated sizes.

    The reference's version takes the whole array and a JAX ``(mesh,
    axis_name)`` and shards it itself under ``shard_map``; here each
    process holds only its shard, and the group takes the mesh axis's
    place.  The tensor lies where the group's backend needs it (the CPU
    for gloo).
    """
    local = torch.as_tensor(local_sizes, dtype=torch.int64).reshape(-1)
    base, _rows = exscan_rows(local.sum().reshape(1), group=group)
    return torch.cumsum(local, 0) - local + base


def exscan_rows(row, group=None) -> tuple[int, torch.Tensor]:
    """The Exscan over ``row[0]``, every process's byte total, with the
    rest of each process's ``row`` gathered beside it: this process's
    offset (the sum of the lower ranks' totals) and the ``(processes,
    len(row))`` int64 table of all rows in rank order, from one all-gather
    (counted as ``cz_collective_calls_total{op="exscan"}``)."""
    import torch.distributed as dist

    from .collective import CALLS

    mine = torch.as_tensor(row, dtype=torch.int64).reshape(-1)
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, mine, group=group)
    CALLS.inc(op="exscan")
    rows = torch.stack(rows)
    return int(rows[:dist.get_rank(group), 0].sum()), rows
