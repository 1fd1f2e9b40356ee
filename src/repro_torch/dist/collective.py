"""The collectives of the rank-parallel snapshot path, over a
``torch.distributed`` process group.

Every rank of the group calls each of them at the same point.  The group's
backend takes CPU tensors (gloo); the objects are small pickles (chunk
tables, a status, a run's spans).  Each call is counted in
``cz_collective_calls_total{op}`` (``CALLS``), as is the Exscan that
places each rank's bytes (:func:`repro_torch.dist.offsets.exscan_rows`,
``op="exscan"``).

Importing this module initializes no process group.
"""
from __future__ import annotations

from repro_torch import obs

__all__ = ["CALLS", "gather_objects", "broadcast_object"]

CALLS = obs.counter("cz_collective_calls_total",
                    "Collectives over the rank group by operation.",
                    labelnames=("op",))


def gather_objects(obj, group, dst: int = 0) -> list | None:
    """Every rank's picklable ``obj`` in rank order on rank ``dst`` (group
    rank), ``None`` on the others."""
    import torch.distributed as dist

    me = dist.get_rank(group)
    out = [None] * dist.get_world_size(group) if me == dst else None
    dist.gather_object(obj, out, dst=dist.get_global_rank(group, dst)
                       if group is not None else dst, group=group)
    CALLS.inc(op="gather")
    return out


def broadcast_object(obj, group, src: int = 0):
    """Rank ``src``'s picklable ``obj`` (group rank) on every rank."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src)
                               if group is not None else src, group=group)
    CALLS.inc(op="broadcast")
    return box[0]
