"""Distributed-systems utilities: parallel-write offsets and fault tolerance
(counterpart of ``repro.dist``).

``offsets``  — exclusive prefix-sum (MPI_Exscan analogue) over compressed
shard sizes, the paper's collective that lets every writer seek to its slot
in the shared per-quantity file without coordination; its sharded form
runs over a ``torch.distributed`` process group.
``fault``    — preemption handling, straggler detection and elastic
re-planning for a fleet that loses or regains devices mid-run.

Importing this package initializes no process group.
"""
from .offsets import exclusive_offsets_np, exclusive_offsets_sharded  # noqa: F401
from .fault import (  # noqa: F401
    PreemptionHandler,
    StragglerReport,
    StragglerWatchdog,
    elastic_plan,
)
