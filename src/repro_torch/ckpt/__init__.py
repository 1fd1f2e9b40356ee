"""Compressed checkpointing of torch state and dataset-backed field
snapshots (counterpart of ``repro.ckpt``)."""
from .checkpoint import (  # noqa: F401
    Checkpointer,
    FieldSnapshotter,
    latest_step,
    load_checkpoint,
    restore_tree,
    save_checkpoint,
)
