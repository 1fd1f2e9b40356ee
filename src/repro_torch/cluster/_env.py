"""Worker-process environment setup for the cluster engine (port of
``repro.cluster._env``).

N rank processes each spinning up a multi-threaded BLAS/OpenMP runtime
oversubscribes the node and can make the parallel path *slower* than serial
— one compute thread per rank is the paper's model anyway.  The caps must be
in the environment **before** the worker process loads numpy and torch
(OpenBLAS/OMP size their pools at library load, and torch sizes its
intra-op pool from ``OMP_NUM_THREADS`` at import) — too early for any
in-worker initializer, since unpickling one already imports the package.
So the parent exports the caps around spawn-pool creation
(:func:`worker_env`); the children inherit them at exec.

The reference also appends XLA's single-thread flags to ``XLA_FLAGS``;
nothing in the port reads them.  torch's intra-op pool takes their place,
and the inherited ``OMP_NUM_THREADS`` cap already holds it to one thread.
"""
from __future__ import annotations

import contextlib
import os

_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS")


@contextlib.contextmanager
def worker_env():
    """Temporarily export per-worker thread caps (explicit settings win);
    restores the parent's environment on exit."""
    saved: dict[str, str | None] = {}
    for var in _THREAD_VARS:
        if var not in os.environ:
            saved[var] = None
            os.environ[var] = "1"
    try:
        yield
    finally:
        for var in saved:
            os.environ.pop(var, None)
