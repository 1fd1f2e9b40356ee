"""Call metrics of the kernel wrappers (the reference's
``repro.kernels.ops._instrument``, in torch).

Every public wrapper counts its calls in ``cz_kernel_calls_total{kernel,
device}`` and times them in ``cz_kernel_seconds{kernel, device, phase}``,
with a ``kernel.compile`` / ``kernel.execute`` trace record, under the
reference's names and labels.  ``device`` is the torch device type of the
call (``cuda`` or ``cpu``).  On the card the count is the kernel's launch
count: the wrapper adds one right after its launch succeeded
(:func:`launched`) and nowhere else, so a call that raises, or has no
blocks to launch on, counts nothing.  The counter's lock keeps the count
exact when several threads launch (the tuner's trials do).  The first call per signature (shapes, dtypes,
static values) is the ``compile`` phase, as the reference keys its jit
cache; on the card it is the call that builds or loads the kernel library.

A call on the card returns before the card is done.  The wrapper waits for
it (``torch.cuda.synchronize``, where the reference calls
``block_until_ready``) only when someone is looking: the process tracer is
on, or a collecting request context is active.  Otherwise the time is the
launch's, and the host keeps running ahead of the card.
"""
from __future__ import annotations

import functools
import threading
import time

import torch

from repro_torch import obs
from repro_torch.obs import context as _context
from repro_torch.obs import trace

__all__ = ["instrument", "launched"]

_CALLS = obs.counter(
    "cz_kernel_calls_total", "Kernel wrapper calls.",
    labelnames=("kernel", "device"))
_SECONDS = obs.histogram(
    "cz_kernel_seconds",
    "Kernel wall time split by compile/execute phase (synchronized while "
    "tracing/tail collection is active; launch time otherwise).",
    buckets=obs.FAST_BUCKETS, labelnames=("kernel", "device", "phase"))


def _sig(x):
    if isinstance(x, torch.Tensor):
        return ("arr", tuple(x.shape), str(x.dtype), x.device.type)
    return ("val", x)


def _observed() -> bool:
    ctx = _context.current()
    return trace.tracing() or (ctx is not None and ctx.collecting)


def launched(name: str) -> None:
    """Count one launch of kernel ``name`` (the reference's label) on the
    card; each wrapper calls it where its launch succeeded."""
    _CALLS.inc(kernel=name, device="cuda")


def instrument(name: str):
    """Wrap one public kernel wrapper with the ``cz_kernel_*`` metrics."""

    def deco(fn):
        seen: set = set()
        lock = threading.Lock()

        @functools.wraps(fn)
        def wrapper(*a, **k):
            key = (tuple(_sig(x) for x in a),
                   tuple(sorted((kk, _sig(v)) for kk, v in k.items())))
            with lock:
                first = key not in seen
                seen.add(key)
            dev = (a[0] if a else next(iter(k.values()))).device
            device = dev.type
            phase = "compile" if first else "execute"
            t0 = time.perf_counter_ns()
            out = fn(*a, **k)
            if device == "cuda" and _observed():
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter_ns()
            if device != "cuda":  # on the card, counted at the launch
                _CALLS.inc(kernel=name, device=device)
            _SECONDS.observe((t1 - t0) / 1e9, kernel=name, device=device,
                             phase=phase)
            trace.record(f"kernel.{phase}", t0, t1, kernel=name, device=device)
            return out

        return wrapper

    return deco
