"""Call metrics of the kernel wrappers (the reference's
``repro.kernels.ops._instrument``, in torch), and the torch side of the
port's tracing: device time of a span and bytes copied between host and
card.

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

A call on the card returns before the card is done, and the wrapper never
waits for it: ``cz_kernel_seconds`` holds the call's host seconds (on the
card, its launch) whether or not anyone traces.  While the process tracer
is on, a pair of CUDA events around the call gives the ``kernel.*`` span
the card's time as ``device_us``, read once the card has passed the second
event (see :func:`device_span`).

:func:`count_copy` counts ``cz_copy_bytes_total{direction, site, pinned}``
where a copy between host and card is made.
"""
from __future__ import annotations

import functools
import threading
import time

import torch

from repro_torch import obs
from repro_torch.obs import trace

__all__ = ["count_copy", "cuda_launches", "device_span", "instrument", "launched"]

_CALLS = obs.counter(
    "cz_kernel_calls_total", "Kernel wrapper calls.",
    labelnames=("kernel", "device"))
_SECONDS = obs.histogram(
    "cz_kernel_seconds",
    "Kernel wrapper host wall time split by compile/execute phase (on the "
    "card the launch, never synchronized; traced spans carry device_us).",
    buckets=obs.FAST_BUCKETS, labelnames=("kernel", "device", "phase"))
_COPY_BYTES = obs.counter(
    "cz_copy_bytes_total",
    "Bytes copied between host and card, counted where the copy is made.",
    labelnames=("direction", "site", "pinned"))


def _sig(x):
    if isinstance(x, torch.Tensor):
        return ("arr", tuple(x.shape), str(x.dtype), x.device.type)
    return ("val", x)


def launched(name: str) -> None:
    """Count one launch of kernel ``name`` (the reference's label) on the
    card; each wrapper calls it where its launch succeeded."""
    _CALLS.inc(kernel=name, device="cuda")


def cuda_launches() -> dict[str, int]:
    """This process's launches on the card so far, per kernel label."""
    return {labels["kernel"]: v for labels, v in _CALLS.samples()
            if labels["device"] == "cuda"}


def count_copy(t: torch.Tensor, to, site: str) -> None:
    """Count the bytes of ``t`` copied to device ``to`` at ``site``, when
    the copy crosses between host and card; a copy that stays on one side
    counts nothing.  ``pinned`` says whether the host side is page-locked
    (a copy to the host lands in pageable memory here)."""
    src, dst = t.device.type, torch.device(to).type
    if src == dst or "cpu" not in (src, dst):
        return
    h2d = src == "cpu"
    _COPY_BYTES.inc(t.numel() * t.element_size(), direction="h2d" if h2d else "d2h",
                    site=site, pinned="true" if h2d and t.is_pinned() else "false")


class _DeviceTimer:
    """A pair of CUDA events on ``device``'s current stream around some
    work: :meth:`settle` puts the card's microseconds between them into a
    trace event's ``args["device_us"]``, at once when the card has passed
    the second event, else when the tracer's events are next read."""

    __slots__ = ("_stream", "_start", "_end")

    def __init__(self, device):
        self._stream = torch.cuda.current_stream(device)
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._start.record(self._stream)

    def stop(self) -> None:
        self._end.record(self._stream)

    def _put(self, ev: dict) -> None:
        self._end.synchronize()  # runs at once, or when the events are read
        ev.setdefault("args", {})["device_us"] = self._start.elapsed_time(self._end) * 1e3

    def settle(self, ev: dict | None) -> None:
        if ev is None:
            return
        if self._end.query():
            self._put(ev)
        else:
            trace.TRACER.defer(functools.partial(self._put, ev))


class _DeviceSpan:
    """A live trace span that also carries the card's time (``device_us``)."""

    __slots__ = ("_span", "_device", "_timer")

    def __init__(self, span, device):
        self._span = span
        self._device = device

    def __enter__(self):
        self._timer = _DeviceTimer(self._device)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._timer.stop()
        self._span.__exit__(*exc)
        self._timer.settle(getattr(self._span, "event", None))
        return False


def device_span(name: str, device, **args):
    """``with device_span("stage1.transform", blocks.device): ...``: a trace
    span whose event, on the card and while the process tracer is on, also
    carries ``device_us``, the card's time of the work queued inside it
    (CUDA events on the current stream, read without a new wait).  On the
    CPU it is a plain span; off, the tracer's shared no-op."""
    span = trace.span(name, **args)
    if trace.tracing() and torch.device(device).type == "cuda":
        return _DeviceSpan(span, device)
    return span


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
            timer = _DeviceTimer(dev) if device == "cuda" and trace.tracing() else None
            t0 = time.perf_counter_ns()
            out = fn(*a, **k)
            t1 = time.perf_counter_ns()
            if timer is not None:
                timer.stop()
            if device != "cuda":  # on the card, counted at the launch
                _CALLS.inc(kernel=name, device=device)
            _SECONDS.observe((t1 - t0) / 1e9, kernel=name, device=device,
                             phase=phase)
            ev = trace.record(f"kernel.{phase}", t0, t1, kernel=name, device=device)
            if timer is not None:
                timer.settle(ev)
            return out

        return wrapper

    return deco
