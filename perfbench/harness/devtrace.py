"""The traced window: torch.profiler over it, reduced to what the per-layer
readers and the result line need.

* ``busy_s``: the union of the intervals in which any device activity ran
  (kernels, copies, sets), over the window;
* ``kernels``: device microseconds and launches by kernel name;
* ``breakdown``: the ten device operations that took most time, and the
  device's idle time grouped by what the host was doing then: the
  innermost span, of the program's trace or the harness's own, that
  covers the middle of each gap.

Profiler times and the spans' ``perf_counter_ns`` stamps are put on one
clock by the harness's own spans, each recorded on both.
"""
from __future__ import annotations

import contextlib
import time

__all__ = ["Window", "reduce_trace"]

_BIN_US = 10_000.0


class Window:
    """The measured window, and in a traced run the profiler around it.

    ``span(name)`` times a region of the harness on the host's clock, and
    in a traced run marks it on the profiler's too."""

    def __init__(self, trace: bool, device: str):
        self.trace = trace
        self.device = device
        self.prof = None
        self.spans: list[tuple[str, int, int]] = []
        self.t0_ns = self.t1_ns = 0

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self.t0_ns = time.perf_counter_ns()
        return self

    def close(self) -> float:
        """End the window (the caller has synchronised the device); returns
        its seconds."""
        self.t1_ns = time.perf_counter_ns()
        return (self.t1_ns - self.t0_ns) / 1e9

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        if self.trace:
            import torch

            with torch.profiler.record_function(f"bench.{name}"):
                yield
        else:
            yield
        self.spans.append((name, t0, time.perf_counter_ns()))


def _union_seconds(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    """Total length of the union of ``(start, end)`` microsecond intervals,
    and the gaps between the merged intervals."""
    busy, gaps = 0.0, []
    cur = None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s <= cur[1]:
            cur[1] = max(cur[1], e)
        else:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e6, gaps


def reduce_trace(win: Window, program_spans: list[dict], origin_ns: int) -> dict:
    """The device trace of ``win`` reduced (see the module docstring).
    ``program_spans`` are the program's trace events (``ts``/``dur`` in
    microseconds from ``origin_ns`` on ``perf_counter_ns``)."""
    window_s = (win.t1_ns - win.t0_ns) / 1e9
    out = {"window_s": window_s, "busy_s": 0.0, "kernels": {}, "breakdown": None}
    if win.prof is None:
        return out
    from torch.autograd import DeviceType

    events = win.prof.events()
    device_iv, marks = [], {}
    for ev in events:
        if ev.name.startswith("bench."):  # the harness's marks, on either track
            if ev.device_type != DeviceType.CUDA:
                marks.setdefault(ev.name[6:], []).append(ev.time_range.start)
        elif ev.device_type == DeviceType.CUDA:
            device_iv.append((ev.time_range.start, ev.time_range.end))
    # the profiler's clock against perf_counter_ns, from the harness's spans
    offsets = []
    for name, t0, _t1 in win.spans:
        starts = marks.get(name)
        if starts:
            offsets.append(starts.pop(0) - t0 / 1e3)
    offset_us = sorted(offsets)[len(offsets) // 2] if offsets else None

    lo_us = win.t0_ns / 1e3 + offset_us if offset_us is not None else None
    hi_us = win.t1_ns / 1e3 + offset_us if offset_us is not None else None
    if lo_us is not None:  # clipped to the window; its ends as empty marks
        device_iv = [(max(s, lo_us), min(e, hi_us)) for s, e in device_iv if e > lo_us and s < hi_us]
        device_iv += [(lo_us, lo_us), (hi_us, hi_us)]
    busy_s, gaps = _union_seconds(device_iv)
    out["busy_s"] = busy_s

    kernels = {ev.key: {"device_us": float(ev.device_time_total), "count": int(ev.count)}
               for ev in win.prof.key_averages()
               if ev.device_type == DeviceType.CUDA and not ev.key.startswith("bench.")
               and ev.device_time_total > 0}
    out["kernels"] = kernels

    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_us"])[:10]
    idle = {}
    if offset_us is not None and gaps:
        host = [(s["ts"] + origin_ns / 1e3 + offset_us, s["dur"], s["name"]) for s in program_spans]
        host += [(t0 / 1e3 + offset_us, (t1 - t0) / 1e3, name) for name, t0, t1 in win.spans]
        bins: dict[int, list] = {}  # 10 ms bins -> the spans over them
        for ts, dur, name in host:
            for k in range(int(ts // _BIN_US), int((ts + dur) // _BIN_US) + 1):
                bins.setdefault(k, []).append((ts, dur, name))
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(dur, name) for ts, dur, name in bins.get(int(mid // _BIN_US), ())
                     if ts <= mid <= ts + dur]
            label = min(inner)[1] if inner else "other"
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    out["breakdown"] = {
        "device_ops": [[k, v["device_us"] / 1e6] for k, v in top],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10],
    }
    return out
