"""Fault tolerance for long-running compression/training fleets (a copy of
``repro.dist.fault``: numpy and ``signal`` only).

Three mechanisms, matching what the reference's ``repro.launch.train``
wires up:

* :class:`PreemptionHandler` — turns SIGTERM/SIGINT into a cooperative
  "finish the step, checkpoint, exit 0" instead of a hard kill.
* :class:`StragglerWatchdog` — flags steps whose wall time exceeds a
  multiple of the rolling median; persistent outliers get a ``redispatch``
  verdict (the scheduler should move that shard's work elsewhere).
* :func:`elastic_plan` — re-plans the device mesh and per-device batch when
  the fleet comes back smaller (or larger) than requested; checkpoints are
  resharded on load, so training resumes on whatever is available.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import signal

import numpy as np

__all__ = ["PreemptionHandler", "StragglerReport", "StragglerWatchdog",
           "elastic_plan"]


class PreemptionHandler:
    """Latch SIGTERM/SIGINT; the train loop polls ``.preempted`` each step."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), install: bool = True):
        self.preempted = False
        self._prev = {}
        if install:
            for sig in signals:
                try:
                    self._prev[sig] = signal.signal(sig, self._handle)
                except (ValueError, OSError):  # non-main thread / exotic platform
                    pass

    def _handle(self, signum, frame):
        self.preempted = True

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    ratio: float      # step_time / rolling median of healthy steps
    action: str       # "ok" | "flag" | "redispatch"


class StragglerWatchdog:
    """Rolling-median step timer; only healthy steps feed the baseline so a
    slow shard cannot drag the median up and mask itself."""

    def __init__(self, window: int = 8, flag_ratio: float = 1.5,
                 redispatch_ratio: float = 3.0):
        self.flag_ratio = flag_ratio
        self.redispatch_ratio = redispatch_ratio
        self._times: collections.deque[float] = collections.deque(maxlen=window)
        self.reports: list[StragglerReport] = []

    def observe(self, step: int, step_time: float) -> StragglerReport:
        ratio = step_time / float(np.median(self._times)) if self._times else 1.0
        if ratio >= self.redispatch_ratio:
            action = "redispatch"
        elif ratio >= self.flag_ratio:
            action = "flag"
        else:
            action = "ok"
        rep = StragglerReport(step, step_time, ratio, action)
        if action == "ok":
            self._times.append(step_time)
        else:
            self.reports.append(rep)
        return rep


def elastic_plan(requested: int, available: int, *, global_batch: int) -> dict:
    """Mesh + batch plan for a fleet of ``available`` devices.

    Factors ``available`` into the squarest (data, model) mesh and keeps the
    global batch by padding the per-device batch up when data parallelism
    does not divide it evenly.
    """
    if available < 1:
        raise ValueError("no devices available")
    model = max(d for d in range(1, math.isqrt(available) + 1)
                if available % d == 0)
    data = available // model
    per_device = math.ceil(global_batch / data)
    return {
        "requested": requested,
        "n_devices": available,
        "mesh_shape": (data, model),
        "per_device_batch": per_device,
        "batch_pad": per_device * data - global_batch,
        "degraded": available < requested,
    }
