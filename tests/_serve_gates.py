"""Deterministic gates for the serve tier's concurrency tests: each waits
on a condition the callers signal, never on ``sleep``."""
import concurrent.futures
import threading


class Parked:
    """Counts callers parked on a flight's future: each package's
    ``_Flight`` is swapped for one whose future signals when a caller
    starts waiting on it (a follower does right after joining)."""

    def __init__(self, monkeypatch, sched_mod):
        self.cond = threading.Condition()
        self.n = 0
        parked = self

        class Future(concurrent.futures.Future):
            def result(self, timeout=None):
                if not self.done():
                    with parked.cond:
                        parked.n += 1
                        parked.cond.notify_all()
                return super().result(timeout)

        class Flight(sched_mod._Flight):
            def __init__(self, leader_rid):
                super().__init__(leader_rid)
                self.future = Future()

        monkeypatch.setattr(sched_mod, "_Flight", Flight)

    def wait(self, n: int) -> None:
        with self.cond:
            assert self.cond.wait_for(lambda: self.n >= n, timeout=30), \
                f"{self.n} of {n} callers parked"


class Gate:
    """Every chunk decode of one package waits on ``release``; ``entered``
    counts the decodes that started, ``max_inside`` the most at once."""

    def __init__(self, monkeypatch, pipeline_cls, fail: BaseException | None = None):
        self.release = threading.Event()
        self.cond = threading.Condition()
        self.entered = self.inside = self.max_inside = 0
        orig = pipeline_cls.decompress_chunk
        gate = self

        def gated(pipe, *a, **k):
            with gate.cond:
                gate.entered += 1
                gate.inside += 1
                gate.max_inside = max(gate.max_inside, gate.inside)
                gate.cond.notify_all()
            try:
                assert gate.release.wait(30), "the gate was never opened"
                if fail is not None:
                    raise fail
                return orig(pipe, *a, **k)
            finally:
                with gate.cond:
                    gate.inside -= 1

        monkeypatch.setattr(pipeline_cls, "decompress_chunk", gated)

    def wait(self, pred, what: str) -> None:
        with self.cond:
            assert self.cond.wait_for(lambda: pred(self), timeout=30), what
