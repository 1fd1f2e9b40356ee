"""RetryStore: retry/backoff policy layer for remote-ish backends.

Networks drop requests; a reader stack in which every caller hand-rolls its
own retry loop ends up with none of them agreeing on what "transient"
means.  This wrapper centralizes the policy: any :class:`Store` op that
fails with a *transient* fault (the :class:`OSError` family — connection
resets, injected :class:`~repro_torch.store.backends.flaky.InjectedFault`s,
socket timeouts) is retried up to ``retries`` times with exponential
backoff and jitter, bounded by an optional per-op ``deadline``.

Permanent errors are never retried: :class:`StoreKeyError` (the object is
not there) and :class:`StoreRangeError` (the range can never be satisfied)
pass straight through — both are checked *before* the transient family,
since ``StoreRangeError`` is itself an ``IOError``.

Every retry bumps ``cz_store_retries_total{backend,op}`` and emits a
``store.retry`` event; a retry budget exhausted against the deadline bumps
``cz_store_deadline_exceeded_total{backend,op}`` and raises
:class:`StoreDeadlineError`.  ``sleep``/``rng`` are injectable so tests run
deterministic schedules without wall-clock waits.

``open_store`` wraps any backend with ``remote = True`` (HttpStore) in this
layer by default; ``retries=0`` opts out, an explicit ``retries=N`` opts
any backend in.
"""
from __future__ import annotations

import random
import time

from repro_torch import obs

from .base import Store, StoreKeyError, StoreRangeError

__all__ = ["RetryStore", "StoreDeadlineError"]

_RETRIES = obs.counter("cz_store_retries_total",
                       "Store operations retried after a transient fault.",
                       labelnames=("backend", "op"))
_DEADLINE = obs.counter(
    "cz_store_deadline_exceeded_total",
    "Store operations abandoned at their per-op retry deadline.",
    labelnames=("backend", "op"))


class StoreDeadlineError(TimeoutError):
    """The per-op deadline expired before a retry could succeed."""


class RetryStore(Store):
    """Delegating store that retries transient faults with backoff.

    ``retries`` is the number of *re*-attempts after the first try;
    ``backoff`` the base delay, doubled each attempt up to ``max_backoff``
    and stretched by up to ``jitter``× of itself (decorrelates a fleet of
    readers hammering one recovering server); ``deadline`` bounds the whole
    op: when the elapsed time plus the next backoff would cross it, the op
    is abandoned with :class:`StoreDeadlineError` instead of sleeping.  The
    deadline governs the retry budget — it cannot interrupt an in-flight
    call, so pair it with the backend's own socket ``timeout`` for hard
    I/O bounds.
    """

    def __init__(self, inner: Store, retries: int = 2,
                 backoff: float = 0.05, max_backoff: float = 2.0,
                 jitter: float = 0.5, deadline: float | None = None,
                 sleep=time.sleep, rng=None):
        super().__init__()
        self.inner = inner
        self.retries = max(0, int(retries))
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.deadline = deadline if deadline is None else float(deadline)
        self._sleep = sleep
        self._rng = rng if rng is not None else random.random
        self._label = inner.scheme or type(inner).__name__.lower()

    @property
    def remote(self):  # the wrapper is as remote as what it wraps
        return self.inner.remote

    def _call(self, op, fn, *args):
        t0 = time.monotonic()
        for attempt in range(self.retries + 1):
            try:
                return fn(*args)
            except (StoreKeyError, StoreRangeError):
                raise  # permanent: retrying cannot change the answer
            except OSError as e:
                if attempt >= self.retries:
                    raise
                delay = min(self.max_backoff,
                            self.backoff * (2.0 ** attempt))
                if self.jitter:
                    delay *= 1.0 + self.jitter * self._rng()
                if (self.deadline is not None
                        and time.monotonic() - t0 + delay >= self.deadline):
                    _DEADLINE.inc(backend=self._label, op=op)
                    obs.event("store.deadline", level="error",
                              backend=self._label, op=op,
                              attempts=attempt + 1, deadline_s=self.deadline,
                              error=f"{type(e).__name__}: {e}")
                    raise StoreDeadlineError(
                        f"{op} on {self.inner.url}: {self.deadline}s deadline"
                        f" exceeded after {attempt + 1} attempt(s): {e}"
                    ) from e
                _RETRIES.inc(backend=self._label, op=op)
                obs.event("store.retry", level="warn", backend=self._label,
                          op=op, attempt=attempt + 1,
                          delay_ms=round(delay * 1e3, 3),
                          error=f"{type(e).__name__}: {e}")
                self._sleep(delay)
        raise AssertionError("unreachable")

    # -- wrapped ops -------------------------------------------------------

    def get(self, key, byte_range=None):
        return self._call("get", self.inner.get, key, byte_range)

    def get_many(self, requests):
        return self._call("get_many", self.inner.get_many, list(requests))

    def put(self, key, data):
        return self._call("put", self.inner.put, key, data)

    def put_atomic(self, key, data):
        return self._call("put_atomic", self.inner.put_atomic, key, data)

    def list(self, prefix=""):
        return self._call("list", self.inner.list, prefix)

    def delete(self, key):
        return self._call("delete", self.inner.delete, key)

    def exists(self, key):
        return self._call("exists", self.inner.exists, key)

    # open_write uses the base buffered sink: the commit goes through
    # self.put and is therefore covered by the retry policy.  (Streaming
    # through the inner sink would leave the one op most likely to hit a
    # network fault — the member upload — outside the policy.)

    def lock(self, name):
        return self.inner.lock(name)

    def stats(self) -> dict:
        """Inner store's counters, if it keeps any."""
        inner_stats = getattr(self.inner, "stats", None)
        return inner_stats() if callable(inner_stats) else {}

    @property
    def url(self) -> str:
        return self.inner.url

    def close(self) -> None:
        inner_close = getattr(self.inner, "close", None)
        if callable(inner_close):
            inner_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
