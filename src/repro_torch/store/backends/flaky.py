"""FlakyStore: fault-injection wrapper for read/write-path resilience tests.

Wraps any :class:`Store` and raises an injected :class:`IOError` on
configured operations.  A dataset written through the inner store can be
read through a flaky view of it — proving that a mid-``read_box`` fetch
failure surfaces as a clean error and that an immediate retry succeeds
against intact caches — and, since the commit path is also injectable, that
a fault in the middle of an append or sidecar merge leaves the dataset
readable at its last committed state.

Knobs (all 1-based counts across the wrapper's lifetime, reassignable
between operations — ``flaky.fail_on_get = flaky.gets + 1`` arms the *next*
get):

* ``fail_on_get`` — fail the Nth ``get``/``get_many`` request;
* ``fail_on_put`` — fail the Nth write (``put`` and ``put_atomic`` share
  one counter, ``puts``, because a commit is a commit either way; the
  buffered ``open_write`` sink commits through ``put``, so streamed member
  writes are injectable too);
* ``fail_on_op`` — ``{"delete": 2, "list": 1, ...}``, a per-op arm for
  anything else (``exists`` is never faulted: it is the probe readers use
  to *recognize* state, not to change it);
* ``fail_every`` — repeat the failure periodically after the first;
  ``None`` (default) fails exactly once per armed counter.

:class:`InjectedFault` subclasses :class:`IOError`, so a
:class:`~repro_torch.store.backends.retry.RetryStore` wrapped around a flaky
store treats the injected faults as transient — the deterministic harness
for retry/backoff tests.
"""
from __future__ import annotations

import threading

from .base import Store

__all__ = ["FlakyStore", "InjectedFault"]


class InjectedFault(IOError):
    """The configured fault, raised by :class:`FlakyStore`."""


class FlakyStore(Store):
    """Delegating store that raises on configured operation counts."""

    def __init__(self, inner: Store, fail_on_get: int | None = None,
                 fail_every: int | None = None,
                 fail_on_put: int | None = None,
                 fail_on_op: dict[str, int] | None = None):
        super().__init__()
        self.inner = inner
        self.fail_on_get = fail_on_get
        self.fail_on_put = fail_on_put
        self.fail_on_op = dict(fail_on_op or {})
        self.fail_every = fail_every
        self.gets = 0
        self.puts = 0
        self.op_calls: dict[str, int] = {}
        self.faults = 0
        self._count_guard = threading.Lock()

    def _armed(self, n: int, first: int | None) -> bool:
        if first is None or n < first:
            return False
        return n == first or bool(
            self.fail_every and (n - first) % self.fail_every == 0)

    def _maybe_fail(self, op: str) -> None:
        with self._count_guard:
            n_op = self.op_calls[op] = self.op_calls.get(op, 0) + 1
            checks = [(op, n_op, self.fail_on_op.get(op))]
            if op == "get":
                self.gets += 1
                checks.append(("get", self.gets, self.fail_on_get))
            elif op in ("put", "put_atomic"):
                self.puts += 1
                checks.append(("put", self.puts, self.fail_on_put))
            for what, n, first in checks:
                if self._armed(n, first):
                    self.faults += 1
                    raise InjectedFault(
                        f"injected fault on {what} #{n} (op={op})")

    def get(self, key, byte_range=None):
        self._maybe_fail("get")
        return self.inner.get(key, byte_range)

    def get_many(self, requests):
        reqs = list(requests)
        for _ in reqs:  # each request in the batch counts toward the arm
            self._maybe_fail("get")
        return self.inner.get_many(reqs)

    def put(self, key, data):
        self._maybe_fail("put")
        self.inner.put(key, data)

    def put_atomic(self, key, data):
        self._maybe_fail("put_atomic")
        self.inner.put_atomic(key, data)

    def list(self, prefix=""):
        self._maybe_fail("list")
        return self.inner.list(prefix)

    def delete(self, key):
        self._maybe_fail("delete")
        self.inner.delete(key)

    def exists(self, key):
        return self.inner.exists(key)

    # open_write intentionally NOT delegated: the base buffered sink commits
    # through self.put on clean close, which routes streamed member writes
    # through put-fault injection and guarantees no torn object is ever
    # visible when the injected fault fires mid-commit.

    def lock(self, name):
        return self.inner.lock(name)

    @property
    def url(self) -> str:
        return f"flaky+{self.inner.url}"
