"""Structured JSON-lines event log, request-correlated.

The diagnostics channel for everything inside ``src/repro_torch`` that is not a
metric or a span: one :func:`event` call emits one JSON object with a
timestamp, a level, the event name, the active request ID (from
:mod:`repro_torch.obs.context`, when inside a request scope), and any keyword
fields — never a bare ``print``.  The CI lint enforces the flip side: no
``print(`` diagnostics outside the CLI modules.

Two destinations, both optional and both owned by the process-wide
:data:`LOG`:

* a bounded in-memory ring (always on; :func:`tail` reads it back —
  tests and the ``/debug`` endpoints use this), and
* a JSON-lines sink — a file path or a stream — enabled via
  :func:`configure` (``cz-compress serve --events OUT.jsonl`` on the CLI).

Levels are the usual ``debug < info < warn < error``; events below the
configured threshold are dropped at the call site.

Stdlib only — importable before numpy/jax.
"""
from __future__ import annotations

import collections
import json
import threading
import time

from repro_torch.obs import context as _context

__all__ = ["EventLog", "LOG", "LEVELS", "event", "configure", "tail"]

#: level names in severity order (numeric thresholds for filtering).
LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


def _level_num(level: str) -> int:
    try:
        return LEVELS[level]
    except KeyError:
        raise ValueError(f"unknown event level {level!r}; "
                         f"one of {sorted(LEVELS)}") from None


class EventLog:
    """One event sink: bounded ring + optional JSON-lines stream."""

    def __init__(self, ring: int = 512, level: str = "info"):
        self._lock = threading.Lock()
        self._ring: collections.deque[dict] = collections.deque(maxlen=ring)
        self._min = _level_num(level)
        self._level = level
        self._stream = None
        self._owns_stream = False
        self.emitted = 0
        self.suppressed = 0

    # -- configuration -------------------------------------------------------

    def configure(self, path: str | None = None, stream=None,
                  level: str | None = None, ring: int | None = None) -> None:
        """Point the log at a JSON-lines sink and/or adjust filtering.

        ``path`` opens (appends to) a file this log then owns; ``stream``
        is any writable text object the *caller* owns.  Passing neither
        leaves the sink unchanged; ``path=None, stream=None`` with an
        explicit prior sink keeps it (use :meth:`close` to drop it).
        """
        with self._lock:
            if level is not None:
                self._min = _level_num(level)
                self._level = level
            if ring is not None:
                self._ring = collections.deque(self._ring, maxlen=int(ring))
            if path is not None and stream is not None:
                raise ValueError("configure takes path or stream, not both")
            if path is not None or stream is not None:
                self._close_stream()
                if path is not None:
                    self._stream = open(path, "a", encoding="utf-8")
                    self._owns_stream = True
                else:
                    self._stream = stream
                    self._owns_stream = False

    def _close_stream(self) -> None:
        if self._stream is not None and self._owns_stream:
            self._stream.close()
        self._stream = None
        self._owns_stream = False

    def close(self) -> None:
        """Drop (and close, if owned) the JSON-lines sink; ring survives."""
        with self._lock:
            self._close_stream()

    @property
    def level(self) -> str:
        return self._level

    # -- emission ------------------------------------------------------------

    def event(self, name: str, level: str = "info", **fields) -> dict | None:
        """Emit one structured event; returns the record (or None if the
        level filter dropped it).  ``request_id`` is stamped automatically
        from the active request scope."""
        if _level_num(level) < self._min:
            with self._lock:
                self.suppressed += 1
            return None
        rec: dict = {"ts": round(time.time(), 6), "level": level,
                     "event": str(name)}
        rid = _context.request_id()
        if rid is not None:
            rec["request_id"] = rid
        for k, v in fields.items():
            rec[k] = v
        with self._lock:
            self._ring.append(rec)
            self.emitted += 1
            if self._stream is not None:
                try:
                    self._stream.write(json.dumps(rec, default=str) + "\n")
                    self._stream.flush()
                except (OSError, ValueError):
                    # a torn sink (disk full, closed stream) must not take
                    # the serving thread down with it
                    self._close_stream()
        return rec

    # -- readback ------------------------------------------------------------

    def tail(self, n: int = 50) -> list[dict]:
        """The most recent ``n`` events, oldest first (copies)."""
        with self._lock:
            items = list(self._ring)
        return [dict(r) for r in items[-int(n):]]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


#: the process-wide event log (module-level helpers target it).
LOG = EventLog()


def event(name: str, level: str = "info", **fields) -> dict | None:
    """``events.event("http.request", code=200, ...)`` against :data:`LOG`."""
    return LOG.event(name, level=level, **fields)


def configure(path: str | None = None, stream=None, level: str | None = None,
              ring: int | None = None) -> None:
    LOG.configure(path=path, stream=stream, level=level, ring=ring)


def tail(n: int = 50) -> list[dict]:
    return LOG.tail(n)
