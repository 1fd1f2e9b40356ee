"""The ``Store`` protocol: a minimal byte-store interface under CZDataset.

A store maps **keys** (relative POSIX-style paths, ``"p/t000000.cz"``) to
immutable byte objects.  The protocol is deliberately small — the shape of
an object store, not a filesystem — so any backend that can do whole-object
put and byte-range get can hold a dataset:

* :meth:`Store.get` — fetch an object, optionally a byte range of it (the
  random-access path: ``FieldReader`` pulls footers and chunks with ranged
  gets and never holds an open handle);
* :meth:`Store.get_many` — batched ranged gets (default: a sequential
  loop); remote backends override with a pipelined fetch so prefetch can
  overlap round-trips with decode;
* :meth:`Store.put` — write a whole object (members are immutable once
  written, so there is no partial update to express);
* :meth:`Store.put_atomic` — all-or-nothing overwrite, the manifest commit
  primitive.  Object stores get this for free (PUT is atomic); file
  backends implement tmp + fsync + rename;
* :meth:`Store.list` / :meth:`Store.delete` / :meth:`Store.exists` — the
  enumeration half, enough for ``CZDataset.gc``;
* :meth:`Store.open_write` — a seekable streaming sink for the CZ2 writer.
  The default buffers and commits through :meth:`put` on close (object
  stores cannot seek); :class:`FileStore` overrides it with a real file so
  the streaming writer stays one-chunk-in-memory and bit-compatible;
* :meth:`Store.lock` — a named advisory exclusive lock (sidecar commit vs.
  merge).  Default is in-process; file backends use ``flock`` so the
  guarantee spans processes.

Keys never contain ``..``, empty segments, or a leading ``/`` — a store is
a closed namespace and a key cannot escape it.
"""
from __future__ import annotations

import abc
import contextlib
import io
import threading
from concurrent.futures import ThreadPoolExecutor

__all__ = ["Store", "StoreKeyError", "StoreRangeError", "check_key",
           "check_range", "shared_io_pool"]


class StoreKeyError(KeyError):
    """The requested key is not in the store."""

    def __str__(self):  # KeyError repr()s its arg; keep messages readable
        return self.args[0] if self.args else ""


class StoreRangeError(IOError):
    """A ranged get started at or past the object's end (HTTP 416).

    Permanent like :class:`StoreKeyError` — the request can never succeed
    against the object as stored — so retry layers must not retry it.
    """

    def __init__(self, key: str, start: int, size: int):
        super().__init__(
            f"range start {start} is at/past the end of {key!r} "
            f"({size if size >= 0 else 'unknown'} bytes)")
        self.key = key
        self.start = int(start)
        self.size = int(size)


def check_range(key: str, start: int, size: int) -> int:
    """Validate a range start against an object of ``size`` bytes, per the
    :meth:`Store.get` contract: ``start == 0`` is always in range (an empty
    object reads as ``b""``), any other start must fall strictly inside the
    object.  Returns ``start`` as an int."""
    start = int(start)
    if start < 0:
        raise ValueError(f"byte_range start must be >= 0, got {start}")
    if start and start >= size:
        raise StoreRangeError(key, start, size)
    return start


_IO_POOL: ThreadPoolExecutor | None = None
_IO_POOL_GUARD = threading.Lock()


def shared_io_pool() -> ThreadPoolExecutor:
    """Process-wide daemon pool for pipelined store I/O (``get_many``
    overrides).  Deliberately separate from the reader-side prefetch pool in
    :mod:`repro_torch.core.container` — a prefetch task fanning out through
    ``get_many`` must never wait on its own pool for the nested work."""
    global _IO_POOL
    with _IO_POOL_GUARD:
        if _IO_POOL is None:
            _IO_POOL = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="cz-store-io")
        return _IO_POOL


def check_key(key: str) -> str:
    """Validate a store key (relative POSIX path, no escape hatches)."""
    if not isinstance(key, str) or not key:
        raise ValueError(f"store key must be a non-empty str, got {key!r}")
    if key.startswith("/") or "\\" in key:
        raise ValueError(f"store key must be a relative POSIX path: {key!r}")
    if any(part in ("", ".", "..") for part in key.split("/")):
        raise ValueError(f"store key must not contain empty, '.' or '..' "
                         f"segments: {key!r}")
    return key


class _BufferedWriter(io.BytesIO):
    """Seekable write buffer that commits to ``store.put(key)`` on a clean
    close — the default ``open_write`` sink for backends that cannot seek
    inside an object.  An exception inside the ``with`` block abandons the
    buffer: object stores never expose a torn write."""

    def __init__(self, store: "Store", key: str):
        super().__init__()
        self._store: Store | None = store
        self._key = key

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._store = None  # abandon: no partial object is ever visible
        self.close()

    def close(self):
        if not self.closed:
            store, data = self._store, self.getvalue()
            super().close()
            if store is not None:
                store.put(self._key, data)


class Store(abc.ABC):
    """Abstract byte store.  See the module docstring for the contract."""

    #: URL scheme this backend answers to (``open_store`` routing), or None
    #: for backends that are only constructed programmatically.
    scheme: str | None = None

    #: True for backends that cross a network (HttpStore): ``open_store``
    #: wraps these in a RetryStore by default so transient faults are
    #: absorbed by policy, not by every caller.
    remote: bool = False

    def __init__(self):
        self._locks: dict[str, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    # -- required primitives -----------------------------------------------

    @abc.abstractmethod
    def get(self, key: str, byte_range: tuple[int, int | None] | None = None
            ) -> bytes:
        """The object at ``key``, or its ``[start, end)`` slice when
        ``byte_range`` is given (``end=None`` means to the object's end).
        Raises :class:`StoreKeyError` for a missing key.

        Range semantics are pinned across all backends (the HTTP-416
        contract): a *short read is allowed only at EOF* — ``end`` past the
        object's end returns the bytes that exist from ``start`` — but a
        ``start`` at or past the object's end raises
        :class:`StoreRangeError`.  ``start == 0`` is always in range, so an
        empty object reads as ``b""`` and header probes on short objects
        still see whatever bytes exist.  Backends validate with
        :func:`check_range`."""

    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> None:
        """Write the whole object at ``key`` (overwrites)."""

    @abc.abstractmethod
    def list(self, prefix: str = "") -> list[str]:
        """All keys starting with ``prefix``, sorted."""

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        """Remove ``key``; :class:`StoreKeyError` if absent."""

    @abc.abstractmethod
    def exists(self, key: str) -> bool:
        """Whether ``key`` holds an object."""

    # -- derived operations (override for a better native implementation) --

    def get_many(self, requests) -> list[bytes]:
        """Fetch several ``(key, byte_range)`` pairs; the async half of the
        read path (the Zarr-v3 ``async_get`` shape).  Returns the payloads
        in request order.  The default is a sequential loop — correct for
        local backends where per-request latency is negligible; remote
        backends (HttpStore, RangeStore) override with a thread-pooled
        pipelined fetch so the reader's prefetcher overlaps round-trips.

        Error semantics match N sequential :meth:`get` calls except that
        the first failure wins and the remaining results are discarded.
        """
        return [self.get(key, byte_range) for key, byte_range in requests]

    def put_atomic(self, key: str, data: bytes) -> None:
        """All-or-nothing durable overwrite — the manifest commit primitive.
        The default is :meth:`put`, correct wherever whole-object put is
        already atomic (every object store); file backends override with
        tmp + fsync + rename."""
        self.put(key, data)

    def open_write(self, key: str):
        """Context manager yielding a seekable binary sink for ``key``,
        committed on clean close.  Default: buffer + :meth:`put`."""
        check_key(key)
        return _BufferedWriter(self, key)

    def lock(self, name: str):
        """Context manager holding a named exclusive advisory lock.  The
        default is in-process (one lock object per name per store instance
        — named ``mem://`` stores share instances, so threads contend
        correctly); :class:`FileStore` uses ``flock`` to span processes."""
        with self._locks_guard:
            lk = self._locks.setdefault(name, threading.Lock())

        @contextlib.contextmanager
        def _held():
            with lk:
                yield

        return _held()

    # -- identity ----------------------------------------------------------

    @property
    def url(self) -> str:
        """Display / reopen URL for this store."""
        return f"{self.scheme or type(self).__name__.lower()}://"

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.url!r})"
