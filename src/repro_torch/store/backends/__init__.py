"""``repro_torch.store.backends`` — pluggable byte stores (a copy of
``repro.store.backends``, stdlib only apart from ``repro_torch.obs``).

Zarr names the design goal: a "pluggable storage subsystem with support for
file systems, key-value databases and cloud object stores".  The port's CZ2
container (``repro_torch.core.container``: the writers, ``read_field``,
``describe`` and ``FieldReader``) talks to a :class:`Store` — *what* is
stored (chunk streams + footers) is decoupled from *where* it lives.  The
classes, URL schemes, metric names and labels are the reference's, so the
same bytes sit behind the same keys in either package.

Built-in backends:

========== ===================== =========================================
URL scheme class                 semantics
========== ===================== =========================================
``file://`` :class:`FileStore`   local directory; plain paths resolve here
``mem://``  :class:`MemoryStore` process-local dict; named URLs share one
                                 instance per process (tests, ephemeral
                                 in-situ runs)
``range://`` :class:`RangeStore` object-store semantics: whole-object put,
                                 byte-range get, request counters — keeps
                                 the read path honest
``http://``  :class:`HttpStore`  read-only ranged gets against any static
``https://``                     file server (keep-alive pooled; wrapped in
                                 :class:`RetryStore` by default)
========== ===================== =========================================

Third-party backends subclass :class:`Store` and register a URL scheme with
:func:`register_store_scheme`; :func:`open_store` then accepts their URLs.
"""
from __future__ import annotations

import os

from .base import (Store, StoreKeyError, StoreRangeError,  # noqa: F401
                   check_key, check_range)
from .file import FileStore  # noqa: F401
from .flaky import FlakyStore, InjectedFault  # noqa: F401
from .http import HttpStore, StaticFileServer  # noqa: F401
from .instrument import InstrumentedStore, StoreMeter  # noqa: F401
from .memory import MemoryStore  # noqa: F401
from .object import RangeStore  # noqa: F401
from .retry import RetryStore, StoreDeadlineError  # noqa: F401

__all__ = ["Store", "StoreKeyError", "StoreRangeError", "StoreDeadlineError",
           "check_key", "check_range", "FileStore", "MemoryStore",
           "RangeStore", "HttpStore", "StaticFileServer", "RetryStore",
           "FlakyStore", "InjectedFault", "InstrumentedStore",
           "StoreMeter", "open_store", "register_store_scheme",
           "STORE_SCHEMES"]

#: URL scheme -> factory taking the part after ``scheme://``.
STORE_SCHEMES: dict[str, type | object] = {
    "file": FileStore.from_url,
    "mem": MemoryStore.from_url,
    "range": RangeStore.from_url,
    "http": HttpStore.from_url,
    "https": lambda rest: HttpStore.from_url(rest, secure=True),
}


def register_store_scheme(scheme: str, factory) -> None:
    """Register a third-party store: ``factory(rest)`` gets the URL part
    after ``{scheme}://`` and returns a :class:`Store`."""
    if not scheme or "://" in scheme:
        raise ValueError(f"invalid store scheme {scheme!r}")
    STORE_SCHEMES[str(scheme)] = factory


def open_store(root, *, instrument: bool = False,
               retries: int | None = None,
               timeout: float | None = None) -> Store:
    """Resolve a dataset root to a :class:`Store`.

    ``root`` is a :class:`Store` (returned as-is, possibly policy-wrapped),
    a URL (``file:///data/run42``, ``mem://myds``, ``http://host/ds``, any
    registered scheme), or a plain local path (the historical form —
    resolves to a :class:`FileStore`).

    ``instrument=True`` wraps the resolved backend in an
    :class:`InstrumentedStore` so every op is metered into the global
    ``cz_store_*`` registry series (already-instrumented stores pass
    through unwrapped).

    ``retries``/``timeout`` configure the :class:`RetryStore` policy layer:
    backends that declare ``remote = True`` (HttpStore) are wrapped by
    default with 2 retries; ``retries=N`` forces wrapping of any backend,
    ``retries=0`` opts out.  ``timeout`` sets the remote backend's socket
    timeout *and* the retry layer's per-op deadline.  The retry wrapper
    goes outermost (``Retry(Instrumented(inner))``) so each attempt is
    metered individually.
    """
    if isinstance(root, Store):
        store = root
    else:
        root = os.fspath(root)
        if "://" in root:
            scheme, rest = root.split("://", 1)
            try:
                factory = STORE_SCHEMES[scheme]
            except KeyError:
                raise ValueError(
                    f"unknown store scheme {scheme!r} in {root!r} (registered:"
                    f" {', '.join(sorted(STORE_SCHEMES))})") from None
            store = factory(rest)
        else:
            store = FileStore(root)
    if timeout is not None and isinstance(store, HttpStore):
        store.timeout = float(timeout)
    if instrument and not isinstance(store, (InstrumentedStore, RangeStore)):
        store = InstrumentedStore(store)
    if not isinstance(store, RetryStore):
        if retries is None:
            if store.remote:
                store = RetryStore(store, deadline=timeout)
        elif retries > 0:
            store = RetryStore(store, retries=retries, deadline=timeout)
    return store
