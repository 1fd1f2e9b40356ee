"""``repro_torch.store`` — the sharded multi-quantity dataset store over CZ2
members (counterpart of ``repro.store``).

A dataset is many quantities x many timesteps on one pluggable byte store
(:mod:`repro_torch.store.backends`: a directory or ``file://`` URL,
``mem://``, ``range://``, ``http://``):

::

    dataset/
      manifest.json            # the ONLY mutable object; atomic put_atomic
      p/
        t000000.cz             # CZ2 container: quantity "p", timestep 0
      rho/
        t000000.cz

* Every member is an ordinary CZ2 container
  (:mod:`repro_torch.core.container`) and reads standalone too.
* ``manifest.json`` is the commit point, in the reference's schema and
  bytes (format 1): members are written first and the manifest is replaced
  through ``Store.put_atomic``, so a crash mid-append leaves at most
  orphaned members.  Either package opens a dataset the other wrote.
* :class:`CZDataset` appends timesteps (``mode="a"``) through one
  :class:`ShardWriter` whose thread pool encodes the chunks of every
  member, byte-identical to a serial write; ``read_box`` decodes only the
  chunks covering a sub-box through cached ``FieldReader`` objects.  Stage 1
  and every decode run on the torch ``device`` the dataset is opened with
  (default ``"cuda"``).
* Rank sidecars (``manifest.rank{r}.json``) hold members a multi-writer run
  committed but has not merged yet; ``CZDataset.gc()`` never collects them.

This module resolves its exports lazily (PEP 562):
``repro_torch.core.container`` imports :mod:`repro_torch.store.backends`,
and :mod:`repro_torch.store.dataset` imports the container — eager
re-exports here would close that loop.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "CZDataset": ".dataset",
    "ShardWriter": ".writer",
    "DtypeCoercionWarning": ".writer",
    "ManifestError": ".manifest",
    "MANIFEST_NAME": ".manifest",
    "Store": ".backends",
    "StoreKeyError": ".backends",
    "FileStore": ".backends",
    "MemoryStore": ".backends",
    "RangeStore": ".backends",
    "FlakyStore": ".backends",
    "InjectedFault": ".backends",
    "open_store": ".backends",
    "register_store_scheme": ".backends",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value  # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
