"""Dataset manifest: one JSON object, committed atomically (a copy of
``repro.store.manifest``; the same schema, error messages and bytes).

The manifest is the *only* mutable object in a CZDataset.  Member objects
are immutable once written; a timestep exists iff the manifest references
it, so the commit protocol is write-members -> ``Store.put_atomic`` of the
manifest.  On a file backend that is the tmp + fsync + rename +
directory-fsync sequence; on an object store a single PUT is already
atomic.  A crash between member write and manifest commit leaves orphaned
member objects but never a dataset that references missing or partial
data.

Every function here takes ``root`` as either a local path / store URL or a
:class:`~repro_torch.store.backends.Store` instance — one code path for
every backend.

Rank sidecars (``manifest.rank{r}.json``) extend the same protocol to
multi-writer runs: each rank commits its own sidecar atomically, with no
contention on ``manifest.json``, and a coordinator later folds them into
the main manifest.  A sidecar entry is *live* — :meth:`CZDataset.gc` must
not collect its member — until the merge commits it and deletes the
sidecar.
"""
from __future__ import annotations

import json
import re

from .backends import Store, StoreKeyError, open_store

__all__ = ["MANIFEST_NAME", "MANIFEST_FORMAT", "QUANTITY_RE", "ManifestError",
           "new_manifest", "read_manifest", "write_manifest",
           "RANK_MANIFEST_RE", "rank_manifest_name", "list_rank_manifests",
           "new_rank_manifest", "read_rank_manifest", "write_rank_manifest"]

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = 1

#: legal quantity names (also member key prefixes); the lookahead rejects
#: all-dot names ('.', '..') that would escape the dataset root
QUANTITY_RE = re.compile(r"^(?!\.+$)[A-Za-z0-9_.\-]+$")

RANK_MANIFEST_RE = re.compile(r"^manifest\.rank(\d+)\.json$")


class ManifestError(IOError):
    """The dataset manifest is missing, unreadable, or structurally invalid."""


def _store(root) -> Store:
    return root if isinstance(root, Store) else open_store(root)


def new_manifest(spec_json: dict) -> dict:
    return {
        "magic": "CZDS",
        "format": MANIFEST_FORMAT,
        "version": 0,          # bumped on every commit
        "next_t": 0,           # next timestep index to assign
        "spec": spec_json,     # dataset-default CompressionSpec
        "quantities": {},      # name -> {shape, dtype, timesteps: [...]}
    }


def _check(m: dict, where: str) -> dict:
    if not isinstance(m, dict) or m.get("magic") != "CZDS":
        raise ManifestError(
            f"{where}/{MANIFEST_NAME} is not a CZDataset manifest (bad magic)")
    if int(m.get("format", 0)) > MANIFEST_FORMAT:
        raise ManifestError(
            f"manifest format {m['format']} is newer than supported "
            f"({MANIFEST_FORMAT}) — upgrade repro to read {where}")
    for key in ("version", "next_t", "spec", "quantities"):
        if key not in m:
            raise ManifestError(f"manifest in {where} is missing {key!r}")
    for q, ent in m["quantities"].items():
        for key in ("shape", "dtype", "timesteps"):
            if key not in ent:
                raise ManifestError(
                    f"manifest entry for quantity {q!r} is missing {key!r}")
    return m


def _load_json(store: Store, key: str, what: str) -> dict:
    data = store.get(key)  # StoreKeyError propagates to the caller
    try:
        return json.loads(data)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ManifestError(f"corrupt {what} {store.url}/{key}: {e}") from None


def read_manifest(root) -> dict:
    store = _store(root)
    try:
        m = _load_json(store, MANIFEST_NAME, "manifest")
    except StoreKeyError:
        raise ManifestError(
            f"no {MANIFEST_NAME} in {store.url} — not a CZDataset "
            "(or the first commit never completed)") from None
    return _check(m, store.url)


def _atomic_json(store: Store, name: str, obj: dict) -> None:
    """``put_atomic`` of an indented-JSON object — the commit primitive
    shared by the main manifest and the per-rank sidecars."""
    store.put_atomic(name, json.dumps(obj, indent=1).encode())


def write_manifest(root, manifest: dict) -> None:
    """Atomic commit through ``Store.put_atomic`` (file backends: tmp write
    + fsync + rename + directory fsync; object stores: one PUT).  Member
    objects are made durable by :class:`~repro_torch.store.ShardWriter` before
    this is called."""
    _atomic_json(_store(root), MANIFEST_NAME, manifest)


# -- per-rank sidecars -------------------------------------------------------

def rank_manifest_name(rank: int) -> str:
    return f"manifest.rank{int(rank)}.json"


def list_rank_manifests(root) -> list[int]:
    """Ranks with a committed sidecar in ``root``, ascending."""
    ranks = []
    for key in _store(root).list("manifest.rank"):
        m = RANK_MANIFEST_RE.match(key)
        if m:
            ranks.append(int(m.group(1)))
    return sorted(ranks)


def new_rank_manifest(rank: int) -> dict:
    return {"magic": "CZRK", "format": MANIFEST_FORMAT,
            "rank": int(rank), "entries": []}


def read_rank_manifest(root, rank: int) -> dict:
    store = _store(root)
    name = rank_manifest_name(rank)
    try:
        side = _load_json(store, name, "rank sidecar")
    except StoreKeyError:
        # historical contract: a missing sidecar is FileNotFoundError, on
        # every backend
        raise FileNotFoundError(f"{store.url}/{name}") from None
    if not isinstance(side, dict) or side.get("magic") != "CZRK":
        raise ManifestError(f"{name} in {store.url} is not a rank sidecar "
                            "(bad magic)")
    if int(side.get("rank", -1)) != int(rank):
        raise ManifestError(
            f"{name} claims rank {side.get('rank')}, expected {rank}")
    for e in side.get("entries", []):
        for key in ("quantity", "t", "time", "file", "bytes", "raw_bytes",
                    "shape", "dtype"):
            if key not in e:
                raise ManifestError(f"sidecar entry in {name} missing {key!r}")
    return side


def write_rank_manifest(root, side: dict) -> None:
    """Atomic sidecar commit — a rank's private, contention-free analogue of
    :func:`write_manifest`."""
    _atomic_json(_store(root), rank_manifest_name(side["rank"]), side)
