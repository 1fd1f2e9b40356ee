"""Per-rank manifest sidecars for multi-writer in-situ append (port of
``repro.cluster.multiwriter``: the same member names, sidecars, merge order,
errors and bytes).

A single-manifest dataset serializes every commit through one object.  In a
rank-parallel in-situ run, each rank instead owns a :class:`RankWriter`: it
writes its member objects (rank-suffixed, so ranks can never collide on a
key) and commits them to a private ``manifest.rank{r}.json`` sidecar —
atomically, with zero coordination.  A coordinator later calls
:func:`merge_manifests`, which folds every sidecar entry into the main
``manifest.json`` in one atomic commit and then retires the sidecars.

Both sides take ``root`` as a path, store URL, or
:class:`~repro_torch.store.backends.Store` — rank-parallel append works over
any backend whose :meth:`Store.lock` is exclusive across the participating
writers (FileStore: ``flock``, so cross-process on a shared filesystem;
MemoryStore: in-process threads).

Crash safety at every point:

* rank crash mid-append  — its sidecar never references the torn member;
  the orphan is reclaimed by :meth:`CZDataset.gc`;
* crash before the merge commit — ``manifest.json`` is untouched, the
  dataset reads at its last committed state, sidecars survive and a re-run
  merges them;
* crash after the commit but before sidecar cleanup — the re-run sees every
  entry already committed (merge is idempotent) and just deletes sidecars.
"""
from __future__ import annotations

import numpy as np

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import container
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.core.schemes import torch_device
from repro_torch.store.backends import open_store
from repro_torch.store.dataset import _member_stats
from repro_torch.store.manifest import (
    QUANTITY_RE,
    ManifestError,
    list_rank_manifests,
    new_rank_manifest,
    rank_manifest_name,
    read_manifest,
    read_rank_manifest,
    write_manifest,
    write_rank_manifest,
)
from repro_torch.store.writer import ShardWriter

__all__ = ["RankWriter", "merge_manifests"]

#: advisory lock serializing sidecar commits against sidecar retirement.
#: Held for sidecar commit (RankWriter.append) and sidecar retirement
#: (merge_manifests): without it, an entry committed between the merge's
#: final re-read and its delete would vanish.  Member writes stay outside
#: the lock — only the tiny JSON commit is serialized, so rank contention
#: is negligible (the whole point of sidecars).
_LOCK_NAME = ".sidecar.lock"


class RankWriter:
    """One rank's append channel into a shared CZDataset.

    The dataset (and its committed default spec) must already exist — the
    coordinator creates it once with ``CZDataset(root, "a", spec=...)``
    before the ranks start.  Timestep indices are supplied by the caller
    (the simulation's step counter), not allocated from ``next_t``, since
    ranks commit independently.

    Stage 1 of every member write and the ``stats=True`` decode run on the
    torch ``device`` (default ``"cuda"``; without a GPU it raises here).
    """

    def __init__(self, root, rank: int, spec: CompressionSpec | None = None,
                 workers: int = 1, stats: bool = False, device=DEFAULT_DEVICE):
        self.device = torch_device(device)
        self.store = open_store(root)
        self.root = str(root)
        self.rank = int(rank)
        if self.rank < 0:
            raise ValueError(f"rank must be >= 0, got {rank}")
        m = read_manifest(self.store)  # dataset must exist
        self.spec = (CompressionSpec.from_json(m["spec"]) if spec is None
                     else spec.validate())
        self._writer = ShardWriter(self.spec, workers=workers, device=self.device)
        self._stats = bool(stats)
        try:
            self._side = read_rank_manifest(self.store, self.rank)
        except FileNotFoundError:
            self._side = new_rank_manifest(self.rank)

    def member_name(self, quantity: str, t: int) -> str:
        """Rank-suffixed member key — two ranks can never collide."""
        return f"{quantity}/t{int(t):06d}.r{self.rank}.cz"

    def append(self, fields: dict[str, np.ndarray], t: int,
               time: float | None = None) -> int:
        """Write member objects, then commit them to this rank's sidecar.

        Uncommitted (merged) entries are invisible to dataset readers until
        :func:`merge_manifests` folds the sidecar into the main manifest.
        """
        if not fields:
            raise ValueError("append needs at least one quantity")
        t = int(t)
        done = {(e["quantity"], e["t"]) for e in self._side["entries"]}
        staged = []
        for q, field in fields.items():
            if not QUANTITY_RE.match(q):
                raise ValueError(f"invalid quantity name {q!r}")
            if (q, t) in done:
                raise ValueError(
                    f"rank {self.rank} already appended {q!r} at t={t}")
            field = np.asarray(field)
            rel = self.member_name(q, t)
            if self.store.exists(rel):
                # members are immutable; an existing object means this (q, t)
                # was already written — merged-and-committed (a restarted
                # rank replaying a step) or orphaned by a crash.  Rewriting
                # in place could tear a committed member; refuse.
                raise IOError(
                    f"member {rel} already exists (committed or orphaned); "
                    "refusing to overwrite — gc the dataset or use a new t")
            member_spec = self._writer.spec_for(field)
            nbytes = self._writer.write(
                rel, field, spec=member_spec,
                extra_header={"quantity": q, "t": t, "time": time,
                              "rank": self.rank},
                store=self.store)
            entry = {
                "quantity": q, "t": t, "time": time, "file": rel,
                "bytes": int(nbytes), "raw_bytes": int(field.nbytes),
                "shape": list(field.shape),
                "dtype": str(member_spec.np_dtype),
            }
            if self._stats:
                entry.update(_member_stats(field, container.read_field(
                    rel, device=self.device, store=self.store)))
            staged.append(entry)
        # all members durable in the store -> one atomic sidecar commit.  The
        # stored sidecar is the truth for *unmerged* entries (a concurrent
        # merge may have retired some), so reconcile under the lock first —
        # a long-lived writer must not resurrect already-merged history.
        with self.store.lock(_LOCK_NAME):
            try:
                self._side = read_rank_manifest(self.store, self.rank)
            except FileNotFoundError:
                self._side = new_rank_manifest(self.rank)
            self._side["entries"].extend(staged)
            write_rank_manifest(self.store, self._side)
        return t

    @property
    def pending(self) -> int:
        """Entries committed to this rank's sidecar but not yet merged
        (read from the store — a concurrent merge may have retired some)."""
        try:
            return len(read_rank_manifest(self.store, self.rank)["entries"])
        except FileNotFoundError:
            return 0

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _committed(m: dict) -> dict[tuple[str, int], str]:
    return {(q, int(ts["t"])): ts["file"]
            for q, ent in m["quantities"].items()
            for ts in ent["timesteps"]}


def merge_manifests(root, remove_sidecars: bool = True) -> int:
    """Fold every rank sidecar into ``manifest.json`` in one atomic commit.

    Returns the number of newly merged entries.  Idempotent: entries already
    in the manifest are skipped, so re-running after a crash at any point
    converges.  Raises :class:`ManifestError` — *before* touching the main
    manifest — on a conflict (two different members claim one
    quantity/timestep), a sidecar referencing a missing member, or a shape
    mismatch; the dataset stays readable at its last committed state.
    """
    store = open_store(root)
    m = read_manifest(store)
    committed = _committed(m)
    ranks = list_rank_manifests(store)
    pending: list[tuple[int, dict]] = []
    for rank in ranks:
        side = read_rank_manifest(store, rank)
        for e in side["entries"]:
            key = (e["quantity"], int(e["t"]))
            if key in committed:
                if committed[key] != e["file"]:
                    raise ManifestError(
                        f"merge conflict in {store.url}: rank {rank} wrote "
                        f"{e['file']} for {key[0]!r} t={key[1]} but "
                        f"{committed[key]} is already committed")
                continue  # already merged (idempotent re-run)
            if not store.exists(e["file"]):
                raise ManifestError(
                    f"rank {rank} sidecar references missing member "
                    f"{e['file']} — refusing to commit a torn timestep")
            committed[key] = e["file"]
            pending.append((rank, e))

    if pending:
        pending.sort(key=lambda p: (int(p[1]["t"]), p[1]["quantity"], p[0]))
        touched = set()
        for rank, e in pending:
            q, t = e["quantity"], int(e["t"])
            ent = m["quantities"].setdefault(q, {
                "shape": list(e["shape"]),
                "dtype": str(e["dtype"]),
                "timesteps": [],
            })
            if tuple(ent["shape"]) != tuple(e["shape"]):
                raise ManifestError(
                    f"rank {rank} appended {q!r} with shape {e['shape']}, "
                    f"dataset has {ent['shape']}")
            if str(ent["dtype"]) != str(e["dtype"]):
                raise ManifestError(
                    f"rank {rank} appended {q!r} with dtype {e['dtype']}, "
                    f"dataset has {ent['dtype']}")
            rec = {"t": t, "time": e["time"], "file": e["file"],
                   "bytes": int(e["bytes"]), "raw_bytes": int(e["raw_bytes"])}
            for k in ("psnr", "max_err"):
                if k in e:
                    rec[k] = e[k]
            ent["timesteps"].append(rec)
            touched.add(q)
            m["next_t"] = max(int(m["next_t"]), t + 1)
        for q in touched:
            m["quantities"][q]["timesteps"].sort(key=lambda ts: ts["t"])
        m["version"] = int(m["version"]) + 1
        write_manifest(store, m)  # the single atomic commit point

    if remove_sidecars:
        # a rank may have committed new entries after we read its sidecar:
        # under the sidecar lock (which serializes us against every rank's
        # commit), re-read, keep anything not yet in the manifest, and only
        # retire a fully merged sidecar — concurrent appends are never
        # dropped
        for rank in ranks:
            with store.lock(_LOCK_NAME):
                try:
                    side = read_rank_manifest(store, rank)
                except FileNotFoundError:
                    continue
                remaining = [
                    e for e in side["entries"]
                    if committed.get((e["quantity"], int(e["t"]))) != e["file"]
                ]
                if remaining:
                    side["entries"] = remaining
                    write_rank_manifest(store, side)
                else:
                    store.delete(rank_manifest_name(rank))
    return len(pending)
