"""CZDataset: per-quantity/per-timestep CZ2 members over a byte store (port
of ``repro.store.dataset``).

See :mod:`repro_torch.store` for the store layout.  One object serves both
ends of the paper's workflow:

* **append mode** — an in-situ simulation opens the dataset once and calls
  :meth:`CZDataset.append` as snapshots are produced; every commit writes the
  member objects first and then atomically replaces the manifest, so readers
  never observe a half-written timestep.
* **random access** — :meth:`CZDataset.read_box` decodes only the chunks
  covering the requested sub-box through a pool of cached
  :class:`~repro_torch.core.container.FieldReader` objects (each with its
  own LRU chunk cache); chunks are fetched from the store as byte ranges,
  and the full field is never inflated for a region query.

The backing store is pluggable (:mod:`repro_torch.store.backends`): ``root``
is a local path, a store URL (``file://``, ``mem://``, ``range://``,
anything registered), or a :class:`~repro_torch.store.backends.Store`
instance.  Manifests and members are the reference's bytes, so either
package opens a dataset the other wrote.

With a ``torch.distributed`` process group (``group=``), an append is
collective: every rank of the group appends at the same point, each with
its own slab of every quantity (on its own device), and each member holds
the global field, the slabs stacked along axis 0 in rank order, written by
all ranks into one shared file (see :mod:`repro_torch.store.writer`).  Rank
0 owns the manifest: it commits the timestep only once every rank's bytes
are in every member and each member's footer is fsynced.

Every stage 1 and every decode runs on the torch ``device`` the dataset is
opened with (default ``"cuda"``, checked at once: without a GPU it raises):
the :class:`ShardWriter`'s writes, the readers behind ``read_box`` and
``read_field``, and the ``stats=True`` decode of each appended member.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import container, metrics
from repro_torch.core.container import FieldReader
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.core.schemes import torch_device
from repro_torch.kernels import _obs as kobs
from repro_torch.obs import trace

from .backends import Store, open_store
from .manifest import (
    MANIFEST_NAME,
    QUANTITY_RE,
    RANK_MANIFEST_RE,
    ManifestError,
    list_rank_manifests,
    new_manifest,
    read_manifest,
    read_rank_manifest,
    write_manifest,
)
from .writer import ShardWriter, _as_field

__all__ = ["CZDataset"]


#: the store key of quantity ``q``'s member at timestep ``t``
_MEMBER = "{q}/t{t:06d}.cz"


def _member_stats(field: np.ndarray | torch.Tensor, dec: np.ndarray) -> dict:
    """Per-member quality record (PSNR is None when the member is lossless —
    JSON has no Infinity).  A tensor field is copied to the host for it,
    counted at site ``dataset.member_stats``."""
    if isinstance(field, torch.Tensor):
        kobs.count_copy(field, "cpu", "dataset.member_stats")
        field = field.cpu().numpy()
    p = metrics.psnr(field, dec)
    err = float(np.max(np.abs(np.asarray(field, np.float64)
                              - np.asarray(dec, np.float64))))
    return {"psnr": float(p) if np.isfinite(p) else None, "max_err": err}


class CZDataset:
    """Sharded multi-quantity dataset store over CZ2 member objects.

    Parameters
    ----------
    root:
        Dataset location: a local directory path, a store URL
        (``file:///data/run42``, ``mem://scratch``, ``range://sim``), or a
        :class:`~repro_torch.store.backends.Store` instance.
    mode:
        ``"r"`` (read-only, manifest must exist) or ``"a"`` (append; the
        dataset is created on first use if ``root`` holds no manifest).
    spec:
        Dataset-default :class:`CompressionSpec` for newly created datasets
        (ignored when opening an existing one — the committed spec wins).
        The dtype tag is re-derived per quantity from the appended array.
    workers:
        Encode threads shared by all member writes of this dataset
        (``1`` = serial; output is byte-identical either way).
    stats:
        Record per-member quality stats (PSNR / max error vs. the appended
        field, via :mod:`repro_torch.core.metrics`) in each committed
        timestep — the paper's testbed-of-comparison readout, shown by
        ``inspect --stats``.  Costs one decode per append.
    prefetch:
        Chunks each reader fetches ahead during ``read_box`` (0 = off).
    device:
        Torch device of every stage 1 and decode (``"cuda"`` or ``"cpu"``).
        ``spec.device`` stays provenance: each member's header records where
        its stage 1 ran.
    group:
        A ``torch.distributed`` process group (gloo) whose ranks append
        together (append mode, a file store, no ``stats``); ``None``
        appends alone.  Opening is collective too: rank 0 reads or creates
        the manifest, then the others read it.
    """

    def __init__(self, root, mode: str = "r",
                 spec: CompressionSpec | None = None, workers: int = 1,
                 cache_readers: int = 8, cache_chunks: int = 8,
                 stats: bool = False, prefetch: int = 0,
                 device=DEFAULT_DEVICE, group=None):
        if mode not in ("r", "a"):
            raise ValueError(f"mode must be 'r' or 'a', got {mode!r}")
        if group is not None and (mode != "a" or stats):
            raise ValueError("a dataset shared by a group appends (mode='a') "
                             "and records no stats")
        self.device = torch_device(device)
        self.store = open_store(root)
        self.root = (self.store.url if isinstance(root, Store) else str(root))
        self.mode = mode
        self._stats = bool(stats)
        self._lock = threading.RLock()
        self._cache_readers = cache_readers
        self._cache_chunks = cache_chunks
        #: chunks each reader fetches ahead during read_box (0 = off);
        #: worth turning on for remote (http://, latency-bearing) stores
        self._prefetch = max(0, int(prefetch))
        self._readers: collections.OrderedDict[tuple[str, int], FieldReader] = \
            collections.OrderedDict()
        self._retired_decoded = 0
        self._retired_hits = 0
        self._group = group

        if group is not None and getattr(self.store, "path_for", None) is None:
            raise ValueError("a dataset shared by a group needs a file store: "
                             "every rank writes at its offset in each member")
        if group is None:
            self._m = self._open_manifest(spec)
        else:
            self._m = self._open_shared(spec)
        self.spec = CompressionSpec.from_json(self._m["spec"])
        self._writer = (ShardWriter(self.spec, workers=workers,
                                    device=self.device)
                        if mode == "a" else None)

    def _open_manifest(self, spec: CompressionSpec | None) -> dict:
        try:
            return read_manifest(self.store)
        except ManifestError:
            if self.mode != "a" or self.store.exists(MANIFEST_NAME):
                raise  # corrupt, or missing in read-only mode: surface it
            m = new_manifest((spec or CompressionSpec()).validate().to_json())
            write_manifest(self.store, m)
            return m

    def _open_shared(self, spec: CompressionSpec | None) -> dict:
        """Rank 0 opens (or creates) the manifest, then tells the others,
        which read it: every rank raises if rank 0 failed."""
        import torch.distributed as dist

        from repro_torch.dist.collective import broadcast_object

        me = dist.get_rank(self._group)
        trace.set_rank(me)
        m, error = None, None
        if me == 0:
            try:
                m = self._open_manifest(spec)
            except Exception as e:  # noqa: BLE001 - the other ranks learn of it
                error = e
        said = broadcast_object(None if error is None else repr(error), self._group)
        if error is not None:
            raise error
        if said is not None:
            raise RuntimeError(f"rank 0 could not open the dataset: {said}")
        return m if m is not None else read_manifest(self.store)

    # -- introspection -----------------------------------------------------

    @property
    def quantities(self) -> list[str]:
        return sorted(self._m["quantities"])

    def timesteps(self, quantity: str) -> list[int]:
        """Committed timestep indices for one quantity, in append order."""
        return [ts["t"] for ts in self._entry(quantity)["timesteps"]]

    def timestep_info(self, quantity: str, t: int | None = None):
        """Committed timestep record(s) — ``{"t", "time", "file", "bytes",
        "raw_bytes"}`` dicts (copies).  ``t=None`` returns the full list."""
        if t is None:
            return [dict(ts) for ts in self._entry(quantity)["timesteps"]]
        return dict(self._timestep(quantity, int(t)))

    def shape(self, quantity: str) -> tuple[int, int, int]:
        return tuple(self._entry(quantity)["shape"])

    def dtype(self, quantity: str) -> np.dtype:
        return np.dtype(self._entry(quantity)["dtype"])

    @property
    def version(self) -> int:
        return int(self._m["version"])

    def _entry(self, quantity: str) -> dict:
        try:
            return self._m["quantities"][quantity]
        except KeyError:
            raise KeyError(
                f"quantity {quantity!r} not in dataset "
                f"(has: {', '.join(self.quantities) or 'none'})") from None

    def _timestep(self, quantity: str, t: int) -> dict:
        for ts in self._entry(quantity)["timesteps"]:
            if ts["t"] == t:
                return ts
        raise KeyError(f"quantity {quantity!r} has no timestep {t} "
                       f"(has: {self.timesteps(quantity)})")

    def describe(self) -> dict:
        """Machine-readable dataset summary: spec, version, and the full
        per-quantity timestep tables, as one JSON-able dict (deep copy).

        The single serializer behind both ``cz-compress inspect --json`` and
        the HTTP service's ``/v1/manifest`` — external tooling sees one
        schema however it asks.
        """
        with self._lock:
            return {
                "store": "CZDS",
                "format": int(self._m["format"]),
                "version": int(self._m["version"]),
                "spec": dict(self._m["spec"]),
                "quantities": {
                    q: {"shape": list(ent["shape"]),
                        "dtype": str(ent["dtype"]),
                        "timesteps": [dict(ts) for ts in ent["timesteps"]]}
                    for q, ent in self._m["quantities"].items()
                },
            }

    def refresh(self) -> None:
        """Re-read the manifest (pick up commits by a concurrent appender)."""
        with self._lock:
            self._m = read_manifest(self.store)

    # -- append mode -------------------------------------------------------

    def append(self, fields: dict[str, np.ndarray | torch.Tensor],
               time: float | None = None) -> int:
        """Commit one timestep of one or more quantities; returns its index.

        Member objects are written first (concurrently chunk-encoded through
        the shared pool), then the manifest is replaced atomically — a crash
        mid-append leaves at most orphaned member objects, never a timestep
        that is half-visible.

        A field is a numpy array (or anything ``np.asarray`` takes) or a
        tensor on any device.  A tensor goes to stage 1 as it is, with no
        host copy; its members and manifest record are its numpy twin's.
        """
        if self._writer is None:
            raise IOError("dataset opened read-only; reopen with mode='a'")
        if not fields:
            raise ValueError("append needs at least one quantity")
        if self._group is not None:
            return self._append_shared(fields, time)
        with self._lock:
            # re-read before patching: merge_manifests (rank sidecars) may
            # have committed entries since this handle last saw the manifest
            # — a stale in-memory copy would clobber them and reuse their
            # timestep indices.  (Appending *concurrently* with a merge from
            # another process remains a documented single-coordinator
            # assumption; rank-parallel writers go through RankWriter.)
            self._m = read_manifest(self.store)
            t = int(self._m["next_t"])
            written = []
            for q, field in fields.items():
                if not QUANTITY_RE.match(q):
                    raise ValueError(f"invalid quantity name {q!r}")
                field = _as_field(field)
                self._check(q, shape=field.shape)
                member_spec = self._writer.spec_for(field)
                self._check(q, spec=member_spec)
                with trace.span("dataset.write", quantity=q, t=t):
                    nbytes = self._writer.write(
                        _MEMBER.format(q=q, t=t), field, spec=member_spec,
                        extra_header={"quantity": q, "t": t, "time": time},
                        store=self.store)
                written.append((q, member_spec, field.shape, nbytes, field.nbytes, field))
            self._commit(t, time, written)
            return t

    def _append_shared(self, fields: dict, time: float | None) -> int:
        """:meth:`append` by every rank of the group: each member is placed
        QoI by QoI (encode, Exscan, write-at), then rank 0 closes them all
        and commits the manifest (see :meth:`ShardWriter.commit_shared`).
        Every rank hands in the same quantities in the same order."""
        import torch.distributed as dist

        me = dist.get_rank(self._group)
        with self._lock:
            self._m = read_manifest(self.store)
            t = int(self._m["next_t"])
            parts, specs = [], []
            for q, field in fields.items():
                with trace.span("dataset.write", quantity=q, t=t):
                    try:
                        if not QUANTITY_RE.match(q):
                            raise ValueError(f"invalid quantity name {q!r}")
                        field = _as_field(field)
                        specs.append(self._writer.spec_for(field))
                        part = self._writer.encode_part(
                            field, spec=specs[-1],
                            extra_header={"quantity": q, "t": t, "time": time})
                    except Exception as e:  # noqa: BLE001 - raised on every rank
                        part = e
                    try:
                        parts.append(self._writer.place_shared(
                            _MEMBER.format(q=q, t=t), part, self._group, store=self.store))
                    except BaseException:
                        if me == 0:  # the members placed before this one
                            for p in parts:
                                with contextlib.suppress(FileNotFoundError):
                                    os.unlink(p.path)
                        raise

            def commit(nbytes: list[int], headers: list[dict]) -> None:
                written = [(q, spec, h["field_shape"], n, h["raw_bytes"], None)
                           for q, spec, n, h in zip(fields, specs, nbytes, headers)]
                for q, spec, shape, *_ in written:
                    self._check(q, shape, spec)
                self._commit(t, time, written)

            self._writer.commit_shared(parts, self._group, then=commit)
            if me != 0:
                self._m = read_manifest(self.store)
            return t

    def _check(self, q: str, shape=None, spec: CompressionSpec | None = None) -> None:
        """Refuse quantity ``q`` of another ``shape`` or another dtype (its
        member ``spec``'s) than its manifest entry's: both are fixed at the
        quantity's first append."""
        ent = self._m["quantities"].get(q)
        if ent is None:
            return
        if shape is not None and tuple(ent["shape"]) != tuple(shape):
            raise ValueError(
                f"quantity {q!r} has shape {tuple(ent['shape'])}, "
                f"append got {tuple(shape)}")
        if spec is not None and str(ent["dtype"]) != str(spec.np_dtype):
            raise ValueError(
                f"quantity {q!r} is {ent['dtype']}, append got "
                f"{spec.np_dtype} — the quantity-level dtype "
                "tag is fixed at first append")

    def _commit(self, t: int, time: float | None, written: list[tuple]) -> None:
        """Commit timestep ``t`` once its members are stored: ``written``
        holds each member's ``(quantity, spec, shape, bytes, raw_bytes,
        field)`` in append order.  Each member's record gets the chunk-scheme
        mix of an ``auto`` member and, with ``stats``, its quality against
        ``field``; then the manifest is replaced in one atomic commit."""
        recs = []
        for q, spec, _shape, nbytes, raw_bytes, field in written:
            rel = _MEMBER.format(q=q, t=t)
            rec = {"t": t, "time": time, "file": rel, "bytes": int(nbytes),
                   "raw_bytes": int(raw_bytes)}
            if spec.scheme == "auto":
                # surface the chunk-scheme mix in the manifest (and so in
                # /v1/manifest + inspect --stats) without a decode pass
                mix = container.describe(rel, verify=False, store=self.store).get("schemes")
                if mix:
                    rec["schemes"] = mix
            if self._stats:
                with trace.span("dataset.stats_read", quantity=q, t=t):
                    dec = container.read_field(rel, device=self.device, store=self.store)
                with trace.span("dataset.member_stats", quantity=q, t=t):
                    rec.update(_member_stats(field, dec))
            recs.append(rec)
        for (q, spec, shape, *_), rec in zip(written, recs):
            ent = self._m["quantities"].setdefault(q, {
                "shape": list(shape), "dtype": str(spec.np_dtype), "timesteps": []})
            ent["timesteps"].append(rec)
        self._m["next_t"] = t + 1
        self._m["version"] = int(self._m["version"]) + 1
        with trace.span("dataset.commit", t=t):
            write_manifest(self.store, self._m)

    # -- random access -----------------------------------------------------

    def reader(self, quantity: str, t: int) -> FieldReader:
        """Cached (LRU) FieldReader for one member — the decode cache shared
        by every region query against that quantity/timestep.

        Eviction folds the reader's counters into the dataset totals and
        drops the reference; it does *not* close the reader (store-backed
        readers hold no OS resources), so an evicted reader a caller still
        holds keeps serving from its own cache.
        """
        key = (quantity, int(t))
        with self._lock:
            r = self._readers.get(key)
            if r is not None:
                self._readers.move_to_end(key)
                return r
            ts = self._timestep(quantity, int(t))
            r = FieldReader(ts["file"], cache_chunks=self._cache_chunks,
                            device=self.device, store=self.store,
                            prefetch=self._prefetch)
            self._readers[key] = r
            while len(self._readers) > self._cache_readers:
                _, old = self._readers.popitem(last=False)
                self._retired_decoded += old.chunks_decoded
                self._retired_hits += old.cache_hits
            return r

    def read_box(self, quantity: str, t: int, lo, hi) -> np.ndarray:
        """Decode the sub-box ``[lo, hi)`` of one quantity at one timestep,
        touching only the chunks that cover it."""
        return self.reader(quantity, t).read_box(lo, hi)

    def read_field(self, quantity: str, t: int) -> np.ndarray:
        """Decode one full field (through the same chunk cache)."""
        return self.reader(quantity, t).read_all()

    def stats(self) -> dict:
        """Aggregate decode-cache counters across member readers (retired
        readers' counts are folded in at eviction/close, so totals are
        monotonic).  ``chunks_decoded == cache_misses`` by construction —
        a FieldReader inflates a chunk exactly when its LRU misses — but
        both names are exposed so cache consumers (``/metrics``,
        ``bench_serve``) can report true hit rates without knowing that."""
        with self._lock:
            live = list(self._readers.values())
            decoded = self._retired_decoded + sum(r.chunks_decoded for r in live)
            hits = self._retired_hits + sum(r.cache_hits for r in live)
            return {
                "open_readers": len(live),
                "chunks_decoded": decoded,
                "cache_hits": hits,
                "cache_misses": decoded,
                "cache_hit_rate": hits / (hits + decoded) if hits + decoded else None,
            }

    # -- retention ---------------------------------------------------------

    def gc(self, dry_run: bool = False) -> list[str]:
        """Delete orphaned objects: members in the store but absent from the
        manifest (a torn append or an aborted rank merge) and stale
        ``.tmp``/``.part`` leftovers.  Returns the orphans' keys, sorted.

        Orphans are enumerated through ``Store.list`` — the same sweep on
        every backend.  Members referenced by an unmerged rank sidecar
        (``manifest.rank{r}.json``) are *live* — they are committed data
        awaiting a merge — and are never collected.  Run gc quiesced (no
        concurrent appenders).
        ``dry_run=True`` only lists; actual deletion needs ``mode='a'``.
        """
        with self._lock:
            self._m = read_manifest(self.store)
            live = {ts["file"]
                    for ent in self._m["quantities"].values()
                    for ts in ent["timesteps"]}
            for rank in list_rank_manifests(self.store):
                side = read_rank_manifest(self.store, rank)
                live |= {e["file"] for e in side["entries"]}
            orphans = []
            for key in self.store.list(""):
                if key == MANIFEST_NAME or RANK_MANIFEST_RE.match(key):
                    continue
                if key.endswith((".tmp", ".part")):
                    orphans.append(key)
                elif key.endswith(".cz") and key not in live:
                    orphans.append(key)
            orphans.sort()
            if dry_run or not orphans:
                return orphans
            if self.mode != "a":
                raise IOError("dataset opened read-only; gc deletion needs "
                              "mode='a' (or use dry_run=True)")
            for key in orphans:
                self.store.delete(key)  # FileStore prunes emptied quantity dirs
            return orphans

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            for r in self._readers.values():
                self._retired_decoded += r.chunks_decoded
                self._retired_hits += r.cache_hits
                r.close()
            self._readers.clear()
            if self._writer is not None:
                self._writer.close()
            # backends holding OS resources (HttpStore's keep-alive pool)
            # expose close(); local dict/dir backends don't need one
            store_close = getattr(self.store, "close", None)
            if callable(store_close):
                store_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self) -> str:
        qs = {q: len(self._m["quantities"][q]["timesteps"])
              for q in self.quantities}
        return (f"CZDataset({self.root!r}, mode={self.mode!r}, "
                f"quantities={qs}, version={self.version})")
