"""CZ container: one file per quantity, chunked, random-access decompress
(port of ``repro.core.container``).

* **CZ2** (written) — ``b"CZ2\\0"`` magic, a u64 pointer to a JSON footer,
  the chunk data, then the footer.  The metadata comes last, so the writer
  streams chunks straight from :meth:`Pipeline.iter_chunks` and patches the
  pointer at the end.  Footer keys are written in the reference's order, so
  the two packages write the same bytes for the same chunks.
* **CZ1** (legacy, read-only) — ``b"CZ1\\0"`` magic with the JSON header up
  front.

Ranks write one CZ2 file together, the paper's shared per-quantity file:
:func:`create_shared`, each rank's chunks at its Exscan offset
(:func:`write_at`), :func:`write_footer` of the ranks' chunk tables.

All container I/O goes through the :class:`repro_torch.store.backends.Store`
byte-store protocol: a plain ``path`` resolves to a :class:`FileStore` on
the file's directory, and every reader and writer also takes ``store=``,
with the path read as a store *key*.  Reads are byte-range ``store.get``
calls (footer first, then exactly the chunks touched).

Decode is registry-driven: the scheme recorded in the header decodes, on
the torch device the caller names (``device=``, default ``"cuda"``).  The
``device`` recorded in a header is provenance only; any container decodes
on any device.  :class:`FieldReader` is the paper's random-access
decompressor: an LRU cache of decoded chunks, ``read_box`` over the
covering chunks only, and an advisory prefetcher of their bytes.
"""
from __future__ import annotations

import collections
import concurrent.futures
import io
import json
import os
import struct
import threading
import time
import zlib
from typing import Iterable, Iterator

import numpy as np

from repro_torch import DEFAULT_DEVICE, obs
from repro_torch.obs import trace
from repro_torch.store import backends as stores

from . import blocks as blk
from .pipeline import CompressedField, CompressionSpec, Pipeline

__all__ = ["write_field", "write_compressed", "write_stream", "commit_footer",
           "ChunkTable", "DATA_START", "create_shared", "write_at", "write_footer",
           "build_field_header", "iter_compressed", "read_field", "describe",
           "ChunkPrefetcher", "FieldReader", "MAGIC", "MAGIC_V1"]

# fetch (store byte-range get) vs decode (chunk inflation) split: the
# reference's series, names and labels
_READS = obs.counter("cz_reader_chunk_reads_total",
                     "FieldReader chunk requests by cache result.",
                     labelnames=("result",))
_FETCHED = obs.counter("cz_reader_fetched_bytes_total",
                       "Compressed bytes fetched from stores by FieldReader.")
_FETCH_SECONDS = obs.histogram("cz_reader_fetch_seconds",
                               "Cold-chunk store fetch wall time.",
                               buckets=obs.FAST_BUCKETS)
_DECODE_SECONDS = obs.histogram("cz_reader_decode_seconds",
                                "Cold-chunk decode wall time.",
                                buckets=obs.FAST_BUCKETS)
_PREFETCHED = obs.counter("cz_reader_prefetch_chunks_total",
                          "Prefetcher chunk outcomes by result.",
                          labelnames=("result",))
_SHARED_BYTES = obs.counter("cz_shared_write_bytes_total",
                            "Bytes each rank wrote into shared per-quantity files.",
                            labelnames=("rank",))

MAGIC = b"CZ2\0"
MAGIC_V1 = b"CZ1\0"
_FOOTER_PTR = struct.Struct("<Q")
#: where a CZ2 container's chunk data starts: after the magic and the footer
#: pointer
DATA_START = len(MAGIC) + _FOOTER_PTR.size


def _source(path, store: stores.Store | None) -> tuple[stores.Store, str]:
    """``(store, key)`` for a path-or-key: with no explicit store, a plain
    path gets a :class:`FileStore` rooted at its directory."""
    if store is not None:
        return store, str(path)
    head, tail = os.path.split(os.path.abspath(os.fspath(path)))
    return stores.FileStore(head), tail


class ChunkTable:
    """A CZ2 footer's chunk table, filled as the chunks are written: each
    chunk's size, block count and CRC-32 (:meth:`add`), and the per-chunk
    :meth:`Scheme.chunk_record` collection ``records``, which
    ``Pipeline.iter_chunks(records=table.records)`` fills as it drains."""

    def __init__(self, records: list | None = None):
        self.sizes, self.nblocks, self.crc32 = [], [], []
        self.records = [] if records is None else records

    def add(self, chunk: bytes, nblk: int) -> None:
        self.sizes.append(len(chunk))
        self.nblocks.append(nblk)
        self.crc32.append(zlib.crc32(chunk) & 0xFFFFFFFF)

    def extend(self, other: ChunkTable) -> None:
        """Append ``other``'s chunks after this table's."""
        self.sizes += other.sizes
        self.nblocks += other.nblocks
        self.crc32 += other.crc32
        self.records += other.records


def commit_footer(f, base_header: dict, table: ChunkTable, footer_off: int,
                  fsync: bool = False) -> int:
    """Append the JSON footer of the chunk ``table`` at ``footer_off`` and
    patch the magic's footer pointer; returns the container's total byte
    count.  Header key order decides byte identity with the reference's
    containers.

    The table's ``records`` become the footer's ``chunk_schemes`` only when
    some chunk recorded something, so single-scheme containers keep their
    bytes.  A ``chunk_schemes`` already in ``base_header`` (a re-written
    :class:`CompressedField`) goes back at the same position."""
    header = dict(base_header)
    recs = header.pop("chunk_schemes", None)
    if any(r is not None for r in table.records):
        recs = table.records
    header.update({
        "nblocks": int(sum(table.nblocks)),
        "chunk_nblocks": table.nblocks,
        "chunk_sizes": table.sizes,
        "chunk_crc32": table.crc32,
    })
    if recs is not None:
        header["chunk_schemes"] = recs
    hbytes = json.dumps(header).encode()
    f.seek(footer_off)
    f.write(hbytes)
    f.seek(len(MAGIC))
    f.write(_FOOTER_PTR.pack(footer_off))
    if fsync:
        f.flush()
        try:
            fd = f.fileno()
        except (OSError, io.UnsupportedOperation):
            fd = None  # store-buffered sink: durability is the put's problem
        if fd is not None:
            os.fsync(fd)
    return footer_off + len(hbytes)


def write_stream(path: str, chunk_iter: Iterable[tuple[bytes, int]],
                 base_header: dict, fsync: bool = False,
                 store: stores.Store | None = None,
                 records: list | None = None) -> int:
    """Stream ``(chunk, nblk)`` pairs to a CZ2 container; one chunk in
    memory.  ``store=`` writes through a byte-store backend (``path`` is the
    key): a :class:`FileStore` streams to a real file, the others buffer and
    commit one whole-object put.  ``records`` is the list the chunk iterator
    fills as it drains (``Pipeline.iter_chunks(records=...)``), read once
    the loop is done."""
    table = ChunkTable(records)
    sink = open(path, "wb") if store is None else store.open_write(path)
    with sink as f:
        f.write(MAGIC)
        f.write(_FOOTER_PTR.pack(0))  # patched once the footer offset is known
        for chunk, nblk in chunk_iter:
            f.write(chunk)
            table.add(chunk, nblk)
        return commit_footer(f, base_header, table, f.tell(), fsync=fsync)


# -- one file shared by ranks (``MPI_File_write_at`` at Exscan offsets) ----

def create_shared(path: str) -> None:
    """Start a shared file (truncating any earlier one): the magic and a
    zero footer pointer, which :func:`write_footer` patches."""
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_FOOTER_PTR.pack(0))


def write_at(path: str, offset: int, bufs, rank: int) -> int:
    """``MPI_File_write_at``: ``bufs`` (an iterable of bytes) one after
    another into the shared file at byte ``offset``, through a descriptor
    of this rank's own; returns the bytes written.  The ``cluster.write_at``
    span; the bytes count in ``cz_shared_write_bytes_total{rank}``."""
    t0 = time.perf_counter_ns()
    n = 0
    fd = os.open(path, os.O_WRONLY)
    try:
        for buf in bufs:
            view = memoryview(buf)
            while view:
                done = os.pwrite(fd, view, offset + n)
                n += done
                view = view[done:]
    finally:
        os.close(fd)
    trace.record("cluster.write_at", t0, time.perf_counter_ns(), rank=int(rank),
                 offset=int(offset), bytes=n)
    _SHARED_BYTES.inc(n, rank=str(rank))
    return n


def write_footer(path: str, header: dict, tables: Iterable[ChunkTable],
                 fsync: bool = False) -> int:
    """Close a shared file whose chunk data every rank has written: the
    footer of the ranks' chunk ``tables`` in rank order, which one after
    another are the serial writer's table, at the end of the data; returns
    the file's byte count."""
    table = ChunkTable()
    for t in tables:
        table.extend(t)
    with open(path, "r+b") as f:
        return commit_footer(f, header, table, DATA_START + sum(table.sizes),
                             fsync=fsync)


def build_field_header(pipe: Pipeline, source, extra_header: dict | None = None):
    """Assemble a container header for a 3D field / 4D block batch (numpy or
    tensor) and return ``(header, blocks)``, the blocks a tensor on the
    pipeline's device."""
    spec = pipe.spec
    header = pipe.base_header()
    with trace.span("pipeline.to_device"):
        data = pipe.as_tensor(source)
        if data.ndim == 3:
            header["field_shape"] = list(data.shape)
            data = blk.blockify(data, spec.block_size)
    if data.ndim != 4:
        raise ValueError(f"expected 3D field or 4D block batch, got {tuple(data.shape)}")
    header["raw_bytes"] = int(data.numel() * spec.np_dtype.itemsize)
    if extra_header:
        header.update(extra_header)
    return header, data


def write_compressed(path: str, source, spec: CompressionSpec | None = None,
                     extra_header: dict | None = None, workers: int = 1,
                     executor=None, fsync: bool = False,
                     store: stores.Store | None = None,
                     device=DEFAULT_DEVICE) -> int:
    """Write a CZ2 container; returns total bytes written.

    ``source`` is a 3D field / 4D block batch (numpy, or a tensor already on
    ``device``) compressed on the fly through :meth:`Pipeline.iter_chunks`,
    or an already-built :class:`CompressedField`.  ``workers > 1`` encodes
    chunks on a thread pool (``executor`` supplies an external one); the one
    ordered drain keeps the file byte-identical to a serial write.
    ``fsync`` flushes the file to stable storage before returning.
    ``store=`` writes through a byte-store backend (``path`` is the key)."""
    if isinstance(source, CompressedField):
        header = dict(source.header)
        for k in ("chunk_nblocks", "chunk_sizes", "chunk_crc32", "nblocks"):
            header.pop(k, None)
        pairs = zip(source.chunks, source.header["chunk_nblocks"])
        return write_stream(path, pairs, header, fsync=fsync, store=store)

    if spec is None:
        raise TypeError("spec is required when writing a raw field/blocks")
    pipe = Pipeline(spec, workers=workers, device=device)
    header, data = build_field_header(pipe, source, extra_header)
    records: list = []
    chunk_iter = pipe.iter_chunks(data, workers=workers, executor=executor,
                                  records=records)
    return write_stream(path, chunk_iter, header, fsync=fsync, store=store,
                        records=records)


def write_field(path: str, field, spec: CompressionSpec, workers: int = 1,
                device=DEFAULT_DEVICE) -> int:
    return write_compressed(path, field, spec, workers=workers, device=device)


def _read_header(f) -> tuple[dict, int]:
    """Dispatch on magic; returns (header, data_start).  File-handle variant
    for callers that already hold one open."""
    magic = f.read(4)
    try:
        if magic == MAGIC_V1:
            (hlen,) = _FOOTER_PTR.unpack(f.read(8))
            header = json.loads(f.read(hlen))
            header.setdefault("format", 1)
            return header, 12 + hlen
        if magic == MAGIC:
            (footer_off,) = _FOOTER_PTR.unpack(f.read(8))
            f.seek(footer_off)
            header = json.loads(f.read())
            return header, 12
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError) as e:
        raise IOError(f"corrupt container metadata: {e}") from None
    raise ValueError("not a CZ container")


def _fetch_header(store: stores.Store, key: str) -> tuple[dict, int, bytes]:
    """Read a container's metadata with byte-range gets — magic + pointer
    first, then exactly the header/footer bytes.  Returns
    (header, data_start, magic)."""
    head = store.get(key, (0, len(MAGIC) + _FOOTER_PTR.size))
    if len(head) < len(MAGIC) + _FOOTER_PTR.size:
        raise ValueError("not a CZ container")
    magic = head[:len(MAGIC)]
    (ptr,) = _FOOTER_PTR.unpack(head[len(MAGIC):])
    try:
        if magic == MAGIC_V1:
            header = json.loads(store.get(key, (12, 12 + ptr)))
            header.setdefault("format", 1)
            return header, 12 + ptr, magic
        if magic == MAGIC:
            header = json.loads(store.get(key, (ptr, None)))
            return header, 12, magic
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise IOError(f"corrupt container metadata: {e}") from None
    raise ValueError("not a CZ container")


def _iter_chunk_bytes(store: stores.Store, key: str, header: dict,
                      data_start: int) -> Iterator[tuple[bytes, int, int]]:
    """CRC-checked ``(chunk_bytes, nblk, index)`` stream for a full scan —
    one ranged get over the whole data region."""
    sizes = header["chunk_sizes"]
    data = store.get(key, (data_start, data_start + int(sum(sizes))))
    off = 0
    for i, (sz, nblk, crc) in enumerate(zip(sizes, header["chunk_nblocks"],
                                            header["chunk_crc32"])):
        chunk = data[off:off + sz]
        off += sz
        if len(chunk) != sz or (zlib.crc32(chunk) & 0xFFFFFFFF) != crc:
            raise IOError("chunk CRC mismatch — corrupt container")
        yield chunk, nblk, i


def iter_compressed(path: str, store: stores.Store | None = None
                    ) -> Iterator[tuple[bytes, int]]:
    """Stream ``(chunk, nblk)`` pairs out of a container, CRC-checked."""
    store, key = _source(path, store)
    header, data_start, _ = _fetch_header(store, key)
    for chunk, nblk, _i in _iter_chunk_bytes(store, key, header, data_start):
        yield chunk, nblk


def read_field(path: str, device=DEFAULT_DEVICE,
               store: stores.Store | None = None) -> np.ndarray:
    """Decompress a whole container on the torch ``device``: the field, or
    the raw blocks if the file was written from a block batch.  ``store=``
    reads ``path`` as a key in a byte-store backend."""
    store, key = _source(path, store)
    header, data_start, _ = _fetch_header(store, key)
    pipe = Pipeline(CompressionSpec.from_json(header["spec"]), device=device)
    fmt = int(header.get("format", 1))
    outs = [pipe.decompress_chunk(chunk, nblk, fmt)
            for chunk, nblk, _i in _iter_chunk_bytes(store, key, header, data_start)]
    blocks = np.concatenate(outs)
    shape = header.get("field_shape")
    if shape is None:
        return blocks
    return blk.unblockify(blocks, tuple(shape))


def describe(path: str, verify: bool = False,
             store: stores.Store | None = None) -> dict:
    """Machine-readable container summary: header fields plus the per-chunk
    table, as one JSON-able dict, with the reference's keys in its order.

    The serializer behind ``inspect --json``.  ``verify=True`` re-reads the
    data region and adds a ``crc_ok`` verdict per chunk (and an aggregate
    one).  A host function: no chunk is decoded."""
    src, key = _source(path, store)
    header, data_start, magic = _fetch_header(src, key)
    sizes = header["chunk_sizes"]
    crcs = header.get("chunk_crc32", [None] * len(sizes))
    recs = header.get("chunk_schemes")
    chunks = []
    ok = True
    data = src.get(key, (data_start, data_start + int(sum(sizes)))) if verify else b""
    off = 0
    for i, (sz, nblk, crc) in enumerate(zip(sizes, header["chunk_nblocks"], crcs)):
        row = {"index": i, "blocks": int(nblk), "bytes": int(sz), "crc32": crc}
        if recs is not None:
            rec = recs[i] if i < len(recs) and recs[i] else {}
            row["scheme"] = rec.get("scheme", header.get("scheme"))
            if "eps" in rec:
                row["eps"] = rec["eps"]
        if verify and crc is not None:
            good = (zlib.crc32(data[off:off + sz]) & 0xFFFFFFFF) == crc
            row["crc_ok"] = good
            ok &= good
        off += sz
        chunks.append(row)
    spec = header["spec"]
    out = {
        "path": path,
        "container": "CZ1" if magic == MAGIC_V1 else "CZ2",
        "format": int(header.get("format", 1)),
        "scheme": header.get("scheme", spec["scheme"]),
        "scheme_params": header.get("scheme_params", {}),
        "dtype": header.get("dtype", spec.get("dtype", "float32")),
        "field_shape": header.get("field_shape"),
        "block_size": spec["block_size"],
        "nblocks": header.get("nblocks"),
        "raw_bytes": header.get("raw_bytes"),
        "compressed_bytes": int(sum(sizes)),
        "spec": spec,
        "chunks": chunks,
    }
    if recs is not None:
        # scheme -> chunk-count histogram for mixed-scheme (auto) containers
        hist: dict[str, int] = {}
        for row in chunks:
            name = row.get("scheme") or header.get("scheme") or "?"
            hist[name] = hist.get(name, 0) + 1
        out["schemes"] = dict(sorted(hist.items()))
    if verify:
        out["crc_ok"] = ok
    return out


_PREFETCH_POOL = None
_PREFETCH_POOL_GUARD = threading.Lock()


def _prefetch_pool():
    """Shared pool for prefetch batches.  Separate from the store layer's
    I/O pool (``shared_io_pool``): a batch task here fans out into
    ``store.get_many``, which may submit to *that* pool — one pool for both
    would deadlock once saturated with waiting parents."""
    global _PREFETCH_POOL
    with _PREFETCH_POOL_GUARD:
        if _PREFETCH_POOL is None:
            _PREFETCH_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="cz-prefetch")
        return _PREFETCH_POOL


class ChunkPrefetcher:
    """Overlaps upcoming chunks' store fetches with the current chunk's
    decode.

    ``read_box`` walks its covering chunks in a known order, so while chunk
    *i* decodes, the byte-range gets for chunks *i+1 .. i+depth* can already
    be on the wire (one ``store.get_many`` batch per scheduling step).
    ``fetch_chunk`` then takes the prefetched bytes via :meth:`take`
    instead of issuing its own get.  The prefetch threads only fetch bytes;
    they never decode and never touch the card.

    Prefetch can never change results or duplicate work:

    * a chunk already in the reader's cache, already in flight here, or
      claimed by the caller's ``skip`` predicate is not scheduled;
    * the buffer is bounded (``max_buffered``, default ``2×depth``): the
      oldest unconsumed entry is evicted and refetched on demand;
    * a failed or evicted prefetch makes :meth:`take` return ``None`` and
      the caller issues a direct ``store.get`` — the prefetcher is purely
      advisory I/O.

    Outcomes are counted in
    ``cz_reader_prefetch_chunks_total{result=issued|used|evicted|failed}``.
    """

    def __init__(self, reader: "FieldReader", depth: int = 2,
                 max_buffered: int | None = None):
        self.reader = reader
        self.depth = max(1, int(depth))
        self.max_buffered = int(max_buffered or 2 * self.depth)
        self._pending: collections.OrderedDict[
            int, concurrent.futures.Future] = collections.OrderedDict()
        self._guard = threading.Lock()
        self._closed = False

    def schedule(self, cis, skip=None) -> int:
        """Issue ranged fetches for the chunk indices not already cached,
        in flight, or skipped.  Returns how many were newly issued."""
        todo = []
        with self._guard:
            if self._closed:
                return 0
            for ci in cis:
                ci = int(ci)
                if ci in self._pending or ci in self.reader._cache:
                    continue
                if skip is not None and skip(ci):
                    continue
                fut = concurrent.futures.Future()
                self._pending[ci] = fut
                todo.append((ci, fut))
            while len(self._pending) > self.max_buffered:
                _ci, old = self._pending.popitem(last=False)
                old.cancel()  # batch may still be running: set_* is guarded
                _PREFETCHED.inc(result="evicted")
        if todo:
            _PREFETCHED.inc(len(todo), result="issued")
            _prefetch_pool().submit(self._fetch_batch, todo)
        return len(todo)

    def _fetch_batch(self, todo):
        r = self.reader
        reqs = []
        for ci, _fut in todo:
            off = int(r._chunk_off[ci])
            reqs.append((r.key, (off, off + r.header["chunk_sizes"][ci])))
        try:
            results = r.store.get_many(reqs)
        except BaseException as e:  # delivered through the futures
            for _ci, fut in todo:
                if not fut.cancelled():
                    try:
                        fut.set_exception(e)
                    except concurrent.futures.InvalidStateError:
                        pass
            return
        for (_ci, fut), data in zip(todo, results):
            try:
                fut.set_result(data)
            except concurrent.futures.InvalidStateError:
                pass  # evicted while the batch was in flight

    def take(self, ci: int) -> bytes | None:
        """Prefetched compressed bytes for ``ci`` (waiting on an in-flight
        batch), or ``None`` when the chunk was never scheduled, was evicted,
        or its fetch failed — callers then get the bytes directly."""
        with self._guard:
            fut = self._pending.pop(int(ci), None)
        if fut is None:
            return None
        try:
            data = fut.result()
        except (concurrent.futures.CancelledError, Exception):
            _PREFETCHED.inc(result="failed")
            return None
        if len(data) != self.reader.header["chunk_sizes"][ci]:
            _PREFETCHED.inc(result="failed")  # short read: refetch directly
            return None
        _PREFETCHED.inc(result="used")
        return data

    def close(self) -> None:
        with self._guard:
            self._closed = True
            for fut in self._pending.values():
                fut.cancel()
            self._pending.clear()


class FieldReader:
    """Random block/region access with an LRU chunk cache (the paper's
    decompressor).  Thread-safe: chunk decode and the cache are guarded by
    one lock, so concurrent ``read_box`` callers share one reader and its
    cache, and decodes run one at a time.

    Each cold chunk is fetched as a byte range of the backing store and
    decoded on the torch ``device`` (default ``"cuda"``) through
    :meth:`Pipeline.decompress_chunk`, which launches the scheme's decode
    kernel on the card; the cache holds the decoded chunks as numpy arrays.
    A failed fetch, decode or launch raises out of the call.  The reader
    holds no open file handle; ``close()`` is terminal (use after close
    raises ``ValueError``).
    """

    def __init__(self, path: str, cache_chunks: int = 8, device=DEFAULT_DEVICE,
                 store: stores.Store | None = None, prefetch: int = 0):
        self.path = str(path)
        self.store, self.key = _source(path, store)
        self.header, data_start, _ = _fetch_header(self.store, self.key)
        self.spec = CompressionSpec.from_json(self.header["spec"])
        self.format = int(self.header.get("format", 1))
        self._pipe = Pipeline(self.spec, device=device)
        sizes = self.header["chunk_sizes"]
        self._chunk_off = np.concatenate([[0], np.cumsum(sizes)])[:-1] + data_start
        self._chunk_nblk = self.header["chunk_nblocks"]
        self._blk0 = np.concatenate([[0], np.cumsum(self._chunk_nblk)])
        if "field_shape" not in self.header:
            raise ValueError(
                "container was written from a block batch (no field_shape); "
                "use read_field for raw blocks")
        self.shape = tuple(self.header["field_shape"])
        self.nb = blk.num_blocks(self.shape, self.spec.block_size)
        self._cache: collections.OrderedDict[int, np.ndarray] = collections.OrderedDict()
        self._cache_chunks = cache_chunks
        self._lock = threading.Lock()
        self._closed = False
        self.cache_hits = 0
        self.cache_misses = 0
        self.prefetch = max(0, int(prefetch))
        self._prefetcher = (ChunkPrefetcher(self, depth=self.prefetch)
                            if self.prefetch else None)

    @property
    def nchunks(self) -> int:
        return len(self._chunk_nblk)

    @property
    def chunks_decoded(self) -> int:
        """Chunks actually decoded so far (== cache misses)."""
        return self.cache_misses

    @property
    def dtype(self) -> np.dtype:
        return self.spec.np_dtype

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self):
        """Terminal and idempotent: marks the reader dead and drops its
        chunk cache; any later fetch raises ``ValueError``."""
        if self._prefetcher is not None:
            self._prefetcher.close()
        with self._lock:
            self._closed = True
            self._cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _chunk(self, ci: int) -> np.ndarray:
        return self.fetch_chunk(ci)[0]

    def fetch_chunk(self, ci: int) -> tuple[np.ndarray, bool]:
        """One chunk plus whether this call decoded it (``False`` = LRU
        hit).  The flag is decided under the reader lock, so accounting
        built on it stays exact under concurrency."""
        with self._lock:
            if self._closed:
                raise ValueError(
                    f"FieldReader for {self.path!r} is closed (close() is terminal)")
            if ci in self._cache:
                self._cache.move_to_end(ci)
                self.cache_hits += 1
                _READS.inc(result="hit")
                return self._cache[ci], False
            self.cache_misses += 1
            _READS.inc(result="miss")
            off = int(self._chunk_off[ci])
            t0 = time.perf_counter_ns()
            buf = self._prefetcher.take(ci) if self._prefetcher is not None else None
            if buf is None:
                buf = self.store.get(self.key, (off, off + self.header["chunk_sizes"][ci]))
            t1 = time.perf_counter_ns()
            out = self._pipe.decompress_chunk(buf, self._chunk_nblk[ci], self.format)
            t2 = time.perf_counter_ns()
            _FETCHED.inc(len(buf))
            _FETCH_SECONDS.observe((t1 - t0) / 1e9)
            _DECODE_SECONDS.observe((t2 - t1) / 1e9)
            trace.record("fetch", t0, t1, chunk=ci, bytes=len(buf))
            self._cache[ci] = out
            while len(self._cache) > self._cache_chunks:
                self._cache.popitem(last=False)
            return out, True

    def block_chunk(self, bx: int, by: int, bz: int) -> tuple[int, int]:
        """``(chunk index, block offset within chunk)`` for one block
        coordinate."""
        _, by_n, bz_n = self.nb
        flat = (bx * by_n + by) * bz_n + bz
        ci = int(np.searchsorted(self._blk0, flat, side="right")) - 1
        return ci, flat - self._blk0[ci]

    def box_blocks(self, lo, hi):
        """Block coordinates covering the box ``[lo, hi)`` (validated)."""
        lo = tuple(int(v) for v in lo)
        hi = tuple(int(v) for v in hi)
        for a, b, s in zip(lo, hi, self.shape):
            if not 0 <= a < b <= s:
                raise ValueError(f"box [{lo}, {hi}) outside field {self.shape}")
        bs = self.spec.block_size
        return [(bx, by, bz)
                for bx in range(lo[0] // bs, (hi[0] - 1) // bs + 1)
                for by in range(lo[1] // bs, (hi[1] - 1) // bs + 1)
                for bz in range(lo[2] // bs, (hi[2] - 1) // bs + 1)]

    def box_chunks(self, lo, hi) -> list[int]:
        """Distinct chunk indices covering the box ``[lo, hi)``, ascending."""
        return sorted({self.block_chunk(*b)[0] for b in self.box_blocks(lo, hi)})

    def read_block(self, bx: int, by: int, bz: int) -> np.ndarray:
        """Decompress and return one (bs, bs, bs) block."""
        ci, off = self.block_chunk(bx, by, bz)
        return self._chunk(ci)[off]

    def read_box(self, lo: tuple[int, int, int], hi: tuple[int, int, int],
                 chunk_getter=None, prefetch_skip=None) -> np.ndarray:
        """Decode the sub-box ``[lo, hi)`` touching only the covering chunks.

        The box is assembled block by block through the LRU chunk cache; the
        full field is never decoded, and ``chunks_decoded`` counts exactly
        the chunks that were.  ``chunk_getter`` substitutes another
        ``ci -> chunk array`` source for the reader's own.

        With ``prefetch`` on, the walk schedules the next ``prefetch``
        chunks' byte-range fetches just before decoding each chunk, so wire
        time overlaps decode time.  ``prefetch_skip`` vetoes chunk indices
        (a caller's in-flight check, so prefetch never duplicates a fetch).
        """
        lo = tuple(int(v) for v in lo)
        hi = tuple(int(v) for v in hi)
        get = self._chunk if chunk_getter is None else chunk_getter
        bs = self.spec.block_size
        blocks = self.box_blocks(lo, hi)  # validates the box
        out = np.empty(tuple(b - a for a, b in zip(lo, hi)), self.dtype)
        pf = self._prefetcher
        sched = None
        if pf is not None:
            order: list[int] = []
            for b in blocks:  # distinct covering chunks, visit order
                c = self.block_chunk(*b)[0]
                if not order or order[-1] != c:
                    order.append(c)
            pos = {c: i for i, c in enumerate(order)}
            fired: set[int] = set()

            def sched(ci):
                i = pos[ci]
                if i in fired:
                    return
                fired.add(i)
                upcoming = order[i + 1:i + 1 + pf.depth]
                if upcoming:
                    pf.schedule(upcoming, skip=prefetch_skip)

        for bx, by, bz in blocks:
            ci, off = self.block_chunk(bx, by, bz)
            if sched is not None:
                sched(ci)  # next chunks' fetches ride while this one decodes
            block = get(ci)[off]
            # intersection of this block's extent with the box
            b0 = (bx * bs, by * bs, bz * bs)
            s0 = tuple(max(a, c) for a, c in zip(lo, b0))
            s1 = tuple(min(b, c + bs) for b, c in zip(hi, b0))
            out[tuple(slice(a - o, b - o) for a, b, o in zip(s0, s1, lo))] = \
                block[tuple(slice(a - c, b - c) for a, b, c in zip(s0, s1, b0))]
        return out

    def read_all(self) -> np.ndarray:
        blocks = np.concatenate([self._chunk(i) for i in range(self.nchunks)])
        return blk.unblockify(blocks, self.shape)
