"""Concurrent shard writer: pooled chunk encoding, single ordered drain
(port of ``repro.store.writer``).

The paper's writers are per-thread: each thread compresses its own
aggregation buffer and the buffers are concatenated in deterministic order.
:class:`ShardWriter` reproduces that shape for dataset members — one shared
:class:`~concurrent.futures.ThreadPoolExecutor` encodes aggregation buffers
(scheme serialize + stage-2 lossless, both GIL-releasing) for *all*
quantities of a timestep, while each CZ2 member is drained by a single
writer strictly in chunk order.  Serial (``workers=1``) and pooled output are
byte-identical.

Stage 1 runs once per member on the caller's thread, on the writer's torch
``device`` (default ``"cuda"``: the scheme's kernel); the pool's threads do
host work only, except under ``auto``, whose per-chunk trials launch the
kernels from the pool's threads.

A member can also be written by every rank of a ``torch.distributed``
process group at once, the paper's in-situ layout: each rank holds one slab
of the global field, the slabs stacked along axis 0 in rank order.  Each
rank encodes its slab (:meth:`ShardWriter.encode_part`), an Exscan over the
ranks' byte totals places its chunks in the one shared file, where it
writes them itself (:meth:`ShardWriter.place_shared`), and rank 0 gathers
the chunk tables and closes the file with the global field's footer
(:meth:`ShardWriter.commit_shared`).  Since every rank's blocks are a
contiguous span of the global block raster that ends on a chunk boundary,
the member is the serial writer's member of the gathered field, byte for
byte.  A rank that fails makes every rank raise at the next collective.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import os
import warnings
import zlib

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import container
from repro_torch.core.blocks import num_blocks
from repro_torch.core.pipeline import DTYPES, CompressionSpec, Pipeline
from repro_torch.core.schemes import check_device, torch_device
from repro_torch.obs import trace

__all__ = ["ShardWriter", "SharedPart", "DtypeCoercionWarning"]


def _as_field(field) -> np.ndarray | torch.Tensor:
    """A tensor as it is, on its own device; anything else as a numpy
    array."""
    return field if isinstance(field, torch.Tensor) else np.asarray(field)


class DtypeCoercionWarning(UserWarning):
    """A field's dtype could not be carried through the dataset spec's scheme
    and the value stream was cast to the spec's dtype (e.g. float64 into an
    fpzipx dataset, whose lossless guarantee is float32-only)."""


@dataclasses.dataclass
class SharedPart:
    """One rank's share of a shared member once its bytes are placed: the
    member's local ``path``, this rank's ``header`` (its slab's shape and
    raw bytes), its chunk ``table`` and the Exscan's table of every rank's
    ``rows``; ``error``, what its write-at raised."""
    path: str
    header: dict
    table: container.ChunkTable
    rows: torch.Tensor
    error: BaseException | None = None


#: an Exscan row: bytes, ok, the member key's CRC, slab shape (3), blocks,
#: blocks a chunk
_ROW = ("bytes", "ok", "key", "nx", "ny", "nz", "nblocks", "per_chunk")


def _shared_path(path: str, store, create: bool) -> str:
    """The local file behind a member key: every rank writes at its offset
    in it, so the store has to be a directory of files (``file://``)."""
    if store is not None:
        path_for = getattr(store, "path_for", None)
        if path_for is None:
            raise ValueError(f"a member shared by ranks needs a file store, not "
                             f"{type(store).__name__}: every rank writes at its offset")
        path = path_for(path)
    if create:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return path


def _slab_spans(slab_x: list[int], cross: tuple[int, int], block_size: int,
                blocks_per_chunk: int) -> list[tuple[int, int]]:
    """Each rank's span ``[lo, hi)`` of the global block raster, where rank
    ``r`` holds the slab of ``slab_x[r]`` cells along x over the ``cross``
    section ``(ny, nz)``, the slabs stacked in rank order.  Raises unless
    every span but the last is a whole number of chunks of
    ``blocks_per_chunk`` blocks (a rank's first chunk then starts with its
    first block)."""
    per_layer = int(np.prod(num_blocks((block_size, *cross), block_size)))
    spans, lo = [], 0
    for x in slab_x:
        if x % block_size:
            raise ValueError(f"a slab of {x} cells along x is not whole blocks of "
                             f"{block_size}")
        spans.append((lo, lo + x // block_size * per_layer))
        lo = spans[-1][1]
    short = [r for r, (a, b) in enumerate(spans[:-1]) if (b - a) % blocks_per_chunk]
    if short:
        raise ValueError(f"rank(s) {short} hold {[spans[r][1] - spans[r][0] for r in short]} "
                         f"blocks, not whole chunks of {blocks_per_chunk}")
    return spans


def _rows_problem(rows: torch.Tensor, block_size: int) -> str | None:
    """What the ranks' Exscan rows disagree on, if anything: a rank that
    failed, another member, another slab cross-section, or a slab (not the
    last) that does not end on a chunk boundary (:func:`_slab_spans`)."""
    r = {k: rows[:, i].tolist() for i, k in enumerate(_ROW)}
    failed = [i for i, ok in enumerate(r["ok"]) if not ok]
    if failed:
        return f"rank(s) {failed} failed to encode their slab"
    if len(set(r["key"])) > 1:
        return f"the ranks write different members (key CRCs {r['key']})"
    if len({(y, z) for y, z in zip(r["ny"], r["nz"])}) > 1:
        return f"the ranks' slabs differ across axis 0: {list(zip(r['ny'], r['nz']))}"
    try:
        _slab_spans(r["nx"], (r["ny"][0], r["nz"][0]), block_size, r["per_chunk"][0])
    except ValueError as e:
        return str(e)
    return None


class ShardWriter:
    """Writes 3D fields to CZ2 member files through a shared encode pool, with
    stage 1 on the torch ``device`` (``"cuda"`` without a GPU raises)."""

    def __init__(self, spec: CompressionSpec, workers: int = 1,
                 device=DEFAULT_DEVICE):
        self.device = torch_device(device)
        self.spec = spec.validate()
        self.workers = max(1, int(workers))
        self._pool = (concurrent.futures.ThreadPoolExecutor(self.workers)
                      if self.workers > 1 else None)

    def spec_for(self, field: np.ndarray | torch.Tensor) -> CompressionSpec:
        """Dataset spec re-tagged with the field's dtype (auto dtype tags).
        Dtypes the spec's scheme can't take (unsupported ones, or e.g.
        float64 into an fpzipx dataset) fall back to the spec's own dtype —
        the field is coerced, never rejected mid-append, but the cast is
        surfaced as a :class:`DtypeCoercionWarning` rather than silent.

        An unknown ``spec.device`` (the header's provenance field, ``"host"``
        or ``"jax"``) is *not* coercible: it raises here even if the spec
        skipped validation (e.g. was rebuilt from a hand-edited manifest)."""
        check_device(self.spec.device)
        # the numpy name of the dtype, read from a tensor without converting it
        dt = str(_as_field(field).dtype).removeprefix("torch.")
        if dt == self.spec.dtype:
            return self.spec
        if dt not in DTYPES:
            warnings.warn(
                f"dtype {dt} is not a supported field dtype {DTYPES}; "
                f"values will be cast to {self.spec.dtype}",
                DtypeCoercionWarning, stacklevel=3)
            return self.spec
        try:
            return dataclasses.replace(self.spec, dtype=dt).validate()
        except ValueError as e:
            warnings.warn(
                f"scheme {self.spec.scheme!r} cannot encode dtype {dt} "
                f"({e}); values will be cast to {self.spec.dtype}",
                DtypeCoercionWarning, stacklevel=3)
            return self.spec

    def write(self, path: str, field: np.ndarray | torch.Tensor,
              extra_header: dict | None = None,
              spec: CompressionSpec | None = None, store=None) -> int:
        """Stream one field into a CZ2 member; returns bytes written.

        ``spec`` lets a caller that already ran :meth:`spec_for` (e.g. for
        the manifest's dtype tag) pass it in instead of re-deriving it —
        and re-emitting any coercion warning.  ``store`` routes the member
        bytes through a :class:`~repro_torch.store.backends.Store` (``path``
        is then a store key); ``None`` writes a local file.  Members are
        fsynced (where the backend has an fd to sync): the dataset's
        atomic-manifest guarantee needs member data on stable storage
        *before* the manifest references it.  A tensor is passed on as it
        is: stage 1 blocks it on the writer's device, where it already lies
        on the in-situ path, and never writes to it.
        """
        field = _as_field(field)
        if field.ndim != 3:
            raise ValueError(f"expected a 3D field, got shape {field.shape}")
        return container.write_compressed(
            path, field, spec or self.spec_for(field),
            extra_header=extra_header, workers=self.workers,
            executor=self._pool, fsync=True, store=store, device=self.device)

    # -- a member shared by the ranks of a process group --------------------

    def encode_part(self, slab, spec: CompressionSpec | None = None,
                    extra_header: dict | None = None
                    ) -> tuple[dict, list, container.ChunkTable, int]:
        """This rank's share of a shared member, in memory: its header (of
        its own slab), its chunks, their table and the blocks a chunk holds.
        Stage 1 runs on the writer's device, stage 2 on its pool, as
        :meth:`write` runs them."""
        field = _as_field(slab)
        if field.ndim != 3:
            raise ValueError(f"expected a 3D slab, got shape {tuple(field.shape)}")
        pipe = Pipeline(spec or self.spec_for(field), workers=self.workers,
                        device=self.device)
        header, data = container.build_field_header(pipe, field, extra_header)
        bufs, table = [], container.ChunkTable()
        for chunk, n in pipe.iter_chunks(data, workers=self.workers,
                                         executor=self._pool, records=table.records):
            bufs.append(chunk)
            table.add(chunk, n)
        return header, bufs, table, pipe.blocks_per_chunk

    def place_shared(self, path: str, part, group, store=None) -> SharedPart:
        """Place this rank's ``part`` (what :meth:`encode_part` returned, or
        the exception it raised) in the shared member ``path``: the Exscan
        over every rank's byte total (the ``cluster.exscan`` span), then
        this rank's write-at.  Rank 0 starts the file before it joins the
        Exscan, so no rank writes before the file is there.

        Every rank of ``group`` calls this at the same point.  Where a rank
        failed to encode, or the ranks disagree on the member or the slab
        layout, every rank raises here (rank 0 removes the file); a failed
        write-at is held in the part and raised by :meth:`commit_shared`."""
        import torch.distributed as dist

        from repro_torch.dist.offsets import exscan_rows

        me = dist.get_rank(group)
        ok = not isinstance(part, BaseException)
        local = None
        row = [-1, 0, zlib.crc32(path.encode()), 0, 0, 0, 0, 1]
        try:
            if ok:
                header, bufs, table, per_chunk = part
                local = _shared_path(path, store, create=me == 0)
                row = [sum(table.sizes), 1, row[2], *header["field_shape"],
                       sum(table.nblocks), per_chunk]
                if me == 0:
                    container.create_shared(local)
        except Exception as e:  # noqa: BLE001 - every rank learns of it below
            ok, part = False, e
            row[:2] = [-1, 0]
        with trace.span("cluster.exscan", key=path):
            offset, rows = exscan_rows(row, group)
        problem = _rows_problem(rows, self.spec.block_size)
        if problem is not None:
            if me == 0 and local is not None:
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(local)
            if not ok:
                raise part
            raise RuntimeError(f"shared member {path!r}: {problem}")
        try:
            container.write_at(local, container.DATA_START + offset, bufs, me)
            error = None
        except Exception as e:  # noqa: BLE001 - raised on every rank at commit
            error = e
        return SharedPart(local, header, table, rows, error)

    def commit_shared(self, parts: list[SharedPart], group, then) -> list[int]:
        """Close the shared members ``parts`` (one per member, in the same
        order on every rank); returns each member's byte count, on every
        rank.  Rank 0 gathers every rank's chunk tables, which says that
        every rank's bytes are written, writes each member's footer for the
        global field (the slabs stacked along axis 0) and fsyncs it, then
        calls ``then(nbytes, headers)`` (the dataset's manifest commit)
        before it tells the ranks the outcome: the ``cluster.commit`` span,
        on rank 0.  Any rank's failure, a write-at's or rank 0's, raises on
        every rank, and rank 0 removes the members."""
        import torch.distributed as dist

        from repro_torch.dist.collective import broadcast_object, gather_objects

        me = dist.get_rank(group)
        errors = [p.error for p in parts if p.error is not None]
        mine = ({"error": f"{type(errors[0]).__name__}: {errors[0]}"} if errors
                else {"tables": [p.table for p in parts]})
        status = None
        with (trace.span("cluster.commit", members=len(parts)) if me == 0
              else contextlib.nullcontext()):
            got = gather_objects(mine, group)
            if me == 0:
                try:
                    bad = [(r, g["error"]) for r, g in enumerate(got) if "error" in g]
                    if bad:
                        raise RuntimeError(f"rank {bad[0][0]} failed its write-at: "
                                           f"{bad[0][1]}")
                    headers = [_global_header(p) for p in parts]
                    nbytes = [container.write_footer(p.path, h, [g["tables"][i] for g in got],
                                                     fsync=True)
                              for i, (p, h) in enumerate(zip(parts, headers))]
                    then(nbytes, headers)
                    status = {"nbytes": nbytes}
                except BaseException as e:
                    status = {"error": f"rank 0: {type(e).__name__}: {e}"}
                    for p in parts:
                        with contextlib.suppress(FileNotFoundError):
                            os.unlink(p.path)
                    broadcast_object(status, group)
                    raise
        status = broadcast_object(status, group)
        if errors:
            raise errors[0]
        if "error" in status:
            raise RuntimeError(f"shared members not committed: {status['error']}")
        return status["nbytes"]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _global_header(part: SharedPart) -> dict:
    """The member's header for the global field, from rank 0's own: the
    slabs' shapes stacked along axis 0, and their raw bytes."""
    rows = {k: part.rows[:, i].tolist() for i, k in enumerate(_ROW)}
    header = dict(part.header)
    nx, ny, nz = header["field_shape"]
    shape = [sum(rows["nx"]), ny, nz]
    header["field_shape"] = shape
    header["raw_bytes"] = header["raw_bytes"] // (nx * ny * nz) * shape[0] * ny * nz
    return header
