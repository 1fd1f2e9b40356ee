"""Rank-parallel compression into one shared CZ2 file, the cluster tier
(port of ``repro.cluster.engine``).

The paper's defining mechanism: every MPI rank compresses its share of the
grid in parallel and writes into **one shared per-quantity file** at a byte
offset computed with ``MPI_Exscan`` over the per-rank compressed sizes.
:class:`ParallelCompressor` reproduces that with worker *processes* as the
MPI stand-in:

1. the global block raster is split into contiguous per-rank spans that land
   on aggregation-buffer (chunk) boundaries (:func:`~repro_torch.cluster.
   decompose.chunk_spans`) — each rank's span is its block-structured
   subdomain of the serial chunk stream;
2. each rank encodes its blocks through :meth:`Pipeline.iter_chunks` into a
   private part file and reports its per-chunk sizes/CRCs (the gather);
3. the parent runs :func:`~repro_torch.dist.offsets.exclusive_offsets_np` —
   the Exscan — over the per-rank byte totals;
4. each rank copies its part into the shared file at its offset
   (``MPI_File_write_at``), and the parent appends the CZ2 JSON footer and
   patches the footer pointer.

Step 4 is :mod:`repro_torch.core.container`'s shared-file form, which the
in-situ path over a process group (:meth:`repro_torch.store.ShardWriter.
place_shared`, every rank with its own slab on its own device) runs too.

Because rank cuts align with chunk boundaries and every registered scheme
transforms blocks independently (the port's kernels give a block the same
bits at any batch size), the assembled file is **bit-identical to the
serial writer** (:func:`repro_torch.core.container.write_field`) for any
rank count.

Stage 1 runs on the compressor's torch ``device`` in every rank: on
``"cuda"`` each spawned rank opens its own CUDA context on the card and
launches the scheme's kernel on its span.  The parent builds the header and
the block batch on the device, copies each span to the host once, and loads
the kernel libraries before it starts the ranks, so they find them built.

The spans reach the ranks as numpy ``.npy`` files in a private staging
directory under the system's temporary directory (``tempfile``), which
each rank loads and deletes and the parent removes whatever happens; the
reference pickles them through the pool's one pipe instead, which moved a
span an order of magnitude slower than a file on local disk on the H100
machine's host (``chip_smoke.py``'s parallel_path; ``PERF.md``).  The raw field never
passes through the output's directory.

A rank's kernel launches are counted where they happen, in its own
process: its ``encode`` span carries the difference of its
``cz_kernel_calls_total{device="cuda"}`` (``launches``) and of the wrappers'
per-side counts (``launches_by_side``) across the encode.
"""
from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch import DEFAULT_DEVICE, obs
from repro_torch.core import blocks as blk
from repro_torch.core import container
from repro_torch.core.pipeline import STAGE_SECONDS, CompressionSpec, Pipeline
from repro_torch.core.schemes import torch_device
from repro_torch.dist.offsets import exclusive_offsets_np
from repro_torch.obs import trace

from .decompose import chunk_spans

__all__ = ["ParallelCompressor"]

#: env override for the worker start method ("spawn" by default: a CUDA
#: runtime cannot be re-initialized in a forked child)
_START_ENV = "REPRO_CLUSTER_START"

#: the paper's per-stage timing as live series (parent-side wall clock)
_PHASE_SECONDS = obs.histogram(
    "cz_cluster_phase_seconds",
    "Parallel-compress phase wall time (encode / exscan / commit).",
    labelnames=("phase",))
_COMPRESSIONS = obs.counter("cz_cluster_compressions_total",
                            "Parallel compress() calls by rank count.",
                            labelnames=("ranks",))

#: the pipeline stages a rank runs, reported on its ``encode`` span
_RANK_STAGES = ("stage1", "serialize", "stage2_encode")


@contextlib.contextmanager
def _rank_tracing(rank, trace_path):
    """Worker-side tracing scope: when the parent asked for a trace file,
    re-anchor this process's global tracer, collect, and save on exit (the
    parent absorbs the file onto rank track ``pid=rank``)."""
    if trace_path is None:
        yield
        return
    trace.TRACER.reset()
    trace.TRACER.process_name = f"rank {rank}"
    trace.TRACER.enable()
    try:
        yield
    finally:
        trace.TRACER.disable()
        trace.TRACER.save(trace_path)


def _launch_counts() -> tuple[dict, dict]:
    """This process's kernel launches on the card so far: per wrapper label
    (``cz_kernel_calls_total{device="cuda"}``) and per ``"<wrapper> n=<side>"``
    (the wrappers' ``LAUNCHES_BY_SIDE``)."""
    from repro_torch.kernels import _obs, lorenzo, wavelet3d

    sides = {f"{k} n={n}": v for c in (wavelet3d.LAUNCHES_BY_SIDE, lorenzo.LAUNCHES_BY_SIDE)
             for (k, n), v in list(c.items())}
    return _obs.cuda_launches(), sides


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _encode_rank(task) -> container.ChunkTable:
    """Worker: load one rank's block span (and delete its file), then encode
    it into a private part file, with stage 1 on the task's torch device.

    Returns the part's chunk table, which the parent gathers before the
    Exscan.  The rank's ``encode`` span carries its seconds per pipeline
    stage (``stage_s``) and the kernel launches its wrappers counted
    meanwhile (``launches``, ``launches_by_side``).
    """
    spec_json, device, span_path, part_path, rank, trace_path = task
    table = container.ChunkTable()
    with _rank_tracing(rank, trace_path):
        with trace.span("span_read", rank=rank):
            blocks_np = np.load(span_path)
            os.unlink(span_path)
        before = dict(STAGE_SECONDS)
        calls0, sides0 = _launch_counts()
        t0 = time.perf_counter_ns()
        with open(part_path, "wb") as f:
            if blocks_np.shape[0]:
                pipe = Pipeline(CompressionSpec.from_json(spec_json), device=device)
                for chunk, nblk in pipe.iter_chunks(blocks_np, records=table.records):
                    f.write(chunk)
                    table.add(chunk, nblk)
            f.flush()
            os.fsync(f.fileno())
        t1 = time.perf_counter_ns()
        calls1, sides1 = _launch_counts()
        trace.record("encode", t0, t1, rank=rank, nblocks=int(blocks_np.shape[0]),
                     stage_s={k: STAGE_SECONDS[k] - before[k] for k in _RANK_STAGES},
                     launches=_delta(calls1, calls0),
                     launches_by_side=_delta(sides1, sides0))
    return table


def _write_at(task) -> None:
    """Worker: copy this rank's part file into the shared file at its
    Exscan offset (the ``MPI_File_write_at`` step), then drop the part."""
    path, offset, part_path, rank, trace_path = task
    with _rank_tracing(rank, trace_path), \
            trace.span("commit", rank=rank, offset=int(offset)):
        with open(part_path, "rb") as src:
            container.write_at(path, offset, iter(lambda: src.read(1 << 20), b""),
                               rank)
        os.unlink(part_path)


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


class ParallelCompressor:
    """Compress fields through N rank processes into single shared CZ2 files.

    Parameters
    ----------
    ranks:
        Worker-pool size and the default rank count per :meth:`compress`
        call (individual calls may use fewer ranks — the pool is shared, so
        one compressor amortizes worker startup across rank counts).
    start_method:
        ``multiprocessing`` start method.  Default ``"spawn"`` (fresh
        interpreter per rank); override with the ``REPRO_CLUSTER_START`` env
        var.  ``"fork"`` with a CUDA device raises ``ValueError``: a forked
        child cannot re-initialize the parent's CUDA runtime.
    device:
        Torch device of stage 1, in the parent and in every rank (default
        ``"cuda"``; without a GPU it raises ``RuntimeError`` here, before
        any process starts).

    The pool is created lazily on the first multi-rank compress and reused
    until :meth:`close`.  ``ranks=1`` calls stay in-process.
    """

    def __init__(self, ranks: int, start_method: str | None = None,
                 device=DEFAULT_DEVICE):
        self.ranks = int(ranks)
        if self.ranks < 1:
            raise ValueError(f"ranks must be >= 1, got {ranks}")
        self.device = torch_device(device)
        self._start = (start_method or os.environ.get(_START_ENV) or "spawn")
        if self._start == "fork" and self.device.type == "cuda":
            raise ValueError(
                f"start method 'fork' cannot run ranks on {self.device}: a "
                "forked child cannot re-initialize CUDA; use 'spawn'")
        self._pool = None

    def _get_pool(self):
        if self._pool is None:
            if self.device.type == "cuda":
                from repro_torch.kernels import _build

                _build.load_all()  # the ranks find every library built
            from ._env import worker_env
            ctx = multiprocessing.get_context(self._start)
            with worker_env():  # children inherit the thread caps at exec
                self._pool = ctx.Pool(self.ranks)
        return self._pool

    def plan(self, field_shape: tuple[int, int, int], spec: CompressionSpec,
             ranks: int | None = None) -> list[dict]:
        """Per-rank work plan: chunk span, block span, block count."""
        spec = spec.validate()
        pipe = Pipeline(spec, device=self.device)
        nblocks = int(np.prod(blk.num_blocks(tuple(field_shape), spec.block_size)))
        bpc = pipe.blocks_per_chunk
        nchunks = -(-nblocks // bpc)
        spans = chunk_spans(nchunks, self._nranks(ranks))
        return [
            {"rank": r, "chunks": (clo, chi),
             "blocks": (clo * bpc, min(chi * bpc, nblocks)),
             "nblocks": min(chi * bpc, nblocks) - clo * bpc}
            for r, (clo, chi) in enumerate(spans)
        ]

    def _nranks(self, ranks: int | None) -> int:
        n = self.ranks if ranks is None else int(ranks)
        if not 1 <= n <= self.ranks:
            raise ValueError(f"ranks must be in [1, {self.ranks}], got {n}")
        return n

    def compress(self, path: str, field, spec: CompressionSpec,
                 extra_header: dict | None = None, ranks: int | None = None,
                 fsync: bool = False) -> int:
        """Write ``field`` (numpy, or a tensor already on the device) to
        ``path`` as a CZ2 container; returns bytes written.  Output is
        bit-identical to ``container.write_compressed(path, field, spec,
        extra_header, device=device)`` for every rank count and every
        registered scheme.
        """
        spec = spec.validate()
        nranks = self._nranks(ranks)
        pipe = Pipeline(spec, device=self.device)
        header, data = container.build_field_header(pipe, field, extra_header)

        nblocks = data.shape[0]
        bpc = pipe.blocks_per_chunk
        nchunks = -(-nblocks // bpc)
        if nranks == 1 or nchunks <= 1:
            records: list = []
            return container.write_stream(
                path, pipe.iter_chunks(data, records=records), header,
                fsync=fsync, records=records)
        _COMPRESSIONS.inc(ranks=nranks)

        # when the parent is tracing, every worker task also gets a trace
        # file path: the worker collects its own timeline there and the
        # parent absorbs each onto rank track pid=r after the run
        tracing = trace.TRACER.enabled
        spec_json = spec.to_json()
        device = str(self.device)
        stage = tempfile.mkdtemp(prefix="cz-spans-")
        tasks, parts, span_files, rank_traces = [], [], [], []
        for r in range(nranks):
            part = f"{path}.rank{r}.part"
            parts.append(part)
            span_files.append(os.path.join(stage, f"rank{r}.npy"))
            enc_trace = f"{part}.enc-trace.json" if tracing else None
            wr_trace = f"{part}.wr-trace.json" if tracing else None
            rank_traces.append((enc_trace, wr_trace))
            tasks.append((spec_json, device, span_files[r], part, r, enc_trace))
        shared_created = False
        try:
            # -- phase 0: each span to the host once, then to its rank's file
            # in the staging directory
            spans = [(clo * bpc, min(chi * bpc, nblocks))
                     for clo, chi in chunk_spans(nchunks, nranks)]
            with trace.span("host_copy", ranks=nranks, nblocks=int(nblocks)):
                host = [data[blo:bhi].cpu().numpy() for blo, bhi in spans]
            with trace.span("span_write", ranks=nranks):
                for span_file, blocks_np in zip(span_files, host):
                    np.save(span_file, blocks_np)
            del host

            # -- phase 1: per-rank encode (scatter of spans, gather of sizes)
            t0 = time.perf_counter_ns()
            with trace.span("encode", ranks=nranks, nchunks=nchunks):
                enc = self._get_pool().map(_encode_rank, tasks)
            _PHASE_SECONDS.observe((time.perf_counter_ns() - t0) / 1e9,
                                   phase="encode")

            # -- phase 2: Exscan over per-rank totals -> shared-file offsets
            t0 = time.perf_counter_ns()
            with trace.span("exscan", ranks=nranks):
                totals = np.asarray([sum(t.sizes) for t in enc], np.int64)
                offsets = exclusive_offsets_np(totals)
            _PHASE_SECONDS.observe((time.perf_counter_ns() - t0) / 1e9,
                                   phase="exscan")

            # -- phase 3: ranks write at their offsets, the parent commits
            # the footer (rank-order concatenation of the gathered metadata
            # == the serial writer's chunk table, through same layout code)
            t0 = time.perf_counter_ns()
            with trace.span("commit", ranks=nranks):
                container.create_shared(path)
                shared_created = True
                self._get_pool().map(
                    _write_at,
                    [(path, int(container.DATA_START + off), part, r, wr)
                     for r, (off, part, (_enc, wr))
                     in enumerate(zip(offsets, parts, rank_traces))])
                nbytes = container.write_footer(path, header, enc, fsync=fsync)
            _PHASE_SECONDS.observe((time.perf_counter_ns() - t0) / 1e9,
                                   phase="commit")
            self._absorb_rank_traces(rank_traces)
            return nbytes
        except BaseException:
            # don't leak part files / a headerless stub on a failed rank
            for part in parts:
                _unlink(part)
            for pair in rank_traces:
                for tp in pair:
                    if tp is not None:
                        _unlink(tp)
            if shared_created:
                _unlink(path)
            raise
        finally:
            shutil.rmtree(stage, ignore_errors=True)

    @staticmethod
    def _absorb_rank_traces(rank_traces) -> None:
        """Fold each rank's saved trace files into the parent's timeline as
        ``pid=rank`` tracks, then drop the temp files.  Missing files (a
        worker died before saving) are skipped — tracing never fails a
        successful compress."""
        for r, pair in enumerate(rank_traces):
            for tp in pair:
                if tp is None:
                    continue
                try:
                    with open(tp) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue
                trace.TRACER.absorb(doc, pid=r, process_name=f"rank {r}")
                _unlink(tp)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self) -> str:
        return (f"ParallelCompressor(ranks={self.ranks}, "
                f"start={self._start!r}, "
                f"pool={'live' if self._pool else 'cold'})")
