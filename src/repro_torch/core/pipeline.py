"""Streaming two-substage compression pipeline (port of
``repro.core.pipeline``).

  field -> blocks -> [substage 1: a registered Scheme, on the pipeline's
        torch device] -> per-"thread" aggregation buffers (~4 MB of blocks)
        -> scheme byte layout (+ optional byte/bit shuffle)
        -> [substage 2: zlib | lzma | bz2 | ... on the host]
        -> chunk stream + JSON-able header

:class:`CompressionSpec` has the reference's fields, defaults, JSON and
hash, so a header written by either package rebuilds a valid spec in the
other.  :class:`Pipeline` binds a spec to its scheme and to a torch device;
``spec.device`` then records where stage 1 ran (``"jax"`` on the kernel
path, ``"host"`` on the plain path; see ``schemes._device``).

Chunks are independent, so ``iter_chunks`` optionally encodes them on a
thread pool (``workers=``): serialization + stage 2 run in parallel while
one ordered drain yields chunks in order, so serial and threaded runs are
byte-identical.  ``CODEC_FORMAT`` is the reference's chunk layout version.

``STAGE_SECONDS`` sums the host-clock seconds of each stage over every call
(and every worker thread); a caller zeroes or snapshots it to time a run.
Stage 1 ends with its copies to the host, so its seconds include the card's
work.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE

from . import blocks as blk
from . import lossless
from .schemes import (Scheme, check_device, get_scheme, resolved_device,
                      torch_device)

__all__ = ["CODEC_FORMAT", "DTYPES", "STAGE_SECONDS", "CompressionSpec",
           "CompressedField", "Pipeline"]

#: version of the per-chunk byte layout, as in the reference
CODEC_FORMAT = 3

#: dtypes a container can record; CZ1/headerless payloads default to float32
DTYPES = ("float32", "float64", "float16")

#: host seconds per stage, summed over calls; see the module docstring
STAGE_SECONDS = dict.fromkeys(
    ("stage1", "serialize", "stage2_encode", "stage2_decode", "deserialize"), 0.0)
_STAGE_LOCK = threading.Lock()


@contextlib.contextmanager
def _timed(stage: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _STAGE_LOCK:
            STAGE_SECONDS[stage] += dt


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    scheme: str = "wavelet"      # a registered scheme (wavelet | zfpx | lorenzo | szx | raw)
    wavelet: str = "w3ai"        # w4i | w4l | w3ai
    eps: float = 1e-3            # absolute error tolerance
    block_size: int = 32
    levels: int | None = None    # wavelet levels (None = max for block size)
    shuffle: str = "byte"        # none | byte | bit
    zero_bits: int = 0           # Z4/Z8 bit zeroing of detail coefficients
    stage2: str = "zlib"         # see repro_torch.core.lossless.METHODS
    buffer_bytes: int = 4 << 20  # per-thread aggregation buffer (paper: 4 MB)
    precision: int = 32          # fpzipx bits of precision (kept for headers)
    dtype: str = "float32"       # field dtype tag (see DTYPES)
    device: str = "host"         # where stage 1 ran: host | jax (set by Pipeline)
    extra: dict = dataclasses.field(default_factory=dict)  # third-party knobs

    def __hash__(self):
        # the generated hash would choke on the mutable `extra` dict
        return hash(tuple(
            tuple(sorted(v.items())) if isinstance(v, dict) else v
            for v in dataclasses.astuple(self)
        ))

    def validate(self) -> "CompressionSpec":
        if self.shuffle not in ("none", "byte", "bit"):
            raise ValueError(f"unknown shuffle {self.shuffle}")
        if self.stage2 not in lossless.METHODS:
            raise ValueError(f"unknown stage2 {self.stage2}")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype}; one of {DTYPES}")
        check_device(self.device)
        blk.check_block_size(self.block_size)
        get_scheme(self.scheme).validate(self)
        return self

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "CompressionSpec":
        return CompressionSpec(**d)


class CompressedField:
    """In-memory compressed representation: chunk list + JSON-able header."""

    def __init__(self, chunks: list[bytes], header: dict):
        self.chunks = chunks
        self.header = header

    @property
    def spec(self) -> CompressionSpec:
        return CompressionSpec.from_json(self.header["spec"])

    @property
    def format(self) -> int:
        """Chunk byte-layout version (headers before CZ2 carried none)."""
        return int(self.header.get("format", 1))


class Pipeline:
    """A validated spec bound to its registered scheme and a torch device.

    Stage 1 runs on ``device`` (default ``"cuda"``; ``"cuda"`` without a GPU
    raises).  ``workers > 1`` encodes aggregation buffers on a thread pool
    (ordered drain, byte-identical to the serial path).
    """

    def __init__(self, spec: CompressionSpec, workers: int = 1,
                 device=DEFAULT_DEVICE):
        self.device = torch_device(device)
        spec.validate()
        self.scheme: Scheme = get_scheme(spec.scheme)
        self.spec = dataclasses.replace(
            spec, device=resolved_device(self.device, self.scheme.device_capable))
        self.workers = max(1, int(workers))

    # -- layout ------------------------------------------------------------

    @property
    def blocks_per_chunk(self) -> int:
        raw_block = self.spec.np_dtype.itemsize * self.spec.block_size ** 3
        return max(1, self.spec.buffer_bytes // raw_block)

    def base_header(self) -> dict:
        """Self-describing header stub, keys in the reference's order."""
        return {
            "format": CODEC_FORMAT,
            "scheme": self.spec.scheme,
            "scheme_params": self.scheme.params(self.spec),
            "dtype": self.spec.dtype,
            "spec": self.spec.to_json(),
        }

    def as_tensor(self, data) -> torch.Tensor:
        """``data`` (numpy array or tensor) in the spec's dtype on this
        pipeline's device."""
        if isinstance(data, torch.Tensor):
            return data.to(self.device, getattr(torch, self.spec.dtype))
        a = np.ascontiguousarray(data, self.spec.np_dtype)
        if not a.flags.writeable:  # torch.from_numpy warns on read-only arrays
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    # -- compression -------------------------------------------------------

    def iter_chunks(self, blocks) -> Iterator[tuple[bytes, int]]:
        """Yield ``(chunk_bytes, n_blocks)`` one aggregation buffer at a time.

        Substage 1 runs once over the whole batch on the device; its host
        streams stay resident for the generator's lifetime, while
        serialization and substage 2 stream chunk by chunk.
        """
        spec = self.spec
        blocks = self.as_tensor(blocks)
        with _timed("stage1"):
            s1 = self.scheme.stage1(blocks, spec)
        nblk = blocks.shape[0]
        bpc = self.blocks_per_chunk
        ranges = [(lo, min(lo + bpc, nblk)) for lo in range(0, nblk, bpc)]

        def encode(lo: int, hi: int) -> bytes:
            with _timed("serialize"):
                payload = self.scheme.serialize(s1, lo, hi, spec)
            with _timed("stage2_encode"):
                return lossless.encode(payload, spec.stage2)

        nworkers = self.workers
        if nworkers <= 1:
            for lo, hi in ranges:
                yield encode(lo, hi), hi - lo
            return

        with concurrent.futures.ThreadPoolExecutor(nworkers) as pool:
            # keep at most ~2x workers chunks in flight: parallelism without
            # materializing the whole compressed chunk list
            it = iter(ranges)
            pending = collections.deque(
                (r, pool.submit(encode, *r))
                for r in itertools.islice(it, 2 * nworkers))
            try:
                while pending:
                    (lo, hi), fut = pending.popleft()
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append((nxt, pool.submit(encode, *nxt)))
                    yield fut.result(), hi - lo
            finally:
                for _r, fut in pending:
                    fut.cancel()

    def compress_blocks(self, blocks, extra_header: dict | None = None
                        ) -> CompressedField:
        blocks = self.as_tensor(blocks)
        chunks, chunk_nblocks = [], []
        for chunk, nblk in self.iter_chunks(blocks):
            chunks.append(chunk)
            chunk_nblocks.append(nblk)
        header = self.base_header()
        header.update({
            "nblocks": int(blocks.shape[0]),
            "chunk_nblocks": chunk_nblocks,
            "chunk_sizes": [len(c) for c in chunks],
            "raw_bytes": int(blocks.numel() * self.spec.np_dtype.itemsize),
        })
        if extra_header:
            header.update(extra_header)
        return CompressedField(chunks, header)

    def compress_field(self, field, extra_header: dict | None = None
                       ) -> CompressedField:
        """Compress a 3D field: a numpy array, or a tensor already on the
        device (it is not copied to the host first)."""
        blocks = blk.blockify(self.as_tensor(field), self.spec.block_size)
        hdr = {"field_shape": list(field.shape)}
        if extra_header:
            hdr.update(extra_header)
        return self.compress_blocks(blocks, hdr)

    def compress(self, data, extra_header: dict | None = None) -> CompressedField:
        """Compress a 3D field or a (nblk, bs, bs, bs) block batch."""
        if data.ndim == 3:
            return self.compress_field(data, extra_header)
        if data.ndim == 4:
            return self.compress_blocks(data, extra_header)
        raise ValueError(f"expected 3D field or 4D block batch, got {tuple(data.shape)}")

    # -- decompression -----------------------------------------------------

    def decompress_chunk(self, buf: bytes, nblk: int,
                         fmt: int = CODEC_FORMAT) -> np.ndarray:
        """One chunk written under container format ``fmt`` -> its blocks."""
        spec = self.scheme.decode_spec(self.spec, fmt)
        with _timed("stage2_decode"):
            payload = lossless.decode(buf, spec.stage2)
        with _timed("deserialize"):
            blocks = self.scheme.deserialize(payload, nblk, spec, self.device)
        # lossy schemes compute in float32; the dtype tag restores the field
        # dtype (raw already deserializes in the tagged dtype — no-op there)
        return blocks.astype(spec.np_dtype, copy=False)

    def decompress_blocks(self, comp: CompressedField) -> np.ndarray:
        return np.concatenate([
            self.decompress_chunk(buf, nb, comp.format)
            for buf, nb in zip(comp.chunks, comp.header["chunk_nblocks"])
        ], axis=0)

    def decompress(self, comp: CompressedField) -> np.ndarray:
        """Blocks back, or the reassembled field if the header recorded one."""
        blocks_np = self.decompress_blocks(comp)
        shape = comp.header.get("field_shape")
        if shape is None:
            return blocks_np
        return blk.unblockify(blocks_np, tuple(shape))
