"""CZ container: one file per quantity, chunked (port of
``repro.core.container``, plain-file I/O).

* **CZ2** (written) — ``b"CZ2\\0"`` magic, a u64 pointer to a JSON footer,
  the chunk data, then the footer.  The metadata comes last, so the writer
  streams chunks straight from :meth:`Pipeline.iter_chunks` and patches the
  pointer at the end.  Footer keys are written in the reference's order, so
  the two packages write the same bytes for the same chunks.
* **CZ1** (legacy, read-only) — ``b"CZ1\\0"`` magic with the JSON header up
  front.

Decode is registry-driven: the scheme recorded in the header decodes, on
the torch device the caller names.  The ``device`` recorded in a header is
provenance only; any container decodes on any device.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Iterable, Iterator

import numpy as np

from repro_torch import DEFAULT_DEVICE

from . import blocks as blk
from .pipeline import CompressionSpec, Pipeline

__all__ = ["write_field", "write_compressed", "write_stream", "commit_footer",
           "build_field_header", "iter_compressed", "read_field", "MAGIC",
           "MAGIC_V1"]

MAGIC = b"CZ2\0"
MAGIC_V1 = b"CZ1\0"
_FOOTER_PTR = struct.Struct("<Q")


def commit_footer(f, base_header: dict, sizes: list[int], nblks: list[int],
                  crcs: list[int], footer_off: int,
                  records: list | None = None) -> int:
    """Append the JSON footer at ``footer_off`` and patch the magic's footer
    pointer; returns the container's total byte count.  Header key order
    decides byte identity with the reference's containers.

    ``records`` is the per-chunk :meth:`Scheme.chunk_record` collection; it
    becomes the footer's ``chunk_schemes`` table only when some chunk
    recorded something, so single-scheme containers keep their bytes."""
    header = dict(base_header)
    header.update({
        "nblocks": int(sum(nblks)),
        "chunk_nblocks": nblks,
        "chunk_sizes": sizes,
        "chunk_crc32": crcs,
    })
    if records is not None and any(r is not None for r in records):
        header["chunk_schemes"] = records
    hbytes = json.dumps(header).encode()
    f.seek(footer_off)
    f.write(hbytes)
    f.seek(len(MAGIC))
    f.write(_FOOTER_PTR.pack(footer_off))
    return footer_off + len(hbytes)


def write_stream(path: str, chunk_iter: Iterable[tuple[bytes, int]],
                 base_header: dict, records: list | None = None) -> int:
    """Stream ``(chunk, nblk)`` pairs to a CZ2 file; one chunk in memory.
    ``records`` is the list the chunk iterator fills as it drains
    (``Pipeline.iter_chunks(records=...)``), read once the loop is done."""
    sizes: list[int] = []
    nblks: list[int] = []
    crcs: list[int] = []
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_FOOTER_PTR.pack(0))  # patched once the footer offset is known
        for chunk, nblk in chunk_iter:
            f.write(chunk)
            sizes.append(len(chunk))
            nblks.append(nblk)
            crcs.append(zlib.crc32(chunk) & 0xFFFFFFFF)
        return commit_footer(f, base_header, sizes, nblks, crcs, f.tell(),
                             records=records)


def build_field_header(pipe: Pipeline, source, extra_header: dict | None = None):
    """Assemble a container header for a 3D field / 4D block batch (numpy or
    tensor) and return ``(header, blocks)``, the blocks a tensor on the
    pipeline's device."""
    spec = pipe.spec
    data = pipe.as_tensor(source)
    header = pipe.base_header()
    if data.ndim == 3:
        header["field_shape"] = list(data.shape)
        data = blk.blockify(data, spec.block_size)
    elif data.ndim != 4:
        raise ValueError(f"expected 3D field or 4D block batch, got {tuple(data.shape)}")
    header["raw_bytes"] = int(data.numel() * spec.np_dtype.itemsize)
    if extra_header:
        header.update(extra_header)
    return header, data


def write_compressed(path: str, source, spec: CompressionSpec,
                     extra_header: dict | None = None, workers: int = 1,
                     device=DEFAULT_DEVICE) -> int:
    """Write a CZ2 container of a 3D field / 4D block batch (numpy, or a
    tensor already on ``device``), compressed on the fly through
    :meth:`Pipeline.iter_chunks`; returns total bytes written."""
    pipe = Pipeline(spec, workers=workers, device=device)
    header, data = build_field_header(pipe, source, extra_header)
    records: list = []
    return write_stream(path, pipe.iter_chunks(data, records=records), header,
                        records=records)


def write_field(path: str, field, spec: CompressionSpec, workers: int = 1,
                device=DEFAULT_DEVICE) -> int:
    return write_compressed(path, field, spec, workers=workers, device=device)


def _read_header(f) -> tuple[dict, int]:
    """Dispatch on magic; returns (header, data_start)."""
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


def _read(path: str) -> tuple[dict, Iterator[tuple[bytes, int]]]:
    """The header and a CRC-checked ``(chunk, nblk)`` stream of a container
    (the data region is read in one go)."""
    with open(path, "rb") as f:
        header, data_start = _read_header(f)
        f.seek(data_start)
        data = f.read(int(sum(header["chunk_sizes"])))

    def chunks():
        off = 0
        for sz, nblk, crc in zip(header["chunk_sizes"], header["chunk_nblocks"],
                                 header["chunk_crc32"]):
            chunk = data[off:off + sz]
            off += sz
            if len(chunk) != sz or (zlib.crc32(chunk) & 0xFFFFFFFF) != crc:
                raise IOError("chunk CRC mismatch — corrupt container")
            yield chunk, nblk

    return header, chunks()


def iter_compressed(path: str) -> Iterator[tuple[bytes, int]]:
    """Stream ``(chunk, nblk)`` pairs out of a container, CRC-checked."""
    yield from _read(path)[1]


def read_field(path: str, device=DEFAULT_DEVICE) -> np.ndarray:
    """Decompress a whole container on ``device``: the field, or the raw
    blocks if the file was written from a block batch."""
    header, chunks = _read(path)
    pipe = Pipeline(CompressionSpec.from_json(header["spec"]), device=device)
    fmt = int(header.get("format", 1))
    blocks = np.concatenate([pipe.decompress_chunk(c, nblk, fmt) for c, nblk in chunks])
    shape = header.get("field_shape")
    if shape is None:
        return blocks
    return blk.unblockify(blocks, tuple(shape))
