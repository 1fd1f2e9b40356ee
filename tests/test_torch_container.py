"""CZ2 containers cross-read between the port and the JAX package, and the
committed fixtures read by the port, on the CPU.

A wavelet container written by either package decodes in the other within
the scheme's declared bound, 100 eps.  The ``cz2_wavelet`` fixture is held
within 2e-5 of its committed decode, not bit for bit: the reference's own
host decode differs from that file by up to 1.53e-5 under current JAX.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import CompressionSpec as RSpec
from repro.core import container as rcont

from repro_torch.core import container as tcont
from repro_torch.core.pipeline import CompressionSpec

# one intra-op thread: the suite runs in parallel worker processes, and
# oversubscribed CPU threads slow small torch ops by orders of magnitude
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
EPS = 1e-3
BOUND = 100 * EPS


def _field(n=32, seed=0):
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    f = 50 * np.sin(5 * g[0] + g[1]) * np.exp(-g[2]) + rng.standard_normal((n, n, n)) * 0.01
    return f.astype(np.float32)


SPECS = [dict(), dict(block_size=16, wavelet="w4l", buffer_bytes=1 << 15),
         dict(block_size=8, wavelet="w4i", buffer_bytes=1 << 12)]


@pytest.mark.parametrize("kw", SPECS, ids=["default", "w4l-16", "w4i-8"])
def test_port_writes_reference_reads(tmp_path, kw):
    f = _field()
    path = str(tmp_path / "f.cz")
    nbytes = tcont.write_field(path, f, CompressionSpec(**kw), device="cpu")
    assert nbytes == os.path.getsize(path)
    dec = rcont.read_field(path, device="host")
    assert dec.shape == f.shape and dec.dtype == np.float32
    assert np.max(np.abs(dec - f)) <= BOUND
    np.testing.assert_array_equal(tcont.read_field(path, device="cpu"), dec)


@pytest.mark.parametrize("kw", SPECS, ids=["default", "w4l-16", "w4i-8"])
def test_reference_writes_port_reads(tmp_path, kw):
    f = _field(seed=1)
    path = str(tmp_path / "f.cz")
    rcont.write_field(path, f, RSpec(**kw))
    dec = tcont.read_field(path, device="cpu")
    assert np.max(np.abs(dec - f)) <= BOUND


@pytest.mark.parametrize("scheme", ["wavelet", "raw"])
def test_both_packages_write_the_same_bytes(tmp_path, scheme):
    f = _field(seed=2)
    rcont.write_field(str(tmp_path / "r.cz"), f, RSpec(scheme=scheme, block_size=16))
    tcont.write_field(str(tmp_path / "t.cz"), f,
                      CompressionSpec(scheme=scheme, block_size=16), device="cpu")
    assert (tmp_path / "t.cz").read_bytes() == (tmp_path / "r.cz").read_bytes()


@pytest.mark.parametrize("scheme", ["raw", "wavelet"])
def test_shared_file_of_two_parts_is_the_serial_file(tmp_path, scheme):
    """Two chunk-aligned parts of a field, each written at its Exscan offset
    into one shared file (``create_shared``, ``write_at``, ``write_footer``),
    make ``write_field``'s file and the JAX package's, byte for byte."""
    from repro_torch.core.pipeline import Pipeline
    from repro_torch.dist.offsets import exclusive_offsets_np

    f = _field(seed=3)
    kw = dict(scheme=scheme, block_size=16, buffer_bytes=1 << 15)  # 4 chunks of 2 blocks
    pipe = Pipeline(CompressionSpec(**kw), device="cpu")
    header, data = tcont.build_field_header(pipe, f)
    cut = pipe.blocks_per_chunk * 3   # the parts hold 3 chunks and 1
    parts = []
    for blocks in (data[:cut], data[cut:]):
        table, bufs = tcont.ChunkTable(), []
        for chunk, nblk in pipe.iter_chunks(blocks, records=table.records):
            bufs.append(chunk)
            table.add(chunk, nblk)
        parts.append((bufs, table))
    offsets = exclusive_offsets_np([sum(t.sizes) for _b, t in parts])
    shared = str(tmp_path / "shared.cz")
    tcont.create_shared(shared)
    for rank in (1, 0):   # each part at its own offset, in any order
        bufs, table = parts[rank]
        assert tcont.write_at(shared, tcont.DATA_START + int(offsets[rank]), bufs,
                              rank) == sum(table.sizes)
    nbytes = tcont.write_footer(shared, header, [t for _b, t in parts])
    tcont.write_field(str(tmp_path / "serial.cz"), f, CompressionSpec(**kw), device="cpu")
    rcont.write_field(str(tmp_path / "ref.cz"), f, RSpec(**kw))
    got = (tmp_path / "shared.cz").read_bytes()
    assert nbytes == len(got)
    assert got == (tmp_path / "serial.cz").read_bytes()
    assert got == (tmp_path / "ref.cz").read_bytes()


def test_block_batch_round_trip_and_iter_compressed(tmp_path):
    blocks = _field().reshape(-1, 8, 8, 8)
    path = str(tmp_path / "b.cz")
    spec = CompressionSpec(scheme="raw", block_size=8, buffer_bytes=1 << 13)
    tcont.write_compressed(path, blocks, spec, workers=2, device="cpu")
    np.testing.assert_array_equal(tcont.read_field(path, device="cpu"), blocks)
    assert [nb for _c, nb in tcont.iter_compressed(path)] == \
        [nb for _c, nb in rcont.iter_compressed(path)]


def test_cz1_raw_fixture_reads_bit_exact():
    dec = tcont.read_field(os.path.join(DATA, "cz1_raw.cz"), device="cpu")
    np.testing.assert_array_equal(
        dec, np.load(os.path.join(DATA, "cz1_raw.decoded.npy")), strict=True)
    np.testing.assert_array_equal(
        dec, np.load(os.path.join(DATA, "golden_input.npy")), strict=True)


def test_cz2_wavelet_fixture_reads_within_tolerance():
    dec = tcont.read_field(os.path.join(DATA, "cz2_wavelet.cz"), device="cpu")
    want = np.load(os.path.join(DATA, "cz2_wavelet.decoded.npy"))
    assert dec.shape == want.shape and dec.dtype == want.dtype
    np.testing.assert_allclose(dec, want, rtol=0, atol=2e-5)


def test_cz2_auto_fixture_reads_byte_exact():
    """A mixed container: 2 wavelet and 6 szx chunks, each behind its
    name + eps prelude."""
    dec = tcont.read_field(os.path.join(DATA, "cz2_auto.cz"), device="cpu")
    np.testing.assert_array_equal(
        dec, np.load(os.path.join(DATA, "cz2_auto.decoded.npy")), strict=True)


def test_corrupt_chunk_is_detected(tmp_path):
    path = tmp_path / "c.cz"
    tcont.write_field(str(path), _field(), CompressionSpec(block_size=16), device="cpu")
    buf = bytearray(path.read_bytes())
    buf[20] ^= 0xFF  # inside the first chunk
    path.write_bytes(bytes(buf))
    with pytest.raises(IOError, match="CRC"):
        tcont.read_field(str(path), device="cpu")


def test_not_a_container(tmp_path):
    path = tmp_path / "x.cz"
    path.write_bytes(b"NOPE" + bytes(16))
    with pytest.raises(ValueError, match="not a CZ container"):
        tcont.read_field(str(path), device="cpu")
