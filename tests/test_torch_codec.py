"""Core API parity of the port with the JAX package, on the CPU: the codec
facade (``repro_torch.core.codec``), ``Pipeline.analyze``,
``CompressedField.nbytes``, the live ``SCHEMES`` view with
``unregister_scheme``, and ``iter_chunks(workers=, executor=)``.

Every comparison runs the same numpy-seeded field through both packages.
Chunk bytes are held bit for bit (the port writes the reference's bytes for
every scheme on the CPU); the threaded and executor paths are held to the
serial path's bytes, ``auto``'s ``chunk_schemes`` records included.
"""
import concurrent.futures
import json
import math

import numpy as np
import pytest
import torch

from repro.core import codec as rcodec
from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline
from repro.core import schemes as rschemes

from repro_torch.core import codec as tcodec
from repro_torch.core import schemes as tschemes
from repro_torch.core.pipeline import CompressionSpec, Pipeline

torch.set_num_threads(1)

N, BS = 32, 8
KW = dict(block_size=BS, buffer_bytes=1 << 13)  # 16 chunks of 4 blocks
SCHEMES = ["wavelet", "zfpx", "lorenzo", "szx", "fpzipx", "raw", "auto"]


def _field(seed=3):
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:N, 0:N, 0:N].astype(np.float32) / N
    f = 30 * np.cos(3 * g[0] - g[2]) * np.exp(-g[1]) + 0.1 * rng.standard_normal((N, N, N))
    return f.astype(np.float32)


FIELD = _field()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_facade_equals_reference(scheme):
    spec, rspec = CompressionSpec(scheme=scheme, **KW), RSpec(scheme=scheme, **KW)
    got = tcodec.compress_field(FIELD, spec, device="cpu")
    want = rcodec.compress_field(FIELD, rspec)
    assert got.chunks == want.chunks and got.header == want.header
    assert got.nbytes == want.nbytes == sum(map(len, got.chunks)) + len(json.dumps(got.header))
    dec = tcodec.decompress_field(got, device="cpu")
    if scheme != "wavelet":
        np.testing.assert_array_equal(dec, rcodec.decompress_field(want), strict=True)
    else:  # the reference's eager host bits; the scheme's bound in any case
        np.testing.assert_array_equal(dec, RPipeline(rspec).decompress(want), strict=True)
    blocks = FIELD.reshape(4, BS, 4, BS, 4, BS).transpose(0, 2, 4, 1, 3, 5).reshape(-1, BS, BS, BS)
    gb = tcodec.compress_blocks(blocks, spec, {"tag": 1}, device="cpu")
    wb = rcodec.compress_blocks(blocks, rspec, {"tag": 1})
    assert gb.chunks == wb.chunks and gb.header == wb.header and gb.nbytes == wb.nbytes
    np.testing.assert_array_equal(tcodec.decompress_blocks(gb, device="cpu"),
                                  rcodec.decompress_blocks(wb) if scheme != "wavelet"
                                  else RPipeline(rspec).decompress_blocks(wb), strict=True)


@pytest.mark.parametrize("scheme", ["wavelet", "zfpx", "lorenzo", "raw", "fpzipx"])
def test_analyze_equals_reference(scheme):
    spec, rspec = CompressionSpec(scheme=scheme, **KW), RSpec(scheme=scheme, **KW)
    got = tcodec.analyze_field(FIELD, spec, device="cpu")
    want = rcodec.analyze_field(FIELD, rspec)
    assert list(got) == list(want)
    assert got["spec"].to_json() == want["spec"].to_json()
    for k in ("cr", "psnr", "max_err", "comp_bytes", "raw_bytes"):
        assert got[k] == want[k], k
    assert got == Pipeline(spec, device="cpu").analyze(torch.from_numpy(FIELD)) | {
        "spec": got["spec"]}
    if scheme in ("raw", "fpzipx"):
        assert got["max_err"] == 0.0 and math.isinf(got["psnr"])


def test_facade_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    comp = tcodec.compress_field(FIELD, CompressionSpec(scheme="raw", **KW), device="cpu")
    for call in (lambda: tcodec.compress_field(FIELD, CompressionSpec()),
                 lambda: tcodec.decompress_field(comp),
                 lambda: tcodec.compress_blocks(FIELD.reshape(-1, 8, 8, 8), CompressionSpec()),
                 lambda: tcodec.decompress_blocks(comp),
                 lambda: tcodec.analyze_field(FIELD, CompressionSpec())):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_schemes_view_is_live_and_read_only():
    assert sorted(tschemes.SCHEMES) == sorted(rschemes.SCHEMES) == tschemes.scheme_names()
    assert len(tschemes.SCHEMES) == len(rschemes.SCHEMES) == 7
    assert "wavelet" in tschemes.SCHEMES and "nope" not in tschemes.SCHEMES
    assert tschemes.SCHEMES["zfpx"] is tschemes.get_scheme("zfpx")
    assert tcodec.SCHEMES is tschemes.SCHEMES
    assert repr(tschemes.SCHEMES) == repr(rschemes.SCHEMES)
    with pytest.raises(TypeError):
        tschemes.SCHEMES["x"] = None  # read-only
    with pytest.raises(ValueError, match="unknown scheme"):
        tschemes.SCHEMES["nope"]


def test_register_and_unregister_a_third_party_scheme(tmp_path):
    """A toy scheme registers into the live view, round-trips through the
    pipeline and the container, and leaves with ``unregister_scheme``."""
    from repro_torch.core import container as tcont

    seen = list(tschemes.SCHEMES)

    @tschemes.register_scheme
    class Negate(tschemes.Scheme):
        name = "negate_toy"

        def stage1(self, blocks, spec):
            return {"x": (-blocks).cpu().numpy()}

        def serialize(self, s1, lo, hi, spec):
            return s1["x"][lo:hi].tobytes()

        def deserialize(self, payload, nblk, spec, device):
            n = spec.block_size
            return -np.frombuffer(payload, np.float32).reshape(nblk, n, n, n)

    try:
        assert "negate_toy" in tschemes.SCHEMES and len(tschemes.SCHEMES) == len(seen) + 1
        spec = CompressionSpec(scheme="negate_toy", **KW)
        np.testing.assert_array_equal(
            tcodec.decompress_field(tcodec.compress_field(FIELD, spec, device="cpu"),
                                    device="cpu"), FIELD)
        path = str(tmp_path / "toy.cz")
        tcont.write_field(path, FIELD, spec, device="cpu")
        np.testing.assert_array_equal(tcont.read_field(path, device="cpu"), FIELD)
    finally:
        tschemes.unregister_scheme("negate_toy")
    assert "negate_toy" not in tschemes.SCHEMES and list(tschemes.SCHEMES) == seen
    tschemes.unregister_scheme("negate_toy")  # absent: a no-op, as in the reference
    with pytest.raises(ValueError, match="unknown scheme"):
        CompressionSpec(scheme="negate_toy").validate()


def _drain(pipe, blocks, **kw):
    records = []
    chunks = list(pipe.iter_chunks(blocks, records=records, **kw))
    return chunks, records


@pytest.mark.parametrize("scheme", SCHEMES)
def test_iter_chunks_threaded_and_executor_equal_serial(scheme):
    spec = CompressionSpec(scheme=scheme, **KW)
    pipe = Pipeline(spec, device="cpu")
    blocks = pipe.as_tensor(FIELD).reshape(
        4, BS, 4, BS, 4, BS).permute(0, 2, 4, 1, 3, 5).reshape(-1, BS, BS, BS)
    serial = _drain(pipe, blocks)
    assert len(serial[0]) == 16
    assert _drain(pipe, blocks, workers=4) == serial
    assert _drain(Pipeline(spec, workers=3, device="cpu"), blocks) == serial
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        assert _drain(pipe, blocks, executor=ex) == serial
        assert _drain(pipe, blocks, workers=4, executor=ex) == serial
    # the reference's serial path: the same chunks and records
    rrecords = []
    rpipe = RPipeline(RSpec(scheme=scheme, **KW))
    rchunks = list(rpipe.iter_chunks(blocks.numpy(), records=rrecords))
    assert serial == (rchunks, rrecords)
    if scheme == "auto":
        assert all(r is not None and "scheme" in r for r in serial[1])
    else:
        assert serial[1] == [None] * 16


def test_threaded_writes_are_the_serial_file(tmp_path):
    """``write_compressed(workers=, executor=)``: the file a serial write
    gives, ``auto``'s ``chunk_schemes`` footer included."""
    from repro_torch.core import container as tcont

    spec = CompressionSpec(scheme="auto", **KW)
    paths = [str(tmp_path / f"{i}.cz") for i in range(3)]
    tcont.write_compressed(paths[0], FIELD, spec, device="cpu")
    tcont.write_compressed(paths[1], FIELD, spec, workers=4, device="cpu")
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        tcont.write_compressed(paths[2], FIELD, spec, executor=ex, device="cpu")
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1] == blobs[2] and b"chunk_schemes" in blobs[0]
