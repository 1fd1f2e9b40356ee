"""The port's ``auto`` meta-scheme against the JAX package's, on the CPU.

``auto`` ranks every registered scheme but itself on a sample of each chunk
and encodes the chunk with the winner, behind a name + eps prelude.  Its
bytes therefore depend on every scheme's sample bytes and decoded bits; the
port is held to the reference's container byte for byte, footer
(``chunk_schemes``) included, on the committed ``golden_auto_input.npy``
under the fixture's spec (8^3 blocks, a 2 KiB buffer: one block per chunk).
A fresh reference write of that input equals the committed fixture
``cz2_auto.cz`` (checked below), so the port is held to both.

The tuner scores a candidate inadmissible only when the scheme's own guard
refuses the data; an error from a transform, as a refused kernel launch
would raise it on the card, propagates out of ``auto``.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline
from repro.core import container as rcont

from repro_torch.core import container as tcont
from repro_torch.core import szx as tszx
from repro_torch.core import wavelets as twv
from repro_torch.core import zfpx as tzfpx
from repro_torch.core.pipeline import CompressionSpec, Pipeline
from repro_torch.core.schemes import get_scheme

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
#: the fixture's spec (tests/data/make_golden.py: auto_spec)
FIXTURE = dict(scheme="auto", eps=1e-3, block_size=8, buffer_bytes=1 << 11)


def _input() -> np.ndarray:
    return np.load(os.path.join(DATA, "golden_auto_input.npy"))


def _header(path) -> dict:
    with open(path, "rb") as fh:
        return tcont._read_header(fh)[0]


def test_fresh_reference_write_equals_the_committed_fixture(tmp_path):
    path = tmp_path / "r.cz"
    rcont.write_field(str(path), _input(), RSpec(**FIXTURE))
    with open(os.path.join(DATA, "cz2_auto.cz"), "rb") as fh:
        assert path.read_bytes() == fh.read()


@pytest.mark.parametrize("extra", [{}, {"target": "abs=1e-3"}, {"target": "rel=1e-4"},
                                   {"target": "psnr=80"}, {"tune_cache": 2}],
                         ids=["default", "abs", "rel", "psnr", "tune_cache"])
def test_container_equals_reference(tmp_path, extra):
    f = _input()
    rcont.write_field(str(tmp_path / "r.cz"), f, RSpec(**FIXTURE, extra=extra))
    tcont.write_field(str(tmp_path / "t.cz"), f, CompressionSpec(**FIXTURE, extra=extra),
                      device="cpu")
    assert (tmp_path / "t.cz").read_bytes() == (tmp_path / "r.cz").read_bytes()
    hdr = _header(tmp_path / "t.cz")
    assert len(hdr["chunk_schemes"]) == len(hdr["chunk_sizes"]) == 8
    if not extra:
        with open(os.path.join(DATA, "cz2_auto.cz"), "rb") as fh:
            assert (tmp_path / "t.cz").read_bytes() == fh.read()
    dec = tcont.read_field(str(tmp_path / "t.cz"), device="cpu")
    want = rcont.read_field(str(tmp_path / "r.cz"))
    np.testing.assert_array_equal(dec.view(np.int32), want.view(np.int32))


def test_fixture_decodes_byte_exact():
    dec = tcont.read_field(os.path.join(DATA, "cz2_auto.cz"), device="cpu")
    np.testing.assert_array_equal(
        dec, np.load(os.path.join(DATA, "cz2_auto.decoded.npy")), strict=True)


def test_workers_are_byte_identical_to_serial():
    f = _input()
    spec = CompressionSpec(**FIXTURE)
    serial = Pipeline(spec, device="cpu").compress(f)
    threaded = Pipeline(spec, workers=4, device="cpu").compress(f)
    assert threaded.chunks == serial.chunks
    assert threaded.header == serial.header
    assert [r["scheme"] for r in serial.header["chunk_schemes"]] == \
        ["wavelet"] * 2 + ["szx"] * 6
    want = RPipeline(RSpec(**FIXTURE), workers=4).compress(f)
    assert threaded.chunks == want.chunks and threaded.header == want.header


def test_winner_guard_falls_through_to_the_runner_up():
    """A chunk whose sample passes szx's guard but whose full chunk does not
    (a huge value in a block the sample skips): the winner's guard refuses
    it, and the runner-up encodes it, as in the reference."""
    g = np.mgrid[0:8, 0:8, 0:8].astype(np.float32) / 8
    x = np.stack([np.sin(3 * g[0] + b) * 0.5 + g[1] for b in range(8)]).astype(np.float32)
    x[1, 3, 3, 3] = 1e6  # block 1: not in the sample (blocks 0, 2, 4, 6)
    kw = dict(scheme="auto", eps=1e-3, block_size=8)
    got = Pipeline(CompressionSpec(**kw), device="cpu").compress(x)
    want = RPipeline(RSpec(**kw)).compress(x)
    assert got.chunks == want.chunks and got.header == want.header
    assert got.header["chunk_schemes"][0]["scheme"] not in ("szx", "lorenzo")


@pytest.mark.parametrize("module,name,exc", [
    (twv, "forward3d", ValueError), (twv, "inverse3d", RuntimeError),
    (tzfpx, "encode", ValueError), (tzfpx, "decode", RuntimeError),
    (tszx, "encode", RuntimeError), (tszx, "decode", ValueError),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_a_launch_error_propagates_out_of_auto(monkeypatch, module, name, exc):
    """The plain version stands in for the kernel on the CPU: make it fail
    as a refused or failed launch would on the card.  ``auto`` must raise,
    never score the candidate as a losing trial and pick another."""
    def refuse(*a, **k):
        raise exc("kernel launch refused")

    monkeypatch.setattr(module, name, refuse)
    f = _input()
    with pytest.raises(exc, match="kernel launch refused"):
        Pipeline(CompressionSpec(**FIXTURE), device="cpu").compress(f)


def test_scheme_contract_equals_reference():
    from repro.core.schemes import get_scheme as rget_scheme

    t, r = get_scheme("auto"), rget_scheme("auto")
    for extra in ({}, {"target": "rel=1e-4"}, {"target": "psnr=80", "tune_cache": 3}):
        ts, rs = CompressionSpec(scheme="auto", extra=extra), RSpec(scheme="auto", extra=extra)
        assert t.params(ts) == r.params(rs)
        assert t.error_bound(ts) == r.error_bound(rs)
    assert t.device_capable is False
    for bad in ({"target": "abs"}, {"tune_cache": -1}, {"tune_cache": True}):
        with pytest.raises(ValueError):
            CompressionSpec(scheme="auto", extra=bad).validate()
        with pytest.raises(ValueError):
            RSpec(scheme="auto", extra=bad).validate()


def test_auto_chunk_decodes_through_the_prelude():
    f = _input()
    comp = Pipeline(CompressionSpec(**FIXTURE), device="cpu").compress(f)
    pipe = Pipeline(CompressionSpec(**FIXTURE), device="cpu")
    for i, rec in enumerate(comp.header["chunk_schemes"]):
        blocks = pipe.decompress_chunk(comp.chunks[i], 1)
        assert blocks.shape == (1, 8, 8, 8)
        assert rec["scheme"] in ("wavelet", "szx")
    assert np.max(np.abs(pipe.decompress(comp) - f)) <= 1e-3 * (1 + 1e-4)
