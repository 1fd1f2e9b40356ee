"""The port's pipeline against the JAX package's, on the CPU.

Headers must equal the reference's, key order included: the two packages
write the same JSON, so either reads the other's containers.  The one
documented difference is where stage 1 ran: a pipeline on a CUDA device
records ``device="jax"`` (the kernel path, in the reference's words), which
the reference accepts.  Raw chunks are byte-identical, and threaded
encoding is byte-identical to serial.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline

from repro_torch.core.pipeline import CODEC_FORMAT, CompressionSpec, Pipeline
from repro_torch.core.schemes import get_scheme, resolved_device

# one intra-op thread: the suite runs in parallel worker processes, and
# oversubscribed CPU threads slow small torch ops by orders of magnitude
torch.set_num_threads(1)


def _field(n=32, seed=0):
    """Smooth field plus noise: some details survive the threshold."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    f = 100 * np.sin(4 * g[0]) * np.cos(3 * g[1]) + 10 * g[2] ** 2
    return (f + rng.standard_normal((n, n, n)) * 0.01).astype(np.float32)


SPECS = [
    dict(),                                                   # the paper's defaults
    dict(block_size=16, buffer_bytes=1 << 15),
    dict(block_size=8, wavelet="w4l", levels=1, buffer_bytes=1 << 12),
    dict(block_size=16, wavelet="w4i", shuffle="bit", stage2="lzma",
         buffer_bytes=1 << 14, zero_bits=4),
    dict(scheme="raw", block_size=16, buffer_bytes=1 << 14),
    dict(scheme="raw", block_size=8, dtype="float64", shuffle="none"),
]


@pytest.mark.parametrize("kw", SPECS, ids=[json.dumps(k) for k in SPECS])
def test_header_and_chunks_equal_reference(kw):
    f = _field()
    want = RPipeline(RSpec(**kw)).compress(f)
    got = Pipeline(CompressionSpec(**kw), device="cpu").compress(f)
    assert json.dumps(got.header) == json.dumps(want.header)  # key order too
    assert got.header["format"] == CODEC_FORMAT
    if kw.get("scheme") == "raw":
        assert got.chunks == want.chunks
    else:
        bound = get_scheme("wavelet").error_bound(got.spec)
        dec = Pipeline(got.spec, device="cpu").decompress(got)
        assert np.max(np.abs(dec - f)) <= bound


def test_tensor_input_equals_numpy_input():
    f = _field()
    pipe = Pipeline(CompressionSpec(block_size=16), device="cpu")
    a = pipe.compress(f)
    b = pipe.compress(torch.from_numpy(f))
    assert a.header == b.header and a.chunks == b.chunks


@pytest.mark.parametrize("scheme", ["wavelet", "raw"])
def test_threaded_equals_serial(scheme):
    f = _field(64, seed=1)
    spec = CompressionSpec(scheme=scheme, block_size=16, buffer_bytes=1 << 15)
    pipe = Pipeline(spec, device="cpu")
    blocks = pipe.as_tensor(f).reshape(-1, 16, 16, 16)
    serial = list(pipe.iter_chunks(blocks))
    threaded = list(Pipeline(spec, workers=4, device="cpu").iter_chunks(blocks))
    assert len(serial) > 4
    assert threaded == serial


def test_device_provenance_is_readable_by_the_reference():
    """``spec.device`` records where stage 1 ran, in the words the
    reference validates: ``jax`` for the kernel path on the card, ``host``
    for the plain path and for schemes without a kernel."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolved_device(cuda, True) == "jax"
    assert resolved_device(cuda, False) == "host"
    assert resolved_device(cpu, True) == "host"
    pipe = Pipeline(CompressionSpec(device="jax"), device="cpu")
    assert pipe.spec.device == "host"
    assert pipe.base_header()["scheme_params"]["device"] == "host"
    on_card = dataclasses.replace(pipe.spec, device="jax").to_json()
    RSpec(**on_card).validate()


@pytest.mark.parametrize("scheme,kw", [
    ("fpzipx", dict(precision=16, block_size=16)),
    ("auto", dict(eps=1e-4, extra={"target": "psnr=80", "tune_cache": 2})),
])
def test_fpzipx_and_auto_specs_match_reference(scheme, kw):
    spec = CompressionSpec(scheme=scheme, **kw).validate()
    ref = RSpec(scheme=scheme, **kw).validate()
    assert spec.to_json() == ref.to_json()
    assert json.dumps(spec.to_json()) == json.dumps(ref.to_json())
    assert hash(spec) == hash(CompressionSpec.from_json(ref.to_json()))
    assert hash(spec) == hash(ref)


def test_spec_json_and_hash_match_reference():
    kw = dict(eps=1e-4, block_size=16, extra={"k": 1})
    assert CompressionSpec(**kw).to_json() == RSpec(**kw).to_json()
    assert hash(CompressionSpec(**kw)) == hash(CompressionSpec(**kw))
    assert CompressionSpec.from_json(RSpec(**kw).to_json()) == CompressionSpec(**kw)
    with pytest.raises(ValueError):
        CompressionSpec(device="cuda").validate()


def test_zfpx_spec_json_and_hash_match_reference():
    """zfpx specs rebuild in either package; header and chunk bytes are
    held to the reference's in tests/test_torch_zfpx.py."""
    kw = dict(scheme="zfpx", eps=1e-2, block_size=8, shuffle="bit")
    assert CompressionSpec(**kw).validate().to_json() == RSpec(**kw).validate().to_json()
    assert hash(CompressionSpec(**kw)) == hash(CompressionSpec(**kw))
    assert CompressionSpec.from_json(RSpec(**kw).to_json()) == CompressionSpec(**kw)
    pipe = Pipeline(CompressionSpec(**kw), device="cpu")
    assert pipe.base_header()["scheme_params"] == {"eps": 1e-2, "device": "host"}


@pytest.mark.parametrize("scheme", ["lorenzo", "szx"])
def test_lorenzo_szx_spec_json_and_hash_match_reference(scheme):
    """lorenzo and szx specs rebuild in either package; header and chunk
    bytes are held to the reference's in tests/test_torch_lorenzo.py."""
    kw = dict(scheme=scheme, eps=1e-4, block_size=8, shuffle="bit")
    assert CompressionSpec(**kw).validate().to_json() == RSpec(**kw).validate().to_json()
    assert hash(CompressionSpec(**kw)) == hash(CompressionSpec(**kw))
    assert CompressionSpec.from_json(RSpec(**kw).to_json()) == CompressionSpec(**kw)
    pipe = Pipeline(CompressionSpec(**kw), device="cpu")
    assert pipe.base_header()["scheme_params"] == {"eps": 1e-4, "device": "host"}


def test_lorenzo_rejects_eps_as_the_reference():
    for eps in (0.0, -1e-3):
        with pytest.raises(ValueError, match="lorenzo requires eps > 0"):
            RSpec(scheme="lorenzo", eps=eps).validate()
        with pytest.raises(ValueError, match="lorenzo requires eps > 0"):
            CompressionSpec(scheme="lorenzo", eps=eps).validate()
