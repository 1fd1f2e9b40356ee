"""The in-situ snapshot path on the card: what crosses the bus, and the
bytes it writes.  Needs a CUDA device (``card``); imports no JAX.

A 64^3 snapshot of p and rho into a ``device="cuda"`` dataset (CubismZ's
default w3ai build): fields already on the card go to stage 1 as they are,
and only the packed stage 1 comes down at site ``stage1.to_host``: per
block its u32 count, its mask at a bit a cell and its coarse corner, and
the significant details, 4 B each (the CPU's stage 1 of the numpy twin
counts them); the detail total's 8 B come down first, at site
``wavelet_pack.total``.  Host fields go up once, in the spec's dtype (4 B a
cell, at ``pipeline.to_device``, float64 ones cast first).  Either way the
members and manifest are those written from the fields' numpy twins, and
the fields are not written to.  The pack kernel is also held to its plain
version at the threshold's edge values.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.ckpt import FieldSnapshotter
from repro_torch.core import blocks as blk
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.core.schemes import get_scheme
from repro_torch.kernels import ops
from repro_torch.kernels.wavelet_pack import pack_plain
from repro_torch.store import DtypeCoercionWarning

N = 64
D2H = "cz_copy_bytes_total{direction=d2h,pinned=false,site=stage1.to_host}"
TOTAL = "cz_copy_bytes_total{direction=d2h,pinned=false,site=wavelet_pack.total}"
H2D = "cz_copy_bytes_total{direction=h2d,pinned=false,site=pipeline.to_device}"


def _tree(root) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


def _copies() -> dict:
    out = {}
    for labels, value in obs.REGISTRY.get("cz_copy_bytes_total").samples():
        tag = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        out[f"cz_copy_bytes_total{{{tag}}}"] = value
    return out


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _packed_bytes(twins: dict, spec) -> int:
    """What the packed stage 1 of these fields brings down: the CPU's
    stage 1 of their numpy twins, whose bytes the card's equal."""
    sch, total = get_scheme("wavelet"), 0
    for f in twins.values():
        s1 = sch.stage1(blk.blockify(torch.from_numpy(f), spec.block_size), spec)
        total += sum(s1[k].nbytes for k in ("counts", "packed", "coarse", "details"))
    return total


# field -> (where the tensors lie, their dtype, the dataset's scheme, the
# copies a snapshot of p and rho counts: stage 1's packed bytes, and the
# rest in bytes a cell)
CASES = {"card": ("cuda", torch.float32, "wavelet", True, {}),
         "host": ("cpu", torch.float32, "wavelet", True, {H2D: 4}),
         # cast on the host first: float32 goes up, as from the numpy twin
         "host_float64": ("cpu", torch.float64, "fpzipx", False, {H2D: 4})}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_snapshot_crosses_the_bus_once_and_writes_the_numpy_twins_members(
        cuda, tmp_path, case):
    where, dtype, scheme, packed, per_cell = CASES[case]
    g = torch.Generator(device=cuda).manual_seed(5)
    fields = {q: (torch.randn((N, N, N), generator=g, device=cuda) * 10).to(where, dtype)
              for q in ("p", "rho")}
    twins = {q: f.cpu().numpy() for q, f in fields.items()}
    kept = {q: f.clone() for q, f in fields.items()}
    spec = CompressionSpec(scheme=scheme)
    snaps = []
    for kind, given in (("numpy", twins), ("tensor", fields)):
        snap = FieldSnapshotter(str(tmp_path / kind), spec=spec, workers=2, device=cuda)
        torch.cuda.synchronize()
        before = _copies()
        if dtype == torch.float32:
            snap.maybe_snapshot(given, 0)          # the twin's builds and loads the kernel
        else:
            with pytest.warns(DtypeCoercionWarning, match=scheme):
                snap.maybe_snapshot(given, 0)
        torch.cuda.synchronize()
        snaps.append({k: v - before.get(k, 0) for k, v in _copies().items()
                      if v != before.get(k, 0)})
        snap.close()
    cells, qois = N ** 3, len(fields)
    want = {k: b * cells * qois for k, b in per_cell.items()}
    if packed:
        want.update({D2H: _packed_bytes(twins, spec), TOTAL: 8 * qois})
    assert snaps[1] == want
    assert all(torch.equal(fields[q], kept[q]) for q in fields)
    assert _tree(tmp_path / "tensor") == _tree(tmp_path / "numpy")


@pytest.mark.card
@pytest.mark.parametrize("eps", [1e-3, 7e-4, 0.0])
def test_pack_kernel_is_its_plain_version_at_the_threshold_edges(cuda, eps):
    """+-eps in float32 and its neighbours, +-0.0, NaNs, infinities and a
    subnormal, in detail and coarse cells: the kernel's four outputs are
    the plain version's on the CPU, bit for bit.  (float32(7e-4) < 7e-4:
    the kernel compares in float32, as torch does.)"""
    rng = np.random.default_rng(11)
    e = np.float32(eps)
    edge = np.array([e, -e, np.nextafter(e, np.float32(0)), np.nextafter(e, np.float32(1)),
                     -np.nextafter(e, np.float32(0)), -np.nextafter(e, np.float32(1)),
                     0.0, -0.0, np.inf, -np.inf, np.float32(1e-40)], np.float32)
    edge = np.concatenate([edge, np.array([0x7FC00000, 0xFFC00000, 0x7F800001],
                                          np.uint32).view(np.float32)])
    for n, nblk in ((8, 40), (32, 12), (64, 3)):
        x = (rng.standard_normal((nblk, n, n, n)) * 2 * eps).astype(np.float32)
        flat = x.reshape(nblk, -1)
        for b in range(nblk):
            flat[b, rng.choice(n ** 3, size=4 * edge.size, replace=False)] = np.tile(edge, 4)
            flat[b, : edge.size] = edge
        x[1] = 0.0
        host = torch.from_numpy(x)
        got = ops.wavelet_pack(host.to(cuda), eps, None)
        want = pack_plain(host, eps, None)
        for g, w in zip(got, want):
            g = g.cpu()
            assert g.dtype == w.dtype and g.shape == w.shape
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w), (n, eps)
