"""The in-situ snapshot path on the card: what crosses the bus, and the
bytes it writes.  Needs a CUDA device (``card``); imports no JAX.

A 64^3 snapshot of p and rho into a ``device="cuda"`` dataset (CubismZ's
default w3ai build): fields already on the card go to stage 1 as they are,
so only the coefficients (4 B a cell) and the mask (1 B) come down, at site
``stage1.to_host``; host fields go up once, in the spec's dtype (4 B a
cell, at ``pipeline.to_device``, float64 ones cast first).  Either way the
members and manifest are those written from the fields' numpy twins, and
the fields are not written to.
"""
import os

import pytest
import torch

from repro_torch import obs
from repro_torch.ckpt import FieldSnapshotter
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.store import DtypeCoercionWarning

N = 64
D2H = "cz_copy_bytes_total{direction=d2h,pinned=false,site=stage1.to_host}"
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


# field -> (where the tensors lie, their dtype, the dataset's scheme, the
# copies a snapshot of p and rho counts, in bytes a cell)
CASES = {"card": ("cuda", torch.float32, "wavelet", {D2H: 5}),
         "host": ("cpu", torch.float32, "wavelet", {D2H: 5, H2D: 4}),
         # cast on the host first: float32 goes up, as from the numpy twin
         "host_float64": ("cpu", torch.float64, "fpzipx", {H2D: 4})}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_snapshot_crosses_the_bus_once_and_writes_the_numpy_twins_members(
        cuda, tmp_path, case):
    where, dtype, scheme, per_cell = CASES[case]
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
    assert snaps[1] == {k: b * cells * qois for k, b in per_cell.items()}
    assert all(torch.equal(fields[q], kept[q]) for q in fields)
    assert _tree(tmp_path / "tensor") == _tree(tmp_path / "numpy")
