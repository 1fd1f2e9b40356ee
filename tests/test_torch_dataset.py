"""The port's dataset layer (``repro_torch.store``: the manifest,
``ShardWriter``, ``CZDataset``) against the JAX package's (``repro.store``),
on the CPU, and the package-level names of ``repro_torch.core`` and
``repro_torch.store``.

Every cross-package comparison runs in directories (FileStore): the two
packages' ``mem://`` and ``range://`` registries are separate, and neither
``open_store`` takes the other's ``Store`` instances.

* The same appends through both packages give byte-identical trees, every
  member and ``manifest.json``, for all seven schemes without stats and
  with them.  With ``stats=True`` the manifest records each member's PSNR
  and max error from a decode; for wavelet they are held within the
  reference's own host-decode drift (below), for the others exactly.
* A tree either package wrote opens in the other with equal ``describe()``,
  ``timestep_info``, ``read_box`` and ``read_field``; so does one with a
  rank sidecar written by the reference, whose pending member both
  packages' ``gc`` leave alone.
* The manifest and sidecar helpers write the reference's bytes and raise
  the reference's errors, message for message.
"""
import importlib
import inspect
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import core as rcore
from repro import store as rstore
from repro.core import CompressionSpec as RSpec
from repro.core import container as rcont
from repro.store import manifest as rman

import repro_torch.core as tcore
import repro_torch.store as tstore
from repro_torch.core import container as tcont
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.store import manifest as tman

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
N, BS = 16, 8
# 4 KiB buffers: 2 blocks of 8^3 float32 per chunk, 4 chunks per member
KW = dict(block_size=BS, buffer_bytes=1 << 12)
SCHEMES = ["wavelet", "zfpx", "lorenzo", "szx", "fpzipx", "raw", "auto"]
# the reference's own wavelet host decode moves by up to 1.53e-5 between jax
# versions (tests/test_golden.py, cz2_wavelet); a stats=True manifest's
# wavelet max_err is held within that, its PSNR within 1e-3 dB
WAVELET_MAX_ERR_TOL = 1.53e-5
WAVELET_PSNR_TOL_DB = 1e-3


def field(seed: int, n: int = N) -> np.ndarray:
    """A smooth seeded float32 field with noise (compresses, but not to 0)."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    f = 40 * np.sin(4 * g[0] + 2 * g[1]) * np.exp(-g[2]) + rng.standard_normal((n, n, n))
    return f.astype(np.float32)


FIELDS = {"p": field(1), "rho": field(2)}
APPENDS = [({"p": FIELDS["p"], "rho": FIELDS["rho"]}, 0.5),
           ({"p": FIELDS["p"] + np.float32(1)}, None)]


def tree(root) -> dict:
    """Every file under ``root``: relative POSIX path -> bytes."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root).replace(os.sep, "/")] = f.read()
    return out


def write_port(root, scheme: str, stats: bool = False, workers: int = 1,
               appends=APPENDS, **kw) -> None:
    with tstore.CZDataset(str(root), "a", spec=CompressionSpec(scheme=scheme, **KW),
                          stats=stats, workers=workers, device="cpu", **kw) as ds:
        for fields, time in appends:
            ds.append(fields, time=time)


def write_ref(root, scheme: str, stats: bool = False, workers: int = 1,
              appends=APPENDS) -> None:
    with rstore.CZDataset(str(root), "a", spec=RSpec(scheme=scheme, **KW),
                          stats=stats, workers=workers) as ds:
        for fields, time in appends:
            ds.append(fields, time=time)


# -- package-level names -----------------------------------------------------

REF_CORE_NAMES = ("CODEC_FORMAT", "DEVICES", "DTYPES", "CompressedField", "CompressionSpec",
                  "Pipeline", "SCHEMES", "Scheme", "get_scheme", "register_scheme",
                  "analyze_field", "compress_blocks", "compress_field", "decompress_blocks",
                  "decompress_field", "compression_ratio", "mse", "psnr")


def test_core_names_resolve_to_the_ports_objects():
    """Every name ``repro.core`` exports resolves from ``repro_torch.core``
    and is the port's own object, the one its submodule defines."""
    ref = {n for n, v in vars(rcore).items()
           if not n.startswith("_") and not inspect.ismodule(v)}
    assert ref == set(REF_CORE_NAMES)
    assert set(tcore.__all__) == ref and set(REF_CORE_NAMES) <= set(dir(tcore))
    for name in REF_CORE_NAMES:
        got = getattr(tcore, name)
        home = importlib.import_module(tcore._EXPORTS[name], "repro_torch.core")
        assert got is getattr(home, name), name
        if isinstance(got, (int, tuple)):  # constants: the reference's values
            assert got == getattr(rcore, name), name
        elif name == "SCHEMES":
            assert type(got).__module__.startswith("repro_torch.")
            assert sorted(got) == sorted(rcore.SCHEMES)
        else:
            assert got.__module__.startswith("repro_torch.core."), name
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        tcore.nope  # noqa: B018


def test_store_exports_the_reference_names():
    assert tstore.__all__ == rstore.__all__ and len(tstore.__all__) == 14
    for name in tstore.__all__:
        got = getattr(tstore, name)
        if name == "MANIFEST_NAME":
            assert got == rstore.MANIFEST_NAME
        else:
            assert got.__module__.startswith("repro_torch.store."), name
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        tstore.nope  # noqa: B018


def test_package_imports_load_no_submodule():
    """``import repro_torch.core`` and ``import repro_torch.store`` import no
    submodule (the kernels import ``core.wavelets``; the container imports
    ``store.backends``); a name resolves on first use, with ``jax`` and
    ``repro`` blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.core, repro_torch.store\n"
        "print(sorted(k for k in sys.modules if k.startswith('repro_torch')))\n"
        "from repro_torch.core import CompressionSpec, Pipeline, psnr\n"
        "from repro_torch.store import CZDataset\n"
        "assert CompressionSpec().scheme == 'wavelet' and Pipeline and psnr\n"
        "print('repro_torch.store.dataset' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-W", "error", "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == [
        "['repro_torch', 'repro_torch.core', 'repro_torch.store']", "True"]


# -- the same appends, the same bytes ------------------------------------------

@pytest.mark.parametrize("stats", [False, True], ids=["nostats", "stats"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_trees_are_the_reference_bytes(tmp_path, scheme, stats):
    """Two timesteps (p and rho at time 0.5, then p at time None) through
    both packages: every member and ``manifest.json`` byte-identical; with
    ``stats=True`` and wavelet, every member and every manifest value but
    psnr/max_err identical, and those within the stated tolerance."""
    write_ref(tmp_path / "r", scheme, stats)
    write_port(tmp_path / "t", scheme, stats)
    got, want = tree(tmp_path / "t"), tree(tmp_path / "r")
    assert sorted(got) == sorted(want) == [
        "manifest.json", "p/t000000.cz", "p/t000001.cz", "rho/t000000.cz"]
    for key in want:
        if key != "manifest.json":
            assert got[key] == want[key], key
    m = json.loads(got["manifest.json"])
    assert m["spec"]["device"] == "host" and m["version"] == 2
    recs = [ts for ent in m["quantities"].values() for ts in ent["timesteps"]]
    assert all(("psnr" in ts) == stats for ts in recs)
    assert all(("schemes" in ts) == (scheme == "auto") for ts in recs)
    if not (stats and scheme == "wavelet"):
        assert got["manifest.json"] == want["manifest.json"]
        return
    r = json.loads(want["manifest.json"])
    for q, ent in m["quantities"].items():
        for ts, rts in zip(ent["timesteps"], r["quantities"][q]["timesteps"]):
            assert abs(ts.pop("max_err") - rts.pop("max_err")) <= WAVELET_MAX_ERR_TOL
            assert abs(ts.pop("psnr") - rts.pop("psnr")) <= WAVELET_PSNR_TOL_DB
    assert m == r


def test_manifest_and_sidecar_helpers_write_the_reference_bytes(tmp_path):
    spec = CompressionSpec(scheme="zfpx", **KW).to_json()
    for pkg, sub in ((rman, "r"), (tman, "t")):
        root = str(tmp_path / sub)
        m = pkg.new_manifest(spec)
        m["quantities"]["p"] = {"shape": [N] * 3, "dtype": "float32", "timesteps": []}
        pkg.write_manifest(root, m)
        side = pkg.new_rank_manifest(3)
        side["entries"].append({"quantity": "p", "t": 4, "time": 1.5,
                                "file": "p/t000004.cz.rank3", "bytes": 10,
                                "raw_bytes": 16384, "shape": [N] * 3,
                                "dtype": "float32"})
        pkg.write_rank_manifest(root, side)
        pkg.write_rank_manifest(root, pkg.new_rank_manifest(0))
    assert tree(tmp_path / "t") == tree(tmp_path / "r")
    for pkg in (rman, tman):
        assert pkg.list_rank_manifests(str(tmp_path / "r")) == [0, 3]
        assert pkg.read_rank_manifest(str(tmp_path / "r"), 3)["entries"][0]["t"] == 4
    assert tman.read_manifest(str(tmp_path / "r")) == rman.read_manifest(str(tmp_path / "t"))
    assert [getattr(tman, n) for n in ("MANIFEST_NAME", "MANIFEST_FORMAT")] == \
        [getattr(rman, n) for n in ("MANIFEST_NAME", "MANIFEST_FORMAT")]
    for name in ("t", "p", "rho_2", "a.b-c", "..x"):
        assert bool(tman.QUANTITY_RE.match(name)) == bool(rman.QUANTITY_RE.match(name))
    for name in ("", ".", "..", "a/b", "../x", "a b"):
        assert not tman.QUANTITY_RE.match(name) and not rman.QUANTITY_RE.match(name)


def _outcome(fn):
    """One call's value, or its exception's type name and message."""
    try:
        return ("ok", fn())
    except (OSError, ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


# (file contents or None to delete, what to read): the manifest's and the
# sidecars' failure modes
BAD_MANIFESTS = {
    "corrupt": ('{"truncated": ', "manifest"),
    "bad-magic": ('{"not": "a manifest"}', "manifest"),
    "newer-format": ('{"magic": "CZDS", "format": 9}', "manifest"),
    "missing-key": ('{"magic": "CZDS", "format": 1, "version": 0, "next_t": 0, '
                    '"spec": {}}', "manifest"),
    "entry-missing-key": ('{"magic": "CZDS", "format": 1, "version": 0, "next_t": 0, '
                          '"spec": {}, "quantities": {"p": {"shape": [2, 2, 2]}}}',
                          "manifest"),
    "missing": (None, "manifest"),
    "sidecar-corrupt": ("[", "rank"),
    "sidecar-bad-magic": ('{"magic": "CZDS"}', "rank"),
    "sidecar-wrong-rank": ('{"magic": "CZRK", "rank": 2, "entries": []}', "rank"),
    "sidecar-entry-missing-key": ('{"magic": "CZRK", "rank": 1, "entries": [{"t": 0}]}',
                                  "rank"),
    "sidecar-missing": (None, "rank"),
}


@pytest.mark.parametrize("case", sorted(BAD_MANIFESTS))
def test_manifest_errors_are_the_reference_errors(tmp_path, case):
    """The same bad manifest or sidecar raises the same exception type with
    the same message from both packages, through the helpers and through
    ``CZDataset`` in both modes (a corrupt manifest is never overwritten)."""
    text, what = BAD_MANIFESTS[case]
    root = tmp_path / "ds"
    root.mkdir()
    name = "manifest.json" if what == "manifest" else "manifest.rank1.json"
    if text is not None:
        (root / name).write_text(text)
    for sub in ("r", "t"):  # both packages' message names the same url
        shutil.copytree(root, tmp_path / sub)
    r, t = str(tmp_path / "r"), str(tmp_path / "t")
    if what == "manifest":
        calls = [(lambda pkg, d: pkg.read_manifest(d)),
                 (lambda pkg, d: (rstore if pkg is rman else tstore).CZDataset(
                     d, **({} if pkg is rman else {"device": "cpu"})).version)]
        if text is not None:
            calls.append(lambda pkg, d: (rstore if pkg is rman else tstore).CZDataset(
                d, "a", **({} if pkg is rman else {"device": "cpu"})).version)
    else:
        calls = [(lambda pkg, d: pkg.read_rank_manifest(d, 1))]
    for call in calls:
        want = _outcome(lambda: call(rman, r))
        got = _outcome(lambda: call(tman, r))
        assert got == want and want[0] != "ok", case
        assert _outcome(lambda: call(tman, t))[0] == want[0]
    assert tree(tmp_path / "r") == tree(root) == tree(tmp_path / "t")


# -- cross-reading -------------------------------------------------------------

def _read_everything(ds) -> dict:
    """What a reader sees of a dataset: describe(), the timestep records,
    every member whole, and seeded random boxes."""
    rng = np.random.default_rng(5)
    out = {"describe": ds.describe(), "repr_quantities": ds.quantities,
           "info": {q: ds.timestep_info(q) for q in ds.quantities},
           "info_t": {q: [ds.timestep_info(q, t) for t in ds.timesteps(q)]
                      for q in ds.quantities},
           "dtype": {q: str(ds.dtype(q)) for q in ds.quantities},
           "shape": {q: ds.shape(q) for q in ds.quantities}, "arrays": []}
    for q in ds.quantities:
        for t in ds.timesteps(q):
            out["arrays"].append(ds.read_field(q, t))
            for _ in range(3):
                lo = rng.integers(0, N - 1, 3)
                hi = [int(rng.integers(a + 1, N + 1)) for a in lo]
                out["arrays"].append(ds.read_box(q, t, tuple(int(v) for v in lo), hi))
    return out


def _assert_same_reads(got: dict, want: dict) -> None:
    arrays_got, arrays_want = got.pop("arrays"), want.pop("arrays")
    assert got == want
    assert len(arrays_got) == len(arrays_want) > 0
    for a, b in zip(arrays_got, arrays_want):
        np.testing.assert_array_equal(a, b, strict=True)


@pytest.mark.parametrize("scheme", ["wavelet", "auto"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_either_package_reads_what_the_other_wrote(tmp_path, writer, scheme):
    """A port-written root opens in the reference's ``CZDataset`` and a
    reference-written one in the port's: the same describe(), timestep
    records, whole fields and boxes, bit for bit."""
    root = tmp_path / "ds"
    (write_port if writer == "port" else write_ref)(root, scheme, stats=True)
    with rstore.CZDataset(str(root)) as r, \
            tstore.CZDataset(str(root), device="cpu") as t:
        _assert_same_reads(_read_everything(t), _read_everything(r))
        assert t.stats()["chunks_decoded"] == r.stats()["chunks_decoded"] > 0
        assert repr(t) == repr(r)
    with rstore.CZDataset(f"file://{root}") as r, \
            tstore.CZDataset(f"file://{root}", device="cpu") as t:
        assert t.describe() == r.describe() and t.root == r.root


def _tree_with_a_sidecar(root) -> list[str]:
    """A reference dataset (one timestep of p), a member pending in the
    reference's rank-1 sidecar, and the orphans gc must find: a member the
    manifest does not name, a torn partial and a stale commit tmp."""
    write_ref(root, "lorenzo", appends=APPENDS[:1])
    rel = "p/t000007.cz.rank1"
    rcont.write_compressed(rel, FIELDS["p"], RSpec(scheme="lorenzo", **KW),
                           store=rstore.open_store(str(root)))
    side = rman.new_rank_manifest(1)
    side["entries"].append({"quantity": "p", "t": 7, "time": 2.0, "file": rel,
                            "bytes": os.path.getsize(root / rel),
                            "raw_bytes": FIELDS["p"].nbytes, "shape": [N] * 3,
                            "dtype": "float32"})
    rman.write_rank_manifest(str(root), side)
    (root / "p" / "t000003.cz").write_bytes(b"orphan")
    (root / "E").mkdir()
    (root / "E" / "t000002.cz.rank0.part").write_bytes(b"part")
    (root / "manifest.json.tmp").write_bytes(b"{}")
    return ["E/t000002.cz.rank0.part", "manifest.json.tmp", "p/t000003.cz"]


def test_rank_sidecar_root_reads_and_collects_as_the_reference(tmp_path):
    """A root with a reference-written rank sidecar: both packages open it
    alike, list the same orphans (never the sidecar's pending member), and
    the port's ``gc`` deletes exactly them, pruning the emptied directory;
    the reference then finds the dataset clean."""
    want = _tree_with_a_sidecar(tmp_path / "ds")
    shutil.copytree(tmp_path / "ds", tmp_path / "ref")
    root, ref = str(tmp_path / "ds"), str(tmp_path / "ref")
    assert tman.list_rank_manifests(root) == [1]
    assert tman.read_rank_manifest(root, 1) == rman.read_rank_manifest(root, 1)
    with rstore.CZDataset(root) as r, tstore.CZDataset(root, device="cpu") as t:
        _assert_same_reads(_read_everything(t), _read_everything(r))
        assert t.gc(dry_run=True) == r.gc(dry_run=True) == want
        with pytest.raises(IOError, match="read-only") as e:
            t.gc()
        with pytest.raises(IOError) as e_ref:
            r.gc()
        assert str(e.value) == str(e_ref.value)
    with tstore.CZDataset(root, "a", device="cpu") as t, rstore.CZDataset(ref, "a") as r:
        assert t.gc() == r.gc() == want
        assert t.gc(dry_run=True) == r.gc(dry_run=True) == []
    assert tree(root) == tree(ref)
    assert not os.path.exists(os.path.join(root, "E"))  # emptied dir pruned
    assert os.path.exists(os.path.join(root, "p", "t000007.cz.rank1"))
    with tstore.CZDataset(root, device="cpu") as t:
        np.testing.assert_array_equal(
            tcont.read_field("p/t000007.cz.rank1", device="cpu", store=t.store),
            rcont.read_field("p/t000007.cz.rank1", store=rstore.open_store(root)))
