"""The port's checkpoints and field snapshots (``repro_torch.ckpt``) against
the JAX package's (``repro.ckpt``), on the CPU.

* Leaf keys and order are JAX's (``tree_flatten_with_path``): a plain dict
  sorted, an ``OrderedDict`` (``nn.Module.state_dict()``) in insertion
  order, list and tuple items ``[i]``, namedtuple fields ``.name``, ``None``
  no leaf.  The order sets the offsets, so it decides the bytes.
* The same state saved by both packages gives byte-identical ``.czq`` files
  and ``manifest.json`` under fpzipx (the default), szx and wavelet (16^3
  blocks, eps 1e-3), and each package loads the other's: bit-exact under
  fpzipx, within the scheme's bound under szx (``eps * 1.01 + 1e-6``, the
  reference's own test) and wavelet (100 eps).  The state holds a plain
  dict, an ``OrderedDict``, a list, a tuple, a ``None``, a 0-d int32, a
  Python float and a bfloat16 tensor (a ``jnp`` bfloat16 array on the
  reference's side, with the same bits).
* bfloat16 round-trips in a process where ``ml_dtypes`` cannot be imported.
* ``FieldSnapshotter``: the reference's round trip on the port, and
  snapshots either package wrote, from numpy or tensor fields, restore in
  the other.  Tensor fields write their numpy twins' members and manifest
  byte for byte, with no host copy and nothing counted on the CPU.
"""
import collections
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.ckpt import FieldSnapshotter as RSnapshotter
from repro.ckpt import checkpoint as rck
from repro.core import CompressionSpec as RSpec

import repro_torch.ckpt as tckpt
from repro_torch import obs
from repro_torch.ckpt import (Checkpointer, FieldSnapshotter, latest_step, load_checkpoint,
                              restore_tree, save_checkpoint)
from repro_torch.ckpt import checkpoint as tck
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.store.writer import DtypeCoercionWarning

from test_torch_dataset import tree

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
EPS = 1e-3
# scheme -> the bound a float32 leaf is held to after a round trip (None: bit-exact)
SCHEMES = {"fpzipx": None, "szx": EPS * 1.01 + 1e-6, "wavelet": 100 * EPS}
Pair = collections.namedtuple("Pair", "mu nu")


def _arrays(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    bf = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)).to(torch.bfloat16)
    return {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "v": rng.standard_normal(300).astype(np.float32),
            "g": np.linspace(-3, 3, 5000, dtype=np.float32).reshape(50, 100),
            "bf_bits": bf.view(torch.int16).numpy()}


def _port_state(a: dict) -> dict:
    t = torch.from_numpy
    return {"params": {"w": t(a["w"].copy()), "b": torch.zeros(32)},
            "opt": collections.OrderedDict([("v", t(a["v"].copy())), ("a", torch.ones(3))]),
            "lst": [t(a["g"].copy()), (t(a["w"][0].copy()), None)],
            "step": torch.tensor(7, dtype=torch.int32), "lr": 0.001, "none": None,
            "emb": t(a["bf_bits"].copy()).view(torch.bfloat16)}


def _ref_state(a: dict) -> dict:
    j = jnp.asarray
    return {"params": {"w": j(a["w"]), "b": jnp.zeros((32,))},
            "opt": collections.OrderedDict([("v", j(a["v"])), ("a", jnp.ones((3,)))]),
            "lst": [j(a["g"]), (j(a["w"][0]), None)],
            "step": jnp.int32(7), "lr": 0.001, "none": None,
            "emb": j(a["bf_bits"].view(ml_dtypes.bfloat16))}


def _spec(pkg, scheme: str):
    cls = RSpec if pkg == "ref" else CompressionSpec
    return None if scheme == "fpzipx" else cls(scheme=scheme, eps=EPS, block_size=16)


def _files(d: str) -> dict:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def _as_numpy(x) -> np.ndarray:
    """A loaded leaf as numpy, bfloat16 as its int16 bits."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _want(a: dict) -> dict:
    """Each leaf's saved value, by key in JAX's order, as :func:`_as_numpy`
    gives it."""
    return {"emb": a["bf_bits"], "lr": np.float64(0.001), "lst/[0]": a["g"],
            "lst/[1]/[0]": a["w"][0], "opt/v": a["v"], "opt/a": np.ones(3, np.float32),
            "params/b": np.zeros(32, np.float32), "params/w": a["w"], "step": np.int32(7)}


def _check_loaded(flat: dict, a: dict, bound) -> None:
    want = _want(a)
    assert list(flat) == list(want)
    for k, w in want.items():
        got = _as_numpy(flat[k])
        assert got.dtype == np.asarray(w).dtype and got.shape == np.shape(w), k
        if bound is None or got.dtype != np.float32:
            assert got.tobytes() == np.asarray(w).tobytes(), k
        else:
            assert np.max(np.abs(got.astype(np.float64) - w)) <= bound, k


# -- leaf keys and order -----------------------------------------------------

def _ref_keys(state) -> list[str]:
    return [rck._leaf_key(p) for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]


def _keyed_states():
    mixed = {"z": 1.0, "b": [1, (2, None, {"y": 3, "x": 4})],
             "a": collections.OrderedDict([("q", 5), ("c", [6, 7])]),
             "n": Pair(8, {"k": 9}), "d": collections.defaultdict(int, {"t": 10, "s": 11}),
             "e": [], "f": {}, "g": None}
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4),
                              torch.nn.Linear(4, 2))
    sd = net.state_dict()
    return {"mixed": (mixed, mixed),
            "state_dict": ({"model": sd, "step": 3},
                           {"model": collections.OrderedDict(
                               (k, jnp.asarray(v.numpy())) for k, v in sd.items()),
                            "step": 3}),
            "top_list": ([[1, 2], (3,), None, 4], [[1, 2], (3,), None, 4])}


@pytest.mark.parametrize("case", ["mixed", "state_dict", "top_list"])
def test_leaf_keys_and_order_are_jax(case):
    port_state, ref_state = _keyed_states()[case]
    assert [k for k, _ in tck._flatten(port_state)] == _ref_keys(ref_state)


def test_state_dict_keeps_insertion_order():
    sd = collections.OrderedDict([("z", torch.ones(1)), ("a", torch.zeros(1))])
    assert [k for k, _ in tck._flatten({"m": sd})] == ["m/z", "m/a"]
    assert [k for k, _ in tck._flatten({"m": dict(sd)})] == ["m/a", "m/z"]


# -- bytes and cross-loading -------------------------------------------------

@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_same_state_gives_the_references_bytes(tmp_path, scheme):
    a = _arrays()
    mr = rck.save_checkpoint(str(tmp_path / "ref"), _ref_state(a), 3, spec=_spec("ref", scheme))
    mt = save_checkpoint(str(tmp_path / "port"), _port_state(a), 3,
                         spec=_spec("port", scheme), device="cpu")
    assert mt == mr
    assert json.loads(json.dumps(mt)) == mt
    assert mt["spec"]["device"] == "host"
    ref_files = _files(str(tmp_path / "ref" / "step_00000003"))
    assert sorted(ref_files) == ["emb.czq", "lr.czq", "lst.czq", "manifest.json", "opt.czq",
                                 "params.czq", "step.czq"]
    assert _files(str(tmp_path / "port" / "step_00000003")) == ref_files


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_each_package_loads_the_others(tmp_path, scheme):
    a = _arrays(1)
    rck.save_checkpoint(str(tmp_path / "ref"), _ref_state(a), 5, spec=_spec("ref", scheme))
    save_checkpoint(str(tmp_path / "port"), _port_state(a), 5, spec=_spec("port", scheme),
                    device="cpu")
    flat, manifest = load_checkpoint(str(tmp_path / "ref"), device="cpu")
    assert manifest["step"] == 5
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in flat.values())
    _check_loaded(flat, a, SCHEMES[scheme])
    flat_ref, _ = rck.load_checkpoint(str(tmp_path / "port"))
    _check_loaded(flat_ref, a, SCHEMES[scheme])
    if scheme != "wavelet":  # the reference's host wavelet decode drifts across jax versions
        for k, v in flat.items():
            assert _as_numpy(v).tobytes() == _as_numpy(flat_ref[k]).tobytes(), k


def test_bfloat16_round_trips_without_ml_dtypes(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from repro_torch.ckpt import load_checkpoint, save_checkpoint\n"
        "x = (torch.arange(24, dtype=torch.float32) / 7 - 1).to(torch.bfloat16).reshape(4, 6)\n"
        f"m = save_checkpoint({str(tmp_path)!r}, {{'e': x, 's': [x[0]]}}, 1, device='cpu')\n"
        "assert m['quantities']['e'][0]['dtype'] == 'bfloat16'\n"
        f"flat, _ = load_checkpoint({str(tmp_path)!r}, device='cpu')\n"
        "assert flat['e'].dtype == torch.bfloat16 and flat['e'].shape == (4, 6)\n"
        "assert torch.equal(flat['e'].view(torch.int16), x.view(torch.int16))\n"
        "assert torch.equal(flat['s/[0]'].view(torch.int16), x[0].view(torch.int16))\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-W", "error", "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_wavelet_checkpoint_runs_the_kernel_wrappers_plain_path(tmp_path):
    calls = obs.REGISTRY.get("cz_kernel_calls_total")
    x = torch.from_numpy(_arrays()["g"])  # 5000 values: two 16^3 blocks, padded
    state = {"g": x, "h": torch.zeros(3 * 4096 + 1)}  # four blocks: a shard each
    spec = _spec("port", "wavelet")
    f0 = calls.value(kernel="wavelet_forward", device="cpu")
    m = save_checkpoint(str(tmp_path), state, 1, spec=spec, n_shards=8, device="cpu")
    nshards = sum(len(e["sizes"]) for q in m["quantities"].values() for e in q)
    assert nshards == 2 + 4
    assert calls.value(kernel="wavelet_forward", device="cpu") - f0 == nshards
    i0 = calls.value(kernel="wavelet_inverse", device="cpu")
    flat, _ = load_checkpoint(str(tmp_path), device="cpu")
    assert calls.value(kernel="wavelet_inverse", device="cpu") - i0 == nshards
    assert float((flat["g"] - x).abs().max()) <= 100 * EPS


def test_restore_tree_casts_to_the_template():
    a = _arrays()
    flat = {"t": torch.from_numpy(a["w"]), "n": torch.from_numpy(a["v"]),
            "s/[0]": torch.tensor(3, dtype=torch.int64), "b": torch.ones(2)}
    template = {"t": torch.zeros(1, dtype=torch.float64), "n": np.zeros(1, np.float16),
                "s": [0, None], "b": torch.zeros(2, dtype=torch.bfloat16)}
    out = restore_tree(template, flat)
    assert out["t"].dtype == torch.float64 and torch.equal(out["t"],
                                                           torch.from_numpy(a["w"]).double())
    assert isinstance(out["n"], np.ndarray) and out["n"].dtype == np.float16
    assert out["s"][1] is None and int(out["s"][0]) == 3
    assert out["b"].dtype == torch.bfloat16
    sd = collections.OrderedDict([("z", torch.zeros(2)), ("a", torch.zeros(2))])
    back = restore_tree({"m": sd, "p": Pair(torch.zeros(2), 0)},
                        {"m/z": torch.ones(2), "m/a": torch.full((2,), 2.0),
                         "p/.mu": torch.ones(2), "p/.nu": torch.tensor(4)})
    assert type(back["m"]) is collections.OrderedDict and list(back["m"]) == ["z", "a"]
    assert float(back["m"]["a"][0]) == 2.0
    assert isinstance(back["p"], Pair) and int(back["p"].nu) == 4


def test_lossless_round_trip_of_a_module_and_its_optimizer(tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(64, 32), torch.nn.Linear(32, 8))
    opt = torch.optim.Adam(net.parameters())
    net(torch.randn(4, 64)).sum().backward()
    opt.step()
    state = {"model": net.state_dict(), "opt": opt.state_dict(), "step": 1}
    m = save_checkpoint(str(tmp_path), state, 1, device="cpu")
    flat, _ = load_checkpoint(str(tmp_path), device="cpu")
    back = restore_tree(state, flat)
    for (k, v), (k2, w) in zip(tck._flatten(state), tck._flatten(back)):
        assert k == k2
        if isinstance(v, torch.Tensor):  # a scalar's leaf comes back as a tensor
            assert v.dtype == w.dtype and torch.equal(v, w), k
        else:
            assert np.asarray(v) == w.numpy(), k
    assert m["cr"] == m["raw_bytes"] / m["compressed_bytes"]


def test_references_small_state_round_trips_losslessly(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(64, 32, generator=g), "b": torch.zeros(32)},
             "m": {"w": torch.ones(64, 32) * 0.1, "b": torch.zeros(32)},
             "v": {"w": torch.ones(64, 32) * 0.2, "b": torch.zeros(32)},
             "step": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), state, 7, device="cpu")
    flat, manifest = load_checkpoint(str(tmp_path), device="cpu")
    assert manifest["step"] == 7
    back = restore_tree(state, flat)
    for (_, a), (_, b) in zip(tck._flatten(state), tck._flatten(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert manifest["cr"] > 0.9  # random data ~1x; structured params compress


# -- atomicity, retention, corruption ----------------------------------------

def test_corruption_raises_ioerror(tmp_path):
    save_checkpoint(str(tmp_path), _port_state(_arrays()), 1, device="cpu")
    qfile = os.path.join(tmp_path, "step_00000001", "params.czq")
    with open(qfile, "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="CRC mismatch in params"):
        load_checkpoint(str(tmp_path), 1, device="cpu")


def test_retention_keeps_the_last_keep(tmp_path):
    ck = Checkpointer(str(tmp_path), every=2, keep=2, device="cpu")
    st = {"w": torch.ones(10), "step": 0}
    saved = [s for s in range(1, 9) if ck.maybe_save(st, s) is not None]
    assert saved == [2, 4, 6, 8]
    assert ck.maybe_save(st, 9, force=True)["step"] == 9
    assert sorted(os.listdir(tmp_path)) == ["step_00000008", "step_00000009"]
    assert latest_step(str(tmp_path)) == 9


def test_a_tmp_directory_is_never_latest(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    save_checkpoint(str(tmp_path), {"w": torch.ones(3)}, 4, device="cpu")
    stale = tmp_path / "step_00000009.tmp"
    stale.mkdir()
    (stale / "manifest.json").write_text("{}")
    (tmp_path / "step_00000007").mkdir()  # no manifest: never committed
    assert latest_step(str(tmp_path)) == 4
    flat, m = load_checkpoint(str(tmp_path), device="cpu")
    assert m["step"] == 4 and torch.equal(flat["w"], torch.ones(3))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), device="cpu")


def test_checkpointer_resume(tmp_path):
    ck = Checkpointer(str(tmp_path), every=5, keep=2, device="cpu")
    assert ck.resume({"U": torch.zeros(2)}) == (None, None)
    U = torch.linspace(0, 1, 5 * 4096).reshape(5, 16, 16, 16)
    ck.maybe_save({"U": U, "step": 5}, 5)
    state, step = ck.resume({"U": torch.zeros(1), "step": 0})
    assert step == 5 and int(state["step"]) == 5
    assert torch.equal(state["U"].view(torch.int32), U.view(torch.int32))


def test_references_checkpointer_restores_on_the_port(tmp_path):
    ck = rck.Checkpointer(str(tmp_path), every=1, keep=3)
    a = _arrays(2)
    for s in (1, 2):
        ck.maybe_save(_ref_state(a), s)
    state, step = Checkpointer(str(tmp_path), device="cpu").resume(_port_state(_arrays(9)))
    assert step == 2
    _check_loaded(dict(tck._flatten(state)), a, None)


# -- field snapshots ---------------------------------------------------------

N, BS = 32, 16


def _field(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:N, 0:N, 0:N].astype(np.float32) / N
    return (40 * np.sin(4 * g[0] + 2 * g[1]) * np.exp(-g[2])
            + rng.standard_normal((N, N, N))).astype(np.float32)


FIELDS = {"p": _field(1), "rho": _field(2)}


def _stepped(k, as_tensor=False):
    out = {q: f + np.float32(k) for q, f in FIELDS.items()}
    return {q: torch.from_numpy(f) for q, f in out.items()} if as_tensor else out


def test_field_snapshotter_round_trip(tmp_path):
    d = str(tmp_path / "snaps")
    snap = FieldSnapshotter(d, every=5, spec=CompressionSpec(scheme="fpzipx", block_size=BS),
                            device="cpu")
    taken = [snap.maybe_snapshot(_stepped(step, as_tensor=True), step) for step in range(11)]
    assert taken == [0, None, None, None, None, 1, None, None, None, None, 2]
    snap.close()

    snap2 = FieldSnapshotter(d, every=5, device="cpu")
    fields, step = snap2.restore()
    assert step == 10
    for q in FIELDS:  # fpzipx at precision=32 is lossless -> bit-exact
        np.testing.assert_array_equal(fields[q], FIELDS[q] + np.float32(10))
    fields, step = snap2.restore(5)
    assert step == 5 and np.array_equal(fields["p"], FIELDS["p"] + np.float32(5))
    snap2.close()
    empty = FieldSnapshotter(str(tmp_path / "empty"), device="cpu")
    assert empty.restore() == (None, None)
    empty.close()


@pytest.mark.parametrize("writer", ["ref", "port", "port_tensor"])
def test_snapshots_restore_in_the_other_package(tmp_path, writer):
    d = str(tmp_path / "snaps")
    spec_cls, make = ((RSpec, lambda **k: RSnapshotter(d, **k)) if writer == "ref" else
                      (CompressionSpec, lambda **k: FieldSnapshotter(d, device="cpu", **k)))
    snap = make(every=2, spec=spec_cls(scheme="fpzipx", block_size=BS), workers=2)
    for step in range(5):
        snap.maybe_snapshot(_stepped(step, as_tensor=writer == "port_tensor"), step)
    snap.close()
    other = (FieldSnapshotter(d, device="cpu") if writer == "ref" else RSnapshotter(d))
    fields, step = other.restore()
    assert step == 4
    for q in FIELDS:
        assert np.array_equal(fields[q], FIELDS[q] + np.float32(4))
    other.close()


def test_float64_field_under_fpzipx_warns(tmp_path):
    snap = FieldSnapshotter(str(tmp_path / "s"), device="cpu")
    with pytest.warns(DtypeCoercionWarning, match="fpzipx"):
        snap.maybe_snapshot({"p": FIELDS["p"].astype(np.float64)}, 0)
    fields, _ = snap.restore()
    assert fields["p"].dtype == np.float32
    assert np.array_equal(fields["p"], FIELDS["p"])
    snap.close()


# (field dtype, spec) -> whether the snapshot warns
TWIN_CASES = {"float32-wavelet": ("float32", CompressionSpec(eps=EPS, block_size=BS), False),
              "float64-fpzipx": ("float64", CompressionSpec(scheme="fpzipx", block_size=BS),
                                 True)}


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_tensor_fields_write_their_numpy_twins_snapshots(tmp_path, case):
    """Tensor fields go to stage 1 as they are, with no host copy; the
    members and manifest they write are their numpy twins' byte for byte,
    a coercion warns as the twin's does, and the tensors are not written."""
    dtype, spec, warns = TWIN_CASES[case]
    msgs = {}
    for kind in ("numpy", "tensor"):
        snap = FieldSnapshotter(str(tmp_path / kind), every=2, spec=spec, workers=2,
                                device="cpu")
        for step in (2, 4):
            fields = {q: f.astype(dtype) for q, f in _stepped(step).items()}
            if kind == "tensor":
                fields = {q: torch.from_numpy(f) for q, f in fields.items()}
                kept = {q: f.clone() for q, f in fields.items()}
            if warns:
                with pytest.warns(DtypeCoercionWarning) as rec:
                    snap.maybe_snapshot(fields, step)
                msgs.setdefault(kind, []).extend(str(w.message) for w in rec)
            else:
                with warnings.catch_warnings():
                    warnings.simplefilter("error")
                    snap.maybe_snapshot(fields, step)
            if kind == "tensor":
                assert all(torch.equal(fields[q], kept[q]) for q in fields)
        snap.close()
    if warns:
        assert msgs["tensor"] == msgs["numpy"] and len(msgs["numpy"]) == 4
        assert "fpzipx" in msgs["numpy"][0]
    assert tree(tmp_path / "tensor") == tree(tmp_path / "numpy")
    assert "manifest.json" in tree(tmp_path / "tensor")


@pytest.mark.parametrize("scheme", ["wavelet", "fpzipx"])
def test_cpu_snapshot_of_cpu_tensors_counts_no_copy(tmp_path, scheme):
    """On the CPU nothing crosses between host and card: a snapshot of CPU
    tensors adds no ``cz_copy_bytes_total`` series and no byte to one."""
    copies = obs.REGISTRY.get("cz_copy_bytes_total")
    before = copies.samples()
    snap = FieldSnapshotter(str(tmp_path / "s"), every=1, workers=2, device="cpu",
                            spec=CompressionSpec(scheme=scheme, eps=EPS, block_size=BS))
    assert snap.maybe_snapshot(_stepped(1, as_tensor=True), 1) == 0
    snap.close()
    assert copies.samples() == before


# -- names and devices -------------------------------------------------------

def test_names_match_the_reference():
    assert sorted(n for n in dir(tckpt) if not n.startswith("_") and n != "checkpoint") == \
        sorted(["Checkpointer", "FieldSnapshotter", "latest_step", "load_checkpoint",
                "restore_tree", "save_checkpoint"])
    assert tck._BS == rck._BS == 16


def test_cuda_without_a_gpu_raises(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path / "c"), {"w": torch.ones(2)}, 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        save_checkpoint(str(tmp_path / "d"), {"w": torch.ones(2)}, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        load_checkpoint(str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="cuda"):
        FieldSnapshotter(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="cuda"):
        Checkpointer(str(tmp_path / "k"))


# -- the snapshot path's trace -------------------------------------------------

def _snapshot_fields():
    g = torch.Generator().manual_seed(7)
    return {q: torch.randn((64, 64, 64), generator=g) * 10 for q in ("p", "rho")}


def _span_tree(events) -> list:
    """The spans as nested ``(name, children)``, children sorted, from their
    ``id`` and ``parent`` args; a kernel wrapper's phase reads ``kernel.*``."""
    kids: dict = {}
    for e in events:
        if e["ph"] == "X":
            kids.setdefault(e["args"]["parent"], []).append(e)

    def tree(parent):
        return sorted((("kernel.*" if e["name"].startswith("kernel.") else e["name"],
                        tree(e["args"]["id"])) for e in kids.get(parent, [])), key=str)
    return tree(None)


def test_traced_snapshot_yields_the_span_tree(tmp_path):
    from repro_torch.obs import trace

    spec = CompressionSpec(buffer_bytes=1 << 18)     # 2 blocks of 32^3 a chunk
    snap = FieldSnapshotter(str(tmp_path / "s"), spec=spec, workers=2, device="cpu")
    trace.reset()
    trace.enable()
    try:
        assert snap.maybe_snapshot(_snapshot_fields(), 3) == 0
        events = trace.TRACER.events()
    finally:
        trace.disable()
        trace.reset()
        snap.close()
    write = ("dataset.write", [
        ("pipeline.to_device", []),
        # the forward transform's kernel span, then the selection's
        ("stage1", [("stage1.to_host", []),
                    ("stage1.transform", [("kernel.*", [])] * 2)]),
        ("stage2", [("encode", [])] * 4),
    ])
    # the fields go to stage 1 as they are: no host copy under the snapshot
    assert _span_tree(events) == [("snapshot", sorted(
        [("dataset.commit", [])] + [write] * 2, key=str))]
    (top,) = [e for e in events if e["name"] == "snapshot"]
    assert top["args"]["step"] == 3
    assert {e["args"]["quantity"] for e in events if e["name"] == "dataset.write"} == \
        {"p", "rho"}


def test_untraced_snapshot_records_nothing_and_touches_no_cuda_event(tmp_path, monkeypatch):
    from repro_torch.obs import trace

    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))

    def no_sync(*a, **k):
        raise AssertionError("an untraced snapshot synchronized")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    copies = obs.REGISTRY.get("cz_copy_bytes_total")
    before = copies.samples()
    trace.reset()
    snap = FieldSnapshotter(str(tmp_path / "s"), spec=CompressionSpec(), workers=2,
                            device="cpu")
    assert snap.maybe_snapshot(_snapshot_fields(), 0) == 0
    snap.close()
    assert trace.TRACER.events() == [] and made == []
    assert copies.samples() == before               # nothing crossed to a card
