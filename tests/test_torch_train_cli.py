"""The port's training driver (``python -m repro_torch.launch.train``) on
the CPU: kill and resume, resumed losses bit-equal to an uninterrupted
run's, the reference driver's lines, no quiet CPU run when the card is
asked for; and train-state checkpoints read across the two packages."""
import contextlib
import io
import json
import os
import pathlib
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import repro.ckpt as rckpt
import repro.configs as rconfigs
from repro.launch import train as rtrain
from repro.train import step as rstep

import repro_torch.ckpt as tckpt
import repro_torch.configs as tconfigs
from repro_torch.launch import train as ttrain
from repro_torch.models.common import tree_leaves
from repro_torch.train import step as tstep

from _torch_mesh import end_the_world_it_started  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--arch", "smollm-135m", "--reduced", "--steps", "12", "--batch", "2", "--seq", "32",
        "--ckpt-every", "5", "--log-every", "4"]


def _run_train(args, tmp):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"] + args
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp, timeout=300)


def test_train_kill_resume_end_to_end(tmp_path):
    """The port's copy of tests/test_ckpt_fault.py's test of the same name,
    and beyond it: the resumed run's losses equal an uninterrupted run's,
    bit for bit (fpzipx at precision 32 is lossless)."""
    ck = str(tmp_path / "ck")
    r1 = _run_train(BASE + ["--ckpt-dir", ck, "--fail-at-step", "6"], tmp_path)
    assert r1.returncode == 17, r1.stderr[-2000:]
    assert "[fault-injection] hard exit at step 6" in r1.stdout
    assert tckpt.latest_step(ck) == 5
    out = str(tmp_path / "m.json")
    r2 = _run_train(BASE + ["--ckpt-dir", ck, "--metrics-out", out], tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "[resume] from step 5" in r2.stdout
    with open(out) as f:
        m = json.load(f)
    assert m["steps"] == 7  # steps 5..11
    full = str(tmp_path / "full.json")
    r3 = _run_train(BASE + ["--ckpt-dir", str(tmp_path / "ck_full"), "--metrics-out", full],
                    tmp_path)
    assert r3.returncode == 0, r3.stderr[-2000:]
    with open(full) as f:
        uninterrupted = json.load(f)
    assert uninterrupted["steps"] == 12
    assert m["losses"] == uninterrupted["losses"][5:]


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--reduced", "--steps", "1"])      # the card is the default
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--device", "cuda", "--reduced", "--steps", "1"])


def test_train_profile_runs_on_the_cpu(tmp_path, capsys):
    """``repro_torch.launch.train_profile`` times each batch size and
    profiles one step; on the CPU it sees no kernels, and it asks for the
    card by default."""
    from repro_torch.launch import train_profile

    out = train_profile.main(["--device", "cpu", "--reduced", "--seq", "32",
                              "--batches", "1,2", "--steps", "1", "--out", str(tmp_path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    assert {b: len(ms) for b, ms in out["ms_per_step"].items()} == {1: 2, 2: 2}
    prof = out["profile"]
    assert prof["batch"] == 2 and prof["kernels"] == prof["launch_calls"] == 0
    assert prof["device_s"] == prof["busy_share"] == 0.0
    assert "aten::" in (tmp_path / "train_profile.txt").read_text()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            train_profile.main(["--reduced", "--seq", "32"])


@contextlib.contextmanager
def _signals_kept():
    """Both drivers install SIGTERM/SIGINT handlers; put the old ones back."""
    kept = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for s, h in kept.items():
            signal.signal(s, h)


# a number, or a time in seconds: masked where the lines are compared
_NUM = re.compile(r"\d+\.\d+|\d+")


def test_lines_are_the_reference_drivers(tmp_path):
    """The same arguments give the same lines, numbers masked (the weights
    come from different generators); step numbers, the resume line and the
    checkpoint steps equal.  Straggler lines depend on the host's timing and
    are left out."""
    args = ["--arch", "olmoe-1b-7b", "--reduced", "--steps", "6", "--batch", "2", "--seq",
            "16", "--ckpt-every", "3", "--log-every", "2"]
    lines = {}
    for name, main, extra in (("reference", rtrain.main, []),
                              ("port", ttrain.main, ["--device", "cpu"])):
        out = io.StringIO()
        with _signals_kept(), contextlib.redirect_stdout(out):
            first, last = main(args + extra + ["--ckpt-dir", str(tmp_path / name)])
        assert np.isfinite(first) and np.isfinite(last)
        lines[name] = [ln for ln in out.getvalue().splitlines()
                       if not ln.startswith("[straggler]")]
    assert [_NUM.sub("#", ln) for ln in lines["port"]] == \
        [_NUM.sub("#", ln) for ln in lines["reference"]]
    steps = [ln.split()[:2] for ln in lines["port"] if ln.startswith(("step", "[ckpt]"))]
    assert steps == [ln.split()[:2] for ln in lines["reference"]
                     if ln.startswith(("step", "[ckpt]"))]


def _assert_flat_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k].cpu() if isinstance(got[k], torch.Tensor) else got[k])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8), w.reshape(-1).view(np.uint8),
                                      err_msg=k)


def test_port_train_checkpoint_loads_in_the_reference(tmp_path):
    cfg = tconfigs.reduced(tconfigs.ARCHS["jamba-v0.1-52b"])
    state = tstep.init_train_state(cfg, torch.Generator().manual_seed(4), device="cpu")
    state["step"].fill_(9)
    g = torch.Generator().manual_seed(5)
    for k in ("m", "v"):     # the moments as a few steps leave them
        for _, a in tree_leaves(state[k]):
            a.copy_(torch.randn(a.shape, generator=g) ** (1 if k == "m" else 2) * 1e-3)
    tckpt.Checkpointer(str(tmp_path), every=1, device="cpu").maybe_save(state, 9)
    flat, manifest = rckpt.load_checkpoint(str(tmp_path))
    assert manifest["step"] == 9 and manifest["spec"]["scheme"] == "fpzipx"
    want = {"/".join(p): a.numpy() for p, a in tree_leaves(state)}
    _assert_flat_equal(flat, want)


def test_reference_train_checkpoint_loads_in_the_port(tmp_path):
    rcfg = rconfigs.reduced(rconfigs.ARCHS["whisper-small"])
    state = jax.jit(rstep.init_train_state, static_argnums=0)(rcfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(6)
    for k in ("m", "v"):     # the moments as a few steps leave them
        state[k] = jax.tree.map(lambda a: (rng.standard_normal(a.shape) ** (1 if k == "m" else 2)
                                           * 1e-3).astype(np.float32), state[k])
    rckpt.Checkpointer(str(tmp_path), every=1).maybe_save(state, 3)
    flat, manifest = tckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert manifest["step"] == 3
    want = {"/".join(p): np.asarray(a) for p, a in tree_leaves(jax.tree.map(np.asarray, state))}
    _assert_flat_equal(flat, want)
    # and the port's resume rebuilds its own state from it
    template = tstep.init_train_state(tconfigs.reduced(tconfigs.ARCHS["whisper-small"]),
                                      torch.Generator().manual_seed(0), device="cpu")
    restored, step = tckpt.Checkpointer(str(tmp_path), device="cpu").resume(template)
    assert step == 3 and restored["step"].dtype == torch.int32
    _assert_flat_equal({"/".join(p): a for p, a in tree_leaves(restored)}, want)
