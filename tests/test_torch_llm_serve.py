"""The port's LLM serve path (``repro_torch.serve.step``,
``repro_torch.launch.serve``) against the JAX package's, on the CPU.

Weights are the reference's, carried across by ``models.convert`` (each
package draws its random weights from its own generator).  Tolerance as in
tests/test_torch_models.py: float32, rtol = 1e-4 and atol = 1e-5 times the
output's largest |value|.
"""
import io
import contextlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as rconfigs
import repro.models as R
from repro.ckpt import save_checkpoint as ref_save_checkpoint
from repro.launch import serve as rserve
from repro.launch.mesh import make_mesh
from repro.serve import step as rstep

import repro_torch.configs as tconfigs
import repro_torch.models as T
from repro_torch.ckpt import load_checkpoint, restore_tree
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_mesh as tmake_mesh
from repro_torch.models.convert import from_reference
from repro_torch.serve import step as tstep

from _torch_mesh import end_the_world_it_started  # noqa: F401  (autouse)

torch.set_num_threads(1)

RTOL, ATOL_SCALE = 1e-4, 1e-5
RST = R.ModelSettings(q_chunk=16, kv_chunk=16, remat="none", compute_dtype=jnp.float32)
TST = T.ModelSettings(q_chunk=16, kv_chunk=16, remat="none", compute_dtype=torch.float32)
ARGS = ["--reduced", "--batch", "2", "--prompt-len", "6", "--max-new", "10", "--seed", "3"]


def close(got, want, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL_SCALE * scale, err_msg=what)


def pair(name):
    return rconfigs.reduced(rconfigs.ARCHS[name]), tconfigs.reduced(tconfigs.ARCHS[name])


def converted(tree):
    return from_reference(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("name", ["smollm-135m", "rwkv6-7b", "jamba-v0.1-52b",
                                  "whisper-small"])
def test_step_builders_match_the_references(name):
    rcfg, tcfg = pair(name)
    mesh = make_mesh((1, 1), ("data", "model"))
    rp = R.init_params(rcfg, jax.random.PRNGKey(0))
    tp = converted(rp)
    rng = np.random.default_rng(0)
    B, S = 2, 8
    toks = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    frames = None
    if rcfg.family == "encdec":
        frames = rng.standard_normal((B, rcfg.enc_frames, rcfg.d_model)).astype(np.float32)

    tmesh = tmake_mesh((1, 1), ("data", "model"), device="cpu")
    rfn, _ = rstep.build_prefill_step(rcfg, mesh, settings=RST)
    tfn, tjit = tstep.build_prefill_step(tcfg, tmesh, settings=TST)
    want = jax.jit(rfn)(rp, jnp.asarray(toks), None if frames is None else jnp.asarray(frames))
    targs = [torch.from_numpy(toks)] + ([] if frames is None else [torch.from_numpy(frames)])
    close(tfn(tp, *targs), want, "prefill")
    # jit_for's step: the 1x1 mesh's blocks are the whole tensors
    tstep_fn, nargs = tjit(tp, dict(zip(("tokens", "frames"), targs)))
    assert nargs == 1 + len(targs)
    close(tstep_fn(tp, *targs), want, "prefill through jit_for")

    rdec, _ = rstep.build_decode_step(rcfg, mesh, settings=RST)
    rcache = R.cache_spec(rcfg, B, S, dtype=jnp.float32, mode="zeros")
    tcache = converted(rcache)
    keep, _ = tstep.build_decode_step(tcfg, tmesh, settings=TST, donate_cache=False)
    _, donate_for = tstep.build_decode_step(tcfg, tmesh, settings=TST)
    donate = donate_for(tp, tcache, torch.from_numpy(toks[:, :1]))
    rdec = jax.jit(rdec)
    for i in range(3):
        tok = toks[:, i:i + 1]
        want, rcache = rdec(rp, rcache, jnp.asarray(tok), jnp.int32(i))
        before = {k: v.clone() for k, v in tcache.items()}
        got, kept = keep(tp, tcache, torch.from_numpy(tok), i)
        close(got, want, f"step {i}, donate_cache=False")
        for k in tcache:   # the input cache is untouched
            assert torch.equal(tcache[k], before[k]) and kept[k] is not tcache[k]
            close(kept[k], rcache[k], f"step {i} cache {k}")
        got, new = donate(tp, tcache, torch.from_numpy(tok), i)
        close(got, want, f"step {i}, donate_cache=True")
        for k in tcache:   # updated in place
            assert new[k] is tcache[k]
            close(tcache[k], rcache[k], f"step {i} donated cache {k}")


def _ref_main(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        toks = rserve.main(argv)
    return toks, out.getvalue().splitlines()


def test_generate_gives_the_references_greedy_tokens():
    rcfg, tcfg = pair("smollm-135m")
    want, _ = _ref_main(ARGS)
    rp = R.init_params(rcfg, jax.random.PRNGKey(3))   # what the reference's main draws
    tp = converted(rp)
    B, P, new = 2, 6, 10
    prompt = np.random.default_rng(3).integers(0, rcfg.vocab, (B, P)).astype(np.int32)
    gen = tserve.generate(tp, tcfg, torch.from_numpy(prompt), new)
    np.testing.assert_array_equal(gen.tokens.numpy(), want)
    assert gen.tokens.dtype == torch.int32 and gen.seconds > 0
    assert gen.cache["k"].shape[2] == P + new

    # teacher-forced along the reference's tokens: the logits of every step
    seq = np.concatenate([prompt, want], axis=1)
    rstep_fn = jax.jit(lambda p, c, tok, pos: R.decode_step(p, c, tok, pos, rcfg, RST))
    rcache = R.cache_spec(rcfg, B, P + new, dtype=jnp.float32, mode="zeros")
    tcache = T.cache_spec(tcfg, B, P + new, dtype=torch.float32, mode="zeros", device="cpu")
    for i in range(P + new):
        tok = seq[:, i:i + 1]
        wl, rcache = rstep_fn(rp, rcache, jnp.asarray(tok), jnp.int32(i))
        gl, tcache = T.decode_step(tp, tcache, torch.from_numpy(tok), i, tcfg, tserve.SETTINGS)
        close(gl, wl, f"step {i}")
        if i >= P - 1:   # the greedy token is the first maximum of both
            assert int(gl[0, -1].argmax()) == int(np.argmax(np.asarray(wl)[0, -1]))
    close(gen.logits, wl, "the last step's logits")


def test_main_prints_the_references_lines(monkeypatch):
    rcfg, _ = pair("smollm-135m")
    want_toks, want_lines = _ref_main(ARGS)
    rp = R.init_params(rcfg, jax.random.PRNGKey(3))
    monkeypatch.setattr(tserve, "init_params", lambda cfg, gen, device: converted(rp))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        toks = tserve.main(ARGS + ["--device", "cpu"])
    lines = out.getvalue().splitlines()
    np.testing.assert_array_equal(toks, want_toks)
    assert isinstance(toks, np.ndarray) and toks.shape == (2, 10)
    assert len(lines) == len(want_lines) == 2
    assert lines[1] == want_lines[1]   # "sample: [...]"
    pattern = r"decoded \(2, 10\) in \d+\.\d\ds \(\d+\.\d tok/s incl\. prefill\)"
    assert re.fullmatch(pattern, lines[0]) and re.fullmatch(pattern, want_lines[0])


def test_main_with_its_own_weights():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        toks = tserve.main(["--device", "cpu", "--reduced", "--arch", "rwkv6-7b",
                            "--batch", "1", "--prompt-len", "3", "--max-new", "4"])
    assert toks.shape == (1, 4) and toks.dtype == np.int32
    assert out.getvalue().splitlines()[1] == f"sample: {toks[0].tolist()}"


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        tmake_mesh((1, 1), ("data", "model"), device="cuda")   # a builder's mesh


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    rcfg, tcfg = pair("qwen3-32b")
    rp = R.init_params(rcfg, jax.random.PRNGKey(4))
    ref_save_checkpoint(str(tmp_path), {"params": rp}, step=7)
    flat, manifest = load_checkpoint(str(tmp_path), device="cpu")
    assert manifest["step"] == 7
    template = {"params": T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")}
    tp = restore_tree(template, flat)["params"]
    toks = np.random.default_rng(4).integers(0, rcfg.vocab, (2, 8)).astype(np.int32)
    want = jax.jit(lambda p, tok: R.prefill(p, tok, rcfg, RST))(rp, jnp.asarray(toks))
    close(T.prefill(tp, torch.from_numpy(toks), tcfg, TST), want, "prefill")
    # fpzipx is lossless: the restored weights are the reference's bits
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(rp["embed"]))
