"""The port's tuner (``repro_torch.tune``) against the JAX package's
(``repro.tune``), on the CPU.

The tuner's decisions rest on sample byte counts and on error statistics
of decoded bits, so the port is held to the reference exactly: the same
targets and bounds, the same candidate specs, and on seeded chunks the
same trial scores (bytes, max error, admissibility) and the same ranking.
Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from repro.core import CompressionSpec as RSpec
from repro.core import SCHEMES as RSCHEMES
from repro.tune import bound as rbound
from repro.tune import policy as rpolicy
from repro.tune import trial as rtrial

from repro_torch import obs
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.core.schemes import scheme_names
from repro_torch.tune import bound, policy, trial

torch.set_num_threads(1)

TARGETS = ["abs=1e-3", "rel=1e-4", "psnr=80", "abs=2.5", "rel=0.5", "psnr=30"]


def _chunk(kind: str, b: int = 8, n: int = 8, seed: int = 0) -> np.ndarray:
    """Seeded chunks in the regimes where different schemes win."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    if kind == "smooth":
        x = 2.0 + np.sin(5 * g[0]) * np.cos(4 * g[1]) + g[2]
        x = np.broadcast_to(x, (b, n, n, n)) * (1 + np.arange(b)[:, None, None, None] / b)
    elif kind == "noise":
        x = rng.uniform(-1, 1, (b, n, n, n))
    elif kind == "constant":
        x = np.full((b, n, n, n), 0.5)
    elif kind == "huge":  # szx's and lorenzo's guard refuses abs=1e-3 here
        x = rng.uniform(-1, 1, (b, n, n, n)) * 1e6
    elif kind == "mixed":
        x = 40.0 + 8 * np.sin(6 * g[0]) + rng.normal(0, 1e-3, (b, n, n, n))
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(x, np.float32)


@pytest.mark.parametrize("text", TARGETS + ["abs = 1e-3", "psnr=1e3"])
def test_target_parse_and_abs_bound_equal_reference(text):
    t, r = bound.Target.parse(text), rbound.Target.parse(text)
    assert (t.mode, t.value, str(t)) == (r.mode, r.value, str(r))
    for vmin, vmax in ((0.0, 1.0), (-3.5, 7.25), (2.0, 2.0), (-1e30, 1e30)):
        assert t.abs_bound(vmin, vmax) == r.abs_bound(vmin, vmax)


@pytest.mark.parametrize("text", ["", "abs", "abs=x", "foo=1", "rel=0", "psnr=-3",
                                  "abs=inf", "abs=nan"])
def test_bad_targets_raise_as_in_reference(text):
    with pytest.raises(ValueError) as rexc:
        rbound.Target.parse(text)
    with pytest.raises(ValueError) as texc:
        bound.Target.parse(text)
    assert str(texc.value) == str(rexc.value)


def test_registry_names_equal_reference():
    assert scheme_names() == sorted(RSCHEMES)


@pytest.mark.parametrize("text", TARGETS)
@pytest.mark.parametrize("name", sorted(RSCHEMES))
def test_candidate_spec_equals_reference(name, text):
    extra = {"target": text}
    for kw in (dict(), dict(block_size=8, precision=16), dict(wavelet="w4i", levels=2,
                                                           block_size=16)):
        tspec = CompressionSpec(scheme="auto", extra=extra, **kw)
        rspec = RSpec(scheme="auto", extra=extra, **kw)
        t = bound.target_from_spec(tspec)
        assert str(t) == str(rbound.target_from_spec(rspec))
        for ab in (t.abs_bound(-2.0, 5.0), 0.0, 1e-9):
            got = bound.candidate_spec(name, tspec, ab)
            want = rbound.candidate_spec(name, rspec, ab)
            assert (got is None) == (want is None), (name, text, kw, ab)
            if got is not None:
                assert got.to_json() == want.to_json()


def test_target_defaults_to_eps():
    assert str(bound.target_from_spec(CompressionSpec(eps=3e-4))) == "abs=0.0003"


@pytest.mark.parametrize("nblk", [1, 3, 4, 5, 8, 32, 33])
def test_sample_blocks_equal_reference(nblk):
    x = np.arange(nblk)
    np.testing.assert_array_equal(trial.sample_blocks(torch.from_numpy(x)).numpy(),
                                  rtrial.sample_blocks(x))
    np.testing.assert_array_equal(trial.sample_blocks(x), rtrial.sample_blocks(x))


def _scores(d):
    return [(t.scheme, t.eps, t.nbytes, t.max_err, t.psnr, t.admissible, t.error is None)
            for t in d.trials]


@pytest.mark.parametrize("kind", ["smooth", "noise", "constant", "huge", "mixed"])
@pytest.mark.parametrize("text", ["abs=1e-3", "rel=1e-4", "psnr=80"])
def test_run_trials_equal_reference(kind, text):
    x = _chunk(kind, seed=len(kind))
    tspec = CompressionSpec(scheme="auto", block_size=8, extra={"target": text})
    rspec = RSpec(scheme="auto", block_size=8, extra={"target": text})
    got = trial.run_trials(torch.from_numpy(x), tspec, bound.Target.parse(text), x)
    want = rtrial.run_trials(x, rspec, rbound.Target.parse(text))
    assert (got.target, got.abs_bound) == (want.target, want.abs_bound)
    assert [c.to_json() for c in got.ranked] == [c.to_json() for c in want.ranked]
    assert _scores(got) == _scores(want)
    if kind == "huge" and text == "abs=1e-3":  # the guard, not an error, refuses szx
        refused = {t.scheme for t in got.trials if t.error is not None}
        assert refused == {"lorenzo", "szx"}


@pytest.mark.parametrize("kind", ["smooth", "noise", "constant", "huge", "mixed"])
def test_chunk_signature_equals_reference(kind):
    x = _chunk(kind, seed=7)
    assert policy.chunk_signature(x) == rpolicy.chunk_signature(x)
    assert policy.chunk_signature(x, grid=0.25) == rpolicy.chunk_signature(x, grid=0.25)


def test_tune_cache_retrial_cadence_equals_reference():
    """With ``tune_cache=3``: the same chunks are trialled, and the others
    served from the cache, in the same order as the reference."""
    from repro import obs as robs

    chunks = [_chunk(k, seed=1) for k in
              ("smooth", "smooth", "noise", "smooth", "smooth", "noise", "noise", "smooth")]

    def run(pol_mod, spec_cls, target_cls, registry, tensor):
        trials = registry.get("cz_tune_trials_total")
        hits = registry.get("cz_tune_cache_hits_total")
        pol = pol_mod.DecisionPolicy(retrial_every=3)
        h0, out = hits.value(), []
        for c in chunks:
            t0 = trials.value(scheme="raw")
            args = (torch.from_numpy(c), spec_cls(scheme="auto", block_size=8),
                    target_cls.parse("abs=1e-3"), c)
            d = pol.decide(*args) if tensor else pol.decide(c, *args[1:3])
            out.append((d.winner.scheme, d.winner.eps, trials.value(scheme="raw") - t0))
        return out, hits.value() - h0

    got = run(policy, CompressionSpec, bound.Target, obs.REGISTRY, True)
    want = run(rpolicy, RSpec, rbound.Target, robs.REGISTRY, False)
    assert got == want
    # a signature's 1st and 4th occurrences are trialled
    assert [t for _s, _e, t in got[0]] == [1, 0, 1, 0, 1, 0, 0, 0] and got[1] == 5
    assert policy.policy_for(CompressionSpec(scheme="auto", extra={"tune_cache": 2})) \
        is policy.policy_for(CompressionSpec(scheme="auto", extra={"tune_cache": 2}))


def test_trials_score_guard_refusals_as_inadmissible_only():
    """szx's guard refuses a sample: an inadmissible trial with the guard's
    message, as the reference scores it; the ranking ends in a lossless
    scheme."""
    x = _chunk("huge")
    spec = CompressionSpec(scheme="auto", block_size=8)
    d = trial.run_trials(torch.from_numpy(x), spec, bound.Target.parse("abs=1e-3"), x)
    szx = next(t for t in d.trials if t.scheme == "szx")
    assert not szx.admissible and "too small for data" in szx.error
    assert d.ranked[-1].scheme in ("raw", "fpzipx")
