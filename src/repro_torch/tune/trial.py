"""Chunk sampler + trial runner: score every candidate scheme on a sample
(port of ``repro.tune.trial``).

One decision = encode a deterministic sample of the chunk's blocks under
every admissible candidate spec (stage 1 + byte layout + stage 2 — the
real encode path, so trial sizes are the sizes the winner will actually
produce), decode it back, and rank by achieved ratio under the measured
bound.  Trials run concurrently on a shared daemon pool; the ranking is
pure (sampling, candidate order, and tie-breaks use no randomness and no
wall clock), so the same chunk bytes always produce the same decision.

The chunk comes twice: as a tensor on the device the trials run on, whose
sample the candidates transform (on the card, through their kernels), and
as its host copy, on which every statistic is taken in numpy float64
exactly as the reference takes it (value range, the sample's range, max
error, PSNR, the one-ulp slack).  A decision then depends only on the
decoded bits, and those are the same on the card and on the CPU.

A candidate is inadmissible when its measured error misses the target, or
when its scheme's own guard (:meth:`Scheme.check`, e.g. szx's
eps/magnitude check) refuses the sample before any transform runs.  Any
other error, a refused kernel launch included, propagates: it is never
scored as a losing trial.

The ranked list — not just the winner — is returned: a winner whose guard
refuses the *full* chunk (values the sample missed) falls through to the
runner-up, ending at a lossless scheme which can never fail.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import lossless
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.core.schemes import get_scheme, scheme_names
from repro_torch.obs import trace

from .bound import Target, candidate_spec

__all__ = ["Trial", "Decision", "sample_blocks", "run_trials"]

#: blocks per trial sample — enough to expose per-regime behaviour, small
#: enough that a full candidate sweep costs a fraction of one chunk encode
SAMPLE_BLOCKS = 4

_TRIALS = obs.counter("cz_tune_trials_total",
                      "Auto-tuner candidate trial encodes by scheme.",
                      labelnames=("scheme",))
_DECISION_SECONDS = obs.histogram(
    "cz_tune_decision_seconds",
    "Wall time of one per-chunk auto-tuning decision (all trials).",
    buckets=obs.FAST_BUCKETS)

_POOL = None
_POOL_GUARD = threading.Lock()


def _trial_pool():
    """Shared daemon pool for candidate trials — separate from the
    pipeline's chunk-encode pool (a chunk worker *waits* on its trials;
    sharing one pool would deadlock once saturated with waiting parents)."""
    global _POOL
    with _POOL_GUARD:
        if _POOL is None:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="cz-tune")
        return _POOL


@dataclasses.dataclass(frozen=True)
class Trial:
    """One candidate's measured score on the sample."""

    scheme: str
    eps: float
    nbytes: int          # stage-1+2 encoded size of the sample
    ratio: float         # raw sample bytes / nbytes
    max_err: float       # measured on the decoded sample
    psnr: float          # paper Eq. 1 on the sample (inf when exact)
    seconds: float       # encode+decode wall time
    admissible: bool     # meets the target on the sample
    error: str | None = None   # the scheme's guard refused the sample


@dataclasses.dataclass(frozen=True)
class Decision:
    """Ranked outcome of one chunk's trials (best candidate first)."""

    target: str                              # normalized target string
    abs_bound: float                         # bound the trials enforced
    ranked: tuple[CompressionSpec, ...]      # admissible specs, best first
    trials: tuple[Trial, ...]                # every trial, scored

    @property
    def winner(self) -> CompressionSpec:
        return self.ranked[0]


def sample_blocks(blocks, max_blocks: int = SAMPLE_BLOCKS):
    """A deterministic, content-independent sample of the chunk's blocks (a
    numpy array or a tensor): an even stride over block indices (always
    including block 0), the same blocks however the chunk reached us."""
    n = int(blocks.shape[0])
    if n <= max_blocks:
        return blocks
    stride = -(-n // max_blocks)  # ceil: at most max_blocks samples
    return blocks[::stride]


def _measured_psnr(sample: np.ndarray, dec: np.ndarray,
                   rng: float) -> float:
    m = float(np.mean((np.asarray(sample, np.float64)
                       - np.asarray(dec, np.float64)) ** 2))
    if m == 0.0:
        return float("inf")
    if rng <= 0.0:
        return float("-inf")  # inexact decode of constant data
    return 20.0 * math.log10(rng / (2.0 * math.sqrt(m)))


def _run_one(cand: CompressionSpec, sample: torch.Tensor, sample_np: np.ndarray,
             rng: float, target: Target, abs_bound: float) -> Trial:
    """Encode + decode the sample under one candidate and score it."""
    sch = get_scheme(cand.scheme)
    nblk = int(sample_np.shape[0])
    raw = int(sample_np.size * cand.np_dtype.itemsize)
    t0 = time.perf_counter()
    _TRIALS.inc(scheme=cand.scheme)
    with trace.span("tune.trial", scheme=cand.scheme, eps=cand.eps,
                    nblocks=nblk):
        x = sample.to(getattr(torch, cand.dtype))
        try:
            sch.check(x, cand)
        except ValueError as e:  # e.g. szx eps/magnitude guard on this sample
            return Trial(cand.scheme, cand.eps, 0, 0.0, float("inf"),
                         float("-inf"), time.perf_counter() - t0,
                         admissible=False, error=str(e))
        s1 = sch.stage1(x, cand)
        enc = lossless.encode(sch.serialize(s1, 0, nblk, cand), cand.stage2)
        dec = sch.deserialize(lossless.decode(enc, cand.stage2), nblk, cand,
                              x.device).astype(cand.np_dtype, copy=False)
    max_err = float(np.max(np.abs(np.asarray(sample_np, np.float64)
                                  - np.asarray(dec, np.float64)))) \
        if nblk else 0.0
    psnr = _measured_psnr(sample_np, dec, rng)
    if target.mode == "psnr":
        ok = psnr >= target.value
    else:
        # one ulp of slack at the sample magnitude: decode casts back to
        # the tagged dtype (same quanta the conformance suite allows)
        ulp = float(np.spacing(cand.np_dtype.type(
            max(abs(float(sample_np.max())), abs(float(sample_np.min()))) or 1.0)))
        ok = max_err <= abs_bound * (1 + 1e-6) + ulp
    return Trial(cand.scheme, cand.eps, len(enc),
                 raw / max(1, len(enc)), max_err, psnr,
                 time.perf_counter() - t0, admissible=ok)


def run_trials(blocks: torch.Tensor, spec: CompressionSpec, target: Target,
               host: np.ndarray) -> Decision:
    """Trial every admissible candidate scheme on a sample of this chunk
    and return the ranked :class:`Decision`.

    ``blocks`` is the chunk on the device the trials run on; ``host`` the
    same chunk in host memory, where every statistic is taken.  Candidates are every
    registered scheme except ``spec.scheme`` itself (the meta-scheme must
    not recurse), each at the eps that meets the chunk's absolute bound
    (:func:`~repro_torch.tune.bound.candidate_spec`).  Ranking is by
    measured sample size ascending with the scheme name as the
    deterministic tie-break; at least one lossless candidate (``raw``) is
    always admissible, so the ranking is never empty.
    """
    t0 = time.perf_counter()
    blocks_np = np.asarray(host, spec.np_dtype)
    vmin = float(blocks_np.min())
    vmax = float(blocks_np.max())
    abs_bound = target.abs_bound(vmin, vmax)
    sample_np = sample_blocks(blocks_np)
    sample = sample_blocks(blocks)
    rng = float(np.asarray(sample_np, np.float64).max()
                - np.asarray(sample_np, np.float64).min()) if sample_np.size else 0.0

    cands = [c for c in (candidate_spec(name, spec, abs_bound)
                         for name in scheme_names()
                         if name != spec.scheme) if c is not None]
    futs = [_trial_pool().submit(_run_one, c, sample, sample_np, rng, target,
                                 abs_bound)
            for c in cands]
    trials = [f.result() for f in futs]

    order = sorted(
        (i for i, t in enumerate(trials) if t.admissible),
        key=lambda i: (trials[i].nbytes, trials[i].scheme))
    ranked = tuple(cands[i] for i in order)
    if not ranked:  # unreachable while `raw` is registered; stay safe
        raise ValueError(
            f"no registered scheme can meet target {target} "
            f"(bound {abs_bound:.3e}) on this chunk")
    _DECISION_SECONDS.observe(time.perf_counter() - t0)
    return Decision(target=str(target), abs_bound=abs_bound,
                    ranked=ranked, trials=tuple(trials))
