"""Decision layer: trial-per-chunk by default, signature cache on request
(port of ``repro.tune.policy``).

Default (``tune_cache`` unset or 0): **every chunk is trialled**.  The
decision is then a pure function of the chunk's bytes, which is what makes
the ``auto`` scheme safe under the cluster engine — any partitioning of
the chunk stream across ranks reproduces the serial writer's choices
byte-for-byte.

Opt-in (``spec.extra["tune_cache"] = K``): decisions are cached under a
cheap chunk-statistics signature (quantized log range / log std /
smoothness — the features that separate compression regimes), and a chunk
whose signature was already decided reuses that decision; every K-th
chunk of a signature is re-trialled anyway (the periodic re-trial budget),
so a drifting stream cannot ride a stale winner forever.  The cache trades
per-chunk optimality and cross-partitioning byte-determinism for trial
cost — steady streams pay trials on ~1/K of their chunks.  Serial encodes
remain deterministic (same chunk order, same hits); rank-parallel encodes
with the cache enabled are *not* guaranteed byte-identical to serial,
which is why it is off by default.

Cache hits count in ``cz_tune_cache_hits_total``; every actual (re-)trial
emits a ``tune.decision`` event recording the winner and why the trial ran.

A chunk comes as a tensor on the trials' device and its host copy; the
signature, like every statistic of the tuner, is taken on the host copy in
numpy float64, as the reference takes it.
"""
from __future__ import annotations

import math
import threading

import numpy as np

import torch

from repro_torch import obs
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.obs import events as _events

from .bound import Target
from .trial import Decision, run_trials

__all__ = ["DecisionPolicy", "chunk_signature", "policy_for"]

_CACHE_HITS = obs.counter(
    "cz_tune_cache_hits_total",
    "Auto-tuning decisions served from the chunk-signature cache.")

#: signature quantization step in log2 space — chunks whose range/std/
#: smoothness agree within ~2^0.5 share a cache line
_GRID = 0.5


def chunk_signature(blocks_np: np.ndarray, grid: float = _GRID) -> tuple:
    """Cheap content signature of a chunk: quantized ``log2`` of value
    range, standard deviation, and mean |first difference| (smoothness).
    One pass over the data, no encode — the features that separate the
    regimes where different schemes win."""
    x = np.asarray(blocks_np, np.float64)

    def q(v: float) -> int:
        return -(10 ** 6) if v <= 0 or not math.isfinite(v) \
            else round(math.log2(v) / grid)

    return (q(float(x.max() - x.min())),
            q(float(x.std())),
            q(float(np.mean(np.abs(np.diff(x, axis=-1))))
              if x.shape[-1] > 1 else 0.0))


class DecisionPolicy:
    """Per-spec decision maker: trials, plus the optional signature cache.

    ``retrial_every`` is the ``tune_cache`` knob: 0 disables caching
    (trial every chunk); K > 0 reuses a signature's cached decision and
    re-trials every K-th occurrence.
    """

    def __init__(self, retrial_every: int = 0):
        self.retrial_every = max(0, int(retrial_every))
        self._cache: dict[tuple, Decision] = {}
        self._uses: dict[tuple, int] = {}
        self._guard = threading.Lock()

    def decide(self, blocks: torch.Tensor, spec: CompressionSpec,
               target: Target, host: np.ndarray) -> Decision:
        """Decide for one chunk: ``blocks`` on the trials' device, ``host``
        the same chunk in host memory."""
        if self.retrial_every <= 0:
            d = run_trials(blocks, spec, target, host)
            _events.event("tune.decision", scheme=d.winner.scheme,
                          eps=d.winner.eps, target=d.target,
                          abs_bound=d.abs_bound, reason="uncached")
            return d
        sig = chunk_signature(host)
        with self._guard:
            uses = self._uses.get(sig, 0)
            self._uses[sig] = uses + 1
            cached = self._cache.get(sig)
            if cached is not None and uses % self.retrial_every != 0:
                _CACHE_HITS.inc()
                return cached
        d = run_trials(blocks, spec, target, host)
        with self._guard:
            self._cache[sig] = d
        _events.event("tune.decision", scheme=d.winner.scheme,
                      eps=d.winner.eps, target=d.target,
                      abs_bound=d.abs_bound,
                      reason="retrial" if cached is not None else "first",
                      signature=list(sig))
        return d


_POLICIES: dict[CompressionSpec, DecisionPolicy] = {}
_POLICIES_GUARD = threading.Lock()


def policy_for(spec: CompressionSpec) -> DecisionPolicy:
    """The process-wide policy for this spec (specs hash by value, so the
    cache persists across pipelines/fields of one steady stream)."""
    retrial = int(spec.extra.get("tune_cache", 0)) if spec.extra else 0
    with _POLICIES_GUARD:
        pol = _POLICIES.get(spec)
        if pol is None or pol.retrial_every != retrial:
            pol = _POLICIES[spec] = DecisionPolicy(retrial)
        return pol
