"""Deterministic synthetic token pipeline (sharded, resumable); a copy of
``repro.data.tokens`` (numpy only), so batches are the reference's bit for bit.

Sequences follow a mixture of order-1 Markov regimes over the vocab, so a
language model can actually *learn* (loss decreases measurably within a few
hundred steps — the end-to-end example's success criterion), while every
batch is a pure function of (seed, step, shard), which makes data iteration
order exactly reproducible across restarts and elastic resharding: shard i
of step t is identical no matter how many hosts are reading.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "batch_at"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 512
    batch: int = 8
    seq: int = 64
    seed: int = 1234
    n_regimes: int = 4
    branching: int = 8      # successors per token (lower = easier)


def _regime_tables(cfg: DataConfig) -> np.ndarray:
    """(n_regimes, vocab, branching) successor tables, deterministic."""
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(0, cfg.vocab, (cfg.n_regimes, cfg.vocab, cfg.branching))


_TABLE_CACHE: dict = {}


def batch_at(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Batch for a global step: dict(tokens (B,S), labels (B,S)) int32."""
    key = (cfg.vocab, cfg.seed, cfg.n_regimes, cfg.branching)
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = _regime_tables(cfg)
    tables = _TABLE_CACHE[key]
    rng = np.random.default_rng((cfg.seed, step))
    B, S = cfg.batch, cfg.seq
    regime = rng.integers(0, cfg.n_regimes, (B,))
    tok = np.empty((B, S + 1), np.int64)
    tok[:, 0] = rng.integers(0, cfg.vocab, (B,))
    choice = rng.integers(0, cfg.branching, (B, S))
    for t in range(S):
        tok[:, t + 1] = tables[regime, tok[:, t], choice[:, t]]
    return {
        "tokens": tok[:, :-1].astype(np.int32),
        "labels": tok[:, 1:].astype(np.int32),
    }
