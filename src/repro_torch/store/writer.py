"""Concurrent shard writer: pooled chunk encoding, single ordered drain
(port of ``repro.store.writer``).

The paper's writers are per-thread: each thread compresses its own
aggregation buffer and the buffers are concatenated in deterministic order.
:class:`ShardWriter` reproduces that shape for dataset members — one shared
:class:`~concurrent.futures.ThreadPoolExecutor` encodes aggregation buffers
(scheme serialize + stage-2 lossless, both GIL-releasing) for *all*
quantities of a timestep, while each CZ2 member is drained by a single
writer strictly in chunk order.  Serial (``workers=1``) and pooled output are
byte-identical.

Stage 1 runs once per member on the caller's thread, on the writer's torch
``device`` (default ``"cuda"``: the scheme's kernel); the pool's threads do
host work only, except under ``auto``, whose per-chunk trials launch the
kernels from the pool's threads.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import warnings

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core import container
from repro_torch.core.pipeline import DTYPES, CompressionSpec
from repro_torch.core.schemes import check_device, torch_device

__all__ = ["ShardWriter", "DtypeCoercionWarning"]


def _as_field(field) -> np.ndarray | torch.Tensor:
    """A tensor as it is, on its own device; anything else as a numpy
    array."""
    return field if isinstance(field, torch.Tensor) else np.asarray(field)


class DtypeCoercionWarning(UserWarning):
    """A field's dtype could not be carried through the dataset spec's scheme
    and the value stream was cast to the spec's dtype (e.g. float64 into an
    fpzipx dataset, whose lossless guarantee is float32-only)."""


class ShardWriter:
    """Writes 3D fields to CZ2 member files through a shared encode pool, with
    stage 1 on the torch ``device`` (``"cuda"`` without a GPU raises)."""

    def __init__(self, spec: CompressionSpec, workers: int = 1,
                 device=DEFAULT_DEVICE):
        self.device = torch_device(device)
        self.spec = spec.validate()
        self.workers = max(1, int(workers))
        self._pool = (concurrent.futures.ThreadPoolExecutor(self.workers)
                      if self.workers > 1 else None)

    def spec_for(self, field: np.ndarray | torch.Tensor) -> CompressionSpec:
        """Dataset spec re-tagged with the field's dtype (auto dtype tags).
        Dtypes the spec's scheme can't take (unsupported ones, or e.g.
        float64 into an fpzipx dataset) fall back to the spec's own dtype —
        the field is coerced, never rejected mid-append, but the cast is
        surfaced as a :class:`DtypeCoercionWarning` rather than silent.

        An unknown ``spec.device`` (the header's provenance field, ``"host"``
        or ``"jax"``) is *not* coercible: it raises here even if the spec
        skipped validation (e.g. was rebuilt from a hand-edited manifest)."""
        check_device(self.spec.device)
        # the numpy name of the dtype, read from a tensor without converting it
        dt = str(_as_field(field).dtype).removeprefix("torch.")
        if dt == self.spec.dtype:
            return self.spec
        if dt not in DTYPES:
            warnings.warn(
                f"dtype {dt} is not a supported field dtype {DTYPES}; "
                f"values will be cast to {self.spec.dtype}",
                DtypeCoercionWarning, stacklevel=3)
            return self.spec
        try:
            return dataclasses.replace(self.spec, dtype=dt).validate()
        except ValueError as e:
            warnings.warn(
                f"scheme {self.spec.scheme!r} cannot encode dtype {dt} "
                f"({e}); values will be cast to {self.spec.dtype}",
                DtypeCoercionWarning, stacklevel=3)
            return self.spec

    def write(self, path: str, field: np.ndarray | torch.Tensor,
              extra_header: dict | None = None,
              spec: CompressionSpec | None = None, store=None) -> int:
        """Stream one field into a CZ2 member; returns bytes written.

        ``spec`` lets a caller that already ran :meth:`spec_for` (e.g. for
        the manifest's dtype tag) pass it in instead of re-deriving it —
        and re-emitting any coercion warning.  ``store`` routes the member
        bytes through a :class:`~repro_torch.store.backends.Store` (``path``
        is then a store key); ``None`` writes a local file.  Members are
        fsynced (where the backend has an fd to sync): the dataset's
        atomic-manifest guarantee needs member data on stable storage
        *before* the manifest references it.  A tensor is passed on as it
        is: stage 1 blocks it on the writer's device, where it already lies
        on the in-situ path, and never writes to it.
        """
        field = _as_field(field)
        if field.ndim != 3:
            raise ValueError(f"expected a 3D field, got shape {field.shape}")
        return container.write_compressed(
            path, field, spec or self.spec_for(field),
            extra_header=extra_header, workers=self.workers,
            executor=self._pool, fsync=True, store=store, device=self.device)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
