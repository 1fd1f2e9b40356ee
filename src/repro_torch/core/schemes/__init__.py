"""Codec-scheme registry of the port (counterpart of ``repro.core.schemes``).

Each scheme is a self-describing object that owns

  * ``validate(spec)``  — scheme-specific spec checks,
  * ``stage1(blocks, spec)`` — the transform of a whole ``(nblk, bs, bs, bs)``
    block batch, a torch tensor on the device it runs on; returns named
    numpy streams on the host,
  * ``serialize(s1, lo, hi, spec)`` / ``deserialize(payload, nblk, spec,
    device)`` — the host byte layout of one aggregation-buffer chunk, the
    same bytes the reference writes.

``wavelet``, ``zfpx``, ``lorenzo``, ``szx`` and ``raw`` are ported so far;
the reference's other schemes are named in :data:`NOT_YET_PORTED` and
asking for one raises ``ValueError``.
"""
from __future__ import annotations

import abc
from typing import TYPE_CHECKING

import numpy as np
import torch

from .. import shuffle as _shuf
from ._device import DEVICES, check_device, resolved_device, torch_device

if TYPE_CHECKING:  # avoid a runtime cycle with repro_torch.core.pipeline
    from ..pipeline import CompressionSpec

__all__ = ["Scheme", "NOT_YET_PORTED", "register_scheme", "get_scheme",
           "scheme_names", "shuffle_bytes",
           "unshuffle_bytes", "DEVICES", "check_device", "resolved_device",
           "torch_device"]

#: schemes of the reference that this package does not implement yet
NOT_YET_PORTED = ("fpzipx", "auto")

_REGISTRY: dict[str, "Scheme"] = {}


def shuffle_bytes(buf: bytes, mode: str, itemsize: int) -> bytes:
    """Optional byte/bit transpose of a value stream (improves stage 2 CR)."""
    if mode == "none" or itemsize == 1:
        return buf
    fn = _shuf.byte_shuffle if mode == "byte" else _shuf.bit_shuffle
    return fn(buf, itemsize)


def unshuffle_bytes(buf: bytes, mode: str, itemsize: int) -> bytes:
    if mode == "none" or itemsize == 1:
        return buf
    fn = _shuf.byte_unshuffle if mode == "byte" else _shuf.bit_unshuffle
    return fn(buf, itemsize)


class Scheme(abc.ABC):
    """One substage-1 compressor: device transform + host byte layout."""

    #: registry key; also recorded in CZ2 headers
    name: str = ""

    #: whether stage 1 has a hand-written kernel (a CUDA batch records
    #: ``device="jax"`` in headers); other schemes always record ``"host"``
    device_capable: bool = False

    def validate(self, spec: "CompressionSpec") -> None:
        """Raise ValueError if ``spec`` is invalid for this scheme."""

    def params(self, spec: "CompressionSpec") -> dict:
        """Scheme-relevant knobs, recorded explicitly in container headers.

        ``device`` records where stage 1 ran (see ``schemes._device``); it is
        provenance, never needed to decode."""
        p = dict(spec.extra) if spec.extra else {}
        p["device"] = spec.device if self.device_capable else "host"
        return p

    def error_bound(self, spec: "CompressionSpec") -> float | None:
        """Declared max-abs-error contract: ``None`` for lossless (decode is
        bit-exact), else a bound on ``max|x - xhat|``."""
        return None

    def decode_spec(self, spec: "CompressionSpec", fmt: int) -> "CompressionSpec":
        """Spec to decode a payload written under container format ``fmt``.

        Lets a scheme change its byte layout across format bumps while old
        containers keep reading bit-exact (see szx's outlier shuffle in v2).
        """
        return spec

    @abc.abstractmethod
    def stage1(self, blocks: torch.Tensor, spec: "CompressionSpec") -> dict[str, np.ndarray]:
        """Transform of a whole (nblk, bs, bs, bs) batch -> host streams."""

    @abc.abstractmethod
    def serialize(self, s1: dict, lo: int, hi: int, spec: "CompressionSpec") -> bytes:
        """Byte layout of blocks [lo, hi) from the stage-1 streams."""

    @abc.abstractmethod
    def deserialize(self, payload: bytes, nblk: int, spec: "CompressionSpec",
                    device: torch.device) -> np.ndarray:
        """Inverse of :meth:`serialize`: payload -> (nblk, bs, bs, bs) blocks,
        with any inverse transform run on ``device``."""


def register_scheme(cls: type) -> type:
    """Class decorator: instantiate and add to the live registry."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[inst.name] = inst
    return cls


def get_scheme(name: str) -> Scheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in NOT_YET_PORTED:
            raise ValueError(f"scheme {name!r} not yet ported") from None
        raise ValueError(
            f"unknown scheme {name!r}; registered: {', '.join(sorted(_REGISTRY))}"
        ) from None


def scheme_names() -> list[str]:
    """Registered scheme names, sorted."""
    return sorted(_REGISTRY)


# Built-in schemes self-register on import.
from . import lorenzo, raw, szx, wavelet, zfpx  # noqa: E402,F401
