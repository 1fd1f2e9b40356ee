"""Codec-scheme registry of the port (counterpart of ``repro.core.schemes``).

Each scheme is a self-describing object that owns

  * ``validate(spec)``  — scheme-specific spec checks,
  * ``stage1(blocks, spec)`` — the transform of a whole ``(nblk, bs, bs, bs)``
    block batch, a torch tensor on the device it runs on; returns named
    numpy streams on the host,
  * ``serialize(s1, lo, hi, spec)`` / ``deserialize(payload, nblk, spec,
    device)`` — the host byte layout of one aggregation-buffer chunk, the
    same bytes the reference writes.

All seven of the reference's schemes are registered: ``wavelet``,
``zfpx``, ``lorenzo``, ``szx``, ``fpzipx``, ``raw`` and the ``auto``
meta-scheme, which picks one of the others per chunk.  Third-party
schemes register with :func:`register_scheme` (and leave with
:func:`unregister_scheme`); ``SCHEMES`` is a live, read-only view of the
registry that iterates names.
"""
from __future__ import annotations

import abc
from collections.abc import Mapping
from typing import TYPE_CHECKING

import numpy as np
import torch

from .. import shuffle as _shuf
from ._device import DEVICES, check_device, resolved_device, torch_device

if TYPE_CHECKING:  # avoid a runtime cycle with repro_torch.core.pipeline
    from ..pipeline import CompressionSpec

__all__ = ["Scheme", "SCHEMES", "register_scheme", "unregister_scheme",
           "get_scheme", "scheme_names",
           "shuffle_bytes", "unshuffle_bytes", "DEVICES", "check_device",
           "resolved_device", "torch_device"]

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

    def check(self, blocks: torch.Tensor, spec: "CompressionSpec") -> None:
        """The scheme's own guard on the data: raise ValueError if ``blocks``
        cannot be encoded under ``spec``, before any transform runs.

        The tuner scores a candidate whose guard fires as inadmissible (the
        reference catches the same ``ValueError`` from its stage 1); any
        error from the transform itself, a refused kernel launch included,
        propagates.  Stage 1 raises what this raises."""

    def chunk_record(self, s1: dict, lo: int, hi: int,
                     spec: "CompressionSpec") -> dict | None:
        """Optional JSON-able per-chunk footer record for blocks [lo, hi),
        called right after :meth:`serialize` for the same range.

        ``None`` (the default) records nothing, and containers stay
        byte-identical.  ``auto`` returns each chunk's winning scheme + eps;
        the container writer collects them into the footer's
        ``chunk_schemes`` table."""
        return None

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


def unregister_scheme(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_scheme(name: str) -> Scheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; registered: {', '.join(sorted(_REGISTRY))}"
        ) from None


def scheme_names() -> list[str]:
    """Registered scheme names, sorted."""
    return sorted(_REGISTRY)


class _SchemesView(Mapping):
    """Live, read-only view of the registry.  Iterates scheme names, so both
    ``"wavelet" in SCHEMES`` and ``for name in SCHEMES`` work."""

    def __getitem__(self, name: str) -> Scheme:
        return get_scheme(name)

    def __iter__(self):
        return iter(_REGISTRY)

    def __len__(self) -> int:
        return len(_REGISTRY)

    def __contains__(self, name) -> bool:
        return name in _REGISTRY

    def __repr__(self) -> str:
        return f"SCHEMES({', '.join(sorted(_REGISTRY))})"


SCHEMES = _SchemesView()


# Built-in schemes self-register on import.  ``auto`` comes last: the
# meta-scheme delegates to whatever else is registered.
from . import fpzipx, lorenzo, raw, szx, wavelet, zfpx  # noqa: E402,F401
from . import auto  # noqa: E402,F401
