"""Byte stores of the port (counterpart of ``repro.store``).

Only :mod:`repro_torch.store.backends` is here: the ``Store`` protocol and
its backends, under the CZ2 container's reads and writes.  The reference's
dataset layer (``CZDataset``, ``ShardWriter``, the manifest) is not ported
yet.
"""
from . import backends  # noqa: F401

__all__ = ["backends"]
