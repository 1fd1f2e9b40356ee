"""The ``auto`` meta-scheme (port of ``repro.core.schemes.auto``): a
per-chunk winner over the registry.

``auto`` owns no transform.  For each aggregation-buffer chunk it asks the
tuner (:mod:`repro_torch.tune`) which registered scheme meets the spec's
quality target at the best measured ratio, delegates encode to that
winner, and makes the chunk self-describing: the serialized payload starts
with a compact prelude —

    u8 name_len | name (ascii) | f64 winner eps

— followed by the winner's own byte layout.  Decode parses the prelude and
dispatches through the registry, on the torch device the reader names.
The winners' names and eps also go to the footer (``chunk_schemes``, via
:meth:`chunk_record`).

The target comes from ``spec.extra["target"]`` (``abs=V | rel=V |
psnr=DB``; defaults to ``abs=spec.eps``) and the optional decision cache
from ``spec.extra["tune_cache"]`` (see :mod:`repro_torch.tune.policy`).

On the card, stage 1 keeps the batch there, so that the trials and the
winners run their kernels on slices of it, and takes one host copy of the
batch, on which the tuner takes every statistic in numpy float64 as the
reference does.  The kernels give the CPU's bits, so the winners and the
container are the same whether the batch was on the card or on the CPU.
The meta-scheme itself is host-side control flow: headers record
``"host"``, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import struct
import threading

from . import Scheme, get_scheme, register_scheme

_LEN = struct.Struct("<B")
_EPS = struct.Struct("<d")


@register_scheme
class AutoScheme(Scheme):
    name = "auto"
    device_capable = False

    # tune imports stay lazy: this module is imported while the schemes
    # package is still initializing, and repro_torch.tune imports the registry

    def validate(self, spec) -> None:
        from repro_torch.tune import bound

        bound.target_from_spec(spec)  # parse errors -> ValueError
        cache = spec.extra.get("tune_cache", 0) if spec.extra else 0
        if not isinstance(cache, int) or isinstance(cache, bool) or cache < 0:
            raise ValueError(
                f"tune_cache must be a non-negative int, got {cache!r}")

    def params(self, spec) -> dict:
        from repro_torch.tune import bound

        p = super().params(spec)
        p["target"] = str(bound.target_from_spec(spec))
        return p

    def error_bound(self, spec):
        from repro_torch.tune import bound

        t = bound.target_from_spec(spec)
        # abs targets are a hard max-abs-error contract; rel/psnr bounds
        # are per-chunk (value-range dependent), enforced by the trials
        return t.value if t.mode == "abs" else float("inf")

    def stage1(self, blocks, spec):
        # no batch transform: winners transform per chunk in serialize().
        # The dict also carries the per-chunk decision memo chunk_record()
        # reads — guarded, serialize may run on the pipeline's thread pool.
        return {"blocks": blocks, "host": blocks.cpu().numpy(),
                "used": {}, "lock": threading.Lock()}

    def serialize(self, s1, lo, hi, spec) -> bytes:
        from repro_torch.tune import bound, policy

        chunk = s1["blocks"][lo:hi]
        target = bound.target_from_spec(spec)
        decision = policy.policy_for(spec).decide(chunk, spec, target,
                                                  s1["host"][lo:hi])
        last_err = None
        for cand in decision.ranked:
            sch = get_scheme(cand.scheme)
            try:
                sch.check(chunk, cand)
            except ValueError as e:
                # the sample passed but the full chunk did not (e.g. szx's
                # eps/magnitude guard): fall through to the runner-up —
                # the ranking always ends in a lossless scheme
                last_err = e
                continue
            payload = sch.serialize(sch.stage1(chunk, cand), 0,
                                    int(chunk.shape[0]), cand)
            with s1["lock"]:
                s1["used"][lo] = cand
            nb = cand.scheme.encode("ascii")
            return _LEN.pack(len(nb)) + nb + _EPS.pack(cand.eps) + payload
        raise ValueError(
            f"every ranked candidate failed on chunk [{lo}:{hi}): {last_err}")

    def deserialize(self, payload, nblk, spec, device):
        n = _LEN.unpack_from(payload, 0)[0]
        name = bytes(payload[1:1 + n]).decode("ascii")
        (eps,) = _EPS.unpack_from(payload, 1 + n)
        wspec = dataclasses.replace(spec, scheme=name, eps=eps, extra={})
        body = payload[1 + n + _EPS.size:]
        return get_scheme(name).deserialize(body, nblk, wspec, device)

    def chunk_record(self, s1, lo, hi, spec):
        with s1["lock"]:
            cand = s1["used"].get(lo)
        if cand is None:
            return None
        return {"scheme": cand.scheme, "eps": cand.eps}
