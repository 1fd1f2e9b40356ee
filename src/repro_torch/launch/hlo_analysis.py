"""Per-device cost counts of the port's own ops (the port's counterpart of
``repro.launch.hlo_analysis``).

The reference parses XLA's compiled HLO text and multiplies each while
body by its trip count, because ``cost_analysis`` counts a scan body once.
The port has no HLO.  It counts the ops it dispatches: :class:`OpCounter`
is a ``TorchDispatchMode`` that sees every aten op and every ``c10d``
collective a function runs, on real tensors or on fake ones (under
``FakeTensorMode``, where nothing is allocated), and adds them into the
reference's :class:`HloStats`:

* ``flops`` — ``torch.utils.flop_counter``'s per-op formulas: 2·M·N·K per
  matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions), the flash
  chunks' products included.  Eager torch dispatches every loop iteration,
  so the count is loop-aware by construction and ``unknown_trip_whiles``
  is always 0;
* ``hbm_bytes`` — the reference's unfused model: each op that writes a
  result counts its result's bytes and its tensor operands' bytes.  Views,
  ``empty``, ``arange`` and scalar constants count nothing, as the
  reference's ``_NO_BYTES_OPS``;
* ``hbm_bytes_fused`` — matmuls (result and operands) and data movement
  only, by the reference's rules: a gather or index reads and writes its
  result; a scatter, an index update or a slice update (``copy_`` into a
  part of a larger tensor) its updates; a sort, a top-k or a running sum
  (XLA's reduce-window) its result and operands;
* ``attn_score_bytes`` — of those fused bytes, the ones on attention's
  score blocks: the result of a product that makes one and the score
  operand of a product that reads one, as marked by
  :func:`repro_torch.models.common.score_block`;
* ``transcendentals`` — the elements through exp, log, tanh, sigmoid,
  rsqrt, sqrt, erf, sin, cos, a non-integer power and the activations and
  softmaxes built on them;
* ``collectives`` — per reference op name, the per-device output bytes
  and the calls: ``c10d.allgather_``/``_allgather_base_`` "all-gather"
  (the gathered whole), ``allreduce_`` "all-reduce" (the reduced tensor),
  ``reduce_scatter_``/``_reduce_scatter_base_`` "reduce-scatter" (the
  scattered block), ``alltoall*`` "all-to-all", ``send``/``recv_``
  "collective-permute".  A collective also counts in ``hbm_bytes``, as an
  HLO instruction does.

Everything is per device: the counted function is one rank's program.  The
counter also follows the storages its ops allocate (``live_bytes``,
``peak_bytes``): a storage counts from the op that made it until its last
tensor is freed.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models.common import SCORE_BLOCK

__all__ = ["HloStats", "OpCounter", "count_ops"]

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

#: ``c10d`` op -> the reference's collective; each op's first argument holds
#: its per-device outputs
_COLLECTIVE = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

#: ops that write no data (the reference's parameter/constant/iota)
_NO_BYTES_OPS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                 "arange", "scalar_tensor", "lift_fresh_copy", "_local_scalar_dense"}

# data movement that the reference's fused model keeps (hlo_analysis.py:150-199)
_GATHER_OPS = {"gather", "index", "index_select", "embedding", "take"}
#: scatter-like op -> the name of its updates argument
_SCATTER_OPS = {"scatter": "src", "scatter_": "src", "scatter_add": "src",
                "scatter_add_": "src", "scatter_reduce": "src", "scatter_reduce_": "src",
                "index_put": "values", "index_put_": "values", "_index_put_impl_": "values",
                "index_add": "source", "index_add_": "source", "index_copy": "source",
                "index_copy_": "source", "slice_scatter": "src", "select_scatter": "src",
                "diagonal_scatter": "src", "as_strided_scatter": "src",
                "embedding_dense_backward": "grad_output"}
_WINDOW_OPS = {"sort", "topk", "kthvalue", "cumsum", "cumsum_", "cumprod", "logcumsumexp"}

_TRANSCENDENTAL = {"exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "log10",
                   "tanh", "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt", "sqrt_",
                   "erf", "erfc", "erfinv", "sin", "cos", "tan", "atan2", "logit", "silu",
                   "silu_", "silu_backward", "gelu", "gelu_backward", "softplus", "mish",
                   "_softmax", "_log_softmax", "_log_softmax_backward_data", "logsumexp",
                   "pow", "pow_"}


def _empty_collectives() -> dict:
    return {op: {"bytes": 0, "count": 0} for op in _COLL_OPS}


@dataclass
class HloStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0          # unfused upper bound (every op that writes)
    hbm_bytes_fused: float = 0.0    # fusion floor: matmuls + data movement
    attn_score_bytes: float = 0.0   # fused-model bytes on the (qc, kc) score
                                    # blocks, which a flash kernel keeps on chip
    transcendentals: float = 0.0
    collectives: dict = field(default_factory=_empty_collectives)
    unknown_trip_whiles: int = 0    # always 0: every call is counted

    @property
    def collective_bytes(self) -> int:
        return sum(v["bytes"] for v in self.collectives.values())


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _argument(func, args, kwargs, name: str):
    if name in kwargs:
        return kwargs[name]
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else None
    return None


def _is_part(dst: torch.Tensor) -> bool:
    """Whether ``dst`` is a strict part of its storage (a slice to update)."""
    return dst.numel() * dst.element_size() < dst.untyped_storage().nbytes()


def _integral(x) -> bool:
    return isinstance(x, int) or (isinstance(x, float) and x.is_integer())


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched while it is entered into :attr:`stats`,
    and follows the bytes of the storages those ops allocate
    (:attr:`live_bytes`, :attr:`peak_bytes`).  Enter it inside a
    ``FakeTensorMode`` to count without allocating."""

    def __init__(self):
        super().__init__()
        self.stats = HloStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._lock = threading.RLock()
        self._kinds: dict = {}

    def _kind(self, func) -> str:
        """"view", "inplace", "fresh", "nobytes" or "collective"."""
        kind = self._kinds.get(func)
        if kind is None:
            name = func._overloadpacket.__name__
            if func.namespace == "c10d":
                if name not in _COLLECTIVE:
                    raise NotImplementedError(f"no rule to count the collective {func}")
                kind = "collective"
            elif func.namespace == "prim" or name in _NO_BYTES_OPS:
                kind = "nobytes"
            else:
                alias = [r.alias_info for r in func._schema.returns if r.alias_info is not None]
                if not alias:
                    kind = "fresh"
                elif any(a.is_write for a in alias):
                    kind = "inplace"
                else:
                    kind = "view"
            self._kinds[func] = kind
        return kind

    def _allocated(self, out) -> None:
        with self._lock:
            for t in _tensors(out):
                st = t.untyped_storage()
                key = id(st)
                if key in self._live:
                    continue
                n = st.nbytes()
                self._live[key] = n
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = self._kind(func)
        if kind == "nobytes":
            self._allocated(out)
        if kind in ("view", "nobytes"):
            return out
        st = self.stats
        name = func._overloadpacket.__name__
        if kind == "collective":
            outputs = _nbytes(args[0])
            coll = st.collectives[_COLLECTIVE[name]]
            coll["bytes"] += outputs
            coll["count"] += 1
            st.hbm_bytes += outputs + _nbytes(args[1:])
            return out
        if kind == "fresh":
            self._allocated(out)
        result, operands = _nbytes(out), _nbytes(args) + _nbytes(list(kwargs.values()))
        st.hbm_bytes += result + operands
        packet = func._overloadpacket
        if packet in flop_registry:
            st.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            st.hbm_bytes_fused += result + operands
            marked = SCORE_BLOCK.get()
            if marked is True:
                st.attn_score_bytes += result
            elif marked is not None:
                st.attn_score_bytes += _nbytes(marked)
        elif name in _GATHER_OPS:
            st.hbm_bytes_fused += 2 * result
        elif name in _SCATTER_OPS:
            st.hbm_bytes_fused += 2 * _nbytes(_argument(func, args, kwargs, _SCATTER_OPS[name]))
        elif name == "copy_" and _is_part(args[0]):
            st.hbm_bytes_fused += 2 * _nbytes(args[1])
        elif name in _WINDOW_OPS:
            st.hbm_bytes_fused += result + operands
        if name in _TRANSCENDENTAL:
            if name.startswith("pow"):
                if not _integral(_argument(func, args, kwargs, "exponent")):
                    st.transcendentals += next(_tensors(out)).numel()
            elif name == "logsumexp":
                st.transcendentals += args[0].numel() + out.numel()
            else:
                st.transcendentals += next(_tensors(out)).numel()
        return out


def count_ops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), its HloStats)``: every op the call dispatches,
    counted by an :class:`OpCounter`."""
    counter = OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.stats
