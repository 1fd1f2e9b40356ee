"""Error-feedback compressed cross-pod gradient reduction (port of
``repro.train.grad_compress``).

The CubismZ insight applied to the training fabric: the pod-to-pod
interconnect is the slowest link, and gradients tolerate lossy compression
*with error feedback*.  Structure:

* each pod computes gradients on its slice of the global batch (its
  "data" ranks' rows, averaged over the pod's "data" group);
* per-leaf top-k selection, block by block (the fixed-shape analogue of
  the paper's wavelet threshold decimation, see
  :func:`repro_torch.core.threshold.topk_details`), on the
  error-feedback-corrected gradient;
* the (values, indices) payload, 8 bytes an entry instead of 4 a value, is
  gathered across pods and scatter-added locally;
* the unsent residual is carried to the next step (error feedback).

The pod exchange has one transport, used always: an explicit copy of the
payload to the host and ``all_gather`` over the mesh's "pod" group there
(gloo takes CPU tensors; NCCL refuses two ranks on one card), then back to
the payload's device.  On a mesh of one pod there is no exchange.

Selection is a stable descending sort of |rows|, so ties go to the lower
index as ``lax.top_k``'s do, and the card picks what the CPU picks.  The
reference's float semantics are XLA's on the CPU (subnormals flushed, see
:mod:`repro_torch.core._xla`): ``g + r``, the scatter-add into zeros, the
sum over pods and the scaling by ``1 / n_pods`` (a product, as XLA
compiles a division by a constant) flush here on every device.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core._xla import flush
from repro_torch.core.threshold import topk_largest
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.common import tree_leaves, tree_map

from .optim import _recip, _unzip

__all__ = ["pod_compressed_grads", "topk_compress", "topk_decompress", "payload_bytes"]


_BLOCK = 1 << 20   # top-k block length (paper-style block-structured selection)
_SPLIT = 1 << 28   # leaves this large are compressed slice by slice along dim 0


def topk_compress(g: torch.Tensor, ratio: int):
    """Blockwise top-|k| selection: the flat tensor is split into
    ``_BLOCK``-long blocks (the last padded with zeros) and each keeps its
    top ``block // ratio`` entries.  Returns (vals (nb, k) float32, idx
    int32 (nb, k) block-local), each row largest |value| first."""
    flat = g.reshape(-1).to(torch.float32)
    n = flat.numel()
    bl = min(_BLOCK, n)
    pad = (-n) % bl
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    rows = flat.reshape(-1, bl)
    k = max(1, bl // ratio)
    idx = topk_largest(rows.abs(), k)
    return torch.gather(rows, 1, idx), idx.to(torch.int32)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """The dense float32 tensor of ``shape``: each block's kept entries
    added into zeros (XLA's ``0 + v``: subnormals flushed, -0 to +0), the
    padding dropped."""
    n = 1
    for s in shape:
        n *= s
    bl = min(_BLOCK, n)
    nb = -(-n // bl)
    rows = torch.zeros((nb, bl), dtype=torch.float32, device=vals.device)
    rows.scatter_(1, idx.long(), flush(vals) + 0.0)
    return rows.reshape(-1)[:n].reshape(shape)


def payload_bytes(grads, method: str = "topk32") -> int:
    """The bytes one pod sends a step for a tree of grads (or of tensors of
    their shapes and dtypes), as :func:`pod_compressed_grads` sends them: a
    tiny leaf whole in its dtype; every other leaf, or each slice along dim
    0 of a huge one, as each block's ``block // ratio`` float32 values and
    int32 indices."""
    ratio = int(method.replace("topk", "") or 32)

    def one(n: int) -> int:
        bl = min(_BLOCK, n)
        return 8 * -(-n // bl) * max(1, bl // ratio)

    total = 0
    for _, g in tree_leaves(grads):
        n = g.numel()
        if n < 4 * ratio:
            total += n * g.element_size()
        elif n < _SPLIT:
            total += one(n)
        else:
            total += g.shape[0] * one(n // g.shape[0])
    return total


def _pod_gather(x: torch.Tensor, group, n_pods: int) -> list[torch.Tensor]:
    """Every pod's ``x``, in pod order, on ``x``'s device: the one
    transport (a copy to the host, ``all_gather`` there, and back)."""
    host = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(n_pods)]
    dist.all_gather(parts, host, group=group)
    return [p.to(x.device) for p in parts]


def _pod_mean(x: torch.Tensor, group, n_pods: int) -> torch.Tensor:
    """``lax.pmean`` over the pods: their values summed in pod order, times
    ``1 / n_pods``."""
    if n_pods == 1:
        return x
    total = None
    for p in _pod_gather(x, group, n_pods):
        total = p if total is None else total + p
    return flush(total * _recip(n_pods)).to(x.dtype)


def _one_small(g, r, ratio: int, group, n_pods: int):
    corrected = flush(flush(g.to(torch.float32)) + flush(r))
    vals, idx = topk_compress(corrected, ratio)
    # what this pod actually transmits
    sent = topk_decompress(vals, idx, g.shape)
    new_r = corrected - sent
    if n_pods == 1:
        return sent.to(g.dtype), new_r
    mean = None
    for v, i in zip(_pod_gather(vals, group, n_pods), _pod_gather(idx, group, n_pods)):
        d = topk_decompress(v, i, g.shape)
        mean = d if mean is None else flush(mean + d)
    return flush(mean * _recip(n_pods)).to(g.dtype), new_r


def pod_compressed_grads(loss_fn, params, residual, batch, cfg, settings,
                         mesh, method: str = "topk32"):
    """Returns ((loss, metrics), grads, new_residual, compress_metrics).

    ``params`` and ``residual`` are whole trees on this rank (replicated
    over the pods); ``batch`` is this rank's rows of the global batch
    (sharded over "pod" and "data").  ``loss_fn`` is unused, as in the
    reference: the loss is ``lm_loss`` under ``settings`` without the
    "pod" axis.  The grads come back whole, summed over the pods' payloads
    and averaged, the residual whole, the loss and metrics averaged over
    every batch rank."""
    from .step import _batch_mean, _value_and_grad

    ratio = int(method.replace("topk", "") or 32)
    sizes = axis_sizes(mesh)
    n_pods = sizes["pod"]
    group = mesh.get_group("pod") if n_pods > 1 else None
    settings = dataclasses.replace(
        settings,
        batch_axes=tuple(a for a in settings.batch_axes if a != "pod"),
        n_batch=max(1, settings.n_batch // n_pods))

    # this pod's gradients: its data ranks' rows, averaged within the pod
    loss, metrics, grads = _value_and_grad(params, batch, cfg, settings)
    data = tuple(a for a in ("data",) if a in sizes)
    loss, metrics, grads = _batch_mean(loss, metrics, grads, mesh, data)

    def one(g, r):
        if g.numel() < 4 * ratio:          # tiny leaf: send dense
            return _pod_mean(g, group, n_pods), torch.zeros_like(r)
        if g.numel() < _SPLIT:
            return _one_small(g, r, ratio, group, n_pods)
        # a huge leaf goes slice by slice along its leading (layer-stack) dim
        outs = [_one_small(gs, rs, ratio, group, n_pods)
                for gs, rs in zip(g.reshape(g.shape[0], -1), r.reshape(r.shape[0], -1))]
        return (torch.stack([o[0] for o in outs]).reshape(g.shape).to(g.dtype),
                torch.stack([o[1] for o in outs]).reshape(g.shape))

    out = tree_map(one, grads, residual)
    new_grads, new_resid = _unzip(out, 0), _unzip(out, 1)
    loss = _pod_mean(loss, group, n_pods)
    metrics = {k: _pod_mean(v, group, n_pods) for k, v in metrics.items()}
    n_leaves = sum(1 for _ in tree_leaves(params))
    dev = loss.device
    cmx = {"grad_compress_ratio": torch.tensor(float(ratio), device=dev),
           "grad_compress_leaves": torch.tensor(float(n_leaves), device=dev)}
    return (loss, metrics), new_grads, new_resid, cmx
