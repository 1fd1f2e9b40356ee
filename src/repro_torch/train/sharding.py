"""Sharding rules: FSDP-style baseline (+ expert parallelism) for every arch
(port of ``repro.train.sharding``).

The rules are the reference's, leaf for leaf:

* every parameter is sharded along its largest "model"-divisible axis
  (ZeRO-3 semantics: the weights are gathered at use, one layer at a time;
  avoids head-count divisibility hazards — qwen2.5 has 40 heads, smollm 9);
* expert-stacked leaves (``we*``) shard the expert axis when divisible
  (expert parallelism);
* scanned layer-stack axes (leading 1-2 dims of ``blocks`` leaves) are never
  sharded;
* activations/batches shard over ("pod","data");
* decode caches shard batch over "data" when divisible and the KV sequence
  axis over "model".

ZeRO-3 as the reference states it, partitioned: a step on a mesh takes
this rank's blocks of the parameters (:func:`sharded_tree` wraps each in a
:class:`Block`) and gathers one layer's slice whole at a time, inside the
layer (:meth:`Block.whole`; no stack dim is ever split, so slice i of a
block is layer i's block).  In training a :class:`TrainBlock`'s gather is
an autograd function whose backward reduces the layer's gradient into the
moments' block as the backward produces it (:func:`reduce_to`).  A serve
step's :class:`Partition` says which rows of the batch and which slice of
the KV sequence a rank holds, and joins the parts: the attention's partial
softmaxes over "model", the rows over the batch axes.

A :class:`PartitionSpec` names, per tensor dim, ``None``, a mesh axis or a
tuple of axes (major first), as JAX's does; a :class:`NamedSharding` pairs
it with a ``DeviceMesh``, gives the DTensor ``placements``, cuts a global
tensor into this rank's block (:meth:`NamedSharding.local`) and gathers
the blocks back (:meth:`NamedSharding.gather`, ``all_gather`` over each
sharding axis's group).  Every sharded dim divides evenly: the rules shard
only divisible dims.  Paths come from ``models.common.tree_leaves``, in
sorted-key order.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_sizes, batch_axes

from .optim import _recip

__all__ = ["param_shardings", "batch_shardings", "cache_shardings",
           "state_shardings", "path_str", "PartitionSpec", "NamedSharding",
           "Block", "TrainBlock", "Partition", "sharded_tree", "reduce_to"]


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple
    of axis names whose shards nest major to minor."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` laid over a ``DeviceMesh``."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` where the spec
        puts that axis on tensor dim ``d``, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, part in enumerate(self.spec) if name in _axes(part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def _block(self, dim: int) -> tuple[int, int]:
        """(this rank's block index, the number of blocks) along ``dim``."""
        names, sizes = self.mesh.mesh_dim_names, self.mesh.shape
        coord = self.mesh.get_coordinate()
        idx, count = 0, 1
        for name in _axes(self.spec[dim]):
            i = names.index(name)
            idx, count = idx * sizes[i] + coord[i], count * sizes[i]
        return idx, count

    def sub(self, n: int = 1) -> NamedSharding:
        """The sharding of ``x[i]``: ``n`` leading dims indexed away."""
        return NamedSharding(self.mesh, P(*self.spec[n:]))

    def over(self, *axes: str) -> NamedSharding:
        """Only the splits over ``axes``; every other dim whole."""
        def keep(part):
            kept = tuple(a for a in _axes(part) if a in axes)
            return None if not kept else kept[0] if len(kept) == 1 else kept

        return NamedSharding(self.mesh, P(*(keep(part) for part in self.spec)))

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of one rank's block of a global ``shape``."""
        return tuple(s // self._block(d)[1] for d, s in enumerate(shape))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x``: a view, ``x``
        itself where no dim is split."""
        for d in range(len(self.spec)):
            idx, count = self._block(d)
            if count > 1:
                step = x.shape[d] // count
                x = x.narrow(d, idx * step, step)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from this rank's block ``x`` (every rank
        calls it): ``all_gather`` over each axis of each split dim, the
        minor axis first.  ``x`` itself where no dim is split."""
        sizes = axis_sizes(self.mesh)
        for d, part in enumerate(self.spec):
            for name in reversed(_axes(part)):
                n = sizes[name]
                if n > 1:
                    x = x.contiguous()
                    parts = [torch.empty_like(x) for _ in range(n)]
                    dist.all_gather(parts, x, group=self.mesh.get_group(name))
                    x = torch.cat(parts, dim=d)
        return x


def path_str(path) -> str:
    """A ``tree_leaves`` path (a tuple of keys) as the reference's string."""
    return "/".join(str(k) for k in path)


def _with_path(fn, tree, path=()):
    """``fn(path, leaf)`` on every leaf, in the tree's own structure (the
    reference's ``tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: _with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _n_stack_dims(pstr: str, hybrid: bool = False) -> int:
    if "blocks" not in pstr:
        return 0
    if hybrid:
        # jamba sub-stacks carry (P, n_sub, ...) leading dims
        segs = pstr.split("/")
        if any(seg in ("mamba", "mlp", "moe") for seg in segs[:-1]):
            return 2
    return 1


def _largest_divisible_dim(shape, start: int, n_model: int,
                           prefer: int | None = None) -> int | None:
    if prefer is not None and prefer < len(shape) and shape[prefer] % n_model == 0:
        return prefer
    best, best_size = None, 0
    for i in range(start, len(shape)):
        if shape[i] % n_model == 0 and shape[i] > best_size:
            best, best_size = i, shape[i]
    return best


def _param_pspec(pstr: str, shape, n_model: int, n_data: int = 1,
                 hybrid: bool = False) -> PartitionSpec:
    if len(shape) == 0:
        return P()
    stack = min(_n_stack_dims(pstr, hybrid), len(shape) - 1)
    prefer = None
    leaf = pstr.rsplit("/", 1)[-1]
    if leaf.startswith("we"):            # experts (.., E, D, F) -> shard E
        prefer = stack
    if leaf == "embed":                  # (V, D) -> shard V
        prefer = 0
    spec = [None] * len(shape)
    dim = _largest_divisible_dim(shape, stack, n_model, prefer)
    if dim is not None:
        spec[dim] = "model"
    if n_data > 1:
        # second FSDP axis: shard another dim over "data" (ZeRO-3 within the
        # pod; params stay replicated across pods to bound cross-pod traffic)
        best2, best2_size = None, 0
        for i in range(stack, len(shape)):
            if i != dim and shape[i] % n_data == 0 and shape[i] > best2_size:
                best2, best2_size = i, shape[i]
        if best2 is not None:
            spec[best2] = "data"
    return P(*spec)


_TP_LAST = {"wq", "wk", "wv", "w1", "w3", "ws1", "ws3", "ck", "bq", "bk",
            "bv", "wr", "wg", "in_proj"}
_TP_FIRST_OF_TAIL = {"wo", "w2", "ws2", "cv", "out_proj"}


def _param_pspec_tp(pstr: str, shape, n_model: int, n_data: int,
                    hybrid: bool = False) -> PartitionSpec:
    """Megatron-style tensor parallelism: shard heads/ffn dims over "model";
    params carry no data-axis sharding (pure TP within the pod; optimizer
    moments still use the 2-axis FSDP rule)."""
    if len(shape) == 0:
        return P()
    stack = min(_n_stack_dims(pstr, hybrid), len(shape) - 1)
    leaf = pstr.rsplit("/", 1)[-1]
    spec = [None] * len(shape)
    dim = None
    if leaf in _TP_LAST:
        dim = len(shape) - 1
    elif leaf in _TP_FIRST_OF_TAIL:
        dim = len(shape) - 2
    elif leaf == "embed":
        dim = 0
    elif leaf == "lm_head":
        dim = 1
    elif leaf.startswith("we"):
        dim = stack                      # experts stay expert-parallel
    if dim is not None and dim >= stack and shape[dim] % n_model == 0:
        spec[dim] = "model"
        return P(*spec)
    # fall back to the FSDP rule when TP does not divide
    return _param_pspec(pstr, shape, n_model, 1, hybrid)


def param_shardings(param_tree, mesh, hybrid: bool = False, mode: str = "fsdp"):
    sizes = axis_sizes(mesh)
    n_model, n_data = sizes["model"], sizes.get("data", 1)
    fn = _param_pspec_tp if mode == "tp" else _param_pspec

    def one(path, leaf):
        return NamedSharding(mesh, fn(path_str(path), tuple(leaf.shape), n_model, n_data,
                                      hybrid))

    return _with_path(one, param_tree)


def state_shardings(state_tree, mesh, hybrid: bool = False, mode: str = "fsdp"):
    """Optimizer state mirrors parameter sharding; scalars replicated."""
    sizes = axis_sizes(mesh)
    n_model, n_data = sizes["model"], sizes.get("data", 1)

    def one(path, leaf):
        pstr = path_str(path)
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return NamedSharding(mesh, P())
        # m/v/residual trees live under their own key; strip it for the rule
        is_param = pstr.startswith("params/")
        for pre in ("m/", "v/", "params/", "residual/"):
            if pstr.startswith(pre):
                pstr = pstr[len(pre):]
        if mode == "tp" and is_param:
            # compute path uses TP params; moments keep 2-axis ZeRO sharding
            return NamedSharding(mesh, _param_pspec_tp(pstr, shape, n_model, n_data, hybrid))
        return NamedSharding(mesh, _param_pspec(pstr, shape, n_model, n_data, hybrid))

    return _with_path(one, state_tree)


def batch_shardings(batch_tree, mesh):
    baxes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    n_batch = 1
    for a in baxes:
        n_batch *= sizes[a]

    def one(_path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) and shape[0] % n_batch == 0 and shape[0] > 0:
            spec[0] = baxes if len(baxes) > 1 else baxes[0]
        return NamedSharding(mesh, P(*spec))

    return _with_path(one, batch_tree)


def cache_shardings(cache_tree, mesh):
    """Decode caches: batch -> data (if divisible), KV seq -> model."""
    sizes = axis_sizes(mesh)
    n_model, n_data = sizes["model"], sizes["data"]

    def one(path, leaf):
        pstr = path_str(path)
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        leafname = pstr.rsplit("/", 1)[-1]
        if leafname in ("k", "v", "xk", "xv"):
            # (L_or_P, B, S, Hkv, hd)
            if shape[1] % n_data == 0:
                spec[1] = "data"
            if shape[2] % n_model == 0:
                spec[2] = "model"
        elif leafname in ("wkv",):        # (L, B, H, hd, hd)
            if shape[1] % n_data == 0:
                spec[1] = "data"
            if shape[2] % n_model == 0:
                spec[2] = "model"
        elif leafname in ("ssm", "conv"):  # (P, nm, B, Di, ds) / (P, nm, B, K-1, Di)
            if shape[2] % n_data == 0:
                spec[2] = "data"
            di_dim = 3 if leafname == "ssm" else 4
            if shape[di_dim] % n_model == 0:
                spec[di_dim] = "model"
        else:                              # x_tm/x_cm (L, B, 1, D)
            if shape[1] % n_data == 0:
                spec[1] = "data"
            if shape[-1] % n_model == 0:
                spec[-1] = "model"
        return NamedSharding(mesh, P(*spec))

    return _with_path(one, cache_tree)


def local_tree(tree, shardings):
    """Each leaf's block on this rank (:meth:`NamedSharding.local`)."""
    return _zip_map(lambda a, sh: sh.local(a), tree, shardings)


def gather_tree(tree, shardings):
    """Each leaf's global tensor from the ranks' blocks
    (:meth:`NamedSharding.gather`)."""
    return _zip_map(lambda a, sh: sh.gather(a), tree, shardings)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def reduce_to(g, sh, mesh, baxes, n_batch: int):
    """This rank's whole gradient ``g`` (of a leaf, or of one layer's slice
    of it) -> the batch ranks' mean in ``sh``'s block: reduce-scatter over
    a batch axis that splits a dim of it, all-reduce over one that does
    not, then this rank's block along the other split dims.  The "model"
    ranks compute the same rows, so their gradients are equal: sliced, not
    summed.  ``g`` itself is not written."""
    sizes = axis_sizes(mesh)
    split = {a: d for d, part in enumerate(sh.spec) for a in _axes(part)}
    fresh = False
    for a in baxes:
        n = sizes[a]
        if n == 1:
            continue
        group = mesh.get_group(a)
        if a not in split:
            if not fresh:
                g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=group)
        else:
            chunks = [c.contiguous() for c in g.chunk(n, dim=split[a])]
            g = torch.empty_like(chunks[0])
            dist.reduce_scatter(g, chunks, group=group)
        fresh = True
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    narrowed = False
    for a, d in split.items():
        if a not in baxes and sizes[a] > 1:
            step = g.shape[d] // sizes[a]
            g = g.narrow(d, coord[a] * step, step)
            narrowed = True
    if n_batch > 1:
        return g * _recip(n_batch)
    # a block of its own, not a view that keeps the whole slice alive
    return g.clone() if narrowed else g


class Block:
    """This rank's block (``data``) of a parameter laid out by
    ``sharding``, for a step that gathers one layer at a time: ``block[i]``
    is layer i's block (no stack dim is split), :meth:`whole` gathers it."""

    def __init__(self, data: torch.Tensor, sharding: NamedSharding):
        self.data, self.sharding = data, sharding

    @property
    def shape(self) -> torch.Size:
        return self.data.shape

    def __getitem__(self, i) -> Block:
        return Block(self.data[i], self.sharding.sub(1))

    def whole(self) -> torch.Tensor:
        return self.sharding.gather(self.data)


class _GatherLayer(torch.autograd.Function):
    """Forward: a block gathered whole.  Backward: the whole gradient
    reduced into the moments' block (:func:`reduce_to`), the gradient of
    ``anchor``, a leaf of that block's shape that autograd differentiates
    in the parameters' place (the two placements differ in ``"tp"``
    mode)."""

    @staticmethod
    def forward(ctx, data, anchor, block):
        ctx.block = block
        out = block.sharding.gather(data)
        return out.view_as(out) if out is data else out

    @staticmethod
    def backward(ctx, g):
        b = ctx.block
        return None, reduce_to(g, b.grad_sharding, *b.reduce_over), None


class TrainBlock(Block):
    """A :class:`Block` whose gather is differentiable.  ``anchor`` holds
    one leaf per layer (nested as the stack dims; a tensor where the leaf
    has none) of the shape of its block under ``grad_sharding``; the
    backward of :meth:`whole` lands the layer's gradient there, reduced
    over ``reduce_over`` = (mesh, batch axes, batch ranks) as it is
    produced."""

    def __init__(self, data, sharding, anchor, grad_sharding, reduce_over):
        super().__init__(data, sharding)
        self.anchor, self.grad_sharding, self.reduce_over = anchor, grad_sharding, reduce_over

    def __getitem__(self, i) -> TrainBlock:
        return TrainBlock(self.data[i], self.sharding.sub(1), self.anchor[i],
                          self.grad_sharding.sub(1), self.reduce_over)

    def whole(self) -> torch.Tensor:
        return _GatherLayer.apply(self.data, self.anchor, self)


def sharded_tree(tree, shardings):
    """Each leaf (this rank's block) as a :class:`Block` of its sharding."""
    return _zip_map(Block, tree, shardings)


class Partition:
    """One rank's part of a serve step on a mesh.  ``rows`` is the
    partition-spec entry that splits the batch (``None``, an axis, or a
    tuple of axes): the rank computes its block of rows.  ``cache_sh`` (a
    decode step) lays out its blocks of the cache: the KV sequence split
    over "model", the recurrent states by heads or ``Di``.  The model code
    calls the methods below to join the parts."""

    def __init__(self, mesh, rows, cache_sh=None):
        sizes = axis_sizes(mesh)
        self.mesh, self.rows, self.cache_sh = mesh, rows, cache_sh
        self.n_rows = 1
        for a in _axes(rows):
            self.n_rows *= sizes[a]

    def _rows_sh(self, x) -> NamedSharding:
        return NamedSharding(self.mesh, P(self.rows, *([None] * (x.dim() - 1))))

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (dim 0), in order."""
        return self._rows_sh(x).gather(x)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole batch's ``x``."""
        return self._rows_sh(x).local(x)

    def kv_slice(self, name: str, length: int) -> tuple[int, int]:
        """(the first position, the number of slices) of this rank's slice
        of cache leaf ``name``'s sequence dim (dim 2), ``length`` long."""
        idx, count = self.cache_sh[name]._block(2)
        return idx * length, count

    def kv_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` (contiguous; written in place and returned) reduced ("max"
        or "sum") over the "model" ranks, which hold the slices of the KV
        sequence."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.mesh.get_group("model"))
        return x

    def state(self, name: str, x: torch.Tensor, lead: int) -> torch.Tensor:
        """One layer's recurrent state ``x`` (cache leaf ``name`` with
        ``lead`` stack dims indexed away) gathered over "model"; its rows
        stay this rank's."""
        return self.cache_sh[name].sub(lead).over("model").gather(x)

    def keep(self, name: str, x: torch.Tensor, lead: int) -> torch.Tensor:
        """This rank's block of a whole state from :meth:`state`."""
        return self.cache_sh[name].sub(lead).over("model").local(x)
