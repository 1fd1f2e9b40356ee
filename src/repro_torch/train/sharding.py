"""Sharding rules: FSDP-style baseline (+ expert parallelism) for every arch
(port of ``repro.train.sharding``).

The rules are the reference's, leaf for leaf:

* every parameter is sharded along its largest "model"-divisible axis
  (ZeRO-3 semantics: the weights are gathered at use; avoids head-count
  divisibility hazards — qwen2.5 has 40 heads, smollm 9);
* expert-stacked leaves (``we*``) shard the expert axis when divisible
  (expert parallelism);
* scanned layer-stack axes (leading 1-2 dims of ``blocks`` leaves) are never
  sharded;
* activations/batches shard over ("pod","data");
* decode caches shard batch over "data" when divisible and the KV sequence
  axis over "model".

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

__all__ = ["param_shardings", "batch_shardings", "cache_shardings",
           "state_shardings", "path_str", "PartitionSpec", "NamedSharding"]


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
