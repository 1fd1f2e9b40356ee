"""Compressed checkpoints of torch state (port of ``repro.ckpt.checkpoint``).

Layout mirrors CubismZ: **one file per quantity** (each top-level key of the
state: ``"params"``, ``"m"``, ``"v"``, ...), the concatenation of per-shard
compressed buffers whose offsets come from an exclusive prefix sum over the
compressed sizes (``repro_torch.dist.offsets``, the MPI_Exscan analogue; the
shards are written by one process, the offsets are the collective's).

Codec: lossless ``fpzipx`` + byte shuffle + zlib by default (the paper's
restart-snapshot scheme); optionally a lossy scheme.  Every quantity file
carries per-shard CRC32; the commit is atomic (write ``step_XXXXXXXX.tmp``,
fsync, rename); ``latest`` resolves to the newest *complete* checkpoint.
Files and manifests are the reference's bytes, so either package restores
the other's checkpoints.

The state is a nest of dicts, lists and tuples (an ``nn.Module.state_dict()``
is an ``OrderedDict``) over tensors on any device, numpy arrays and Python
scalars.  Its leaves are keyed and ordered as JAX's ``tree_flatten_with_path``
orders them (:func:`_flatten`), since the order sets each leaf's offsets.
Stage 1 of every float32 leaf runs on the torch ``device``.
"""
from __future__ import annotations

import collections
import json
import os
import shutil
import zlib

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.pipeline import CompressedField, CompressionSpec, Pipeline
from repro_torch.core.schemes import torch_device
from repro_torch.dist.offsets import exclusive_offsets_np
from repro_torch.obs import trace

__all__ = ["Checkpointer", "FieldSnapshotter", "save_checkpoint",
           "load_checkpoint", "latest_step", "restore_tree"]

_BS = 16                      # codec block side for flattened tensors
_BLOCK = _BS ** 3


def _children(node):
    """``(key, child)`` pairs of an inner node in JAX's order, or ``None`` for
    a leaf.  A plain dict is walked in sorted key order, an ``OrderedDict`` in
    insertion order; a namedtuple's fields are keyed ``.name``, a list's or
    tuple's items ``[i]``."""
    if isinstance(node, collections.OrderedDict):
        return list(node.items())
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", v) for f, v in zip(node._fields, node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten(state, path: tuple = ()) -> list[tuple[str, object]]:
    """``(key, leaf)`` for every leaf of ``state``, keys ``a/[1]/b`` as the
    reference's ``_leaf_key`` gives them; ``None`` is no leaf.  A dict key
    that is no string (an optimizer's ``state_dict()`` keys its parameters
    by index) is sorted as itself and written as ``str(key)``, where the
    reference raises."""
    if state is None:
        return []
    kids = _children(state)
    if kids is None:
        return [("/".join(map(str, path)), state)]
    return [item for k, v in kids for item in _flatten(v, path + (k,))]


def _to_blocks(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Flatten to (nb, 16,16,16) float32 blocks (zero-padded) on ``x``'s
    device; returns the blocks and the pad."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, _BS, _BS, _BS), pad


def _compress_leaf(leaf, pipe: Pipeline, n_shards: int):
    """Returns (shard bytes, meta, shape, dtype name, raw bytes).  A float32
    tensor stays on its device; other leaves are stored as the numpy array
    the reference stores (bfloat16, which numpy lacks, as its bits)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            bits = leaf.cpu().contiguous().view(torch.int16).numpy()
            return ([zlib.compress(bits.tobytes(), 1)],
                    {"codec": "raw+zlib", "dtype": "bfloat16"},
                    list(leaf.shape), "bfloat16", bits.nbytes)
    if not (isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32):
        arr = leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if arr.dtype != np.float32:
            return ([zlib.compress(arr.tobytes(), 1)],
                    {"codec": "raw+zlib", "dtype": str(arr.dtype)},
                    list(arr.shape), str(arr.dtype), arr.nbytes)
        leaf = torch.from_numpy(np.array(arr))  # a writable contiguous copy
    blocks, pad = _to_blocks(leaf)
    nb = blocks.shape[0]
    per = max(1, nb // n_shards)
    shards = []
    for lo in range(0, nb, per):
        comp = pipe.compress_blocks(blocks[lo: lo + per])
        shards.append(json.dumps(comp.header).encode() + b"\0" + b"".join(comp.chunks))
    return (shards, {"codec": pipe.spec.scheme, "pad": pad, "dtype": "float32"},
            list(leaf.shape), "float32", leaf.numel() * 4)


def _decompress_leaf(shard_bufs: list[bytes], meta: dict, shape, dtype,
                     device: torch.device) -> torch.Tensor:
    if meta["codec"] == "raw+zlib":
        raw = zlib.decompress(shard_bufs[0])
        if meta["dtype"] == "bfloat16":
            bits = torch.from_numpy(np.frombuffer(raw, np.int16).copy())
            return bits.view(torch.bfloat16).reshape(shape).to(device)
        arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(shape).copy()
        return torch.from_numpy(arr).to(device)
    blocks = []
    for buf in shard_bufs:
        hdr, rest = buf.split(b"\0", 1)
        header = json.loads(hdr)
        chunks, off = [], 0
        for sz in header["chunk_sizes"]:
            chunks.append(rest[off: off + sz])
            off += sz
        comp = CompressedField(chunks, header)
        # registry-driven decode; header["format"] keeps pre-v2 shards readable
        blocks.append(Pipeline(comp.spec, device=device).decompress_blocks(comp))
    n = int(np.prod(shape)) if shape else 1
    flat = np.concatenate(blocks).reshape(-1)[:n]
    return torch.from_numpy(flat.astype(np.dtype(dtype)).reshape(shape)).to(device)


def _fsync_write(path: str, bufs) -> None:
    with open(path, "wb") as f:
        for b in bufs:
            f.write(b)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(ckpt_dir: str, state, step: int, *,
                    spec: CompressionSpec | None = None, n_shards: int = 8,
                    device=DEFAULT_DEVICE) -> dict:
    """Write one compressed checkpoint; returns manifest (incl. CR stats).

    Stage 1 of the float32 leaves runs on ``device``; the manifest's spec
    records where (``"host"`` for the default fpzipx, which has no kernel)."""
    spec = spec or CompressionSpec(scheme="fpzipx", precision=32,
                                   block_size=_BS, shuffle="byte")
    pipe = Pipeline(spec, device=device)
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)

    quantities: dict[str, list] = {}
    for key, leaf in _flatten(state):
        quantities.setdefault(key.split("/", 1)[0], []).append((key, leaf))

    manifest = {"step": step, "spec": pipe.spec.to_json(), "quantities": {},
                "raw_bytes": 0, "compressed_bytes": 0}
    for qty, items in quantities.items():
        entries = []
        bufs = []
        for key, leaf in items:
            shards, meta, shape, dtype, nbytes = _compress_leaf(leaf, pipe, n_shards)
            sizes = [len(s) for s in shards]
            # exclusive prefix-sum offsets (the paper's parallel-write scheme)
            base = sum(len(b) for b in bufs)
            offsets = (exclusive_offsets_np(sizes) + base).tolist()
            entries.append({
                "key": key, "shape": shape, "dtype": dtype,
                "meta": meta, "offsets": offsets, "sizes": sizes,
                "crc32": [zlib.crc32(s) & 0xFFFFFFFF for s in shards],
            })
            bufs.extend(shards)
            manifest["raw_bytes"] += nbytes
            manifest["compressed_bytes"] += sum(sizes)
        _fsync_write(os.path.join(tmp, f"{qty}.czq"), bufs)
        manifest["quantities"][qty] = entries
    manifest["cr"] = manifest["raw_bytes"] / max(1, manifest["compressed_bytes"])
    _fsync_write(os.path.join(tmp, "manifest.json"), [json.dumps(manifest).encode()])
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    return manifest


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name[5:]))
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int | None = None, device=DEFAULT_DEVICE):
    """Returns (flat dict key -> tensor on ``device``, manifest).  Elastic:
    the state is whole on one device; the caller reshards it as the *new*
    fleet needs."""
    dev = torch_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for qty, entries in manifest["quantities"].items():
        with open(os.path.join(d, f"{qty}.czq"), "rb") as f:
            blob = f.read()
        for e in entries:
            shards = []
            for off, sz, crc in zip(e["offsets"], e["sizes"], e["crc32"]):
                buf = blob[off: off + sz]
                if (zlib.crc32(buf) & 0xFFFFFFFF) != crc:
                    raise IOError(f"CRC mismatch in {qty}:{e['key']} shard")
                shards.append(buf)
            out[e["key"]] = _decompress_leaf(shards, e["meta"], tuple(e["shape"]),
                                             e["dtype"], dev)
    return out, manifest


def restore_tree(template, flat: dict):
    """Rebuild a nest matching ``template`` from the flat key -> tensor dict.
    A leaf takes the template leaf's dtype (and device, for a tensor; a numpy
    template leaf gets a numpy array); a scalar template leaf gets the tensor."""
    def one(path: tuple, leaf):
        kids = _children(leaf)
        if kids is not None:
            vals = [one(path + (k,), v) for k, v in kids]
            if isinstance(leaf, dict):
                out = leaf.copy()  # keeps the dict's type and default factory
                out.update((k, v) for (k, _), v in zip(kids, vals))
                return out
            if hasattr(leaf, "_fields"):
                return type(leaf)(*vals)
            return type(leaf)(vals)
        if leaf is None:
            return None
        arr = flat["/".join(map(str, path))]
        if isinstance(leaf, torch.Tensor):
            return arr.to(device=leaf.device, dtype=leaf.dtype)
        if hasattr(leaf, "dtype"):
            return arr.cpu().numpy().astype(leaf.dtype)
        return arr

    return one((), template)


class FieldSnapshotter:
    """Dataset-backed snapshot path for *field* state (simulation restart).

    Training state goes through :class:`Checkpointer`; 3D solver state (the
    paper's in-situ restart snapshots) goes into one append-mode
    :class:`repro_torch.store.CZDataset` on ``device``: every snapshot is a
    committed timestep of all quantities, so restart data gets the store's
    atomic manifest, random-access region reads and concurrent chunk
    encoding.

    With a ``torch.distributed`` process group (``group=``, gloo), the
    snapshots are the paper's in-situ ones over ranks: every rank of the
    group opens the snapshotter on the same directory and calls
    :meth:`maybe_snapshot` at the same steps with its own slab of each
    quantity, a tensor on its own device.  Each snapshot's member of a
    quantity holds the global field, the slabs stacked along axis 0 in
    rank order, in one file that every rank writes at its Exscan offset;
    rank 0 commits the timestep once every rank's bytes are in (see
    :class:`repro_torch.store.CZDataset`).  A rank that fails makes every
    rank raise.
    """

    def __init__(self, ds_dir: str, every: int = 1,
                 spec: CompressionSpec | None = None, workers: int = 1,
                 device=DEFAULT_DEVICE, group=None):
        from repro_torch.store import CZDataset

        self.every = every
        self.ds = CZDataset(ds_dir, mode="a",
                            spec=spec or CompressionSpec(scheme="fpzipx",
                                                         shuffle="byte"),
                            workers=workers, device=device, group=group)
        self._steps: dict[int, int] = {  # sim step -> dataset timestep
            int(ts["time"]): ts["t"]
            for q in self.ds.quantities
            for ts in self.ds.timestep_info(q)
            if ts["time"] is not None
        }

    def maybe_snapshot(self, fields: dict, step: int,
                       force: bool = False) -> int | None:
        """Append one snapshot every ``every`` steps; returns its timestep.

        The whole call is the trace span ``snapshot``.  A tensor field is
        handed on where it lies, never copied to the host: stage 1 reads it
        on the dataset's device (a tensor on another device moves there
        once, counted at ``pipeline.to_device``), and it is never written
        to.  The simulation step is recorded as the timestep's ``time`` tag,
        so :meth:`restore` can resolve "latest" or an exact step after
        reopen.
        """
        if not force and (self.every <= 0 or step % self.every != 0):
            return None
        with trace.span("snapshot", step=step):
            t = self.ds.append({q: f.detach() if isinstance(f, torch.Tensor) else f
                                for q, f in fields.items()}, time=float(step))
            self._steps[step] = t
        return t

    def restore(self, step: int | None = None):
        """Returns (fields dict, step) for ``step`` (default: latest); or
        (None, None) on an empty dataset."""
        if not self._steps:
            return None, None
        step = max(self._steps) if step is None else step
        t = self._steps[step]
        fields = {q: self.ds.read_field(q, t) for q in self.ds.quantities
                  if t in self.ds.timesteps(q)}
        return fields, step

    def close(self):
        self.ds.close()


class Checkpointer:
    """Periodic checkpoint manager with retention and resume support."""

    def __init__(self, ckpt_dir: str, every: int = 100, keep: int = 3,
                 spec: CompressionSpec | None = None, device=DEFAULT_DEVICE):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self.spec = spec
        self.device = torch_device(device)
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, state, step: int, force: bool = False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return None
        manifest = save_checkpoint(self.dir, state, step, spec=self.spec,
                                   device=self.device)
        self._gc()
        return manifest

    def _gc(self):
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def resume(self, template):
        step = latest_step(self.dir)
        if step is None:
            return None, None
        flat, _manifest = load_checkpoint(self.dir, step, device=self.device)
        return restore_tree(template, flat), step
