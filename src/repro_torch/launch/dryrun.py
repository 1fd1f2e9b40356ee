"""Multi-pod dry run: count every (arch x shape x mesh) cell (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder devices and
reads XLA's memory and cost analyses.  The port compiles nothing: it runs
one rank's step once, under ``FakeTensorMode`` and the op counter of
:mod:`repro_torch.launch.hlo_analysis`, in a world of ``prod(mesh)``
ranks on torch's ``fake`` backend (one process; every collective returns
at once).  Nothing is allocated: the state, the batch and every
intermediate are fake tensors of the ``--device``'s type.  Rank 0's
counts stand for every device's: the port gathers at use, so the "model"
ranks compute the same rows (ROADMAP §3).

Each cell writes ``<out>/<arch>__<shape>__<mesh>[__tag].json`` with the
reference's keys in its order.  What stands in for XLA's numbers:

* ``memory.argument_bytes`` — the rank's blocks of the state and batch
  (params and cache for serving), exactly as the shardings cut them;
  ``output_bytes`` the step's results; ``temp_bytes`` the peak of the live
  storages less the arguments; ``alias_bytes`` the results written into
  the arguments (the donated decode cache); ``generated_code_bytes`` 0;
* ``time_lower_s`` the counted run's seconds, ``time_compile_s`` null;
* ``flops_per_device``, ``bytes_accessed_per_device`` and
  ``transcendentals`` the counter's totals (``hbm_bytes`` for the bytes);
* ``collectives`` and ``loop_aware`` both hold the counter's values: every
  call is counted, loop bodies included, so there is no separate
  loop-blind count (``unknown_trip_whiles`` is 0).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--skip-existing] [--mesh both]
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k --device cpu

Importing this module starts no process group and sets no environment
variable.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, cell_applicable
from repro_torch.core.schemes import torch_device
from repro_torch.launch.hlo_analysis import HloStats, OpCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ModelSettings, count_params, input_batch_specs, param_specs
from repro_torch.models.costs import detailed_flops, model_flops
from repro_torch.serve.step import build_decode_step, build_prefill_step
from repro_torch.train.sharding import batch_shardings, cache_shardings, param_shardings
from repro_torch.train.optim import OptConfig
from repro_torch.train.step import build_train_step, train_state_specs

__all__ = ["CellCount", "count_cell", "lower_cell", "main"]

_PARAM_DTYPES = {"f32": None, "bf16": torch.bfloat16}


@dataclasses.dataclass
class CellCount:
    """One rank's step of a cell, counted (every byte count per device)."""
    stats: HloStats
    seconds: float              # the counted run
    argument_bytes: int         # the rank's blocks of the step's inputs
    output_bytes: int
    alias_bytes: int            # results written into the inputs' storage
    peak_bytes: int             # the inputs + the peak of what the step allocated
    micro_batches: int


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


def _storage_bytes(tree) -> dict[int, int]:
    """id -> bytes of each storage that ``tree``'s tensors use, once."""
    out = {}
    for t in _leaves(tree):
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def _blocks(specs, shardings, device):
    """A tensor of this rank's block shape for every leaf of ``specs``
    (``meta`` tensors), cut as ``shardings`` cut it."""
    if isinstance(specs, dict):
        return {k: _blocks(v, shardings[k], device) for k, v in specs.items()}
    return torch.empty(shardings.shard_shape(specs.shape), dtype=specs.dtype, device=device)


def count_cell(cfg, shape, mesh, settings: ModelSettings = ModelSettings(), *,
               sharding: str = "fsdp", param_dtype=None, grad_compress=None,
               micro: int = 0, opt: OptConfig = OptConfig()) -> CellCount:
    """Builds ``shape``'s step for ``cfg`` on ``mesh`` as the reference's
    dry run does (train with ``donate=False``, decode with
    ``donate_cache=True``) and runs this rank's step once under
    ``FakeTensorMode`` and an :class:`OpCounter`, on fake blocks of the
    state and batch on the mesh's device type.  ``micro`` 0 takes the
    reference's default; ``opt`` is the train step's optimizer."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = torch.device(mesh.device_type)
    micro = (micro or (4 if cfg.d_model >= 4096 else 1)) if shape.kind == "train" else 1
    hybrid = cfg.family == "hybrid"
    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape.kind == "train":
            batch_specs = input_batch_specs(cfg, shape)
            _, jit_for, state_sh = build_train_step(
                cfg, mesh, settings=settings, opt=opt, grad_compress=grad_compress,
                donate=False, micro_batches=micro, sharding_mode=sharding,
                param_dtype=param_dtype)
            step = jit_for(batch_specs)
            args = (_blocks(train_state_specs(cfg, grad_compress=grad_compress,
                                              param_dtype=param_dtype), state_sh, dev),
                    _blocks(batch_specs, batch_shardings(batch_specs, mesh), dev))
        elif shape.kind == "prefill":
            pspecs, batch_specs = param_specs(cfg), input_batch_specs(cfg, shape)
            _, jit_for = build_prefill_step(cfg, mesh, settings=settings)
            step, _ = jit_for(pspecs, batch_specs)
            batch = _blocks(batch_specs, batch_shardings(batch_specs, mesh), dev)
            args = (_blocks(pspecs, param_shardings(pspecs, mesh, hybrid=hybrid), dev),
                    batch["tokens"], *([batch["frames"]] if "frames" in batch else []))
        else:
            pspecs, dspecs = param_specs(cfg), input_batch_specs(cfg, shape)
            _, jit_for = build_decode_step(cfg, mesh, settings=settings, donate_cache=True)
            step = jit_for(pspecs, dspecs["cache"], dspecs["token"])
            args = (_blocks(pspecs, param_shardings(pspecs, mesh, hybrid=hybrid), dev),
                    _blocks(dspecs["cache"], cache_shardings(dspecs["cache"], mesh), dev),
                    _blocks(dspecs["token"], batch_shardings(dspecs["token"], mesh), dev),
                    shape.seq_len - 1)
        inputs = _storage_bytes(args)
        counter = OpCounter()
        t0 = time.perf_counter()
        with counter:
            out = step(*args)
        seconds = time.perf_counter() - t0
        outputs = _storage_bytes(out)
    argument_bytes = sum(inputs.values())
    return CellCount(stats=counter.stats, seconds=seconds, argument_bytes=argument_bytes,
                     output_bytes=sum(outputs.values()),
                     alias_bytes=sum(n for k, n in outputs.items() if k in inputs),
                     peak_bytes=argument_bytes + counter.peak_bytes, micro_batches=micro)


def _settings(args) -> ModelSettings:
    return ModelSettings(attn_impl=args.attn_impl, q_chunk=args.q_chunk,
                         kv_chunk=args.kv_chunk, remat=args.remat,
                         act_shard=args.act_shard, rwkv_chunk=args.rwkv_chunk,
                         attn_shard=args.attn_shard)


def _start_fake_world(n: int) -> None:
    """A world of ``n`` ranks on the ``fake`` backend, this process rank 0."""
    # the module registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts a fake world of its own for each cell; a "
                           "process group is already initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def lower_cell(arch_name: str, shape_name: str, mesh_kind: str, args):
    """The reference's cell result for one (arch, shape, mesh) on the
    production mesh, counted by :func:`count_cell` in a fake world of its
    own, ended before it returns."""
    cfg = ARCHS[arch_name]
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
                "applicable": False, "skip_reason": reason}

    multi = mesh_kind == "multi"
    st = _settings(args)
    _start_fake_world(math.prod((2, 16, 16) if multi else (16, 16)))
    try:
        mesh = make_production_mesh(multi_pod=multi, device=args.device)
        c = count_cell(cfg, shape, mesh, st, sharding=args.sharding,
                       param_dtype=_PARAM_DTYPES[args.param_dtype],
                       grad_compress=args.grad_compress or None, micro=args.micro)
        n_devices = mesh.size()
    finally:
        dist.destroy_process_group()
    la = c.stats
    temp = c.peak_bytes - c.argument_bytes
    af = detailed_flops(cfg, shape, attn_impl=st.attn_impl, remat=st.remat)

    result = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
        "applicable": True,
        "n_devices": n_devices,
        "attn_impl": st.attn_impl,
        "remat": st.remat,
        "act_shard": st.act_shard,
        "sharding_mode": args.sharding,
        "param_dtype": args.param_dtype,
        "grad_compress": args.grad_compress or None,
        "micro_batches": c.micro_batches,
        "time_lower_s": c.seconds,
        "time_compile_s": None,
        "flops_per_device": la.flops,
        "bytes_accessed_per_device": la.hbm_bytes,
        "transcendentals": la.transcendentals,
        "memory": {
            "argument_bytes": c.argument_bytes,
            "output_bytes": c.output_bytes,
            "temp_bytes": temp,
            "alias_bytes": c.alias_bytes,
            "generated_code_bytes": 0,
        },
        "collectives": la.collectives,
        "collective_bytes_per_device": la.collective_bytes,
        "loop_aware": {
            "flops_per_device": la.flops,
            "hbm_bytes_per_device": la.hbm_bytes,
            "hbm_bytes_fused_per_device": la.hbm_bytes_fused,
            "attn_score_bytes_per_device": la.attn_score_bytes,
            "collectives": la.collectives,
            "collective_bytes_per_device": la.collective_bytes,
            "unknown_trip_whiles": la.unknown_trip_whiles,
        },
        "analytic": af,
        "model_flops": model_flops(cfg, shape),
        "params_total": count_params(cfg),
        "params_active": count_params(cfg, active_only=True),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    # the reference's prove-it-fits line, from the counted run
    print(f"  memory_analysis: arg={c.argument_bytes/2**30:.3f}GiB "
          f"temp={temp/2**30:.3f}GiB "
          f"out={c.output_bytes/2**30:.3f}GiB per device")
    print(f"  cost_analysis: flops={la.flops:.3e} "
          f"bytes={la.hbm_bytes:.3e} per device")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--attn-impl", default="masked",
                    choices=["masked", "triangular"])
    ap.add_argument("--q-chunk", type=int, default=256)
    ap.add_argument("--kv-chunk", type=int, default=512)
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--micro", type=int, default=0,
                    help="microbatch count for train cells (0 = per-arch default)")
    ap.add_argument("--act-shard", default="seq", choices=["none", "seq", "hidden"])
    ap.add_argument("--rwkv-chunk", type=int, default=0)
    ap.add_argument("--sharding", default="fsdp", choices=["fsdp", "tp"])
    ap.add_argument("--param-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--attn-shard", default="auto",
                    choices=["auto", "replicate", "heads", "cp"])
    ap.add_argument("--grad-compress", default="",
                    help="e.g. topk32 — cross-pod EF-compressed reduction (multi mesh)")
    ap.add_argument("--device", default="cuda",
                    help="the device type of the fake tensors (default: the card); "
                         "nothing is allocated on it")
    args = ap.parse_args(argv)
    torch_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                path = os.path.join(args.out, f"{arch}__{shape}__{mesh_kind}{tag}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {path}")
                    continue
                print(f"[cell] {arch} x {shape} x {mesh_kind}", flush=True)
                try:
                    res = lower_cell(arch, shape, mesh_kind, args)
                except Exception as e:  # noqa: BLE001 - record and continue
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "applicable": True, "error": f"{type(e).__name__}: {e}"}
                    failures.append((arch, shape, mesh_kind, str(e)))
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", f_)
        raise SystemExit(1)
    print("\nall requested cells counted OK")


if __name__ == "__main__":
    main()
