"""Shared by the port's mesh tests (tests/test_torch_mesh_*.py,
tests/test_torch_grad_compress.py and the files that build a 1x1 mesh
in-process): a process group's lifetime, and the ranks spawned on gloo.

``repro_torch.launch.mesh.make_mesh`` starts a world of one process when
none exists, and that world lives as long as the process.  A test module
that builds meshes in-process ends the world it started, so that a module
run after it in the same worker (``tests/test_torch_dist.py`` starts its
own) finds none.

The rank functions run in ``torch.multiprocessing`` spawned processes on a
gloo group with a ``file://`` init, as tests/test_torch_dist.py's do.  This
module imports no JAX and nothing of the reference, so the children import
neither; each rank writes what it holds to ``rank{r}.npz``.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: the CPU tests' settings (tests/_torch_train.py's TST)
SETTINGS = dict(q_chunk=16, kv_chunk=16, ce_chunk=32, remat="none")
#: the reference train tests' optimizer (tests/test_torch_train_step.py's OPT)
OPT = dict(lr=1e-3, warmup_steps=20, total_steps=100)


@pytest.fixture(scope="module", autouse=True)
def end_the_world_it_started():
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args) -> list[dict]:
    """``fn(rank, world, init_file, out_dir, *args)`` in ``world`` spawned
    processes; their ``rank{r}.npz`` files, in rank order."""
    mp.spawn(fn, args=(world, str(tmp_path / "init"), str(tmp_path), *args), nprocs=world,
             join=True)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _flat(prefix, tree) -> dict:
    from repro_torch.models.common import tree_leaves

    return {f"{prefix}/{'/'.join(p)}": a.detach().cpu().numpy() for p, a in tree_leaves(tree)}


def step_rank(rank, world, init_file, out_dir, before, batch, shape, axes, kw, grads):
    """One train step of the reduced smollm on mesh ``shape``/``axes`` from
    the state ``before`` (the reference's, numpy): this rank's blocks of the
    state and rows of ``batch`` in, its blocks out (``after/``), its rows
    (``rows/``), the metrics (``metric/``), the gathered state
    (``whole/``), each block's spec (``spec/``, JSON) and, with ``grads``,
    this rank's own gradient of its rows (``grad/``)."""
    import json

    import repro_torch.configs as tconfigs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ModelSettings
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.convert import state_from_reference
    from repro_torch.train import optim, step
    from repro_torch.train.sharding import batch_shardings, gather_tree, local_tree

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        cfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
        st = ModelSettings(**SETTINGS, compute_dtype=torch.float32)
        mesh = make_mesh(shape, axes, device="cpu")
        _, jit_for, state_sh = step.build_train_step(
            cfg, mesh, settings=st, opt=optim.OptConfig(**OPT), donate=True, **kw)
        whole = {k: torch.from_numpy(v) for k, v in batch.items()}
        rows = local_tree(whole, batch_shardings(whole, mesh))
        # a block of its own per leaf (``local_tree`` gives views of the whole)
        state = tree_map(torch.clone, local_tree(state_from_reference(before, "cpu"),
                                                 state_sh))
        new, met = jit_for(whole)(state, rows)
        out = {**_flat("after", new), **_flat("rows", rows),
               **_flat("whole", gather_tree(new, state_sh)),
               **{f"metric/{k}": v.numpy() for k, v in met.items()},
               **{f"spec/{'/'.join(p)}": np.array(json.dumps(list(sh.spec)))
                  for p, sh in tree_leaves(state_sh)}}
        if grads:
            _, _, g = step._value_and_grad(state_from_reference(before, "cpu")["params"],
                                           rows, cfg, st)
            out.update(_flat("grad", g))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def unflatten(flat: dict, prefix: str) -> dict:
    """The tree under ``prefix/`` of a rank's (or the reference's) npz."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = tree, key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def serve_rank(rank, world, init_file, out_dir, shape):
    """The serve builders over mesh ``shape`` ("data", "model"): three decode
    steps and a prefill through ``jit_for`` on this rank's blocks of the
    reduced smollm's params, cache and tokens, against ``fn`` on the whole
    trees; writes whether the logits and the cache blocks are equal, bit
    for bit."""
    import repro_torch.configs as tconfigs
    import repro_torch.models as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    from repro_torch.train.sharding import (batch_shardings, cache_shardings, local_tree,
                                            param_shardings)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        cfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
        st = T.ModelSettings(q_chunk=16, kv_chunk=16, remat="none", compute_dtype=torch.float32)
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
                                .astype(np.int32))
        whole = T.cache_spec(cfg, 2, 8, dtype=torch.float32, mode="zeros", device="cpu")
        fn, jit_for = build_decode_step(cfg, mesh, settings=st)
        step = jit_for(params, whole, toks[:, :1])
        local_params = local_tree(params, param_shardings(params, mesh))
        cache_sh = cache_shardings(whole, mesh)
        cache = {k: v.clone() for k, v in local_tree(whole, cache_sh).items()}
        token_sh = batch_shardings(toks[:, :1], mesh)
        out = {}
        for i in range(3):
            want, whole = fn(params, whole, toks[:, i:i + 1], i)
            got, new = step(local_params, cache, token_sh.local(toks[:, i:i + 1]), i)
            out[f"decode{i}/logits"] = np.array(torch.equal(got, want))
            out[f"decode{i}/cache"] = np.array(all(
                new[k] is cache[k] and torch.equal(new[k], cache_sh[k].local(whole[k]))
                for k in whole))
        pfn, pjit = build_prefill_step(cfg, mesh, settings=st)
        pstep, nargs = pjit(params, {"tokens": toks})
        rows = batch_shardings({"tokens": toks}, mesh)["tokens"].local(toks)
        out["prefill"] = np.array(nargs == 2 and torch.equal(pstep(local_params, rows),
                                                            pfn(params, toks)))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
