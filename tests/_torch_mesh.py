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
    reduced smollm's params, cache and tokens, and ``fn`` on the whole
    trees; writes both logits (``decode{i}/got`` and ``want``,
    ``prefill/...``), this rank's cache block and ``fn``'s cache cut to it
    (``decode{i}/cache/{leaf}/...``), and whether the step wrote the cache
    block in place (``decode{i}/in_place``)."""
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
        local_params = local_tree(params, param_shardings(params, mesh))
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
                                .astype(np.int32))
        whole = T.cache_spec(cfg, 2, 8, dtype=torch.float32, mode="zeros", device="cpu")
        fn, jit_for = build_decode_step(cfg, mesh, settings=st)
        step = jit_for(params, whole, toks[:, :1])
        cache_sh = cache_shardings(whole, mesh)
        cache = {k: v.clone() for k, v in local_tree(whole, cache_sh).items()}
        token_sh = batch_shardings(toks[:, :1], mesh)
        out = {}
        for i in range(3):
            want, whole = fn(params, whole, toks[:, i:i + 1], i)
            got, new = step(local_params, cache, token_sh.local(toks[:, i:i + 1]), i)
            out[f"decode{i}/got"], out[f"decode{i}/want"] = got.numpy(), want.numpy()
            out[f"decode{i}/in_place"] = np.array(all(new[k] is cache[k] for k in whole))
            for k in whole:
                out[f"decode{i}/cache/{k}/got"] = new[k].numpy().copy()
                out[f"decode{i}/cache/{k}/want"] = cache_sh[k].local(whole[k]).numpy().copy()
        pfn, pjit = build_prefill_step(cfg, mesh, settings=st)
        pstep, nargs = pjit(params, {"tokens": toks})
        rows = batch_shardings({"tokens": toks}, mesh)["tokens"].local(toks)
        assert nargs == 2
        out["prefill/got"] = pstep(local_params, rows).numpy()
        out["prefill/want"] = pfn(params, toks).numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


#: the meshes of the partitioned serve tests: the KV sequence (and the
#: parameters, the states' heads or Di) split over "model"; the rows over
#: "data"
SERVE_MESHES = {"model2": (1, 2), "data2": (2, 1)}


def partitioned_rank(rank, world, init_file, out_dir, arch, params, cache, toks, frames,
                     positions):
    """The reduced ``arch``'s serve builders on each of ``SERVE_MESHES``,
    through ``jit_for`` on this rank's blocks of the reference's weights
    ``params`` (numpy): prefill of ``toks`` (and ``frames``), and one
    decode step from the cache ``cache`` (numpy, whole) at each of
    ``positions``, each from a fresh copy; writes the logits
    (``{mesh}/prefill``, ``{mesh}/pos{p}/logits``) and this rank's cache
    block after each step (``{mesh}/pos{p}/cache/{leaf}``)."""
    import repro_torch.configs as tconfigs
    import repro_torch.models as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import from_reference
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    from repro_torch.train.sharding import (batch_shardings, cache_shardings, local_tree,
                                            param_shardings)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        cfg = tconfigs.reduced(tconfigs.ARCHS[arch])
        st = T.ModelSettings(q_chunk=16, kv_chunk=16, remat="none", compute_dtype=torch.float32)
        whole_params = from_reference(params, device="cpu")
        whole_cache = from_reference(cache, device="cpu")
        batch = {"tokens": torch.from_numpy(toks)}
        if frames is not None:
            batch["frames"] = torch.from_numpy(frames)
        token = batch["tokens"][:, :1]
        out = {}
        for tag, shape in SERVE_MESHES.items():
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            local = local_tree(whole_params, param_shardings(
                whole_params, mesh, hybrid=(cfg.family == "hybrid")))
            _, pjit = build_prefill_step(cfg, mesh, settings=st)
            pstep, nargs = pjit(whole_params, batch)
            rows = local_tree(batch, batch_shardings(batch, mesh))
            out[f"{tag}/prefill"] = pstep(local, *(rows[k] for k in ("tokens", "frames")
                                                   if k in rows)).numpy()
            _, djit = build_decode_step(cfg, mesh, settings=st)
            step = djit(whole_params, whole_cache, token)
            cache_sh = cache_shardings(whole_cache, mesh)
            tok = batch_shardings(token, mesh).local(token)
            for pos in positions:
                blocks = {k: v.clone() for k, v in local_tree(whole_cache, cache_sh).items()}
                logits, new = step(local, blocks, tok, pos)
                out[f"{tag}/pos{pos}/logits"] = logits.numpy()
                for k, v in new.items():
                    out[f"{tag}/pos{pos}/cache/{k}"] = v.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def grads_rank(rank, world, init_file, out_dir, arch, params, batch, meshes, remat):
    """The reduced ``arch``'s loss gradients on each mesh of ``meshes``
    ({tag: shape} over ("data", "model")): this rank's blocks of the
    reference's weights ``params`` (numpy) and rows of ``batch``, through
    ``train.step._block_value_and_grad`` (one layer gathered at a time,
    each layer's grads reduced into the moments' blocks in the backward);
    writes the loss and metrics averaged over the batch ranks
    (``{tag}/loss``, ``{tag}/metric/{k}``), the grads' blocks
    (``{tag}/grad/{path}``) and their specs (``{tag}/spec/{path}``)."""
    import json

    import repro_torch.configs as tconfigs
    from repro_torch.launch.mesh import axis_sizes, batch_axes, make_mesh
    from repro_torch.models import ModelSettings
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.convert import from_reference
    from repro_torch.train import step
    from repro_torch.train.sharding import batch_shardings, local_tree

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        cfg = tconfigs.reduced(tconfigs.ARCHS[arch])
        st = ModelSettings(**dict(SETTINGS, remat=remat), compute_dtype=torch.float32)
        whole = from_reference(params, device="cpu")
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        out = {}
        for tag, shape in meshes.items():
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            sizes = axis_sizes(mesh)
            baxes = batch_axes(mesh)
            nb = int(np.prod([sizes[a] for a in baxes]))
            state_sh = step.train_state_shardings(cfg, mesh)
            blocks = local_tree(whole, state_sh["params"])
            rows = local_tree(tbatch, batch_shardings(tbatch, mesh))
            loss, metrics, grads = step._block_value_and_grad(
                blocks, rows, cfg, st, state_sh["params"], state_sh["m"], (mesh, baxes, nb))
            out[f"{tag}/loss"] = step._mean(loss, mesh, baxes).numpy()
            for k, v in metrics.items():
                out[f"{tag}/metric/{k}"] = step._mean(v, mesh, baxes).numpy()
            for (path, g), (_, sh) in zip(tree_leaves(grads), tree_leaves(state_sh["m"])):
                out[f"{tag}/grad/{'/'.join(path)}"] = g.numpy()
                out[f"{tag}/spec/{'/'.join(path)}"] = np.array(json.dumps(list(sh.spec)))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def compress_rank(rank, world, init_file, out_dir, shape, grads, resid, consts, method,
                  hybrid):
    """``grad_compress.compress_blocks`` on mesh ``shape`` ("pod", "data",
    "model") with the module's constants set to ``consts``, on given per-pod
    gradients and residuals (``grads[p]``, ``resid[p]``: flat dicts of whole
    numpy leaves): this rank's blocks of its pod's leaves in, laid out by
    the parameters' placement rule (``param_shardings``, ``hybrid``); the
    same on the whole leaves (the whole path).  Writes the block results
    (``block/{g,r}/{leaf}``), the whole results (``whole/{g,r}/{leaf}``),
    each leaf's pod exchanges (``exchanges/{leaf}``, ``_pod_gather`` calls
    counted while the leaf is compressed, for each path), its planned
    pieces and exchanges (``plan/{leaf}``) and the loss."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import grad_compress as gc
    from repro_torch.train.sharding import NamedSharding, P, param_shardings

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        for k, v in consts.items():
            setattr(gc, k, v)
        mesh = make_mesh(shape, ("pod", "data", "model"), device="cpu")
        pod = mesh.get_coordinate()[0]
        sh = param_shardings(grads[pod], mesh, hybrid=hybrid)
        whole_g = {k: torch.from_numpy(v) for k, v in grads[pod].items()}
        whole_r = {k: torch.from_numpy(v) for k, v in resid[pod].items()}
        blocks_g = {k: sh[k].local(v).clone() for k, v in whole_g.items()}
        blocks_r = {k: sh[k].local(v).clone() for k, v in whole_r.items()}
        counts, current = {}, [None]
        gather, leaf = gc._pod_gather, gc._compress_leaf

        def counted_gather(*args):
            counts[current[0]] = counts.get(current[0], 0) + 1
            return gather(*args)

        def named_leaf(g, r, s, *args):
            current[0] = (tag, order.pop(0))
            try:
                return leaf(g, r, s, *args)
            finally:
                current[0] = (tag, None)   # the loss and metrics after the leaves

        gc._pod_gather, gc._compress_leaf = counted_gather, named_leaf
        out = {}
        plan = gc.compress_plan(blocks_g, sh, method)
        for tag, g, r, shs in (
                ("block", blocks_g, blocks_r, sh),
                ("whole", whole_g, whole_r,
                 {k: NamedSharding(mesh, P(*[None] * v.dim())) for k, v in whole_g.items()})):
            order = list(g)
            (loss, _), new_g, new_r, cmx = gc.compress_blocks(
                torch.tensor(float(pod)), {}, g, r, shs, mesh, method)
            out[f"{tag}/loss"] = loss.numpy()
            for k in g:
                got_g, got_r = new_g[k], new_r[k]
                if tag == "whole":
                    got_g, got_r = sh[k].local(got_g), sh[k].local(got_r)
                out[f"{tag}/g/{k}"] = got_g.numpy()
                out[f"{tag}/r/{k}"] = got_r.numpy()
                out[f"exchanges/{tag}/{k}"] = np.array(counts.get((tag, k), 0))
            out[f"exchanges/{tag}/loss"] = np.array(counts.get((tag, None), 0))
        for (path, p) in plan.items():
            out[f"plan/{path[0]}"] = np.array(
                [1 if p.tiny else len(p.batches), len(p.pieces),
                 max((q.elements for q in p.pieces), default=0)])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
