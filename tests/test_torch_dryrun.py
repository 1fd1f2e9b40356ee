"""The port's dry run (``repro_torch.launch.dryrun``) on the production
meshes, 16x16 ("data", "model") and 2x16x16 ("pod", "data", "model"),
over worlds of 256 and 512 ranks on torch's ``fake`` backend (one
process, fake tensors: nothing is allocated).

Each cell's counts are held to what the port's own placements say
(``train/sharding.py``): the arguments are the rank's blocks, and every
collective's bytes are what the partitioned step moves: each layer's
parameters gathered inside the layer (again in a remat backward), each
layer's grads reduced to the moments' blocks, the batch means and the
clip's all-reduce; in decode the attention's log-sum-exp merge over
"model" (a MAX and a SUM a layer) and the logits' rows, in prefill the
logits' rows.  They cannot be held against the reference's HLO, which
GSPMD partitions its own way.  The flops are held against
``models.costs.detailed_flops``: a train step's per device times the
batch ranks within 15% of its total (the port's checkpoint reruns neither
the LM head nor a layer's last product, where the analytic count assumes
four full passes); prefill per device times the batch ranks within 1% of
the whole batch's (its head at the last position only), and decode's
within 1% of its rows' products plus its rows' attention over its slice
of the KV sequence.  Reduced dense configs (smollm-135m, qwen3-32b), B 2
per batch rank for train and 1 for serving, S 32 in 16-wide attention
chunks.  The peak of a deeper reduced config's train and decode cells on
a 4x4 mesh stays under the rank's blocks, two layers whole and the step's
activations.  Then the CLI at full width (smollm-135m, decode_32k, both
meshes): the reference's JSON keys in order, its lines, a peak under
80 GB, and a failing cell's exit 1.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import axis_sizes, batch_axes, make_production_mesh
from repro_torch.models import ModelSettings, input_batch_specs, lm_loss, param_specs
from repro_torch.models.common import tree_leaves
from repro_torch.models.costs import detailed_flops
from repro_torch.train import grad_compress as gc
from repro_torch.train.sharding import (_axes, batch_shardings, cache_shardings,
                                        param_shardings)
from repro_torch.train.step import (init_train_state, train_state_shardings,
                                    train_state_specs)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS_TESTED = ("smollm-135m", "qwen3-32b")
KINDS = ("train", "prefill", "decode")
MESHES = ("single", "multi")
S = 32
SETTINGS = ModelSettings(q_chunk=16, kv_chunk=16)
TRAIN_RTOL, SERVE_RTOL = 0.15, 0.01

#: the reference's result keys, in order (src/repro/launch/dryrun.py:139-182)
RESULT_KEYS = [
    "arch", "shape", "mesh", "kind", "applicable", "n_devices", "attn_impl", "remat",
    "act_shard", "sharding_mode", "param_dtype", "grad_compress", "micro_batches",
    "time_lower_s", "time_compile_s", "flops_per_device", "bytes_accessed_per_device",
    "transcendentals", "memory", "collectives", "collective_bytes_per_device",
    "loop_aware", "analytic", "model_flops", "params_total", "params_active", "seq_len",
    "global_batch"]
MEMORY_KEYS = ["argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "generated_code_bytes"]
LOOP_AWARE_KEYS = ["flops_per_device", "hbm_bytes_per_device",
                   "hbm_bytes_fused_per_device", "attn_score_bytes_per_device",
                   "collectives", "collective_bytes_per_device", "unknown_trip_whiles"]
COLLECTIVES = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"]


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _block_bytes(specs, shardings) -> int:
    return sum(_nbytes(sh.shard_shape(s.shape), s.dtype)
               for (_, s), (_, sh) in zip(tree_leaves(specs), tree_leaves(shardings)))


def _gather_bytes(specs, shardings, sizes, per_layer=None) -> tuple[int, int]:
    """(bytes, calls) of the all-gathers that make each leaf whole from its
    block: per split dim, each of its axes minor first, the tensor gathered
    so far times the axis.  With ``per_layer`` a stacked leaf (under
    "blocks", one stack dim: the dense configs) is gathered one layer's
    slice at a time, ``per_layer`` times a layer."""
    total = calls = 0
    for (path, s), (_, sh) in zip(tree_leaves(specs), tree_leaves(shardings)):
        shape, spec, times = list(sh.shard_shape(s.shape)), sh.spec, 1
        if per_layer and "blocks" in path and len(shape) > 1:
            shape, spec, times = shape[1:], spec[1:], per_layer * shape[0]
        for d, part in enumerate(spec):
            for a in reversed(_axes(part)):
                if sizes[a] > 1:
                    shape[d] *= sizes[a]
                    total += times * _nbytes(shape, s.dtype)
                    calls += times
    return total, calls


def _grad_reduce_bytes(specs, moment_sh, sizes, baxes) -> dict:
    """Per op, (bytes, calls) of taking each float32 grad, a stacked leaf's
    one layer at a time, to the moments' block: over each batch axis, a
    reduce-scatter where the axis splits a dim of the leaf, else an
    all-reduce of what is left."""
    out = {"all-reduce": [0, 0], "reduce-scatter": [0, 0]}
    for (path, s), (_, sh) in zip(tree_leaves(specs), tree_leaves(moment_sh)):
        split = {a for part in sh.spec for a in _axes(part)}
        layers = s.shape[0] if "blocks" in path and s.dim() > 1 else 1
        n = s.numel() // layers
        for a in baxes:
            if sizes[a] == 1:
                continue
            if a in split:
                n //= sizes[a]
                op = "reduce-scatter"
            else:
                op = "all-reduce"
            out[op][0] += 4 * n * layers
            out[op][1] += layers
    return out


def _rows_gather(shape, rows, sizes, dtype=torch.float32) -> tuple[int, int]:
    """(bytes, calls) of gathering a (B, ...) result's rows, split over the
    axes ``rows``, minor first."""
    shape, total, calls = list(shape), 0, 0
    n = math.prod(sizes[a] for a in rows)
    shape[0] //= n
    for a in reversed(rows):
        if sizes[a] > 1:
            shape[0] *= sizes[a]
            total += _nbytes(shape, dtype)
            calls += 1
    return total, calls


def _decode_flops(cfg, shape, n_rows, n_model) -> float:
    """A decode rank's flops: its rows' products, and its rows' attention
    over its slice of the KV sequence."""
    f = detailed_flops(cfg, shape, attn_impl=SETTINGS.attn_impl, remat=SETTINGS.remat)
    return f["matmul_fwd"] / n_rows + f["attn_fwd"] / (n_rows * n_model)


def _metrics(cfg) -> list:
    """The keys of ``lm_loss``'s metrics for ``cfg`` (a tiny real call)."""
    params = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")["params"]
    toks = torch.zeros((1, 8), dtype=torch.int32)
    return sorted(lm_loss(params, {"tokens": toks, "labels": toks}, cfg, SETTINGS)[1])


def _cell(cfg, kind, mesh, nb, **kw) -> dict:
    """The dry run's counts of one cell and what the shardings say of it."""
    sizes = axis_sizes(mesh)
    baxes = tuple(a for a in batch_axes(mesh) if sizes[a] > 1)
    shape = ShapeConfig("x", S, (2 if kind == "train" else 1) * nb, kind)
    c = dryrun.count_cell(cfg, shape, mesh, SETTINGS, **kw)
    hybrid = cfg.family == "hybrid"
    want = {op: [0, 0] for op in COLLECTIVES}

    def add(op, pair):
        want[op][0] += pair[0]
        want[op][1] += pair[1]

    batch = input_batch_specs(cfg, shape)
    if kind == "train":
        gcomp = kw.get("grad_compress")
        specs = train_state_specs(cfg, grad_compress=gcomp)
        state_sh = train_state_shardings(cfg, mesh, grad_compress=gcomp)
        args = _block_bytes(specs, state_sh) + _block_bytes(batch, batch_shardings(batch, mesh))
        scalars = 1 + len(_metrics(cfg))            # the loss and each metric
        # each layer gathered in the forward and again in the remat backward
        add("all-gather", _gather_bytes(specs["params"], state_sh["params"], sizes,
                                        per_layer=2 if SETTINGS.remat != "none" else 1))
        # compressed: the grads and the loss reduce over the pod's "data" ranks
        reduce = tuple(a for a in baxes if not gcomp or a != "pod")
        add("all-reduce", (4 * scalars * len(reduce), scalars * len(reduce)))
        for op, pair in _grad_reduce_bytes(specs["params"], state_sh["m"], sizes,
                                           reduce).items():
            add(op, pair)
        if gcomp:
            # each leaf's grad block (and the residual's, but a tiny leaf's) gathered
            # whole inside the pod, one piece each at these sizes; then the pods'
            # exchange: each leaf's payload, and the loss and metrics
            leaves = [s for _, s in tree_leaves(specs["params"])]
            ratio = int(gcomp.replace("topk", ""))
            assert all(s.numel() < min(gc._SPLIT, gc._PIECE) for s in leaves)
            big = {p: s for p, s in tree_leaves(specs["params"]) if s.numel() >= 4 * ratio}
            add("all-gather", _gather_bytes(specs["params"], state_sh["m"], sizes))
            add("all-gather", _gather_bytes(
                big, {p: dict(tree_leaves(state_sh["residual"]))[p] for p in big}, sizes))
            payload = gc.payload_bytes(specs["params"], gcomp) + 4 * scalars
            add("all-gather", (sizes["pod"] * payload, scalars + len(leaves)))
        add("all-reduce", (4, 1))                                # the clip's norm
        alias = 0
    else:
        pspecs = param_specs(cfg)
        psh = param_shardings(pspecs, mesh, hybrid=hybrid)
        add("all-gather", _gather_bytes(pspecs, psh, sizes, per_layer=1))
        B = shape.global_batch
        if kind == "prefill":
            bsh = batch_shardings(batch, mesh)
            args = _block_bytes(pspecs, psh) + _block_bytes(batch, bsh)
            add("all-gather", _rows_gather((B, cfg.vocab), _axes(bsh["tokens"].spec[0]),
                                           sizes))
            alias = 0
        else:
            csh = cache_shardings(batch["cache"], mesh)
            tsh = batch_shardings(batch["token"], mesh)
            alias = _block_bytes(batch["cache"], csh)
            args = _block_bytes(pspecs, psh) + alias + _block_bytes(batch["token"], tsh)
            rows = _axes(csh["k"].spec[1])       # the cache's rows
            if _axes(tsh.spec[0]) != rows:       # the tokens of the cache's rows
                add("all-gather", _gather_bytes(batch["token"], tsh, sizes))
            if sizes["model"] > 1:               # each layer's log-sum-exp merge
                b = B // math.prod(sizes[a] for a in rows)
                G = cfg.n_heads // cfg.n_kv_heads
                add("all-reduce", (cfg.n_layers * 4 * b * cfg.n_kv_heads * G
                                   * (1 + cfg.hd + 1), 2 * cfg.n_layers))
            add("all-gather", _rows_gather((B, 1, cfg.vocab), rows, sizes))
    return {"count": c, "shape": shape, "args": args, "alias": alias, "collectives": want}


@pytest.fixture(scope="module")
def cells():
    """Every (arch, mesh, kind) cell counted, and topk32 on the pod mesh;
    each mesh over a fake world of its own, ended after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    out = {}
    for kind_of_mesh in MESHES:
        multi = kind_of_mesh == "multi"
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if multi else 256)
        try:
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            nb = math.prod(axis_sizes(mesh)[a] for a in batch_axes(mesh))
            for arch in ARCHS_TESTED:
                cfg = reduced(ARCHS[arch])
                for kind in KINDS:
                    out[arch, kind_of_mesh, kind] = _cell(cfg, kind, mesh, nb)
            out["topk32"] = _cell(reduced(ARCHS["smollm-135m"]), "train", mesh, nb,
                                  grad_compress="topk32") if multi else None
            out[kind_of_mesh] = nb
        finally:
            dist.destroy_process_group()
    return out


CELLS = [(a, m, k) for a in ARCHS_TESTED for m in MESHES for k in KINDS]
CELL_IDS = [f"{a}-{m}-{k}" for a, m, k in CELLS]


@pytest.mark.parametrize("arch,mesh,kind", CELLS, ids=CELL_IDS)
def test_flops_per_device_against_detailed_flops(cells, arch, mesh, kind):
    cell = cells[arch, mesh, kind]
    cfg, shape, got = reduced(ARCHS[arch]), cell["shape"], cell["count"].stats.flops
    total = detailed_flops(cfg, shape, attn_impl=SETTINGS.attn_impl,
                           remat=SETTINGS.remat)["total"]
    if kind == "train":
        assert abs(got * cells[mesh] / total - 1) <= TRAIN_RTOL, (got, total)
    elif kind == "prefill":     # each batch rank its rows; logits at the last position only
        total -= 2 * cfg.vocab * cfg.d_model * shape.global_batch * (S - 1)
        assert abs(got * cells[mesh] / total - 1) <= SERVE_RTOL, (got, total)
    else:                       # its rows (over "data"), its slice of the KV sequence
        # both production meshes: 16 "data" ranks split the cache's rows, 16 "model"
        # ranks its KV sequence
        assert abs(got / _decode_flops(cfg, shape, 16, 16) - 1) <= SERVE_RTOL, (got, total)


@pytest.mark.parametrize("arch,mesh,kind", CELLS, ids=CELL_IDS)
def test_collectives_are_what_the_shardings_move(cells, arch, mesh, kind):
    cell = cells[arch, mesh, kind]
    got = cell["count"].stats.collectives
    for op, (nbytes, calls) in cell["collectives"].items():
        assert got[op]["bytes"] == nbytes, (op, got[op], nbytes)
        assert got[op]["count"] == calls, (op, got[op], calls)


@pytest.mark.parametrize("arch,mesh,kind", CELLS, ids=CELL_IDS)
def test_arguments_are_the_ranks_blocks(cells, arch, mesh, kind):
    cell, c = cells[arch, mesh, kind], cells[arch, mesh, kind]["count"]
    assert c.argument_bytes == cell["args"]
    assert c.alias_bytes == cell["alias"]          # the donated decode cache
    assert c.peak_bytes >= c.argument_bytes + c.output_bytes - c.alias_bytes
    assert c.micro_batches == 1 and c.stats.unknown_trip_whiles == 0


def test_topk32_pod_gather_is_the_payload(cells):
    """On the pod mesh with ``grad_compress="topk32"``, the all-gathers are
    each layer's parameters (as the dense step gathers them), each leaf's
    grad and residual blocks gathered whole inside the pod, and the pods'
    exchange: ``grad_compress.payload_bytes`` and the loss and metrics from
    each pod, one exchange a leaf.  The grads reduce over the pod's "data"
    ranks only (reduce-scatter where "data" splits a leaf)."""
    cell = cells["topk32"]
    got = cell["count"].stats.collectives
    for op, (nbytes, calls) in cell["collectives"].items():
        assert got[op] == {"bytes": nbytes, "count": calls}, (op, got[op], nbytes, calls)
    assert got["reduce-scatter"]["count"] > 0


def test_topk32_cell_peaks_under_whole_gathers(cells):
    """The reduced topk32 cell on the pod mesh peaks under its arguments and
    the whole float32 parameters, residual and grads (what gathering them
    whole held), and within the dense cell's peak, the residual's blocks
    and ten copies of its largest leaf (each leaf one piece here)."""
    from repro_torch.models import count_params

    cfg = reduced(ARCHS["smollm-135m"])
    c, dense = cells["topk32"]["count"], cells["smollm-135m", "multi", "train"]["count"]
    largest = max(s.numel() for _, s in tree_leaves(param_specs(cfg)))
    assert c.peak_bytes < c.argument_bytes + 3 * 4 * count_params(cfg)
    assert c.peak_bytes <= (dense.peak_bytes + c.argument_bytes - dense.argument_bytes
                            + 10 * 4 * largest)


#: the memory test's config: reduced smollm-135m, 16 layers, d_ff 1024 (the
#: parameters outweigh the activations, so that a design holding them whole
#: fails it)
DEEP = dict(n_layers=16, d_ff=1024)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_the_peak_holds_one_layer_whole_at_a_time(kind):
    """A cell on a 4x4 mesh (a fake world of 16) peaks under the rank's
    blocks, two layers' parameters whole (float32 and their bfloat16 cast),
    the embedding whole, and the step's activations.  Blocks: the
    arguments (state or parameters and cache, and the rows), for train also
    the new state and two copies of the grads' blocks (a layer's own and
    the stacked).  Activations, counted in float32 and generously: eight
    tensors a row and position of the widest of D, F and V, and (train)
    every layer's saved input, (decode) the rank's score blocks.  Gathering
    every parameter whole, as the port did before, needs the whole float32
    parameters (and for train their whole grads) on top of the blocks,
    which exceeds that bound."""
    import dataclasses

    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import count_params

    cfg = dataclasses.replace(reduced(ARCHS["smollm-135m"]), **DEEP)
    B, S = (8, 32) if kind == "train" else (4, 64)
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        mesh = make_mesh((4, 4), ("data", "model"), device="cpu")
        c = dryrun.count_cell(cfg, ShapeConfig("x", S, B, kind), mesh, SETTINGS)
        if kind == "train":
            specs = train_state_specs(cfg)
            m_blocks = _block_bytes(specs["m"], train_state_shardings(cfg, mesh)["m"])
    finally:
        dist.destroy_process_group()
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    whole = 4 * count_params(cfg)
    embed = 4 * V * D
    layer = (whole - embed - 4 * D) // L           # the final norm's D aside
    rows = B // 4                                  # the rank's rows (over "data")
    act = 8 * rows * (S if kind == "train" else 1) * max(D, F, V) * 4
    if kind == "train":
        blocks = c.argument_bytes + c.output_bytes + 2 * m_blocks
        act += L * rows * S * D * 4
        old = c.argument_bytes + 2 * whole
    else:
        blocks = c.argument_bytes
        act += 8 * rows * cfg.n_heads * (S // 4) * 4
        old = c.argument_bytes + whole
    bound = blocks + 2 * layer * 3 // 2 + embed * 3 // 2 + act
    assert c.peak_bytes <= bound, (c.peak_bytes, bound)
    assert old > bound, (old, bound)


def test_topk32_peak_holds_one_piece_whole(monkeypatch):
    """The compressed step on a (2, 4, 4) pod mesh (a fake world of 32),
    the DEEP config, its top-k units cut a layer each (``_SPLIT`` and
    ``_PIECE`` 2^16, ``_BLOCK`` 2^12), peaks under the dense step's bound of
    the test above plus the compress pass's working set: ten float32 copies
    of a piece and three of the largest leaf's payload.  Gathering the
    parameters, the residual and the grads whole, as the branch did
    before, needs three whole float32 copies of the parameters on top of
    the blocks, which exceeds that bound."""
    import dataclasses

    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import count_params

    for name, value in (("_SPLIT", 1 << 16), ("_PIECE", 1 << 16), ("_BLOCK", 1 << 12)):
        monkeypatch.setattr(gc, name, value)
    cfg = dataclasses.replace(reduced(ARCHS["smollm-135m"]), **DEEP)
    B, S = 16, 32
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=32)
    try:
        mesh = make_mesh((2, 4, 4), ("pod", "data", "model"), device="cpu")
        c = dryrun.count_cell(cfg, ShapeConfig("x", S, B, "train"), mesh, SETTINGS,
                              grad_compress="topk32")
        specs = train_state_specs(cfg, grad_compress="topk32")
        m_blocks = _block_bytes(specs["m"], train_state_shardings(
            cfg, mesh, grad_compress="topk32")["m"])
    finally:
        dist.destroy_process_group()
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    whole = 4 * count_params(cfg)
    embed = 4 * V * D
    layer = (whole - embed - 4 * D) // L
    rows = B // 8                                  # the rank's rows (over "pod", "data")
    act = 8 * rows * S * max(D, F, V) * 4 + L * rows * S * D * 4
    blocks = c.argument_bytes + c.output_bytes + 2 * m_blocks
    payload = max(gc.payload_bytes({"x": s}) for _, s in tree_leaves(specs["params"]))
    bound = (blocks + 2 * layer * 3 // 2 + embed * 3 // 2 + act + 10 * 4 * gc._PIECE
             + 3 * payload)
    old = c.argument_bytes + 3 * whole
    assert c.peak_bytes <= bound, (c.peak_bytes, bound)
    assert old > bound, (old, bound)


@pytest.mark.parametrize("kind", KINDS)
def test_run_cell_runs_the_ranks_step_for_real(kind):
    """``run_cell`` runs rank 0's step on real random blocks, the same
    arguments as ``count_cell`` counts, in a fake world of 16 on a 4x4
    mesh (each family's reduced config; no peak on the CPU)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    shape = ShapeConfig("x", S, 8 if kind == "train" else 4, kind)
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        mesh = make_mesh((4, 4), ("data", "model"), device="cpu")
        for arch in ("smollm-135m", "olmoe-1b-7b", "rwkv6-7b", "jamba-v0.1-52b",
                     "whisper-small"):
            cfg = reduced(ARCHS[arch])
            c = dryrun.count_cell(cfg, shape, mesh, SETTINGS)
            run = dryrun.run_cell(cfg, shape, mesh, SETTINGS, steps=2)
            assert run["argument_bytes"] == c.argument_bytes, arch
            assert len(run["seconds"]) == 2 and min(run["seconds"]) > 0, arch
            assert run["micro_batches"] == 1 and run["max_memory_allocated"] is None
    finally:
        dist.destroy_process_group()


def test_run_cell_runs_a_compressed_step_for_real():
    """``run_cell`` runs rank 0's ``topk32`` step on a (2, 2, 2) pod mesh (a
    fake world of 8): the pods' exchange in a fake world leaves its parts
    as this pod's payload, so the exchanged indices stay in their blocks;
    ``count_compress`` counts the pass alone (12 exchanges: the 11 leaves
    and the loss)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    cfg = reduced(ARCHS["smollm-135m"])
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        shape = ShapeConfig("x", S, 8, "train")
        c = dryrun.count_cell(cfg, shape, mesh, SETTINGS, grad_compress="topk32")
        run = dryrun.run_cell(cfg, shape, mesh, SETTINGS, grad_compress="topk32", steps=1)
        alone = dryrun.count_compress(cfg, mesh, "topk32")
    finally:
        dist.destroy_process_group()
    assert run["argument_bytes"] == c.argument_bytes and len(run["seconds"]) == 1
    assert alone["exchanges"] == 12 and alone["pieces"] == alone["leaves"] - 1 == 10
    assert alone["payload_bytes"] == gc.payload_bytes(param_specs(cfg), "topk32")
    assert alone["argument_bytes"] < alone["peak_bytes"] < c.peak_bytes


def test_the_cli_writes_the_references_json(tmp_path):
    out = tmp_path / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m",
         "--shape", "decode_32k", "--mesh", "both", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "[cell] smollm-135m x decode_32k x single"
    assert lines[1].startswith("  memory_analysis: arg=") and lines[1].endswith(
        "GiB per device")
    assert lines[2].startswith("  cost_analysis: flops=")
    assert lines[3] == "[cell] smollm-135m x decode_32k x multi"
    assert lines[-1] == "all requested cells counted OK"
    cfg = ARCHS["smollm-135m"]
    for mesh_kind, n in (("single", 256), ("multi", 512)):
        with open(out / f"smollm-135m__decode_32k__{mesh_kind}.json") as f:
            res = json.load(f)
        assert list(res) == RESULT_KEYS
        assert list(res["memory"]) == MEMORY_KEYS
        assert list(res["loop_aware"]) == LOOP_AWARE_KEYS
        assert list(res["collectives"]) == COLLECTIVES
        assert res["n_devices"] == n and res["applicable"] and "error" not in res
        assert res["time_compile_s"] is None and res["time_lower_s"] > 0
        la = res["loop_aware"]
        assert la["flops_per_device"] == res["flops_per_device"] > 0
        assert la["hbm_bytes_per_device"] == res["bytes_accessed_per_device"] > 0
        assert la["collectives"] == res["collectives"]
        assert la["unknown_trip_whiles"] == 0
        mem = res["memory"]
        assert mem["generated_code_bytes"] == 0 and mem["temp_bytes"] > 0
        assert 0 < mem["alias_bytes"] <= mem["argument_bytes"]
        # a rank decodes its 8 rows over its slice of the KV sequence and
        # gathers no cache (the whole bf16 cache is ~97 GB): its all-gathers
        # are the float32 parameters, one layer at a time (a leaf split over
        # "data" and "model" passes a 1/16 part on the way), and the logits
        shape = SHAPES["decode_32k"]
        assert abs(res["flops_per_device"] / _decode_flops(cfg, shape, 16, 16) - 1) \
            <= SERVE_RTOL
        params, logits = 4 * res["params_total"], 128 * cfg.vocab * 4
        assert params < res["collectives"]["all-gather"]["bytes"] \
            <= params * (1 + 1 / 16) + logits
        assert mem["argument_bytes"] + mem["temp_bytes"] < 80e9     # fits an 80 GB card


def test_a_failing_cell_is_recorded_and_exits_1(tmp_path, monkeypatch, capsys):
    real = dryrun.count_cell

    def failing_on_the_pod_mesh(cfg, shape, mesh, *a, **kw):
        if mesh.size() == 512:
            raise RuntimeError("made to fail")
        return real(cfg, shape, mesh, *a, **kw)

    monkeypatch.setattr(dryrun, "count_cell", failing_on_the_pod_mesh)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    assert not dist.is_initialized()
    printed = capsys.readouterr().out
    assert "\n1 FAILURES:\n" in printed
    with open(tmp_path / "smollm-135m__decode_32k__multi.json") as f:
        assert json.load(f) == {"arch": "smollm-135m", "shape": "decode_32k", "mesh": "multi",
                                "applicable": True, "error": "RuntimeError: made to fail"}
    with open(tmp_path / "smollm-135m__decode_32k__single.json") as f:
        assert "error" not in json.load(f)
    # a skipped cell and one that does not apply
    monkeypatch.setattr(dryrun, "count_cell", real)
    dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k", "--mesh", "single",
                 "--device", "cpu", "--out", str(tmp_path)])
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", "single",
                 "--device", "cpu", "--out", str(tmp_path), "--skip-existing"])
    printed = capsys.readouterr().out
    assert f"[skip] {tmp_path}/smollm-135m__decode_32k__single.json" in printed
    with open(tmp_path / "smollm-135m__decode_32k__single.json") as f:
        assert json.load(f)["applicable"]


def test_cuda_without_a_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                     "--out", str(tmp_path)])


def test_importing_starts_no_world_and_sets_no_environment():
    code = ("import os, torch.distributed as d\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis\n"
            "assert dict(os.environ) == before and not d.is_initialized()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
