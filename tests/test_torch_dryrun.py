"""The port's dry run (``repro_torch.launch.dryrun``) on the production
meshes, 16x16 ("data", "model") and 2x16x16 ("pod", "data", "model"),
over worlds of 256 and 512 ranks on torch's ``fake`` backend (one
process, fake tensors: nothing is allocated).

Each cell's counts are held to what the port's own placements say
(``train/sharding.py``): the arguments are the rank's blocks, and every
collective's bytes are what gathering at use, the reduce-scatter of the
grads to the moments' blocks, the batch means and the clip's all-reduce
move.  They cannot be held against the reference's HLO: GSPMD partitions
the compute, the port gathers at use (ROADMAP §3).  The flops are held
against ``models.costs.detailed_flops``: a train step's per device times
the batch ranks within 15% of its total (the port's checkpoint reruns
neither the LM head nor a layer's last product, where the analytic count
assumes four full passes); prefill and decode per device within 1% of the
whole batch's, since every rank computes the whole batch (prefill's head
at the last position only).  Reduced dense configs (smollm-135m,
qwen3-32b), B 2 per batch rank for train and 1 for serving, S 32 in 16-wide
attention chunks.  Then the CLI at full width (smollm-135m, decode_32k,
both meshes): the reference's JSON keys in order, its lines, and a failing
cell's exit 1.
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

from repro_torch.configs import ARCHS, ShapeConfig, reduced
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


def _gather_bytes(specs, shardings, sizes) -> tuple[int, int]:
    """(bytes, calls) of the all-gathers that make each leaf whole from its
    block: per split dim, each of its axes minor first, the tensor gathered
    so far times the axis."""
    total = calls = 0
    for (_, s), (_, sh) in zip(tree_leaves(specs), tree_leaves(shardings)):
        shape = list(sh.shard_shape(s.shape))
        for d, part in enumerate(sh.spec):
            for a in reversed(_axes(part)):
                if sizes[a] > 1:
                    shape[d] *= sizes[a]
                    total += _nbytes(shape, s.dtype)
                    calls += 1
    return total, calls


def _grad_reduce_bytes(specs, moment_sh, sizes, baxes) -> dict:
    """Per op, (bytes, calls) of taking each whole float32 grad to the
    moments' block: over each batch axis, a reduce-scatter where the axis
    splits a dim of the leaf, else an all-reduce of what is left."""
    out = {"all-reduce": [0, 0], "reduce-scatter": [0, 0]}
    for (_, s), (_, sh) in zip(tree_leaves(specs), tree_leaves(moment_sh)):
        split = {a for part in sh.spec for a in _axes(part)}
        n = s.numel()
        for a in baxes:
            if sizes[a] == 1:
                continue
            if a in split:
                n //= sizes[a]
                op = "reduce-scatter"
            else:
                op = "all-reduce"
            out[op][0] += 4 * n
            out[op][1] += 1
    return out


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
        add("all-gather", _gather_bytes(specs["params"], state_sh["params"], sizes))
        scalars = 1 + len(_metrics(cfg))            # the loss and each metric
        if gcomp:
            # whole grads and the residual: the mean over "data", then the pods'
            # exchange, each pod's payload and its loss and metrics gathered
            leaves = [s for _, s in tree_leaves(specs["params"])]
            add("all-gather", _gather_bytes(specs["residual"], state_sh["residual"], sizes))
            add("all-reduce", (4 * (scalars + sum(s.numel() for s in leaves)),
                               scalars + len(leaves)))
            ratio = int(gcomp.replace("topk", ""))
            sends = scalars + sum(1 if s.numel() < 4 * ratio else 2 for s in leaves)
            payload = gc.payload_bytes(specs["params"], gcomp) + 4 * scalars
            add("all-gather", (sizes["pod"] * payload, sends))
        else:
            add("all-reduce", (4 * scalars * len(baxes), scalars * len(baxes)))
            for op, pair in _grad_reduce_bytes(specs["params"], state_sh["m"], sizes,
                                               baxes).items():
                add(op, pair)
        add("all-reduce", (4, 1))                                # the clip's norm
        alias = 0
    else:
        pspecs = param_specs(cfg)
        psh = param_shardings(pspecs, mesh, hybrid=hybrid)
        add("all-gather", _gather_bytes(pspecs, psh, sizes))
        if kind == "prefill":
            bsh = batch_shardings(batch, mesh)
            args = _block_bytes(pspecs, psh) + _block_bytes(batch, bsh)
            add("all-gather", _gather_bytes(batch, bsh, sizes))
            alias = 0
        else:
            csh = cache_shardings(batch["cache"], mesh)
            tsh = batch_shardings(batch["token"], mesh)
            alias = _block_bytes(batch["cache"], csh)
            args = _block_bytes(pspecs, psh) + alias + _block_bytes(batch["token"], tsh)
            add("all-gather", _gather_bytes(batch["cache"], csh, sizes))
            add("all-gather", _gather_bytes(batch["token"], tsh, sizes))
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
    else:
        if kind == "prefill":   # logits at the last position only
            total -= 2 * cfg.vocab * cfg.d_model * shape.global_batch * (S - 1)
        assert abs(got / total - 1) <= SERVE_RTOL, (got, total)


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
    the parameters' and residuals' gathers plus the pods' exchange:
    ``grad_compress.payload_bytes`` and the loss and metrics from each pod."""
    cell = cells["topk32"]
    got = cell["count"].stats.collectives
    for op, (nbytes, calls) in cell["collectives"].items():
        assert got[op] == {"bytes": nbytes, "count": calls}, (op, got[op], nbytes, calls)
    assert got["reduce-scatter"]["count"] == 0


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
        # every rank decodes the whole batch from the gathered cache
        assert abs(res["flops_per_device"] / res["analytic"]["total"] - 1) <= SERVE_RTOL
        assert res["collectives"]["all-gather"]["bytes"] > 2 * cfg.n_layers * 128 * 32768 \
            * cfg.n_kv_heads * cfg.hd * 2 * (1 - 1 / 256)   # the bf16 cache, gathered


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
