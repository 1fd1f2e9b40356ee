"""The port's placement rules (``repro_torch.train.sharding``) against the
reference's (``repro.train.sharding``), leaf for leaf, on the production
meshes: 16x16 ("data", "model") and 2x16x16 ("pod", "data", "model").

The port's meshes are ``make_production_mesh``'s ``DeviceMesh`` over a
world of 256 or 512 ranks on torch's ``fake`` backend (one process); the
reference's are ``jax.sharding.AbstractMesh``es of the same shape.  Specs
come from each package's ``param_specs``/``train_state_specs``/
``input_batch_specs``/``cache_spec`` (``meta`` tensors and
``ShapeDtypeStruct``s) of the ten full configs; a spec is compared as the
tuple of its parts, exactly.
"""
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

import repro.configs as rconfigs
import repro.models as R
from repro.train import sharding as rsh
from repro.train import step as rstep

import repro_torch.configs as tconfigs
import repro_torch.models as T
from repro_torch.launch import mesh as tmesh
from repro_torch.models.common import tree_leaves
from repro_torch.train import sharding as tsh
from repro_torch.train import step as tstep

ARCH_NAMES = sorted(rconfigs.ARCHS)
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", params=[False, True], ids=["16x16", "2x16x16"])
def meshes(request):
    """(the port's mesh over a fake world, the reference's abstract mesh)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = MESHES[request.param]
    n = 1
    for s in shape:
        n *= s
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield tmesh.make_production_mesh(multi_pod=request.param, device="cpu"), \
            AbstractMesh(shape, axes)
    finally:
        dist.destroy_process_group()


def _ref_specs(tree):
    return {tuple(getattr(k, "key", str(k)) for k in path): tuple(sh.spec)
            for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree):
    return {path: tuple(sh.spec) for path, sh in tree_leaves(tree)}


def _same(got, want):
    assert sorted(got) == sorted(want)
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not bad, bad


def test_the_production_meshes(meshes):
    mesh, ref = meshes
    assert tuple(mesh.shape) == tuple(ref.shape.values())
    assert mesh.mesh_dim_names == ref.axis_names
    assert tmesh.axis_sizes(mesh) == dict(ref.shape)
    assert tmesh.batch_axes(mesh) == tuple(a for a in ("pod", "data") if a in ref.axis_names)
    assert tmesh.model_axis(mesh) == "model"
    assert mesh.get_coordinate() == (0,) * len(ref.axis_names)


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_shardings_are_the_references(meshes, name, mode):
    mesh, ref = meshes
    rcfg, tcfg = rconfigs.ARCHS[name], tconfigs.ARCHS[name]
    hybrid = rcfg.family == "hybrid"
    want = _ref_specs(rsh.param_shardings(R.param_specs(rcfg), ref, hybrid=hybrid, mode=mode))
    got = tsh.param_shardings(T.param_specs(tcfg), mesh, hybrid=hybrid, mode=mode)
    _same(_port_specs(got), want)
    assert all(sh.mesh is mesh for _, sh in tree_leaves(got))


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_state_shardings_are_the_references(meshes, name, mode):
    """With the error-feedback residual and bfloat16 parameters."""
    mesh, ref = meshes
    want = _ref_specs(rstep.train_state_shardings(
        rconfigs.ARCHS[name], ref, grad_compress="topk32", mode=mode,
        param_dtype=jnp.bfloat16))
    got = tstep.train_state_shardings(tconfigs.ARCHS[name], mesh, grad_compress="topk32",
                                      mode=mode, param_dtype=torch.bfloat16)
    assert sorted(got) == ["m", "params", "residual", "step", "v"]
    _same(_port_specs(got), want)


@pytest.mark.parametrize("shape", sorted(rconfigs.SHAPES))
@pytest.mark.parametrize("name", ["smollm-135m", "whisper-small"])
def test_batch_shardings_are_the_references(meshes, name, shape):
    mesh, ref = meshes
    rcfg, tcfg = rconfigs.ARCHS[name], tconfigs.ARCHS[name]
    want = _ref_specs(rsh.batch_shardings(
        R.input_batch_specs(rcfg, rconfigs.SHAPES[shape]), ref))
    got = tsh.batch_shardings(T.input_batch_specs(tcfg, tconfigs.SHAPES[shape]), mesh)
    _same(_port_specs(got), want)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_shardings_are_the_references(meshes, name):
    """decode_32k's cache (B 128, S 32768), and one whose batch and length
    divide neither axis (B 3, S 1000)."""
    mesh, ref = meshes
    rcfg, tcfg = rconfigs.ARCHS[name], tconfigs.ARCHS[name]
    for B, S in ((128, 32768), (3, 1000)):
        want = _ref_specs(rsh.cache_shardings(R.cache_spec(rcfg, B, S), ref))
        got = tsh.cache_shardings(T.cache_spec(tcfg, B, S), mesh)
        _same(_port_specs(got), want)


def test_placements_and_blocks(meshes):
    """DTensor placements per mesh dim, and a block's shape and place."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, _ = meshes
    P = tsh.PartitionSpec
    names = mesh.mesh_dim_names
    batch = tsh.NamedSharding(mesh, P(tmesh.batch_axes(mesh), None))
    want = tuple(Shard(0) if a in ("pod", "data") else Replicate() for a in names)
    assert batch.placements == want
    n_batch = 32 if "pod" in names else 16
    assert batch.shard_shape((64, 7)) == (64 // n_batch, 7)
    w = tsh.NamedSharding(mesh, P(None, "model", "data"))
    assert w.placements == tuple({"model": Shard(1), "data": Shard(2)}.get(a, Replicate())
                                 for a in names)
    x = torch.arange(2 * 32 * 48).reshape(2, 32, 48)
    # rank 0: the first block along each split dim
    assert torch.equal(w.local(x), x[:, :2, :3])
    assert tsh.NamedSharding(mesh, P()).local(x) is x
