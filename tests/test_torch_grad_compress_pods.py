"""One compressed train step of the reduced smollm on two pods split over
"data" or "model", in four gloo processes, against the reference's step on
four XLA host devices (tests/test_torch_grad_compress.py's script in a
subprocess, the mesh's shape given).

The port's step keeps every parameter, moment and residual in its block:
the backward reduces each layer's gradient over the pod's "data" ranks,
and the top-k gathers one piece of a leaf at a time inside the pod.  The
pods must end with the same params, m and v, bit for bit; each keeps its
own residual.  Against the reference, tests/test_torch_grad_compress.py's
flip rule: an entry whose |corrected| lies within the grads' tolerance of
its block's threshold, in either pod's gradient, may be selected
differently; every other value is held to the tolerances there.  Each
pod's gradient (the flip rule's input) is the port's own over the pod's
rows, in this process.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import state_from_reference
from repro_torch.train import step as tstep

from _torch_mesh import end_the_world_it_started  # noqa: F401  (autouse)
from _torch_mesh import spawn, step_rank, unflatten
from _torch_train import TST
from test_torch_grad_compress import (REF_SCRIPT, ROOT, _batch, _check_step, _near_threshold,
                                      bits)

torch.set_num_threads(1)

#: two pods, each of two ranks over "data" or over "model" (rank = pod * 2
#: + its coordinate on the axis of size 2)
MESHES = {"2x2x1": (2, 2, 1), "2x1x2": (2, 1, 2)}


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_compressed_step_two_pods_in_blocks_matches_the_reference(tmp_path, tag):
    shape = MESHES[tag]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(tmp_path / "ref.npz"),
                          ",".join(map(str, shape))],
                         env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    flat = dict(np.load(tmp_path / "ref.npz"))
    before, want = unflatten(flat, "before"), unflatten(flat, "after")
    wmet = unflatten(flat, "metric")
    cfg = tconfigs.reduced(tconfigs.ARCHS["smollm-135m"])
    batch = _batch(cfg)
    ranks = spawn(step_rank, 4, tmp_path, before, batch, shape, ("pod", "data", "model"),
                  {"grad_compress": "topk32"}, False)
    # rows over ("pod", "data"): (2, 2, 1) a row a rank, (2, 1, 2) two a pod
    n_rows = batch["tokens"].shape[0] // (shape[0] * shape[1])
    for r, out in enumerate(ranks):
        first = (r // (shape[1] * shape[2]) * shape[1] + r // shape[2] % shape[1]) * n_rows
        np.testing.assert_array_equal(out["rows/tokens"], batch["tokens"][first:first + n_rows])
    # pod 1's rank r + 2 holds the blocks of pod 0's rank r: bit-equal params,
    # m and v, and the same metrics; the residuals are each pod's own
    for r in (0, 1):
        a, b = ranks[r], ranks[r + 2]
        for k in a:
            if k.startswith(("after/", "whole/", "metric/")) and "/residual/" not in k:
                np.testing.assert_array_equal(bits(a[k]), bits(b[k]), err_msg=(tag, k))
        assert a["spec/m/embed"] == b["spec/m/embed"]
    # the state stays in blocks: a split leaf's block is a part of the whole
    split = [k for k in ranks[0] if k.startswith("after/m/")
             and ranks[0][k].shape != ranks[0]["whole/" + k[len("after/"):]].shape]
    assert split, "no leaf split on this mesh"
    params = state_from_reference(before, "cpu")["params"]
    half = batch["tokens"].shape[0] // 2
    near = []
    for pod in range(2):
        rows = {k: torch.from_numpy(v[pod * half:(pod + 1) * half]) for k, v in batch.items()}
        _, _, g = tstep._value_and_grad(params, rows, cfg,
                                        dataclasses.replace(TST, batch_axes=("data",)))
        near.append({p: _near_threshold(a.numpy(), 32) for p, a in tree_leaves(g)})
    either = {p: near[0][p] | near[1][p] for p in near[0]}
    got = unflatten(ranks[0], "whole")
    gmet = unflatten(ranks[0], "metric")
    # the reference's residual is its first pod's
    n = _check_step(got, gmet, want, wmet, before, either, near[0])
    assert n < 0.02 * sum(a.size for _, a in tree_leaves(got["m"])), n
