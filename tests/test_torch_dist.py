"""The port's ``repro_torch.dist`` against the JAX package's ``repro.dist``,
on the CPU.

* ``exclusive_offsets_np`` equals the reference's on random sizes, on an
  empty input and on a single element.
* ``exclusive_offsets_sharded`` runs over a ``torch.distributed`` gloo
  group: each process passes its shard and gets its slice of
  ``exclusive_offsets_np`` of the concatenated sizes, at world size 1
  in-process and at world size 2 in spawned processes.
* ``fault`` is a copy: ``StragglerWatchdog`` reports, ``elastic_plan``
  results and ``PreemptionHandler``'s latch equal the reference's on the
  same inputs.

The reference is imported inside the tests, so that the processes spawned
here import no JAX.
"""
import dataclasses
import os
import signal

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.dist import fault as tfault
from repro_torch.dist import offsets as toff


@pytest.mark.parametrize("sizes", [
    np.random.default_rng(0).integers(0, 1 << 40, 17),
    np.random.default_rng(1).integers(0, 5_000_000, 1000),
    np.array([], np.int64),
    np.array([123456789012], np.int64),
], ids=["random-17", "random-1000", "empty", "single"])
def test_offsets_np_equal_reference(sizes):
    from repro.dist.offsets import exclusive_offsets_np

    got = toff.exclusive_offsets_np(sizes)
    want = exclusive_offsets_np(sizes)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(toff.exclusive_offsets_np(list(sizes)), want)


def _gloo(rank: int, world: int, init_file: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)


def test_offsets_sharded_world_size_1(tmp_path):
    assert not dist.is_initialized()  # importing repro_torch.dist started no group
    sizes = np.random.default_rng(2).integers(0, 1 << 30, 9)
    _gloo(0, 1, str(tmp_path / "init"))
    try:
        out = toff.exclusive_offsets_sharded(torch.from_numpy(sizes))
        assert out.dtype == torch.int64
        np.testing.assert_array_equal(out.numpy(), toff.exclusive_offsets_np(sizes))
        # an explicit group, and an empty shard
        group = dist.new_group([0])
        out = toff.exclusive_offsets_sharded(sizes.tolist(), group=group)
        np.testing.assert_array_equal(out.numpy(), toff.exclusive_offsets_np(sizes))
        assert toff.exclusive_offsets_sharded([]).numel() == 0
    finally:
        dist.destroy_process_group()


#: per-rank shards of the world-size-2 run (rank 1's empty in one case)
SHARDS = {"uneven": ([3, 9, 1, 4, 1 << 35], [7, 0, 2]),
          "empty_rank": ([5, 6, 7], [])}


def _exscan_rank(rank: int, world: int, init_file: str, shards, out_dir: str) -> None:
    """Spawned rank: one sharded exscan of its own shard, saved as .npy."""
    _gloo(rank, world, init_file)
    try:
        out = toff.exclusive_offsets_sharded(torch.tensor(shards[rank], dtype=torch.int64))
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), out.numpy())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", sorted(SHARDS))
def test_offsets_sharded_world_size_2(tmp_path, case):
    shards = SHARDS[case]
    mp.spawn(_exscan_rank, args=(2, str(tmp_path / "init"), shards, str(tmp_path)),
             nprocs=2, join=True)
    got = np.concatenate([np.load(tmp_path / f"rank{r}.npy") for r in range(2)])
    want = toff.exclusive_offsets_np(np.concatenate([np.asarray(s, np.int64)
                                                     for s in shards]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("times", [
    [1.0] * 10 + [2.0, 5.0, 1.1, 0.9, 3.5],
    list(np.random.default_rng(3).lognormal(0.0, 0.6, 60)),
    [0.5, 0.5, 1.6, 0.4, 0.6, 3.0, 0.5],
], ids=["reference-case", "lognormal-60", "short"])
def test_straggler_watchdog_equals_reference(times):
    from repro.dist.fault import StragglerWatchdog

    t = tfault.StragglerWatchdog(window=8, flag_ratio=1.5, redispatch_ratio=3.0)
    r = StragglerWatchdog(window=8, flag_ratio=1.5, redispatch_ratio=3.0)
    for step, dt in enumerate(times):
        assert dataclasses.asdict(t.observe(step, dt)) == \
            dataclasses.asdict(r.observe(step, dt))
    assert [dataclasses.asdict(x) for x in t.reports] == \
        [dataclasses.asdict(x) for x in r.reports]
    assert t.reports, "the sequence flags no step"


def test_elastic_plan_equals_reference():
    from repro.dist.fault import elastic_plan

    for requested, available, batch in [(256, 240, 256), (256, 256, 256), (8, 7, 30),
                                        (4, 9, 10), (1, 1, 1), (16, 12, 1000)]:
        assert tfault.elastic_plan(requested, available, global_batch=batch) == \
            elastic_plan(requested, available, global_batch=batch)
    for mod in (tfault, None):
        fn = mod.elastic_plan if mod else elastic_plan
        with pytest.raises(ValueError, match="no devices available"):
            fn(4, 0, global_batch=8)


def test_preemption_handler_latches_as_the_reference():
    from repro.dist.fault import PreemptionHandler

    for cls in (tfault.PreemptionHandler, PreemptionHandler):
        before = signal.getsignal(signal.SIGUSR1)
        h = cls(signals=(signal.SIGUSR1,))
        try:
            assert not h.preempted
            assert signal.getsignal(signal.SIGUSR1) == h._handle  # installed
            signal.raise_signal(signal.SIGUSR1)
            assert h.preempted
        finally:
            h.restore()
        assert signal.getsignal(signal.SIGUSR1) == before
        assert not cls(install=False).preempted
