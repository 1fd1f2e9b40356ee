"""The readers of the program's snapshot-path spans and counters, each
fed a hand-made record (and one with nothing to read, as the parent
commit's program gives), and on the card the program's copy counts and
device times that they read."""
import importlib.util
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"
N = 512 ** 3


def _read(name: str):
    spec = importlib.util.spec_from_file_location(f"pb_test_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, dur_us, **args):
    return {"name": name, "ph": "X", "ts": 0.0, "dur": dur_us, "args": args}


SPANS = [
    _span("snapshot", 3000e3, id=1, parent=None), _span("snapshot", 2000e3, id=9, parent=None),
    _span("pipeline.to_device", 90e3), _span("pipeline.to_device", 110e3),
    _span("stage1", 320e3),
    _span("stage1.transform", 2.2e3, device_us=1500.0),
    _span("stage1.transform", 2.0e3, device_us=2500.0),
    _span("stage1.transform", 1.0e3),                  # on the CPU: no device time
    _span("stage1.to_host", 300e3, device_us=290e3),
    _span("stage1.to_host", 310e3, device_us=310e3),
    _span("stage2", 800e3), _span("stage2", 900e3),
    _span("encode", 2900e3),
]
COPIES = {
    "cz_copy_bytes_total{direction=d2h,pinned=false,site=snapshot.host_copy}": 4 * N * 6,
    "cz_copy_bytes_total{direction=h2d,pinned=false,site=pipeline.to_device}": 4 * N * 6,
    "cz_copy_bytes_total{direction=d2h,pinned=false,site=stage1.to_host}": 5 * N * 6,
}


@pytest.mark.parametrize("name, record, want", [
    ("snapshot_ms", {"spans": SPANS}, 2500.0),
    ("to_device_ms", {"spans": SPANS}, 100.0),
    ("stage1_transform_ms", {"spans": SPANS}, 2.0),
    ("stage1_to_host_ms", {"spans": SPANS}, 300.0),
    ("stage2_wall_ms", {"spans": SPANS}, 850.0),
    # 3 snapshots of p and rho, 13 B a cell each: 1744.83 MB a QoI
    ("copy_mb_per_qoi", {"counters": COPIES, "snapshots": 3, "qois": ["p", "rho"]},
     1744.830464),
    ("stage2_cr", {"counters": {"cz_pipeline_payload_bytes_total{scheme=wavelet}": 300,
                                "cz_pipeline_encoded_bytes_total{scheme=wavelet}": 100}}, 3.0),
])
def test_reader_on_a_hand_made_record(name, record, want):
    assert _read(name)(record) == pytest.approx(want, rel=1e-12)


# what the parent commit's program leaves: the older spans and counters only
PARENT = {"spans": [_span("stage1", 320e3), _span("encode", 2900e3),
                    _span("snapshot.host_copy", 245e3), _span("dataset.write", 3e6)],
          "counters": {"cz_pipeline_raw_bytes_total{scheme=wavelet}": 4 * N,
                       "cz_pipeline_encoded_bytes_total{scheme=wavelet}": N // 5},
          "snapshots": 3, "qois": ["p", "rho"]}
NAMES = ("snapshot_ms", "to_device_ms", "stage1_transform_ms", "stage1_to_host_ms",
         "stage2_wall_ms", "copy_mb_per_qoi", "stage2_cr")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("record", [{}, PARENT], ids=["empty", "parent"])
def test_reader_with_nothing_to_read_returns_none(name, record):
    assert _read(name)(record) is None


def test_chunk_cr_over_stage2_cr_is_stage_1s_ratio():
    c = {"cz_pipeline_raw_bytes_total{scheme=wavelet}": 1000,
         "cz_pipeline_payload_bytes_total{scheme=wavelet}": 250,
         "cz_pipeline_encoded_bytes_total{scheme=wavelet}": 50}
    ratio = _read("chunk_cr")({"counters": c}) / _read("stage2_cr")({"counters": c})
    assert ratio == pytest.approx(1000 / 250)


@pytest.mark.card
def test_snapshot_on_the_card_counts_its_copies_and_device_time(cuda, tmp_path, monkeypatch):
    """64^3 p and rho snapshotted on the card: 13 B a cell crosses per QoI
    (the field down, back up, coefficients and mask down), the stage 1
    spans and the kernel's carry a positive ``device_us``, and an untraced
    snapshot makes no CUDA event and never synchronizes."""
    import torch

    from perfbench.harness import bench
    from repro_torch.ckpt import FieldSnapshotter
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.obs import trace

    g = torch.Generator(device=cuda).manual_seed(5)
    fields = {q: torch.randn((64, 64, 64), generator=g, device=cuda) * 10 for q in ("p", "rho")}
    snap = FieldSnapshotter(str(tmp_path / "s"), spec=CompressionSpec(), workers=2, device=cuda)
    snap.maybe_snapshot(fields, 0)                          # builds and loads the kernel
    torch.cuda.synchronize()

    made, syncs = [], []
    real_event, real_sync = torch.cuda.Event, torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1) or real_event(*a, **k))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1) or real_sync(*a, **k))
    trace.reset()
    before = bench.program_counters()
    snap.maybe_snapshot(fields, 1)
    real_sync()
    assert made == [] and syncs == [] and trace.TRACER.events() == []
    trace.enable()
    try:
        snap.maybe_snapshot(fields, 2)
        real_sync()
        events = trace.TRACER.events()
    finally:
        trace.disable()
        trace.reset()
        snap.close()
    assert syncs == [] and made
    copied = {k: v for k, v in bench.counter_deltas(before, bench.program_counters()).items()
              if k.startswith("cz_copy_bytes_total")}
    cells, qois = 64 ** 3, 2 * 2                          # two snapshots of p and rho
    assert copied == {
        "cz_copy_bytes_total{direction=d2h,pinned=false,site=snapshot.host_copy}": 4 * cells * qois,
        "cz_copy_bytes_total{direction=h2d,pinned=false,site=pipeline.to_device}": 4 * cells * qois,
        "cz_copy_bytes_total{direction=d2h,pinned=false,site=stage1.to_host}": 5 * cells * qois,
    }
    timed = [e for e in events
             if e["name"] in ("stage1.transform", "stage1.to_host", "kernel.execute")]
    assert sorted(e["name"] for e in timed) == ["kernel.execute"] * 2 + \
        ["stage1.to_host"] * 2 + ["stage1.transform"] * 2
    assert all(e["args"]["device_us"] > 0 for e in timed)
