"""Each cell's whole run on the CPU at a small size: the loop, the
program, the judgement and the readers; and the run broken underneath in
each way the cell can break, which the judgement has to catch."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from perfbench.harness import bench
from perfbench.tests._small import CELLS, overrides, run_small

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(workload):
    out = run_small(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in bench.load_cell(workload).end_to_end}
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-3] == "checks"  # last key of the printed line


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_the_span_and_counter_metrics(workload):
    out = run_small(workload, trace=True)
    assert out["correct"]
    names = set(out["metrics"])
    if "insitu" in workload:
        assert {"snapshot_share", "host_copy_ms", "stage1_ms", "encode_ms"} <= names
    else:
        assert names == {"chunk_cr"}
    # no card here: the device readers find nothing and say nothing
    assert "wavelet_fwd_roofline" not in names and "device_idle_share" not in names
    assert out["device"]["window_s"] > 0


def test_insitu_window_holds_whole_cycles():
    out = run_small("insitu.euler512.w3ai.every10", seconds=0.5)
    rec = out["_record"]
    assert rec["steps"] == 10 * rec["snapshots"] and rec["snapshots"] >= 1
    mcell = 64 ** 3 * rec["steps"] / rec["window_s"] / 1e6
    assert out["metrics"]["insitu_mcell_s"]["value"] == pytest.approx(mcell)


# -- faults planted in the program's timed path ------------------------------

def _stale_snapshot(monkeypatch):
    """A snapshot that hands on the state it saw before (a step that
    returns its state unchanged)."""
    from repro_torch.ckpt import FieldSnapshotter

    real, seen = FieldSnapshotter.maybe_snapshot, {}

    def stale(self, fields, step, force=False):
        old = seen.get("fields", fields)
        seen["fields"] = fields
        return real(self, old, step, force)
    monkeypatch.setattr(FieldSnapshotter, "maybe_snapshot", stale)


def _half_the_qois(monkeypatch):
    """Half of the batch left out: the snapshot commits p and drops rho."""
    from repro_torch.ckpt import FieldSnapshotter

    real = FieldSnapshotter.maybe_snapshot

    def half(self, fields, step, force=False):
        return real(self, dict(list(fields.items())[:1]), step, force)
    monkeypatch.setattr(FieldSnapshotter, "maybe_snapshot", half)


def _half_the_blocks(monkeypatch):
    """Half of the batch left out: stage 1 transforms the first half of
    the blocks and zeroes the rest."""
    from repro_torch.core.schemes.wavelet import WaveletScheme

    real = WaveletScheme.stage1

    def half(self, blocks, spec):
        blocks = blocks.clone()
        blocks[blocks.shape[0] // 2:] = 0
        return real(self, blocks, spec)
    monkeypatch.setattr(WaveletScheme, "stage1", half)


def _altered_coefficient(monkeypatch):
    """An answer altered where it is produced: one kept coefficient of
    each chunk changed by 4 eps."""
    from repro_torch.core.schemes.wavelet import WaveletScheme

    real = WaveletScheme.stage1

    def altered(self, blocks, spec):
        s1 = real(self, blocks, spec)
        s1["coeffs"] = s1["coeffs"].copy()
        s1["coeffs"][:, 0, 0, 0] += 4 * spec.eps
        s1["coarse"] = s1["coeffs"][..., :4, :4, :4]
        return s1
    monkeypatch.setattr(WaveletScheme, "stage1", altered)


def _wrong_time_tag(monkeypatch):
    """An answer altered: the snapshot committed under another step."""
    from repro_torch.ckpt import FieldSnapshotter

    real = FieldSnapshotter.maybe_snapshot
    monkeypatch.setattr(FieldSnapshotter, "maybe_snapshot",
                        lambda self, fields, step, force=False:
                        real(self, fields, step + (step > 0), True))


def _altered_read(monkeypatch):
    """An answer altered where it is produced: one value of what
    ``read_field`` gives back moved by 2 eps."""
    from repro_torch.core import container

    real = container.read_field

    def altered(*a, **k):
        out = np.array(real(*a, **k))
        out.flat[12345] += 2e-3
        return out
    monkeypatch.setattr(container, "read_field", altered)


INSITU_FAULTS = {"stale": _stale_snapshot, "half_qois": _half_the_qois,
                 "half_blocks": _half_the_blocks, "altered": _altered_coefficient,
                 "time_tag": _wrong_time_tag}
EXSITU_FAULTS = {"half_blocks": _half_the_blocks, "altered": _altered_coefficient,
                 "altered_read": _altered_read}


@pytest.mark.parametrize("workload", [c for c in CELLS if "insitu" in c])
@pytest.mark.parametrize("fault", sorted(INSITU_FAULTS))
def test_insitu_fault_is_not_correct(workload, fault, monkeypatch):
    INSITU_FAULTS[fault](monkeypatch)
    out = run_small(workload, seconds=0.2)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("fault", sorted(EXSITU_FAULTS))
def test_exsitu_fault_is_not_correct(fault, monkeypatch):
    EXSITU_FAULTS[fault](monkeypatch)
    out = run_small("exsitu.cav512.w3ai.t9_4", seconds=0.1)
    assert not out["correct"], (fault, out["checks"])


# -- the control: the reference in bfloat16 in the program's place -----------

@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits_at_a_small_size(workload):
    from perfbench import control

    for seed in (1, 2, 3):
        got = control.control(workload, seed, "cpu", overrides=overrides(workload))
        assert got["fails"], got


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits_at_the_cells_size(workload, cuda):
    from perfbench import control

    for seed in (11, 12, 13):
        assert control.control(workload, seed, cuda)["fails"]


# -- what a run may load -------------------------------------------------------

def test_dry_run_of_every_cell_loads_no_jax_and_no_reference_package(tmp_path):
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from perfbench.harness import bench\n"
        "from perfbench.tests._small import CELLS, run_small\n"
        "ok = [run_small(w, seconds=0.1)['correct'] for w in CELLS]\n"
        "print(json.dumps({'ok': ok, 'bad': bench.forbidden_modules(),\n"
        "                  'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path)},
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert all(got["ok"]) and got["bad"] == []
    assert "repro_torch" in got["tops"]            # the port was run ...
    assert not {"jax", "jaxlib", "flax", "repro", "benchmarks"} & set(got["tops"])


def test_a_run_writes_only_under_its_own_tmpdir(monkeypatch):
    monkeypatch.delenv("TMPDIR")
    with pytest.raises(RuntimeError, match="TMPDIR"):
        bench.data_dir("insitu.euler512.w3ai.every10")


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert "repro" not in bench.forbidden_modules()
    assert "jax" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in bench.forbidden_modules()
