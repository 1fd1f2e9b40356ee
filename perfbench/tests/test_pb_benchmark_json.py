"""BENCHMARK.json against the contract's shape: keys, names, units, files,
and what each cell reports."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in BENCH["command"]:
        assert LINE.match(word)


def test_every_name_unit_and_line():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] \
            + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert LINE.match(text), text
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in BENCH[group]]
        assert len(ns) == len(set(ns))


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_setup_bound_and_each_cell_reports_enough():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        e2e = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [])]
        assert layer, cell
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files_hold_their_checks(name):
    c = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == name
    assert cfg["check"]["err_bound"] == 1.0          # the stated guarantee
    assert cfg["spec"]["eps"] == 1e-3 and cfg["spec"]["wavelet"] == "w3ai"


def test_full_check_fits_the_time_limit():
    # 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 s a cell to compile, 1200 spare
    r = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200
