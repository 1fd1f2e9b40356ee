"""The port's slice as a whole, on the CPU: the CLI generates a cavitation
snapshot, compresses every QoI through the wavelet pipeline, and each
container it writes reads back in the JAX package within the scheme's
declared bound (100 eps) of the reference generator's field."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.core import container as rcont
from repro.fields import CloudConfig, cavitation_fields

from repro_torch.core import container as tcont
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.launch import compress

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPS = 1e-3


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-W", "error", "-m",
                           "repro_torch.launch.compress", *args],
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_end_to_end_reads_back_in_reference(tmp_path):
    out = tmp_path / "fields"
    proc = _run("--device", "cpu", "--n", "64", "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    ref = cavitation_fields(CloudConfig(n=64), 9.4)
    report = json.loads((out / "report.json").read_text())
    assert report["spec"]["device"] == "host"
    assert list(report["fields"]) == list(ref)
    for q, field in ref.items():
        dec = rcont.read_field(str(out / f"{q}.cz"), device="host")
        assert np.max(np.abs(dec - field)) <= 100 * EPS, q
        r = report["fields"][q]
        assert r["max_abs_err"] <= 100 * EPS and r["cr"] > 1
        assert r["bytes"] == os.path.getsize(out / f"{q}.cz")
        stages = r["stage_s"]
        assert list(stages) == ["stage1", "serialize", "stage2_encode",
                                "stage2_decode", "deserialize"]
        assert all(v > 0 for v in stages.values()), stages
        assert sum(stages.values()) <= r["write_s"] + r["read_s"]



def test_cli_decompress_verifies(tmp_path, capsys):
    f = cavitation_fields(CloudConfig(n=32), 4.7)["rho"]
    np.save(tmp_path / "rho.npy", f)
    tcont.write_field(str(tmp_path / "rho.cz"), f, CompressionSpec(), device="cpu")
    assert compress.main(["--device", "cpu", "--decompress", str(tmp_path / "rho.cz"),
                          "--verify-against", str(tmp_path / "rho.npy")]) is None
    assert "PSNR vs reference" in capsys.readouterr().out


def test_cli_rejects_unported_scheme(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        compress.main(["--device", "cpu", "--n", "32", "--scheme", "zfpx",
                       "--out", str(tmp_path)])
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
