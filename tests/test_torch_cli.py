"""The port's slices as a whole, on the CPU: the CLI generates a cavitation
snapshot, compresses every QoI through the wavelet pipeline (or the zfpx,
lorenzo or szx one), and each container it writes reads back in the JAX
package within the scheme's declared bound (100 eps; 16 eps for zfpx; eps
for lorenzo and szx) of the field."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.core import CompressionSpec as RSpec
from repro.core import container as rcont
from repro.fields import CloudConfig, cavitation_fields

from repro_torch.core import container as tcont
from repro_torch.core.pipeline import CompressionSpec
from repro_torch.fields import CloudConfig as TCloudConfig
from repro_torch.fields import cavitation_fields as tcavitation_fields
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


def test_cli_zfpx_writes_and_decompress_verifies(tmp_path, capsys):
    """``--scheme zfpx`` on the CPU: the report has the wavelet path's
    fields, each container is the reference's bytes for the same field, and
    ``--decompress --verify-against`` reads one back."""
    out = tmp_path / "fields"
    report = compress.main(["--device", "cpu", "--scheme", "zfpx", "--n", "32",
                            "--qoi", "p,a2", "--out", str(out)])
    # the field the CLI compressed: the port's generator, on the CPU
    ref = {q: f.numpy() for q, f in
           tcavitation_fields(TCloudConfig(n=32), 9.4, device="cpu").items()}
    assert list(report["fields"]) == ["p", "a2"]
    for q, r in report["fields"].items():
        assert r["max_abs_err"] <= 16 * EPS and r["cr"] > 1
        assert list(r["stage_s"]) == ["stage1", "serialize", "stage2_encode",
                                      "stage2_decode", "deserialize"]
        rcont.write_field(str(tmp_path / f"{q}.ref.cz"), ref[q], RSpec(scheme="zfpx"))
        assert (out / f"{q}.cz").read_bytes() == (tmp_path / f"{q}.ref.cz").read_bytes()
    np.save(tmp_path / "p.npy", ref["p"])
    capsys.readouterr()
    assert compress.main(["--device", "cpu", "--decompress", str(out / "p.cz"),
                          "--verify-against", str(tmp_path / "p.npy")]) is None
    assert "PSNR vs reference" in capsys.readouterr().out


@pytest.mark.parametrize("scheme", ["lorenzo", "szx"])
def test_cli_lorenzo_szx_writes_and_decompress_verifies(tmp_path, capsys, scheme):
    """``--scheme lorenzo|szx`` on the CPU: each container is the
    reference's bytes for the same field and decodes within the scheme's
    bound (eps, up to float32's spacing of max|x|), and ``--decompress
    --verify-against`` reads one back."""
    out = tmp_path / "fields"
    report = compress.main(["--device", "cpu", "--scheme", scheme, "--n", "32",
                            "--qoi", "p,a2", "--out", str(out)])
    ref = {q: f.numpy() for q, f in
           tcavitation_fields(TCloudConfig(n=32), 9.4, device="cpu").items()}
    assert list(report["fields"]) == ["p", "a2"]
    for q, r in report["fields"].items():
        assert r["max_abs"] == float(np.max(np.abs(ref[q])))
        assert r["max_abs_err"] <= EPS * (1 + 1e-4) + np.spacing(np.float32(r["max_abs"]))
        assert r["cr"] > 1
        rcont.write_field(str(tmp_path / f"{q}.ref.cz"), ref[q], RSpec(scheme=scheme))
        assert (out / f"{q}.cz").read_bytes() == (tmp_path / f"{q}.ref.cz").read_bytes()
    np.save(tmp_path / "p.npy", ref["p"])
    capsys.readouterr()
    assert compress.main(["--device", "cpu", "--decompress", str(out / "p.cz"),
                          "--verify-against", str(tmp_path / "p.npy")]) is None
    assert "PSNR vs reference" in capsys.readouterr().out


def test_cli_rejects_unknown_scheme(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        compress.main(["--device", "cpu", "--n", "32", "--scheme", "fpzipy",
                       "--out", str(tmp_path)])
    assert exc.value.code == 2
    assert "unknown scheme 'fpzipy'" in capsys.readouterr().err


@pytest.mark.parametrize("args", [
    ["--scheme", "fpzipx"],
    ["--scheme", "fpzipx", "--precision", "16"],
    ["--scheme", "auto"],
    ["--scheme", "auto", "--target", "psnr=80", "--tune-cache", "2"],
], ids=["fpzipx", "fpzipx-p16", "auto", "auto-psnr-cache"])
def test_cli_fpzipx_auto_files_equal_reference_cli(tmp_path, args):
    """``--scheme fpzipx|auto`` at ``--device cpu``: the files the port's
    CLI writes are the reference CLI's bytes for the same field (a 32^3
    cavitation p from the port's generator, through ``--source npy``)."""
    from repro.launch import compress as rcompress

    f = tcavitation_fields(TCloudConfig(n=32), 9.4, device="cpu")["p"].numpy()
    np.save(tmp_path / "p.npy", f)
    common = ["--source", "npy", "--npy", str(tmp_path / "p.npy"), "--block-size", "16",
              *args]
    report = compress.main(["--device", "cpu", *common, "--out", str(tmp_path / "t")])
    rcompress.main([*common, "--out", str(tmp_path / "r")])
    got = (tmp_path / "t" / "field.cz").read_bytes()
    assert got == (tmp_path / "r" / "field.cz").read_bytes()
    r = report["fields"]["field"]
    if args == ["--scheme", "fpzipx"]:  # lossless
        assert r["max_abs_err"] == 0.0
    elif args == ["--scheme", "auto"]:  # the default target, abs=eps
        assert r["max_abs_err"] <= EPS * (1 + 1e-6) + np.spacing(np.float32(r["max_abs"]))


def test_cli_list_schemes_prints_all_seven(capsys):
    assert compress.main(["--list-schemes"]) is None
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == sorted(
        ["auto", "fpzipx", "lorenzo", "raw", "szx", "wavelet", "zfpx"])
    assert all(ln.split()[1].startswith("repro_torch.core.schemes.") for ln in lines)


def test_cli_tune_flags_need_scheme_auto(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        compress.main(["--device", "cpu", "--target", "abs=1e-3", "--out", str(tmp_path)])
    assert exc.value.code == 2
    assert "only apply to --scheme auto" in capsys.readouterr().err
