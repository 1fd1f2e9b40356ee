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


def _cli(module, args, stdin=None, monkeypatch=None):
    """Run a CLI's ``main`` in this process: (exit code, stdout, stderr)."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    code = 0
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            module.main(args)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def _inspect_files(tmp_path):
    """Every committed fixture, and a small auto file and a block batch
    written by the port."""
    data = ROOT / "tests" / "data"
    files = sorted(str(p) for p in data.glob("*.cz"))
    f = tcavitation_fields(TCloudConfig(n=16), 9.4, device="cpu")["p"].numpy()
    files.append(str(tmp_path / "auto.cz"))
    tcont.write_field(files[-1], f, CompressionSpec(scheme="auto", block_size=8,
                                                    buffer_bytes=1 << 12), device="cpu")
    files.append(str(tmp_path / "blocks.cz"))
    tcont.write_compressed(files[-1], f.reshape(-1, 8, 8, 8),
                           CompressionSpec(scheme="raw", block_size=8), device="cpu")
    return files


@pytest.mark.parametrize("flags", [[], ["--no-verify"], ["--json"], ["--json", "--no-verify"]],
                         ids=["text", "no-verify", "json", "json-no-verify"])
def test_inspect_prints_what_the_reference_prints(tmp_path, flags):
    """``inspect`` of a container: the reference CLI's output, character for
    character, and its exit code; a corrupt chunk fails both alike."""
    from repro.launch import compress as rcompress

    files = _inspect_files(tmp_path)
    bad = tmp_path / "bad.cz"
    blob = bytearray((ROOT / "tests" / "data" / "cz2_zfpx.cz").read_bytes())
    blob[20] ^= 0xFF  # inside the first chunk
    bad.write_bytes(bytes(blob))
    for path in [*files, str(bad)]:
        got = _cli(compress, ["inspect", *flags, path])
        want = _cli(rcompress, ["inspect", *flags, path])
        assert got == want, path
        verifying = "--no-verify" not in flags
        assert got[0] == (1 if path == str(bad) and verifying else 0)
    if "--json" in flags:
        doc = json.loads(_cli(compress, ["inspect", *flags, files[-2]])[1])
        assert doc["schemes"] and doc["scheme"] == "auto"


@pytest.mark.parametrize("args", [["DIR"], ["URL"], ["--stats", "FILE"], ["--json", "DIR"]],
                         ids=["directory", "url", "stats", "json-directory"])
def test_inspect_refuses_dataset_roots(tmp_path, args):
    """Dataset roots and ``--stats`` need the dataset layer: a usage error
    (exit 2) that names the roadmap item."""
    path = {"DIR": str(tmp_path), "URL": "mem://ds",
            "FILE": str(ROOT / "tests" / "data" / "cz2_zfpx.cz")}
    code, out, err = _cli(compress, ["inspect", *[path.get(a, a) for a in args]])
    assert code == 2 and out == ""
    assert "ROADMAP §1 item 5" in err and "CZDataset" in err


METRICS_TEXT = """\
# HELP cz_serve_queries_total Region queries.
# TYPE cz_serve_queries_total counter
cz_serve_queries_total{kind="region",status="ok"} 12
cz_serve_queries_total{kind="region",status="error"} 1
# HELP cz_store_op_seconds Store operation latency.
# TYPE cz_store_op_seconds histogram
cz_store_op_seconds_bucket{backend="file",op="get",le="0.001"} 3
cz_store_op_seconds_bucket{backend="file",op="get",le="+Inf"} 4
cz_store_op_seconds_sum{backend="file",op="get"} 0.0123456789
cz_store_op_seconds_count{backend="file",op="get"} 4
# HELP cz_up Up.
# TYPE cz_up gauge
cz_up 1
"""


@pytest.mark.parametrize("flags", [[], ["--json"], ["--buckets"], ["--json", "--buckets"]],
                         ids=["table", "json", "buckets", "json-buckets"])
@pytest.mark.parametrize("source", ["file", "stdin"])
def test_stats_prints_what_the_reference_prints(tmp_path, monkeypatch, flags, source):
    from repro.launch import compress as rcompress

    path = tmp_path / "m.txt"
    path.write_text(METRICS_TEXT)
    arg = str(path) if source == "file" else "-"
    stdin = METRICS_TEXT if source == "stdin" else None
    got = _cli(compress, ["stats", arg, *flags], stdin, monkeypatch)
    want = _cli(rcompress, ["stats", arg, *flags], stdin, monkeypatch)
    assert got == want
    assert got[0] == 0 and "cz_serve_queries_total" in got[1]
    if "--json" not in flags:  # JSON holds every sample
        assert ("cz_store_op_seconds_bucket" in got[1]) == ("--buckets" in flags)


def test_stats_of_the_process_registry_and_the_diff(tmp_path):
    """``stats`` with no source renders this process's registry (the port's
    series); ``--diff`` of two snapshots, as text and JSON, prints what the
    reference prints."""
    from repro.launch import compress as rcompress
    from repro_torch import obs as tobs

    tobs.counter("cz_torch_cli_probe_total", "A probe.").inc(3)
    code, out, _ = _cli(compress, ["stats"])
    assert code == 0 and "cz_torch_cli_probe_total" in out
    code, out, _ = _cli(compress, ["stats", "--json"])
    a = tmp_path / "a.json"
    a.write_text(out)
    tobs.REGISTRY.get("cz_torch_cli_probe_total").inc(2)
    b = tmp_path / "b.json"
    b.write_text(_cli(compress, ["stats", "--json"])[1])
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps({"schema": 1, "registry": tobs.snapshot()}))
    for pair in ((a, b), (b, a), (a, a), (a, snap)):
        for flags in ([], ["--json"]):
            args = ["stats", "--diff", str(pair[0]), str(pair[1]), *flags]
            got = _cli(compress, args)
            assert got == _cli(rcompress, args)
            assert got[0] == 0
    text = _cli(compress, ["stats", "--diff", str(a), str(b)])[1]
    assert "cz_torch_cli_probe_total" in text and "3 -> 5  (+2)" in text
    assert _cli(compress, ["stats", "--diff", str(a), str(a)])[1] == "no differences\n"


@pytest.mark.parametrize("args", [["-", "--watch", "1"], ["FILE", "--watch", "-1"]])
def test_stats_watch_refuses_as_the_reference(tmp_path, args):
    from repro.launch import compress as rcompress

    (tmp_path / "m.txt").write_text(METRICS_TEXT)
    args = ["stats", *[str(tmp_path / "m.txt") if a == "FILE" else a for a in args]]
    got, want = _cli(compress, args), _cli(rcompress, args)
    assert got[0] == want[0] == 2 and got[1] == want[1] == ""
    assert got[2].splitlines()[-1].split(": ", 2)[-1] == want[2].splitlines()[-1].split(": ", 2)[-1]


def test_decompress_reads_through_the_store(tmp_path, capsys, monkeypatch):
    """``--decompress`` goes through the store-backed ``read_field``: a file
    store on the file's directory, byte-range gets only."""
    from repro_torch.store import backends as tb

    f = tcavitation_fields(TCloudConfig(n=16), 9.4, device="cpu")["rho"].numpy()
    path = tmp_path / "rho.cz"
    tcont.write_field(str(path), f, CompressionSpec(scheme="lorenzo", block_size=8), device="cpu")
    gets = []
    real = tb.FileStore.get

    def spy(self, key, byte_range=None):
        gets.append((self.root, key, byte_range))
        return real(self, key, byte_range)

    monkeypatch.setattr(tb.FileStore, "get", spy)
    assert compress.main(["--device", "cpu", "--decompress", str(path)]) is None
    assert "decompressed (16, 16, 16)" in capsys.readouterr().out
    assert gets and all(r == str(tmp_path) and k == "rho.cz" and rng is not None
                        for r, k, rng in gets)
