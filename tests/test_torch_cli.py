"""The port's slices as a whole, on the CPU: the CLI generates a cavitation
snapshot, compresses every QoI through the wavelet pipeline (or the zfpx,
lorenzo or szx one), and each container it writes reads back in the JAX
package within the scheme's declared bound (100 eps; 16 eps for zfpx; eps
for lorenzo and szx) of the field."""
import json
import os
import pathlib
import shutil
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


def _dataset(root) -> None:
    """A dataset for the CLI: auto (a chunk mix), 8^3 blocks, 2 KiB chunks;
    timestep 0 of p and rho with stats, timestep 1 of p without."""
    from repro_torch.store import CZDataset

    f = tcavitation_fields(TCloudConfig(n=16), 9.4, device="cpu")
    spec = CompressionSpec(scheme="auto", block_size=8, buffer_bytes=1 << 11)
    with CZDataset(str(root), "a", spec=spec, stats=True, device="cpu") as ds:
        ds.append({"p": f["p"].numpy(), "rho": f["rho"].numpy()}, time=9.4)
    with CZDataset(str(root), "a", device="cpu") as ds:
        ds.append({"p": f["p"].numpy() + 1}, time=9.5)


@pytest.mark.parametrize("args", [["DIR"], ["URL"], ["--stats", "DIR"], ["--json", "DIR"],
                                  ["--stats", "FILE"]],
                         ids=["directory", "url", "stats", "json-directory", "stats-file"])
def test_inspect_refuses_dataset_roots(tmp_path, args):
    """Dataset roots were refused before the dataset layer was ported; now
    ``inspect`` of a directory root, a ``file://`` root, ``--stats`` and
    ``--json`` of a root print what the reference's CLI prints on the same
    tree, character for character, with its exit code.  ``--stats`` of one
    container is still refused, with the reference's usage error."""
    from repro.launch import compress as rcompress

    root = tmp_path / "ds"
    _dataset(root)
    path = {"DIR": str(root), "URL": f"file://{root}",
            "FILE": str(ROOT / "tests" / "data" / "cz2_zfpx.cz")}
    argv = ["inspect", *[path.get(a, a) for a in args]]
    got, want = _cli(compress, argv), _cli(rcompress, argv)
    if "FILE" in args:
        assert got[0] == want[0] == 2 and got[1] == want[1] == ""
        assert got[2].splitlines()[-1].split(": ", 2)[-1] == \
            want[2].splitlines()[-1].split(": ", 2)[-1] == \
            "--stats needs a CZDataset directory or store URL"
        return
    assert got == want
    assert got[0] == 0 and got[2] == ""
    if "--json" in args:
        doc = json.loads(got[1])
        assert doc["store"] == "CZDS" and len(doc["members"]) == 3
        assert all(m["crc_ok"] for m in doc["members"].values())
    elif "--stats" in args:
        assert "CZDataset v2, scheme auto" in got[1] and got[1].count(" - ") >= 1
    else:
        assert got[1].count("CRC verify   ok") == 3 and "chunk mix" in got[1]


@pytest.mark.parametrize("case", ["dry-run", "delete", "no-manifest"])
def test_gc_prints_what_the_reference_prints(tmp_path, case):
    """``gc [--dry-run]`` on a tree with an orphaned member, a stale
    ``.tmp`` and a member pending in a rank sidecar: the reference CLI's
    output and exit code; each deletes the same keys from its copy of the
    tree (never the sidecar's member), after which a dry run reports the
    dataset clean.  A root without a manifest fails alike."""
    from repro.launch import compress as rcompress
    from repro.store import manifest as rman

    root = tmp_path / "t"
    _dataset(root)
    side = rman.new_rank_manifest(2)
    side["entries"].append({"quantity": "p", "t": 5, "time": 9.6, "file": "p/t000005.cz",
                            "bytes": 4, "raw_bytes": 16384, "shape": [16] * 3,
                            "dtype": "float32"})
    rman.write_rank_manifest(str(root), side)
    for key in ("p/t000005.cz", "p/t000009.cz", "rho/t000001.cz.tmp"):
        (root / key).write_bytes(b"data")
    if case == "no-manifest":
        (root / "manifest.json").unlink()
    shutil.copytree(root, tmp_path / "r")
    flags = ["--dry-run"] if case == "dry-run" else []
    got = _cli(compress, ["gc", *flags, str(root)])
    want = _cli(rcompress, ["gc", *flags, str(tmp_path / "r")])
    assert got[0] == want[0]
    if case == "no-manifest":
        assert got[0] == 1 and got[1] == want[1] == ""
        assert got[2] == f"error: no manifest.json in {root}\n"
        assert want[2] == f"error: no manifest.json in {tmp_path / 'r'}\n"
        return
    assert got == want and got[0] == 0
    verb = "would delete" if flags else "deleted"
    assert got[1] == (f"{verb} p/t000009.cz\n{verb} rho/t000001.cz.tmp\n"
                      f"2 orphan(s) {'found' if flags else 'deleted'}\n")
    assert (root / "p" / "t000005.cz").exists()
    if not flags:
        for r in (root, tmp_path / "r"):
            again = _cli(compress, ["gc", "--dry-run", str(r)])
            assert again == _cli(rcompress, ["gc", "--dry-run", str(r)])
            assert again[1] == "dataset clean — no orphans\n"


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


# -- parallel, and --out as a store URL ----------------------------------------

def test_parallel_files_equal_reference_cli(tmp_path):
    """``parallel --device cpu --ranks 2 --check-identical --trace``: exit 0,
    every line ``bit-identical``, the files the reference CLI's ``parallel``
    writes for the same ``--source npy`` field, and one trace document with
    the parent's phases and a track per rank."""
    from repro.launch import compress as rcompress

    f = tcavitation_fields(TCloudConfig(n=32), 9.4, device="cpu")["p"].numpy()
    np.save(tmp_path / "p.npy", f)
    # 16^3 blocks, 16 KiB buffers: 8 chunks, 4 per rank
    common = ["parallel", "--ranks", "2", "--source", "npy", "--npy", str(tmp_path / "p.npy"),
              "--block-size", "16", "--buffer-bytes", "16384", "--check-identical"]
    code, out, _err = _cli(compress, [*common, "--device", "cpu", "--out", str(tmp_path / "t"),
                                      "--trace", str(tmp_path / "t.json")])
    assert code == 0, out
    lines = out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("field ranks=2 CR=")
    assert lines[0].endswith("[bit-identical]")
    assert lines[1] == f"trace written to {tmp_path / 't.json'}"
    assert _cli(rcompress, [*common, "--out", str(tmp_path / "r")])[0] == 0
    assert (tmp_path / "t" / "field.cz").read_bytes() == \
        (tmp_path / "r" / "field.cz").read_bytes()
    assert sorted(os.listdir(tmp_path / "t")) == ["field.cz"]
    doc = json.loads((tmp_path / "t.json").read_text())
    tracks = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
              if e["name"] == "process_name"}
    assert tracks[0] == "rank 0" and tracks[1] == "rank 1"
    for r in (0, 1):
        spans = {e["name"] for e in doc["traceEvents"] if e["pid"] == r and e["ph"] == "X"}
        assert {"encode", "stage1", "commit", "kernel.compile"} <= spans
    parent = {e["name"] for e in doc["traceEvents"] if e["pid"] not in (0, 1)}
    assert {"host_copy", "encode", "exscan", "commit", "decode"} <= parent


@pytest.mark.parametrize("sub", [[], ["parallel"]], ids=["compress", "parallel"])
def test_out_store_url_other_than_file_is_a_usage_error(tmp_path, sub):
    code, _out, err = _cli(compress, [*sub, "--device", "cpu", "--n", "32",
                                      "--out", "mem://x"])
    assert code == 2
    assert "--out 'mem://x': the ex-situ/parallel writers emit local files" in err


@pytest.mark.parametrize("sub", [[], ["parallel", "--ranks", "2", "--check-identical",
                                       "--buffer-bytes", "65536"]],
                         ids=["compress", "parallel"])
def test_out_file_url_writes_into_its_directory(tmp_path, monkeypatch, sub):
    """``--out file://DIR`` writes into DIR, not into a relative directory
    named after the URL."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "fields"
    code, text, err = _cli(compress, [*sub, "--device", "cpu", "--n", "64", "--qoi", "p",
                                      "--block-size", "16", "--out", f"file://{out}"])
    assert code == 0, err
    assert (out / "p.cz").is_file()
    assert sorted(os.listdir(tmp_path)) == ["fields"]
    if sub:
        assert text.startswith("p     ranks=2 ") and "[bit-identical]" in text
    dec = rcont.read_field(str(out / "p.cz"), device="host")
    f = tcavitation_fields(TCloudConfig(n=64), 9.4, device="cpu")["p"].numpy()
    assert np.max(np.abs(dec - f)) <= 100 * EPS
