"""Ex-situ compression tool of the port (``repro.launch.compress``).

Compresses 3D fields — from the cavitation generator or a .npy file — into
CZ2 containers on a torch device, reads each back, and reports CR, PSNR,
max error, max |x| and seconds per quantity (whole write and read, and per pipeline
stage); or decompresses one container.  ``parallel`` does the same through N
rank processes into one shared file per quantity (the paper's cluster tier).

Examples:
  python -m repro_torch.launch.compress --n 512 --t 9.4 --out artifacts/fields
  python -m repro_torch.launch.compress --device cpu --n 64 --out /tmp/fields
  python -m repro_torch.launch.compress --scheme zfpx --n 512 --out artifacts/zfpx
  python -m repro_torch.launch.compress --scheme lorenzo --n 512 --out artifacts/lorenzo
  python -m repro_torch.launch.compress --device cpu --scheme szx --n 64 --out /tmp/szx
  python -m repro_torch.launch.compress --scheme fpzipx --precision 16 --out /tmp/fpz
  python -m repro_torch.launch.compress --scheme auto --target psnr=80 --out /tmp/auto
  python -m repro_torch.launch.compress --scheme auto --trace t.json --out /tmp/auto
  python -m repro_torch.launch.compress --list-schemes
  python -m repro_torch.launch.compress --decompress artifacts/fields/p.cz \
      --verify-against p.npy
  python -m repro_torch.launch.compress parallel --ranks 4 --n 128 --out /tmp/fields
  python -m repro_torch.launch.compress parallel --device cpu --ranks 2 \
      --check-identical --trace t.json --out file:///tmp/fields
  python -m repro_torch.launch.compress inspect artifacts/fields/p.cz
  python -m repro_torch.launch.compress inspect --json artifacts/fields/p.cz
  python -m repro_torch.launch.compress inspect artifacts/dataset
  python -m repro_torch.launch.compress inspect --stats file:///data/run42
  python -m repro_torch.launch.compress gc --dry-run artifacts/dataset
  python -m repro_torch.launch.compress serve artifacts/dataset --port 8423
  python -m repro_torch.launch.compress serve --device cpu --port 0 /tmp/ds
  python -m repro_torch.launch.compress stats http://127.0.0.1:8423
  python -m repro_torch.launch.compress stats metrics.txt
  python -m repro_torch.launch.compress stats --diff a.json b.json

``--scheme auto`` picks the best registered scheme per chunk for the quality
target ``--target`` (``abs=V``, ``rel=V`` or ``psnr=DB``; default
``abs=<--eps>``); ``--tune-cache K`` reuses decisions for chunks with
matching statistics.  ``--trace OUT.json`` writes a Chrome trace of the
run's spans (stage 1, each chunk's encode and decode, trials, kernel
calls), viewable in Perfetto.

``--out`` is a directory path or a ``file://`` URL: the writers emit local
files (the ranks of ``parallel`` seek into one shared file), so any other
store URL is a usage error.  ``parallel --ranks N`` splits the chunk stream
into N contiguous spans, one per spawned rank process (each runs stage 1 on
``--device``, default ``cuda``), places the ranks' bytes by an exclusive
scan and writes the footer; ``--check-identical`` also writes each quantity
serially on the same device and exits 1 unless the two files are
bit-identical; ``--trace`` writes one merged Chrome trace, the parent's
phases and one track per rank.

``inspect PATH`` prints a container's header, chunk table and CRC verdicts
(``--json``: the same as one JSON document, ``container.describe``); of a
dataset root (a directory or a store URL: ``file://``, ``mem://``, ...) the
manifest summary and every member's table (``--json``: ``CZDataset.describe``
with the members' documents), and ``--stats`` the per-member CR/PSNR table.
``gc [--dry-run] ROOT`` lists, then deletes, a dataset's orphaned members.
``serve ROOT`` answers region queries over HTTP (``/v1/region``,
``/v1/manifest``, ``/healthz``, ``/metrics``, ``/debug/*``), every cold
chunk decoded on ``--device`` (default ``cuda``), until SIGINT.
``stats [SOURCE]`` pretty-prints a metrics snapshot (a running server's
``/metrics``, a file of Prometheus text, ``-`` for stdin, or this process's
registry), ``--diff A B`` the delta of two JSON snapshots.  Each prints what
the reference's ``cz-compress inspect``, ``gc`` and ``stats`` print.

The containers are readable by the reference (``repro``) and vice versa.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, obs
from repro_torch.core import container
from repro_torch.core.metrics import compression_ratio, psnr
from repro_torch.core.pipeline import STAGE_SECONDS, CompressionSpec
from repro_torch.core.schemes import get_scheme, scheme_names


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def _trace_scope(out_path: str | None):
    """Collect the port's spans for the duration and write a Chrome trace
    file on exit (no-op when ``out_path`` is falsy)."""
    if not out_path:
        yield
        return
    from repro_torch.obs import trace

    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        print(f"trace written to {trace.save(out_path)}")


def _validated_spec(ap: argparse.ArgumentParser,
                    spec: CompressionSpec) -> CompressionSpec:
    """Validate a CLI-built spec; an unknown scheme/dtype/... must be a
    clear usage error (exit 2), never a silent fallback."""
    try:
        return spec.validate()
    except ValueError as e:
        ap.error(str(e))


def _add_tune_args(ap: argparse.ArgumentParser) -> None:
    """The auto-tuning knobs, shared by the serial and parallel writers."""
    ap.add_argument("--target", default="", metavar="MODE=VALUE",
                    help="quality target for --scheme auto: abs=1e-3 "
                    "(max abs error), rel=1e-4 (x value range), or psnr=80 "
                    "(dB); default abs=<--eps>")
    ap.add_argument("--tune-cache", type=int, default=0, metavar="K",
                    help="with --scheme auto: reuse tuning decisions for "
                    "chunks with matching stats, re-trialling every K-th "
                    "occurrence (0 = trial every chunk, the default)")


def _tune_extra(ap: argparse.ArgumentParser, args) -> dict:
    """Fold the tuning flags into ``spec.extra``; reject them for fixed
    schemes so a typo'd --scheme never silently drops the quality target."""
    extra = {}
    if args.target:
        extra["target"] = args.target
    if args.tune_cache:
        extra["tune_cache"] = args.tune_cache
    if extra and args.scheme != "auto":
        ap.error("--target/--tune-cache only apply to --scheme auto")
    return extra


def _is_dataset_root(path: str) -> bool:
    """Store URLs are always dataset roots; plain paths are roots iff they
    are directories (a file path is a single .cz container)."""
    return "://" in path or os.path.isdir(path)


def _local_out_dir(ap: argparse.ArgumentParser, out: str) -> str:
    """Resolve --out for the ex-situ writers, which produce real local files
    (the rank-parallel engine's processes seek into ONE shared file): plain
    paths pass through, file:// URLs resolve to their directory, any other
    store scheme is a usage error."""
    if "://" not in out:
        return out
    from repro_torch.store.backends import FileStore, open_store

    store = open_store(out)
    if isinstance(store, FileStore):
        return store.root
    ap.error(f"--out {out!r}: the ex-situ/parallel writers emit local files "
             "(rank processes share one seekable file); use a plain path or "
             "a file:// URL")


def _inspect_container(path: str, verify: bool = True, store=None,
                       label: str | None = None) -> bool:
    """Print a CZ container's self-description; returns the CRC verdict.
    ``store`` reads the container from a byte store (``path`` is then a
    store key); ``label`` overrides the printed heading."""
    d = container.describe(path, verify=verify, store=store)
    magic = container.MAGIC_V1 if d["container"] == "CZ1" else container.MAGIC
    print(label or path)
    print(f"  magic        {magic!r}  (container "
          f"{'CZ1 legacy' if d['container'] == 'CZ1' else 'CZ2'}, "
          f"chunk format {d['format']})")
    print(f"  scheme       {d['scheme']}  params {d['scheme_params']}")
    if d.get("schemes"):
        mix = "  ".join(f"{name} x{cnt}" for name, cnt in d["schemes"].items())
        print(f"  chunk mix    {mix}")
    print(f"  dtype        {d['dtype']}")
    shape = d["field_shape"] if d["field_shape"] is not None else "(block batch)"
    print(f"  field_shape  {shape}  "
          f"nblocks {d['nblocks']}  block_size {d['block_size']}")
    if d["raw_bytes"]:
        print(f"  bytes        {d['compressed_bytes']} compressed / "
              f"{d['raw_bytes']} raw "
              f"(CR {d['raw_bytes']/max(1, d['compressed_bytes']):.2f}x)")
    ok = True
    mixed = bool(d.get("schemes"))
    scheme_col = f" {'scheme':>8}" if mixed else ""
    print(f"  {'chunk':>5} {'blocks':>7} {'bytes':>10}{scheme_col}  crc32")
    for row in d["chunks"]:
        crc = row["crc32"]
        if crc is None:
            verdict = "-"
        elif not verify:
            verdict = f"{crc:08x}"
        else:
            good = row["crc_ok"]
            ok &= good
            verdict = f"{crc:08x} {'ok' if good else 'MISMATCH'}"
        col = f" {row.get('scheme', '?'):>8}" if mixed else ""
        print(f"  {row['index']:>5} {row['blocks']:>7} {row['bytes']:>10}"
              f"{col}  {verdict}")
    print(f"  CRC verify   {'ok' if ok else 'FAILED'}")
    return ok


def _open_dataset(root: str, mode: str = "r"):
    """The dataset for ``inspect`` and ``gc``, which read manifests and
    container footers and decode nothing: no device is needed."""
    from repro_torch.store import CZDataset

    return CZDataset(root, mode, device="cpu")


def _inspect_dataset(root: str, verify: bool) -> bool:
    ok = True
    with _open_dataset(root) as ds:
        print(f"{root}: CZDataset v{ds.version}, spec {ds.spec.to_json()}")
        for q in ds.quantities:
            print(f"  {q}: shape {list(ds.shape(q))} dtype {ds.dtype(q)} "
                  f"timesteps {ds.timesteps(q)}")
            for ts in ds.timestep_info(q):
                ok &= _inspect_container(
                    ts["file"], verify, store=ds.store,
                    label=f"{root.rstrip('/')}/{ts['file']}")
    return ok


def _stats_table(root: str) -> int:
    """Per-member compression factor + PSNR table (the paper's testbed-of-
    comparison readout).  PSNR/max_err come from append-time stats
    (``CZDataset(..., stats=True)``); members appended without them show
    '-'."""
    with _open_dataset(root) as ds:
        print(f"{root}: CZDataset v{ds.version}, "
              f"scheme {ds.spec.scheme}, eps {ds.spec.eps}")
        print(f"  {'quantity':<12} {'t':>4} {'bytes':>12} {'raw':>12} "
              f"{'CR':>8} {'PSNR(dB)':>9} {'max_err':>10}")
        for q in ds.quantities:
            for ts in ds.timestep_info(q):
                cr = compression_ratio(ts["raw_bytes"], ts["bytes"])
                p = ts.get("psnr", "-")
                if p is None:
                    p = "exact"     # bit-exact member (recorded as null)
                elif isinstance(p, float):
                    p = f"{p:.2f}"
                e = ts.get("max_err", "-")
                if isinstance(e, float):
                    e = f"{e:.3e}"
                print(f"  {q:<12} {ts['t']:>4} {ts['bytes']:>12} "
                      f"{ts['raw_bytes']:>12} {cr:>8.2f} {p:>9} {e:>10}")
    return 0


def _inspect_json(path: str, verify: bool) -> int:
    """Machine-readable inspect: ``CZDataset.describe`` for a dataset root
    (with ``container.describe`` of every member), ``container.describe``
    for one container."""
    if _is_dataset_root(path):
        with _open_dataset(path) as ds:
            out = ds.describe()
            out["root"] = path
            out["members"] = {
                ts["file"]: container.describe(
                    ts["file"], verify=verify, store=ds.store)
                for q in ds.quantities for ts in ds.timestep_info(q)}
    else:
        out = container.describe(path, verify=verify)
    json.dump(out, sys.stdout, indent=1)
    print()
    members = out.get("members", {path: out} if "chunks" in out else {})
    bad = [m for m in members.values()
           if verify and m.get("crc_ok") is False]
    return 1 if bad else 0


def inspect_main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.compress inspect")
    ap.add_argument("path", help="a .cz container, a CZDataset directory, or "
                    "a store URL (file://, mem://, any registered scheme)")
    ap.add_argument("--no-verify", action="store_true",
                    help="print CRCs without re-reading chunk data")
    ap.add_argument("--stats", action="store_true",
                    help="per-member CR/PSNR table for a dataset root")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output: manifest + member/chunk "
                    "tables as one JSON document on stdout")
    args = ap.parse_args(argv)
    if args.stats:
        if not _is_dataset_root(args.path):
            ap.error("--stats needs a CZDataset directory or store URL")
        return _stats_table(args.path)
    if args.json:
        return _inspect_json(args.path, not args.no_verify)
    if _is_dataset_root(args.path):
        ok = _inspect_dataset(args.path, not args.no_verify)
    else:
        ok = _inspect_container(args.path, not args.no_verify)
    return 0 if ok else 1


def gc_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.compress gc",
        description="Delete orphaned dataset members (on disk but absent "
                    "from the manifest, e.g. after a torn append or an "
                    "aborted rank merge).  Members pending in rank sidecars "
                    "are never touched.")
    ap.add_argument("root", help="CZDataset directory or store URL "
                    "(file://, mem://)")
    ap.add_argument("--dry-run", action="store_true",
                    help="list orphans without deleting")
    args = ap.parse_args(argv)
    from repro_torch.store import MANIFEST_NAME, open_store

    if not open_store(args.root).exists(MANIFEST_NAME):
        print(f"error: no {MANIFEST_NAME} in {args.root}", file=sys.stderr)
        return 1
    with _open_dataset(args.root, "r" if args.dry_run else "a") as ds:
        orphans = ds.gc(dry_run=args.dry_run)
    verb = "would delete" if args.dry_run else "deleted"
    for rel in orphans:
        print(f"{verb} {rel}")
    if orphans:
        print(f"{len(orphans)} orphan(s) "
              f"{'found' if args.dry_run else 'deleted'}")
    else:
        print("dataset clean — no orphans")
    return 0


def parallel_main(argv) -> int:
    """Rank-parallel single-shared-file compression
    (:mod:`repro_torch.cluster.engine`), stage 1 on ``--device`` in every
    rank."""
    from repro_torch.cluster import ParallelCompressor
    from repro_torch.fields import CloudConfig, cavitation_fields

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.compress parallel")
    ap.add_argument("--ranks", type=int, default=4,
                    help="worker processes (the MPI-rank stand-in)")
    ap.add_argument("--source", default="cavitation",
                    choices=["cavitation", "npy"])
    ap.add_argument("--npy", default="", help="input .npy for --source npy")
    ap.add_argument("--t", type=float, default=9.4)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--qoi", default="p,rho,E,a2")
    ap.add_argument("--scheme", default="wavelet")
    ap.add_argument("--wavelet", default="w3ai")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--shuffle", default="byte")
    ap.add_argument("--zero-bits", type=int, default=0)
    ap.add_argument("--stage2", default="zlib")
    ap.add_argument("--precision", type=int, default=32)
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"],
                    help="torch device of stage 1 in every rank, of the "
                    "read-back and of --check-identical's serial write")
    ap.add_argument("--buffer-bytes", type=int, default=1 << 20)
    _add_tune_args(ap)
    ap.add_argument("--out", default="artifacts/fields",
                    help="output directory (plain path or file:// URL)")
    ap.add_argument("--check-identical", action="store_true",
                    help="also write serially and verify the shared file is "
                    "bit-identical (the engine's core guarantee)")
    ap.add_argument("--trace", metavar="OUT.json",
                    help="write one merged Chrome trace (parent phases + a "
                         "track per rank) — view in Perfetto")
    args = ap.parse_args(argv)
    args.out = _local_out_dir(ap, args.out)

    spec = _validated_spec(ap, CompressionSpec(
        scheme=args.scheme, wavelet=args.wavelet, eps=args.eps,
        block_size=args.block_size, shuffle=args.shuffle,
        zero_bits=args.zero_bits, stage2=args.stage2,
        precision=args.precision, buffer_bytes=args.buffer_bytes,
        extra=_tune_extra(ap, args)))
    if args.source == "npy":
        fields = {"field": np.load(args.npy).astype(np.float32)}
    else:
        fields = cavitation_fields(CloudConfig(n=args.n), args.t, device=args.device)
        fields = {k: v for k, v in fields.items() if k in args.qoi.split(",")}
    os.makedirs(args.out, exist_ok=True)

    ok = True
    with _trace_scope(args.trace), \
            ParallelCompressor(args.ranks, device=args.device) as pc:
        for name, f in fields.items():
            path = os.path.join(args.out, f"{name}.cz")
            t0 = time.perf_counter()
            nbytes = pc.compress(path, f, spec)
            dt = time.perf_counter() - t0
            dec = container.read_field(path, device=args.device)
            x = f.cpu().numpy() if isinstance(f, torch.Tensor) else f
            line = (f"{name:5s} ranks={args.ranks} "
                    f"CR={compression_ratio(x.nbytes, nbytes):8.2f} "
                    f"PSNR={psnr(x, dec):7.2f} dB "
                    f"{x.nbytes / 2**20 / dt:6.1f} MB/s -> {path}")
            if args.check_identical:
                ref = path + ".serial"
                container.write_field(ref, f, spec, device=args.device)
                with open(path, "rb") as a, open(ref, "rb") as b:
                    same = a.read() == b.read()
                os.unlink(ref)
                ok &= same
                line += f"  [{'bit-identical' if same else 'MISMATCH'}]"
            print(line)
    return 0 if ok else 1


def serve_main(argv) -> int:
    """HTTP region-query service over a CZDataset
    (:mod:`repro_torch.serve.http`), decoding on ``--device``."""
    from repro_torch.serve.http import main as http_main

    return http_main(argv)


def _stats_fetch(source: str | None) -> str:
    """One metrics snapshot as Prometheus text, from any stats source."""
    if source is None:
        return obs.render()
    if source.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(source.rstrip("/") + "/metrics") as r:
            return r.read().decode()
    if source == "-":
        return sys.stdin.read()
    with open(source) as f:
        return f.read()


def _metrics_table(samples: dict, buckets: bool) -> str:
    width = max((len(n) for n in samples), default=10)
    lines = []
    for name, rows in samples.items():
        if not buckets and name.endswith("_bucket"):
            continue
        for lbl, val in rows:
            ls = ",".join(f"{k}={v}" for k, v in lbl.items())
            ls = f"{{{ls}}}" if ls else ""
            v = int(val) if float(val).is_integer() else round(val, 6)
            lines.append(f"{name:<{width}} {ls:<28} {v}")
    return "\n".join(lines)


def _stats_flatten(doc: dict) -> dict:
    """Normalize any saved snapshot shape into ``{(name, labelstr): value}``:
    ``stats --json`` output, a raw :func:`repro_torch.obs.snapshot` dump,
    or a bench record (its registry dump under ``"registry"``).  Histogram
    samples flatten to ``name_count`` / ``name_sum`` entries."""
    if isinstance(doc.get("registry"), dict) and "schema" in doc:
        doc = doc["registry"]  # a bench record
    out: dict[tuple[str, str], float] = {}
    for name, val in doc.items():
        rows = val.get("samples") if isinstance(val, dict) else val
        if not isinstance(rows, list):
            continue
        for row in rows:
            if not isinstance(row, dict):
                continue
            lbl = row.get("labels") or {}
            key = ",".join(f"{k}={v}" for k, v in sorted(lbl.items()))
            if "value" in row:
                out[(name, key)] = float(row["value"])
            else:  # histogram sample: count + sum are the comparable scalars
                out[(f"{name}_count", key)] = float(row.get("count", 0))
                out[(f"{name}_sum", key)] = float(row.get("sum", 0.0))
    return out


def _stats_diff(path_a: str, path_b: str, as_json: bool) -> int:
    """``stats --diff A.json B.json``: what changed between two snapshots."""
    with open(path_a) as f:
        a = _stats_flatten(json.load(f))
    with open(path_b) as f:
        b = _stats_flatten(json.load(f))
    rows = []
    for key in sorted(set(a) | set(b)):
        va, vb = a.get(key), b.get(key)
        delta = (vb or 0.0) - (va or 0.0)
        if delta == 0.0 and va is not None and vb is not None:
            continue  # unchanged — noise in a delta report
        rows.append({"name": key[0], "labels": key[1], "a": va, "b": vb,
                     "delta": delta})
    if as_json:
        json.dump({"a": path_a, "b": path_b, "changed": rows}, sys.stdout, indent=1)
        print()
        return 0
    if not rows:
        print("no differences")
        return 0
    width = max(len(r["name"]) for r in rows)

    def fmt(v):
        if v is None:
            return "-"
        return str(int(v)) if float(v).is_integer() else f"{v:.6g}"

    for r in rows:
        ls = f"{{{r['labels']}}}" if r["labels"] else ""
        sign = "+" if r["delta"] >= 0 else ""
        print(f"{r['name']:<{width}} {ls:<28} "
              f"{fmt(r['a'])} -> {fmt(r['b'])}  ({sign}{fmt(r['delta'])})")
    return 0


def stats_main(argv) -> int:
    """Pretty-print a metrics snapshot: a server's ``/metrics``, saved
    exposition text, or this process's registry — optionally live
    (``--watch``) or as the delta of two saved snapshots (``--diff``)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.compress stats",
        description="Pretty-print a cz_* metrics snapshot.  SOURCE is an "
                    "http(s)://host:port of a running server (its /metrics is "
                    "fetched), a file of Prometheus text, or '-' for stdin; "
                    "omitted = this process's registry.")
    ap.add_argument("source", nargs="?")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON instead of the table")
    ap.add_argument("--buckets", action="store_true",
                    help="include histogram bucket rows")
    ap.add_argument("--watch", type=float, metavar="SECS",
                    help="redraw the table every SECS seconds until Ctrl-C")
    ap.add_argument("--diff", nargs=2, metavar=("A.json", "B.json"),
                    help="print the metric delta between two JSON snapshots "
                         "(stats --json output or bench records) and exit")
    args = ap.parse_args(argv)

    if args.diff:
        return _stats_diff(args.diff[0], args.diff[1], args.json)

    if args.watch:
        if args.source == "-":
            ap.error("--watch cannot re-read stdin; give a URL or file")
        if args.watch <= 0:
            ap.error("--watch needs a positive interval")
        try:
            while True:
                samples = obs.parse_prometheus(_stats_fetch(args.source))
                table = _metrics_table(samples, args.buckets)
                # clear screen + home, then one coherent frame
                sys.stdout.write(
                    f"\x1b[2J\x1b[H{args.source or '(process registry)'}  "
                    f"every {args.watch:g}s  (Ctrl-C to stop)\n{table}\n")
                sys.stdout.flush()
                time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0

    samples = obs.parse_prometheus(_stats_fetch(args.source))
    if args.json:
        json.dump({name: [{"labels": lbl, "value": val} for lbl, val in rows]
                   for name, rows in samples.items()}, sys.stdout, indent=1)
        print()
        return 0
    print(_metrics_table(samples, args.buckets))
    return 0


def main(argv=None) -> dict | None:
    """Run the CLI; returns the report it writes to ``report.json`` (``None``
    for ``--decompress``).  The subcommands ``inspect``, ``gc``,
    ``parallel``, ``serve`` and ``stats`` exit with their status, as the
    reference's do."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "inspect":
        raise SystemExit(inspect_main(argv[1:]))
    if argv and argv[0] == "gc":
        raise SystemExit(gc_main(argv[1:]))
    if argv and argv[0] == "parallel":
        raise SystemExit(parallel_main(argv[1:]))
    if argv and argv[0] == "serve":
        raise SystemExit(serve_main(argv[1:]))
    if argv and argv[0] == "stats":
        raise SystemExit(stats_main(argv[1:]))
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.compress")
    ap.add_argument("--source", default="cavitation", choices=["cavitation", "npy"])
    ap.add_argument("--npy", default="", help="input .npy for --source npy")
    ap.add_argument("--t", type=float, default=9.4, help="snapshot time (us)")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--qoi", default="p,rho,E,a2")
    ap.add_argument("--scheme", default="wavelet",
                    help=f"any registered scheme ({', '.join(scheme_names())})")
    ap.add_argument("--list-schemes", action="store_true",
                    help="print the scheme registry and exit")
    ap.add_argument("--wavelet", default="w3ai")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--shuffle", default="byte")
    ap.add_argument("--zero-bits", type=int, default=0)
    ap.add_argument("--stage2", default="zlib")
    ap.add_argument("--precision", type=int, default=32)
    _add_tune_args(ap)
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"],
                    help="torch device of stage 1 and of the decode")
    ap.add_argument("--out", default="artifacts/fields",
                    help="output directory (plain path or file:// URL)")
    ap.add_argument("--decompress", default="", metavar="FILE.cz")
    ap.add_argument("--verify-against", default="", metavar="FIELD.npy")
    ap.add_argument("--trace", metavar="OUT.json",
                    help="collect the port's spans (stage1/encode/decode, trials, "
                    "kernel calls) and write a Chrome trace — view in Perfetto")
    args = ap.parse_args(argv)
    args.out = _local_out_dir(ap, args.out)

    if args.list_schemes:
        for name in scheme_names():
            print(f"{name:10s} {type(get_scheme(name)).__module__}")
        return None
    with _trace_scope(args.trace):
        return _body(ap, args)


def _body(ap: argparse.ArgumentParser, args) -> dict | None:
    if args.decompress:
        t0 = time.perf_counter()
        field = container.read_field(args.decompress, device=args.device)
        print(f"decompressed {field.shape} in {time.perf_counter() - t0:.2f}s")
        if args.verify_against:
            ref = np.load(args.verify_against)
            print(f"PSNR vs reference: {psnr(ref, field):.2f} dB "
                  f"maxerr {np.max(np.abs(ref - field)):.3e}")
        return None

    spec = _validated_spec(ap, CompressionSpec(
        scheme=args.scheme, wavelet=args.wavelet, eps=args.eps,
        block_size=args.block_size, shuffle=args.shuffle,
        zero_bits=args.zero_bits, stage2=args.stage2,
        precision=args.precision, extra=_tune_extra(ap, args)))
    os.makedirs(args.out, exist_ok=True)

    t0 = time.perf_counter()
    if args.source == "npy":
        fields = {"field": np.load(args.npy).astype(np.float32)}
    else:
        from repro_torch.fields import CloudConfig, cavitation_fields

        fields = cavitation_fields(CloudConfig(n=args.n), args.t, device=args.device)
        fields = {k: v for k, v in fields.items() if k in args.qoi.split(",")}
    _sync(args.device)
    gen_s = time.perf_counter() - t0

    report = {}
    for name, f in fields.items():
        path = os.path.join(args.out, f"{name}.cz")
        before = dict(STAGE_SECONDS)
        t0 = time.perf_counter()
        nbytes = container.write_field(path, f, spec, device=args.device)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = container.read_field(path, device=args.device)
        read_s = time.perf_counter() - t0
        x = f.cpu().numpy() if isinstance(f, torch.Tensor) else f
        report[name] = {
            "cr": compression_ratio(x.nbytes, nbytes),
            "psnr_db": psnr(x, dec),
            "max_abs_err": float(np.max(np.abs(x - dec))),
            "max_abs": float(np.max(np.abs(x))),
            "bytes": nbytes,
            "write_s": write_s,
            "read_s": read_s,
            "stage_s": {k: v - before[k] for k, v in STAGE_SECONDS.items()},
        }
        r = report[name]
        print(f"{name:5s} CR={r['cr']:8.2f} PSNR={r['psnr_db']:7.2f} dB "
              f"maxerr={r['max_abs_err']:.3e} write {write_s:.2f}s "
              f"read {read_s:.2f}s -> {path}")
    print(f"generated {', '.join(fields)} in {gen_s:.2f}s")
    out = {"spec": spec.to_json(), "device": args.device, "generate_s": gen_s,
           "fields": report}
    with open(os.path.join(args.out, "report.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
