"""Ex-situ compression tool of the port (the serial path of
``repro.launch.compress``).

Compresses 3D fields — from the cavitation generator or a .npy file — into
CZ2 containers on a torch device, reads each back, and reports CR, PSNR,
max error, max |x| and seconds per quantity (whole write and read, and per pipeline
stage); or decompresses one container.

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

``--scheme auto`` picks the best registered scheme per chunk for the quality
target ``--target`` (``abs=V``, ``rel=V`` or ``psnr=DB``; default
``abs=<--eps>``); ``--tune-cache K`` reuses decisions for chunks with
matching statistics.  ``--trace OUT.json`` writes a Chrome trace of the
run's spans (stage 1, each chunk's encode and decode, trials, kernel
calls), viewable in Perfetto.

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

from repro_torch import DEFAULT_DEVICE
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


def main(argv=None) -> dict | None:
    """Run the CLI; returns the report it writes to ``report.json`` (``None``
    for ``--decompress``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
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
    ap.add_argument("--target", default="", metavar="MODE=VALUE",
                    help="quality target for --scheme auto: abs=1e-3 "
                    "(max abs error), rel=1e-4 (x value range), or psnr=80 "
                    "(dB); default abs=<--eps>")
    ap.add_argument("--tune-cache", type=int, default=0, metavar="K",
                    help="with --scheme auto: reuse tuning decisions for "
                    "chunks with matching stats, re-trialling every K-th "
                    "occurrence (0 = trial every chunk, the default)")
    ap.add_argument("--device", default=DEFAULT_DEVICE, choices=["cuda", "cpu"],
                    help="torch device of stage 1 and of the decode")
    ap.add_argument("--out", default="artifacts/fields", help="output directory")
    ap.add_argument("--decompress", default="", metavar="FILE.cz")
    ap.add_argument("--verify-against", default="", metavar="FIELD.npy")
    ap.add_argument("--trace", metavar="OUT.json",
                    help="collect the port's spans (stage1/encode/decode, trials, "
                    "kernel calls) and write a Chrome trace — view in Perfetto")
    args = ap.parse_args(argv)

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

    spec = CompressionSpec(scheme=args.scheme, wavelet=args.wavelet, eps=args.eps,
                           block_size=args.block_size, shuffle=args.shuffle,
                           zero_bits=args.zero_bits, stage2=args.stage2,
                           precision=args.precision, extra=_tune_extra(ap, args))
    try:
        spec.validate()
    except ValueError as e:
        ap.error(str(e))
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
