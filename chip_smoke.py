#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. ``card``      the card (nvidia-smi name and power limit), torch and CUDA.
2. ``build``     builds the hand-written kernels from ``src/repro_torch/
                 kernels/csrc`` with nvcc, and times the build.
3. ``parity``    each kernel against its plain PyTorch version on the card:
                 w4i, w4l, w3ai; n in {8, 16, 32}; every valid level count;
                 B = 64 blocks uniform in [-50, 50].  Forward within
                 rtol=1e-5, atol=2e-3 (tests/test_kernels.py); inverse and
                 round trip within rtol=1e-5, atol=1e-4 * 50
                 (tests/test_kernels.py), except w4i at 3 levels, held to a
                 fixed atol=3e-2: its boundary extrapolation makes
                 coefficients of ~4e3, whose rounding the synthesis
                 amplifies, so over 64 blocks float32 itself exceeds
                 1e-4 * 50 there (the plain version's own round trip reads
                 1.0e-2 on the H100, the JAX package's 5.6e-3 on the CPU).
                 A block's output bits independent of the batch size.  Containers written on
                 the card decode on the CPU's plain path and the other way
                 round, within the scheme's bound of 100 eps.
4. ``main_path`` the CLI entry point, ``repro_torch.launch.compress.main``,
                 on one 512^3 cavitation snapshot at t = 9.4 us (the paper's
                 70-bubble cloud), all four QoIs, default spec (w3ai wavelet,
                 eps = 1e-3, 32^3 blocks, byte shuffle, zlib), on the card;
                 each container is read back on the card.  Per QoI: CR, PSNR,
                 max |x - x^|, which must be <= 100 eps, and seconds.  The
                 kernels' launch counts are zeroed just before and read just
                 after: each kernel must have run.  The CLI's report also
                 splits each QoI's write and read into the pipeline's stage
                 seconds (``core.pipeline.STAGE_SECONDS``).
5. ``kernels``   per kernel, at the main path's shapes (forward B = 4096,
                 inverse B = 32 blocks of 32^3): its launches on the main
                 path, max |kernel - plain|, the kernel's own time per launch
                 (``ms``: its device time in a torch.profiler trace of
                 back-to-back calls), the wrapper's time per call
                 (``call_ms``: median of CUDA events around one call, the
                 host's launch path included), the plain version's time,
                 and the least time the card could take (bytes over
                 3.35 TB/s, float32 flops over 67 TFLOP/s, NVIDIA's H100 SXM
                 figures).  No single PyTorch call computes this function,
                 so there is no library time.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32, outside the tensor cores
AMP = 50.0
FWD_TOL = dict(rtol=1e-5, atol=2e-3)
RT_TOL = dict(rtol=1e-5, atol=1e-4 * AMP)
# w4i at 3 levels: float32's own round trip exceeds RT_TOL (see above)
RT_TOL_W4I_L3 = dict(rtol=1e-5, atol=3e-2)
EPS = 1e-3
N_MAIN, T_MAIN = 512, 9.4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` launches of one call's time on the card, from
    CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """The kernel's own device time per launch, in ms, from
    a torch.profiler trace of ``reps`` back-to-back calls of ``fn``.  The
    trace can miss a launch at its start, so the mean is over those seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            us += ev.device_time_total
            count += ev.count
    check(reps // 2 <= count <= reps and us > 0,
          f"profiler saw {count} launches of {kernel} ({us} us) of {reps}")
    return us / 1e3 / count


def flops(kind: str, n: int, levels: int, nblocks: int) -> int:
    """Float32 operations of the transform (either direction): per output
    pair of each 1D step, the stencil's multiplies and adds plus the
    split/merge (8) and, for w4l, the update (3); 3 axes per level."""
    per_pair = 11 if kind == "w4l" else 8
    return nblocks * sum(3 * (n >> lv) ** 3 // 2 * per_pair for lv in range(levels))


def bound_ms(kind: str, n: int, levels: int, nblocks: int) -> tuple[float, str]:
    nbytes = 2 * nblocks * n ** 3 * 4  # each block read once and written once
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops(kind, n, levels, nblocks) / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_parity(torch, wv, kern, ops) -> dict:
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    worst = {"forward_vs_plain": 0.0, "inverse_vs_plain": 0.0, "round_trip": 0.0,
             "plain_round_trip": 0.0}
    per_case = {}
    for kind in wv.WAVELETS:
        for n in kern.SUPPORTED_SIDES:
            for lv in range(1, wv.max_levels(n) + 1):
                x = torch.rand((64, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
                y = ops.wavelet_forward(x, kind, lv)
                y_plain = wv.forward3d(x, kind, lv)
                back = ops.wavelet_inverse(y, kind, lv)
                back_plain = wv.inverse3d(y, kind, lv)
                torch.cuda.synchronize()
                tag = f"{kind} n={n} levels={lv}"
                plain_rt = (wv.inverse3d(y_plain, kind, lv) - x).abs().max().item()
                rt_tol = RT_TOL_W4I_L3 if (kind, lv) == ("w4i", 3) else RT_TOL
                errs = {"forward_vs_plain": (y - y_plain).abs().max().item(),
                        "inverse_vs_plain": (back - back_plain).abs().max().item(),
                        "round_trip": (back - x).abs().max().item(),
                        "plain_round_trip": plain_rt}
                check(torch.allclose(y, y_plain, **FWD_TOL), f"forward vs plain: {tag} {errs}")
                check(torch.allclose(back, back_plain, **rt_tol),
                      f"inverse vs plain: {tag} {errs}")
                check(torch.allclose(back, x, **rt_tol), f"round trip: {tag} {errs}")
                check(torch.equal(ops.wavelet_forward(x[:2].contiguous(), kind, lv), y[:2]),
                      f"forward batch invariance: {tag}")
                check(torch.equal(ops.wavelet_inverse(y[:2].contiguous(), kind, lv), back[:2]),
                      f"inverse batch invariance: {tag}")
                for k, e in errs.items():
                    worst[k] = max(worst[k], e)
                per_case[tag] = [errs[k] for k in worst]
    return {"cases": len(per_case), "blocks_per_case": 64, "max_abs_err": worst,
            "batch_invariant": True, "per_case_err": {"columns": list(worst), **per_case}}


def phase_interop(tmp: str) -> dict:
    """A small snapshot written on the card decodes on the CPU's plain path
    and the other way round, within the scheme's bound."""
    import numpy as np

    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.fields import CloudConfig, cavitation_fields

    f = cavitation_fields(CloudConfig(n=64), T_MAIN, device="cpu")["p"].numpy()
    spec = CompressionSpec()
    errs = {}
    for wdev, rdev in (("cuda", "cpu"), ("cpu", "cuda")):
        path = os.path.join(tmp, f"interop_{wdev}.cz")
        container.write_field(path, f, spec, device=wdev)
        with open(path, "rb") as fh:
            recorded = container._read_header(fh)[0]["spec"]["device"]
        check(recorded == ("jax" if wdev == "cuda" else "host"), f"device provenance {wdev}")
        dec = container.read_field(path, device=rdev)
        errs[f"{wdev}->{rdev}"] = float(np.max(np.abs(dec - f)))
        check(dec.shape == f.shape and np.isfinite(dec).all(), f"interop {wdev}->{rdev}")
        check(errs[f"{wdev}->{rdev}"] <= 100 * EPS, f"interop error {wdev}->{rdev}")
    return errs


def phase_main_path(tmp: str, kern) -> dict:
    from repro_torch.launch import compress

    out = os.path.join(tmp, "fields")
    for k in kern.LAUNCHES:
        kern.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    report = compress.main(["--source", "cavitation", "--n", str(N_MAIN),
                            "--t", str(T_MAIN), "--qoi", "p,rho,E,a2",
                            "--device", "cuda", "--out", out])
    total_s = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    fields = report["fields"]
    check(list(fields) == ["p", "rho", "E", "a2"], f"QoIs {list(fields)}")
    for q, r in fields.items():
        check(r["max_abs_err"] <= 100 * EPS, f"{q}: max error {r['max_abs_err']} > 100 eps")
        check(r["cr"] > 1 and r["psnr_db"] > 0, f"{q}: CR {r['cr']} PSNR {r['psnr_db']}")
    from repro_torch.core import container

    with open(os.path.join(out, "p.cz"), "rb") as fh:
        check(container._read_header(fh)[0]["spec"]["device"] == "jax",
              "main path header does not record the kernel path")
    return {"n": N_MAIN, "t_us": T_MAIN, "spec": "CompressionSpec() defaults",
            "generate_s": report["generate_s"], "total_s": total_s,
            "fields": fields, "launches": launches}


def phase_kernels(torch, wv, ops, launches: dict) -> list[dict]:
    g = torch.Generator(device="cuda")
    g.manual_seed(34)
    kind, n, lv = "w3ai", 32, 3   # the main path's spec
    nblocks = (N_MAIN // n) ** 3
    x = torch.rand((nblocks, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
    coeffs = ops.wavelet_forward(x, kind, lv)
    chunk = coeffs[:32].contiguous()  # one read-path chunk: 4 MiB of blocks
    rows = []
    for name, fn, plain, arg, reps in (
            ("wavelet3d_forward", ops.wavelet_forward, wv.forward3d, x, 20),
            ("wavelet3d_inverse", ops.wavelet_inverse, wv.inverse3d, chunk, 50)):
        err = (fn(arg, kind, lv) - plain(arg, kind, lv)).abs().max().item()
        check(err <= FWD_TOL["atol"] + FWD_TOL["rtol"] * arg.abs().max().item(),
              f"{name} vs plain at the main shape: {err}")
        b_ms, b_by = bound_ms(kind, n, lv, arg.shape[0])
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wavelet3d.cu",
            "replaces": "src/repro/kernels/wavelet3d.py:"
                        + ("139" if name.endswith("forward") else "145"),
            "launches": launches[name], "max_abs_err": err,
            "ms": kernel_ms(lambda: fn(arg, kind, lv), "wavelet3d_kernel", reps),
            "call_ms": median_ms(lambda: fn(arg, kind, lv), reps),
            "plain_ms": median_ms(lambda: plain(arg, kind, lv), 5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "blocks": int(arg.shape[0]),
        })
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.core import wavelets as wv
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import wavelet3d as kern

    card = smi()
    emit({"phase": "card", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = _build.BUILD_DIR / "libwavelet3d.so"
    if lib.exists():  # build from the sources, never from an earlier run
        lib.unlink()
    _build.load("wavelet3d")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": str(lib),
          "flags": list(_build.NVCC_FLAGS)})

    tmp = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        parity = phase_parity(torch, wv, kern, ops)
        parity["interop_max_abs_err"] = phase_interop(tmp)
        emit({"phase": "parity", **parity})
        main_path = phase_main_path(tmp, kern)
        emit({"phase": "main_path", **main_path})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = phase_kernels(torch, wv, ops, main_path["launches"])
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
