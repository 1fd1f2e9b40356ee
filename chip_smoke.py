#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. ``card``      the card (nvidia-smi name and power limit), torch and CUDA.
2. ``build``     builds the hand-written kernels from ``src/repro_torch/
                 kernels/csrc`` with nvcc, one nvcc per source, all started
                 together, and times the build.
3. ``parity``    each kernel against its plain PyTorch version on the card.
                 Wavelets: w4i, w4l, w3ai; n in {8, 16, 32, 64} at B = 64,
                 128 at B = 4, 256 at B = 2 (the cluster kernel to n = 64,
                 the staged one above); every valid level count; blocks
                 uniform in [-50, 50].  Forward within rtol=1e-5, atol=2e-3
                 (tests/test_kernels.py); inverse and round trip within
                 rtol=1e-5, atol=1e-4 * 50 (tests/test_kernels.py), except
                 w4i at 3 or more levels, held to a fixed atol=3e-2: its
                 boundary extrapolation makes coefficients of ~4e3, whose
                 rounding the synthesis amplifies, so over 64 blocks float32
                 itself exceeds 1e-4 * 50 there (the JAX package's own
                 round trip reads 5.6e-3 at 3 levels on the CPU).  A block's
                 output bits independent of the batch size.
                 zfpx: n in {8, 12, 16, 32, 64}, eps in {1e-4, 1e-3, 0}, B = 64
                 blocks uniform in [-50, 50] (the last 32 scaled by powers of
                 two) with the edge cells of tests/test_torch_zfpx.py in
                 blocks 1-5; emax, q and the decoded bits equal, bit for bit.
                 lorenzo: n in {4, 6, 7, 8, 10, 16, 24, 25, 32, 33, 64} at
                 B = 64 and n = 128 at B = 2 (the decode's cluster kernel to
                 n = 64, its staged path above), eps in {1e-4, 1e-3, 2e-7} (2e-7:
                 |q| > 2^24), blocks uniform in [-50, 50], at B = 64 with the
                 traps of tests/test_torch_lorenzo.py in blocks 1-4
                 (amplitude 3e4, NaN and inf, subnormals and zeros, values
                 on the half-grid); residuals and decoded bits equal, bit for
                 bit, the decode also of the first 1, 3 and 32 blocks, and
                 the round trip of the plain blocks within eps * (1 + 1e-4)
                 + spacing(50); residuals over all of int32 (wrapping) at
                 n = 16, 32 and 64, B = 64, and a subnormal 2 eps decode to
                 the same bits.
                 Containers written on the card decode on the CPU's plain
                 path and the other way round: wavelet within the scheme's
                 bound of 100 eps, with the chunk bytes of a container
                 written on the CPU; zfpx and lorenzo to the same bits as a
                 container written on the CPU, whose chunk bytes they have.
                 An szx file written by the CLI with --device cuda records
                 "host" (szx has no kernel, as in the reference) and
                 decodes within its bound.
   ``bits``      the wavelet kernels against the plain version on the CPU,
                 bit for bit: each kernel's input copied to the CPU, the
                 plain forward3d/inverse3d run there, the bits compared
                 (the inverse takes the kernel's forward output).  Every
                 kind; n in {8, 16, 32, 64}, every level count, B = 64;
                 n = 128, B = 1, full depth; amplitudes 50, 1e-36 and 1e-39
                 (subnormal intermediates and inputs); and n = 256, B = 1,
                 w3ai at full depth and amplitude 50.  Reports per case the
                 count of differing values and the largest difference; a
                 difference is reported, not failed.  Then the lorenzo
                 decode at n = 32, B = 32 and n = 64, B = 4 against the CPU's
                 plain version, on residuals over all of int32 and from an
                 encode: a differing value fails.
4. ``main_path`` the CLI entry point, ``repro_torch.launch.compress.main``,
                 on one 512^3 cavitation snapshot at t = 9.4 us (the paper's
                 70-bubble cloud), all four QoIs, default spec (w3ai wavelet,
                 eps = 1e-3, 32^3 blocks, byte shuffle, zlib), on the card;
                 each container is read back on the card.  Per QoI: CR, PSNR,
                 max |x - x^|, which must be <= 100 eps, and seconds.  The
                 kernels' launch counts are zeroed just before and read just
                 after: each kernel of the path must have run.  The CLI's
                 report also splits each QoI's write and read into the
                 pipeline's stage seconds (``core.pipeline.STAGE_SECONDS``).
   ``block64_path`` the same CLI run with ``--block-size 64`` (w3ai, 4
                 levels, 2^3 coarse corner) on the QoI p only: the cluster
                 kernels at n = 64 on the main path, within 100 eps, both
                 wavelet kernels launched (counts zeroed just before).
5. ``zfpx_path`` the same CLI run with ``--scheme zfpx`` (eps = 1e-3) on the
                 QoI p only (its four QoIs took 187-238 s, mostly zlib):
                 max |x - x^| <= 16 eps, the header records the kernel path,
                 and both zfpx kernels ran (counts zeroed just before).
6. ``lorenzo_path`` the same CLI run with ``--scheme lorenzo`` (eps = 1e-3),
                 on the QoI p only (its four took 285 s, 95% zlib): max
                 |x - x^| <= eps * (1 + 1e-4) + spacing(max|x|), the header
                 records the kernel path, and both lorenzo kernels ran
                 (counts zeroed just before).
   ``fpzipx``    fpzipx (no kernel: integer torch ops on the card) against
                 the CPU: the lossless round trip on the card bit-exact on
                 the edge values (NaN payload 0x7fc12345, +-0, 1e-40, +-inf,
                 +-FLT_MAX) and on 32 random +-50 blocks of 32^3; the
                 deltas of random bit patterns over all of uint32, and the
                 decode of random int32 deltas (wrapping sums), equal to the
                 CPU's bits; chunk bytes equal to the CPU's at precisions 32
                 and 16.
   ``auto_interop`` ``--scheme auto`` (default target abs = eps) written on
                 the card and on the CPU in this run: a 128^3 sub-volume of
                 the 512^3 p snapshot (32^3 blocks, 2 chunks), and
                 tests/data/golden_auto_input.npy under the fixture's spec
                 (8^3 blocks, 2 KiB buffer: one block per chunk).  The card's
                 and the CPU's files are byte-identical, footer
                 (``chunk_schemes``) included; the fixture's is the committed
                 tests/data/cz2_auto.cz.  The card decodes cz2_auto.cz to
                 cz2_auto.decoded.npy bit for bit.
   ``auto_path`` the CLI with ``--scheme auto --target abs=1e-3`` on the
                 512^3 p (32^3 blocks, 4 MiB chunks): each chunk's trials
                 encode and decode a 4-block sample under every other
                 scheme, the winner encodes the chunk.  Every one of the six
                 kernels must launch (counts zeroed just before); max
                 |x - x^| <= 1e-3 * (1 + 1e-6) + spacing(max|x|), the
                 trials' own slack; the header records "host", as the
                 reference's auto does.  Prints the footer's chunk mix, the
                 stage seconds, and the tuner's series (``cz_tune_*``).
   ``auto_trials`` the tuner's trials of every chunk of the same 512^3 p
                 (target abs=1e-3, 32^3 blocks, 4 MiB chunks: 128 chunks),
                 run on the card and on the CPU.  Every kernel call of the
                 card's trials is recorded and held to its plain version on
                 the same inputs, bit for bit: the trials' shapes (4-block
                 samples) and eps (zfpx 6.25e-5, lorenzo 1e-3, wavelet w3ai
                 at 3 levels).  Each chunk's trials (scheme, eps, nbytes,
                 max_err, psnr, admissible, error) and its ranking equal the
                 CPU's.
   ``region_path`` random access to the 512^3 p containers that main_path,
                 zfpx_path, lorenzo_path and auto_path wrote (kept for it):
                 for each, ``describe(verify=True)`` and ``inspect``;
                 ``read_field(device="cuda")`` through a MemoryStore and a
                 RangeStore with 2 ms per request (the wavelet container
                 also through a FileStore and an HttpStore on a loopback
                 StaticFileServer), each bit-equal to the MemoryStore read;
                 ``FieldReader`` boxes (one
                 block, an unaligned box of 8 chunks, a two-plane slab of 16
                 chunks, the whole field) on a fresh 2 ms RangeStore each,
                 cold then warm, bit-equal to the same slice, with
                 ``chunks_decoded`` the box's chunks; slab and field again
                 at prefetch 4 with the same bits, requests and bytes.  Each
                 read's launches: one decode launch per chunk decoded (none
                 for szx chunks), none on a warm read.  Prints per container
                 and box the cold and warm ms, the reader's fetch and decode
                 sums, and read_field's seconds per store.
   A kernel's launch count on a path is its wrapper's
   ``cz_kernel_calls_total{device="cuda"}`` series from repro_torch.obs,
   which the wrapper adds one to where its launch succeeded and nowhere
   else (exact under threads); each path sets it to 0 just before its run.
7. ``kernels``   one row per ported kernel, at its path's shapes (forward,
                 zfpx and lorenzo encode B = 4096, inverse, zfpx and lorenzo
                 decode B = 32 blocks of 32^3: one read-path chunk), the
                 wavelet kernels at n = 64 (forward B = 512, one QoI;
                 inverse B = 4, one read chunk), and the lorenzo decode at
                 n = 64 (B = 4, a read chunk) and the wavelet staged kernel
                 at n = 128 (B = 1, 5 levels): its launches on its path (the
                 n = 64 wavelet rows on block64_path; the lorenzo n = 64 and
                 wavelet n = 128 rows: the launches at that side counted per
                 side over every path's run, 0 while no path runs it),
                 max |kernel - plain| (every kernel is held
                 to its plain version bit for bit), the kernel's own time per
                 call (``ms``: its device time in a torch.profiler trace of
                 back-to-back calls; the staged wavelet kernel's 15 launches
                 summed), the lorenzo decode's design as its library
                 reports it (cluster or staged, planes per CTA, CTAs per
                 block), the wrapper's time per call
                 (``call_ms``: median of CUDA events around one call, the
                 host's launch path included), the plain version's time,
                 and the least time the card could take (bytes over
                 3.35 TB/s; the wavelets' float32 flops over 67 TFLOP/s,
                 NVIDIA's H100 SXM figures; zfpx's and lorenzo's int32 and
                 float32 operations over 16.7 Tops/s, its 64 int32 lanes per
                 SM).  No single PyTorch call computes any of these
                 functions, so there is no library time.  Each row also
                 carries its launches on auto_path (``auto_path_launches``)
                 and on region_path (``region_path_launches``).

The parity, bits and kernels lines carry their phase's seconds.  The last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
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
# H100 SXM int32: 132 SMs x 64 int32 lanes x 1.98 GHz (the float32 figure
# above counts 128 lanes x 2 flops per FMA); zfpx's operations are int32 and
# float32 ones at one per lane and clock, so they are held to this rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
AMP = 50.0
FWD_TOL = dict(rtol=1e-5, atol=2e-3)
RT_TOL = dict(rtol=1e-5, atol=1e-4 * AMP)
# w4i at 3 or more levels: float32's own round trip exceeds RT_TOL (see above)
RT_TOL_W4I_L3 = dict(rtol=1e-5, atol=3e-2)
# (n, B) of the wavelet parity cases: the cluster kernel to n = 64, the
# staged kernel above
PARITY_SIDES = ((8, 64), (16, 64), (32, 64), (64, 64), (128, 4), (256, 2))
# (n, B) of the lorenzo parity cases: the decode's cluster kernel to n = 64
# (whole blocks per CTA to 16, slabs above; 24: a short last slab; 7, 25
# and 33: odd sides, loaded without bulk copies, 25 and 33 in clusters of 5
# and 11), the staged path at 128
LORENZO_PARITY_SIDES = ((4, 64), (6, 64), (7, 64), (8, 64), (10, 64), (16, 64), (24, 64),
                        (25, 64), (32, 64), (33, 64), (64, 64), (128, 2))
BIT_AMPLITUDES = (AMP, 1e-36, 1e-39)
EPS = 1e-3
ZFPX_BOUND = 16 * EPS       # the zfpx scheme's declared bound
N_MAIN, T_MAIN = 512, 9.4
KERNEL_SOURCES = ("wavelet3d", "zfp_transform", "lorenzo")
ZFPX_PATH_QOIS = ("p",)     # one QoI: its four took 187-238 s, mostly zlib
LORENZO_PATH_QOIS = ("p",)  # one QoI: its four took 285 s, 95% zlib
AUTO_TARGET = 1e-3          # auto_path's target, abs=1e-3
# each kernel row's label in cz_kernel_calls_total
KERNEL_LABELS = {"wavelet3d_forward": "wavelet_forward", "wavelet3d_inverse": "wavelet_inverse",
                 "zfpx_encode": "zfpx_encode", "zfpx_decode": "zfpx_decode",
                 "lorenzo_encode": "lorenzo_encode", "lorenzo_decode": "lorenzo_decode"}


def auto_bound(max_abs: float) -> float:
    """What the tuner's trials allow a target abs=1e-3: the target plus one
    float32 ulp at max |x| (repro_torch/tune/trial.py)."""
    import numpy as np

    return AUTO_TARGET * (1 + 1e-6) + float(np.spacing(np.float32(max_abs)))


def lorenzo_bound(max_abs: float, eps: float = EPS) -> float:
    """The lorenzo and szx bound as the reference's tests hold it
    (tests/test_kernels.py): eps, plus float32's spacing of max |x|, since
    past |q| = 2^24 the grid is coarser than 2 eps."""
    import numpy as np

    return eps * (1 + 1e-4) + float(np.spacing(np.float32(max_abs)))


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


def kernel_ms(fn, kernel: str, reps: int, per_call: int = 1) -> float:
    """The kernel's own device time per call, in ms, from a torch.profiler
    trace of ``reps`` back-to-back calls of ``fn``: every CUDA kernel whose
    name holds ``kernel`` counts, ``per_call`` of them in each call (a
    staged path's launches).  The trace can miss a launch at its
    start, so the mean is over those seen; a trace that saw fewer than half
    the launches is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                us += ev.device_time_total
                count += ev.count
        if reps // 2 <= count / per_call <= reps and us > 0:
            break
    check(reps // 2 <= count / per_call <= reps and us > 0,
          f"profiler saw {count} launches of {kernel} ({us} us) of {reps} x {per_call}")
    return us / 1e3 / (count / per_call)


def wavelet_flops(kind: str, n: int, levels: int, nblocks: int) -> int:
    """Float32 operations of the transform (either direction): per output
    pair of each 1D step, the stencil's multiplies and adds plus the
    split/merge (8) and, for w4l, the update (3); 3 axes per level."""
    per_pair = 11 if kind == "w4l" else 8
    return nblocks * sum(3 * (n >> lv) ** 3 // 2 * per_pair for lv in range(levels))


def bound_ms(nbytes: int, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time for moving ``nbytes`` once through HBM and doing
    ``ops`` at ``ops_per_s``: the larger of the two, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wavelet_bound_ms(kind: str, n: int, levels: int, nblocks: int) -> tuple[float, str]:
    nbytes = 2 * nblocks * n ** 3 * 4  # each block read once and written once
    return bound_ms(nbytes, wavelet_flops(kind, n, levels, nblocks), FP32_FLOPS_PER_S)


# zfpx operations per 4^3 cell: the lifting (16 per 4-vector, 16 vectors per
# axis, 3 axes) and, per value, encode's flush (2), |x| and max (2), scale
# (1), conversion (1) and truncation (2), or decode's conversion (1), scale
# (1) and flush (2)
ZFPX_LIFT_OPS = 3 * 16 * 16


def zfpx_bound_ms(n: int, nblocks: int, decode: bool) -> tuple[float, str]:
    nc = (n // 4) ** 3
    # the float32 blocks one way, the int32 q and emax streams the other
    nbytes = nblocks * (n ** 3 * 4 + nc * 64 * 4 + nc * 4)
    ops = nblocks * nc * (ZFPX_LIFT_OPS + 64 * (4 if decode else 8))
    return bound_ms(nbytes, ops, INT32_OPS_PER_S)


# lorenzo operations per element: the quantizer (2 multiplies, 2 roundings,
# the FMA, the add, the conversion and 4 flushes of 2 each) and the three
# differences (encode); the three sums, the conversion, the product and its
# flush (decode)
LORENZO_ENC_OPS, LORENZO_DEC_OPS = 18, 7


def lorenzo_bound_ms(n: int, nblocks: int, decode: bool) -> tuple[float, str]:
    nbytes = 2 * nblocks * n ** 3 * 4  # 4 bytes in and 4 out per element
    ops = nblocks * n ** 3 * (LORENZO_DEC_OPS if decode else LORENZO_ENC_OPS)
    return bound_ms(nbytes, ops, INT32_OPS_PER_S)


def phase_parity(torch, wv, ops) -> dict:
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    worst = {"forward_vs_plain": 0.0, "inverse_vs_plain": 0.0, "round_trip": 0.0,
             "plain_round_trip": 0.0}
    per_case = {}
    for kind in wv.WAVELETS:
        for n, nb in PARITY_SIDES:
            for lv in range(1, wv.max_levels(n) + 1):
                x = torch.rand((nb, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
                y = ops.wavelet_forward(x, kind, lv)
                y_plain = wv.forward3d(x, kind, lv)
                back = ops.wavelet_inverse(y, kind, lv)
                back_plain = wv.inverse3d(y, kind, lv)
                torch.cuda.synchronize()
                tag = f"{kind} n={n} levels={lv}"
                plain_rt = (wv.inverse3d(y_plain, kind, lv) - x).abs().max().item()
                rt_tol = RT_TOL_W4I_L3 if kind == "w4i" and lv >= 3 else RT_TOL
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
    return {"cases": len(per_case), "sides_blocks": PARITY_SIDES, "max_abs_err": worst,
            "batch_invariant": True, "per_case_err": {"columns": list(worst), **per_case}}


def phase_bits(torch, wv, sz, ops) -> dict:
    """The wavelet kernels against the plain version on the CPU, bit for
    bit: differences are counted and reported, not failed.  Then the
    lorenzo decode at its read chunks (n = 32, B = 32; n = 64, B = 4), on
    residuals over all of int32 and from an encode: integer-exact, so a
    difference fails."""
    g = torch.Generator(device="cuda")
    g.manual_seed(90)
    cases = [(amp, kind, n, lv, 64) for amp in BIT_AMPLITUDES for kind in wv.WAVELETS
             for n in (8, 16, 32, 64) for lv in range(1, wv.max_levels(n) + 1)]
    cases += [(amp, kind, 128, 5, 1) for amp in BIT_AMPLITUDES for kind in wv.WAVELETS]
    cases.append((AMP, "w3ai", 256, 6, 1))
    per_case, differing, worst = {}, 0, 0.0
    for amp, kind, n, lv, nb in cases:
        x = (torch.rand((nb, n, n, n), generator=g, device="cuda") * 2 - 1) * amp
        y = ops.wavelet_forward(x, kind, lv)
        z = ops.wavelet_inverse(y, kind, lv)
        x_cpu, y_cpu, z_cpu = x.cpu(), y.cpu(), z.cpu()
        row = []
        for got, want in ((y_cpu, wv.forward3d(x_cpu, kind, lv)),
                          (z_cpu, wv.inverse3d(y_cpu, kind, lv))):
            diff = got.view(torch.int32) != want.view(torch.int32)
            row += [int(diff.sum()), _max_abs_diff(got, want) if diff.any() else 0.0]
        check(all(torch.isfinite(t).all() for t in (y_cpu, z_cpu)), f"bits: non-finite output {n}")
        per_case[f"{kind} n={n} L={lv} B={nb} amp={amp:g}"] = row
        differing += row[0] + row[2]
        worst = max(worst, row[1], row[3])
    lorenzo = {}
    for n, nb in ((32, 32), (64, 4)):
        x = torch.rand((nb, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
        full = torch.randint(-2 ** 31, 2 ** 31, (nb, n, n, n), generator=g, device="cuda",
                             dtype=torch.int64).to(torch.int32)
        for source, r in (("int32", full), ("encode", ops.lorenzo_encode(x, EPS))):
            got, want = ops.lorenzo_decode(r, EPS).cpu(), sz.decode(r.cpu(), EPS)
            differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            lorenzo[f"lorenzo_decode n={n} B={nb} {source}"] = differ
            check(differ == 0, f"bits: lorenzo decode n={n} {source}: {differ} values differ")
    return {"cases": len(per_case), "bit_equal_cases": sum(r[0] + r[2] == 0 for r in
                                                           per_case.values()),
            "differing_values": differing, "max_abs_diff": worst,
            "per_case": {"columns": ["fwd_differing", "fwd_max_abs_diff", "inv_differing",
                                     "inv_max_abs_diff"], **per_case},
            "lorenzo_differing_values": lorenzo}


def zfpx_batch(torch, g, n: int):
    """B = 64 blocks of side n uniform in [-50, 50], the last 32 scaled by
    2^-16 .. 2^15, with the edge cells of tests/test_torch_zfpx.py as cell 0
    of blocks 1-5: a subnormal max (emax -127), emax -101 (an infinite
    scale, with zeros and subnormals), subnormals in a cell of emax -98,
    emax 128, and zeros."""
    x = torch.rand((64, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
    x[32:] *= torch.exp2(torch.arange(-16.0, 16.0, device="cuda")).view(32, 1, 1, 1)
    u = torch.rand((4, 4, 4), generator=g, device="cuda") * 2 - 1
    tiny = torch.where(u.abs() < 0.15, u * 0, u.sign() * 1e-39)
    small = torch.where(u.abs() < 0.5, u.sign() * 1.1e-38, u * 2.0 ** -98)
    for b, cell in enumerate((u * 1e-39, torch.where(u.abs() < 0.3, tiny, u * 2.0 ** -101),
                              small, u * (2.0 ** 127 * 1.9), u * 0), start=1):
        x[b, :4, :4, :4] = cell
    return x


ZFPX_EDGE_EMAX = [-127, -101, -98, 128, -127]


def phase_zfpx_parity(torch, zf, ops) -> dict:
    """The zfpx kernels against their plain version on the card, bit for bit."""
    g = torch.Generator(device="cuda")
    g.manual_seed(56)
    cases, worst = 0, 0.0
    for n in (8, 12, 16, 32, 64):
        for eps in (1e-4, 1e-3, 0.0):  # eps = 0 truncates no planes
            tag = f"zfpx n={n} eps={eps}"
            x = zfpx_batch(torch, g, n)
            e, q = ops.zfpx_encode(x, eps)
            e_plain, q_plain = zf.encode(x, eps)
            d = ops.zfpx_decode(e, q, eps, n)
            d_plain = zf.decode(e_plain, q_plain, eps, n)
            torch.cuda.synchronize()
            check(e[1:6, 0].tolist() == ZFPX_EDGE_EMAX, f"{tag}: edge cells {e[1:6, 0].tolist()}")
            check(_bit_equal(torch, e, e_plain), f"{tag}: emax differs from the plain version")
            check(_bit_equal(torch, q, q_plain), f"{tag}: q differs from the plain version")
            check(_bit_equal(torch, d, d_plain),
                  f"{tag}: decoded bits differ from the plain version")
            if eps > 0:  # the bound is 16 eps; unscaled blocks, no edge cell
                err = (d[6:32] - x[6:32]).abs().max().item()
                check(err <= 16 * eps, f"{tag}: round trip {err} > 16 eps")
                worst = max(worst, err)
            cases += 1
    return {"cases": cases, "blocks_per_case": 64, "bit_exact": True,
            "edge_emax": ZFPX_EDGE_EMAX, "round_trip_max_abs_err": worst}


def lorenzo_batch(torch, g, n: int, eps: float, nb: int = 64):
    """``nb`` blocks of side n uniform in [-50, 50]; when nb = 64, with the
    traps of tests/test_torch_lorenzo.py: block 1 at amplitude 3e4 (the
    FMA), block 2 with NaN and +-inf, block 3 subnormal with zeros, block 4
    on the half-grid of 2 eps."""
    x = torch.rand((nb, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
    if nb < 64:
        return x
    x[1] *= 600.0
    flat = x[2].view(-1)
    flat[::7] = float("nan")
    flat[1::11] = float("inf")
    flat[2::13] = -float("inf")
    u = torch.rand((n, n, n), generator=g, device="cuda") * 2 - 1
    x[3] = torch.where(u.abs() < 0.2, u * 0, u * 1.1e-38)
    k = torch.randint(-1000, 1000, (n, n, n), generator=g, device="cuda")
    x[4] = (k.float() + 0.5) * 2 * eps
    return x


def phase_lorenzo_parity(torch, sz, ops) -> dict:
    """The lorenzo kernels against their plain version on the card, bit for
    bit; the round trip of the plain blocks within the reference's bound.
    The decode also at B = 1, 3 and 32 (a CTA holding fewer blocks than its
    share, a cluster per block)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(78)
    cases, worst = 0, {}
    for n, nb in LORENZO_PARITY_SIDES:
        for eps in (1e-4, 1e-3, 2e-7):
            tag = f"lorenzo n={n} B={nb} eps={eps}"
            x = lorenzo_batch(torch, g, n, eps, nb)
            r, r_plain = ops.lorenzo_encode(x, eps), sz.encode(x, eps)
            d, d_plain = ops.lorenzo_decode(r, eps), sz.decode(r_plain, eps)
            torch.cuda.synchronize()
            check(_bit_equal(torch, r, r_plain), f"{tag}: residuals differ from the plain one")
            check(_bit_equal(torch, d, d_plain), f"{tag}: decoded bits differ from the plain one")
            for b in (1, 3, 32):
                if b < nb:
                    check(_bit_equal(torch, ops.lorenzo_decode(r[:b], eps), d_plain[:b]),
                          f"{tag}: decode of the first {b} blocks differs from the plain one")
            plain = slice(5, None) if nb == 64 else slice(None)  # the blocks without traps
            err = (d[plain] - x[plain]).abs().max().item()
            bound = lorenzo_bound(AMP, eps)
            check(err <= bound, f"{tag}: round trip {err} > {bound}")
            worst[str(eps)] = max(worst.get(str(eps), 0.0), err)
            cases += 1
    # wrapping sums over all of int32 where slabs carry into each other, and
    # a subnormal 2 eps (decodes to zeros)
    for n in (16, 32, 64):
        for eps in (1e-3, 5e-39):
            r = torch.randint(-2 ** 31, 2 ** 31, (64, n, n, n), generator=g, device="cuda",
                              dtype=torch.int64).to(torch.int32)
            d = ops.lorenzo_decode(r, eps)
            check(_bit_equal(torch, d, sz.decode(r, eps)),
                  f"lorenzo decode n={n} eps={eps}: int32 range")
            cases += 1
    return {"cases": cases, "sides_blocks": LORENZO_PARITY_SIDES, "bit_exact": True,
            "round_trip_max_abs_err_by_eps": worst}


def _recorded_device(container, path: str) -> str:
    with open(path, "rb") as fh:
        return container._read_header(fh)[0]["spec"]["device"]


def phase_interop(tmp: str) -> dict:
    """A small snapshot written on the card decodes on the CPU's plain path
    and the other way round: wavelet within the scheme's bound, zfpx to the
    same bits as a container written on the CPU."""
    import numpy as np

    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.fields import CloudConfig, cavitation_fields

    f = cavitation_fields(CloudConfig(n=64), T_MAIN, device="cpu")["p"].numpy()
    spec = CompressionSpec()
    errs, paths = {}, {}
    for wdev, rdev in (("cuda", "cpu"), ("cpu", "cuda")):
        path = paths[wdev] = os.path.join(tmp, f"interop_{wdev}.cz")
        container.write_field(path, f, spec, device=wdev)
        check(_recorded_device(container, path) == ("jax" if wdev == "cuda" else "host"),
              f"device provenance {wdev}")
        dec = container.read_field(path, device=rdev)
        errs[f"{wdev}->{rdev}"] = float(np.max(np.abs(dec - f)))
        check(dec.shape == f.shape and np.isfinite(dec).all(), f"interop {wdev}->{rdev}")
        check(errs[f"{wdev}->{rdev}"] <= 100 * EPS, f"interop error {wdev}->{rdev}")
    check(list(container.iter_compressed(paths["cuda"]))
          == list(container.iter_compressed(paths["cpu"])),
          "wavelet chunks written on the card differ from the CPU's")

    zspec = CompressionSpec(scheme="zfpx")
    for wdev in ("cuda", "cpu"):
        paths[wdev] = os.path.join(tmp, f"interop_zfpx_{wdev}.cz")
        container.write_field(paths[wdev], f, zspec, device=wdev)
        check(_recorded_device(container, paths[wdev]) == ("jax" if wdev == "cuda" else "host"),
              f"zfpx device provenance {wdev}")
    check(list(container.iter_compressed(paths["cuda"]))
          == list(container.iter_compressed(paths["cpu"])),
          "zfpx chunks written on the card differ from the CPU's")
    want = container.read_field(paths["cpu"], device="cpu")
    for wdev in ("cuda", "cpu"):
        for rdev in ("cpu", "cuda"):
            dec = container.read_field(paths[wdev], device=rdev)
            check(np.array_equal(dec.view(np.int32), want.view(np.int32)),
                  f"zfpx decode {wdev}->{rdev} differs from cpu->cpu")
    zerr = float(np.max(np.abs(want - f)))
    check(zerr <= ZFPX_BOUND, f"zfpx interop error {zerr}")

    lspec = CompressionSpec(scheme="lorenzo")
    for wdev in ("cuda", "cpu"):
        paths[wdev] = os.path.join(tmp, f"interop_lorenzo_{wdev}.cz")
        container.write_field(paths[wdev], f, lspec, device=wdev)
        check(_recorded_device(container, paths[wdev]) == ("jax" if wdev == "cuda" else "host"),
              f"lorenzo device provenance {wdev}")
    check(list(container.iter_compressed(paths["cuda"]))
          == list(container.iter_compressed(paths["cpu"])),
          "lorenzo chunks written on the card differ from the CPU's")
    want = container.read_field(paths["cpu"], device="cpu")
    for wdev in ("cuda", "cpu"):
        for rdev in ("cpu", "cuda"):
            dec = container.read_field(paths[wdev], device=rdev)
            check(np.array_equal(dec.view(np.int32), want.view(np.int32)),
                  f"lorenzo decode {wdev}->{rdev} differs from cpu->cpu")
    lerr = float(np.max(np.abs(want - f)))
    check(lerr <= lorenzo_bound(float(np.max(np.abs(f)))), f"lorenzo interop error {lerr}")

    # szx has no kernel: on the card its plain math runs as torch ops, and
    # the header says "host", as the reference's does
    from repro_torch.launch import compress

    out = os.path.join(tmp, "interop_szx")
    report = compress.main(["--source", "cavitation", "--n", "64", "--t", str(T_MAIN),
                            "--qoi", "p", "--device", "cuda", "--scheme", "szx",
                            "--out", out])
    check(_recorded_device(container, os.path.join(out, "p.cz")) == "host",
          "szx written on the card does not record host")
    serr = report["fields"]["p"]["max_abs_err"]
    check(serr <= lorenzo_bound(report["fields"]["p"]["max_abs"]), f"szx interop error {serr}")
    return {"wavelet_max_abs_err": errs, "wavelet_chunks_identical": True,
            "zfpx_chunks_identical": True,
            "zfpx_decodes_identical": True, "zfpx_max_abs_err": zerr,
            "lorenzo_chunks_identical": True, "lorenzo_decodes_identical": True,
            "lorenzo_max_abs_err": lerr, "szx_recorded_device": "host",
            "szx_max_abs_err": serr}


FLT_MAX_BITS = 0x7F7FFFFF
# the lossless round trip's edge values, as float32 bit patterns: a NaN
# payload, +0, -0, 1e-40 (subnormal), +-inf, +-FLT_MAX
FPZIPX_EDGES = (0x7FC12345, 0x00000000, 0x80000000, 0x000116C2, 0x7F800000, 0xFF800000,
                FLT_MAX_BITS, 0x80000000 | FLT_MAX_BITS)


def phase_fpzipx(tmp: str) -> dict:
    """fpzipx on the card against the CPU: lossless round trip bit-exact on
    the edge values and on random +-50 blocks; deltas over all of uint32 and
    the decode's wrapping int32 sums equal to the CPU's; chunk bytes equal
    to the CPU's at precisions 32 and 16."""
    import numpy as np
    import torch

    from repro_torch.core import container
    from repro_torch.core import fpzipx as fpz
    from repro_torch.core.pipeline import CompressionSpec

    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    x = torch.rand((32, 32, 32, 32), generator=g, device="cuda") * (2 * AMP) - AMP
    edges = torch.tensor(np.array(FPZIPX_EDGES, np.uint32).view(np.int32), device="cuda")
    x.view(torch.int32).view(-1)[: 64 * edges.numel()] = edges.repeat(64)
    back = fpz.decode(fpz.encode(x))
    check(torch.equal(back.view(torch.int32), x.view(torch.int32)),
          "fpzipx: the lossless round trip on the card is not bit-exact")
    bits = torch.randint(-2 ** 31, 2 ** 31, (8, 32, 32, 32), generator=g, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    cases = 0
    for p in (32, 16, 8):
        d = fpz.encode(bits.view(torch.float32), precision=p)
        check(torch.equal(d.cpu(), fpz.encode(bits.cpu().view(torch.float32), precision=p)),
              f"fpzipx deltas at precision {p} differ from the CPU's")
        cases += 1
    check(torch.equal(fpz.decode(bits).cpu().view(torch.int32),
                      fpz.decode(bits.cpu()).view(torch.int32)),
          "fpzipx decode (wrapping int32 sums) differs from the CPU's")
    f = x.cpu().numpy()  # the 32 blocks, edges included, 4 chunks of 8
    nbytes = {}
    for p in (32, 16):
        spec = CompressionSpec(scheme="fpzipx", precision=p, buffer_bytes=1 << 20)
        paths = {}
        for dev in ("cuda", "cpu"):
            paths[dev] = os.path.join(tmp, f"fpzipx_{p}_{dev}.cz")
            container.write_field(paths[dev], f, spec, device=dev)
        check(list(container.iter_compressed(paths["cuda"]))
              == list(container.iter_compressed(paths["cpu"])),
              f"fpzipx chunks at precision {p} written on the card differ from the CPU's")
        dec = container.read_field(paths["cpu"], device="cuda")
        if p == 32:
            check(np.array_equal(dec.view(np.int32), f.view(np.int32)),
                  "fpzipx container round trip on the card is not bit-exact")
        nbytes[p] = os.path.getsize(paths["cuda"])
    return {"edges": [f"0x{b:08x}" for b in FPZIPX_EDGES], "round_trip_bit_exact": True,
            "delta_cases": cases, "decode_wraps_as_cpu": True,
            "chunks_identical_precisions": [32, 16], "container_bytes": nbytes}


def phase_auto_interop(tmp: str, p512) -> dict:
    """``auto`` written on the card and on the CPU: byte-identical files, the
    footer's chunk_schemes included, for a 128^3 sub-volume of the 512^3 p
    and for the golden fixture's input under its spec (which must give the
    committed cz2_auto.cz); the card decodes cz2_auto.cz bit for bit."""
    import numpy as np

    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec

    data = os.path.join(ROOT, "tests", "data")
    sub = p512[192:320, 192:320, 192:320].contiguous().cpu().numpy()
    cases = {"p_128": (sub, CompressionSpec(scheme="auto")),
             "golden_auto_input": (np.load(os.path.join(data, "golden_auto_input.npy")),
                                   CompressionSpec(scheme="auto", eps=1e-3, block_size=8,
                                                   buffer_bytes=1 << 11))}
    out = {}
    for name, (f, spec) in cases.items():
        files = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"auto_{name}_{dev}.cz")
            container.write_field(path, f, spec, device=dev)
            with open(path, "rb") as fh:
                files[dev] = fh.read()
        check(files["cuda"] == files["cpu"],
              f"auto {name}: the file written on the card differs from the CPU's")
        with open(path, "rb") as fh:
            header = container._read_header(fh)[0]
        dec = container.read_field(path, device="cuda")
        err = float(np.max(np.abs(dec - f)))
        check(err <= EPS * (1 + 1e-6) + float(np.spacing(np.float32(np.abs(f).max()))),
              f"auto {name}: max error {err}")
        out[name] = {"bytes": len(files["cuda"]), "chunk_schemes": header["chunk_schemes"],
                     "max_abs_err": err}
    with open(os.path.join(data, "cz2_auto.cz"), "rb") as fh:
        check(fh.read() == files["cuda"], "auto: the card's fixture file is not cz2_auto.cz")
    dec = container.read_field(os.path.join(data, "cz2_auto.cz"), device="cuda")
    want = np.load(os.path.join(data, "cz2_auto.decoded.npy"))
    check(dec.dtype == want.dtype and np.array_equal(dec.view(np.int32), want.view(np.int32)),
          "auto: cz2_auto.cz decoded on the card differs from cz2_auto.decoded.npy")
    return {"cases": out, "card_equals_cpu": True, "fixture_equals_cz2_auto": True,
            "cz2_auto_decodes_bit_exact": True}


def phase_auto_trials(torch, wv, zf, sz, ops, p512) -> dict:
    """The tuner's trials of every chunk of the 512^3 p, as auto_path makes
    them, on the card and on the CPU.  Each kernel call of the card's trials
    is recorded (inputs and output copied at the call) and held to its plain
    version on the same inputs, bit for bit; each chunk's trials and ranking
    must equal the CPU's."""
    import threading

    from repro_torch.core import blocks as blk
    from repro_torch.core.pipeline import CompressionSpec, Pipeline
    from repro_torch.tune import bound, trial

    plain = {"wavelet_forward": wv.forward3d, "wavelet_inverse": wv.inverse3d,
             "zfpx_encode": zf.encode, "zfpx_decode": zf.decode,
             "lorenzo_encode": sz.encode, "lorenzo_decode": sz.decode}
    real = {name: getattr(ops, name) for name in plain}
    calls, lock = [], threading.Lock()

    def copy(v):
        if isinstance(v, tuple):
            return tuple(copy(t) for t in v)
        return v.clone() if isinstance(v, torch.Tensor) else v

    def recording(name):
        def call(*a, **k):
            out = real[name](*a, **k)
            with lock:
                calls.append((name, copy(a), copy(k), copy(out)))
            return out
        return call

    def sig(a, k) -> str:
        vals = [list(v.shape) if isinstance(v, torch.Tensor) else v for v in a]
        return json.dumps([vals, {kk: v for kk, v in sorted(k.items())}])

    def scores(d) -> list:
        return [(t.scheme, t.eps, t.nbytes, t.max_err, t.psnr, t.admissible, t.error)
                for t in d.trials]

    spec = CompressionSpec(scheme="auto", extra={"target": f"abs={AUTO_TARGET:g}"})
    target = bound.target_from_spec(spec)
    blocks = blk.blockify(p512, spec.block_size)
    host = blocks.cpu().numpy()
    bpc = Pipeline(spec, device="cpu").blocks_per_chunk
    checked = {name: 0 for name in plain}
    inputs = {name: set() for name in plain}
    winners = {}
    for lo in range(0, host.shape[0], bpc):
        ci = lo // bpc
        for name in plain:
            setattr(ops, name, recording(name))
        try:
            card = trial.run_trials(blocks[lo:lo + bpc], spec, target, host[lo:lo + bpc])
        finally:
            for name, fn in real.items():
                setattr(ops, name, fn)
        chunk_cpu = torch.from_numpy(host[lo:lo + bpc])
        cpu = trial.run_trials(chunk_cpu, spec, target, host[lo:lo + bpc])
        for name, a, k, out in calls:
            check(_bit_equal(torch, out, plain[name](*a, **k)),
                  f"auto trials, chunk {ci}: {name} at {sig(a, k)} differs from its "
                  "plain version")
            checked[name] += 1
            inputs[name].add(sig(a, k))
        calls.clear()
        check(scores(card) == scores(cpu),
              f"auto trials, chunk {ci}: the card's trials {scores(card)} differ from "
              f"the CPU's {scores(cpu)}")
        check([(c.scheme, c.eps) for c in card.ranked] == [(c.scheme, c.eps) for c in cpu.ranked],
              f"auto trials, chunk {ci}: the card's ranking differs from the CPU's")
        w = f"{card.winner.scheme} eps={card.winner.eps:g}"
        winners[w] = winners.get(w, 0) + 1
    check(all(checked.values()), f"auto trials: a kernel never ran: {checked}")
    return {"chunks": host.shape[0] // bpc, "target": str(target),
            "kernel_calls_bit_exact": checked,
            "kernel_inputs": {k: sorted(v) for k, v in inputs.items()},
            "trials_equal_cpu": True, "winners": winners}


def _cuda_launches() -> dict:
    """Per kernel row, its wrapper's launches on the card so far
    (``cz_kernel_calls_total{device="cuda"}``)."""
    from repro_torch import obs

    calls = obs.REGISTRY.get("cz_kernel_calls_total")
    return {k: calls.value(kernel=v, device="cuda") for k, v in KERNEL_LABELS.items()}


def _zero_launches(sides: list[dict]) -> None:
    """Set every launch count to 0: per wrapper on the card, and per
    (wrapper, block side) in ``sides``."""
    from repro_torch import obs

    calls = obs.REGISTRY.get("cz_kernel_calls_total")
    for label in KERNEL_LABELS.values():
        calls.set_total(0, kernel=label, device="cuda")
    for c in sides:
        c.clear()


# the kernels line's rows at a block side of their own, and the per-side
# count each reads
SIDE_ROWS = (("wavelet3d_forward_n64", "wavelet3d_forward n=64"),
             ("wavelet3d_inverse_n64", "wavelet3d_inverse n=64"),
             ("lorenzo_decode_n64", "lorenzo_decode n=64"),
             ("wavelet3d_forward_n128", "wavelet3d_forward n=128"),
             ("wavelet3d_inverse_n128", "wavelet3d_inverse n=128"))


def _path_rows(run: dict) -> dict:
    """Each kernels-line row's launches in one path's run: per wrapper from
    ``launches``, and the side rows from ``launches_by_side``."""
    rows = {k: run["launches"][k] for k in KERNEL_LABELS}
    rows.update({row: run["launches_by_side"].get(key, 0) for row, key in SIDE_ROWS})
    return rows


def _tune_series() -> dict:
    """The tuner's series so far: trials per scheme, cache hits, and the
    decision-time histogram."""
    from repro_torch import obs

    snap = obs.snapshot()
    return {k: snap[k]["samples"] for k in ("cz_tune_trials_total", "cz_tune_cache_hits_total",
                                            "cz_tune_decision_seconds") if k in snap}


def _series_delta(before: dict, after: dict) -> dict:
    """``after`` minus ``before`` for :func:`_tune_series` snapshots."""
    out = {}
    for name, rows in after.items():
        old = {json.dumps(r["labels"], sort_keys=True): r for r in before.get(name, [])}
        out[name] = []
        for r in rows:
            o = old.get(json.dumps(r["labels"], sort_keys=True))
            if "value" in r:
                out[name].append({"labels": r["labels"],
                                  "value": r["value"] - (o["value"] if o else 0)})
            else:
                ob = dict(map(tuple, o["buckets"])) if o else {}
                out[name].append({"labels": r["labels"],
                                  "count": r["count"] - (o["count"] if o else 0),
                                  "sum": r["sum"] - (o["sum"] if o else 0.0),
                                  "buckets": [[b if b != float("inf") else "+Inf",
                                               c - ob.get(b, 0)] for b, c in r["buckets"]]})
    return out


def run_cli_path(tmp: str, name: str, scheme_args: list[str], spec: str, bound,
                 kernels: tuple[str, ...], sides: list[dict],
                 qois: tuple[str, ...] = ("p", "rho", "E", "a2"),
                 recorded: str = "jax", keep: str | None = None) -> dict:
    """One 512^3 snapshot through the CLI on the card, every launch count
    (per wrapper, and per wrapper and block side in ``sides``) set to 0
    just before and read just after; each of ``kernels`` must run.
    ``bound(max_abs)`` is
    the scheme's bound for a QoI of that max |x|; ``recorded`` the device
    the header must record.  Returns the footer's chunk mix per QoI and the
    tuner's series of the run too.  ``keep`` is a path the run's p.cz is
    moved to (for region_path) before the rest is removed."""
    from repro_torch.core import container
    from repro_torch.launch import compress

    out = os.path.join(tmp, name)
    tune0 = _tune_series()
    _zero_launches(sides)
    t0 = time.perf_counter()
    report = compress.main(["--source", "cavitation", "--n", str(N_MAIN),
                            "--t", str(T_MAIN), "--qoi", ",".join(qois),
                            "--device", "cuda", "--out", out, *scheme_args])
    total_s = time.perf_counter() - t0
    launches = _cuda_launches()
    by_side = {f"{k} n={n}": v for c in sides for (k, n), v in sorted(c.items())}
    for k in kernels:
        check(launches[k] > 0, f"{k} never launched on the {name} path")
    fields = report["fields"]
    check(list(fields) == list(qois), f"QoIs {list(fields)}")
    mix = {}
    for q, r in fields.items():
        b = bound(r["max_abs"])
        check(r["max_abs_err"] <= b, f"{name} {q}: max error {r['max_abs_err']} > {b}")
        check(r["cr"] > 1 and r["psnr_db"] > 0, f"{name} {q}: CR {r['cr']} PSNR {r['psnr_db']}")
        with open(os.path.join(out, f"{q}.cz"), "rb") as fh:
            header = container._read_header(fh)[0]
        check(header["spec"]["device"] == recorded,
              f"{name} {q} header records {header['spec']['device']}, not {recorded}")
        if "chunk_schemes" in header:
            tally = {}
            for rec in header["chunk_schemes"]:
                key = f"{rec['scheme']} eps={rec['eps']:g}"
                tally[key] = tally.get(key, 0) + 1
            mix[q] = tally
    if keep:
        os.makedirs(os.path.dirname(keep), exist_ok=True)
        os.replace(os.path.join(out, "p.cz"), keep)
    shutil.rmtree(out, ignore_errors=True)
    res = {"n": N_MAIN, "t_us": T_MAIN, "spec": spec, "qois": list(qois),
           "generate_s": report["generate_s"], "total_s": total_s,
           "fields": fields, "launches": launches, "launches_by_side": by_side}
    if mix:
        res["chunk_mix"] = mix
        res["tune"] = _series_delta(tune0, _tune_series())
    return res


# region_path: the p containers kept from the paths, and the kernel that
# decodes each chunk scheme (szx, like raw and fpzipx, has none)
REGION_CONTAINERS = ("wavelet", "zfpx", "lorenzo", "auto")
DECODE_KERNEL = {"wavelet": "wavelet3d_inverse", "zfpx": "zfpx_decode",
                 "lorenzo": "lorenzo_decode"}
# boxes [lo, hi) of the 512^3 field: (a) one block, (b) an unaligned box of
# 4x4x4 blocks in 8 chunks, (c) a two-plane slab across the middle, 16
# chunks, (d) the whole field
REGION_BOXES = {"a_block": ((0, 0, 0), (32, 32, 32)),
                "b_unaligned": ((37, 201, 390), (137, 301, 490)),
                "c_slab": ((255, 0, 0), (257, 512, 512)),
                "d_field": ((0, 0, 0), (512, 512, 512))}
REGION_LATENCY = 0.002  # the RangeStore's per-request latency, s
# the container also read whole through a FileStore and an HttpStore (the
# store code is the same for every chunk scheme)
REGION_ALL_STORES = "wavelet"
REGION_PREFETCH = 4     # the depth held against prefetch 0 on boxes c and d


def _reader_sums() -> dict:
    """The sums of the reader's fetch and decode histograms so far."""
    from repro_torch import obs

    out = {}
    for name in ("cz_reader_fetch_seconds", "cz_reader_decode_seconds"):
        m = obs.REGISTRY.get(name)
        out[name] = m.snapshot()["sum"] if m is not None else 0.0
    return out


def phase_region(files: dict, sides: list[dict]) -> tuple[dict, dict]:
    """Random access to the 512^3 p containers on the card.  For each
    container (wavelet, zfpx, lorenzo; auto, whose chunks are szx):
    ``describe(verify=True)`` and ``inspect``; ``read_field(device="cuda")``
    through a MemoryStore (the reference read) and a RangeStore with 2 ms
    per request, and for the wavelet container also through a FileStore and
    an HttpStore on a loopback StaticFileServer, each bit-equal to the
    reference read; then ``FieldReader`` on a fresh RangeStore (2 ms) per
    box, cold then warm, each bit-equal to the same slice of the reference
    read, with ``chunks_decoded`` the box's chunks; boxes c and d again at
    prefetch 4: the same bits, requests and bytes fetched.  Every read runs
    with the launch counts set to 0 just before and read just after: the
    decode kernel of each chunk's scheme launches once per chunk decoded,
    and no kernel on a warm read.  Returns the per-container results and
    the launches summed over every read (per wrapper, and per wrapper and
    block side)."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.core import container
    from repro_torch.launch import compress
    from repro_torch.store import backends as stores

    totals = dict.fromkeys(KERNEL_LABELS, 0)
    by_side: dict = {}

    def counted(expected: dict, what: str, fn):
        _zero_launches(sides)
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        launches = _cuda_launches()
        want = {k: expected.get(k, 0) for k in KERNEL_LABELS}
        check(launches == want, f"region_path {what}: launches {launches}, expected {want}")
        for k, v in launches.items():
            totals[k] += v
        for c in sides:
            for (k, n), v in c.items():
                by_side[f"{k} n={n}"] = by_side.get(f"{k} n={n}", 0) + v
        return out, dt, sum(launches.values())

    results = {}
    for name in REGION_CONTAINERS:
        path = files[name]
        d = container.describe(path, verify=True)
        check(d["crc_ok"] is True, f"region_path {name}: describe reports a CRC mismatch")
        schemes = [row.get("scheme", d["scheme"]) for row in d["chunks"]]
        nchunks = len(schemes)

        def expect(cis):
            e = {}
            for ci in cis:
                k = DECODE_KERNEL.get(schemes[ci])
                if k:
                    e[k] = e.get(k, 0) + 1
            return e

        shown, code = io.StringIO(), None
        with contextlib.redirect_stdout(shown):
            try:
                compress.main(["inspect", path])
            except SystemExit as e:
                code = e.code
        check(code == 0, f"region_path {name}: inspect exited {code}")
        with open(path, "rb") as fh:
            blob = fh.read()
        root, key = os.path.split(path)
        mem, rng = stores.MemoryStore(), stores.RangeStore(latency=REGION_LATENCY)
        mem.put(key, blob)
        rng.put(key, blob)
        read_s = {}
        ref, read_s["mem"], _ = counted(
            expect(range(nchunks)), f"{name} read_field over mem",
            lambda: container.read_field(key, device="cuda", store=mem))
        check(ref.dtype == np.float32 and ref.shape == (N_MAIN,) * 3,
              f"region_path {name}: read_field gave {ref.dtype} {ref.shape}")
        bits = ref.view(np.int32)
        with contextlib.ExitStack() as stack:
            others = [("range_2ms", rng)]
            if name == REGION_ALL_STORES:
                srv = stack.enter_context(stores.StaticFileServer(root))
                others += [("file", stores.FileStore(root)),
                           ("http", stack.enter_context(stores.HttpStore(srv.url)))]
            for kind, st in others:
                got, read_s[kind], _ = counted(
                    expect(range(nchunks)), f"{name} read_field over {kind}",
                    lambda st=st: container.read_field(key, device="cuda", store=st))
                check(got.dtype == ref.dtype and np.array_equal(got.view(np.int32), bits),
                      f"region_path {name}: read_field over {kind} differs from the "
                      f"MemoryStore read")
                del got
        boxes = {}
        for bname, (lo, hi) in REGION_BOXES.items():
            want = bits[tuple(slice(a, b) for a, b in zip(lo, hi))]
            runs = {}
            for pf in (0, REGION_PREFETCH) if bname in ("c_slab", "d_field") else (0,):
                st = stores.RangeStore(latency=REGION_LATENCY)
                st.put(key, blob)
                tag = f"{name} box {bname} prefetch {pf}"
                with container.FieldReader(key, cache_chunks=nchunks, device="cuda", store=st,
                                           prefetch=pf) as r:
                    cis = r.box_chunks(lo, hi)
                    sums0, st0 = _reader_sums(), st.stats()
                    box, cold_s, cold_n = counted(expect(cis), f"{tag} cold",
                                                  lambda: r.read_box(lo, hi))
                    sums1, st1 = _reader_sums(), st.stats()
                    check(np.array_equal(box.view(np.int32), want),
                          f"region_path {tag}: read_box differs from the MemoryStore read")
                    check(r.chunks_decoded == len(cis),
                          f"region_path {tag}: {r.chunks_decoded} chunks decoded, box has {len(cis)}")
                    hits0 = r.cache_hits
                    box, warm_s, warm_n = counted({}, f"{tag} warm",
                                                  lambda: r.read_box(lo, hi))
                    check(np.array_equal(box.view(np.int32), want),
                          f"region_path {tag}: the warm read_box differs")
                    check(r.chunks_decoded == len(cis)
                          and r.cache_hits - hits0 == len(r.box_blocks(lo, hi)),
                          f"region_path {tag}: the warm read was not all cache hits")
                    del box
                runs[pf] = {
                    "cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3,
                    "chunks_decoded": r.chunks_decoded,
                    "launches": cold_n, "warm_launches": warm_n,
                    **{f"{k}_sum": sums1[k] - sums0[k] for k in sums0},
                    "get_requests": st1["get_requests"] - st0["get_requests"],
                    "bytes_fetched": st1["bytes_fetched"] - st0["bytes_fetched"]}
            if REGION_PREFETCH in runs:
                a, b = runs[0], runs[REGION_PREFETCH]
                check((a["get_requests"], a["bytes_fetched"]) == (b["get_requests"],
                                                                  b["bytes_fetched"]),
                      f"region_path {name} box {bname}: prefetch changed requests or bytes "
                      f"{a} {b}")
            boxes[bname] = {"lo": lo, "hi": hi, "chunks": len(cis), **runs.pop(0)}
            if runs:
                boxes[bname][f"prefetch{REGION_PREFETCH}"] = runs[REGION_PREFETCH]
        results[name] = {"bytes": len(blob), "chunks": nchunks,
                         "chunk_schemes": {s_: schemes.count(s_) for s_ in sorted(set(schemes))},
                         "crc_ok": True, "inspect_exit": code,
                         "read_field_s": read_s, "boxes": boxes}
        del ref, bits
    return results, {"launches": totals, "launches_by_side": by_side}


def _max_abs_diff(got, want) -> float:
    if isinstance(got, tuple):
        return max(_max_abs_diff(a, b) for a, b in zip(got, want))
    return (got.double() - want.double()).abs().max().item()


def _bit_equal(torch, got, want) -> bool:
    """Equal bits; float32 tensors are compared as int32 (signed zeros too)."""
    if isinstance(got, tuple):
        return all(_bit_equal(torch, a, b) for a, b in zip(got, want))
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got, want)


def kernel_rows(torch, wv, zf, sz, ops, lkern, launches: dict,
                auto_launches: dict, region_launches: dict) -> list[dict]:
    """One row per ported kernel at its path's shapes: the wavelet forward,
    zfpx and lorenzo encode over a QoI's 4096 blocks, the inverse, zfpx and
    lorenzo decode over one read-path chunk of 32 blocks; the wavelet
    kernels at n = 64 (block64_path): the forward over a QoI's 512 blocks,
    the inverse over one 4-block chunk; and the lorenzo decode at n = 64
    over a 4-block chunk and the wavelet staged kernel at n = 128 (B = 1,
    5 levels), sides that no path runs yet.  The lorenzo decode's rows also
    carry the design its library launches at their side."""
    g = torch.Generator(device="cuda")
    g.manual_seed(34)
    kind, n, lv = "w3ai", 32, 3   # the main path's spec
    nblocks = (N_MAIN // n) ** 3
    x = torch.rand((nblocks, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
    chunk = ops.wavelet_forward(x, kind, lv)[:32].contiguous()
    x64 = x.view(-1, 64, 64, 64)  # 512 blocks of 64^3 (4 levels), as random
    chunk64 = ops.wavelet_forward(x64, kind, 4)[:4].contiguous()
    x128 = x.view(-1, 128, 128, 128)[:1].contiguous()
    chunk128 = ops.wavelet_forward(x128, kind, 5)
    emax, q = ops.zfpx_encode(x, EPS)
    emax, q = emax[:32].contiguous(), q[:32].contiguous()
    res = ops.lorenzo_encode(x, EPS)[:32].contiguous()
    res64 = ops.lorenzo_encode(x64[:4].contiguous(), EPS)
    wsrc, zsrc, lsrc = ("src/repro_torch/kernels/csrc/wavelet3d.cu",
                        "src/repro_torch/kernels/csrc/zfp_transform.cu",
                        "src/repro_torch/kernels/csrc/lorenzo.cu")

    table = [
        ("wavelet3d_forward", wsrc, "src/repro/kernels/wavelet3d.py:139",
         "wavelet3d_cluster_kernel",
         lambda: ops.wavelet_forward(x, kind, lv), lambda: wv.forward3d(x, kind, lv),
         20, nblocks, wavelet_bound_ms(kind, n, lv, nblocks)),
        ("wavelet3d_inverse", wsrc, "src/repro/kernels/wavelet3d.py:145",
         "wavelet3d_cluster_kernel",
         lambda: ops.wavelet_inverse(chunk, kind, lv), lambda: wv.inverse3d(chunk, kind, lv),
         50, 32, wavelet_bound_ms(kind, n, lv, 32)),
        ("wavelet3d_forward_n64", wsrc, "src/repro/kernels/wavelet3d.py:139",
         "wavelet3d_cluster_kernel",
         lambda: ops.wavelet_forward(x64, kind, 4), lambda: wv.forward3d(x64, kind, 4),
         20, 512, wavelet_bound_ms(kind, 64, 4, 512)),
        ("wavelet3d_inverse_n64", wsrc, "src/repro/kernels/wavelet3d.py:145",
         "wavelet3d_cluster_kernel",
         lambda: ops.wavelet_inverse(chunk64, kind, 4), lambda: wv.inverse3d(chunk64, kind, 4),
         50, 4, wavelet_bound_ms(kind, 64, 4, 4)),
        ("zfpx_encode", zsrc, "src/repro/kernels/zfp_transform.py:56", "zfpx_encode_kernel",
         lambda: ops.zfpx_encode(x, EPS), lambda: zf.encode(x, EPS),
         20, nblocks, zfpx_bound_ms(n, nblocks, decode=False)),
        ("zfpx_decode", zsrc, "src/repro/kernels/zfp_transform.py:82", "zfpx_decode_kernel",
         lambda: ops.zfpx_decode(emax, q, EPS, n), lambda: zf.decode(emax, q, EPS, n),
         50, 32, zfpx_bound_ms(n, 32, decode=True)),
        ("lorenzo_encode", lsrc, "src/repro/kernels/lorenzo.py:57", "lorenzo_encode_kernel",
         lambda: ops.lorenzo_encode(x, EPS), lambda: sz.encode(x, EPS),
         20, nblocks, lorenzo_bound_ms(n, nblocks, decode=False)),
        ("lorenzo_decode", lsrc, "src/repro/kernels/lorenzo.py:63", "lorenzo_decode_cluster",
         lambda: ops.lorenzo_decode(res, EPS), lambda: sz.decode(res, EPS),
         50, 32, lorenzo_bound_ms(n, 32, decode=True)),
        ("lorenzo_decode_n64", lsrc, "src/repro/kernels/lorenzo.py:63", "lorenzo_decode_cluster",
         lambda: ops.lorenzo_decode(res64, EPS), lambda: sz.decode(res64, EPS),
         50, 4, lorenzo_bound_ms(64, 4, decode=True)),
        ("wavelet3d_forward_n128", wsrc, "src/repro/kernels/wavelet3d.py:139",
         "wavelet3d_staged_kernel",
         lambda: ops.wavelet_forward(x128, kind, 5), lambda: wv.forward3d(x128, kind, 5),
         20, 1, wavelet_bound_ms(kind, 128, 5, 1)),
        ("wavelet3d_inverse_n128", wsrc, "src/repro/kernels/wavelet3d.py:145",
         "wavelet3d_staged_kernel",
         lambda: ops.wavelet_inverse(chunk128, kind, 5), lambda: wv.inverse3d(chunk128, kind, 5),
         20, 1, wavelet_bound_ms(kind, 128, 5, 1)),
    ]
    # CUDA kernels per call: the staged wavelet kernel runs once per level and axis
    per_call = {"wavelet3d_forward_n128": 15, "wavelet3d_inverse_n128": 15}
    designs = {"lorenzo_decode": lkern.decode_design(n),
               "lorenzo_decode_n64": lkern.decode_design(64)}
    rows = []
    for name, src, replaces, symbol, call, plain, reps, blocks, (b_ms, b_by) in table:
        got, want = call(), plain()
        err = _max_abs_diff(got, want)
        check(_bit_equal(torch, got, want), f"{name} vs plain at its path's shape: not bit-exact")
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "auto_path_launches": auto_launches[name],
            "region_path_launches": region_launches[name],
            "max_abs_err": err,
            "ms": kernel_ms(call, symbol, reps, per_call.get(name, 1)),
            "call_ms": median_ms(call, reps),
            "plain_ms": median_ms(plain, 5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "blocks": blocks, **designs.get(name, {}),
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
    from repro_torch.core import szx as sz
    from repro_torch.core import wavelets as wv
    from repro_torch.core import zfpx as zf
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import lorenzo as lkern
    from repro_torch.kernels import wavelet3d as wkern

    card = smi()
    emit({"phase": "card", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = [_build.BUILD_DIR / f"lib{name}.so" for name in KERNEL_SOURCES]
    for lib in libs:  # build from the sources, never from an earlier run
        if lib.exists():
            lib.unlink()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.load, KERNEL_SOURCES))  # one nvcc per source, together
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(lib) for lib in libs], "flags": list(_build.NVCC_FLAGS)})

    tmp = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    sides = [wkern.LAUNCHES_BY_SIDE, lkern.LAUNCHES_BY_SIDE]
    try:
        t0 = time.perf_counter()
        parity = phase_parity(torch, wv, ops)
        parity["zfpx"] = phase_zfpx_parity(torch, zf, ops)
        parity["lorenzo"] = phase_lorenzo_parity(torch, sz, ops)
        parity["interop"] = phase_interop(tmp)
        emit({"phase": "parity", "seconds": time.perf_counter() - t0, **parity})
        t0 = time.perf_counter()
        bits = phase_bits(torch, wv, sz, ops)
        emit({"phase": "bits", "seconds": time.perf_counter() - t0, **bits})
        region = {k: os.path.join(tmp, "region", f"{k}.cz") for k in REGION_CONTAINERS}
        main_path = run_cli_path(tmp, "main_path", [], "CompressionSpec() defaults",
                                 lambda _m: 100 * EPS,
                                 ("wavelet3d_forward", "wavelet3d_inverse"), sides,
                                 keep=region["wavelet"])
        emit({"phase": "main_path", **main_path})
        block64_path = run_cli_path(tmp, "block64_path", ["--block-size", "64"],
                                    "CompressionSpec(block_size=64): w3ai, eps 1e-3, 4 "
                                    "levels, byte shuffle, zlib", lambda _m: 100 * EPS,
                                    ("wavelet3d_forward", "wavelet3d_inverse"), sides,
                                    ("p",))
        emit({"phase": "block64_path", **block64_path})
        zfpx_path = run_cli_path(tmp, "zfpx_path", ["--scheme", "zfpx"],
                                 "CompressionSpec(scheme='zfpx'): eps 1e-3, 32^3 blocks, "
                                 "byte shuffle, zlib", lambda _m: ZFPX_BOUND,
                                 ("zfpx_encode", "zfpx_decode"), sides,
                                 ZFPX_PATH_QOIS, keep=region["zfpx"])
        emit({"phase": "zfpx_path", **zfpx_path})
        lorenzo_path = run_cli_path(tmp, "lorenzo_path", ["--scheme", "lorenzo"],
                                    "CompressionSpec(scheme='lorenzo'): eps 1e-3, 32^3 "
                                    "blocks, byte shuffle, zlib", lorenzo_bound,
                                    ("lorenzo_encode", "lorenzo_decode"), sides,
                                    LORENZO_PATH_QOIS, keep=region["lorenzo"])
        emit({"phase": "lorenzo_path", **lorenzo_path})
        t0 = time.perf_counter()
        fpzipx = phase_fpzipx(tmp)
        emit({"phase": "fpzipx", "seconds": time.perf_counter() - t0, **fpzipx})
        t0 = time.perf_counter()
        from repro_torch.fields import CloudConfig, cavitation_fields

        p512 = cavitation_fields(CloudConfig(n=N_MAIN), T_MAIN, device="cuda")["p"]
        auto_interop = phase_auto_interop(tmp, p512)
        emit({"phase": "auto_interop", "seconds": time.perf_counter() - t0, **auto_interop})
        t0 = time.perf_counter()
        auto_trials = phase_auto_trials(torch, wv, zf, sz, ops, p512)
        del p512
        emit({"phase": "auto_trials", "seconds": time.perf_counter() - t0, **auto_trials})
        auto_path = run_cli_path(tmp, "auto_path", ["--scheme", "auto", "--target", "abs=1e-3"],
                                 "CompressionSpec(scheme='auto', extra={'target': "
                                 "'abs=1e-3'}): 32^3 blocks, 4 MiB chunks, byte shuffle, "
                                 "zlib", auto_bound, tuple(KERNEL_LABELS), sides,
                                 ("p",), recorded="host", keep=region["auto"])
        emit({"phase": "auto_path", **auto_path})
        t0 = time.perf_counter()
        region_results, region_path = phase_region(region, sides)
        for name, res in region_results.items():
            emit({"phase": "region_path", "container": name, **res})
        emit({"phase": "region_path", "seconds": time.perf_counter() - t0, **region_path})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # each kernel's launches on its own path
    wavelet = ("wavelet3d_forward", "wavelet3d_inverse")
    launches = {k: main_path["launches"][k] for k in wavelet}
    launches.update({f"{k}_n64": block64_path["launches"][k] for k in wavelet})
    launches.update({k: zfpx_path["launches"][k] for k in ("zfpx_encode", "zfpx_decode")})
    launches.update({k: lorenzo_path["launches"][k]
                     for k in ("lorenzo_encode", "lorenzo_decode")})
    # the rows at sides of their own: launches at that side, summed over
    # every path's run (each counted from 0)
    runs = (main_path, block64_path, zfpx_path, lorenzo_path, auto_path)
    for row, key in (("lorenzo_decode_n64", "lorenzo_decode n=64"),
                     ("wavelet3d_forward_n128", "wavelet3d_forward n=128"),
                     ("wavelet3d_inverse_n128", "wavelet3d_inverse n=128")):
        launches[row] = sum(run["launches_by_side"].get(key, 0) for run in runs)
    t0 = time.perf_counter()
    rows = kernel_rows(torch, wv, zf, sz, ops, lkern, launches, _path_rows(auto_path),
                       _path_rows(region_path))
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
