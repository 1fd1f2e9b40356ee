"""Time the lorenzo decode kernel's design choices on the card.

``kernels/csrc/lorenzo.cu`` fixes the decode's design by the block side n
alone.  This script builds variants of that source, each with one choice
changed, and times every variant on the same residuals, each result held
bit for bit against the plain version (:func:`repro_torch.core.szx.decode`):

* ``kept``: the source as it is;
* ``staged``: the three passes through device memory at every side (the
  decode's design before the cluster kernel);
* ``slabs_n32_2``, ``_8``, ``_16``, ``_32``: 2, 8, 16 or 32 planes per CTA
  at n = 32 (clusters of 16, 4, 2 and 1 CTAs; the source takes 4, K = 8);
  ``slabs_n64_8``: 8 planes per CTA at n = 64 (K = 8; the source takes 4,
  K = 16); ``slabs_32kib``: about 32 KiB of planes per CTA at every side
  above 16, min(8192 / n^2, n) planes and at least ceil(n / 16), so whole
  blocks at n = 17 .. 20 (the source takes about 16 KiB);
* ``threads_128``, ``threads_512``: the cluster kernel's CTA size (the
  source takes 256 threads);
* ``one_bulk_copy``: a CTA's planes in one bulk copy, rather than up to 8
  whose planes are scanned as each lands;
* ``linear_carry``: each CTA reads the total plane of every rank below it,
  rather than each CTA scanning one slice of the plane across the ranks.

Run it from a checkout on a machine with the card and the CUDA toolkit::

    PYTHONPATH=src python -m repro_torch.launch.lorenzo_decode_designs

It prints the card's name and power limit (``nvidia-smi``), then one JSON
line per side and variant: the kernel's device time per call (``ms``, the
mean over a torch.profiler trace of back-to-back calls, the staged path's
three kernels summed), the median of CUDA events around one call
(``call_ms``), and the design the variant's library reports.  ``kept`` is
timed first and again last at each side: the two readings show the
spread.  ``--rounds`` repeats the whole timing, every other round in
the reverse order of the variants.  A variant that differs from the plain
version fails the run.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core import szx
from repro_torch.kernels import _build

SOURCE = _build.CSRC / "lorenzo.cu"

#: (n, B) of the timed residuals: one read chunk at n = 32 and 64, about
#: 4 MiB at 16 and 8, and an odd side (plain loads, a cluster of 5)
INPUTS = ((32, 32), (64, 4), (16, 256), (8, 2048), (33, 32))

_PLANES_RULE = "__host__ __device__ constexpr int planes_per_cta(int n) {\n"
_LINEAR_CARRY = (
    ("""    cl.sync();
    const int slice = (nn + K - 1) / K;
    const int end = (rank + 1) * slice < nn ? (rank + 1) * slice : nn;
    for (int e = rank * slice + tid; e < end; e += kClusterThreads) {
      uint32_t below = 0;
      for (int r0 = 0; r0 < K; r0 += kBatch) {
        uint32_t t[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          t[u] = r0 + u < K - 1 ? static_cast<uint32_t>(*cl.map_shared_rank(total + e, r0 + u))
                                : 0u;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (r0 + u < K) {
            *cl.map_shared_rank(total + e, r0 + u) = static_cast<int32_t>(below);
            below += t[u];
          }
        }
      }
    }
    cl.sync();  // the last access to another CTA's shared memory
""", """    cl.sync();
"""),
    ("""    if (rank > 0) load_values<E>(total + j * n + k0, k0, n, ok, acc);  // the carry
""", """    for (int r = 0; r < rank; ++r) {
      uint32_t t[E];
      load_values<E>(cl.map_shared_rank(total, r) + j * n + k0, k0, n, ok, t);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += t[e];
    }
"""),
    ("""    }
  }
}

template <int NT, int E>
cudaError_t launch_cluster(""", """    }
  }
  if (K > 1) cl.sync();  // the last access to another CTA's shared memory
}

template <int NT, int E>
cudaError_t launch_cluster("""),
)


def _planes(n: int, planes: int) -> tuple[tuple[str, str], ...]:
    return ((_PLANES_RULE, f"{_PLANES_RULE}  if (n == {n}) return {planes};\n"),)


#: variant -> (old, new) replacements in the source, each old text found once
VARIANTS: dict[str, tuple[tuple[str, str], ...]] = {
    "kept": (),
    "staged": (("constexpr int kMaxClusterSide = 64;", "constexpr int kMaxClusterSide = 0;"),),
    "slabs_n32_2": _planes(32, 2),
    "slabs_n32_8": _planes(32, 8),
    "slabs_n32_16": _planes(32, 16),
    "slabs_n32_32": _planes(32, 32),
    "slabs_n64_8": _planes(64, 8),
    "slabs_32kib": (("const int p = 4096 / (n * n);",
                     "const int p = 8192 / (n * n) < n ? 8192 / (n * n) : n;"),),
    "threads_128": (("constexpr int kClusterThreads = 256;",
                     "constexpr int kClusterThreads = 128;"),),
    "threads_512": (("constexpr int kClusterThreads = 256;",
                     "constexpr int kClusterThreads = 512;"),),
    "one_bulk_copy": (("constexpr int kMaxPieces = 8;", "constexpr int kMaxPieces = 1;"),),
    "linear_carry": _LINEAR_CARRY,
}


def variant_source(name: str) -> str:
    """The decode's source with variant ``name``'s replacements made."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} is not in lorenzo.cu exactly once")
        src = src.replace(old, new)
    return src


def _build_variant(name: str, out_dir: Path) -> Path:
    src, lib = out_dir / f"lorenzo_{name}.cu", out_dir / f"liblorenzo_{name}.so"
    src.write_text(variant_source(name))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building variant {name} failed:\n{proc.stdout}{proc.stderr}")
    return lib


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr = ctypes.c_void_p
    lib.lorenzo_decode_launch.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_float, ptr]
    for fn in (lib.lorenzo_decode_launch, lib.lorenzo_decode_planes_per_cta,
               lib.lorenzo_decode_cluster_ctas):
        fn.restype = ctypes.c_int
    for fn in (lib.lorenzo_decode_planes_per_cta, lib.lorenzo_decode_cluster_ctas):
        fn.argtypes = [ctypes.c_int]
    return lib


def _kernel_ms(fn, per_call: int, reps: int) -> float:
    """Device time per call of the kernels named ``lorenzo_decode*`` in a
    torch.profiler trace of ``reps`` back-to-back calls; the mean is over
    the launches the trace saw (it can miss some at its start).  A trace
    that saw fewer than half the launches is taken again, up to three
    times."""
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
            if "lorenzo_decode" in ev.key:
                us += ev.device_time_total
                count += ev.count
        if reps // 2 <= count / per_call <= reps and us > 0:
            break
    if not (reps // 2 <= count / per_call <= reps and us > 0):
        raise RuntimeError(f"the profiler saw {count} decode kernels of {reps} x {per_call}")
    return us / 1e3 / (count / per_call)


def _call_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=100, help="calls per timing")
    ap.add_argument("--rounds", type=int, default=1, help="timings of every variant")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    out_dir = _build.BUILD_DIR.parent / "lorenzo_decode_designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = list(VARIANTS)
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        libs = dict(zip(names, map(_bind, pool.map(lambda v: _build_variant(v, out_dir),
                                                    names))))
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    two = szx.grid(1e-3)[1]
    ok = True
    batches = []
    for n, nb in INPUTS:
        r = torch.randint(-2 ** 31, 2 ** 31, (nb, n, n, n), generator=g, device="cuda",
                          dtype=torch.int64).to(torch.int32)
        batches.append((r, szx.decode(r, 1e-3).view(torch.int32)))
    for rnd, (r, want) in ((rnd, b) for rnd in range(args.rounds) for b in batches):
        n, nb = r.shape[-1], r.shape[0]
        order = names[1:] if rnd % 2 == 0 else names[:0:-1]
        for name in ["kept", *order, "kept"]:
            lib = libs[name]
            out = torch.empty(r.shape, dtype=torch.float32, device="cuda")

            def call(lib=lib, out=out, r=r, n=n, nb=nb, name=name):
                rc = lib.lorenzo_decode_launch(r.data_ptr(), out.data_ptr(), nb, n, two,
                                               torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name} n={n}: cudaError {rc}")
                return out

            equal = torch.equal(call().view(torch.int32), want)
            ok &= equal
            planes = lib.lorenzo_decode_planes_per_cta(n)
            print(json.dumps({
                "round": rnd, "variant": name, "n": n, "blocks": nb,
                "design": "cluster" if planes else "staged", "planes_per_cta": planes,
                "cluster_ctas": lib.lorenzo_decode_cluster_ctas(n), "bit_equal": equal,
                "ms": _kernel_ms(call, 1 if planes else 3, args.reps),
                "call_ms": _call_ms(call, args.reps)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
