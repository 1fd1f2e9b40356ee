"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error are the same checks.  Exits non-zero,
printing no result, without CUDA or with fewer cards than the cell asks
for, when the program is missing, or when JAX or the package the port was
made from was loaded.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
_CACHE = ROOT / "build" / "perfbench"
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.harness import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = bench.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = bench.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in out["_lines"]:
        print(line, file=sys.stderr)
    path = bench.save_record(out, args.workload, args.seed, bool(args.trace))
    print(f"record {path.relative_to(ROOT)}", file=sys.stderr)
    for line in bench.check_lines(out):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(bench.result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
