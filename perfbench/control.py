"""The correctness check's control: the plain reference put in the
program's place and computed in bfloat16, the precision below the float32
the configuration states, on a cell's own data and schedule.  Its numbers
have to fail the cell's limits (``configs/<config>.json`` ``check``).

    python3 perfbench/control.py --workload NAME --seeds 11,12,13

On the card.  In situ it takes the producer's fields at the cell's first
``SNAPSHOTS`` snapshot steps and judges, in place of each file's
coefficients, the reference's own transform of the field computed in
bfloat16 and thresholded at eps.  Ex situ it does the same for each QoI's
field, and in place of ``read_field``'s output it judges the bfloat16
inverse of those coefficients.  One JSON line per seed.  The benchmark's
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402

from perfbench.harness import bench  # noqa: E402
from perfbench.producers import cavitation, euler3d  # noqa: E402
from perfbench.reference import cz_w3ai as ref  # noqa: E402

LOW = torch.bfloat16
SNAPSHOTS = 3


def control_insitu(cell: bench.Cell, seed: int, device: str) -> dict:
    cfg, every = cell.config, int(cell.traffic["every"])
    eps, factor = float(cfg["spec"]["eps"]), float(cfg["guarantee"]["bound_factor"])
    bs = int(cfg["spec"]["block_size"])
    U = euler3d.init_bubble_cloud(int(cfg["n"]), cfg["cloud"], seed, device,
                                  p_ambient=cfg["p_ambient"], p_bubble=cfg["p_bubble"],
                                  rho_liquid=cfg["rho_liquid"], rho_gas=cfg["rho_gas"])
    dt = euler3d.cfl_dt(U, float(cfg["cfl"]))
    U = euler3d.step(U, dt)
    coef_gap = err_bound = 0.0
    for k in range(SNAPSHOTS):
        if k:
            for _ in range(every):
                U = euler3d.step(U, dt)
        for x in euler3d.qoi_fields(U, cell.traffic["qois"]).values():
            low = ref.kept_coeffs(ref.blockify(x, bs), eps, LOW)
            j = ref.judge_field(x, low, eps, factor)
            coef_gap, err_bound = max(coef_gap, j["coef_gap"]), max(err_bound, j["err_bound"])
    return {"coef_gap": coef_gap, "err_bound": err_bound}


def control_exsitu(cell: bench.Cell, seed: int, device: str) -> dict:
    cfg = cell.config
    eps, factor = float(cfg["spec"]["eps"]), float(cfg["guarantee"]["bound_factor"])
    bs = int(cfg["spec"]["block_size"])
    fields = cavitation.cavitation_fields(cfg["cloud"], float(cell.traffic["t_us"]), seed, device)
    coef_gap = err_bound = read_gap = 0.0
    for q in cell.traffic["qois"]:
        x = fields[q]
        low = ref.kept_coeffs(ref.blockify(x, bs), eps, LOW)
        j = ref.judge_field(x, low, eps, factor)
        back = ref.unblockify(ref.inverse3d(low, LOW), x.shape)
        read_gap = max(read_gap, float((back - j["decoded"]).abs().max()) / eps)
        coef_gap, err_bound = max(coef_gap, j["coef_gap"]), max(err_bound, j["err_bound"])
    return {"coef_gap": coef_gap, "err_bound": err_bound, "read_gap": read_gap}


def control(workload: str, seed: int, device: str = "cuda",
            overrides: dict | None = None) -> dict:
    """The control's numbers for one seed, each beside its limit, and
    whether it failed at least one of them (it has to)."""
    cell = bench.load_cell(workload)
    if overrides:
        cell.config = {**cell.config, **overrides}
    fn = {"insitu": control_insitu, "exsitu": control_exsitu}[cell.traffic["driver"]]
    numbers = fn(cell, seed, device)
    limits = cell.config["check"]
    failed = [k for k, v in numbers.items() if v > limits[k]]
    return {"workload": workload, "seed": seed, "numbers": numbers,
            "limits": {k: limits[k] for k in numbers}, "fails": failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
