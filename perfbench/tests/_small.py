"""Small sizes of the cells for the CPU tests: every cell's loop, program
and reference as the card runs them, at a 64^3 grid (two 32^3 blocks a
side), on the CPU."""
from perfbench.harness import bench

CELLS = ("insitu.euler512.w3ai.every10", "exsitu.cav512.w3ai.t9_4",
         "insitu.euler512.w3ai.every40")


def overrides(workload: str) -> dict:
    cfg = bench.load_cell(workload).config
    if "cloud" in cfg and "n" in cfg["cloud"]:
        return {"cloud": {**cfg["cloud"], "n": 64}}
    return {"n": 64}


def run_small(workload: str, seed: int = 2 ** 31 + 17, seconds: float = 0.3,
              trace: bool = False) -> dict:
    return bench.run_cell(workload, seed, seconds, trace, device="cpu",
                          overrides=overrides(workload))
