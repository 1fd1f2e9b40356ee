"""wavelet_fwd_roofline (%): the least time of the program's forward
wavelet launches (each block read once and written once through HBM at
the data sheet's 3.35 TB/s, or its float32 operations at 67 TFLOP/s,
whichever is longer) over the device time the profiler gave the forward
kernel.  Every forward launch of these cells transforms one whole field."""
import re

from perfbench.harness import arith

_FORWARD = re.compile(r"wavelet3d_cluster_kernel<\s*(\d+)\s*,\s*\d+\s*,\s*false\s*>")


def read(record: dict):
    kernels = record.get("device_trace", {}).get("kernels", {})
    n, bs = record.get("n"), record.get("block_size")
    if not n or not bs:
        return None
    us = launches = 0
    for name, k in kernels.items():
        m = _FORWARD.search(name)
        if m and int(m.group(1)) == bs:
            us += k["device_us"]
            launches += k["count"]
    bound_ms, _by = arith.wavelet_bound_ms((n // bs) ** 3, bs)
    return arith.roofline_pct(bound_ms, launches, us / 1e3)
