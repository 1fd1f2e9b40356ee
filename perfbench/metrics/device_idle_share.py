"""device_idle_share (%): the share of the traced window in which no
operation (kernel, copy or set) ran on the card, from torch.profiler."""


def read(record: dict):
    dt = record.get("device_trace", {})
    if not dt.get("window_s") or not dt.get("busy_s"):
        return None
    return 100.0 * (1.0 - dt["busy_s"] / dt["window_s"])
