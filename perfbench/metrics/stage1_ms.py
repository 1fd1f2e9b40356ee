"""stage1_ms (ms): the mean of the program's ``stage1`` spans, one per QoI
compressed: blocking, the wavelet kernel, the threshold and the copies of
its streams to the host, on the host's clock."""


def read(record: dict):
    durs = [s["dur"] for s in record.get("spans", []) if s["name"] == "stage1"]
    return sum(durs) / len(durs) / 1e3 if durs else None
