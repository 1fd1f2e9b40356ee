"""stage2_wall_ms (ms): the mean of the program's ``stage2`` spans, one per
QoI compressed: from stage 1's end to the last chunk written, on the
calling thread's clock (the wall time the card waits on, where
``encode_ms`` sums the pool's threads)."""


def read(record: dict):
    durs = [s["dur"] for s in record.get("spans", []) if s["name"] == "stage2"]
    return sum(durs) / len(durs) / 1e3 if durs else None
