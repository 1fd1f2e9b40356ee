"""snapshot_ms (ms): the mean of the program's ``snapshot`` spans, one per
``FieldSnapshotter.maybe_snapshot`` call that took a snapshot: the host
copies, the append of every QoI and the commit, on the host's clock."""


def read(record: dict):
    durs = [s["dur"] for s in record.get("spans", []) if s["name"] == "snapshot"]
    return sum(durs) / len(durs) / 1e3 if durs else None
