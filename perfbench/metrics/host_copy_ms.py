"""host_copy_ms (ms): the mean of the program's ``snapshot.host_copy``
spans, one per QoI snapshotted: the field's copy from the card to the
host before it is compressed."""


def read(record: dict):
    durs = [s["dur"] for s in record.get("spans", []) if s["name"] == "snapshot.host_copy"]
    return sum(durs) / len(durs) / 1e3 if durs else None
