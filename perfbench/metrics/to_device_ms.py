"""to_device_ms (ms): the mean of the program's ``pipeline.to_device``
spans, one per QoI compressed: the host field copied back onto the card
and cut into blocks there, on the host's clock."""


def read(record: dict):
    durs = [s["dur"] for s in record.get("spans", []) if s["name"] == "pipeline.to_device"]
    return sum(durs) / len(durs) / 1e3 if durs else None
