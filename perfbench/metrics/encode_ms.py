"""encode_ms (ms): the program's ``encode`` spans (serialize and zlib of
one chunk, on the pool's threads) summed, per QoI compressed: thread
milliseconds, not wall time."""


def read(record: dict):
    spans = record.get("spans", [])
    members = sum(1 for s in spans if s["name"] == "stage1")
    enc = sum(s["dur"] for s in spans if s["name"] == "encode")
    return enc / members / 1e3 if members and enc else None
