"""stage2_cr (x): the program's count of the bytes serialize handed to
stage 2 over the chunk bytes that left it, in the window
(``cz_pipeline_payload_bytes_total`` over
``cz_pipeline_encoded_bytes_total``): what the lossless stage saves.
``chunk_cr`` over it is stage 1's own ratio."""


def _total(counters: dict, name: str) -> float:
    return sum(v for k, v in counters.items() if k == name or k.startswith(name + "{"))


def read(record: dict):
    c = record.get("counters", {})
    payload = _total(c, "cz_pipeline_payload_bytes_total")
    enc = _total(c, "cz_pipeline_encoded_bytes_total")
    return payload / enc if payload and enc else None
