"""chunk_cr (x): the program's own count of the block bytes that entered
chunk encoding over the chunk bytes that left it, in the window
(``cz_pipeline_raw_bytes_total`` over ``cz_pipeline_encoded_bytes_total``):
the codec's ratio, before container headers and footers."""


def _total(counters: dict, name: str) -> float:
    return sum(v for k, v in counters.items() if k == name or k.startswith(name + "{"))


def read(record: dict):
    c = record.get("counters", {})
    raw = _total(c, "cz_pipeline_raw_bytes_total")
    enc = _total(c, "cz_pipeline_encoded_bytes_total")
    return raw / enc if raw and enc else None
