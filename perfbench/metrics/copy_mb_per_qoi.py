"""copy_mb_per_qoi (MB): the program's count of bytes copied between host
and card in the window (``cz_copy_bytes_total``, every direction and
site), over the QoIs snapshotted in it, in 10^6 bytes."""


def read(record: dict):
    c = record.get("counters", {})
    keys = [k for k in c if k == "cz_copy_bytes_total" or k.startswith("cz_copy_bytes_total{")]
    qois = record.get("snapshots", 0) * len(record.get("qois", ()))
    if not keys or not qois:
        return None
    return sum(c[k] for k in keys) / qois / 1e6
