"""commit_ms (ms): the median of rank 0's ``cluster.commit`` spans, one per
collective snapshot: the gather of every rank's chunk tables, each
member's footer and fsync, and the manifest's commit."""


def read(record: dict):
    from statistics import median

    durs = [s["dur"] / 1e3 for s in record.get("spans", [])
            if s["name"] == "cluster.commit" and s.get("args", {}).get("rank", 0) == 0]
    return median(durs) if durs else None
