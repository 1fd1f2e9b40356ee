"""shared_write_ms (ms): the median over the snapshots' members of the
slowest rank's ``cluster.write_at`` span (a rank's pwrite of its chunks at
its Exscan offset in the shared file).  The spans carry no member key, so
each rank's write-ats are matched in the order they were recorded."""


def read(record: dict):
    from statistics import median

    by_rank: dict = {}
    for s in sorted(record.get("spans", []), key=lambda s: s["ts"]):
        rank = s.get("args", {}).get("rank")
        if s["name"] == "cluster.write_at" and rank is not None:
            by_rank.setdefault(rank, []).append(s["dur"] / 1e3)
    if not by_rank:
        return None
    slowest = [max(ms) for ms in zip(*by_rank.values())]
    return median(slowest) if slowest else None
