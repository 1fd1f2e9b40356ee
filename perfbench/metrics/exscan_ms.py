"""exscan_ms (ms): the Exscan's own cost, the median over the snapshots'
members of the fastest rank's ``cluster.exscan`` span (one per rank, per
member: the all-gather that places each rank's bytes; the fastest rank
arrives last and waits for no one)."""


def read(record: dict):
    from statistics import median

    by_member = _per_member(record, "cluster.exscan")
    mins = [min(d.values()) for d in by_member.values() if len(d) > 1]
    return median(mins) if mins else None


def _per_member(record: dict, name: str) -> dict:
    """{member key: {rank: ms}} of the spans called ``name``."""
    out: dict = {}
    for s in record.get("spans", []):
        args = s.get("args", {})
        if s["name"] == name and "key" in args and "rank" in args:
            out.setdefault(args["key"], {})[args["rank"]] = s["dur"] / 1e3
    return out
