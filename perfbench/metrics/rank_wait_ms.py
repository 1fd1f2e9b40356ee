"""rank_wait_ms (ms): the straggler wait, the median over the snapshots'
members of the slowest rank's ``cluster.exscan`` span less the fastest
rank's (the first rank to reach the Exscan waits for the last)."""


def read(record: dict):
    from statistics import median

    by_member: dict = {}
    for s in record.get("spans", []):
        args = s.get("args", {})
        if s["name"] == "cluster.exscan" and "key" in args and "rank" in args:
            by_member.setdefault(args["key"], {})[args["rank"]] = s["dur"] / 1e3
    waits = [max(d.values()) - min(d.values()) for d in by_member.values() if len(d) > 1]
    return median(waits) if waits else None
