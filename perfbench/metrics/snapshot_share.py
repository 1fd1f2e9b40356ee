"""snapshot_share (%): the host clock's seconds inside the program's
``FieldSnapshotter.maybe_snapshot`` calls of the window, over the window
(the device synchronised before each call, so the solver's queued steps
are not in it)."""


def read(record: dict):
    spans = [s for s in record.get("harness_spans", []) if s["name"] == "snapshot"]
    if not spans or not record.get("window_s"):
        return None
    return 100.0 * sum(s["t1_ns"] - s["t0_ns"] for s in spans) / 1e9 / record["window_s"]
