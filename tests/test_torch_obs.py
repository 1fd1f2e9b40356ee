"""The port's observability (``repro_torch.obs``) against the JAX package's
(``repro.obs``): after the same sequence of operations, the metrics render
and snapshot to the same text and JSON, traces have the same Chrome
trace-event layout, and events the same records.  Then the series the
port's pipeline, tuner and kernel wrappers record carry the reference's
names, kinds and labels."""
import io
import json
import re

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import CompressionSpec as RSpec
from repro.core import Pipeline as RPipeline
from repro.obs import context as rcontext
from repro.obs import events as revents
from repro.obs import sampling as rsampling
from repro.obs import trace as rtrace

from repro_torch import obs as tobs
from repro_torch.core.pipeline import CompressionSpec, Pipeline
from repro_torch.kernels import ops
from repro_torch.obs import context as tcontext
from repro_torch.obs import events as tevents
from repro_torch.obs import sampling as tsampling
from repro_torch.obs import trace as ttrace

torch.set_num_threads(1)


def _exercise(obs_mod) -> "object":
    """One sequence of registry operations, run against either package."""
    reg = obs_mod.Registry()
    c = reg.counter("cz_test_total", "A counter.", labelnames=("scheme",))
    g = reg.gauge("cz_test_ratio", "A gauge.", labelnames=("scheme",))
    h = reg.histogram("cz_test_seconds", "A histogram.", buckets=obs_mod.FAST_BUCKETS,
                      labelnames=("scheme", "phase"))
    plain = reg.counter("cz_test_plain_total", "No labels.")
    for i, scheme in enumerate(["wavelet", "zfpx", "wavelet", 'a"b\\c']):
        c.inc(i + 1, scheme=scheme)
        g.set(1.5 * i, scheme=scheme)
        h.observe(10.0 ** -(i + 1), scheme=scheme, phase="execute")
        h.observe(3.0 * i, scheme=scheme, phase="compile")
    g.dec(0.25, scheme="zfpx")
    plain.inc()
    h.exemplar(0.002, "trace-1", scheme="zfpx", phase="execute")
    return reg


def test_registry_render_and_snapshot_equal_reference():
    rreg, treg = _exercise(robs), _exercise(tobs)
    assert treg.render() == rreg.render()
    # an exemplar ends with its wall-clock timestamp
    stamp = re.compile(r"(# \{[^}]*\} \S+) \S+$", re.M)
    assert stamp.sub(r"\1", treg.render(openmetrics=True)) == \
        stamp.sub(r"\1", rreg.render(openmetrics=True))
    assert treg.snapshot() == rreg.snapshot()
    assert tobs.parse_prometheus(treg.render()) == robs.parse_prometheus(rreg.render())


@pytest.mark.parametrize("bad", [
    lambda o: o.Registry().counter("bad name", "x"),
    lambda o: o.Registry().counter("cz_x_total", "x", labelnames=("a",)).inc(b=1),
    lambda o: o.Registry().counter("cz_x_total", "x").inc(-1),
])
def test_registry_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as rexc:
        bad(robs)
    with pytest.raises(ValueError) as texc:
        bad(tobs)
    assert str(texc.value) == str(rexc.value)


def _trace_doc(tracer_cls):
    tr = tracer_cls(process_name="rank 0")
    tr.enable()
    o = tr._origin_ns
    tr.record("stage1", o + 1000, o + 5000, scheme="wavelet", nblocks=8)
    tr.record("encode", o + 6000, o + 9000, chunk=0, ratio=3.5)
    tr.record("decode", o + 2000, o + 3000)
    doc = tr.chrome()
    doc["metadata"]["epoch_us"] = 0
    for ev in doc["traceEvents"]:
        ev["pid"] = 0
    return doc


def test_chrome_trace_layout_equals_reference():
    rdoc = _trace_doc(rtrace.Tracer)
    tdoc = _trace_doc(ttrace.Tracer)
    assert tdoc == rdoc
    assert [e["name"] for e in tdoc["traceEvents"]] == [
        "process_name", "thread_name", "stage1", "decode", "encode"]
    assert {e["ph"] for e in tdoc["traceEvents"]} == {"M", "X"}


def test_merged_traces_equal_reference():
    a = {"traceEvents": [{"name": "x", "ph": "X", "ts": 5.0, "dur": 1.0, "pid": 1, "tid": 0}],
         "metadata": {"epoch_us": 100}}
    b = {"traceEvents": [{"name": "process_name", "ph": "M", "pid": 2, "tid": 0,
                          "args": {"name": "r"}},
                         {"name": "y", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 2, "tid": 0}],
         "metadata": {"epoch_us": 90}}
    assert ttrace.merge_traces([a, b], pids=[0, 1]) == rtrace.merge_traces([a, b], pids=[0, 1])


def _events(events_mod, context_mod):
    log = events_mod.EventLog(ring=3, level="info")
    sink = io.StringIO()
    log.configure(stream=sink)
    log.event("tune.decision", scheme="szx", eps=1e-3, target="abs=0.001")
    log.event("dropped", level="debug", x=1)
    with context_mod.request("req-7"):
        log.event("http.request", level="warn", code=200)
    for i in range(3):
        log.event("n", i=i)
    recs = [{k: v for k, v in r.items() if k != "ts"} for r in log.tail(10)]
    lines = [{k: v for k, v in json.loads(s).items() if k != "ts"}
             for s in sink.getvalue().splitlines()]
    return recs, lines, log.emitted, log.suppressed


def test_event_records_equal_reference():
    assert _events(tevents, tcontext) == _events(revents, rcontext)


def test_request_context_and_tail_sampler_equal_reference():
    def run(obs_mod, ctx_mod, samp_mod):
        lat = obs_mod.Registry().histogram("cz_lat_seconds", "lat")
        s = samp_mod.TailSampler(lat, slow_s=0.1)
        kept = []
        for i, (dur, err) in enumerate([(0.05, None), (0.2, None), (0.01, "boom")]):
            with ctx_mod.request(f"r{i}", collect=True) as ctx:
                ctx.record("encode", ctx.started_ns, ctx.started_ns + 1000, {"chunk": i})
            kept.append(s.finish(ctx, dur, error=err))
        stats = {k: v for k, v in s.stats().items() if k != "bytes"}  # wall-clock digits
        kept_traces = [(t["request_id"], t["reason"], t["error"], t["duration_ms"])
                       for t in s.traces()]
        return kept, stats, kept_traces

    assert run(tobs, tcontext, tsampling) == run(robs, rcontext, rsampling)


def _series(registry, prefix: str) -> dict:
    return {m.name: (m.kind, tuple(m.labelnames)) for m in registry
            if m.name.startswith(prefix)}


def test_pipeline_series_have_the_reference_names_kinds_and_labels():
    x = np.random.default_rng(3).uniform(-1, 1, (16, 16, 16)).astype(np.float32)
    spec = dict(block_size=8, buffer_bytes=1 << 12)
    enc = tobs.REGISTRY.get("cz_pipeline_chunks_encoded_total")
    before = enc.value(scheme="wavelet")
    tp = Pipeline(CompressionSpec(**spec), device="cpu")
    tp.decompress(tp.compress(x))
    RPipeline(RSpec(**spec)).compress(x)
    assert _series(tobs.REGISTRY, "cz_pipeline_") == _series(robs.REGISTRY, "cz_pipeline_")
    assert enc.value(scheme="wavelet") - before == 4  # 8 blocks, 2 per chunk


def test_tune_and_kernel_series_have_the_reference_names_kinds_and_labels():
    import repro.kernels.ops  # noqa: F401  (registers the reference's kernel series)
    import repro.tune  # noqa: F401
    import repro_torch.tune  # noqa: F401

    assert _series(tobs.REGISTRY, "cz_tune_") == _series(robs.REGISTRY, "cz_tune_")
    want = {k: v for k, v in _series(robs.REGISTRY, "cz_kernel_").items()
            if k in ("cz_kernel_calls_total", "cz_kernel_seconds")}
    assert _series(tobs.REGISTRY, "cz_kernel_") == want


def test_kernel_wrappers_count_calls_on_the_cpu():
    calls = tobs.REGISTRY.get("cz_kernel_calls_total")
    before = calls.value(kernel="wavelet_forward", device="cpu")
    x = torch.zeros((1, 8, 8, 8))
    ops.wavelet_forward(x)
    ops.wavelet_forward(x)
    assert calls.value(kernel="wavelet_forward", device="cpu") - before == 2
    secs = tobs.REGISTRY.get("cz_kernel_seconds")
    assert secs.snapshot(kernel="wavelet_forward", device="cpu", phase="execute")["count"] >= 1


def test_cli_trace_writes_the_pipeline_spans(tmp_path):
    from repro_torch.launch import compress

    out = tmp_path / "t.json"
    compress.main(["--device", "cpu", "--n", "32", "--qoi", "p", "--block-size", "16",
                   "--out", str(tmp_path / "f"), "--trace", str(out)])
    doc = json.loads(out.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"stage1", "encode", "decode"} <= names
    assert names & {"kernel.compile", "kernel.execute"}
    assert all(e["cat"] == "repro" for e in doc["traceEvents"] if e["ph"] == "X")


def test_kernel_call_counts_are_exact_under_threads():
    """Many threads calling one wrapper at once: no call is lost from
    ``cz_kernel_calls_total`` (the tuner's trials call wrappers from a
    pool)."""
    import sys
    import threading

    calls = tobs.REGISTRY.get("cz_kernel_calls_total")
    before = calls.value(kernel="lorenzo_decode", device="cpu")
    r = torch.zeros((1, 2, 2, 2), dtype=torch.int32)
    nthreads, per_thread = 16, 200

    def work():
        for _ in range(per_thread):
            ops.lorenzo_decode(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert calls.value(kernel="lorenzo_decode", device="cpu") - before == nthreads * per_thread


@pytest.mark.parametrize("name", ["wavelet_forward", "zfpx_encode", "lorenzo_encode"])
def test_a_refused_launch_counts_nothing(name):
    """A wrapper counts a call off the CPU only where its kernel launched: a
    call that the wrapper refuses before any launch adds to no series."""
    calls = tobs.REGISTRY.get("cz_kernel_calls_total")

    def series():
        return {tuple(sorted(labels.items())): v for labels, v in calls.samples()}

    before = series()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, name)(torch.empty((1, 8, 8, 8), device="meta"))
    assert series() == before
