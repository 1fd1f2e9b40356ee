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
    port = _series(tobs.REGISTRY, "cz_pipeline_")
    # the port's one series more: the bytes serialize hands to stage 2
    assert port.pop("cz_pipeline_payload_bytes_total") == ("counter", ("scheme",))
    assert port == _series(robs.REGISTRY, "cz_pipeline_")
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


# -- span ids and parents, device time, copies (the port's own tracing) -------

@pytest.fixture
def traced():
    ttrace.reset()
    ttrace.enable()
    try:
        yield ttrace.TRACER
    finally:
        ttrace.disable()
        ttrace.reset()


def _by_name(events) -> dict:
    return {e["name"]: e["args"] for e in events if e["ph"] == "X"}


def test_spans_name_their_parent_on_their_thread(traced):
    import threading

    with ttrace.span("outer", k=1):
        with ttrace.span("inner"):
            o = ttrace.current_id()
            ttrace.record("stamped", o, o)
        later = ttrace.next_id()
        seen = {}

        def other():  # another thread's stack is empty: the parent is passed
            seen["current"] = ttrace.current_id()
            ttrace.record("chunk", 0, 1, parent=later)

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    ttrace.record("late", 0, 1, id=later)
    a = _by_name(traced.events())
    assert seen["current"] is None
    assert a["outer"]["k"] == 1 and a["outer"]["parent"] is None
    assert a["inner"]["parent"] == a["outer"]["id"]
    assert a["stamped"]["parent"] == a["inner"]["id"]
    assert a["chunk"]["parent"] == a["late"]["id"] == later
    assert a["late"]["parent"] is None       # recorded after "outer" closed
    assert len({x["id"] for x in a.values()}) == len(a)


def test_nothing_runs_while_tracing_is_off():
    ttrace.reset()
    assert not ttrace.tracing()
    assert ttrace.span("x") is ttrace.span("y")          # the shared no-op
    assert ttrace.next_id() is None and ttrace.current_id() is None
    with ttrace.span("x"):
        assert ttrace.current_id() is None               # no stack was kept
    assert ttrace.record("x", 0, 1) is None
    assert ttrace.TRACER.events() == []


def test_deferred_finish_runs_once_before_events_are_read(traced):
    ev = ttrace.record("late", 0, 1)
    calls = []
    traced.defer(lambda: (calls.append(1), ev["args"].update(device_us=7.0)))
    assert calls == []
    assert _by_name(traced.events())["late"]["device_us"] == 7.0
    traced.events()
    assert calls == [1]


class _FakeEvent:
    """``torch.cuda.Event`` on the CPU: stamps the host clock at ``record``,
    done at once unless ``pending``."""
    made = 0
    pending = False

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        import time

        self.t = time.perf_counter()

    def query(self):
        return not type(self).pending

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class _FakeCudaArg:
    """A kernel argument that reports the card as its device."""
    device = torch.device("cuda")


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA events and streams faked on the CPU; any synchronize fails."""
    _FakeEvent.made, _FakeEvent.pending = 0, False
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)

    def no_sync(*a, **k):
        raise AssertionError("tracing synchronized the card")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    return _FakeEvent


@pytest.mark.parametrize("pending", [False, True], ids=["done", "pending"])
def test_device_span_times_the_card_only_while_tracing(fake_card, pending):
    from repro_torch.kernels import _obs as kobs

    ttrace.reset()
    with kobs.device_span("stage1.transform", "cuda"):
        pass
    assert fake_card.made == 0 and ttrace.TRACER.events() == []
    fake_card.pending = pending
    ttrace.enable()
    try:
        with kobs.device_span("stage1.transform", "cuda", n=3):
            with kobs.device_span("stage1.to_host", "cpu"):   # a plain span on the CPU
                pass
        assert fake_card.made == 2
        a = _by_name(ttrace.TRACER.events())
    finally:
        ttrace.disable()
        ttrace.reset()
    assert a["stage1.transform"]["n"] == 3 and a["stage1.transform"]["device_us"] >= 0
    assert a["stage1.to_host"]["parent"] == a["stage1.transform"]["id"]
    assert "device_us" not in a["stage1.to_host"]


def test_kernel_wrapper_on_the_card_never_synchronizes(fake_card):
    from repro_torch.kernels import _obs as kobs

    secs = tobs.REGISTRY.get("cz_kernel_seconds")
    probe = kobs.instrument("obs_probe")(lambda x: x)
    arg = _FakeCudaArg()
    ttrace.reset()
    probe(arg)                                  # untraced: no event, no wait
    assert fake_card.made == 0
    ttrace.enable()
    try:
        with ttrace.span("caller"):
            probe(arg)
        a = _by_name(ttrace.TRACER.events())
    finally:
        ttrace.disable()
        ttrace.reset()
    assert fake_card.made == 2
    assert a["kernel.execute"]["device_us"] >= 0
    assert a["kernel.execute"]["parent"] == a["caller"]["id"]
    assert a["kernel.execute"]["device"] == "cuda"
    for phase in ("compile", "execute"):
        assert secs.snapshot(kernel="obs_probe", device="cuda", phase=phase)["count"] == 1


class _FakeTensor:
    def __init__(self, device, numel, itemsize, pinned=False):
        self.device = torch.device(device)
        self._n, self._b, self._p = numel, itemsize, pinned

    def numel(self):
        return self._n

    def element_size(self):
        return self._b

    def is_pinned(self):
        return self._p


def test_copy_counter_counts_only_copies_that_cross():
    from repro_torch.kernels import _obs as kobs

    copies = tobs.REGISTRY.get("cz_copy_bytes_total")

    def series():
        return {tuple(sorted(labels.items())): v for labels, v in copies.samples()}

    before = series()
    kobs.count_copy(torch.zeros(8), "cpu", "probe.same")            # stays on the host
    kobs.count_copy(_FakeTensor("cuda", 8, 4), "cuda", "probe.same")  # stays on the card
    assert series() == before
    kobs.count_copy(_FakeTensor("cuda", 10, 4), "cpu", "probe.d2h")
    kobs.count_copy(_FakeTensor("cpu", 10, 1), "cuda", "probe.h2d")
    kobs.count_copy(_FakeTensor("cpu", 3, 2, pinned=True), torch.device("cuda"), "probe.h2d")
    assert copies.value(direction="d2h", site="probe.d2h", pinned="false") == 40
    assert copies.value(direction="h2d", site="probe.h2d", pinned="false") == 10
    assert copies.value(direction="h2d", site="probe.h2d", pinned="true") == 6
