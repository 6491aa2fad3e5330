"""paddle_tpu_torch's observability layer against the JAX reference on
the CPU: Prometheus text from the same registry operations is byte-equal
to the reference's, the seeded reservoirs keep the same samples, the
histogram merge and percentile helpers agree, the metrics server's POST
and GET contracts (tests/test_router.py's), the host-span recorder's
chrome export, the trace context (mint, parse, coerce and the
traceparent round trip), the trace span ring, replica identity and the
deterministic backoff jitter."""
import http.client
import json
import urllib.error
import urllib.request

import pytest

from paddle_tpu.observability import registry as jreg
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.observability.fleet.identity import (
    ReplicaIdentity as JaxIdentity)
from paddle_tpu.observability.fleet.poller import (
    backoff_jitter_unit as jax_jitter)
from paddle_tpu.observability.trace import TraceContext as JaxContext
from paddle_tpu.observability.trace import TraceRecorder as JaxRecorder

from paddle_tpu_torch.observability import (
    HostSpanRecorder, MetricsRegistry, Reservoir, WindowedReservoir,
    merge_histogram_snapshots, percentile_from_buckets,
    prometheus_text_from_snapshots, start_metrics_server)
from paddle_tpu_torch.observability.fleet import (ReplicaIdentity,
                                                  backoff_jitter_unit,
                                                  default_replica_id)
from paddle_tpu_torch.observability.trace import (TRACEPARENT_RE,
                                                  TraceContext,
                                                  TraceRecorder)


def _populate(reg):
    """The same operations on either package's registry."""
    c = reg.counter("requests_total", "requests served")
    c.inc()
    c.inc(2.5)
    lab = reg.counter("dispatches_total", "dispatches by kind",
                      labelnames=("kind", "replica"))
    lab.labels("prefill", "r0").inc(3)
    lab.labels("decode", 'r"1\\').inc()
    g = reg.gauge("queue_depth", "queued requests\nper step")
    g.set(7)
    g.dec(2)
    pull = reg.gauge("uptime_seconds", "pull gauge")
    pull.set_function(lambda: 12.5)
    h = reg.histogram("latency_seconds", "latency",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.07):
        h.observe(v)
    hl = reg.histogram("ttft_seconds", "ttft", labelnames=("tier",))
    hl.labels("a").observe(0.2)
    hl.labels("b").observe(3.0)
    return reg


def test_prometheus_text_is_byte_equal_to_reference():
    ours = _populate(MetricsRegistry()).prometheus_text()
    ref = _populate(jreg.MetricsRegistry()).prometheus_text()
    assert ours == ref
    assert "# TYPE latency_seconds histogram" in ours
    a = _populate(MetricsRegistry())
    b = _populate(jreg.MetricsRegistry())
    assert a.snapshot() == b.snapshot()
    assert a.snapshot_json() == b.snapshot_json()
    snaps = [("r0", a.snapshot()), ("r1", a.snapshot())]
    jsnaps = [("r0", b.snapshot()), ("r1", b.snapshot())]
    assert prometheus_text_from_snapshots(snaps) == \
        jreg.prometheus_text_from_snapshots(jsnaps)


def test_histogram_merge_and_percentiles_equal_reference():
    a = _populate(MetricsRegistry()).snapshot()
    b = _populate(jreg.MetricsRegistry()).snapshot()
    key = next(k for k in a if k.startswith("latency_seconds"))
    entries = [a[key], a[key]]
    merged = merge_histogram_snapshots(entries)
    assert merged == jreg.merge_histogram_snapshots([b[key], b[key]])
    for q in (50, 90, 99):
        assert percentile_from_buckets(merged["buckets"], q) == \
            jreg.percentile_from_buckets(merged["buckets"], q)


@pytest.mark.parametrize("seed", [0, 7, 0x5EED])
def test_reservoir_keeps_the_reference_samples(seed):
    ours, ref = Reservoir(capacity=16, seed=seed), \
        jreg.Reservoir(capacity=16, seed=seed)
    for i in range(500):
        v = (i * 37) % 101 / 7.0
        ours.add(v)
        ref.add(v)
    assert ours.samples() == ref.samples()
    assert ours.seen == ref.seen == 500
    for q in (0, 50, 99, 100):
        assert ours.percentile(q) == ref.percentile(q)
    w, jw = WindowedReservoir(window_s=10.0, capacity=8), \
        jreg.WindowedReservoir(window_s=10.0, capacity=8)
    for t in range(30):
        w.add(t, now=float(t))
        jw.add(t, now=float(t))
    assert w.values(now=30.0) == jw.values(now=30.0)
    assert w.percentile(90, now=30.0) == jw.percentile(90, now=30.0)


def _post_raw(port, path, raw):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=raw,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            raw_out = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as e:
        raw_out, status = e.read().decode(), e.code
    try:
        return status, json.loads(raw_out)
    except json.JSONDecodeError:
        return status, {"_raw": raw_out}


def test_metrics_server_post_contract():
    reg = MetricsRegistry()
    seen = []

    def echo(body):
        seen.append(body)
        if body.get("boom"):
            raise RuntimeError("handler exploded")
        if body.get("teapot"):
            return (418, {"short": "stout"})
        return {"ok": True, "n": body.get("n")}

    handle = start_metrics_server(reg, post_routes={"/echo": echo},
                                  max_body_bytes=4096)
    try:
        port = handle.port
        assert _post_raw(port, "/echo", b'{"n": 3}') == \
            (200, {"ok": True, "n": 3})
        st, out = _post_raw(port, "/echo", b'{"teapot": 1}')
        assert st == 418 and out == {"short": "stout"}
        st, out = _post_raw(port, "/echo", b'{"n": oops')
        assert st == 400 and out["error"] == "malformed JSON body"
        st, out = _post_raw(port, "/echo", b'[1, 2]')
        assert st == 400 and out["error"] == "malformed JSON body"
        st, out = _post_raw(port, "/echo",
                            b'{"pad": "' + b"x" * 8192 + b'"}')
        assert st == 413 and "body too large" in out["error"]
        st, out = _post_raw(port, "/echo", b'{"boom": 1}')
        assert st == 500 and "RuntimeError" in out["error"]
        st, _ = _post_raw(port, "/nope", b"{}")
        assert st == 404
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5.0)
        conn.putrequest("POST", "/echo", skip_accept_encoding=True)
        conn.putheader("Content-Type", "application/json")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 411
        resp.read()
        conn.close()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics.json",
                timeout=5.0) as resp:
            assert resp.status == 200
        assert seen and seen[0] == {"n": 3}
    finally:
        handle.close()
    assert handle.closed
    handle.close()                       # idempotent


def test_metrics_server_get_routes():
    reg = _populate(MetricsRegistry())
    calls = []

    def q(params):
        calls.append(params)
        return {"params": params}
    q.accepts_query = True
    handle = start_metrics_server(
        reg, extra_routes={"/debug/state": lambda: {"a": 1},
                           "/debug/text": lambda: "plain\n",
                           "/debug/q": q,
                           "/debug/boom": lambda: 1 / 0})
    try:
        base = handle.url

        def get(path):
            try:
                with urllib.request.urlopen(base + path, timeout=5.0) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, ""
        st, body = get("/metrics")
        assert st == 200 and body == reg.prometheus_text()
        assert get("/debug/state") == (200, '{"a": 1}')
        assert get("/debug/text") == (200, "plain\n")
        assert json.loads(get("/debug/q?tenant=x")[1]) == \
            {"params": {"tenant": "x"}}
        index = json.loads(get("/debug")[1])["routes"]
        assert "/debug/state" in index and "/metrics" in index
        assert get("/debug/boom")[0] == 500
        assert get("/nope")[0] == 404
    finally:
        handle.close()


def test_host_span_recorder_chrome_export_matches_reference():
    ours, ref = HostSpanRecorder(capacity=3), \
        jtracing.HostSpanRecorder(capacity=3)
    for rec in (ours, ref):
        for i in range(5):
            rec.record(f"s{i}", float(i), 0.5, args={"i": i})
        rec.record_flow("req", 1.0, "s", 42)
        rec.record_flow("req", 2.0, "f", 42)
    assert ours.dropped == ref.dropped == 2
    a, b = ours.chrome_trace("p"), ref.chrome_trace("p")
    strip = [{k: v for k, v in e.items() if k not in ("pid", "tid")}
             for e in a["traceEvents"]]
    jstrip = [{k: v for k, v in e.items() if k not in ("pid", "tid")}
              for e in b["traceEvents"]]
    assert strip == jstrip
    with pytest.raises(ValueError):
        ours.record_flow("x", 0.0, "q", 1)


def test_trace_context_round_trip_equals_reference():
    ctx = TraceContext.mint(baggage={"rid": "q1", "tenant": "t"})
    assert TRACEPARENT_RE.match(ctx.to_traceparent())
    j = JaxContext.from_traceparent(ctx.to_traceparent(),
                                    baggage=ctx.baggage)
    assert j.as_dict() == ctx.as_dict()
    back = TraceContext.coerce(j.as_dict())
    assert (back.trace_id, back.span_id, back.baggage) == \
        (ctx.trace_id, ctx.span_id, ctx.baggage)
    assert TraceContext.coerce(ctx.to_traceparent()).trace_id == \
        ctx.trace_id
    child = ctx.child({"hop": 2})
    assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
    assert child.baggage == {"rid": "q1", "tenant": "t", "hop": 2}
    # garbage never raises: a locally minted root, as in the reference
    for bad in (None, "00-zz-yy-01", {"traceparent": 3}, 17,
                {"baggage": {}}):
        c, jc = TraceContext.coerce(bad), JaxContext.coerce(bad)
        assert c.minted_local and jc.minted_local
        assert TRACEPARENT_RE.match(c.to_traceparent())
    big = {f"k{i}": "v" * 300 for i in range(20)}
    assert TraceContext.mint(baggage=big).baggage == \
        JaxContext.mint(baggage=big).baggage
    with pytest.raises(ValueError):
        TraceContext.from_traceparent("not-a-header")


def test_trace_recorder_ring_matches_reference():
    ctx = TraceContext.mint()
    jctx = JaxContext(ctx.trace_id, ctx.span_id)
    ours, ref = TraceRecorder("router", capacity=2), \
        JaxRecorder("router", capacity=2)
    for rec, c in ((ours, ctx), (ref, jctx)):
        for i in range(3):
            rec.record(c, f"router/s{i}", 100.0 + i, 0.5, {"i": i})
        rec.record_root(c, "router/request", 99.0, 5.0)
        assert rec.record(None, "x", 0.0, 0.0) is None
    assert ours.snapshot() == ref.snapshot()
    strip = [{k: v for k, v in s.items() if k != "span_id"}
             for s in ours.for_trace(ctx.trace_id)]
    jstrip = [{k: v for k, v in s.items() if k != "span_id"}
              for s in ref.for_trace(ctx.trace_id)]
    assert strip == jstrip
    assert set(ours.debug_traces()) == set(ref.debug_traces())
    off = TraceRecorder("r", enabled=False)
    assert off.record(ctx, "x", 0.0, 1.0) is None
    assert off.snapshot()["spans_recorded"] == 0


def test_replica_identity_and_backoff_jitter_equal_reference():
    ident, jident = ReplicaIdentity("r0"), JaxIdentity("r0")
    assert set(ident.report()) == set(jident.report())
    assert ident.replica_id == "r0" and ident.uptime_s() >= 0.0
    assert ReplicaIdentity().replica_id == default_replica_id()
    for seed in (0, 3, "s"):
        for who in ("q1", "r0", 7):
            for attempt in range(1, 6):
                assert backoff_jitter_unit(seed, who, attempt) == \
                    jax_jitter(seed, who, attempt)
    assert backoff_jitter_unit(0, "q1", 1) != backoff_jitter_unit(1, "q1", 1)
