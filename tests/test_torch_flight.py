"""paddle_tpu_torch's request flight recorder and SLO tracker against
the JAX reference on the CPU (tests/test_flight.py's scenarios): the
tracker's verdicts, goodput and windows on the same seeded requests
under one injected clock; the recorder on the same lifecycles under one
clock (the same ``/debug/requests`` body, the same marker spans and flow
chains); and the engines on the same traffic, whose every request goes
through the same lifecycle events in the same order, with the same SLO
verdicts, on both pools, pipelined or not, chunked, speculative, shed,
timed out and aborted.

The recorder's and tracker's outputs compare exactly. From live
engines only event names, attributes that are not wall-clock seconds,
and counts are compared.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.observability import FlightRecorder as JaxFlight
from paddle_tpu.observability import HostSpanRecorder as JaxSpans
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import SLOTracker as JaxSLO
from paddle_tpu.serving import ServingEngine as JaxEngine

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.observability import (FlightRecorder,
                                            HostSpanRecorder,
                                            MetricsRegistry, SLOTracker)
from paddle_tpu_torch.serving import ServingEngine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------- SLOTracker

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("targets", [(None, None), (100.0, None),
                                     (80.0, 12.0)])
def test_slo_tracker_matches_reference(targets, seed):
    clock = _Clock()
    trackers = [SLOTracker(MetricsRegistry(), *targets, window_s=5.0,
                           clock=clock),
                JaxSLO(JaxRegistry(), *targets, window_s=5.0, clock=clock)]
    rs = np.random.RandomState(seed)
    for _ in range(60):
        clock.t += float(rs.rand())
        if rs.rand() < 0.1:
            reason = ("slo_lost", "deadline")[rs.randint(2)]
            for s in trackers:
                s.observe_shed(reason)
            continue
        ttft = None if rs.rand() < 0.05 else float(rs.rand() * 0.2)
        lat = float((ttft or 0.0) + rs.rand() * 0.5)
        toks = int(rs.randint(1, 30))
        verdicts = [s.observe_request(ttft, lat, toks) for s in trackers]
        assert verdicts[0] == verdicts[1]
    a, b = (s.report() for s in trackers)
    assert a == b
    assert a["attained"] + sum(v for k, v in a["violations"].items()
                               if k in ("ttft", "tpot")) >= 0
    if targets == (None, None):
        assert set(a["violations"]) <= {"slo_lost", "deadline"}


# ------------------------------------------------------ flight recorder

class _Req:
    def __init__(self, rid, prompt_len, tenant):
        self.rid = rid
        self.prompt = list(range(prompt_len))
        self.max_new_tokens = 8
        self.generated = []
        self.tenant_id = tenant
        self.dispatch_failures = 0
        self.trace = None


def _lifecycle(fl, req, rs):
    """One request's events, some paths rarer than others."""
    fl.enqueued(req)
    if rs.rand() < 0.15:
        fl.shed(req, "slo_lost", -3.5)
        return
    fl.admitted(req, slot=int(rs.randint(4)), bucket=16, group_size=1)
    if rs.rand() < 0.2:
        req.dispatch_failures += 1
        fl.dispatch_failed(req, "prefill", RuntimeError("boom"))
        fl.admission_rolled_back(req)
        fl.admitted(req, slot=1, bucket=16, group_size=1)
    if rs.rand() < 0.3:
        fl.prefix_hit(req, 16, 3, saved_ms=None if rs.rand() < 0.5
                      else 1.25)
    fl.prefill_dispatched(req, bucket=16, group_size=1)
    for n in range(1, int(rs.randint(2, 12))):
        req.generated.append(n)
        fl.token_emitted(req, n)
        if rs.rand() < 0.1:
            fl.draft_accepted(req, 2, 4)
            fl.draft_rejected(req, 2, 4)
        if rs.rand() < 0.05:
            fl.callback_error(req, ValueError("cb"))
    if rs.rand() < 0.2:
        fl.deadline_exceeded(req, 12.0)
        fl.retired(req, "deadline", slo_violations=["deadline"])
    else:
        fl.retired(req, "max_tokens", slo_violations=[])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("keep", [3, 256])
def test_flight_recorder_matches_reference(seed, keep):
    """The same lifecycles under one clock: the same traces, state,
    ``debug_requests`` (whole and per tenant), marker spans and flows."""
    clocks = [_Clock(), _Clock()]
    spans = [HostSpanRecorder(capacity=4096), JaxSpans(capacity=4096)]
    fls = [FlightRecorder(recorder=spans[0], keep_last=keep,
                          decode_window=4, clock=clocks[0]),
           JaxFlight(recorder=spans[1], keep_last=keep, decode_window=4,
                     clock=clocks[1])]
    for rid in range(12):
        tenant = ("acme", "zeta", None)[rid % 3]
        for fl, clock in zip(fls, clocks):
            clock.t += 0.001 * (rid + 1)
            _lifecycle(fl, _Req(rid, 5 + rid, tenant),
                       np.random.RandomState(seed * 100 + rid))
    a, b = fls
    assert a.debug_requests() == b.debug_requests()
    assert a.debug_requests(tenant="acme") == b.debug_requests(tenant="acme")
    assert a.state() == b.state()
    assert all(t.tenant_id == "acme" for t in a.completed()
               if t.rid in {r["rid"] for r in
                            a.debug_requests(tenant="acme")["completed"]})
    sa = [(s.name, s.t0, s.args) for s in spans[0].spans()]
    sb = [(s.name, s.t0, s.args) for s in spans[1].spans()]
    assert sa == sb
    assert [(f.fid, f.phase, f.t) for f in spans[0].flows()] == \
        [(f.fid, f.phase, f.t) for f in spans[1].flows()]
    json.dumps(a.debug_requests())


def test_kv_exported_appends_to_a_retired_trace():
    fl = FlightRecorder(recorder=HostSpanRecorder(capacity=64))
    req = _Req(7, 9, "acme")
    fl.enqueued(req)
    fl.retired(req, "max_tokens")
    fl.kv_exported(req, 2, 4096)
    events = [e["event"] for e in fl.trace(7).events]
    assert events == ["enqueued", "retired", "kv_exported"]


# ---------------------------------------------------------- engines

@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


_TIMED = ("t", "t_rel_ms", "saved_ms", "headroom_ms", "overrun_ms",
          "trace_id")


def _events(eng, rids):
    out = []
    for rid in rids:
        tr = eng.request_trace(rid)
        out.append([{k: v for k, v in e.items() if k not in _TIMED}
                    for e in tr.events] + [tr.reason, tr.tenant_id])
    return out


def _traffic(eng, seed, n=7, **kw):
    rs = np.random.RandomState(seed)
    stem = rs.randint(0, 97, (17,)).astype(np.int64)
    reqs = []
    for i in range(n):
        p = np.concatenate([stem, rs.randint(0, 97, (int(
            rs.randint(1, 9)),)).astype(np.int64)]) if i % 2 else \
            rs.randint(0, 97, (int(rs.randint(3, 26)),)).astype(np.int64)
        reqs.append(eng.add_request(p, int(rs.randint(2, 9)),
                                    tenant_id=("a", "b")[i % 2], **kw))
    eng.run()
    return reqs


ENGINE_CASES = {
    "paged": dict(paged=True),
    "paged_sync": dict(paged=True, async_depth=0),
    "slot": dict(paged=False),
    "slot_chunked": dict(paged=False, prefill_chunk=8),
    "paged_chunked": dict(paged=True, prefill_chunk=8),
    "paged_spec": dict(paged=True, speculative=True, spec_k=3),
    "slo_window": dict(paged=True, slo_ttft_ms=1e4, slo_tpot_ms=1e4,
                       trace_decode_window=2),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_lifecycles_match_reference(models, case):
    """The same traffic on both engines: the same streams and, for
    every request, the same lifecycle events with the same attributes
    in the same order; the same SLO report counts; a flight trace per
    request, each retired."""
    jm, tm = models
    kw = dict(num_slots=3, bucket_min=8, block_size=8,
              **ENGINE_CASES[case])
    ours = ServingEngine(tm, device="cpu", **kw)
    ref = JaxEngine(jm, **kw)
    a, b = _traffic(ours, 4), _traffic(ref, 4)
    assert [r.generated for r in a] == [r.generated for r in b]
    assert _events(ours, [r.rid for r in a]) == \
        _events(ref, [r.rid for r in b])
    sa, sb = ours.metrics.slo.report(), ref.metrics.slo.report()
    for key in ("requests", "attained", "violations", "goodput_tokens",
                "total_tokens"):
        assert sa[key] == sb[key], key
    # (a draft verdict landing after its request retired inside a
    # verify block opens a partial trace in both packages)
    st = ours.flight.state()
    assert st == ref.flight.state()
    assert st["completed_kept"] == len(a)
    ours.close()
    ref.close()


def test_engine_shed_timeout_and_abort_lifecycles(models):
    """A shed request, a request past its deadline and an aborted one
    each close their trace with the reason, counted in the SLO report
    as violations, billed to their tenant."""
    _, tm = models
    eng = ServingEngine(tm, device="cpu", num_slots=1, bucket_min=8,
                        policy="slo_feedback", slo_ttft_ms=1e-6)
    eng._policy.observe_service(50.0)
    shed = [eng.add_request(np.arange(1, 9), 3, tenant_id="s")
            for _ in range(3)]
    eng.run()
    reasons = [eng.request_trace(r.rid).reason for r in shed]
    assert "shed" in reasons
    slow = ServingEngine(tm, device="cpu", num_slots=1, bucket_min=8)
    r1 = slow.add_request(np.arange(1, 9), 30, tenant_id="x")
    r2 = slow.add_request(np.arange(1, 9), 3, tenant_id="y",
                          deadline_ms=1e-3)
    slow.step()
    slow.step()
    slow.close()
    t1, t2 = slow.request_trace(r1.rid), slow.request_trace(r2.rid)
    assert t1.reason == "aborted" and t2.reason == "deadline"
    assert "deadline_exceeded" in [e["event"] for e in t2.events]
    rows = slow.metrics.tenant_report()["tenants"]
    assert rows["x"]["aborts"] == 1 and rows["y"]["timeouts"] == 1
    assert slow.metrics.slo.report()["violations"]["deadline"] == 1
    eng.close()


def test_engine_retention_is_bounded(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                        completed_keep=3, trace_keep=4)
    reqs = _traffic(eng, 5, n=9)
    assert len(eng.scheduler.completed) == 3
    st = eng.flight.state()
    assert st["completed_kept"] == 4 and st["completed_dropped"] == 5
    assert eng.request_trace(reqs[0].rid) is None
    assert eng.request_trace(reqs[-1].rid).reason == "max_tokens"
    eng.close()


def test_debug_requests_route_filters_by_tenant(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8)
    reqs = _traffic(eng, 6)
    h = eng.serve_metrics()
    try:
        url = f"http://127.0.0.1:{h.port}/debug/requests"
        with urllib.request.urlopen(url + "?tenant=a") as resp:
            body = json.loads(resp.read())
        want = {r.rid for r in reqs if r.tenant_id == "a"}
        assert {t["rid"] for t in body["completed"]} == want
        assert body["tenant"] == "a"
        with urllib.request.urlopen(url) as resp:
            everything = json.loads(resp.read())
        assert len(everything["completed"]) == len(reqs)
        assert everything["state"]["completed_kept"] == len(reqs)
    finally:
        eng.close()
