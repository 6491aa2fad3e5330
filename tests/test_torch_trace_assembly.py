"""paddle_tpu_torch's trace assembly against the JAX reference on the
CPU (tests/test_trace.py's scenarios): the TraceAssembler on the same
scraped bodies (clock-offset correction, skew ambiguity, completeness,
the unattributed gap), ``chrome_trace`` and ``ttft_breakdown`` on the
same cohorts, the engines' per-hop spans and ``/debug/traces``, the KV
handoff joining the decode tier to the prefill tier's trace between the
packages both ways, and a request across the router's two-hop path,
whose assembled trace has every canonical segment in both packages.

Bodies are built with fixed span ids and wall times, so the assembled
dicts compare exactly; from live engines only span names, the replicas
and completeness are compared.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.observability import trace as jtrace
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.router import EngineGateway as JaxGateway
from paddle_tpu.serving.router import InProcessTransport as JaxTransport
from paddle_tpu.serving.router import Router as JaxRouter
from paddle_tpu.serving.router import RouterConfig as JaxRouterConfig

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.serving import (EngineGateway, InProcessTransport,
                                      Router, RouterConfig, ServingEngine)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _span(tid, name, t0, dur, replica, i):
    return {"trace_id": tid, "span_id": f"{i:016x}",
            "parent_id": "p" * 16, "name": name, "replica": replica,
            "t0": t0, "dur": dur}


def _body(replica, spans, wall_time):
    return {"replica_id": replica, "wall_time": wall_time, "state": {},
            "spans": spans}


def _cohort(seed, n_traces=4, drop=0):
    """Seeded multi-replica span bodies: ``n_traces`` requests through
    the nine canonical segments on three replicas with skewed clocks,
    the last ``drop`` segments of odd traces missing."""
    rs = np.random.RandomState(seed)
    hosts = {"router": 0.0, "p0": float(rs.uniform(-2, 2)),
             "d0": float(rs.uniform(-2, 2))}
    where = ("router", "router", "p0", "p0", "p0", "router", "d0", "d0",
             "d0")
    per = {h: [] for h in hosts}
    tids, i = [], 0
    for j in range(n_traces):
        tid = f"{seed:04x}{j:028x}"
        tids.append(tid)
        t = 1000.0 + 10 * j
        segs = ttrace.CANONICAL_SEGMENTS
        if j % 2 and drop:
            segs = segs[:-drop]
        for name, host in zip(segs, where):
            dur = float(rs.uniform(0.001, 0.02))
            per[host].append(_span(tid, name, t + hosts[host], dur, host, i))
            i += 1
            t += dur + float(rs.uniform(0, 0.002))
    return tids, [(_body(h, per[h], 2000.0 + skew), skew)
                  for h, skew in hosts.items()]


def _assemblers(bodies, rtt):
    out = []
    for mod in (ttrace, jtrace):
        asm = mod.TraceAssembler()
        for body, skew in bodies:
            # the scrape stamps bracket the replica's wall_time
            t_req = body["wall_time"] - skew - rtt / 2
            asm.add_body(body, t_req=t_req, t_resp=t_req + rtt)
        out.append(asm)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rtt", [0.0005, 3.0])
@pytest.mark.parametrize("drop", [0, 2])
def test_assembler_matches_reference(seed, rtt, drop):
    """Offset correction, skew flags, completeness and the gap: the
    same assembled traces from the same bodies and scrape stamps."""
    tids, bodies = _cohort(seed, drop=drop)
    ours, ref = _assemblers(bodies, rtt)
    assert ours.trace_ids() == ref.trace_ids() == sorted(tids)
    for tid in tids:
        a, b = ours.assemble(tid), ref.assemble(tid)
        assert a.as_dict() == b.as_dict()
        assert a.complete == (drop == 0 or tid[-1] in "02468ace")
    assert [t.as_dict() for t in ours.assemble_all()] == \
        [t.as_dict() for t in ref.assemble_all()]
    if rtt > 1:
        assert any(r["skew_ambiguous"] for r in
                   ours.assemble(tids[0]).timeline())
    assert ours.assemble("ee" * 16) is None


@pytest.mark.parametrize("seed", [0, 5])
def test_chrome_trace_and_ttft_breakdown_match_reference(seed):
    tids, bodies = _cohort(seed, n_traces=5, drop=1)
    ours, ref = _assemblers(bodies, 0.001)
    a = [ours.assemble(t) for t in tids]
    b = [ref.assemble(t) for t in tids]
    assert ttrace.chrome_trace(a) == jtrace.chrome_trace(b)
    assert ttrace.ttft_breakdown(a) == jtrace.ttft_breakdown(b)
    json.dumps(ttrace.chrome_trace(a))


def test_assembler_rejects_non_body_and_keys_match():
    with pytest.raises(ValueError):
        ttrace.TraceAssembler().add_body({"not": "a body"})
    assert ttrace.CANONICAL_SEGMENTS == jtrace.CANONICAL_SEGMENTS
    assert ttrace.TRACE_SNAPSHOT_KEYS == jtrace.TRACE_SNAPSHOT_KEYS


# ---------------------------------------------------------- engines

@pytest.fixture(scope="module")
def models():
    jm = jax_gpt(seed=11)
    return jm, torch_twin(jm)


KNOBS = dict(num_slots=2, bucket_min=8, paged=True)


def _names(asm, tid):
    return sorted(s["name"] for s in asm.assemble(tid).spans)


def test_engine_spans_and_debug_traces(models):
    """Each request leaves its prefill-side spans under its own trace id
    in both packages; ``/debug/traces`` serves the ring and an assembler
    scraping it rebuilds one trace per request."""
    jm, tm = models
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 97, (int(n),)).astype(np.int64)
               for n in (5, 9, 14)]
    engines = (ServingEngine(tm, device="cpu", **KNOBS),
               JaxEngine(jm, **KNOBS))
    names = []
    for eng in engines:
        reqs = [eng.add_request(p, 3) for p in prompts]
        eng.run()
        asm = (ttrace if isinstance(eng, ServingEngine)
               else jtrace).TraceAssembler()
        asm.add_recorder(eng.trace)
        names.append([_names(asm, r.trace.trace_id) for r in reqs])
    assert names[0] == names[1]
    assert names[0][0] == ["prefill/compute", "prefill/queue"]
    ours = engines[0]
    h = ours.serve_metrics()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{h.port}/debug/traces") as resp:
            body = json.loads(resp.read())
        assert body["replica_id"] == ours.replica_id
        asm = ttrace.TraceAssembler()
        asm.scrape(f"127.0.0.1:{h.port}")
        assert len(asm.trace_ids()) == len(prompts)
        snap = ours.metrics.snapshot()["trace"]
        assert set(snap) == set(ttrace.TRACE_SNAPSHOT_KEYS)
        assert snap["spans_recorded"] == 2 * len(prompts)
    finally:
        for eng in engines:
            eng.close()


def test_trace_spans_off_keeps_the_surface(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", trace_spans=False, **KNOBS)
    eng.add_request(np.arange(1, 9), 3)
    eng.run()
    snap = eng.metrics.snapshot()["trace"]
    assert snap["enabled"] is False and snap["spans_recorded"] == 0
    assert eng.trace.debug_traces()["spans"] == []
    eng.close()


@pytest.mark.parametrize("direction", ["port->port", "port->jax",
                                       "jax->port"])
def test_kv_handoff_joins_the_prefill_trace(models, direction):
    """The handoff carries the trace: the decode tier's spans land under
    the prefill tier's trace id, and the two rings assemble the kv
    segments, whichever package serves each tier."""
    jm, tm = models

    def make(pkg, role):
        return ServingEngine(tm, device="cpu", role=role, **KNOBS) \
            if pkg == "port" else JaxEngine(jm, role=role, **KNOBS)
    src, dst = direction.split("->")
    pe, de = make(src, "prefill"), make(dst, "decode")
    ctx = ttrace.TraceContext.mint(baggage={"rid": "wire"})
    req = pe.add_request(np.arange(1, 20), 1, hold_kv=True,
                         trace=ctx.as_dict())
    pe.run()
    dreq = de.import_kv(json.loads(json.dumps(pe.export_kv(req.rid))), 4)
    de.run()
    assert dreq.trace.trace_id == ctx.trace_id
    assert dreq.trace.minted_local is False
    asm = ttrace.TraceAssembler()
    asm.add_recorder(pe.trace)
    asm.add_recorder(de.trace)
    assert {"prefill/compute", "kv/export", "kv/import", "decode/queue",
            "decode/first_step"} <= set(_names(asm, ctx.trace_id))
    pe.close()
    de.close()


def test_corrupted_wire_trace_mints_a_local_root(models):
    _, tm = models
    pe = ServingEngine(tm, device="cpu", role="prefill", **KNOBS)
    de = ServingEngine(tm, device="cpu", role="decode", **KNOBS)
    req = pe.add_request(np.arange(1, 20), 1, hold_kv=True)
    pe.run()
    payload = pe.export_kv(req.rid)
    payload["trace"] = {"traceparent": "garbage"}
    dreq = de.import_kv(payload, 3)
    de.run()
    assert dreq.trace.minted_local is True and len(dreq.generated) == 3
    assert dreq.trace.trace_id in de.trace.trace_ids()
    pe.close()
    de.close()


def _two_hop(mods, engine_fn):
    """One prefill and one decode replica behind a router; three
    requests take the two-hop path. Returns the assembled traces."""
    gateway, transport, router_cls, cfg_cls = mods
    gp = gateway(engine_fn("prefill", "p0"))
    gd = gateway(engine_fn("decode", "d0"))
    router = router_cls([transport(gp), transport(gd)],
                        config=cfg_cls(refresh_s=0.01, hedge=False,
                                       affinity=False))
    try:
        router.refresh(force=True)
        assert router.state()["disagg"]["prefill_replicas"] == ["p0"]
        results = [router.submit(list(range(1 + i, 18 + i)), 4,
                                 tenant_id="acme").result(timeout=60.0)
                   for i in range(3)]
        assert all(r["ok"] for r in results), results
        asm = (ttrace if gateway is EngineGateway
               else jtrace).TraceAssembler()
        for rec in (router.trace, gp.engine.trace, gd.engine.trace):
            asm.add_recorder(rec)
        return [asm.assemble(t) for t in asm.trace_ids()], \
            [r["tokens"] for r in results], gd.engine
    finally:
        router.close()
        gp.close()
        gd.close()


def test_router_two_hop_traces_are_complete_in_both_packages(models):
    """Across the router's disaggregated path every request assembles
    into one trace with all nine canonical segments, in the port as in
    the reference; the streams agree and the decode tier bills the
    tenant the router admitted."""
    jm, tm = models
    port = _two_hop(
        (EngineGateway, InProcessTransport, Router, RouterConfig),
        lambda role, rid: ServingEngine(tm, device="cpu", role=role,
                                        replica_id=rid, **KNOBS))
    ref = _two_hop(
        (JaxGateway, JaxTransport, JaxRouter, JaxRouterConfig),
        lambda role, rid: JaxEngine(jm, role=role, replica_id=rid,
                                    **KNOBS))
    assert port[1] == ref[1]
    for traces in (port[0], ref[0]):
        assert len(traces) == 3
        for t in traces:
            assert t.complete, t.missing_segments()
            assert set(t.replicas) == {"router", "p0", "d0"}
    assert [sorted(s["name"] for s in t.spans) for t in port[0]] == \
        [sorted(s["name"] for s in t.spans) for t in ref[0]]
    bd = ttrace.ttft_breakdown(port[0])
    assert bd["complete"] == 3
    rows = port[2].metrics.tenant_report()["tenants"]
    assert set(rows) == {"acme"}
