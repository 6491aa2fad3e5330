"""paddle_tpu_torch's tenant observatory against the JAX reference on
the CPU (tests/test_tenant.py's scenarios): the ledger on the same
seeded event streams, the ``OVERFLOW_TENANT`` fold past ``max_tenants``,
``add_request(tenant_id=)`` on both pools with the per-tenant sums equal
to the engine's own counters and to the JAX engine's, the tenant's
resolution from the trace baggage and its write-back, and the tenant
carried across a KV handoff between the packages both ways.

Counts compare exactly; the reservoir percentiles of live engines
(queue wait, TTFT, the ms a cache hit saved) ride the wall clock and
are dropped before comparing.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import tenant as jtenant
from paddle_tpu.serving import ServingEngine as JaxEngine

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.observability import tenant as ttenant
from paddle_tpu_torch.observability.trace import TraceContext
from paddle_tpu_torch.serving import ServingEngine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _events(seed, n_tenants, n=300):
    rs = np.random.RandomState(seed)
    names = [f"t{i}" for i in range(n_tenants)] + [None, ""]
    out = []
    for _ in range(n):
        t = names[rs.randint(len(names))]
        kind = rs.randint(8)
        if kind == 0:
            out.append(("note_admission", t, int(rs.randint(1, 50)),
                        float(rs.rand())))
        elif kind == 1:
            out.append(("note_first_token", t, float(rs.rand())))
        elif kind == 2:
            viol = [d for d in ("ttft", "tpot") if rs.rand() < 0.3]
            out.append(("note_completion", t, int(rs.randint(1, 40)), viol))
        elif kind == 3:
            out.append(("note_shed", t, "slo_lost"))
        elif kind == 4:
            out.append(("note_timeout", t))
        elif kind == 5:
            out.append(("note_abort", t))
        elif kind == 6:
            out.append(("note_cache_savings", t, int(rs.randint(1, 64)),
                        None if rs.rand() < 0.5 else float(rs.rand())))
        else:
            out.append(("note_admission", t, 3, 0.0))
    return out


def _ledgers(max_tenants):
    return (ttenant.TenantLedger(MetricsRegistry(), max_tenants=max_tenants),
            jtenant.TenantLedger(JaxRegistry(), max_tenants=max_tenants))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_tenants", [32, 3, 0])
def test_ledger_matches_reference(seed, max_tenants):
    """The same events: the same report, top list, overflow count and
    Prometheus families (the fold happens before any label is minted,
    so at most ``max_tenants + 1`` series)."""
    ledgers = _ledgers(max_tenants)
    regs = []
    for led in ledgers:
        led.set_queue_probe(lambda: {"t1": 2, "t9": 1, "zz": 4})
        for name, *args in _events(seed, n_tenants=6):
            getattr(led, name)(*args)
    a, b = (led.report() for led in ledgers)
    assert a == b
    assert ledgers[0].top(4) == ledgers[1].top(4)
    assert ledgers[0].overflow_events == ledgers[1].overflow_events
    if max_tenants == 3:
        assert ttenant.OVERFLOW_TENANT in a["tenants"]
        assert a["overflow"]["folded_events"] > 0
        assert len(a["tenants"]) <= 3 + 1


def test_flood_is_bounded():
    led = ttenant.TenantLedger(MetricsRegistry(), max_tenants=8)
    for i in range(10_000):
        led.note_admission(f"tenant-{i}", 4, 0.0)
    rep = led.report()
    assert rep["tenant_count"] == 9
    assert rep["tenants"][ttenant.OVERFLOW_TENANT]["requests"] == 10_000 - 8


def test_schema_is_the_references():
    for name in ("TENANT_KEYS", "TENANT_ENTRY_KEYS", "OVERFLOW_TENANT",
                 "DEFAULT_TENANT"):
        assert getattr(ttenant, name) == getattr(jtenant, name), name
    assert ttenant.disabled_tenant_report(5) == \
        jtenant.disabled_tenant_report(5)


# ---------------------------------------------------------- engines

VOLATILE = ("queue_wait", "ttft", "cache_saved_ms")


def _strip(rep):
    return {t: {k: v for k, v in e.items() if k not in VOLATILE}
            for t, e in rep["tenants"].items()}


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


SPECS = [(5, 3, "alice"), (7, 4, "bob"), (6, 2, "alice"), (9, 5, None),
         (12, 3, "carol"), (5, 6, "bob"), (20, 2, "alice")]


def _drive(eng, seed, specs=SPECS, **kw):
    rs = np.random.RandomState(seed)
    reqs = [eng.add_request(rs.randint(0, 97, (n,)).astype(np.int64), k,
                            tenant_id=t, **kw) for n, k, t in specs]
    eng.run()
    return reqs


def _conserved(eng):
    snap = eng.metrics.snapshot()
    rows = snap["tenants"]["tenants"].values()
    slo = snap["slo"]
    assert sum(e["requests"] for e in rows) == snap["requests_admitted"]
    assert sum(e["completed"] for e in rows) == snap["requests_completed"]
    assert sum(e["tokens_out"] for e in rows) == snap["tokens_generated"]
    assert sum(e["goodput_tokens"] for e in rows) == slo["goodput_tokens"]
    assert sum(e["attained"] for e in rows) == slo["attained"]
    fam = eng.metrics.registry.snapshot()["serving_tenant_tokens_out_total"]
    assert sum(fam["values"].values()) == snap["tokens_generated"]
    return snap


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("slo", [None, 1e-3])
def test_engine_tenants_match_reference(models, paged, slo):
    """The same tenant-tagged traffic on both engines: the same streams,
    the same per-tenant counts, and the sums conserved; with an SLO no
    request can meet, every one is a TTFT violation in both."""
    jm, tm = models
    kw = dict(num_slots=3, bucket_min=8, paged=paged, slo_ttft_ms=slo)
    ours = ServingEngine(tm, device="cpu", **kw)
    ref = JaxEngine(jm, **kw)
    a = [r.generated for r in _drive(ours, 0)]
    b = [r.generated for r in _drive(ref, 0)]
    assert a == b
    snap = _conserved(ours)
    assert _strip(snap["tenants"]) == \
        _strip(ref.metrics.snapshot()["tenants"])
    assert set(snap["tenants"]["tenants"]) == {"alice", "bob", "carol",
                                               "default"}
    assert snap["tenants"]["tenants"]["alice"]["tokens_out"] == 7
    if slo:
        assert snap["slo"]["attained"] == 0
    ours.close()
    ref.close()


def test_overflow_fold_in_the_engine(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                        max_tenants=2)
    specs = [(5, 2, f"t{i}") for i in range(6)]
    _drive(eng, 1, specs)
    rep = _conserved(eng)["tenants"]
    assert set(rep["tenants"]) == {"t0", "t1", ttenant.OVERFLOW_TENANT}
    assert rep["tenants"][ttenant.OVERFLOW_TENANT]["requests"] == 4
    off = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                        max_tenants=0)
    _drive(off, 1, specs)
    assert off.metrics.tenant_report() == ttenant.disabled_tenant_report(0)
    eng.close()
    off.close()


def test_tenant_resolves_from_baggage_and_is_written_back(models):
    """``tenant_id`` wins; else the baggage's ``tenant``; else
    ``"default"``; the resolved id lands in the baggage with the same
    trace and span ids, as in the reference."""
    jm, tm = models
    prompt = np.arange(1, 8)
    for eng, ctx_cls in ((ServingEngine(tm, device="cpu", num_slots=2),
                          TraceContext),
                         (JaxEngine(jm, num_slots=2), None)):
        ctx = TraceContext.mint(baggage={"tenant": "acme", "x": "1"})
        wire = ctx.as_dict()
        r1 = eng.add_request(prompt, 2, trace=wire)
        r2 = eng.add_request(prompt, 2, trace=wire, tenant_id="zeta")
        r3 = eng.add_request(prompt, 2)
        assert (r1.tenant_id, r2.tenant_id, r3.tenant_id) == \
            ("acme", "zeta", "default")
        assert r2.trace.baggage == {"tenant": "zeta", "x": "1"}
        assert r2.trace.trace_id == ctx.trace_id
        assert r2.trace.span_id == ctx.span_id
        assert r3.trace.baggage["tenant"] == "default"
        eng.run()
        eng.close()


@pytest.mark.parametrize("direction", ["port->port", "port->jax",
                                       "jax->port"])
def test_kv_handoff_carries_the_tenant(models, direction):
    """A prefill tier's export carries the request's trace and tenant;
    the decode tier of either package bills the import to it."""
    jm, tm = models
    kw = dict(num_slots=2, bucket_min=8, paged=True)

    def make(pkg, role):
        return ServingEngine(tm, device="cpu", role=role, **kw) \
            if pkg == "port" else JaxEngine(jm, role=role, **kw)
    src, dst = direction.split("->")
    pe, de = make(src, "prefill"), make(dst, "decode")
    r = pe.add_request(np.arange(3, 22), 1, hold_kv=True, tenant_id="acme")
    pe.run()
    payload = json.loads(json.dumps(pe.export_kv(r.rid)))
    assert payload["trace"]["baggage"]["tenant"] == "acme"
    d = de.import_kv(payload, 4)
    de.run()
    assert d.tenant_id == "acme" and d.trace.trace_id == r.trace.trace_id
    rows = de.metrics.tenant_report()["tenants"]
    assert set(rows) == {"acme"} and rows["acme"]["tokens_out"] == 4
    pe.close()
    de.close()


def test_debug_tenants_route(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8)
    _drive(eng, 2)
    h = eng.serve_metrics()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{h.port}/debug/tenants") as resp:
            body = json.loads(resp.read())
        assert resp.status == 200
        assert set(body) == set(ttenant.TENANT_KEYS)
        for entry in body["tenants"].values():
            assert set(entry) == set(ttenant.TENANT_ENTRY_KEYS)
        assert body == json.loads(json.dumps(eng.metrics.tenant_report()))
        assert eng.debug_state()["tenants"]["tenant_count"] == 4
    finally:
        eng.close()
