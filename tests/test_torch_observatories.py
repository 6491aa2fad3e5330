"""paddle_tpu_torch's serving engine with every observatory on, against
the JAX engine on the CPU, at the small config of
tests/test_torch_resilience.py: the greedy streams equal the reference's
token for token; ``snapshot()`` and each ``/debug/*`` route carry the
reference's sections and key sets; the counts agree (tokens per tenant,
SLO attainment and violations, flight-recorder entries, requests per
program); the ``ServingConfig`` knobs validate as the reference's do;
and an incident bundle carries its ``requests``, ``traces`` and
``tenants`` sections.

Streams and counts compare exactly; wall-clock seconds are never
compared, only key sets and the containment of one measured interval
in another.
"""
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.observability.health import INCIDENT_KEYS
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

# SLO targets every request meets whatever the host's speed, so the
# verdicts are deterministic (test_torch_tenant.py holds the
# every-request-violates case)
ALL_ON = dict(perf=True, cache_observatory=True, trace_spans=True,
              slo_ttft_ms=1e6, slo_tpot_ms=1e6, health=True)
TENANTS = ("acme", "zeta", "ortho")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


def _prompts(n=9, seed=0):
    rs = np.random.RandomState(seed)
    stem = rs.randint(0, 97, (16,)).astype(np.int64)
    return [np.concatenate([stem, rs.randint(0, 97, (int(k),))])
            if i % 3 == 0 else rs.randint(0, 97, (int(k) + 3,))
            for i, k in enumerate(rs.randint(2, 14, n))]


def _serve(eng, prompts, max_new=6):
    reqs = [eng.add_request(p.astype(np.int64), max_new,
                            tenant_id=TENANTS[i % 3])
            for i, p in enumerate(prompts)]
    eng.run()
    return reqs


@pytest.fixture(scope="module")
def served(models):
    """Both engines, every observatory on, over the same traffic, with
    their metrics servers up."""
    jm, tm = models
    out = {}
    for paged in (True, False):
        kw = dict(num_slots=4, bucket_min=8, paged=paged, **ALL_ON)
        ours = ServingEngine(tm, device="cpu", **kw)
        ref = JaxEngine(jm, **kw)
        prompts = _prompts()
        out[paged] = (ours, ref, _serve(ours, prompts), _serve(ref, prompts),
                      ours.serve_metrics(), ref.serve_metrics())
    yield out
    for ours, ref, *_ in out.values():
        ours.close()
        ref.close()


@pytest.mark.parametrize("paged", [True, False])
def test_streams_equal_the_reference_with_every_observatory_on(served,
                                                               paged):
    ours, ref, a, b, *_ = served[paged]
    assert [r.generated for r in a] == [r.generated for r in b]
    assert all(r.done for r in a)
    if paged:
        ours.pool.check_conservation()
        assert ours.pool.live_blocks == 0


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("section", ["perf", "cache", "slo", "tenants",
                                     "trace", "latency_percentiles",
                                     "prefix_cache", "scheduler",
                                     "resilience", "health", "replica"])
def test_snapshot_sections_have_the_references_keys(served, paged,
                                                     section):
    ours, ref = served[paged][:2]
    a, b = ours.metrics.snapshot()[section], ref.metrics.snapshot()[section]
    assert set(a) == set(b)
    if section == "perf":
        assert set(a["spec"]) == set(b["spec"])
        for name, prog in a["programs"].items():
            assert set(prog) == set(b["programs"][name])
    if section == "slo":
        assert set(a["window"]) == set(b["window"])


def test_snapshot_keeps_every_reference_key(served):
    """The port's snapshot is the reference's plus its own ``kv_wire``
    and ``ttft_p50_ms``; speculation now sits under ``perf``."""
    ours, ref = served[True][:2]
    a, b = set(ours.metrics.snapshot()), set(ref.metrics.snapshot())
    assert b <= a
    assert a - b == {"kv_wire", "ttft_p50_ms"}
    assert "spec" not in a


ROUTES = ["/debug/requests", "/debug/traces", "/debug/perf",
          "/debug/cache", "/debug/tenants", "/debug/state",
          "/debug/health", "/debug/ledger", "/metrics.json", "/debug"]


def _get(handle, route):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{handle.port}{route}", timeout=10) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("route", ROUTES)
def test_debug_routes_answer_with_the_references_keys(served, paged, route):
    ours, ref, _, _, h_ours, h_ref = served[paged]
    (sa, a), (sb, b) = _get(h_ours, route), _get(h_ref, route)
    assert sa == sb == 200
    if route == "/metrics.json":
        # every family the reference exposes, under its name (the
        # build-info gauge carries each package's name)
        missing = set(b) - set(a)
        assert missing == {"paddle_tpu_build_info"}, missing
    elif route == "/debug/state":
        assert set(a) == set(b)
        assert a["decode_layout"] == \
            ("paged_xla" if paged else "contiguous")
    elif route == "/debug":
        assert set(a["routes"]) >= set(ROUTES) - {"/debug"}
    else:
        assert set(a) == set(b)


@pytest.mark.parametrize("paged", [True, False])
def test_counts_agree_with_the_reference(served, paged):
    """Tokens per tenant, SLO attainment and violations, flight entries
    and dispatches per program are the reference's; the per-tenant
    sums are the engine's totals; attainment plus violating requests
    is the completed count."""
    ours, ref, a, _, *_ = served[paged]
    sa, sb = ours.metrics.snapshot(), ref.metrics.snapshot()
    tok = {t: e["tokens_out"] for t, e in sa["tenants"]["tenants"].items()}
    assert tok == {t: e["tokens_out"]
                   for t, e in sb["tenants"]["tenants"].items()}
    assert sum(tok.values()) == sa["tokens_generated"] == \
        sum(len(r.generated) for r in a)
    violating = sum(1 for r in a if ours.request_trace(r.rid).events[-1]
                    .get("slo_violations"))
    assert sa["slo"]["attained"] + violating == sa["requests_completed"]
    assert sa["slo"]["attained"] == len(a)
    for key in ("requests", "attained", "violations", "goodput_tokens"):
        assert sa["slo"][key] == sb["slo"][key]
    assert ours.flight.state() == ref.flight.state()
    assert {k: v["dispatches"] for k, v in sa["perf"]["programs"].items()} \
        == {k: v["dispatches"] for k, v in sb["perf"]["programs"].items()}
    split = ours.metrics.dispatch_sync_split()
    assert split == (ours.metrics.dispatch_s, ours.metrics.sync_s)
    lp = ours.metrics.latency_percentiles()
    assert lp["ttft"]["count"] == lp["request_latency"]["count"] == len(a)


def test_config_knobs_validate_as_the_reference(models):
    _, tm = models
    for bad in (dict(trace_span_keep=0), dict(max_tenants=-1)):
        with pytest.raises(ValueError):
            ServingConfig(**bad)
    cfg = ServingConfig()
    assert (cfg.perf, cfg.cache_observatory, cfg.trace_spans,
            cfg.max_tenants, cfg.trace_keep, cfg.completed_keep,
            cfg.cache_sample_rate, cfg.slo_window_s) == \
        (True, True, True, 32, 256, 4096, 0.125, 60.0)
    off = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                        perf=False, cache_observatory=False,
                        trace_spans=False, health=False)
    off.add_request(np.arange(1, 9), 4)
    off.run()
    snap = off.metrics.snapshot()
    assert (snap["perf"]["enabled"], snap["cache"]["enabled"],
            snap["trace"]["enabled"]) == (False, False, False)
    assert snap["tokens_generated"] == 4
    off.close()


def test_incident_bundle_carries_requests_traces_and_tenants(models,
                                                             tmp_path):
    """A forced queue stall with a request mid-decode: the bundle's
    ``requests`` holds the flight recorder's traces (the queued one
    tagged with its tenant), ``traces`` the assembled trace of every
    request in flight that has spans, ``tenants`` the top tenants."""
    _, tm = models
    inc = str(tmp_path / "inc")
    eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                        supervisor=False, incident_dir=inc,
                        health_detectors={"queue_stall": {"stall_steps": 3}})
    busy = eng.add_request(np.arange(1, 9), 4, tenant_id="busy")
    eng.run()
    mid = eng.add_request(np.arange(2, 12), 40, tenant_id="mid")
    for _ in range(3):
        eng.step()
    traces = eng.health._context["traces"]()
    assert [t["trace_id"] for t in traces] == [mid.trace.trace_id]
    queued = eng.add_request(np.arange(3, 9), 2, tenant_id="late")
    eng.scheduler.admit_paged = lambda *a, **k: None
    eng.close()                      # aborts mid: no tokens from here
    eng2 = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                         supervisor=False, incident_dir=inc,
                         health_detectors={"queue_stall":
                                           {"stall_steps": 3}})
    eng2.add_request(np.arange(3, 9), 2, tenant_id="late")
    eng2.scheduler.admit_paged = lambda *a, **k: None
    for _ in range(4):
        eng2.step()
    files = [f for f in os.listdir(inc) if f.startswith("incident_")]
    assert len(files) == 1
    bundle = json.load(open(os.path.join(inc, files[0])))
    assert set(bundle) == set(INCIDENT_KEYS)
    for key in ("requests", "traces", "tenants"):
        assert bundle[key] is not None, key
    (active,) = bundle["requests"]["active"]
    assert active["tenant_id"] == "late"
    assert bundle["traces"] == []    # queued: no span recorded yet
    assert bundle["tenants"] == eng2.metrics.tenants.top()
    assert busy.done and queued.done
    eng2.close()
