"""paddle_tpu_torch's fleet telemetry against the JAX reference on the
CPU (tests/test_fleet.py's scenarios): the poller's verdicts,
staleness, backoff and eviction under an injected ``fetch`` and clock,
the rollup's sums and merged percentiles, the five fleet detectors on
the same rows, the FleetServer's routes, and the wire between the
packages: the reference's FleetPoller scrapes a port replica served on
127.0.0.1 with the port poller's verdicts and rollup keys, and
tools/tenant_report.py and tools/cache_report.py give the same exit
code against it as against a JAX replica serving the same requests.

Every comparison is exact (the modules are stdlib and deterministic
under the injected clock) except the fields measured on the wall clock
(``scrape_ms``, ``t``, latency percentiles of live engines), which are
dropped before comparing. No test sleeps to wait for a window.
"""
import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.observability import fleet as jfleet
from paddle_tpu.observability.fleet import detectors as jdet
from paddle_tpu.serving import ServingEngine as JaxEngine

from _torch_port import jax_gpt, torch_twin
from test_fleet import _FakeReplica, _fake_fetch, _fleet_row
from paddle_tpu_torch.observability import fleet as tfleet
from paddle_tpu_torch.observability.fleet import detectors as tdet
from paddle_tpu_torch.observability.fleet.identity import (
    backoff_jitter_unit)
from paddle_tpu_torch.observability.health.detectors import detector_names
from paddle_tpu_torch.serving import EngineGateway, ServingEngine

REPO = Path(__file__).resolve().parents[1]
VOLATILE = ("scrape_ms", "t", "age_s")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _strip(obj):
    """Drop the wall-clock fields, recursively."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _pollers(replicas, clock, **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("timeout_s", 0.5)
    targets = [{"id": r.rid, "url": r.url} for r in replicas]
    return [mod.FleetPoller(targets, fetch=_fake_fetch(replicas),
                            clock=lambda: clock["t"], **kw)
            for mod in (tfleet, jfleet)]


def _fired(v):
    return [f["detector"] for f in v]


# ------------------------------------------------- poller lifecycle

SCENARIOS = {
    # (replica kwargs, [(t, {rid: alive}, {rid: {attr: value}})])
    "steady": ([dict(rid="ra", queue=2), dict(rid="rb", queue=1)],
               [(t, {}, {"ra": {"steps": 10 + 10 * t}})
                for t in range(5)]),
    "kill_and_readmit": ([dict(rid="ra"), dict(rid="rb")],
                         [(0, {}, {}), (1, {"ra": False}, {}),
                          (1.5, {}, {}), (2.5, {}, {}), (3.5, {}, {}),
                          (6, {"ra": True}, {}), (7, {}, {})]),
    "unhealthy_and_skewed": ([dict(rid="ra", queue=30),
                              dict(rid="rb", queue=1, healthy=False),
                              dict(rid="rc", queue=1)],
                             [(t, {}, {}) for t in range(4)]),
    "goodput_cliff": ([dict(rid="ra", goodput=0.0, queue=3),
                       dict(rid="rb", goodput=0.0, queue=3)],
                      [(t, {}, {"ra": {"goodput": 100.0 * min(t, 4)},
                                "rb": {"goodput": 100.0 * min(t, 4)}})
                       for t in range(1, 10)]),
    "all_down": ([dict(rid="ra")],
                 [(0, {"ra": False}, {}), (3, {}, {}), (9, {}, {}),
                  (20, {"ra": True}, {})]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_poller_verdicts_and_snapshots_match_reference(name):
    """The same replicas under the same injected clock: every cycle's
    firings, every replica's verdict and bookkeeping, and the fleet
    snapshot equal the reference poller's."""
    specs, script = SCENARIOS[name]
    reps = [_FakeReplica(**s) for s in specs]
    clock = {"t": 0.0}
    ours, ref = _pollers(reps, clock, down_after=2, backoff_base_s=1.0,
                         stale_after_s=1.0, backoff_jitter=0.25,
                         jitter_seed=3)
    for t, alive, attrs in script:
        clock["t"] = float(t)
        for r in reps:
            r.alive = alive.get(r.rid, r.alive)
            for k, v in attrs.get(r.rid, {}).items():
                setattr(r, k, v)
        assert _fired(ours.poll_once()) == _fired(ref.poll_once())
        for a, b in zip(ours.replicas, ref.replicas):
            assert (a.verdict, a.consecutive_failures, a.evictions,
                    a.readmissions, a.backoff_until) == \
                (b.verdict, b.consecutive_failures, b.evictions,
                 b.readmissions, b.backoff_until)
    assert _strip(ours.snapshot()) == _strip(ref.snapshot())
    assert _strip(ours.fleet_health()) == _strip(ref.fleet_health())
    assert _strip(ours.fleet_tenants()) == _strip(ref.fleet_tenants())
    assert ours.prometheus_text() == ref.prometheus_text()
    assert _strip(ours.ledger.last()) == _strip(ref.ledger.last())


def test_eviction_backoff_staleness_readmission():
    """The reference test's lifecycle, step by step, on the port."""
    reps = [_FakeReplica("ra")]
    clock = {"t": 0.0}
    poller = _pollers(reps, clock, down_after=2, backoff_base_s=1.0,
                      stale_after_s=1.0, backoff_jitter=0.0)[0]
    poller.poll_once()
    st = poller.replicas[0]
    assert st.verdict == "up"
    reps[0].alive = False
    clock["t"] = 1.0
    poller.poll_once()
    assert st.verdict == "up" and st.consecutive_failures == 1
    assert st.backoff_until == pytest.approx(2.0)
    clock["t"] = 1.5
    poller.poll_once()
    assert st.verdict == "stale"
    clock["t"] = 2.5
    assert _fired(poller.poll_once()) == ["replica_flap"]
    assert st.verdict == "down" and st.evictions == 1
    reps[0].alive = True
    clock["t"] = 5.0
    assert _fired(poller.poll_once()) == ["replica_flap"]
    assert st.verdict == "up" and st.readmissions == 1
    fam = poller.registry.get("fleet_anomalies_total")
    assert fam.labels("replica_flap").value == 2


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_backoff_jitter_is_the_references(seed):
    """One copy of the jitter function, the reference poller's values;
    the poller uses it."""
    from paddle_tpu.observability.fleet.poller import (
        backoff_jitter_unit as ref_unit)
    for who in ("ra", "http://x:1"):
        for attempt in range(1, 6):
            assert backoff_jitter_unit(seed, who, attempt) == \
                ref_unit(seed, who, attempt)
    from paddle_tpu_torch.observability.fleet import poller
    assert poller.backoff_jitter_unit is backoff_jitter_unit


def test_registry_file_targets(tmp_path):
    reg = tmp_path / "fleet.json"
    reg.write_text(json.dumps({"replicas": [
        {"id": "ra", "url": "http://ra"}, "rb:80"]}))

    def dead(url, t):
        raise ConnectionError("down")
    ours = tfleet.FleetPoller.from_registry(str(reg), fetch=dead)
    ref = jfleet.FleetPoller.from_registry(str(reg), fetch=dead)
    assert [(s.url, s.replica_id) for s in ours.replicas] == \
        [(s.url, s.replica_id) for s in ref.replicas]


# ------------------------------------------------------------- rollup

def _cache(accesses, hits, seed):
    rs = np.random.RandomState(seed)
    return {"accesses": accesses, "hits": hits,
            "saved_tokens": 10 * hits, "saved_ms": 0.5 * hits,
            "thrash": int(rs.randint(0, 5)), "sampled_accesses": accesses,
            "mrc": [{"blocks": 8 * f, "est_hit_rate": float(rs.rand()),
                     "factor": float(f)} for f in (1, 2, 4)],
            "heat_top": [{"fp": f"{rs.randint(0, 4):08x}", "depth": 1,
                          "hits": int(rs.randint(1, 9)),
                          "last_tick": int(rs.randint(0, 20)),
                          "tokens_saved": 16 * int(rs.randint(1, 9))}
                         for _ in range(3)]}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rollup_sums_and_merged_percentiles_match(seed):
    """``fleet_aggregate``, ``fleet_cache``, ``fleet_tenants`` and
    ``merged_latency`` over the same scrape bodies: the port's equal
    the reference's, and the counters are the exact sums."""
    rs = np.random.RandomState(seed)
    reps = []
    for i in range(3):
        r = _FakeReplica(f"r{i}", tokens=float(rs.randint(1, 500)),
                         goodput=float(rs.randint(0, 100)),
                         completed=int(rs.randint(1, 30)),
                         queue=int(rs.randint(0, 5)),
                         cache=_cache(int(rs.randint(10, 200)),
                                      int(rs.randint(0, 10)), seed + i))
        reps.append(r)
    snaps = [r.metrics() for r in reps]
    states = [r.state() for r in reps]
    for name in ("fleet_cache", "fleet_tenants", "merged_latency"):
        args = (snaps, states) if name != "merged_latency" else (snaps,)
        assert getattr(tfleet, name)(*args) == getattr(jfleet, name)(*args)
    clock = {"t": 0.0}
    ours, ref = _pollers(reps, clock)
    ours.poll_once()
    ref.poll_once()
    agg = ours.snapshot()["fleet"]
    assert _strip(agg) == _strip(ref.snapshot()["fleet"])
    assert agg["tokens_generated"] == sum(r.tokens for r in reps)
    assert agg["requests_completed"] == sum(r.completed for r in reps)
    assert agg["latency"]["ttft"]["count"] == sum(r.completed
                                                  for r in reps)


def test_schema_keys_are_the_references():
    for name in ("FLEET_SNAPSHOT_KEYS", "FLEET_REPLICA_KEYS",
                 "FLEET_AGG_KEYS", "FLEET_ROW_KEYS",
                 "FLEET_TENANT_ROW_KEYS", "FLEET_TENANT_ENTRY_KEYS",
                 "FLEET_SCHEMA"):
        assert getattr(tfleet, name) == getattr(jfleet, name), name


def test_build_info_of_either_package_gives_the_version():
    from paddle_tpu_torch.observability.fleet.rollup import (
        build_info_labels)
    for fam, lib in (("paddle_tpu_torch_build_info", "torch_version"),
                     ("paddle_tpu_build_info", "jax_version")):
        snap = {fam: {"type": "gauge", "help": "", "values": {
            f"replica=r,version=1.2,{lib}=9": 1}}}
        assert build_info_labels(snap)["version"] == "1.2"


# ---------------------------------------------------------- detectors

def test_fleet_detectors_registered_at_fleet_scope():
    assert detector_names(scope="fleet") == [
        "fleet_goodput_collapse", "load_skew", "noisy_neighbor",
        "replica_flap", "tenant_starvation"]
    assert "replica_flap" not in detector_names()


def _tenant_rows(rs, n, noisy):
    rows = []
    for i in range(1, n + 1):
        tenants = {}
        for t in ("big", "small", "mid"):
            heavy = noisy and t == "big"
            starved = noisy and t == "small" and i > 4
            tenants[t] = {
                "tokens_delta": float(rs.randint(500, 900) if heavy
                                      else rs.randint(5, 60)),
                "requests_delta": 0.0 if starved
                else float(rs.randint(1, 5)),
                "completed_delta": float(rs.randint(0, 4)),
                "attained_delta": float(rs.randint(0, 2)),
                "violated_delta": float(rs.randint(0, 4)
                                        if noisy and t != "big" else 0),
                "queued": int(rs.randint(1, 6) if t == "small" else 0)}
        rows.append(_fleet_row(i, tenants=tenants, work_pending=True))
    return rows


def _detector_rows(name, seed):
    rs = np.random.RandomState(seed)
    if name == "replica_flap":
        moves = [("up", "down"), ("down", "up"), ("up", "stale"),
                 ("init", "up")]
        return [_fleet_row(i, transitions=[
            {"replica": f"r{rs.randint(0, 3)}",
             "from": moves[rs.randint(0, 4)][0],
             "to": moves[rs.randint(0, 4)][1]}] if rs.rand() < 0.6 else [])
            for i in range(1, 20)]
    if name == "fleet_goodput_collapse":
        deltas = [100.0] * 6 + [float(rs.randint(0, 3))] * 6 \
            + [float(rs.randint(50, 120)) for _ in range(6)]
        return [_fleet_row(i + 1, goodput_delta=d, work_pending=True)
                for i, d in enumerate(deltas)]
    if name == "load_skew":
        return [_fleet_row(i, queue_depths={
            "a": int(rs.randint(0, 40)), "b": int(rs.randint(0, 4)),
            "c": int(rs.randint(0, 4))}) for i in range(1, 25)]
    return _tenant_rows(rs, 16, noisy=seed % 2 == 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["replica_flap", "fleet_goodput_collapse",
                                  "load_skew", "noisy_neighbor",
                                  "tenant_starvation"])
def test_fleet_detector_fires_as_the_reference(name, seed):
    """Each fleet detector on the same seeded rows: the same firings
    at the same steps with the same verdict bodies."""
    classes = {"replica_flap": "ReplicaFlap",
               "fleet_goodput_collapse": "FleetGoodputCollapse",
               "load_skew": "LoadSkew", "noisy_neighbor": "NoisyNeighbor",
               "tenant_starvation": "TenantStarvation"}
    kw = {"window": 3} if name == "fleet_goodput_collapse" else {}
    ours = getattr(tdet, classes[name])(**kw)
    ref = getattr(jdet, classes[name])(**kw)
    got, want = [], []
    for row in _detector_rows(name, seed):
        got.append(ours.observe(dict(row), None))
        want.append(ref.observe(dict(row), None))
    assert got == want
    if seed % 2 == 0 or name in ("replica_flap", "load_skew"):
        assert any(v is not None for v in got)


# ------------------------------------------------------------- server

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode("utf-8")


def test_fleet_server_routes_match_reference():
    reps = [_FakeReplica("ra", queue=2), _FakeReplica("rb")]
    clock = {"t": 0.0}
    bodies = []
    for poller in _pollers(reps, clock):
        poller.poll_once()
        srv = (tfleet if type(poller).__module__.startswith(
            "paddle_tpu_torch") else jfleet).FleetServer(poller)
        srv.serve(poll=False)
        try:
            got = {}
            for route in ("/fleet/health", "/fleet/state", "/fleet/tenants",
                          "/fleet/metrics"):
                status, body = _get(f"http://127.0.0.1:{srv.port}{route}")
                assert status == 200, route
                got[route] = body if route == "/fleet/metrics" \
                    else _strip(json.loads(body))
            bodies.append(got)
        finally:
            srv.close()
    assert bodies[0] == bodies[1]


# ------------------------------------------------- port replicas, live

KNOBS = dict(num_slots=2, bucket_min=8, paged=True)


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt(seed=7)
    return jm, torch_twin(jm)


def _serve(eng, seed=9):
    rs = np.random.RandomState(seed)
    for n, k, t in ((5, 3, "alice"), (7, 3, "bob"), (6, 2, "alice")):
        eng.add_request(rs.randint(0, 97, (n,)).astype(np.int64), k,
                        tenant_id=t)
    eng.run()


def test_two_port_replicas_rollup_and_kill(models):
    """Two port engines behind their gateways on 127.0.0.1, one poller
    over both: both up, the rollup's sums equal the replicas' own
    counters, the /fleet routes answer; a killed replica goes down
    after ``down_after`` cycles and the flap is counted."""
    engines = [ServingEngine(models[1], device="cpu", replica_id=f"p{i}",
                             **KNOBS) for i in range(2)]
    for i, e in enumerate(engines):
        _serve(e, seed=i)
    gws = [EngineGateway(e) for e in engines]
    clock = {"t": 0.0}
    try:
        urls = [f"127.0.0.1:{gw.serve().port}" for gw in gws]
        poller = tfleet.FleetPoller(urls, interval_s=1.0, timeout_s=5.0,
                                    down_after=2, backoff_jitter=0.0,
                                    clock=lambda: clock["t"])
        assert poller.poll_once() == []
        snap = poller.snapshot()
        assert [r["verdict"] for r in snap["replicas"].values()] == \
            ["up", "up"]
        assert all(r["healthy"] for r in snap["replicas"].values())
        f = snap["fleet"]
        assert f["tokens_generated"] == sum(
            e.metrics.tokens_generated for e in engines)
        assert f["requests_completed"] == sum(
            e.metrics.requests_completed for e in engines)
        assert f["tenants"]["tenants"]["alice"]["tokens_out"] == 10
        srv = tfleet.FleetServer(poller)
        srv.serve(poll=False)
        try:
            for route in ("/fleet/health", "/fleet/state",
                          "/fleet/metrics", "/fleet/tenants"):
                assert _get(f"http://127.0.0.1:{srv.port}{route}")[0] \
                    == 200
        finally:
            srv.close()
        gws[1].kill()
        fired = []
        for k in range(1, 6):
            clock["t"] = 10.0 * k
            fired += _fired(poller.poll_once())
        verdicts = {r["replica_id"]: r["verdict"]
                    for r in poller.snapshot()["replicas"].values()}
        assert verdicts == {"p0": "up", "p1": "down"}
        assert fired == ["replica_flap"]
    finally:
        for gw in gws:
            gw.close()


def _reference_exit_codes(url):
    """tools/tenant_report.py against ``url`` and tools/cache_report.py
    over its /debug/cache body."""
    tenant = subprocess.run(
        [sys.executable, str(REPO / "tools" / "tenant_report.py"), url,
         "--json", "--min-tokens", "1"],
        capture_output=True, text=True, timeout=120)
    body = _get(f"http://{url}/debug/cache")[1]
    cache = subprocess.run(
        [sys.executable, str(REPO / "tools" / "cache_report.py"), "-"],
        input=body, capture_output=True, text=True, timeout=120)
    return tenant.returncode, cache.returncode, tenant.stdout


def test_reference_poller_and_tools_read_a_port_replica(models):
    """The wire is the reference's: its FleetPoller scrapes a port
    replica with the port poller's verdicts and rollup keys, and its
    stdlib report tools exit as they do on a JAX replica serving the
    same requests."""
    jm, tm = models
    port = ServingEngine(tm, device="cpu", replica_id="port", **KNOBS)
    jax_eng = JaxEngine(jm, replica_id="jax", **KNOBS)
    handles = []
    try:
        for e in (port, jax_eng):
            _serve(e)
            handles.append(e.serve_metrics())
        urls = [f"127.0.0.1:{h.port}" for h in handles]
        clock = {"t": 0.0}
        polls = [mod.FleetPoller([urls[0]], timeout_s=5.0,
                                 clock=lambda: clock["t"])
                 for mod in (tfleet, jfleet)]
        for p in polls:
            assert p.poll_once() == []
        ours, ref = (p.snapshot() for p in polls)
        assert set(ours) == set(ref)
        assert set(ours["fleet"]) == set(ref["fleet"])
        for a, b in zip(ours["replicas"].values(),
                        ref["replicas"].values()):
            assert set(a) == set(b)
            for k in ("verdict", "healthy", "tokens_generated",
                      "goodput_tokens", "requests_completed",
                      "cache_hit_rate", "replica_id", "queue_depth"):
                assert a[k] == b[k], k
        assert ours["fleet"]["tenants"] == ref["fleet"]["tenants"]
        codes = [_reference_exit_codes(u)[:2] for u in urls]
        assert codes[0] == codes[1] == (0, 0)
        doc = json.loads(_reference_exit_codes(urls[0])[2])
        assert set(doc["tenants"]) == {"alice", "bob"}
    finally:
        for h in handles:
            h.close()
        port.close()
        jax_eng.close()
