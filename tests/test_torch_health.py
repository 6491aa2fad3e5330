"""paddle_tpu_torch's health observatory against the JAX reference on
the CPU: the step ledger, every detector on the same synthetic rows
(the same verdicts at the same row index), the monitor and incident
bundles (debounce and rotation), the engine's ledger rows and a forced
queue stall end to end on both engines (the same verdict at the same
step), clean runs that fire nothing, and the compile watchdog, which in
the port records no compile (a documented divergence)."""
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.observability import health as jhealth
from paddle_tpu.observability.registry import MetricsRegistry as JaxRegistry
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.resilience import FaultPlan as JaxPlan

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.observability import (
    HostSpanRecorder, MetricsRegistry, StepLedger, build_detectors,
    detector_names, disabled_health_summary)
from paddle_tpu_torch.observability.health import (
    INCIDENT_KEYS, INCIDENT_SCHEMA, LEDGER_ROW_KEYS, HealthMonitor,
    IncidentRecorder)
from paddle_tpu_torch.observability.watchdog import (
    CompileAfterWarmupError, CompileWatchdog)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.resilience import FaultPlan


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


def _row(step, **kw):
    """One fully populated ledger row with healthy defaults."""
    base = {
        "step": int(step), "t": float(step), "wall_s": 0.01,
        "dispatch_s": 0.004, "sync_s": 0.003, "queue_depth": 0,
        "queue_age_s": 0.0, "occupied_slots": 2, "chunked_inflight": 0,
        "admitted": 0, "tokens": 2, "completed": 0,
        "goodput_tokens": 0, "prefill_tokens": 0, "prefill_chunks": 0,
        "shed": 0, "deprioritized": 0, "new_compiles": 0,
        "steady_compiles": 0, "slo_on": False, "prefix_hit_rate": None,
        "pool_free_blocks": None, "pool_evictable_blocks": None,
        "pool_live_blocks": None, "conservation_ok": None,
        "conservation_error": None, "cache_thrash": None,
        "pool_evictable_delta": None,
    }
    assert set(base) == set(LEDGER_ROW_KEYS)
    base.update(kw)
    return base


def _fired(detector, rows, ledger_cls):
    """(row index, verdict) of every firing over a scratch ledger."""
    ledger = ledger_cls(keep=len(rows) + 1)
    out = []
    for i, r in enumerate(rows):
        ledger.append(r)
        v = detector.observe(r, ledger)
        if v:
            out.append((i, v))
    return out


def _rows_spike():
    rs = np.random.RandomState(0)
    rows = [_row(i + 1, wall_s=0.008 + rs.rand() * 0.004)
            for i in range(30)]
    rows.append(_row(31, wall_s=0.5))
    rows += [_row(32 + i, wall_s=2.0, new_compiles=1) for i in range(2)]
    return rows


def _rows_stall():
    rows = [_row(i + 1, queue_depth=3, tokens=0, occupied_slots=0,
                 queue_age_s=1.0 + i) for i in range(12)]
    rows += [_row(13, queue_depth=3, tokens=1)]
    rows += [_row(14 + i, queue_depth=2, tokens=0) for i in range(40)]
    return rows


def _rows_goodput():
    rates = [5] * 48 + [0] * 20
    for w in range(12):
        rates.extend([max(0, 5 - w // 2)] * 16)
    return [_row(i + 1, slo_on=True, goodput_tokens=g, completed=1,
                 queue_depth=4) for i, g in enumerate(rates)]


def _rows_leak():
    return [_row(1, conservation_ok=True),
            _row(2, conservation_ok=False,
                 conservation_error="refcount underflow"),
            _row(3, occupied_slots=1, pool_live_blocks=6,
                 pool_free_blocks=2, pool_evictable_blocks=1),
            _row(4, occupied_slots=0, tokens=0, pool_live_blocks=3,
                 pool_free_blocks=2, pool_evictable_blocks=1),
            _row(5, occupied_slots=0, tokens=0, pool_live_blocks=3,
                 pool_free_blocks=2, pool_evictable_blocks=1),
            _row(6, occupied_slots=0, tokens=0, pool_live_blocks=0,
                 pool_free_blocks=8, pool_evictable_blocks=2),
            _row(7, occupied_slots=0, tokens=0, pool_live_blocks=2,
                 pool_free_blocks=6, pool_evictable_blocks=2)]


def _rows_thrash():
    rows = [_row(i + 1, cache_thrash=3) for i in range(70)]
    rows += [_row(71 + i, cache_thrash=0) for i in range(70)]
    rows += [_row(141 + i, cache_thrash=(1 if i % 4 == 0 else 0))
             for i in range(30)]
    return rows


def _rows_compile():
    return [_row(1, new_compiles=3, steady_compiles=0),
            _row(2, new_compiles=1, steady_compiles=1),
            _row(3), _row(4, new_compiles=2, steady_compiles=2)]


ROWS = {
    "step_time_spike": (_rows_spike, {"window": 32, "min_steps": 8,
                                      "min_wall_s": 0.05}),
    "queue_stall": (_rows_stall, {"stall_steps": 5}),
    "goodput_collapse": (_rows_goodput, {"window": 16, "drop_frac": 0.1,
                                         "healthy_frac": 0.5,
                                         "min_completions": 2}),
    "kv_block_leak": (_rows_leak, {}),
    "cache_thrash": (_rows_thrash, {"window": 8, "min_thrash": 12}),
    "steady_state_compile": (_rows_compile, {}),
}


def test_ledger_ring_equals_reference():
    a, b = StepLedger(keep=4), jhealth.StepLedger(keep=4)
    assert a.last_step_id == b.last_step_id == 0 and a.last() is None
    for i in range(7):
        a.append(_row(i + 1))
        b.append(_row(i + 1))
    assert a.steps == b.steps == 7 and len(a) == len(b) == 4
    assert a.as_dict() == b.as_dict()
    assert a.rows(last=2) == b.rows(last=2) and a.last() == b.last()
    assert LEDGER_ROW_KEYS == jhealth.LEDGER_ROW_KEYS
    with pytest.raises(ValueError):
        StepLedger(keep=0)


def test_detector_registry_matches_reference():
    assert detector_names() == jhealth.detector_names()
    assert set(ROWS) == set(detector_names())
    assert [d.name for d in build_detectors()] == \
        [d.name for d in jhealth.build_detectors()]
    with pytest.raises(ValueError):
        build_detectors(only=["no_such_detector"])


@pytest.mark.parametrize("name", sorted(ROWS))
def test_detector_fires_at_the_reference_rows(name):
    rows_fn, kw = ROWS[name]
    ours = build_detectors({name: kw}, only=[name])[0]
    ref = jhealth.build_detectors({name: kw}, only=[name])[0]
    got = _fired(ours, rows_fn(), StepLedger)
    want = _fired(ref, rows_fn(), jhealth.StepLedger)
    assert got == want
    assert got, f"{name} never fired on its rows"


def test_monitor_report_and_marker_spans_match_reference():
    """The same rows through both monitors: the same firings, reports
    and summaries, a marker span per firing, and a broken detector
    counted, never fatal."""
    class Broken:
        name = "broken_test"

        def observe(self, row, ledger):
            raise RuntimeError("buggy detector")

    def build(mod_build, mon_cls, reg):
        dets = mod_build({"queue_stall": {"stall_steps": 2}},
                         only=["queue_stall", "kv_block_leak"])
        return mon_cls(reg, detectors=dets + [Broken()],
                       recorder=HostSpanRecorder(capacity=64))

    ours = build(build_detectors, HealthMonitor, MetricsRegistry())
    ref = build(jhealth.build_detectors, jhealth.HealthMonitor,
                JaxRegistry())
    for i in range(5):
        row = _row(i + 1, queue_depth=1, tokens=0)
        assert ours.observe(row) == ref.observe(row)
    assert ours.report() == ref.report()
    assert ours.summary() == ref.summary()
    assert not ours.healthy and ours.anomalies_total == 1
    assert [s.name for s in ours._recorder.spans()] == \
        ["health/queue_stall"]
    ours.resolve()
    assert ours.healthy
    assert disabled_health_summary() == jhealth.disabled_health_summary()


def test_incident_recorder_debounce_and_rotation(tmp_path):
    clock = {"t": 100.0}
    rec = IncidentRecorder(str(tmp_path), keep_last=3, debounce_s=30.0,
                           clock=lambda: clock["t"])
    led = StepLedger(keep=8)
    for i in range(5):
        led.append(_row(i + 1))
    ctx = {"metrics": lambda: {"ok": 1},
           "spans_tail": lambda: (_ for _ in ()).throw(
               RuntimeError("span source died"))}
    assert rec.should_capture("queue_stall")
    p1 = rec.capture("queue_stall", {"detector": "queue_stall",
                                     "step": 5, "reason": "r"}, led, ctx)
    assert os.path.exists(p1) and rec.written == 1
    assert not rec.should_capture("queue_stall")
    assert rec.should_capture("step_time_spike")
    clock["t"] += 31.0
    assert rec.should_capture("queue_stall")
    bundle = json.load(open(p1))
    assert set(bundle) == set(INCIDENT_KEYS) == set(jhealth.INCIDENT_KEYS)
    assert bundle["schema"] == INCIDENT_SCHEMA == jhealth.INCIDENT_SCHEMA
    assert len(bundle["ledger_tail"]) == 5
    assert "RuntimeError" in bundle["spans_tail"]["error"]
    for i in range(5):
        clock["t"] += 31.0
        rec.capture("queue_stall", {"step": i, "reason": "r"}, led, ctx)
    files = [f for f in os.listdir(tmp_path) if f.startswith("incident_")]
    assert len(files) == 3
    assert rec.list_incidents() == sorted(
        os.path.join(str(tmp_path), f) for f in files)


# ---------------------------------------------------- engine integration

def _stall(eng):
    """Admission that never admits: the queue never drains."""
    if eng.paged:
        eng.scheduler.admit_paged = lambda *a, **k: None
    else:
        eng.scheduler.admit_chunked = lambda *a, **k: ([], [])


@pytest.mark.parametrize("paged", [False, True])
def test_forced_queue_stall_same_verdict_as_reference(models, paged,
                                                      tmp_path):
    """An induced stall on both engines: queue_stall fires at the same
    step with the same verdict; /metrics counts it, /debug/health names
    it, /debug/ledger serves the rows, and the port's incident bundle
    lands with the reference's schema."""
    jm, tm = models
    prompt = np.arange(5, dtype=np.int64) % 97
    kw = dict(num_slots=2, bucket_min=8, paged=paged, supervisor=False,
              health_detectors={"queue_stall": {"stall_steps": 4}})
    inc_dir = str(tmp_path / "incidents")
    eng = ServingEngine(tm, device="cpu", incident_dir=inc_dir, **kw)
    ref = JaxEngine(jm, **kw)
    verdicts = []
    for e in (eng, ref):
        e.add_request(prompt, max_new_tokens=3)
        _stall(e)
        for _ in range(8):
            e.step()
        (v,) = [st["last_verdict"]
                for st in e.health.report()["detectors"].values()
                if st["fired"]]
        verdicts.append({k: x for k, x in v.items() if k != "queue_age_s"})
    assert verdicts[0] == verdicts[1]
    assert verdicts[0]["step"] == 4 and verdicts[0]["steps_stalled"] == 4
    text = eng.metrics.prometheus_text()
    assert 'serving_anomalies_total{detector="queue_stall"} 1' in text
    handle = eng.serve_metrics()
    try:
        base = f"http://127.0.0.1:{handle.port}"
        health = json.loads(urllib.request.urlopen(
            base + "/debug/health", timeout=10).read())
        assert health["healthy"] is False
        assert health["detectors"]["queue_stall"]["fired"] == 1
        assert set(health) == set(ref.health.report())
        led = json.loads(urllib.request.urlopen(
            base + "/debug/ledger", timeout=10).read())
        assert led["steps"] == 8 and len(led["rows"]) == 8
        for row in led["rows"]:
            assert set(row) == set(LEDGER_ROW_KEYS)
            assert row["queue_depth"] == 1 and row["tokens"] == 0
        state = json.loads(urllib.request.urlopen(
            base + "/debug/state", timeout=10).read())
        assert state["queue_depth"] == 1
    finally:
        eng.close()
    assert handle.closed
    files = [f for f in os.listdir(inc_dir) if f.startswith("incident_")]
    assert len(files) == 1 and "queue_stall" in files[0]
    bundle = json.load(open(os.path.join(inc_dir, files[0])))
    assert set(bundle) == set(INCIDENT_KEYS)
    assert bundle["verdict"]["steps_stalled"] == 4
    assert bundle["health"]["healthy"] is False
    assert bundle["replica"]["replica_id"] == eng.replica_id


def test_engine_ledger_rows_track_the_reference(models):
    """A clean paged run: the port's per-step rows carry the reference's
    counts (tokens, admissions, completions, prefill tokens, block
    economy) step for step."""
    jm, tm = models
    rs = np.random.RandomState(11)
    traffic = [(rs.randint(0, 97, (n,)).astype(np.int64), k)
               for n, k in [(5, 4), (19, 3), (9, 5), (12, 2)]]
    kw = dict(num_slots=2, bucket_min=8, paged=True, block_size=8,
              health_audit_every=2)
    rows = []
    for e in (ServingEngine(tm, device="cpu", **kw), JaxEngine(jm, **kw)):
        for p, k in traffic:
            e.add_request(p, max_new_tokens=k)
        e.run()
        rows.append(e.health.ledger.rows())
    keys = ("step", "queue_depth", "occupied_slots", "admitted", "tokens",
            "completed", "prefill_tokens", "pool_free_blocks",
            "pool_evictable_blocks", "pool_live_blocks", "conservation_ok",
            "cache_thrash", "pool_evictable_delta")
    assert [{k: r[k] for k in keys} for r in rows[0]] == \
        [{k: r[k] for k in keys} for r in rows[1]]


def test_engine_clean_runs_fire_nothing(models):
    _, tm = models
    rs = np.random.RandomState(11)
    for kw in ({"paged": False}, {"paged": True, "block_size": 8,
                                  "health_audit_every": 1},
               {"paged": False, "prefill_chunk": 8,
                "slo_ttft_ms": 5000.0}):
        eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                            **kw)
        for _ in range(2):
            for n, k in [(5, 4), (19, 3), (9, 5)]:
                eng.add_request(rs.randint(0, 97, (n,)).astype(np.int64),
                                max_new_tokens=k)
            eng.run()
        health = eng.metrics.snapshot()["health"]
        assert health["anomalies_total"] == 0, (kw, health)
        assert health["healthy"] is True
        assert health["ledger_steps"] > 0


def test_watchdog_records_no_compile(models):
    """The documented divergence. The reference's watchdog records its
    engine's compiles, and a compile_storm fire after declare_warmup()
    rebuilds a program — a steady-state compile that the detector turns
    into an anomaly. The port compiles nothing per shape: for the same
    plan its compile_storm draws and fires line up with the reference's
    (the fault logs are equal), but nothing is evicted or recorded, and
    steady_state_compile stays registered and silent."""
    jm, tm = models
    rs = np.random.RandomState(3)
    traffic = [rs.randint(0, 97, (n,)).astype(np.int64) for n in (4, 9, 6)]
    plan = {"compile_storm": 1.0}
    logs, healths = [], []
    for e in (ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                            paged=False,
                            chaos=FaultPlan(seed=1, faults=plan)),
              JaxEngine(jm, num_slots=2, bucket_min=8, paged=False,
                        chaos=JaxPlan(seed=1, faults=plan))):
        for p in traffic[:2]:
            e.add_request(p, max_new_tokens=3)
        e.run()
        e.declare_warmup()
        e.add_request(traffic[2], max_new_tokens=3)
        e.run()
        logs.append(e.chaos.fault_log())
        healths.append(e.metrics.snapshot()["health"]["detectors"])
    assert logs[0] == logs[1] and logs[0]
    assert healths[0]["steady_state_compile"] == 0
    assert healths[1]["steady_state_compile"] >= 1
    port = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8)
    port.add_request(traffic[0], max_new_tokens=3)
    port.run()
    port.declare_warmup()
    rep = port.watchdog.report()
    assert rep["warmed"] is True and rep["compiles_total"] == 0
    assert set(rep) == set(JaxEngine(jm, num_slots=2, bucket_min=8)
                           .watchdog.report())
    assert port.debug_state()["watchdog"]["steady_state_compiles"] == 0
    wd = CompileWatchdog(mode="raise")
    wd.record(("prefill", 8, 1))
    wd.declare_warmup_complete()
    with pytest.raises(CompileAfterWarmupError):
        wd.record(("prefill", 16, 1))
    assert wd.report()["steady_state_compiles"] == 1
