"""paddle_tpu_torch's hardened serving engine against the JAX reference
on the CPU: the seeded fault injector, the engine's chaos seams,
deadlines, bounded retry, quarantine, chunked-prefill rollback, the
poisoned callback, drain and close, and the supervisor's restart on
both pools (tests/test_resilience.py's scenarios).

For one FaultPlan the port's injector fires on the same checks as the
reference's, and an engine under chaos gives the JAX engine's greedy
streams and the same fault log: every seam (prefill/chunk/decode
dispatch, transfer, step latency, block exhaustion, callback) is
crossed as often, in the same order, with the same context. The one
seam whose effect differs by design is ``compile_storm``: the reference
evicts and rebuilds a compiled program there, the port builds nothing
per shape (its draws still line up; see
test_torch_health.py::test_watchdog_records_no_compile).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.resilience import FaultInjector as JaxInjector
from paddle_tpu.serving.resilience import FaultPlan as JaxPlan

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.resilience import (
    DEFAULT_RATES, FAULT_SITES, FaultInjector, FaultPlan, FaultSpec,
    InjectedFault, resolve_chaos)
from paddle_tpu_torch.serving.scheduler import RUNNING

_VOCAB = 97


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


def _prompts(n, lo=3, hi=14, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, _VOCAB, (int(k),)).astype(np.int64)
            for k in rs.randint(lo, hi, n)]


def _port(tm, **kw):
    return ServingEngine(tm, device="cpu", **kw)


def _streams(eng, prompts, max_new, **add_kw):
    reqs = [eng.add_request(p, max_new_tokens=max_new, **add_kw)
            for p in prompts]
    eng.run()
    return reqs, [list(r.generated) for r in reqs]


_REF = {}


def _reference(jm, prompts, max_new, seed_key, **kw):
    """The JAX engine's unfaulted greedy streams (memoised per
    traffic)."""
    key = (seed_key, max_new, tuple(sorted(kw.items())))
    if key not in _REF:
        eng = JaxEngine(jm, num_slots=4, bucket_min=8, **kw)
        _REF[key] = _streams(eng, prompts, max_new)[1]
    return _REF[key]


def _conserved(eng, slots):
    assert eng.pool.free_count + len(eng.pool.quarantined) == slots
    if eng.paged:
        eng.pool.check_conservation()
        assert eng.pool.live_blocks == 0


# ------------------------------------------------------- fault harness

def test_injector_fire_log_equals_reference():
    """The same plan and call sequence give the same fire decisions and
    the same fault log in both packages, at random rates and at exact
    ``after``/``max_fires`` schedules."""
    plans = [
        dict(seed=9, faults={"transfer": 0.3, "callback": 0.5}),
        dict(seed=1, faults={"decode_dispatch": {
            "rate": 1.0, "after": 2, "max_fires": 1}}),
        dict(seed=4, faults=None),
    ]
    sites = ["transfer", "callback", "decode_dispatch", "prefill_dispatch",
             "block_exhaustion", "step_latency", "chunk_dispatch",
             "compile_storm", "router_dispatch"]
    for kw in plans:
        a = FaultInjector(FaultPlan(**kw))
        b = JaxInjector(JaxPlan(**kw))
        da = [a.fires(sites[i % len(sites)], step=i) for i in range(400)]
        db = [b.fires(sites[i % len(sites)], step=i) for i in range(400)]
        assert da == db
        assert a.fault_log() == b.fault_log()
        assert a.report() == b.report()
        assert FaultPlan(**kw).as_dict() == JaxPlan(**kw).as_dict()
    assert FAULT_SITES == tuple(JaxPlan(seed=0).faults) \
        and DEFAULT_RATES["compile_storm"] == 0.0
    c = FaultInjector(FaultPlan(seed=1, faults={
        "decode_dispatch": {"rate": 1.0, "after": 2, "max_fires": 1}}))
    assert [c.fires("decode_dispatch") for _ in range(6)] == \
        [False, False, True, False, False, False]
    with pytest.raises(InjectedFault) as ei:
        FaultInjector(FaultPlan(seed=1, faults={"transfer": 1.0})) \
            .maybe_raise("transfer")
    assert ei.value.site == "transfer"


def test_resolve_chaos_forms_and_no_environment_gate(monkeypatch):
    """No PADDLE_CHAOS gate in the port (a documented divergence): None
    is off whatever the environment says; the explicit forms arm."""
    monkeypatch.setenv("PADDLE_CHAOS", "11")
    assert resolve_chaos(None) is None and resolve_chaos(False) is None
    assert resolve_chaos(7).plan.seed == 7
    assert resolve_chaos(FaultPlan(seed=3)).plan.seed == 3
    assert resolve_chaos({"seed": 5, "faults": {"transfer": 0.5}}) \
        .plan.faults["transfer"].rate == 0.5
    inj = FaultInjector(FaultPlan(seed=2))
    assert resolve_chaos(inj) is inj
    with pytest.raises(ValueError):
        resolve_chaos("nonsense")
    with pytest.raises(ValueError):
        FaultPlan(seed=0, faults={"not_a_site": 0.5})
    with pytest.raises(ValueError):
        FaultSpec(rate=1.5)


def test_chaos_off_by_default_and_snapshot_keys(models):
    jm, tm = models
    eng = _port(tm, num_slots=2, bucket_min=8)
    ref = JaxEngine(jm, num_slots=2, bucket_min=8)
    assert eng.chaos is None
    res = eng.metrics.snapshot()["resilience"]
    assert res["chaos"] == {"enabled": False}
    assert res == ref.metrics.snapshot()["resilience"]
    for key in ("resilience", "health", "replica"):
        assert set(eng.metrics.snapshot()[key]) \
            == set(ref.metrics.snapshot()[key]), key


# --------------------------------------------- chaos against the JAX engine

_CHAOS = {"prefill_dispatch": 0.2, "decode_dispatch": 0.1,
          "transfer": 0.1, "callback": 0.3, "block_exhaustion": 0.1,
          "step_latency": {"rate": 0.05, "latency_s": 0.001}}


@pytest.mark.parametrize("paged", [False, True])
def test_chaos_engine_matches_jax_engine(models, paged):
    """The same FaultPlan on the same workload: the port's streams and
    fault log equal the JAX engine's (no seam is crossed a different
    number of times), equal an unfaulted run, and repeat exactly; the
    pool ends conserved."""
    jm, tm = models
    prompts = _prompts(8)

    def run(eng):
        reqs, streams = _streams(eng, prompts, 6, on_token=lambda r, t: None)
        return eng, streams, eng.chaos.fault_log()

    kw = dict(num_slots=4, bucket_min=8, paged=paged,
              max_dispatch_retries=3)
    e1, s1, log1 = run(_port(tm, chaos=FaultPlan(seed=3, faults=_CHAOS),
                             **kw))
    _, s2, log2 = run(_port(tm, chaos=FaultPlan(seed=3, faults=_CHAOS),
                            **kw))
    ej, sj, logj = run(JaxEngine(jm, chaos=JaxPlan(seed=3, faults=_CHAOS),
                                 **kw))
    assert log1 == log2 == logj
    assert len(log1) > 0
    assert s1 == s2 == sj == _reference(jm, prompts, 6, "p8")
    _conserved(e1, 4)
    res, ref = (e.metrics.snapshot()["resilience"] for e in (e1, ej))
    for k in ("dispatch_failures", "dispatch_retries", "callback_errors",
              "faults_injected", "requests_aborted"):
        assert res[k] == ref[k], k
    assert res["chaos"]["plan"]["seed"] == 3 and res["dispatch_retries"] > 0


def test_unhardened_engine_raises_on_injected_fault(models):
    """max_dispatch_retries=0: the injected failure rolls back leak-free
    and propagates, the request back in the queue."""
    _, tm = models
    eng = _port(tm, num_slots=2, bucket_min=8,
                chaos=FaultPlan(seed=0, faults={"prefill_dispatch": 1.0}))
    eng.add_request(_prompts(1)[0], max_new_tokens=3)
    with pytest.raises(InjectedFault):
        eng.run()
    assert eng.pool.free_count == 2
    assert len(eng.scheduler.queue) == 1


# ------------------------------------------------- retry / quarantine

def test_transient_prefill_failure_retries_to_completion(models):
    jm, tm = models
    prompts = _prompts(3, seed=2)
    plan = {"prefill_dispatch": {"rate": 1.0, "max_fires": 2}}
    eng = _port(tm, num_slots=4, bucket_min=8, max_dispatch_retries=3,
                chaos=FaultPlan(seed=0, faults=plan))
    _, streams = _streams(eng, prompts, 5)
    assert streams == _reference(jm, prompts, 5, "p3s2")
    res = eng.metrics.snapshot()["resilience"]
    assert res["dispatch_failures"]["prefill"] == 2
    assert res["dispatch_retries"] >= 2 and res["requests_aborted"] == 0


def test_retry_budget_exhaustion_aborts_request(models):
    jm, tm = models
    prompt = _prompts(1)[0]
    kw = dict(num_slots=2, bucket_min=8, max_dispatch_retries=2)
    eng = _port(tm, chaos=FaultPlan(seed=0, faults={"prefill_dispatch": 1.0}),
                **kw)
    ref = JaxEngine(jm, chaos=JaxPlan(seed=0,
                                      faults={"prefill_dispatch": 1.0}), **kw)
    req = eng.add_request(prompt, max_new_tokens=3)
    rreq = ref.add_request(prompt, max_new_tokens=3)
    eng.run()
    ref.run()
    assert req.done and req.generated == []
    assert req.dispatch_failures == rreq.dispatch_failures == 3
    assert req.stop_reason == "error"
    res = eng.metrics.snapshot()["resilience"]
    assert res["requests_aborted"] == 1
    assert eng.pool.quarantined == ref.pool.quarantined
    assert eng.pool.free_count + len(eng.pool.quarantined) == 2


def test_repeated_same_slot_failures_quarantine_the_slot(models):
    jm, tm = models
    prompts = _prompts(1, seed=4)
    eng = _port(tm, num_slots=2, bucket_min=8, max_dispatch_retries=5,
                quarantine_after=2,
                chaos=FaultPlan(seed=0, faults={
                    "prefill_dispatch": {"rate": 1.0, "max_fires": 3}}))
    (req,), streams = _streams(eng, prompts, 4)
    assert eng.pool.quarantined == [0]
    assert req.slot is None and req.done
    assert streams == _reference(jm, prompts, 4, "p1s4")
    res = eng.metrics.snapshot()["resilience"]
    assert res["quarantined_slots"] == [0]
    assert res["slots_quarantined_total"] == 1
    assert eng.pool.free_count == 1 and eng.pool.occupancy == 0.0


@pytest.mark.parametrize("paged", [False, True])
def test_quarantine_never_takes_the_last_slot(models, paged):
    _, tm = models
    eng = _port(tm, num_slots=1, bucket_min=8, paged=paged,
                max_dispatch_retries=5, quarantine_after=1,
                chaos=FaultPlan(seed=0, faults={
                    "prefill_dispatch": {"rate": 1.0, "max_fires": 2}}))
    (req,), _ = _streams(eng, _prompts(1), 3)
    assert req.done and len(req.generated) == 3
    assert eng.pool.quarantined == []
    _conserved(eng, 1)


# ------------------------------------------- chunk-boundary rollback

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("boundary", [0, 1, 2, 3])
def test_chunked_prefill_rollback_at_every_boundary(models, paged,
                                                    boundary):
    """A dispatch failure at each chunk boundary of a 26-token prompt
    (chunk 8, four chunks) on both pools: the rollback conserves slots
    and blocks, and the retry's stream equals the JAX engine's."""
    jm, tm = models
    prompt = np.random.RandomState(31).randint(0, _VOCAB, (26,)) \
        .astype(np.int64)
    ref = _reference(jm, [prompt], 4, "chunk26", prefill_chunk=8,
                     paged=paged)
    eng = _port(tm, num_slots=2, bucket_min=8, prefill_chunk=8,
                paged=paged, max_dispatch_retries=3,
                chaos=FaultPlan(seed=0, faults={"chunk_dispatch": {
                    "rate": 1.0, "after": boundary, "max_fires": 1}}))
    _, streams = _streams(eng, [prompt], 4)
    assert streams == ref
    assert eng.chaos.fault_log()[0]["chunk"] == boundary
    res = eng.metrics.snapshot()["resilience"]
    assert res["dispatch_failures"]["chunk"] == 1
    assert res["dispatch_retries"] == 1
    assert not eng._chunk_q and not eng._prefilling
    _conserved(eng, 2)


# --------------------------------------------------------- deadlines

def test_queued_request_past_deadline_times_out(models):
    _, tm = models
    eng = _port(tm, num_slots=1, bucket_min=8)
    req = eng.add_request(_prompts(1)[0], max_new_tokens=3,
                          deadline_ms=1.0)
    req.t_arrival -= 0.01          # 10 ms old at the next step
    eng.step()
    assert req.done and req.generated == []
    assert req.stop_reason == "deadline"
    res = eng.metrics.snapshot()["resilience"]
    assert res["requests_timed_out"] == 1


@pytest.mark.parametrize("paged", [False, True])
def test_decoding_request_past_deadline_retires_mid_flight(models, paged):
    _, tm = models
    eng = _port(tm, num_slots=1, bucket_min=8, paged=paged)
    req = eng.add_request(_prompts(1, hi=6)[0], max_new_tokens=50,
                          deadline_ms=60_000.0)
    for _ in range(4):
        eng.step()
    assert req.state == RUNNING and req.generated
    req.t_arrival -= 61.0          # the deadline passes mid-decode
    for _ in range(100):
        if req.done:
            break
        eng.step()
    assert req.done and 0 < len(req.generated) < 50
    assert req.stop_reason == "deadline"
    assert eng.metrics.snapshot()["resilience"]["requests_timed_out"] == 1
    eng.run()
    _conserved(eng, 1)
    # a request without a deadline is untouched by the scan
    r2 = eng.add_request(_prompts(1)[0], max_new_tokens=3)
    eng.run()
    assert r2.done and len(r2.generated) == 3


def test_deadline_validation(models):
    _, tm = models
    eng = _port(tm, num_slots=1, bucket_min=8)
    with pytest.raises(ValueError):
        eng.add_request(_prompts(1)[0], max_new_tokens=2, deadline_ms=0)


# --------------------------------------------------- callback guard

def test_poisoned_on_token_callback_does_not_kill_the_step_loop(models):
    jm, tm = models
    prompts = _prompts(4, seed=6)
    eng = _port(tm, num_slots=4, bucket_min=8)
    seen = []

    def poisoned(r, t):
        raise ValueError("user bug")

    reqs = [eng.add_request(p, max_new_tokens=5,
                            on_token=poisoned if i == 1 else
                            (lambda r, t: seen.append((r.rid, t))))
            for i, p in enumerate(prompts)]
    eng.run()
    assert [list(r.generated) for r in reqs] == \
        _reference(jm, prompts, 5, "p4s6")
    res = eng.metrics.snapshot()["resilience"]
    assert res["callback_errors"] == len(reqs[1].generated)
    assert sum(1 for rid, _ in seen if rid == reqs[0].rid) == 5
    assert reqs[1].stop_reason in ("eos", "max_tokens")


# ------------------------------------------------------ drain / close

@pytest.mark.parametrize("paged", [False, True])
def test_close_with_inflight_work_aborts_explicitly(models, paged):
    _, tm = models
    prompts = _prompts(6, seed=8)
    with _port(tm, num_slots=2, bucket_min=8, paged=paged) as eng:
        reqs = [eng.add_request(p, max_new_tokens=30) for p in prompts]
        eng.step()
        eng.step()
        assert eng._pending           # a pipelined result is unread
    assert all(r.done for r in reqs)
    aborted = [r for r in reqs if r.stop_reason == "aborted"]
    assert aborted
    res = eng.metrics.snapshot()["resilience"]
    assert res["requests_aborted"] == len(aborted)
    _conserved(eng, 2)
    with pytest.raises(RuntimeError):
        eng.add_request(prompts[0], max_new_tokens=2)
    eng.close()                               # idempotent


def test_drain_finishes_commitments_then_closes(models):
    jm, tm = models
    prompts = _prompts(5, seed=9)
    eng = _port(tm, num_slots=2, bucket_min=8)
    reqs = [eng.add_request(p, max_new_tokens=4) for p in prompts]
    eng.step()
    done = eng.drain()
    assert [list(r.generated) for r in reqs] == \
        _reference(jm, prompts, 4, "p5s9")
    assert {r.rid for r in done} >= {r.rid for r in reqs}
    assert all(r.stop_reason in ("eos", "max_tokens") for r in reqs)
    assert eng.metrics.snapshot()["resilience"]["requests_aborted"] == 0
    assert eng.metrics.health_report()["draining"] is True
    with pytest.raises(RuntimeError):
        eng.add_request(prompts[0], max_new_tokens=2)


# ------------------------------------------------------- supervisor

def _wedged(*a, **k):
    raise RuntimeError("device wedged")


@pytest.mark.parametrize("paged", [False, True])
def test_supervisor_restart_on_forced_wedge_end_to_end(models, paged):
    """A decode that fails on every step (retried, never escalated: the
    budget is 100) stalls the queue; the queue_stall detector fires; the
    supervisor restarts in-process (fresh pool and programs); the
    re-queued requests complete with the JAX engine's streams, and
    health reports degraded during the replay, healthy after."""
    jm, tm = models
    prompts = _prompts(6, seed=12)
    eng = _port(tm, num_slots=4, bucket_min=8, paged=paged,
                max_dispatch_retries=100, supervisor_cooldown_s=0.0,
                health_detectors={"queue_stall": {"stall_steps": 4}})
    reqs = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    for _ in range(3):
        eng.step()
    assert eng.metrics.health_report()["healthy"] is True
    pool_before = eng.pool
    eng._decode_fn = _wedged
    steps = 0
    while eng.supervisor.restarts == 0:
        eng.step()
        steps += 1
        assert steps < 50, "supervisor never fired"
    assert eng._decode_fn is not _wedged      # programs rebuilt
    assert eng.pool is not pool_before
    rep = eng.metrics.health_report()
    assert rep["degraded"] is True and rep["healthy"] is False
    assert rep["restarts"] == 1
    assert eng.health.report()["detectors"]["queue_stall"]["fired"] >= 1
    eng.run()
    assert [list(r.generated) for r in reqs] == \
        _reference(jm, prompts, 8, "p6s12")
    rep = eng.metrics.health_report()
    assert rep["degraded"] is False and rep["healthy"] is True
    assert eng.metrics.snapshot()["resilience"]["supervisor_restarts"] == 1
    _conserved(eng, 4)


@pytest.mark.parametrize("paged", [False, True])
def test_supervisor_escalation_from_decode_retry_exhaustion(models, paged):
    """Decode failing past the retry budget escalates straight to the
    supervisor, and the replay is exact (the paged pool comes back a
    fresh, conserved object)."""
    jm, tm = models
    prompts = _prompts(3, seed=13)
    eng = _port(tm, num_slots=4, bucket_min=8, paged=paged,
                max_dispatch_retries=2, supervisor_cooldown_s=0.0)
    reqs = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    eng.step()
    eng._decode_fn = _wedged
    eng.run()
    assert eng.supervisor.restarts == 1
    assert [list(r.generated) for r in reqs] == \
        _reference(jm, prompts, 6, "p3s13")
    res = eng.metrics.snapshot()["resilience"]
    assert res["dispatch_failures"]["decode"] == 3   # 2 retries + 1
    assert res["supervisor_restarts"] == 1
    _conserved(eng, 4)


def test_supervisor_gives_up_after_max_restarts(models):
    _, tm = models
    eng = _port(tm, num_slots=2, bucket_min=8, max_dispatch_retries=1,
                supervisor_max_restarts=2, supervisor_cooldown_s=0.0)
    eng.add_request(_prompts(1)[0], max_new_tokens=6)
    eng.step()

    def dead(*a, **k):
        raise RuntimeError("permanently dead")

    build = eng._build_programs

    def poisoned():
        build()
        eng._decode_fn = dead

    eng._build_programs = poisoned       # every rebuild is wedged too
    eng._decode_fn = dead
    with pytest.raises(RuntimeError, match="permanently dead"):
        eng.run()
    assert eng.supervisor.restarts == 2
    assert eng.supervisor.gave_up is True and eng.supervisor.degraded
    assert eng.metrics.health_report()["healthy"] is False


def test_config_takes_the_operations_knobs(models):
    _, tm = models
    eng = _port(tm, num_slots=2, bucket_min=8, chaos=5,
                max_dispatch_retries=2, retry_backoff_s=0.0,
                quarantine_after=2, health=True, health_audit_every=8,
                health_ledger_keep=16, health_detectors=None,
                incident_dir=None, incident_keep=4, health_debounce_s=1.0,
                supervisor=True, supervisor_max_restarts=3,
                supervisor_cooldown_s=0.5, replica_id="r7",
                watchdog_mode="raise")
    assert eng.replica_id == "r7" and eng.chaos.plan.seed == 5
    assert eng.supervisor.max_restarts == 3
    assert eng.health.ledger.keep == 16
    off = _port(tm, num_slots=2, bucket_min=8, health=False)
    assert off.health is None and off.supervisor is None
    for bad in (dict(max_dispatch_retries=-1), dict(quarantine_after=0),
                dict(health_audit_every=0)):
        with pytest.raises(ValueError):
            _port(tm, num_slots=2, bucket_min=8, **bad)
