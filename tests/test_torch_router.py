"""paddle_tpu_torch's fleet router against the JAX reference on the CPU.

The breaker's state machine on the same outcome sequences; the journal;
the same scripted fake transports (tests/test_router.py's pattern)
behind the port's Router and the reference's, which must make the same
placements, shed verdicts, retries, failovers and journal replays and
report the same ``state()``; router chaos, deterministic per seed; and
gateways over port engines in one process — least-load placement,
drain-aware admission, a replica killed mid-stream whose requests fail
over with the JAX engine's greedy streams — plus one HTTPTransport
over loopback.
"""
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import router as jrouter
from paddle_tpu.serving.resilience import FaultPlan as JaxPlan

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import router as trouter
from paddle_tpu_torch.serving.resilience import FaultPlan
from paddle_tpu_torch.serving.router import (
    CLOSED, HALF_OPEN, OPEN, ROUTER_STATE_KEYS, CircuitBreaker,
    EngineGateway, HTTPTransport, InProcessTransport, RequestJournal,
    Router, RouterConfig, TransportError, prompt_fingerprints)

PACKAGES = {"port": (trouter, FaultPlan), "ref": (jrouter, JaxPlan)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------ circuit breaker

_BREAKER_SCRIPTS = [
    [("f", 0.0), ("f", 0.1), ("allow", 0.2), ("s",), ("f", 0.3),
     ("f", 0.4), ("allow", 0.5)],
    [("f", 0.0), ("f", 0.1), ("f", 0.2), ("allow", 0.5), ("allow", 1.3),
     ("allow", 1.3), ("claim", 1.3), ("allow", 1.31), ("s",),
     ("allow", 1.4)],
    [("f", 0.0), ("f", 0.1), ("f", 0.15), ("claim", 1.2), ("f", 1.25),
     ("allow", 1.3), ("allow", 2.3), ("claim", 2.3), ("s",)],
    [("v", "down", 5.0), ("allow", 6.0), ("v", "up", 7.0),
     ("allow", 7.0), ("claim", 7.0), ("s",), ("v", "stale", 8.0),
     ("v", "down", 9.0), ("v", "down", 9.5)],
]


@pytest.mark.parametrize("script", range(len(_BREAKER_SCRIPTS)))
def test_breaker_state_machine_matches_reference(script):
    ours = CircuitBreaker(threshold=3, reset_s=1.0)
    ref = jrouter.CircuitBreaker(threshold=3, reset_s=1.0)
    for op in _BREAKER_SCRIPTS[script]:
        outs = []
        for br in (ours, ref):
            if op[0] == "f":
                br.record_failure(op[1])
            elif op[0] == "s":
                br.record_success()
            elif op[0] == "allow":
                outs.append(br.allow(op[1]))
            elif op[0] == "claim":
                br.claim(op[1])
            else:
                br.note_verdict(op[1], op[2])
        assert outs[:1] == outs[1:]
        assert (ours.state, ours.consecutive_failures, ours.transitions) \
            == (ref.state, ref.consecutive_failures, ref.transitions)
        assert ours.describe(10.0) == ref.describe(10.0)
    assert {CLOSED, OPEN, HALF_OPEN} == {"closed", "open", "half_open"}
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=0)


def test_journal_commit_replay_and_tear():
    j = RequestJournal()
    e = j.admit("q1", [1, 2, 3], 6, None, None, 0.0, tenant="t")
    assert j.depth == 1 and e.prefill_ids == [1, 2, 3]
    j.commit(e, 0, [7, 8])
    j.commit(e, 1, [8, 9, 10])
    assert e.tokens == [7, 8, 9, 10] and e.remaining_tokens == 2
    assert e.prefill_ids == [1, 2, 3, 7, 8, 9, 10]
    j.commit(e, 0, [7])                 # a shorter commit changes nothing
    assert e.tokens == [7, 8, 9, 10]
    with pytest.raises(AssertionError):
        j.commit(e, 9, [1])
    assert j.snapshot() == [{"rid": "q1", "replica": None, "attempts": 0,
                             "tokens_so_far": 4, "remaining_tokens": 2,
                             "tenant": "t"}]
    assert j.complete("q1") is e and j.depth == 0


# ---------------------------------------------------- fake transports

def _greedy(prefill, n):
    """Each token a pure function of the sequence so far, so continuing
    from prompt + k committed tokens agrees with the unfaulted stream."""
    seq = [int(t) for t in prefill]
    out = []
    for _ in range(n):
        t = (sum(seq) * 31 + 7) % 97
        seq.append(t)
        out.append(t)
    return out


class _FakeCall:
    def __init__(self, payload, error=None, delay_s=0.0):
        self._payload = payload
        self._error = error
        self._done_at = time.monotonic() + delay_s
        self.cancelled = False

    @property
    def done(self):
        return self.cancelled or time.monotonic() >= self._done_at

    def result(self, timeout=None):
        if self._error is not None:
            raise self._error
        return self._payload

    def cancel(self):
        self.cancelled = True
        return True


class _FakeTransport:
    """A scripted replica raising the given package's transport errors:
    ``script`` lists per-begin behaviours ("ok", "error", "refuse",
    ("mid_error", k) = stream k tokens then die, ("shed", reason)); the
    last entry repeats."""

    def __init__(self, mod, rid, script=("ok",), draining=False,
                 healthy=True, degraded=False, queue_depth=0, heat=(),
                 delay_s=0.0, dead=False):
        self.mod = mod
        self.replica_id = rid
        self.script = list(script)
        self.draining = draining
        self.healthy = healthy
        self.degraded = degraded
        self.queue_depth = queue_depth
        self.heat = list(heat)
        self.delay_s = delay_s
        self.dead = dead
        self.begins = []
        self.calls = []

    def begin(self, prompt, max_new_tokens, eos_id=None, deadline_ms=None,
              on_token=None):
        behavior = self.script[min(len(self.begins), len(self.script) - 1)]
        self.begins.append({"prompt": list(prompt),
                            "max_new_tokens": max_new_tokens,
                            "deadline_ms": deadline_ms is not None})
        if behavior == "error":
            raise self.mod.TransportError(f"{self.replica_id} unreachable")
        if behavior == "refuse":
            raise self.mod.TransportRefused(f"{self.replica_id} draining")
        shed = error = None
        tokens = _greedy(prompt, max_new_tokens)
        if isinstance(behavior, tuple) and behavior[0] == "mid_error":
            tokens = tokens[:behavior[1]]
            error = self.mod.TransportError(f"{self.replica_id} died")
        elif isinstance(behavior, tuple) and behavior[0] == "shed":
            tokens, shed = [], behavior[1]
        if on_token is not None:
            for t in tokens:
                on_token(t)
        call = _FakeCall({"rid": "fr", "replica_id": self.replica_id,
                          "tokens": tokens, "shed_reason": shed},
                         error=error, delay_s=self.delay_s)
        self.calls.append(call)
        return call

    def health(self):
        if self.dead:
            raise self.mod.TransportError(f"{self.replica_id} is dead")
        return {"healthy": self.healthy, "draining": self.draining,
                "degraded": self.degraded}

    def state(self):
        if self.dead:
            raise self.mod.TransportError(f"{self.replica_id} is dead")
        return {"queue_depth": self.queue_depth,
                "cache": {"heat": {"top": self.heat}}}


def _cfg(mod, **kw):
    kw.setdefault("max_retries", 2)
    kw.setdefault("backoff_base_s", 0.001)
    kw.setdefault("backoff_max_s", 0.01)
    kw.setdefault("refresh_s", 0.02)
    kw.setdefault("hedge", False)
    return mod.RouterConfig(**kw)


_OUTCOME = ("ok", "shed", "reason", "tokens", "replica_id", "attempts",
            "failures", "failovers", "hedged", "hedge_winner")


def _outcome(res):
    return {k: res.get(k) for k in _OUTCOME}


def _state(router):
    """``state()`` without wall-clock fields."""
    st = router.state()
    for r in st["replicas"]:
        r["breaker"].pop("open_for_s")
    st["hedge"].pop("delay_s")
    return st


def _heat(prompt, block=4):
    return [{"fp": fp, "tokens_saved": 64}
            for fp in prompt_fingerprints(prompt, block)]


# scenario -> (replicas [(rid, kwargs)], config kwargs, requests
# [(prompt, max_new, kwargs)], posture changes between requests)
SCENARIOS = {
    "least_loaded": ([("a", dict(queue_depth=5)), ("b", {})], {},
                     [([1, 2, 3], 4, {})] * 3),
    "retry_failover": ([("a", dict(script=("error",))),
                        ("b", dict(queue_depth=1))],
                       dict(affinity=False), [([9, 9], 3, {})] * 2),
    "retry_budget": ([("a", dict(script=("error",)))],
                     dict(max_retries=1), [([1], 2, {})]),
    "refusal": ([("a", dict(script=("refuse",))),
                 ("b", dict(queue_depth=1))],
                dict(affinity=False), [([2, 2], 3, {})]),
    "replica_shed": ([("a", dict(script=(("shed", "slo_lost"),))),
                      ("b", dict(queue_depth=1))],
                     dict(affinity=False), [([3, 3], 3, {})]),
    "mid_stream_replay": ([("a", dict(script=(("mid_error", 3),))),
                           ("b", dict(queue_depth=1))],
                          dict(affinity=False),
                          [([4, 8, 15, 16], 8, {})]),
    "no_admissible": ([("a", dict(draining=True)),
                       ("b", dict(degraded=True)),
                       ("c", dict(healthy=False)), ("d", dict(dead=True))],
                      {}, [([1], 2, {})]),
    "deadline": ([("a", {})], {},
                 [([1, 2], 3, dict(deadline_ms=60000.0)),
                  ([1, 2], 3, dict(deadline_ms=0.0))]),
    "affinity_heat": ([("a", {}), ("b", dict(queue_depth=1,
                                             heat=_heat(list(range(8)))))],
                      dict(affinity_block=4, affinity_spill=4),
                      [(list(range(8)), 3, {})]),
    "affinity_spill": ([("a", {}), ("b", dict(queue_depth=20,
                                              heat=_heat(list(range(8)))))],
                       dict(affinity_block=4, affinity_spill=4),
                       [(list(range(8)), 3, {})]),
    "tie_break": ([("b", dict(heat=_heat(list(range(8))))),
                   ("a", dict(heat=_heat(list(range(8)))))],
                  dict(affinity_block=4, affinity_spill=4),
                  [(list(range(8)), 3, {})]),
    "sticky": ([("a", {}), ("b", {})], dict(affinity_block=4),
               [(list(range(16)), 2, {})] * 4),
    "breaker": ([("a", dict(script=("error", "error", "error", "ok")))],
                dict(max_retries=0, breaker_threshold=3,
                     breaker_reset_s=60.0),
                [([1], 2, {})] * 4),
}


def _run_scenario(name, pkg):
    mod, _ = PACKAGES[pkg]
    replicas, cfg, requests = SCENARIOS[name]
    ts = [_FakeTransport(mod, rid, **kw) for rid, kw in replicas]
    router = mod.Router(ts, config=_cfg(mod, **cfg))
    try:
        results = [_outcome(router.generate(p, n, timeout=10.0, **kw))
                   for p, n, kw in requests]
        return (results, {t.replica_id: t.begins for t in ts},
                _state(router), dict(router._stats))
    finally:
        router.close()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_decisions_equal_reference(name):
    """The same fake transports behind both routers: the same results
    (placement, shed verdict, attempts, failures, failovers, tokens),
    the same dispatches (prompt + replayed tokens, budgets, deadline
    propagation), the same state() and counters."""
    ours = _run_scenario(name, "port")
    ref = _run_scenario(name, "ref")
    assert ours == ref
    results, _, state, _ = ours
    assert tuple(sorted(state)) == tuple(sorted(ROUTER_STATE_KEYS))
    json.dumps(state)
    if name == "mid_stream_replay":
        assert results[0]["tokens"] == _greedy([4, 8, 15, 16], 8)
    if name == "no_admissible":
        assert results[0]["reason"] == "no_admissible_replica"


def test_router_shed_and_hedge_verdicts_equal_reference():
    """Queue-full and closed-router sheds, and a hedge whose slow
    primary loses and is cancelled, in both routers."""
    out = []
    for pkg in ("port", "ref"):
        mod, _ = PACKAGES[pkg]
        a = _FakeTransport(mod, "a", delay_s=0.5)
        router = mod.Router([a], config=_cfg(mod, max_queue=1))
        t1 = router.submit([1, 2], 3)
        r2 = router.submit([3, 4], 3).result(timeout=1.0)
        r1 = t1.result(timeout=10.0)
        router.close()
        r3 = router.generate([1], 2, timeout=1.0)
        a = _FakeTransport(mod, "a", delay_s=1.0)
        b = _FakeTransport(mod, "b", queue_depth=1)
        router = mod.Router([a, b], config=_cfg(
            mod, hedge=True, hedge_min_s=0.02, affinity=False))
        r4 = router.generate([6, 6], 4, timeout=10.0)
        cancelled = a.calls[0].cancelled
        stats = dict(router._stats)
        router.close()
        out.append(([_outcome(r) for r in (r1, r2, r3, r4)], cancelled,
                    stats))
    assert out[0] == out[1]
    (r1, r2, r3, r4), cancelled, stats = out[0]
    assert r2["reason"] == "queue_full" and r3["reason"] == "router_closed"
    assert r4["hedged"] and r4["hedge_winner"] == "hedge" and cancelled
    assert stats["hedges"] == 1
    assert RouterConfig().hedge is False and RouterConfig().max_retries == 2


def test_router_chaos_deterministic_and_equal_reference():
    """A seeded plan at the router's own seam: retries absorb it, two
    runs give the same fault log, and so does the reference's router."""
    plan = {"seed": 11, "faults": {"router_dispatch": {"rate": 0.5}}}

    def run(pkg):
        mod, plan_cls = PACKAGES[pkg]
        ts = [_FakeTransport(mod, "a"), _FakeTransport(mod, "b")]
        router = mod.Router(ts, chaos=plan_cls(**plan),
                            config=_cfg(mod, max_retries=6, affinity=False))
        results = [router.submit([1, 2, i], 3, tag=f"t{i}").result(10.0)
                   for i in range(8)]
        log = [(e["site"], e["check"], e["rid"])
               for e in router.chaos.fault_log()]
        router.close()
        return [_outcome(r) for r in results], log

    res1, log1 = run("port")
    res2, log2 = run("port")
    resj, logj = run("ref")
    assert all(r["ok"] for r in res1) and log1
    assert log1 == log2 == logj
    assert res1 == res2 == resj
    router = Router([_FakeTransport(trouter, "a")])
    assert router.chaos is None
    router.close()


# --------------------------------------------- in-process engine fleet

@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


def _gateway(tm, rid, **kw):
    return EngineGateway(ServingEngine(tm, device="cpu", num_slots=2,
                                       bucket_min=8, replica_id=rid, **kw))


def _jax_streams(jm, prompts, max_new):
    eng = JaxEngine(jm, num_slots=2, bucket_min=8, paged=True)
    reqs = [eng.add_request(np.asarray(p, dtype=np.int64),
                            max_new_tokens=max_new) for p in prompts]
    eng.run()
    return [[int(t) for t in r.generated] for r in reqs]


def _rand_prompts(seed, n, lo=4, hi=8):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 97, (int(rs.randint(lo, hi)),)).astype(int)
            .tolist() for _ in range(n)]


def _clean(gw):
    """The replica's pool ends empty and conserved."""
    eng = gw.engine
    with gw._lock:
        assert not eng.pending
        assert eng.pool.free_count == eng.config.num_slots
        eng.pool.check_conservation()
        assert eng.pool.live_blocks == 0


def test_gateway_kill_never_surfaces_aborted_request_as_success(models):
    _, tm = models
    gw = _gateway(tm, "rkill")
    prompt = np.asarray([5, 9, 2, 7, 1], dtype=np.int64)
    warm = gw.submit(prompt, max_new_tokens=2)
    assert gw.wait(warm, timeout=120.0)
    req = gw.submit(prompt, max_new_tokens=48)
    deadline = time.monotonic() + 30.0
    while not req.generated and time.monotonic() < deadline:
        time.sleep(0.001)
    assert req.generated, "request never started decoding"
    gw.kill()
    assert req.done and len(req.generated) < 48
    assert req.stop_reason == "aborted"
    with pytest.raises(TransportError):
        gw.wait(req, timeout=5.0)
    with pytest.raises(TransportError):
        gw.submit(prompt, max_new_tokens=2)


def test_gateway_concurrent_submitters_stress(models):
    """More submitting threads than cores, with a short switch interval,
    against one gateway stepping its engine: every request completes
    with its full stream and the pool ends conserved (a submission or a
    step that raced the other outside the lock would lose a request or
    leak a slot)."""
    _, tm = models
    gw = _gateway(tm, "stress")
    prompts = _rand_prompts(11, 24, lo=3, hi=9)
    results, errors = {}, []

    def client(k):
        try:
            for i in range(k, len(prompts), 12):
                req = gw.submit(prompts[i], max_new_tokens=3 + i % 4)
                assert gw.wait(req, timeout=120.0)
                results[i] = list(req.generated)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    try:
        assert not errors, errors
        assert sorted(results) == list(range(len(prompts)))
        assert all(len(results[i]) == 3 + i % 4 for i in results)
        _clean(gw)
    finally:
        gw.close()


def test_router_least_load_over_inprocess_gateways(models):
    """Two port replicas behind the router: requests spread by load and
    every stream equals the JAX engine's."""
    jm, tm = models
    prompts = _rand_prompts(2, 6)
    ref = _jax_streams(jm, prompts, 6)
    ga, gb = _gateway(tm, "la"), _gateway(tm, "lb")
    router = Router([InProcessTransport(ga), InProcessTransport(gb)],
                    config=_cfg(trouter, refresh_s=0.01, affinity=False))
    try:
        tickets = [router.submit(p, 6) for p in prompts]
        results = [t.result(timeout=60.0) for t in tickets]
        assert all(r["ok"] for r in results)
        assert [r["tokens"] for r in results] == ref
        placed = {r["replica_id"] for r in results}
        assert placed == {"la", "lb"}
        assert tuple(sorted(router.state())) == \
            tuple(sorted(ROUTER_STATE_KEYS))
        for gw in (ga, gb):
            deadline = time.monotonic() + 10.0
            while gw.engine.pending and time.monotonic() < deadline:
                time.sleep(0.005)
            _clean(gw)
    finally:
        router.close()
        ga.close()
        gb.close()


def test_router_drain_aware_admission_two_replicas(models):
    """One replica drains mid-traffic: within one poll interval new
    requests go only to the other, while the draining replica's work
    completes."""
    _, tm = models
    ga, gb = _gateway(tm, "ra"), _gateway(tm, "rb")
    router = Router([InProcessTransport(ga), InProcessTransport(gb)],
                    config=_cfg(trouter, refresh_s=0.05, affinity=False))
    prompts = _rand_prompts(3, 6, lo=5, hi=6)
    try:
        warm = [router.submit(p, 24) for p in prompts[:4]]
        deadline = time.monotonic() + 30.0
        while not ga.engine.pending and time.monotonic() < deadline:
            time.sleep(0.002)
        assert ga.engine.pending
        ga.drain(wait=False)
        time.sleep(0.06)
        for p in prompts[4:]:
            res = router.submit(p, 4).result(timeout=60.0)
            assert res["ok"] and res["replica_id"] == "rb"
        for t in warm:
            assert t.result(timeout=60.0)["ok"]
        assert not ga.engine.pending
        by_id = {r["replica_id"]: r for r in router.state()["replicas"]}
        assert by_id["ra"]["admissible"] is False
        assert by_id["ra"]["posture"]["draining"] is True
        _clean(ga)
    finally:
        router.close()
        ga.close()
        gb.close()


def test_router_inprocess_kill_failover_parity(models):
    """A replica killed mid-stream: every admitted request completes
    with the JAX engine's greedy stream (the journal replays prompt +
    committed tokens on the survivor), the death shows only in the
    failover counters, and the survivor's pool ends conserved."""
    jm, tm = models
    prompts = _rand_prompts(5, 6)
    ref = _jax_streams(jm, prompts, 16)
    ga, gb = _gateway(tm, "ka"), _gateway(tm, "kb")
    router = Router([InProcessTransport(ga), InProcessTransport(gb)],
                    config=_cfg(trouter, max_retries=4, refresh_s=0.05,
                                affinity=False))
    try:
        tickets = [router.submit(p, 16) for p in prompts]
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and sum(
                1 for r in list(ga.engine.scheduler.active.values())
                if r.generated) < 2:
            time.sleep(0.001)
        ga.kill()
        results = [t.result(timeout=120.0) for t in tickets]
        assert all(r["ok"] for r in results)
        assert [r["tokens"] for r in results] == ref
        assert all(r["replica_id"] == "kb" for r in results
                   if r["failovers"])
        assert router._stats["failovers"] >= 1
        assert router.breakers["ka"].state == OPEN
        deadline = time.monotonic() + 10.0
        while gb.engine.pending and time.monotonic() < deadline:
            time.sleep(0.005)
        _clean(gb)
    finally:
        router.close()
        gb.close()


def test_http_transport_over_loopback(models):
    """One replica behind EngineGateway.serve() on 127.0.0.1 and a
    router over an HTTPTransport to it: streams equal the JAX engine's,
    /metrics and /debug/health answer, and a draining replica's 503 is
    a clean refusal."""
    jm, tm = models
    prompts = _rand_prompts(7, 3)
    ref = _jax_streams(jm, prompts, 5)
    gw = _gateway(tm, "h0")
    handle = gw.serve(port=0, addr="127.0.0.1")
    router = Router([HTTPTransport(f"127.0.0.1:{handle.port}",
                                   replica_id="h0", timeout_s=60.0)],
                    config=_cfg(trouter, refresh_s=0.05))
    try:
        results = [router.generate(p, 5, timeout=60.0) for p in prompts]
        assert all(r["ok"] for r in results)
        assert [r["tokens"] for r in results] == ref
        for path in ("/metrics", "/debug/health", "/debug/state"):
            with urllib.request.urlopen(handle.url + path,
                                        timeout=10.0) as resp:
                assert resp.status == 200
        gw.drain(wait=True, timeout=30.0)
        st, body = None, None
        try:
            req = urllib.request.Request(
                handle.url + "/v1/generate",
                data=json.dumps({"prompt": [1, 2],
                                 "max_new_tokens": 2}).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=10.0)
        except urllib.error.HTTPError as e:
            st, body = e.code, json.loads(e.read().decode())
        assert st == 503 and body["error"] == "refused"
        _clean(gw)
    finally:
        router.close()
        gw.close()
    assert handle.closed
