"""paddle_tpu_torch's fleet drills on the CPU, beside the reference's
tools: the router drill over replica processes (monolithic and
disaggregated, a replica SIGKILLed mid-request), the seeded chaos sweep
on both pools, and fleet_top over two port replicas.

The drills' wave lines carry the reference's fields (``lost``,
``parity_mismatch``, ``killed``, ``handoffs``, ``wire_bytes``) and
give the reference's verdicts: every admitted request completes through
the failover, exact against the reference wave, and the no-failover
baseline loses the killed replica's requests. The chaos sweep's cells
give the reference's fault counts, retries, restarts and steps on the
same seeds and weights. fleet_top's exit code is the reference's on the
same replicas. Every subprocess has a timeout of its own, and every wait
is on a ready-line or a bounded poll, never a fixed sleep.
"""
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.observability.fleet import FLEET_SNAPSHOT_KEYS
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.router import Router, RouterConfig
from paddle_tpu_torch.serving.router.transport import HTTPTransport
from paddle_tpu_torch.tools import chaos_sweep, fleet_top, router_drill

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DRILL_TIMEOUT = 300    # seconds a drill subprocess may take (about 10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(module, *args, timeout=_DRILL_TIMEOUT):
    proc = subprocess.run(
        [sys.executable, "-m", f"paddle_tpu_torch.tools.{module}", *args],
        cwd=_ROOT, capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.strip().startswith("{")]
    return proc, lines


# ------------------------------------------------------------- the drill

def test_router_drill_fast_subprocess_self_run():
    """``router_drill --fast``: 3 replica processes over HTTP, one
    SIGKILLed mid-traffic; exit 0 with 100% completion, exact streams,
    clean survivors, and the no-failover baseline losing requests."""
    proc, lines = _run("router_drill", "--device", "cpu", "--fast",
                       "--requests", "6", "--max-new", "10",
                       "--threads", "1")
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    waves = {e["wave"]: e for e in lines if "wave" in e}
    assert lines[-1]["result"] == "PASS" and lines[-1]["failures"] == []
    assert waves["reference"]["ok"] == waves["reference"]["total"] == 6
    fo = waves["failover"]
    assert fo["lost"] == [] and fo["parity_mismatch"] == []
    assert fo["killed"] == "dr0" and fo["ok"] + fo["shed"] == 6
    assert fo["failovers"] >= 1 and fo["traced_failovers"] >= 1
    assert fo["steady_state_compiles"] == 0
    assert fo["kill_to_done_s"] > 0
    assert waves["baseline_no_failover"]["lost"]   # the kill hurt there
    assert waves["baseline_no_failover"]["killed"] == "dr1"


def test_router_drill_prefill_kill_subprocess():
    """``--kill prefill``: 1 prefill + 2 decode replicas; the reference
    wave hands KV off over the wire, the prefill replica dies
    mid-handoff and every request still completes exactly."""
    proc, lines = _run("router_drill", "--device", "cpu", "--fast",
                       "--kill", "prefill", "--requests", "6",
                       "--max-new", "10", "--threads", "1")
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    waves = {e["wave"]: e for e in lines if "wave" in e}
    assert lines[-1]["result"] == "PASS"
    assert waves["reference"]["handoffs"] > 0
    assert waves["reference"]["wire_bytes"] > 0
    fo = waves["failover"]
    assert fo["lost"] == [] and fo["parity_mismatch"] == []
    assert fo["killed"] == "dr0"                   # the prefill tier
    assert {"handoffs", "handoff_failures"} <= set(fo)
    assert waves["baseline_no_failover"]["lost"]


def test_router_drill_replays_the_reference_engines_streams():
    """The port's replicas serve the reference drill's prompts with the
    streams a JAX engine gives on the same weights: the drill's oracle
    (its reference wave) is the reference's."""
    jm = jax_gpt()
    tm = torch_twin(jm)
    from paddle_tpu.serving import ServingEngine as JaxEngine
    prompts = router_drill.prompts_for(5, 6)
    jeng = JaxEngine(jm, num_slots=2, bucket_min=8)
    jreqs = [jeng.add_request(np.asarray(p, np.int64), max_new_tokens=10)
             for p in prompts]
    jeng.run()
    eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                        paged=False, replica_id="x0")
    from paddle_tpu_torch.serving.router import EngineGateway
    gw = EngineGateway(eng)
    handle = gw.serve()
    try:
        router = Router([HTTPTransport(f"127.0.0.1:{handle.port}",
                                       replica_id="x0")],
                        config=RouterConfig(max_retries=0))
        got = [t.result(timeout=60.0)
               for t in [router.submit(p, 10) for p in prompts]]
        router.close()
    finally:
        handle.close()
        gw.close()
    assert [r["tokens"] for r in got] == [list(r.generated) for r in jreqs]


def test_replica_worker_counts_and_audit_routes():
    """The worker's own routes: counts read and reset under the gateway
    lock (decode steps since the reset), and the pool audit."""
    proc = router_drill.spawn(0, device="cpu", threads=1, block_size=8,
                              prefix="w")
    try:
        info = router_drill.ready(proc, timeout=120.0)
        url = f"http://127.0.0.1:{info['port']}"
        assert info["replica_id"] == "w0" and info["pid"] == proc.pid
        router_drill.post(url, "/v1/counts", {"reset": True})
        out = router_drill.post(url, "/v1/generate",
                                {"prompt": [1, 2, 3], "max_new_tokens": 4})
        assert len(out["tokens"]) == 4
        counts = router_drill.post(url, "/v1/counts")
        # on the CPU no kernel launches; the paged decode ran 3 steps
        assert counts["decode_steps"] == 3 and counts["k4"] == 0
        assert counts["num_layers"] == 2
        audit = router_drill.post(url, "/v1/audit")
        assert audit["ok"] and audit["conserved"] and not audit["pending"]
    finally:
        router_drill.stop([proc])
    assert proc.returncode is not None


def test_import_route_takes_a_handoff_over_a_mebibyte():
    """A replica's /v1/import takes the largest handoff its pool could
    import: here a 200-token prompt of a wider model, 2.2 MB of JSON,
    over the reference's 1 MiB limit, decodes as it does in process."""
    from paddle_tpu_torch.serving import kv_wire
    from paddle_tpu_torch.serving.router import EngineGateway
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              TransformerLMConfig)
    cfg = TransformerLMConfig(vocab_size=97, hidden_size=256, num_layers=4,
                              num_heads=4, max_seq_len=256, dropout=0.0)
    tm = GPTForCausalLM(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3)).eval()
    prompt = np.random.RandomState(4).randint(0, 97, 200).astype(np.int64)
    pe = ServingEngine(tm, device="cpu", num_slots=2, role="prefill")
    req = pe.add_request(prompt, max_new_tokens=1, hold_kv=True)
    pe.run()
    payload = pe.export_kv(req.rid)
    body = json.dumps({"handoff": payload, "max_new_tokens": 5})
    assert len(body) > 1 << 20
    assert len(json.dumps(payload)) <= kv_wire.payload_bytes_bound(
        4, 4, 64, 256, 16, 4)
    want = ServingEngine(tm, device="cpu", num_slots=2, role="decode")
    wreq = want.import_kv(payload, max_new_tokens=5)
    want.run()
    gw = EngineGateway(ServingEngine(tm, device="cpu", num_slots=2,
                                     role="decode"))
    handle = gw.serve()
    try:
        out = router_drill.post(f"http://127.0.0.1:{handle.port}",
                                "/v1/import", json.loads(body))
    finally:
        handle.close()
        gw.close()
    assert out["tokens"] == list(wreq.generated) and len(out["tokens"]) == 5


# -------------------------------------------------------- the chaos sweep

def test_chaos_sweep_fast_gate():
    """``chaos_sweep --fast`` on both pools (its entry point, in this
    process pinned to one torch thread): every cell passes (no hang, no
    leak, parity, determinism, no patrol finding)."""
    out = io.StringIO()
    rc = chaos_sweep.main(["--device", "cpu", "--fast"], out=out)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert rc == 0, out.getvalue()[-2000:]
    cells = [c for c in lines if "site" in c]
    assert lines[-1] == {"summary": True, "cells": len(cells),
                         "failures": 0}
    assert all(c["ok"] for c in cells)
    assert {(c["site"], c["paged"]) for c in cells} >= {
        ("all", False), ("all", True), ("chunk_dispatch", True),
        ("kv_handoff", True)}
    assert sum(1 for c in cells if c.get("spec")) == 2   # both pools


def _reference_sweep():
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    try:
        import chaos_sweep as ref
    finally:
        sys.path.pop(0)
    return ref


@pytest.mark.parametrize("site,paged,spec", [
    ("all", True, False),
    ("chunk_dispatch", False, False),
    ("decode_dispatch", True, True),
])
def test_chaos_cells_match_the_reference(site, paged, spec):
    """One cell of each kind through both sweeps on the same weights
    (the reference's seed-11 model, converted) and the same seed: the
    same verdict, fault counts, retries, restarts, incomplete requests
    and steps."""
    ref = _reference_sweep()
    jm = ref._build_model()
    tm = torch_twin(jm)
    specs = chaos_sweep.workload(12)
    rs = np.random.RandomState(9)
    specs = specs + [(rs.randint(0, 97, (28,)).astype(np.int64), 4)]
    if spec:
        specs = [(p, k + 8) for p, k in specs]
    want_ref, _, _, _ = ref._drain(jm, specs, paged, chunk=8, spec=spec)
    got_ref, _, _, _ = chaos_sweep.drain(tm, specs, paged, chunk=8,
                                         spec=spec, device="cpu")
    assert got_ref == want_ref          # the unfaulted streams agree
    want = ref._check_cell(site, 1, jm, specs, want_ref, paged, 8,
                           spec=spec)
    got = chaos_sweep.patrolled(chaos_sweep.check_cell, site, 1, tm, specs,
                                got_ref, paged, 8, spec=spec, device="cpu")
    keys = ("ok", "steps", "faults", "retries", "restarts", "incomplete")
    assert {k: got.get(k) for k in keys} == {k: want.get(k) for k in keys}
    assert got["ok"]


def test_chaos_handoff_cell_matches_the_reference():
    ref = _reference_sweep()
    jm = ref._build_model()
    tm = torch_twin(jm)
    specs = chaos_sweep.workload(6)
    want_ref, _, _, _ = ref._drain(jm, specs, True)
    got_ref, _, _, _ = chaos_sweep.drain(tm, specs, True, device="cpu")
    assert got_ref == want_ref
    want = ref._check_handoff_cell(1, jm, specs, want_ref)
    got = chaos_sweep.check_handoff_cell(1, tm, specs, got_ref,
                                         device="cpu")
    assert got == want and got["ok"]


# ------------------------------------------------------------- fleet_top

@pytest.fixture
def two_replicas():
    """Two port replicas serving three requests each, behind their
    metrics servers, with the SLO target of the reference's test."""
    tm = torch_twin(jax_gpt())
    engines, handles = [], []
    for i in range(2):
        eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                            replica_id=f"r{i}", slo_ttft_ms=10000.0)
        handles.append(eng.serve_metrics())
        engines.append(eng)
        rs = np.random.RandomState(i)
        for _ in range(3):
            eng.add_request(rs.randint(0, 97, (5,)).astype(np.int64),
                            max_new_tokens=3, tenant_id=f"t{i}")
        eng.run()
    yield engines, handles
    for h in handles:
        h.close()
    for e in engines:
        e.close()


def _top(*args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fleet_top.main(list(args))
    return rc, out.getvalue(), err.getvalue()


def _reference_top(*args):
    """The reference's fleet_top on the same targets: its exit code (its
    table goes to the test's own output)."""
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    try:
        import fleet_top as ref
    finally:
        sys.path.pop(0)
    return ref.main(list(args))


def test_fleet_top_healthy_and_unhealthy_exits(two_replicas):
    engines, handles = two_replicas
    targets = [f"127.0.0.1:{h.port}" for h in handles]
    rc, out, err = _top(*targets, "--interval", "0.05")
    assert rc == 0, err
    assert "r0" in out and "r1" in out and "2/2 up" in out
    assert "healthy" in out and "ttft_p50=" in out
    assert _reference_top(*targets, "--interval", "0.05") == 0
    # the CLI itself, once
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.fleet_top",
         *targets, "--interval", "0.05"], cwd=_ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "2/2 up" in proc.stdout
    # kill r1: exit 1 naming its target, as the reference's tool does
    handles[1].close()
    rc, out, err = _top(*targets, "--interval", "0.05")
    assert rc == 1 and "1/2 up" in out
    assert "UNHEALTHY" in err and targets[1] in err
    assert _reference_top(*targets, "--interval", "0.05") == 1


def test_fleet_top_json_router_traces_tenants(two_replicas):
    engines, handles = two_replicas
    targets = [f"127.0.0.1:{h.port}" for h in handles]
    rc, out, _ = _top("--json", targets[0])
    assert rc == 0
    assert set(json.loads(out)) == set(FLEET_SNAPSHOT_KEYS)
    router = Router([HTTPTransport(t, replica_id=f"r{i}")
                     for i, t in enumerate(targets)],
                    config=RouterConfig(max_retries=0))
    rhandle = router.serve(port=0)
    try:
        rurl = f"127.0.0.1:{rhandle.port}"
        rc, out, _ = _top(*targets, "--router", rurl, "--traces",
                          "--tenants", "--interval", "0.05")
        assert rc == 0
        assert "router: journal=0" in out and "r0=closed" in out
        assert "traces: " in out and "tenants: " in out
        assert "t0" in out and "t1" in out
        rc, out, _ = _top("--json", *targets, "--router", rurl, "--traces",
                          "--tenants")
        doc = json.loads(out)
        assert set(doc) == set(FLEET_SNAPSHOT_KEYS) | {"router", "traces",
                                                       "tenants"}
        assert doc["router"]["journal_depth"] == 0
        assert len(doc["traces"]) == 6          # one a served request
        assert set(doc["tenants"]["fleet"]["tenants"]) == {"t0", "t1"}
    finally:
        rhandle.close()
        router.close()
    assert fleet_top.fetch_router_state("127.0.0.1:9") is None
    buf = io.StringIO()
    fleet_top.render_router(None, out=buf)
    assert "unreachable" in buf.getvalue()


def test_fleet_top_watch_renders_until_interrupted(two_replicas):
    engines, handles = two_replicas
    targets = [f"127.0.0.1:{h.port}" for h in handles]
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.fleet_top",
         *targets, "--watch", "0.05"], cwd=_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    guard = threading.Timer(60.0, proc.kill)    # bounds the read below
    guard.start()
    try:
        frames = 0
        for line in proc.stdout:
            frames += line.startswith("== fleet_top")
            if frames == 2:
                break
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        guard.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    assert frames == 2 and rc == 0
