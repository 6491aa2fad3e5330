"""router_drill — the kill-a-replica gate for the port's fleet router (a
port of the reference's ``tools/router_drill.py``).

Spawns N replica processes (:mod:`.replica_worker`: the same seeded
model each, an EngineGateway with ``POST /v1/generate``), routes seeded
traffic to them over HTTP, and proves the router's failover promise:

  1. **reference wave** — all replicas up; every request completes;
     its streams are the parity oracle;
  2. **failover wave** — the same traffic with seeded
     ``router_dispatch`` faults armed, and one replica SIGKILLed the
     moment it has requests in flight. PASS iff 100% of admitted,
     non-shed requests complete, every stream passes the parity rule
     against the reference wave, the survivors end with no queued
     request, no occupied slot and their pools conserved, and each
     failed-over request stays ONE trace (the replay's spans land
     under the original trace id beside a router/failover span);
  3. **no-failover baseline** — the same kill against a
     ``max_retries=0`` router: the drill DEMANDS lost requests here and
     names them.

The parity rule is bit-exactness by default (the CPU: every replica
computes the same stream). On the card a replayed request lands in a
batch of another size, so a caller may pass its own rule (``parity``),
as ``chip_smoke.py`` does with its near-tie rule. The reference also
demands zero steady-state compiles on the survivors; the port compiles
nothing per shape, so ``serving_compiles_total`` stays 0 and the field
(``steady_state_compiles``) is kept, always 0.

Exit 0 iff every wave passes; exit 1 names the lost or mismatched
requests. One JSON line per wave on stdout, the RESULT line last.

``--kill prefill`` runs the disaggregated flavour: replica 0 is the
prefill tier, the rest decode (paged pools); wave 1 must hand KV off
(``handoffs > 0``) and wave 2 SIGKILLs the prefill replica mid-handoff.

    python -m paddle_tpu_torch.tools.router_drill --device cpu --fast
    python -m paddle_tpu_torch.tools.router_drill --device cpu --fast \\
        --kill prefill
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn(idx, role=None, device=None, model="tiny", seed=7, num_slots=2,
          block_size=None, paged=False, threads=None, prefix="dr"):
    """Start one replica worker process; read its ready-line with
    :func:`ready`."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.replica_worker",
           "--replica-id", f"{prefix}{idx}", "--model", model,
           "--seed", str(seed), "--num-slots", str(num_slots)]
    if role is not None:
        cmd += ["--role", role]
    if device is not None:
        cmd += ["--device", device]
    if block_size is not None:
        cmd += ["--block-size", str(block_size)]
    if paged:
        cmd.append("--paged")
    if threads is not None:
        cmd += ["--threads", str(threads)]
    return subprocess.Popen(cmd, cwd=_ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def ready(proc, timeout=300.0):
    """The worker's JSON ready-line, waited for at most ``timeout`` s;
    a worker that dies or stays silent is killed and raises."""
    box = {}

    def read():
        box["line"] = proc.stdout.readline()

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    line = box.get("line")
    if not line:
        proc.kill()
        proc.wait(timeout=30)
        err = proc.stderr.read()[-2000:] if proc.stderr else ""
        raise RuntimeError(f"replica worker never became ready:\n{err}")
    return json.loads(line)


def stop(procs):
    """Kill every worker still running and reap them all."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
        for f in (p.stdout, p.stderr):
            if f is not None:
                f.close()


def get(url, path, timeout=5.0):
    with urllib.request.urlopen(url + path, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def post(url, path, body=None, timeout=30.0):
    req = urllib.request.Request(
        url + path, data=json.dumps(body or {}).encode("utf-8"),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def compiles(url):
    """Sum of the replica's ``serving_compiles_total`` series from its
    /metrics.json (always 0 in the port: it compiles nothing)."""
    fam = get(url, "/metrics.json").get("serving_compiles_total")
    if fam is None:
        raise RuntimeError("replica exposes no serving_compiles_total")
    return sum(fam["values"].values())


def prompts_for(seed, n, vocab=97):
    """The reference drill's prompts: lengths 4-7 from ``seed``."""
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (int(rs.randint(4, 8)),))
            .astype(int).tolist() for _ in range(n)]


def wait_inflight(urls, deadline_s=30.0):
    """Block until some replica of ``urls`` has an occupied slot or a
    queued request — the moment a SIGKILL is sure to strand in-flight
    work. Returns its url, or None at the deadline."""
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        for u in urls:
            try:
                st = get(u, "/debug/state", timeout=1.0)
            except Exception:   # noqa: BLE001 - replica mid-warmup
                continue
            if st.get("slot_occupancy", 0) > 0 \
                    or st.get("queue_depth", 0) > 0:
                return u
        time.sleep(0.01)
    return None


def leak_audit(url, rid, paged, failures, timeout=60.0):
    """The survivor idle and clean: once its engine has gone idle
    (waited for at most ``timeout`` s), no queued request, no occupied
    slot, no held export, no live block, and the pool conserved."""
    t_end = time.monotonic() + timeout
    while True:
        audit = post(url, "/v1/audit")
        if audit["ok"] or time.monotonic() > t_end:
            break
        time.sleep(0.01)
    st = get(url, "/debug/state")
    if st.get("queue_depth", 0) != 0 \
            or st.get("slot_occupancy", 0) != 0 \
            or st.get("held_exports", 0) != 0:
        failures.append(
            f"leak on {rid}: queue_depth={st.get('queue_depth')} "
            f"slot_occupancy={st.get('slot_occupancy')} "
            f"held_exports={st.get('held_exports')}")
    if not audit["ok"]:
        failures.append(f"pool of {rid} not clean: {audit}")
    if paged:
        pool = (st.get("prefix_cache") or {}).get("pool") or {}
        if pool.get("live_blocks", 0) != 0:
            failures.append(f"leaked blocks on {rid}: "
                            f"live_blocks={pool.get('live_blocks')}")


def run_drill(replicas=3, requests=12, max_new=16, seed=5, fault_rate=0.1,
              kill="replica", out=sys.stdout, prompts=None, device=None,
              model="tiny", model_seed=7, num_slots=2, block_size=None,
              parity=None, threads=None, counts=None, timeout_s=600.0):
    """Run the three waves; returns ``(failures, waves)``: the failure
    messages (empty on PASS) and each wave's line with its streams
    (``"streams"``, in request order; None for a lost request).

    ``prompts`` (token lists) and ``max_new`` (an int or one per prompt)
    replace the reference's seeded traffic; ``parity(i, got, want)``
    replaces bit-exactness; ``counts``, a dict, receives each worker's
    ``/v1/counts`` reading, taken after the reference wave and the
    failover wave (the victim's just before its kill), every count
    reset just before the wave it covers."""
    from ..observability.trace import TraceAssembler
    from ..serving.resilience.chaos import FaultPlan, FaultSpec
    from ..serving.router import HTTPTransport, Router, RouterConfig

    disagg = kill == "prefill"
    roles = (["prefill"] + ["decode"] * (replicas - 1)) if disagg \
        else [None] * replicas
    procs = [spawn(i, role=r, device=device, model=model, seed=model_seed,
                   num_slots=num_slots, block_size=block_size,
                   paged=block_size is not None, threads=threads)
             for i, r in enumerate(roles)]
    failures, waves = [], {}
    parity = parity or (lambda i, got, want: got == want)
    try:
        infos = [ready(p) for p in procs]
        urls = [f"http://127.0.0.1:{i['port']}" for i in infos]
        rids = [i["replica_id"] for i in infos]
        by_url = dict(zip(urls, rids))
        if prompts is None:
            prompts = prompts_for(seed, requests)
        n = len(prompts)
        news = list(max_new) if isinstance(max_new, (list, tuple)) \
            else [int(max_new)] * n

        def transports(active):
            return [HTTPTransport(u, replica_id=by_url[u], timeout_s=120.0)
                    for u in active]

        def cfg(max_retries):
            return RouterConfig(max_retries=max_retries, refresh_s=0.1,
                                backoff_base_s=0.05, backoff_max_s=0.5,
                                seed=seed)

        def reset(active):
            for u in active:
                post(u, "/v1/counts", {"reset": True})

        def read(u, label):
            if counts is not None:
                counts.setdefault(label, {})[by_url[u]] = post(
                    u, "/v1/counts")

        def route(router):
            tickets = [router.submit(p, k) for p, k in zip(prompts, news)]
            return tickets

        # ---- wave 1: reference (no kill) — the parity oracle
        compiles_w0 = {u: compiles(u) for u in urls}
        reset(urls)
        router = Router(transports(urls), config=cfg(max_retries=3))
        t0 = time.monotonic()
        ref = [t.result(timeout=timeout_s) for t in route(router)]
        wall = time.monotonic() - t0
        w1_state = router.state()
        router.close()
        for u in urls:
            read(u, "reference")
        ref_ok = sum(1 for r in ref if r["ok"])
        w1 = {"wave": "reference", "ok": ref_ok, "total": n,
              "tokens": sum(len(r["tokens"]) for r in ref if r["ok"]),
              "wall_s": round(wall, 4)}
        if disagg:
            w1["handoffs"] = w1_state["disagg"]["handoffs"]
            w1["wire_bytes"] = w1_state["disagg"]["wire_bytes"]
        print(json.dumps(w1), file=out, flush=True)
        waves["reference"] = dict(w1, streams=[r["tokens"] if r["ok"]
                                               else None for r in ref])
        if ref_ok != n:
            bad = [(r["rid"], r.get("reason")) for r in ref if not r["ok"]]
            failures.append(f"reference wave incomplete: {ref_ok}/{n} {bad}")
            return failures, waves
        if disagg:
            if w1_state["disagg"]["handoffs"] == 0:
                postures = {r["replica_id"]: dict(r["posture"],
                                                  admissible=r["admissible"])
                            for r in w1_state["replicas"]}
                failures.append(
                    "disagg reference wave completed without a single KV "
                    f"handoff — the two-hop path never ran; the router "
                    f"saw {postures}")
            # the prefill tier is about to die: audit it now
            leak_audit(urls[0], rids[0], True, failures)
        ref_streams = [r["tokens"] for r in ref]

        # ---- wave 2: failover — SIGKILL mid-traffic + seeded
        # router_dispatch faults; every request must complete in parity
        survivors = urls[1:]
        compiles_before = {u: compiles(u) for u in survivors}
        plan = FaultPlan(seed=seed, faults={
            "router_dispatch": FaultSpec(rate=fault_rate)})
        reset(urls)
        router = Router(transports(urls), config=cfg(max_retries=4),
                        chaos=plan)
        tickets = route(router)
        victim = urls[0]
        wait_inflight([victim], deadline_s=30.0)
        read(victim, "failover")
        procs[0].send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        procs[0].wait(timeout=30)
        res = [t.result(timeout=timeout_s) for t in tickets]
        kill_to_done = time.monotonic() - t_kill
        state = router.state()
        router.close()
        ok = [r for r in res if r["ok"]]
        shed = [r for r in res if r.get("shed")]
        lost = [r["rid"] for r in res if not r["ok"] and not r.get("shed")]
        mismatch = [r["rid"] for i, r in enumerate(res)
                    if r["ok"] and not parity(i, r["tokens"],
                                              ref_streams[i])]
        failmoves = state["counters"]["failovers"]
        w2 = {"wave": "failover", "ok": len(ok), "shed": len(shed),
              "lost": lost, "parity_mismatch": mismatch,
              "failovers": failmoves,
              "retries": state["counters"]["retries"],
              "killed": by_url[victim],
              "kill_to_done_s": round(kill_to_done, 4)}
        if disagg:
            w2["handoffs"] = state["disagg"]["handoffs"]
            w2["handoff_failures"] = state["disagg"]["handoff_failures"]
        # one trace a failed-over request: the router's recorder joined
        # with the survivors' /debug/traces (the victim's ring died)
        asm = TraceAssembler()
        asm.add_recorder(router.trace)
        for u in survivors:
            try:
                asm.scrape(u, timeout=3.0)
            except Exception:   # noqa: BLE001 - audit is best-effort
                pass
        failed_over = [t for t in asm.assemble_all()
                       if any(s["name"] == "router/failover"
                              for s in t.spans)]
        w2["traced_failovers"] = len(failed_over)
        if failmoves and not failed_over:
            failures.append(
                f"router counted {failmoves} failovers but no assembled "
                f"trace carries a router/failover span")
        survivor_rids = {by_url[u] for u in survivors}
        for t in failed_over:
            if not ({s["replica"] for s in t.spans} & survivor_rids):
                failures.append(
                    f"failed-over trace {t.trace_id} has no survivor-side "
                    f"spans under the original trace id — the replay "
                    f"forked the trace")
        for u in survivors:
            leak_audit(u, by_url[u], disagg or block_size is not None,
                       failures)
            read(u, "failover")
        steady = {by_url[u]: compiles(u) - compiles_before[u]
                  for u in survivors}
        w2["steady_state_compiles"] = int(sum(steady.values()))
        print(json.dumps(w2), file=out, flush=True)
        waves["failover"] = dict(w2, streams=[r["tokens"] if r["ok"]
                                              else None for r in res])
        if lost:
            failures.append(f"failover wave lost rids: {lost}")
        if mismatch:
            failures.append(f"parity broken for rids: {mismatch}")
        if len(ok) + len(shed) != n:
            failures.append("failover wave accounting does not add up")
        if any(steady.values()) or any(compiles_w0.values()):
            failures.append(f"steady-state compiles on the survivors: "
                            f"{steady}")

        # ---- wave 3: no-failover baseline — the kill MUST hurt
        router = Router(transports(survivors), config=cfg(max_retries=0))
        tickets = route(router)
        victim = survivors[0]
        wait_inflight([victim], deadline_s=30.0)
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=30)
        res = [t.result(timeout=timeout_s) for t in tickets]
        router.close()
        base_lost = [r["rid"] for r in res
                     if not r["ok"] and not r.get("shed")]
        w3 = {"wave": "baseline_no_failover",
              "ok": sum(1 for r in res if r["ok"]),
              "shed": sum(1 for r in res if r.get("shed")),
              "lost": base_lost, "killed": by_url[victim]}
        print(json.dumps(w3), file=out, flush=True)
        waves["baseline_no_failover"] = w3
        if not base_lost:
            failures.append(
                "baseline (max_retries=0) lost nothing — the kill was not "
                "observed mid-flight; drill inconclusive")
        for i, p in enumerate(procs):
            if i > 1 and p.poll() is not None:
                failures.append(f"replica {rids[i]} died on its own "
                                f"(exit {p.returncode})")
        return failures, waves
    finally:
        stop(procs)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="kill-a-replica drill: exit 0 iff 100% completion + "
                    "parity + no leaks")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--fault-rate", type=float, default=0.1,
                    help="seeded router_dispatch fault rate for the "
                         "failover wave")
    ap.add_argument("--kill", choices=("replica", "prefill"),
                    default="replica",
                    help="replica: SIGKILL a monolithic replica; prefill: "
                         "1P+ND disaggregated, SIGKILL the prefill tier "
                         "mid-handoff")
    ap.add_argument("--fast", action="store_true",
                    help="3 replicas, fewer and shorter requests")
    ap.add_argument("--device", default=None,
                    help="the workers' device: cuda (the default) or cpu")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's CPU threads in each worker")
    args = ap.parse_args(argv)
    if args.fast:
        args.requests = min(args.requests, 8)
        args.max_new = min(args.max_new, 12)
    if args.replicas < 3:
        ap.error("the drill needs >= 3 replicas (one killed per chaos "
                 "wave, one survivor to finish the work)")
    if args.device != "cpu":
        # every worker loads the kernels the parent builds here, once
        from ..ops import _build
        _build.build_all()
    t0 = time.monotonic()
    failures, _ = run_drill(replicas=args.replicas, requests=args.requests,
                            max_new=args.max_new, seed=args.seed,
                            fault_rate=args.fault_rate, kill=args.kill,
                            device=args.device, threads=args.threads)
    print(json.dumps({"result": "PASS" if not failures else "FAIL",
                      "failures": failures,
                      "wall_s": round(time.monotonic() - t0, 1)}),
          flush=True)
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
