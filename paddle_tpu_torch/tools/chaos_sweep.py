"""Seeded chaos sweep over the port's serving engine (a port of the
reference's ``tools/chaos_sweep.py``): N seeds x fault sites, exit
non-zero on any leak, hang or parity break.

Every cell runs the SAME smoke workload on a hardened engine (bounded
retry + supervisor) under one armed fault site (plus an "all" cell
arming the mix), then checks what the resilience layer owes:

  * **no hang** — the drain finishes within a step budget;
  * **no leak** — every slot free afterwards, and on the paged pool a
    full ``check_conservation()`` audit passes;
  * **parity** — every completed request's stream is the unfaulted
    reference drain's (greedy replay stays exact through rollback,
    retry and supervisor restart);
  * **determinism** — the cell rerun at the same seed gives the same
    fault log and streams.

Every cell runs with the lock patrol armed (a lock-order or held-across-
dispatch finding fails it). Beside the site cells: speculative-decoding
cells on both pools and a disaggregated KV-handoff cell with payloads
corrupted in flight. The reference's extra cell that forces its Pallas
paged-decode kernel in interpret mode has no counterpart: on the card
every paged cell runs K4, on the CPU its plain version.

Output: one JSON line per cell and a summary line; exit 1 on any
failure.

    python -m paddle_tpu_torch.tools.chaos_sweep --device cpu --fast
    python -m paddle_tpu_torch.tools.chaos_sweep --device cpu --seeds 2
"""
import argparse
import copy
import json
import sys

import numpy as np

# the per-site arming each cell uses: rates high enough that every
# recovery path actually runs during a smoke drain
SITE_RATES = {
    "prefill_dispatch": 0.25,
    "chunk_dispatch": 0.25,
    "decode_dispatch": 0.10,
    "transfer": 0.10,
    "block_exhaustion": 0.15,
    "callback": 0.30,
    "step_latency": {"rate": 0.05, "latency_s": 0.001},
}
MAX_STEPS = 3000      # hang budget: a clean drain needs ~100 steps
CHUNK = 8


def workload(n_requests=16):
    rs = np.random.RandomState(5)
    lengths = rs.randint(3, 20, n_requests)
    return [(rs.randint(0, 97, (int(n),)).astype(np.int64),
             int(rs.randint(3, 8))) for n in lengths]


def drain(model, specs, paged, chaos=None, chunk=None, spec=False,
          device=None):
    """One engine drain; returns (streams, engine, steps, fault_log)."""
    from ..serving import ServingEngine
    eng = ServingEngine(
        model, device=device, num_slots=4, bucket_min=8, paged=paged,
        speculative=spec, prefill_chunk=chunk, chaos=chaos,
        max_dispatch_retries=3, supervisor_cooldown_s=0.0,
        health_audit_every=8)
    reqs = [eng.add_request(p, max_new_tokens=k,
                            on_token=lambda r, t: None)
            for p, k in specs]
    steps = 0
    while eng.step():
        steps += 1
        if steps > MAX_STEPS:
            return None, eng, steps, None   # hang
    streams = [list(r.generated) for r in reqs]
    log = eng.chaos.fault_log() if eng.chaos is not None else None
    return streams, eng, steps, log


def check_cell(site, seed, model, specs, reference, paged, chunk,
               spec=False, device=None):
    """Run one (site, seed) cell twice; returns a result dict with
    ok=False and a reason on any contract break."""
    from ..serving.resilience import FaultPlan
    faults = dict(SITE_RATES) if site == "all" \
        else {site: SITE_RATES[site]}

    def plan():
        return FaultPlan(seed=seed, faults=faults)

    out = {"site": site, "seed": seed, "paged": paged, "spec": spec,
           "ok": True}
    streams, eng, steps, log = drain(model, specs, paged, chaos=plan(),
                                     chunk=chunk, spec=spec, device=device)
    out["steps"] = steps
    if streams is None:
        return dict(out, ok=False, reason=f"hang: > {MAX_STEPS} steps")
    res = eng.metrics.snapshot()["resilience"]
    out["faults"] = res["faults_injected"]
    out["retries"] = res["dispatch_retries"]
    out["restarts"] = res["supervisor_restarts"]
    if eng.pool.free_count + len(eng.pool.quarantined) \
            != eng.pool.num_slots:
        return dict(out, ok=False, reason="slot leak after drain")
    if paged:
        try:
            eng.pool.check_conservation()
        except AssertionError as e:
            return dict(out, ok=False, reason=f"block conservation: {e}")
        if eng.pool.live_blocks > 0:
            return dict(out, ok=False, reason="live blocks at idle")
    bad = [i for i, (got, want) in enumerate(zip(streams, reference))
           if got and got != want]
    if bad:
        return dict(out, ok=False, reason=f"parity break on requests {bad}")
    incomplete = sum(1 for got, want in zip(streams, reference)
                     if got != want)
    out["incomplete"] = incomplete   # aborted after retries is allowed,
    if incomplete > len(specs) // 4:  # wholesale failure is not
        return dict(out, ok=False,
                    reason=f"{incomplete}/{len(specs)} incomplete")
    streams2, _, _, log2 = drain(model, specs, paged, chaos=plan(),
                                 chunk=chunk, spec=spec, device=device)
    if log2 != log:
        return dict(out, ok=False, reason="fault log not deterministic")
    if streams2 != streams:
        return dict(out, ok=False, reason="streams not deterministic")
    return out


def check_handoff_cell(seed, model, specs, reference, device=None):
    """Disaggregated KV-handoff cell: every request prefills on a
    prefill-role engine, crosses the wire as a serialized payload and
    decodes on a decode-role engine, with a seeded share of payloads
    corrupted in flight (a digest flip, a dropped frame, garbled
    base64). Corruption must raise the typed wire error without
    poisoning the decode pool (a clean retry of the same handoff
    succeeds, exact against the monolithic reference), both tiers end
    block-clean, and the same seed gives the same corruption schedule
    and streams."""
    from ..serving import ServingEngine
    from ..serving.kv_wire import KVWireError

    def corrupt(rs, payload):
        bad = copy.deepcopy(payload)
        kind = int(rs.randint(3))
        if kind == 0:
            f = bad["frames"][int(rs.randint(len(bad["frames"])))]
            f["digest"] = (f["digest"] + 1) % (1 << 32)
        elif kind == 1:
            bad["frames"].pop()
        else:
            bad["frames"][0]["k"] = "!!notb64"
        return bad

    def run_once():
        pe = ServingEngine(model, device=device, num_slots=4, bucket_min=8,
                           paged=True, role="prefill")
        de = ServingEngine(model, device=device, num_slots=4, bucket_min=8,
                           paged=True, role="decode")
        rs = np.random.RandomState(seed)
        streams, faults = [], 0
        try:
            for p, k in specs:
                req = pe.add_request(p, max_new_tokens=1, hold_kv=True)
                pe.run()
                payload = pe.export_kv(req.rid)
                if rs.rand() < 0.4:
                    faults += 1
                    try:
                        de.import_kv(corrupt(rs, payload),
                                     max_new_tokens=int(k))
                    except KVWireError:
                        pass
                    else:
                        return None, faults, \
                            "corrupted import did not raise KVWireError"
                dreq = de.import_kv(payload, max_new_tokens=int(k))
                de.run()
                streams.append(list(dreq.generated))
            for eng, tier in ((pe, "prefill"), (de, "decode")):
                if eng._held_exports:
                    return None, faults, f"held-export leak: {tier}"
                try:
                    eng.pool.check_conservation()
                except AssertionError as e:
                    return None, faults, f"{tier} block conservation: {e}"
                if eng.pool.live_blocks > 0:
                    return None, faults, f"live blocks at idle: {tier}"
        finally:
            pe.close()
            de.close()
        return streams, faults, None

    out = {"site": "kv_handoff", "seed": seed, "paged": True, "ok": True}
    streams, faults, reason = run_once()
    out["faults"] = {"kv_wire_corruption": faults}
    if reason:
        return dict(out, ok=False, reason=reason)
    bad = [i for i, (got, want) in enumerate(zip(streams, reference))
           if got != want]
    if bad:
        return dict(out, ok=False,
                    reason=f"handoff parity break on requests {bad}")
    streams2, faults2, reason2 = run_once()
    if reason2:
        return dict(out, ok=False, reason=f"rerun: {reason2}")
    if faults2 != faults:
        return dict(out, ok=False,
                    reason="corruption schedule not deterministic")
    if streams2 != streams:
        return dict(out, ok=False, reason="streams not deterministic")
    return out


def patrolled(check, *args, **kwargs):
    """Run one cell with the lock patrol armed: every seeded fault
    schedule doubles as a race/deadlock drill."""
    from ..analysis import lock_patrol
    with lock_patrol() as patrol:
        result = check(*args, **kwargs)
        findings = patrol.findings()
    if findings:
        patrol_json = [f.to_dict() for f in findings]
        if result.get("ok"):
            result = dict(result, ok=False, reason="lock patrol findings",
                          patrol=patrol_json)
        else:
            result = dict(result, patrol=patrol_json)
    return result


def main(argv=None, out=sys.stdout):
    from .replica_worker import build_model
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--fast", action="store_true",
                    help="one seed, a reduced site matrix")
    ap.add_argument("--paged", type=int, choices=(0, 1), default=None,
                    help="restrict to one pool")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    sites = ["prefill_dispatch", "decode_dispatch", "transfer", "callback",
             "block_exhaustion", "chunk_dispatch", "all"]
    seeds = [1] if args.fast else list(range(1, args.seeds + 1))
    if args.fast:
        sites = ["prefill_dispatch", "decode_dispatch", "chunk_dispatch",
                 "all"]
    pools = [False, True] if args.paged is None else [bool(args.paged)]
    dev = args.device

    model = build_model("tiny", 11, dev)
    specs = workload(12 if args.fast else 16)
    # one long prompt so chunk_dispatch cells chunk for real
    rs = np.random.RandomState(9)
    specs = specs + [(rs.randint(0, 97, (28,)).astype(np.int64), 4)]

    failures = cells = 0

    def emit(result):
        nonlocal failures, cells
        cells += 1
        print(json.dumps(result), file=out, flush=True)
        failures += not result["ok"]

    for paged in pools:
        reference, _, _, _ = drain(model, specs, paged, chunk=CHUNK,
                                   device=dev)
        assert reference is not None, "reference drain hung"
        for seed in seeds:
            for site in sites:
                if site == "block_exhaustion" and not paged:
                    continue   # the slot pool has no block economy
                emit(patrolled(check_cell, site, seed, model, specs,
                               reference, paged, CHUNK, device=dev))
    # speculative cells, both pools: decode faults hit the k-token verify
    # dispatches too, held against a speculative unfaulted reference
    spec_specs = [(p, k + 8) for p, k in specs]
    for paged in pools:
        reference, _, _, _ = drain(model, spec_specs, paged, chunk=CHUNK,
                                   spec=True, device=dev)
        assert reference is not None, "spec reference drain hung"
        for seed in seeds:
            emit(patrolled(check_cell, "decode_dispatch", seed, model,
                           spec_specs, reference, paged, CHUNK, spec=True,
                           device=dev))
    # the KV-handoff cells, paged pool only (the wire unit is the block)
    if True in pools:
        reference, _, _, _ = drain(model, specs, True, chunk=CHUNK,
                                   device=dev)
        assert reference is not None, "handoff reference drain hung"
        for seed in seeds:
            emit(patrolled(check_handoff_cell, seed, model, specs,
                           reference, device=dev))
    print(json.dumps({"summary": True, "cells": cells,
                      "failures": failures}), file=out, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
