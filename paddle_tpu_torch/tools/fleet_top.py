"""fleet_top — the fleet table of the port's serving replicas, one shot
or watched (a port of the reference's ``tools/fleet_top.py``).

Polls N serving replicas (their ``serve_metrics()`` surfaces) through
``paddle_tpu_torch.observability.fleet.FleetPoller`` and renders one row
per replica: availability verdict, health posture, queue depth, step
rate, goodput tokens, decode roofline fraction, staleness — plus the
fleet rollup line (census, bucket-wise-merged latency percentiles,
fleet-detector firings).

    python -m paddle_tpu_torch.tools.fleet_top 127.0.0.1:9100 127.0.0.1:9101
    python -m paddle_tpu_torch.tools.fleet_top --registry fleet.json \
        --watch 2

Exit code: 0 iff EVERY replica is up and healthy; 1 otherwise, naming the
offending replicas on stderr. ``--json`` dumps the pinned-schema
FleetSnapshot instead of the table. ``--router URL`` also scrapes a
router's ``/router/state`` and stamps a router line under the fleet line
(journal depth, shed/retry/failover/hedge totals, per-replica breaker
states). ``--traces`` also scrapes each target's ``/debug/traces`` ring
(and the router's ``/router/trace``), assembles the distributed traces
and renders one line per trace (window, unattributed gap, completeness).
``--tenants`` also renders the federated per-tenant attribution table
plus the noisy_neighbor / tenant_starvation detector state.
"""
import argparse
import json
import sys
import time

_COLS = (
    ("REPLICA", 18), ("VERDICT", 8), ("POSTURE", 9), ("RESTARTS", 9),
    ("QUEUE", 6), ("STEP/S", 8), ("GOODPUT", 9), ("ROOFLINE", 9),
    ("AGE_S", 7), ("UPTIME_S", 9),
)


def _fmt(v, nd=1):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _posture(e):
    if e["verdict"] != "up":
        return e["verdict"]
    if e["draining"]:
        return "draining"
    if e["degraded"]:
        return "degraded"
    if e["healthy"] is False:
        return "unhealthy"
    return "healthy" if e["healthy"] else "?"


def render(snap, out=None):
    out = out or sys.stdout
    line = "  ".join(f"{name:<{w}}" for name, w in _COLS)
    print(line, file=out)
    print("-" * len(line), file=out)
    for rid, e in sorted(snap["replicas"].items()):
        cells = (
            rid[:18], e["verdict"], _posture(e),
            _fmt(e["restarts"]), _fmt(e["queue_depth"]),
            _fmt(e["step_rate"]), _fmt(e["goodput_tokens"], 0),
            _fmt(e["roofline_fraction"], 3), _fmt(e["age_s"]),
            _fmt(e["uptime_s"]),
        )
        print("  ".join(f"{str(c):<{w}}" for c, (_, w)
                        in zip(cells, _COLS)), file=out)
    f = snap["fleet"]
    lat = f["latency"]["ttft"]
    print(f"fleet: {f['up']}/{f['size']} up ({f['stale']} stale, "
          f"{f['down']} down)  queue={_fmt(f['queue_depth'], 0)}  "
          f"step_rate={_fmt(f['step_rate'])}/s  "
          f"goodput_tokens={_fmt(f['goodput_tokens'], 0)}  "
          f"ttft_p50={_fmt(lat['p50_ms'])}ms "
          f"p99={_fmt(lat['p99_ms'])}ms  "
          f"anomalies={snap['health']['anomalies_total']}", file=out)


def fetch_router_state(url, timeout=2.0):
    """GET ``/router/state`` off a router's metrics server; None when
    unreachable (the fleet table still renders)."""
    import urllib.request
    url = url.rstrip("/")
    if "://" not in url:
        url = "http://" + url
    try:
        with urllib.request.urlopen(url + "/router/state",
                                    timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except Exception:   # noqa: BLE001 - best-effort stamp
        return None


def render_router(state, out=None):
    out = out or sys.stdout
    if state is None:
        print("router: unreachable", file=out)
        return
    c = state["counters"]
    breakers = ", ".join(
        f"{r['replica_id']}={r['breaker']['state']}"
        for r in state["replicas"])
    print(f"router: journal={state['journal_depth']}  "
          f"ok={c['ok']} err={c['error']} shed={c['shed']}  "
          f"retries={c['retries']} failovers={c['failovers']} "
          f"hedges={c['hedges']}  breakers[{breakers}]", file=out)


def fetch_fleet_traces(targets, router=None, timeout=2.0):
    """Assemble distributed traces off the fleet's ``/debug/traces``
    rings (plus the router's ``/router/trace``) — best-effort; an
    unreachable replica just contributes no spans, so a partial trace
    renders with its missing segments named instead of hiding."""
    from ..observability.trace import TraceAssembler
    asm = TraceAssembler()
    scraped = 0
    urls = list(targets)
    if router:
        url = router.rstrip("/")
        if "://" not in url:
            url = "http://" + url
        urls.append(url + "/router/trace")
    for u in urls:
        try:
            asm.scrape(u, timeout=timeout)
            scraped += 1
        except Exception:   # noqa: BLE001 - best-effort stamp
            pass
    return asm.assemble_all() if scraped else []


def render_traces(traces, out=None, limit=8):
    out = out or sys.stdout
    if not traces:
        print("traces: none assembled", file=out)
        return
    print(f"traces: {len(traces)} assembled "
          f"(newest {min(limit, len(traces))})", file=out)
    for t in traces[-limit:]:
        status = "complete" if t.complete else \
            "missing:" + ",".join(t.missing_segments())
        print(f"  {t.trace_id[:16]}  "
              f"replicas={','.join(t.replicas)}  "
              f"window={_fmt(t.window_ms())}ms  "
              f"gap={_fmt(t.unattributed_ms())}ms  {status}",
              file=out)


def render_tenants(doc, out=None, limit=8):
    """One line per tenant off the poller's federated rollup, biggest
    token consumer first, plus the fairness detectors' verdicts."""
    out = out or sys.stdout
    fleet = (doc or {}).get("fleet")
    if not fleet:
        print("tenants: no tenant series reported", file=out)
        return
    rows = fleet["tenants"]
    print(f"tenants: {fleet['tenant_count']} "
          f"(folded={fleet['overflow_folded']}, showing "
          f"{min(limit, len(rows))})", file=out)
    for name, e in list(rows.items())[:limit]:
        print(f"  {name[:20]:<20} tokens={_fmt(e['tokens_out'], 0)}  "
              f"share={_fmt(e['token_share'], 3)}  "
              f"req={_fmt(e['requests'], 0)}  "
              f"attain={_fmt(e['attainment'], 3)}  "
              f"queued={_fmt(e['queued'], 0)}", file=out)
    for name, verdict in sorted((doc.get("last_verdicts")
                                 or {}).items()):
        print(f"  ! {name}: {verdict.get('reason', '?')}", file=out)


def verdict_exit(snap, out=None):
    """0 iff all replicas up and healthy; else 1, naming offenders."""
    out = out or sys.stderr
    bad = {rid: e for rid, e in snap["replicas"].items()
           if e["verdict"] != "up" or e["healthy"] is not True
           or e["degraded"] or e["draining"]}
    if not bad and snap["fleet"]["healthy"]:
        return 0
    for rid, e in sorted(bad.items()):
        print(f"UNHEALTHY: {rid} verdict={e['verdict']} "
              f"posture={_posture(e)} "
              f"last_error={e['last_error'] or '-'}", file=out)
    if not bad:
        print("UNHEALTHY: fleet-level verdict false", file=out)
    return 1


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="render the serving-fleet table; exit 0 iff all "
                    "replicas are up and healthy")
    parser.add_argument("targets", nargs="*",
                        help="replica scrape targets (host:port or "
                             "http://host:port)")
    parser.add_argument("--registry", default=None,
                        help="JSON registry file ({'replicas': "
                             "[{'id','url'}|'host:port', ...]})")
    parser.add_argument("--interval", type=float, default=1.0,
                        help="poll interval seconds (watch mode; also "
                             "spaces the two one-shot polls)")
    parser.add_argument("--timeout", type=float, default=1.0,
                        help="per-replica scrape timeout seconds")
    parser.add_argument("--down-after", type=int, default=1,
                        help="consecutive failures before a replica "
                             "is marked down (one-shot default 1: an "
                             "unreachable replica IS down)")
    parser.add_argument("--polls", type=int, default=2,
                        help="one-shot poll count (>=2 gives step "
                             "rates)")
    parser.add_argument("--watch", type=float, default=None,
                        metavar="SECS",
                        help="keep polling and re-rendering every "
                             "SECS until interrupted")
    parser.add_argument("--json", action="store_true",
                        help="dump the FleetSnapshot JSON instead of "
                             "the table")
    parser.add_argument("--router", default=None, metavar="URL",
                        help="also scrape a router's /router/state "
                             "and stamp its line (journal, breaker "
                             "states, dispatch counters)")
    parser.add_argument("--traces", action="store_true",
                        help="also assemble distributed traces off "
                             "the targets' /debug/traces rings (and "
                             "the router's /router/trace when "
                             "--router is given) and render one line "
                             "per trace")
    parser.add_argument("--tenants", action="store_true",
                        help="also render the federated per-tenant "
                             "attribution table and the fairness "
                             "detectors' state")
    args = parser.parse_args(argv)
    if not args.targets and not args.registry:
        parser.error("give targets or --registry")

    from ..observability.fleet import FleetPoller
    kw = dict(interval_s=args.interval, timeout_s=args.timeout,
              down_after=args.down_after)
    poller = FleetPoller.from_registry(args.registry, **kw) \
        if args.registry else FleetPoller(args.targets, **kw)

    if args.watch:
        try:
            while True:
                poller.poll_once()
                snap = poller.snapshot()
                print(f"\n== fleet_top {time.strftime('%H:%M:%S')} ==")
                render(snap)
                if args.router:
                    render_router(fetch_router_state(args.router))
                if args.traces:
                    render_traces(fetch_fleet_traces(
                        args.targets, router=args.router,
                        timeout=args.timeout))
                if args.tenants:
                    render_tenants(poller.fleet_tenants())
                sys.stdout.flush()
                time.sleep(args.watch)
        except KeyboardInterrupt:
            return verdict_exit(poller.snapshot())

    for i in range(max(1, args.polls)):
        if i:
            time.sleep(min(args.interval, 0.5))
        poller.poll_once()
    snap = poller.snapshot()
    router_state = fetch_router_state(args.router) \
        if args.router else None
    traces = fetch_fleet_traces(args.targets, router=args.router,
                                timeout=args.timeout) \
        if args.traces else None
    tenants = poller.fleet_tenants() if args.tenants else None
    if args.json:
        if args.router:
            snap = dict(snap, router=router_state)
        if traces is not None:
            snap = dict(snap, traces=[t.as_dict() for t in traces])
        if tenants is not None:
            snap = dict(snap, tenants=tenants)
        print(json.dumps(snap, indent=1, sort_keys=True, default=str))
    else:
        render(snap)
        if args.router:
            render_router(router_state)
        if traces is not None:
            render_traces(traces)
        if tenants is not None:
            render_tenants(tenants)
    return verdict_exit(snap)


if __name__ == "__main__":
    sys.exit(main())
