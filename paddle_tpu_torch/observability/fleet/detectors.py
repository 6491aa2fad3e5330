"""Fleet-level anomaly detectors over the poller's rollup rows (a copy
of ``paddle_tpu/observability/fleet/detectors.py``).

Same framework as the engine detectors
(``health.detectors.register_detector``), different scope and row
vocabulary: these are registered under ``scope="fleet"`` and evaluate
ONE row per completed poll cycle (see ``poller.FleetPoller._fleet_row``
— ``step`` is the poll sequence number, so the shared ``Detector``
base and ledger machinery apply unchanged). Engine detectors judge
one replica's steps; these judge the fleet's SHAPE:

``replica_flap``
    a replica's availability verdict changed — ``up``→``down`` (the
    router must stop dispatching there NOW) or ``down``→``up``
    (readmission; rapid alternation is the classic flapping replica a
    human should look at). Fires once per transition, naming the
    replicas and directions.
``fleet_goodput_collapse``
    the FLEET's SLO-met tokens/sec falling off a cliff between
    adjacent poll windows while work is pending — the every-replica-
    degraded-at-once signature (shared dependency died, overload
    breached every replica simultaneously) that no single replica's
    own goodput_collapse detector can distinguish from its neighbors'.
``load_skew``
    sustained queue-depth imbalance across UP replicas (max far above
    the fleet mean while the mean shows real load): the
    dispatch-layer-is-broken signature — one replica drowning while
    its peers idle means routing, not capacity, is the problem.
``noisy_neighbor``
    one tenant dominating the fleet's generated tokens over a poll
    window WHILE the other tenants' SLO attainment over the same
    window is poor — capacity is being monopolized at the victims'
    expense. Judged from the per-tenant deltas in ``row["tenants"]``
    (exact fleet counter sums differenced between cycles).
``tenant_starvation``
    a tenant with work QUEUED somewhere gets zero admissions for
    ``sustain`` consecutive polls while OTHER tenants keep getting
    admitted — the fairness inverse of noisy_neighbor: not slow
    service, no service.
"""
import collections

from ..health.detectors import Detector, register_detector

__all__ = ["ReplicaFlap", "FleetGoodputCollapse", "LoadSkew",
           "NoisyNeighbor", "TenantStarvation"]


@register_detector("replica_flap", scope="fleet")
class ReplicaFlap(Detector):
    """Fires on any availability transition involving ``down``:
    ``up/stale``→``down`` (lost) and ``down``→``up`` (readmitted).
    Transitions appear in exactly one poll row, so each change fires
    exactly once."""

    def observe(self, row, ledger):
        flaps = [t for t in row.get("transitions", ())
                 if t["to"] == "down" or t["from"] == "down"]
        if not flaps:
            return None
        names = ", ".join(f"{t['replica']}:{t['from']}->{t['to']}"
                          for t in flaps)
        return self._verdict(
            row, f"replica availability changed: {names}",
            replicas=[t["replica"] for t in flaps],
            transitions=[dict(t) for t in flaps],
            down=int(row.get("down", 0)))


@register_detector("fleet_goodput_collapse", scope="fleet")
class FleetGoodputCollapse(Detector):
    """Fleet-aggregate SLO-met tokens/sec cliff between adjacent
    ``window``-poll windows: previous window healthy (>=
    ``healthy_frac`` of the best windowed rate seen), current window
    below ``drop_frac`` of it, work still pending somewhere in the
    fleet. Inert while no replica reports goodput (no SLO targets
    configured fleet-wide)."""

    def __init__(self, window=8, drop_frac=0.1, healthy_frac=0.5):
        self.window = int(window)
        self.drop_frac = float(drop_frac)
        self.healthy_frac = float(healthy_frac)
        self._rows = collections.deque(maxlen=2 * self.window)
        self._peak = 0.0

    @staticmethod
    def _rate(seg):
        dt = sum(d for _, d in seg)
        good = sum(g for g, _ in seg)
        return good / dt if dt > 0 else 0.0

    def observe(self, row, ledger):
        self._rows.append((float(row.get("goodput_delta", 0.0)),
                           float(row.get("dt_s", 0.0))))
        if len(self._rows) < 2 * self.window:
            return None
        rows = list(self._rows)
        prev = self._rate(rows[:self.window])
        cur = self._rate(rows[self.window:])
        if prev > 0:
            self._peak = max(self._peak, prev)
        if (row.get("work_pending")
                and self._peak > 0
                and prev >= self.healthy_frac * self._peak
                and cur < self.drop_frac * prev):
            self._rows.clear()
            return self._verdict(
                row,
                f"fleet goodput {cur:.1f} tok/s collapsed from "
                f"{prev:.1f} tok/s",
                window_polls=self.window,
                previous_rate_tps=round(prev, 3),
                current_rate_tps=round(cur, 3),
                peak_rate_tps=round(self._peak, 3))
        return None


@register_detector("load_skew", scope="fleet")
class LoadSkew(Detector):
    """Queue-depth imbalance across UP replicas, sustained for
    ``sustain`` consecutive polls: the worst replica holds >=
    ``min_depth`` queued requests AND >= ``skew_factor`` x (its
    PEERS' mean depth + 1). Judging the worst against its peers (not
    the fleet mean, which the worst itself dominates on small fleets
    — with N replicas max/mean is bounded by N) makes the
    one-replica-drowning-while-peers-idle signature detectable at any
    fleet size >= ``min_replicas``. The absolute ``min_depth`` floor
    keeps an idle fleet's zero-vs-one jitter quiet. Fires once per
    episode; re-arms when balance returns."""

    def __init__(self, skew_factor=4.0, min_depth=6, sustain=3,
                 min_replicas=2):
        self.skew_factor = float(skew_factor)
        self.min_depth = int(min_depth)
        self.sustain = int(sustain)
        self.min_replicas = int(min_replicas)
        self._streak = 0
        self._fired = False

    def observe(self, row, ledger):
        depths = row.get("queue_depths") or {}
        if len(depths) < self.min_replicas:
            self._streak = 0
            self._fired = False
            return None
        worst = max(depths, key=lambda r: depths[r])
        peers = [v for r, v in depths.items() if r != worst]
        peer_mean = sum(peers) / len(peers)
        skewed = (depths[worst] >= self.min_depth
                  and depths[worst]
                  >= self.skew_factor * (peer_mean + 1.0))
        if not skewed:
            self._streak = 0
            self._fired = False
            return None
        self._streak += 1
        if self._streak >= self.sustain and not self._fired:
            self._fired = True
            return self._verdict(
                row,
                f"queue skew: {worst} holds {depths[worst]} queued vs "
                f"peer mean {peer_mean:.1f}",
                replica=worst,
                max_queue_depth=int(depths[worst]),
                peer_mean_queue_depth=round(peer_mean, 2),
                polls_skewed=self._streak)
        return None


@register_detector("noisy_neighbor", scope="fleet")
class NoisyNeighbor(Detector):
    """One tenant's generated-token share over the last ``window``
    polls >= ``share_frac`` of the fleet total WHILE the OTHER
    tenants' SLO attainment over the same window (their summed
    attained / summed completions+violations) is below
    ``attain_floor``. Both halves must hold: a tenant dominating an
    otherwise-healthy fleet is just the biggest customer, and poor
    fleet-wide attainment without a dominant tenant is overload, not
    a neighbor problem. Volume gates (``min_tokens`` window tokens,
    ``min_victim_judged`` victim verdicts) keep idle/cold windows
    quiet. Fires once per episode; re-arms when either half clears."""

    def __init__(self, window=8, share_frac=0.6, attain_floor=0.5,
                 min_tokens=100, min_victim_judged=3):
        self.window = int(window)
        self.share_frac = float(share_frac)
        self.attain_floor = float(attain_floor)
        self.min_tokens = float(min_tokens)
        self.min_victim_judged = float(min_victim_judged)
        self._rows = collections.deque(maxlen=self.window)
        self._fired = False

    def observe(self, row, ledger):
        self._rows.append(row.get("tenants") or {})
        if len(self._rows) < self.window:
            return None
        tokens, attained, judged = {}, {}, {}
        for facts in self._rows:
            for t, f in facts.items():
                tokens[t] = tokens.get(t, 0.0) \
                    + (f.get("tokens_delta") or 0.0)
                att = f.get("attained_delta") or 0.0
                attained[t] = attained.get(t, 0.0) + att
                judged[t] = judged.get(t, 0.0) + att \
                    + (f.get("violated_delta") or 0.0)
        total = sum(tokens.values())
        if total < self.min_tokens or len(tokens) < 2:
            self._fired = False
            return None
        top = max(tokens, key=lambda t: (tokens[t], t))
        share = tokens[top] / total
        victim_judged = sum(v for t, v in judged.items() if t != top)
        if victim_judged < self.min_victim_judged:
            self._fired = False
            return None
        victim_attain = sum(
            v for t, v in attained.items() if t != top) / victim_judged
        noisy = (share >= self.share_frac
                 and victim_attain < self.attain_floor)
        if not noisy:
            self._fired = False
            return None
        if self._fired:
            return None
        self._fired = True
        return self._verdict(
            row,
            f"tenant {top} holds {share:.0%} of fleet tokens over "
            f"{self.window} polls while other tenants attain "
            f"{victim_attain:.0%}",
            tenant=top,
            token_share=round(share, 4),
            victim_attainment=round(victim_attain, 4),
            window_polls=self.window,
            window_tokens=round(total, 1))


@register_detector("tenant_starvation", scope="fleet")
class TenantStarvation(Detector):
    """A tenant with queued work admitted NOWHERE for ``sustain``
    consecutive polls while other tenants' admissions kept flowing.
    Per-tenant streaks (several tenants can starve at once, each
    fires on its own schedule); a poll with zero fleet-wide
    admissions resets nothing — an idle or wedged fleet is a
    different detector's problem, starvation is specifically unfair
    SHARING of admissions that are happening."""

    def __init__(self, sustain=3, min_queued=1):
        self.sustain = int(sustain)
        self.min_queued = int(min_queued)
        self._streaks = {}
        self._fired = set()

    def observe(self, row, ledger):
        facts = row.get("tenants") or {}
        total_adm = sum((f.get("requests_delta") or 0.0)
                        for f in facts.values())
        for t in list(self._streaks):
            if t not in facts:
                self._streaks.pop(t, None)
                self._fired.discard(t)
        for t, f in sorted(facts.items()):
            own_adm = f.get("requests_delta") or 0.0
            queued = f.get("queued") or 0
            if own_adm > 0 or queued < self.min_queued:
                self._streaks.pop(t, None)
                self._fired.discard(t)
                continue
            if total_adm - own_adm <= 0:
                # nobody got admitted: the fleet is idle/wedged, not
                # unfair — hold the streak, don't grow it
                continue
            streak = self._streaks.get(t, 0) + 1
            self._streaks[t] = streak
            if streak >= self.sustain and t not in self._fired:
                self._fired.add(t)
                return self._verdict(
                    row,
                    f"tenant {t} starved: {queued} queued, zero "
                    f"admissions for {streak} polls while peers "
                    f"admitted {total_adm:.0f}",
                    tenant=t,
                    queued=int(queued),
                    polls_starved=streak,
                    peer_admissions=round(total_adm, 1))
        return None
