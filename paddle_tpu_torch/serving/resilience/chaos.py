"""Deterministic, seeded fault injection for the serving engine (a
port of ``paddle_tpu/serving/resilience/chaos.py``).

Recovery code that is never exercised is recovery code that does not
work: the engine's rollback / retry / quarantine / supervisor paths
only run when something fails, and production failures are rare,
unseeded and unreproducible. This module makes failure a first-class,
REPLAYABLE input: a :class:`FaultPlan` names the fault sites to arm
and the per-site rates, and a :class:`FaultInjector` built from it
decides — deterministically, from ``(seed, site, check index)`` alone
— whether the i-th crossing of each seam fails. Two runs with the
same plan produce the SAME fault schedule, and the port's injector
gives the reference's schedule bit for bit (each site draws from
``random.Random(f"{seed}:{site}")``).

Fault sites are the engine's REAL seams (the injector raises exactly
where a production failure would surface, before the device call):

``prefill_dispatch``    a grouped/paged prefill dispatch raises
``chunk_dispatch``      a chunked-prefill chunk dispatch raises
``decode_dispatch``     the pooled decode dispatch raises
``transfer``            a device->host readback (harvest sync) raises
``step_latency``        one step stalls ``latency_s`` (spike fodder)
``block_exhaustion``    paged-pool admission sees a dry pool
``compile_storm``       the reference evicts a compiled program; the
                        port draws here where it reuses a built
                        program (so the draws stay aligned) and
                        evicts nothing
``callback``            a user ``on_token`` callback raises

Off by default: ``ServingConfig(chaos=...)`` takes a FaultPlan / seed /
dict. The reference's ``PADDLE_CHAOS`` environment gate has no
counterpart: the port reads no environment.

Every fire is counted (``serving_faults_injected_total{site}``),
marker-spanned (``chaos/<site>`` in the chrome timeline) and appended
to the injector's fault log — a chaos run is fully attributable.
"""
import random

# every seam the engine exposes to the injector, in documentation
# order; ``router_dispatch`` is the fleet router's seam (a dispatch to
# a replica fails before it leaves the router — the retry/failover/
# breaker path's chaos input), checked by Router, not the engine
FAULT_SITES = (
    "prefill_dispatch", "chunk_dispatch", "decode_dispatch",
    "transfer", "step_latency", "block_exhaustion", "compile_storm",
    "callback", "router_dispatch",
)

# the default plan: dispatch/transfer/callback faults at
# a rate the retry budget comfortably absorbs, mild latency spikes,
# occasional admission droughts; compile storms stay OPT-IN (they
# deliberately violate the steady-state compile invariant)
DEFAULT_RATES = {
    "prefill_dispatch": 0.05,
    "chunk_dispatch": 0.05,
    "decode_dispatch": 0.02,
    "transfer": 0.02,
    "step_latency": 0.01,
    "block_exhaustion": 0.02,
    "compile_storm": 0.0,
    "callback": 0.05,
    # router-level faults stay OPT-IN: the default plan targets
    # one engine; arming the router seam is the router drill's call
    "router_dispatch": 0.0,
}


class InjectedFault(RuntimeError):
    """An injected failure crossing a fault site. Carries ``site`` so
    handlers (and tests) can tell chaos from organic failures."""

    def __init__(self, site, detail=""):
        super().__init__(f"injected fault at {site}"
                         + (f": {detail}" if detail else ""))
        self.site = str(site)


class FaultSpec:
    """One site's arming: ``rate`` is the per-check fire probability;
    ``after`` skips the first N checks (arm the k-th crossing exactly
    with ``after=k-1, rate=1.0, max_fires=1`` — the chunk-boundary
    rollback tests do); ``max_fires`` bounds total fires (None =
    unbounded); ``latency_s`` is the stall width for ``step_latency``."""

    __slots__ = ("rate", "after", "max_fires", "latency_s")

    def __init__(self, rate=0.0, after=0, max_fires=None,
                 latency_s=0.02):
        self.rate = float(rate)
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.after = int(after)
        self.max_fires = None if max_fires is None else int(max_fires)
        self.latency_s = float(latency_s)

    def as_dict(self):
        return {"rate": self.rate, "after": self.after,
                "max_fires": self.max_fires,
                "latency_s": self.latency_s}


class FaultPlan:
    """A seeded chaos schedule: ``faults`` maps site -> FaultSpec (or
    a bare rate, or a kwargs dict). ``faults=None`` arms every site at
    its DEFAULT_RATES rate. The plan is pure data — build one injector
    per engine from it (injectors carry run state; plans are reusable
    across runs and embeddable in incident bundles)."""

    def __init__(self, seed=0, faults=None):
        self.seed = int(seed)
        if faults is None:
            faults = dict(DEFAULT_RATES)
        specs = {}
        for site, spec in faults.items():
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; sites: {FAULT_SITES}")
            if isinstance(spec, FaultSpec):
                specs[site] = spec
            elif isinstance(spec, dict):
                specs[site] = FaultSpec(**spec)
            else:
                specs[site] = FaultSpec(rate=spec)
        self.faults = specs

    def as_dict(self):
        """JSON-safe plan (the incident bundle's replay recipe)."""
        return {"seed": self.seed,
                "faults": {s: sp.as_dict()
                           for s, sp in sorted(self.faults.items())}}


def resolve_chaos(chaos):
    """ServingConfig's ``chaos=`` knob -> a FaultInjector or None.

    ``None`` or ``False`` is off; a FaultInjector is used as it is; a
    FaultPlan / int seed / ``{seed, faults}`` dict arms explicitly."""
    if chaos is None or chaos is False:
        return None
    if isinstance(chaos, FaultInjector):
        return chaos
    if isinstance(chaos, FaultPlan):
        return FaultInjector(chaos)
    if isinstance(chaos, int) and not isinstance(chaos, bool):
        return FaultInjector(FaultPlan(seed=chaos))
    if isinstance(chaos, dict):
        return FaultInjector(FaultPlan(**chaos))
    raise ValueError(
        f"chaos must be None/False, a FaultPlan, an int seed, or a "
        f"{{seed, faults}} dict, got {chaos!r}")


class FaultInjector:
    """Runtime fault decisions + the attributable fault log.

    Each site draws from its OWN ``random.Random(f"{seed}:{site}")``
    stream indexed purely by that site's check count, so the decision
    for the i-th crossing of a seam depends on nothing but the plan —
    not on other sites, wall time, or interleaving. That independence
    is what makes the fault log (and therefore the whole chaos run)
    reproducible from the seed alone.

    ``on_fire(site)`` is the metrics hook (the engine wires the
    ``serving_faults_injected_total{site}`` counter); ``recorder``
    receives a ``chaos/<site>`` marker span per fire (default: the
    process-global host-span recorder, so fires land in the chrome
    timeline next to the step that absorbed them).
    """

    MAX_LOG = 100_000   # full-log determinism diffing, still bounded

    def __init__(self, plan, on_fire=None, recorder=None):
        self.plan = plan
        self._on_fire = on_fire
        self._recorder = recorder
        self._rng = {s: random.Random(f"{plan.seed}:{s}")
                     for s in plan.faults}
        self._checks = {s: 0 for s in plan.faults}
        self._fires = {s: 0 for s in plan.faults}
        self._log = []

    def bind(self, on_fire=None, recorder=None):
        """Late wiring (the engine attaches its metrics/recorder after
        construction when a pre-built injector is passed in)."""
        if on_fire is not None:
            self._on_fire = on_fire
        if recorder is not None:
            self._recorder = recorder

    def fires(self, site, **ctx):
        """Decide the next crossing of ``site``; True = inject. Logs
        and counts every fire with its check index plus the caller's
        context (step id, rid, ...)."""
        spec = self.plan.faults.get(site)
        if spec is None or spec.rate <= 0.0:
            return False
        self._checks[site] += 1
        check = self._checks[site]
        if check <= spec.after:
            return False
        if spec.max_fires is not None \
                and self._fires[site] >= spec.max_fires:
            return False
        # the draw happens for every armed post-`after` check, so the
        # stream index == check index and the decision is reproducible
        if self._rng[site].random() >= spec.rate:
            return False
        self._fires[site] += 1
        if len(self._log) < self.MAX_LOG:
            self._log.append(dict(
                {"site": site, "fire": self._fires[site],
                 "check": check}, **ctx))
        if self._on_fire is not None:
            self._on_fire(site)
        if self._recorder is not None:
            import time
            self._recorder.record(f"chaos/{site}", time.perf_counter(),
                                  0.0, args=dict({"check": check}, **ctx))
        return True

    def maybe_raise(self, site, **ctx):
        """Raise InjectedFault when the next crossing of ``site``
        fires — the dispatch/transfer/callback seams' entry point."""
        if self.fires(site, **ctx):
            raise InjectedFault(site, detail=str(ctx) if ctx else "")

    def latency_s(self, site="step_latency"):
        spec = self.plan.faults.get(site)
        return spec.latency_s if spec is not None else 0.0

    # ------------------------------------------------------- reporting
    @property
    def total_fires(self):
        return sum(self._fires.values())

    def fault_log(self):
        """The full (bounded) fire log — the determinism contract's
        comparison surface and the incident bundle's fault history."""
        return [dict(e) for e in self._log]

    def report(self):
        """JSON-safe summary for snapshot()["resilience"]["chaos"] and
        incident bundles: the plan (replay recipe), per-site
        check/fire counts, and the log tail."""
        return {
            "enabled": True,
            "plan": self.plan.as_dict(),
            "sites": {s: {"checks": self._checks[s],
                          "fires": self._fires[s]}
                      for s in sorted(self.plan.faults)},
            "fires_total": self.total_fires,
            "fault_log_tail": self.fault_log()[-40:],
        }
