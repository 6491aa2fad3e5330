"""Self-healing engine supervisor: health verdicts -> in-process
restart -> replayed in-flight requests (a copy of
``paddle_tpu/serving/resilience/supervisor.py``).

The health observatory gives every engine a verdict; the supervisor
acts on the ones that mean "the step loop cannot make progress from
here" (a wedged queue, a leaking pool, a dispatch that fails every
retry). Its one move is an in-process restart —
``ServingEngine._supervisor_restart``: replace the pool with a fresh
one (on the paged pool, its radix index too), rebuild the serving
programs, reset the device-side token/position state, and re-queue
every in-flight request for re-prefill of its prompt PLUS the tokens it
already emitted (greedy decoding makes the replay bit-exact).

Truthfulness to the router is the other half: from the moment of
restart until every replayed request completes the engine reports
``degraded: true`` (and ``healthy: false``) on ``/debug/health``; when
the replay set drains the supervisor marks the monitor's outstanding
anomalies RESOLVED and — if warmup had been declared — re-declares it.
``supervisor_restarts_total`` counts every recovery; ``max_restarts``
bounds the crash-loop (a persistently failing engine must eventually
surface the raw error, not restart forever); ``cooldown_s`` debounces
back-to-back verdicts about the same episode.
"""
import time
import weakref

# detector verdicts that warrant a restart: the wedge signatures.
# step_time_spike / goodput_collapse are performance anomalies (capture
# an incident, page a human); steady_state_compile is an attribution
# alarm — none of them are fixed by rebuilding state, so none restart.
RESTART_ON = ("queue_stall", "kv_block_leak", "dispatch_failure")


class EngineSupervisor:
    """Per-engine recovery orchestrator.

    ``consider(verdicts)`` is fed every step's detector firings by the
    engine's health tick; ``trigger(reason)`` is the engine-internal
    escalation path (the bounded-retry machinery calls it when a
    dispatch keeps failing past its budget). Both funnel into one
    guarded ``restart``.
    """

    def __init__(self, engine, restart_on=RESTART_ON, max_restarts=8,
                 cooldown_s=1.0, clock=time.perf_counter):
        # weak back-edge: the engine owns the supervisor; a strong
        # reference here would make every dead engine a GC cycle whose
        # gen-2 collection pauses land inside some OTHER engine's
        # timed steps
        self._engine_ref = weakref.ref(engine)
        self.restart_on = tuple(restart_on)
        self.max_restarts = int(max_restarts)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.restarts = 0
        self.gave_up = False
        self._last_restart_t = None
        self._last = None          # {"reason", "step", "requeued", ...}
        self._awaiting = set()     # rids replaying since the restart
        self._was_warmed = False

    @property
    def engine(self):
        return self._engine_ref()

    # -------------------------------------------------------- triggers
    def consider(self, verdicts):
        """React to this step's detector firings (at most one restart
        per step — the first qualifying verdict wins; the rest
        described the same wedge)."""
        for v in verdicts or ():
            if v.get("detector") in self.restart_on:
                return self.restart(v["detector"], verdict=v)
        return False

    def trigger(self, reason, detail=None):
        """Engine-internal escalation (repeated dispatch failure past
        the retry budget). Returns True when a restart ran — the
        caller swallows the failure; False means the supervisor is
        exhausted/cooling and the caller must re-raise."""
        return self.restart(reason, verdict=detail)

    # --------------------------------------------------------- restart
    def restart(self, reason, verdict=None):
        if self.engine is None:
            return False
        now = self._clock()
        if self.restarts >= self.max_restarts:
            self.gave_up = True
            return False
        if self._last_restart_t is not None \
                and now - self._last_restart_t < self.cooldown_s:
            return False
        self._last_restart_t = now
        self.restarts += 1
        self._was_warmed = self.engine.watchdog.warmed
        requeued = self.engine._supervisor_restart(reason)
        # recovery is proven by OUTCOMES, not by the restart itself:
        # stay degraded until everything pending at restart time —
        # replayed in-flight requests AND the queued work the wedge
        # was starving — actually completes. A restart that fails to
        # unwedge keeps reporting degraded/unhealthy, truthfully.
        self._awaiting = {r.rid for r in self.engine.scheduler.queue}
        self._last = {
            "reason": str(reason),
            "verdict": dict(verdict) if verdict else None,
            "requeued": len(requeued),
            "restart": self.restarts,
        }
        if not self._awaiting:
            self._recovered()
        return True

    def note_completion(self, rid):
        """Engine callback on every retirement: when the last replayed
        request completes, the recovery is DONE — anomalies resolve,
        degraded clears, warmup re-declares."""
        if not self._awaiting:
            return
        self._awaiting.discard(rid)
        if not self._awaiting:
            self._recovered()

    def _recovered(self):
        if self.engine is None:
            return
        health = self.engine.health
        if health is not None:
            health.resolve()
        if self._was_warmed:
            # the restart ran under a reopened warmup; from here the
            # watchdog's steady state is back in force
            self.engine.declare_warmup()

    # ------------------------------------------------------- reporting
    @property
    def degraded(self):
        """True from restart until every replayed request completed —
        the router-facing "serving, but not at full trust" state."""
        return bool(self._awaiting) or self.gave_up

    def report(self):
        return {
            "enabled": True,
            "restarts": self.restarts,
            "degraded": self.degraded,
            "replaying": len(self._awaiting),
            "gave_up": self.gave_up,
            "max_restarts": self.max_restarts,
            "restart_on": list(self.restart_on),
            "last_restart": dict(self._last) if self._last else None,
        }
