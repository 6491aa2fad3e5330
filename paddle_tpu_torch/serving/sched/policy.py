"""Admission policies: FIFO (the default) and SLO-feedback load shedding
(the port's own copy of ``paddle_tpu/serving/sched/policy.py``).

A queued request's headroom is

    slo_ttft_ms - elapsed_since_arrival_ms - service_estimate_ms

where the service estimate is an EWMA of admission->first-token times
the engine feeds back (``observe_service``). Requests whose headroom is
below zero are shed (``mode="shed"``: retired with no tokens) or
deferred once behind the viable queue (``mode="defer"``). Policies only
decide; the scheduler applies the decision and the engine counts it.
"""


class TriageDecision:
    """``shed`` and ``deprioritized``: ``[(request, headroom_ms), ...]``
    (headroom at decision time, below 0 for lost causes)."""

    __slots__ = ("shed", "deprioritized")

    def __init__(self, shed=(), deprioritized=()):
        self.shed = list(shed)
        self.deprioritized = list(deprioritized)

    @property
    def empty(self):
        return not self.shed and not self.deprioritized


class SchedulingPolicy:
    """Base policy: FIFO, nothing shed. ``triage`` sees a snapshot of
    the queue (arrival order) and the perf_counter time;
    ``observe_service`` receives each admission->first-token latency in
    ms."""

    name = "fifo"

    def triage(self, queue, now):
        return TriageDecision()

    def observe_service(self, service_ms):
        pass


class FIFOPolicy(SchedulingPolicy):
    """Strict arrival order; every request is served, however late."""


class SLOFeedbackPolicy(SchedulingPolicy):
    """Shed (or defer) queued requests whose TTFT target is already
    lost. ``margin_ms`` makes the estimate more conservative (> 0 sheds
    later); without ``slo_ttft_ms`` the policy decides nothing."""

    name = "slo_feedback"

    def __init__(self, slo_ttft_ms=None, mode="shed", margin_ms=0.0,
                 ewma=0.25):
        if mode not in ("shed", "defer"):
            raise ValueError(f"mode must be 'shed' or 'defer', "
                             f"got {mode!r}")
        self.slo_ttft_ms = None if slo_ttft_ms is None \
            else float(slo_ttft_ms)
        self.mode = mode
        self.margin_ms = float(margin_ms)
        self.ewma = float(ewma)
        self.service_est_ms = 0.0

    def observe_service(self, service_ms):
        """Fold one admission->first-token time (ms) into the EWMA."""
        s = float(service_ms)
        if self.service_est_ms == 0.0:
            self.service_est_ms = s
        else:
            self.service_est_ms += self.ewma * (s - self.service_est_ms)

    def headroom_ms(self, request, now):
        """TTFT budget left were the request admitted now (<= 0: the
        target is lost); None without a target."""
        if self.slo_ttft_ms is None:
            return None
        elapsed = (now - request.t_arrival) * 1000.0
        return self.slo_ttft_ms - elapsed - self.service_est_ms \
            - self.margin_ms

    def triage(self, queue, now):
        decision = TriageDecision()
        if self.slo_ttft_ms is None:
            return decision
        for req in queue:
            h = self.headroom_ms(req, now)
            if h >= 0.0:
                continue
            if self.mode == "shed":
                decision.shed.append((req, h))
            elif not req.deprioritized:
                # defer once: re-deferring forever would starve it
                decision.deprioritized.append((req, h))
        return decision


def resolve_policy(policy, slo_ttft_ms=None):
    """``ServingConfig(policy=...)`` -> a policy: None / "fifo" ->
    FIFOPolicy, "slo_feedback" -> SLOFeedbackPolicy at the engine's TTFT
    target, a SchedulingPolicy instance as it is."""
    if policy is None or policy == "fifo":
        return FIFOPolicy()
    if policy == "slo_feedback":
        return SLOFeedbackPolicy(slo_ttft_ms=slo_ttft_ms)
    if isinstance(policy, SchedulingPolicy):
        return policy
    raise ValueError(
        f"policy must be 'fifo', 'slo_feedback' or a SchedulingPolicy "
        f"instance, got {policy!r}")
