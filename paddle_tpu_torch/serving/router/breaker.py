"""Per-replica circuit breaker (a copy of
``paddle_tpu/serving/router/breaker.py``).

The router's unit of distrust: a replica that keeps failing dispatches
stops receiving traffic *before* the fleet poller's ``down_after``
eviction catches up (dispatch failures are a faster, request-path
signal than scrape failures), and a recovered replica is re-trusted
through exactly ONE probe request instead of a thundering herd.

States and transitions (the classic three-state machine):

  * ``closed``    — healthy; every dispatch allowed. ``threshold``
                    CONSECUTIVE failures → ``open`` (any success
                    resets the streak);
  * ``open``      — no dispatches for ``reset_s`` seconds, then the
                    next ``allow()`` admits a single probe and moves
                    to ``half_open``;
  * ``half_open`` — exactly one probe in flight; its success closes
                    the breaker, its failure re-opens (a fresh
                    ``reset_s`` wait).

The breaker is driven by BOTH dispatch outcomes (``record_success`` /
``record_failure``) and the fleet poller's availability verdicts
(``note_verdict``): a ``down`` verdict force-opens (no point probing a
replica the poller already evicted), and an ``up`` verdict on an open
breaker skips straight to the half-open probe — the poller reaching
the replica is evidence worth one request.

Pure logic, injectable clock, no threads — the router serializes
access under its own lock.
"""

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]


class CircuitBreaker:
    def __init__(self, threshold=3, reset_s=1.0, clock=None):
        self.threshold = int(threshold)
        if self.threshold < 1:
            raise ValueError(
                f"threshold must be >= 1, got {threshold}")
        self.reset_s = float(reset_s)
        if self.reset_s < 0:
            raise ValueError(f"reset_s must be >= 0, got {reset_s}")
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at = None
        self.transitions = []   # (to_state) history, bounded below
        self._probe_inflight = False

    # ------------------------------------------------------ inputs
    def record_success(self):
        """A dispatch to this replica completed: close from any
        state (a half-open probe succeeding is the recovery path)."""
        self.consecutive_failures = 0
        self._probe_inflight = False
        self._to(CLOSED)

    def record_failure(self, now):
        """A dispatch failed (transport error / replica death — NOT a
        clean refusal): count the streak; trip at ``threshold``. A
        half-open probe failing re-opens immediately."""
        self.consecutive_failures += 1
        self._probe_inflight = False
        if self.state == HALF_OPEN \
                or self.consecutive_failures >= self.threshold:
            self.opened_at = now
            self._to(OPEN)

    def note_verdict(self, verdict, now):
        """Fold in the fleet poller's availability verdict: ``down``
        force-opens; ``up`` on an open breaker arms an immediate
        half-open probe (backdate ``opened_at`` so the next
        ``allow()`` admits it). ``stale`` / None change nothing —
        distrust the numbers, keep the dispatch evidence."""
        if verdict == "down" and self.state != OPEN:
            self.opened_at = now
            self._probe_inflight = False
            self._to(OPEN)
        elif verdict == "up" and self.state == OPEN:
            self.opened_at = now - self.reset_s

    # ------------------------------------------------------ gating
    def allow(self, now):
        """May the router dispatch to this replica right now?
        Non-mutating (safe to ask for every placement candidate):
        closed → yes; open past ``reset_s`` → yes, one probe is
        available; half-open with the probe still in flight → no."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            return (self.opened_at is not None
                    and now - self.opened_at >= self.reset_s)
        return not self._probe_inflight

    def claim(self, now):
        """The router chose this replica: consume the probe slot if
        the breaker is recovering (open-past-reset → half-open with
        the probe in flight). Call only after ``allow(now)``."""
        if self.state == OPEN and self.allow(now):
            self._to(HALF_OPEN)
            self._probe_inflight = True
        elif self.state == HALF_OPEN:
            self._probe_inflight = True

    # ------------------------------------------------- introspection
    def describe(self, now):
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "open_for_s": round(now - self.opened_at, 3)
            if self.state != CLOSED and self.opened_at is not None
            else None,
        }

    def _to(self, state):
        if state != self.state:
            self.state = state
            self.transitions.append(state)
            del self.transitions[:-32]   # bounded history
