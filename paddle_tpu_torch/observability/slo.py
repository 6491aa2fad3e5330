"""SLO attainment, goodput accounting, and sliding-window latency
percentiles for the serving engine (a copy of
``paddle_tpu/observability/slo.py``).

Throughput alone misrepresents a serving fleet: a step that generates
many tokens LATE is worth nothing to the users waiting on them. The
operational quantities (the vLLM/Orca-class serving literature's
goodput-under-SLO framing) are:

  * **SLO attainment** — did each request meet its time-to-first-token
    (TTFT) and time-per-output-token (TPOT) targets? Counted per
    request, with per-dimension violation counters so a TTFT miss
    (queueing/prefill problem) is distinguishable from a TPOT miss
    (decode-throughput problem);
  * **goodput** — tokens generated by requests that MET their SLOs vs
    total tokens: the fleet's useful output;
  * **sliding-window percentiles** — p50/p90/p99 TTFT / TPOT / request
    latency over the last ``window_s`` SECONDS of traffic (a
    registry.WindowedReservoir per series), exposed as pull-time
    gauges so ``/metrics`` reflects current traffic, not process
    lifetime (the uniform reservoirs keep lifetime views).

All counters/gauges live in the engine's MetricsRegistry, so the same
numbers feed Prometheus text and the JSON snapshot.
SLO targets come from ``ServingConfig(slo_ttft_ms=..., slo_tpot_ms=
...)``; with no targets configured every request trivially attains
(the tracker still maintains the windows — they are useful without
SLOs).
"""
import time

from .registry import WindowedReservoir

_QUANTILES = ((50, "p50"), (90, "p90"), (99, "p99"))


class SLOTracker:
    """Per-request SLO verdicts + goodput counters + windowed
    percentile gauges, all in ``registry``.

    TPOT is judged only for requests with >= 2 tokens (a single-token
    request has no inter-token interval). ``clock`` drives the sliding
    windows and is injectable for tests.
    """

    def __init__(self, registry, slo_ttft_ms=None, slo_tpot_ms=None,
                 window_s=60.0, window_capacity=4096,
                 clock=time.monotonic):
        self.slo_ttft_ms = None if slo_ttft_ms is None \
            else float(slo_ttft_ms)
        self.slo_tpot_ms = None if slo_tpot_ms is None \
            else float(slo_tpot_ms)
        self.window_s = float(window_s)
        r = registry
        self._c_requests = r.counter(
            "serving_slo_requests_total", "requests given SLO verdicts")
        self._c_attained = r.counter(
            "serving_slo_attained_total",
            "requests that met every configured SLO")
        self._c_violations = r.counter(
            "serving_slo_violations_total",
            "SLO violations by dimension (one request can violate "
            "several)", labelnames=("dimension",))
        self._c_goodput = r.counter(
            "serving_goodput_tokens_total",
            "tokens from requests that met their SLOs")
        self._c_tokens = r.counter(
            "serving_slo_tokens_total",
            "tokens from all SLO-judged requests")
        self._windows = {
            name: WindowedReservoir(window_s, window_capacity, clock)
            for name in ("ttft", "tpot", "request_latency")
        }
        # pull-time gauges: the percentile is computed AT SCRAPE over
        # the then-current window (0 when the window is empty — absent
        # would be cleaner but the family is already declared)
        for name, res in self._windows.items():
            fam = r.gauge(
                f"serving_window_{name}_ms",
                f"sliding-window {name} percentile over the last "
                f"{int(self.window_s)}s (ms)",
                labelnames=("quantile",))
            for q, label in _QUANTILES:
                fam.labels(label).set_function(
                    lambda res=res, q=q: self._window_ms(res, q))

    @staticmethod
    def _window_ms(res, q):
        p = res.percentile(q)
        return 0.0 if p is None else p * 1000.0

    # ------------------------------------------------------ accounting
    def observe_request(self, ttft_s, latency_s, tokens):
        """Judge one completed request; returns the list of violated
        dimensions ("" empty = attained). ``tokens`` is the generated
        count; TPOT = (latency - ttft) / (tokens - 1)."""
        tokens = int(tokens)
        tpot_s = None
        if tokens > 1 and ttft_s is not None:
            tpot_s = max(0.0, (latency_s - ttft_s)) / (tokens - 1)
        if ttft_s is not None:
            self._windows["ttft"].add(ttft_s)
        if tpot_s is not None:
            self._windows["tpot"].add(tpot_s)
        self._windows["request_latency"].add(latency_s)

        violations = []
        if self.slo_ttft_ms is not None and ttft_s is not None \
                and ttft_s * 1000.0 > self.slo_ttft_ms:
            violations.append("ttft")
        if self.slo_tpot_ms is not None and tpot_s is not None \
                and tpot_s * 1000.0 > self.slo_tpot_ms:
            violations.append("tpot")

        self._c_requests.inc()
        self._c_tokens.inc(tokens)
        if violations:
            for dim in violations:
                self._c_violations.labels(dim).inc()
        else:
            self._c_attained.inc()
            self._c_goodput.inc(tokens)
        return violations

    def observe_shed(self, reason="shed"):
        """Judge one LOAD-SHED request: it produced zero tokens, so it
        contributes nothing to goodput — but it IS a judged request
        with a violation (dimension = the shed reason), so attainment
        honestly reflects that shedding trades a few requests' answers
        for the fleet's goodput. Without this, a policy could inflate
        its attainment by shedding everything it might miss."""
        self._c_requests.inc()
        self._c_violations.labels(str(reason)).inc()

    # -------------------------------------------------------- querying
    @property
    def requests(self):
        return int(self._c_requests.value)

    @property
    def attained(self):
        return int(self._c_attained.value)

    @property
    def goodput_tokens(self):
        return int(self._c_goodput.value)

    @property
    def total_tokens(self):
        return int(self._c_tokens.value)

    def window_percentiles(self):
        """{"ttft": {"count", "p50_ms", "p90_ms", "p99_ms"}, ...} over
        the CURRENT window (None entries when empty)."""
        out = {}
        for name, res in self._windows.items():
            entry = {"count": res.count()}
            for q, label in _QUANTILES:
                p = res.percentile(q)
                entry[f"{label}_ms"] = None if p is None \
                    else round(p * 1000.0, 3)
            out[name] = entry
        return out

    def report(self):
        """The JSON-safe ``slo`` section of snapshot()/debug
        artifacts."""
        requests = self.requests
        attained = self.attained
        total_tokens = self.total_tokens
        goodput = self.goodput_tokens
        violations = {labels[0]: int(child.value) for labels, child
                      in self._c_violations.series()}
        return {
            "config": {"slo_ttft_ms": self.slo_ttft_ms,
                       "slo_tpot_ms": self.slo_tpot_ms,
                       "window_s": self.window_s},
            "requests": requests,
            "attained": attained,
            "attainment": round(attained / requests, 4) if requests
            else None,
            "violations": violations,
            "goodput_tokens": goodput,
            "total_tokens": total_tokens,
            "goodput_fraction": round(goodput / total_tokens, 4)
            if total_tokens else None,
            "window": self.window_percentiles(),
        }
