"""Fleet-side trace assembly: scrape, join, order, decompose (a copy
of ``paddle_tpu/observability/trace/assembler.py``).

The :class:`TraceAssembler` turns N per-replica span rings (the
``/debug/traces`` bodies, the router's ``/router/trace``, or live
:class:`~paddle_tpu_torch.observability.trace.spans.TraceRecorder` objects)
into per-request end-to-end traces:

  * **clock-offset estimation** — every scraped body carries the
    replica's ``wall_time`` at render; the assembler's own
    request/response stamps around the scrape bound the true offset to
    ``[t_req - wall_time, t_resp - wall_time]`` (the classic NTP
    bound). The midpoint is the estimate, half the width the
    ambiguity. Span orderings that fall INSIDE the combined ambiguity
    of their sources are flagged ``skew_ambiguous`` — never silently
    reordered into a story the clocks can't support.
  * **assembly** — spans joined by trace_id across sources, shifted
    onto the assembler's clock, sorted; :class:`AssembledTrace` then
    answers the timeline, the nine-segment completeness check, and
    the wall accounting (window vs segment sum = the unattributed
    gap).
  * **rendering** — :func:`chrome_trace` (one pid per replica, one
    flow chain per trace linking the hops: the flight recorder's flow
    machinery extended cross-process, valid under the same validator) and
    :func:`ttft_breakdown` (median/p99 ms per canonical segment over
    a cohort — the TTFT critical path as named numbers).

Pure stdlib: a command-line reader can load this module by file
path.
"""
import json
import time
import urllib.request

from .spans import CANONICAL_SEGMENTS

__all__ = ["TraceAssembler", "AssembledTrace", "chrome_trace",
           "ttft_breakdown"]


def _pct(values, q):
    """Linear-interpolation percentile over a small list; None when
    empty (stdlib-only — this module must import without numpy)."""
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = (len(vs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


class _Source:
    __slots__ = ("replica_id", "spans", "offset", "ambiguity")

    def __init__(self, replica_id, spans, offset, ambiguity):
        self.replica_id = str(replica_id)
        self.spans = spans          # list of span dicts (replica clock)
        self.offset = float(offset)      # add to map onto our clock
        self.ambiguity = float(ambiguity)


class AssembledTrace:
    """One request's joined, clock-aligned, ordered span list."""

    def __init__(self, trace_id, spans):
        self.trace_id = trace_id
        # spans: dicts with adjusted "t0" + "skew_ambiguous" flags,
        # sorted by adjusted start time
        self.spans = spans

    @property
    def replicas(self):
        seen = {}
        for s in self.spans:
            seen[s["replica"]] = True
        return list(seen)

    def _canonical(self):
        return [s for s in self.spans if s["name"] in CANONICAL_SEGMENTS]

    def segments(self):
        """Wall milliseconds per canonical segment (summed across
        occurrences — a failover trace has two prefill attempts)."""
        out = {}
        for s in self._canonical():
            out[s["name"]] = out.get(s["name"], 0.0) \
                + s["dur"] * 1000.0
        return {k: round(v, 3) for k, v in out.items()}

    def missing_segments(self, required=CANONICAL_SEGMENTS):
        present = {s["name"] for s in self.spans}
        return [n for n in required if n not in present]

    @property
    def complete(self):
        return not self.missing_segments()

    def window_ms(self):
        """The TTFT accounting window: first canonical span start to
        last canonical span end (submit → decode/first_step end on a
        two-hop trace). None when no canonical span landed."""
        spans = self._canonical()
        if not spans:
            return None
        t0 = min(s["t0"] for s in spans)
        t1 = max(s["t0"] + s["dur"] for s in spans)
        return (t1 - t0) * 1000.0

    def unattributed_ms(self):
        """Window wall not covered by any canonical segment — the
        honesty metric: <10% of the window means the decomposition
        tells the whole TTFT story."""
        window = self.window_ms()
        if window is None:
            return None
        return max(0.0, window - sum(self.segments().values()))

    def unattributed_frac(self):
        window = self.window_ms()
        if not window:
            return None
        return self.unattributed_ms() / window

    def timeline(self):
        """Render-ready rows, ordered by (estimated) start time."""
        if not self.spans:
            return []
        t0 = min(s["t0"] for s in self.spans)
        rows = []
        for s in self.spans:
            rows.append({
                "t_rel_ms": round((s["t0"] - t0) * 1000.0, 3),
                "dur_ms": round(s["dur"] * 1000.0, 3),
                "replica": s["replica"],
                "name": s["name"],
                "skew_ambiguous": bool(s.get("skew_ambiguous")),
                "attrs": s.get("attrs") or {},
            })
        return rows

    def as_dict(self):
        return {
            "trace_id": self.trace_id,
            "replicas": self.replicas,
            "complete": self.complete,
            "missing_segments": self.missing_segments(),
            "window_ms": None if self.window_ms() is None
            else round(self.window_ms(), 3),
            "unattributed_ms": None if self.unattributed_ms() is None
            else round(self.unattributed_ms(), 3),
            "segments": self.segments(),
            "timeline": self.timeline(),
        }


class TraceAssembler:
    """Join per-replica span rings into per-request traces."""

    def __init__(self):
        self._sources = []

    # -------------------------------------------------------- sources
    def add_body(self, body, t_req=None, t_resp=None):
        """Ingest one ``/debug/traces`` body. ``t_req``/``t_resp`` are
        the assembler-clock stamps around the scrape that produced it;
        without them (a saved file, a same-process ring) the offset is
        taken as zero with zero ambiguity — correct when every source
        shares the host clock."""
        if not isinstance(body, dict) or "spans" not in body:
            raise ValueError("not a /debug/traces body (no spans)")
        offset, amb = 0.0, 0.0
        wall = body.get("wall_time")
        if t_req is not None and t_resp is not None \
                and isinstance(wall, (int, float)):
            lo = float(t_req) - float(wall)
            hi = float(t_resp) - float(wall)
            offset = (lo + hi) / 2.0
            amb = max(0.0, (hi - lo) / 2.0)
        spans = [s for s in body["spans"] if isinstance(s, dict)
                 and "trace_id" in s and "t0" in s and "dur" in s]
        self._sources.append(_Source(
            body.get("replica_id") or f"source{len(self._sources)}",
            spans, offset, amb))
        return self

    def add_recorder(self, recorder):
        """Ingest a live same-process TraceRecorder (zero offset)."""
        return self.add_body(recorder.debug_traces())

    def scrape(self, url, timeout=5.0, samples=3):
        """GET one replica's trace surface, stamping the round trip
        for the skew bound. A bare host:port scrapes
        ``/debug/traces``; give the full path for the router's
        ``/router/trace``.

        NTP-style sampling: take ``samples`` round trips and keep the
        tightest one. A scheduler stall inflates a round trip — and
        with it both the ambiguity and the midpoint offset error — so
        the fastest sample is the most truthful clock bound."""
        url = str(url).rstrip("/")
        if "://" not in url:
            url = "http://" + url
        if url.count("/") <= 2:   # no path component
            url += "/debug/traces"
        best = None
        for _ in range(max(1, int(samples))):
            t_req = time.time()
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                raw = resp.read()
            t_resp = time.time()
            if best is None or (t_resp - t_req) < (best[1] - best[0]):
                best = (t_req, t_resp, raw)
        body = json.loads(best[2].decode("utf-8"))
        return self.add_body(body, t_req=best[0], t_resp=best[1])

    # ------------------------------------------------------- assembly
    def trace_ids(self):
        """Every trace id any source saw, in first-seen order."""
        seen = {}
        for src in self._sources:
            for s in src.spans:
                seen[s["trace_id"]] = True
        return list(seen)

    def assemble(self, trace_id):
        """One AssembledTrace (or None when no source saw the id):
        spans shifted onto the assembler clock, sorted by estimated
        start, skew-ambiguous orderings flagged."""
        spans = []
        for src in self._sources:
            for s in src.spans:
                if s["trace_id"] != trace_id:
                    continue
                d = dict(s)
                d["t0"] = float(s["t0"]) + src.offset
                d["dur"] = float(s["dur"])
                d["replica"] = s.get("replica") or src.replica_id
                d["_amb"] = src.ambiguity
                d["_src"] = id(src)
                spans.append(d)
        if not spans:
            return None
        spans.sort(key=lambda s: (s["t0"], s["name"]))
        # ordering honesty: when two adjacent spans come from
        # different sources and their start gap is inside the combined
        # clock ambiguity, the rendered order is an estimate — flag
        # both rather than silently presenting it as fact
        for a, b in zip(spans, spans[1:]):
            if a["_src"] == b["_src"]:
                continue
            if abs(b["t0"] - a["t0"]) < a["_amb"] + b["_amb"]:
                a["skew_ambiguous"] = True
                b["skew_ambiguous"] = True
        for s in spans:
            s.pop("_amb", None)
            s.pop("_src", None)
        return AssembledTrace(trace_id, spans)

    def assemble_all(self):
        return [t for t in (self.assemble(tid)
                            for tid in self.trace_ids())
                if t is not None]


# ---------------------------------------------------------- rendering
def chrome_trace(traces):
    """chrome://tracing export over assembled traces: one pid per
    replica, every span an "X" slice, one flow chain per trace whose
    s/t/f points ride the span starts — loadable next to (and valid
    under the same flow validator as) the single-process export,
    now spanning processes."""
    traces = list(traces)
    events = []
    pids = {}
    for tr in traces:
        for s in tr.spans:
            if s["replica"] not in pids:
                pids[s["replica"]] = len(pids) + 1
    for replica, pid in sorted(pids.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": replica}})
    all_spans = [s for tr in traces for s in tr.spans]
    if not all_spans:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    t_base = min(s["t0"] for s in all_spans)
    for tr in traces:
        fid = int(tr.trace_id[:12], 16)
        chain = sorted(tr.spans, key=lambda s: s["t0"])
        for i, s in enumerate(chain):
            pid = pids[s["replica"]]
            ts = round((s["t0"] - t_base) * 1e6, 3)
            dur = round(s["dur"] * 1e6, 3)
            args = dict(s.get("attrs") or {})
            args["trace_id"] = tr.trace_id
            if s.get("skew_ambiguous"):
                args["skew_ambiguous"] = True
            events.append({"ph": "X", "name": s["name"], "cat": "trace",
                           "ts": ts, "dur": dur, "pid": pid, "tid": 1,
                           "args": args})
            phase = "s" if i == 0 else \
                ("f" if i == len(chain) - 1 else "t")
            flow = {"ph": phase, "name": f"trace {tr.trace_id[:8]}",
                    "cat": "trace", "id": fid,
                    # strictly increasing inside the chain (ties in
                    # rounded span starts would shuffle s/t/f order);
                    # the offsets stay far under the validator's
                    # rounding slack, so every point still binds to
                    # its own span
                    "ts": round(ts + 0.001 * i, 3),
                    "pid": pid, "tid": 1,
                    "args": {"span": s["name"]}}
            if phase == "f":
                flow["bp"] = "e"    # enclosing-slice binding
            events.append(flow)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def ttft_breakdown(traces):
    """The TTFT critical-path decomposition over a cohort: median/p99
    milliseconds per canonical segment, the window, and the
    unattributed gap."""
    traces = list(traces)
    per_seg = {name: [] for name in CANONICAL_SEGMENTS}
    windows, gaps, fracs = [], [], []
    complete = 0
    for tr in traces:
        segs = tr.segments()
        for name, ms in segs.items():
            per_seg[name].append(ms)
        w = tr.window_ms()
        if w is not None:
            windows.append(w)
            gaps.append(tr.unattributed_ms())
            fracs.append(tr.unattributed_frac())
        if tr.complete:
            complete += 1

    def stats(values):
        return {"median_ms": None if not values
                else round(_pct(values, 50), 3),
                "p99_ms": None if not values
                else round(_pct(values, 99), 3),
                "count": len(values)}

    out = {
        "count": len(traces),
        "complete": complete,
        "ttft": stats(windows),
        "segments": {name: stats(per_seg[name])
                     for name in CANONICAL_SEGMENTS},
        "unattributed": stats(gaps),
    }
    out["unattributed"]["median_frac"] = None if not fracs \
        else round(_pct(fracs, 50), 4)
    return out
