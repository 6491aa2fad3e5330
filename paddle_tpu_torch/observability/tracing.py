"""Bounded host-span ring buffer + chrome://tracing export (a copy of
``paddle_tpu/observability/tracing.py``).

The serving engine's chaos harness, health monitor and supervisor drop
marker spans here (``chaos/<site>``, ``health/<detector>``), so what
they did is readable after the fact next to the step that absorbed it:
``dump_chrome_trace()`` writes a JSON Trace Event file that
chrome://tracing and https://ui.perfetto.dev open directly.

The buffer is a fixed-capacity ring (collections.deque maxlen):
sustained traffic overwrites the oldest spans instead of growing —
recording is always-on and O(1) per span with a single lock.

Besides complete ("X") spans the recorder holds chrome FLOW events
(``ph:"s"/"t"/"f"``) linking markers across spans. Flow events bind to
the slice enclosing their timestamp on the same pid/tid, so every flow
emission pairs with a marker span at the identical timestamp.
"""
import collections
import json
import os
import threading
import time


class HostSpan:
    """One completed host scope: [t0, t0+dur) seconds on thread tid."""

    __slots__ = ("name", "t0", "dur", "tid", "args")

    def __init__(self, name, t0, dur, tid, args=None):
        self.name = name
        self.t0 = float(t0)
        self.dur = float(dur)
        self.tid = int(tid)
        self.args = args

    @property
    def t1(self):
        return self.t0 + self.dur


class FlowEvent:
    """One chrome flow-event point: phase "s" (start), "t" (step) or
    "f" (finish) of flow chain ``fid`` at instant ``t`` on thread
    ``tid``. Chains with the same (cat, id) render as arrows between
    the slices enclosing each point."""

    __slots__ = ("name", "t", "phase", "fid", "tid", "args")

    def __init__(self, name, t, phase, fid, tid, args=None):
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be 's', 't' or 'f', "
                             f"got {phase!r}")
        self.name = name
        self.t = float(t)
        self.phase = phase
        self.fid = int(fid)
        self.tid = int(tid)
        self.args = args


class HostSpanRecorder:
    """Thread-safe bounded recorder of completed host spans.

    Spans arrive at scope EXIT (a scope knows its duration only
    then), so within one thread children are recorded before their
    parent — the chrome export doesn't care: complete ("X") events
    carry absolute ts+dur and nest by containment in the viewer.
    """

    def __init__(self, capacity=65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf = collections.deque(maxlen=self.capacity)
        self._flows = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dropped = 0
        self._flows_dropped = 0
        self._pid = os.getpid()

    def record(self, name, t0, dur, args=None):
        span = HostSpan(name, t0, dur, threading.get_ident(), args)
        with self._lock:
            if len(self._buf) == self.capacity:
                self._dropped += 1
            self._buf.append(span)
        return span

    def record_flow(self, name, t, phase, flow_id, args=None):
        """Record one flow-event point ("s"/"t"/"f") of chain
        ``flow_id`` at instant ``t`` on the calling thread. Pair it
        with a marker span at the same timestamp so viewers have a
        slice to bind the arrow to."""
        ev = FlowEvent(name, t, phase, flow_id, threading.get_ident(),
                       args)
        with self._lock:
            if len(self._flows) == self._flows.maxlen:
                self._flows_dropped += 1
            self._flows.append(ev)
        return ev

    def __len__(self):
        with self._lock:
            return len(self._buf)

    @property
    def dropped(self):
        """Spans overwritten by the ring since the last clear()."""
        return self._dropped

    def spans(self):
        with self._lock:
            return list(self._buf)

    def flows(self):
        with self._lock:
            return list(self._flows)

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._flows.clear()
            self._dropped = 0
            self._flows_dropped = 0

    # ---------------------------------------------------------- export
    def chrome_trace(self, process_name="paddle_tpu_torch"):
        """The trace as a dict in Chrome Trace Event JSON format:
        complete ("X") events in microseconds with stable pid/tid,
        flow events ("s"/"t"/"f") linking request lifecycles across
        spans, plus process/thread-name metadata events. Load with
        chrome://tracing or ui.perfetto.dev."""
        spans = self.spans()
        flows = self.flows()
        pid = self._pid
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]
        for tid in sorted({s.tid for s in spans}
                          | {f.tid for f in flows}):
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tid, "args": {"name": f"host-{tid}"},
            })
        for s in spans:
            ev = {
                "name": s.name, "ph": "X", "cat": "host",
                "ts": round(s.t0 * 1e6, 3),
                "dur": round(s.dur * 1e6, 3),
                "pid": pid, "tid": s.tid,
            }
            if s.args:
                ev["args"] = dict(s.args)
            events.append(ev)
        for f in flows:
            ev = {
                "name": f.name, "ph": f.phase, "cat": "request",
                "id": f.fid, "ts": round(f.t * 1e6, 3),
                "pid": pid, "tid": f.tid,
            }
            if f.phase == "f":
                ev["bp"] = "e"  # bind the finish to the ENCLOSING slice
            if f.args:
                ev["args"] = dict(f.args)
            events.append(ev)
        # deterministic viewer order: by start time, metadata first;
        # stable sort keeps a flow point after the span it binds to
        # when both share a timestamp
        events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"recorder": "paddle_tpu_torch.observability",
                              "dropped_spans": self._dropped,
                              "dropped_flows": self._flows_dropped}}

    def dump_chrome_trace(self, path, process_name="paddle_tpu_torch"):
        """Write the chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(process_name), fh)
        return path


_default_recorder = HostSpanRecorder()


def default_recorder():
    """The process-global recorder the engine's marker spans feed."""
    return _default_recorder


class span_timer:
    """Context manager recording one span into a recorder."""

    def __init__(self, name, recorder=None, args=None):
        self.name = name
        self.recorder = recorder or _default_recorder
        self.args = args
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.recorder.record(self.name, self._t0,
                             time.perf_counter() - self._t0, self.args)
        return False
