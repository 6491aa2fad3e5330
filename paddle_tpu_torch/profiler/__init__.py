"""Profiler (a port of ``paddle_tpu/profiler/__init__.py``; reference
platform/profiler.h:127 RecordEvent, :213 EnableProfiler,
python/paddle/fluid/profiler.py:314).

``record_scope`` is the framework's one instrumentation point, with
three sinks:

* the device timeline: ``torch.profiler.record_function`` (a range in a
  ``torch.profiler`` trace beside the kernels it launched) and, on a
  machine with CUDA, an NVTX range, the counterparts of the reference's
  XPlane ``TraceAnnotation`` + ``named_scope``;
* the bounded host-span ring (``observability.tracing``'s default
  recorder, a chrome://tracing timeline);
* the process registry: ``host_span_seconds_total`` and
  ``host_span_calls_total`` by scope name (Prometheus text).

An optional ``sink(name, seconds)`` receives the same elapsed time. The
optimizer's ``step()`` runs inside ``optimizer/step`` and hapi's batches
inside ``hapi/train_batch`` / ``eval_batch`` / ``predict_batch`` /
``train_window``, as in the reference.

``Profiler`` runs ``torch.profiler.profile`` (the CPU, and CUDA where
there is a card) over the steps its scheduler marks RECORD and writes
each record window as a chrome trace (``<log_dir>/<worker>.<n>.pt.trace
.json``, openable in chrome://tracing or Perfetto), where the reference
writes an XPlane capture; ``export_chrome_tracing(dir)`` sends the files
to ``dir``; ``timer_only`` writes nothing and times the steps.
"""
import contextlib
import os
import socket
import time

import torch

from ..observability import registry as _obs_registry
from ..observability import tracing as _obs_tracing

_span_seconds = _obs_registry.default_registry().counter(
    "host_span_seconds_total",
    "wall seconds accrued per record_scope name", labelnames=("span",))
_span_calls = _obs_registry.default_registry().counter(
    "host_span_calls_total",
    "record_scope completions per scope name", labelnames=("span",))


class RecordEvent:
    """A named range on the device timeline (reference profiler.h:127):
    a ``record_function`` range, and an NVTX range on CUDA."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False

    def begin(self):
        self.__enter__()

    def end(self):
        self.__exit__(None, None, None)


@contextlib.contextmanager
def record_scope(name, sink=None):
    """One scope, three sinks (the device timeline, the host-span ring,
    the registry's seconds and calls by ``name``), and ``sink(name,
    seconds)`` when given."""
    t0 = time.perf_counter()
    with RecordEvent(name):
        yield
    dt = time.perf_counter() - t0
    _obs_tracing.default_recorder().record(name, t0, dt)
    _span_seconds.labels(name).inc(dt)
    _span_calls.labels(name).inc()
    if sink is not None:
        sink(name, dt)


class ProfilerState:
    """Reference: paddle.profiler.ProfilerState."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget:
    """Reference: paddle.profiler.ProfilerTarget. GPU is the card's
    kernels (CUPTI, through ``torch.profiler``); TPU is kept for the
    reference's name and means the card too."""
    CPU = 0
    GPU = 1
    TPU = 2


def make_scheduler(closed=0, ready=0, record=1000000, repeat=0,
                   skip_first=0):
    """Reference: paddle.profiler.make_scheduler: the step's state in
    ``[skip_first][closed][ready][record]`` repeated ``repeat`` times (0:
    for ever)."""
    period = closed + ready + record

    def schedule(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def export_chrome_tracing(dir_name, worker_name=None):
    """Reference: paddle.profiler.export_chrome_tracing: an
    ``on_trace_ready`` that makes the Profiler write its chrome traces to
    ``dir_name`` (named by ``worker_name``, else host and pid)."""
    def on_ready(prof):
        return dir_name
    on_ready._export_dir = dir_name
    on_ready._worker = worker_name
    return on_ready


def _activities(targets):
    acts = [torch.profiler.ProfilerActivity.CPU]
    want_card = targets is None or any(
        t in (ProfilerTarget.GPU, ProfilerTarget.TPU) for t in targets)
    if want_card and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Profiler:
    """paddle.profiler.Profiler over ``torch.profiler.profile``
    (reference python/paddle/profiler/profiler.py): ``start``/``stop``
    (or the scheduler's RECORD windows) trace the steps between them
    into a chrome trace under ``log_dir``; ``step()`` marks a step's
    end; ``step_info`` summarises the steps' wall times."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 log_dir="./profiler_log", timer_only=False):
        self.log_dir = log_dir
        self.timer_only = timer_only
        self.targets = targets
        if isinstance(scheduler, tuple):
            start, stop = scheduler
            scheduler = make_scheduler(closed=start, ready=0,
                                       record=stop - start, repeat=1)
        self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self._worker = getattr(on_trace_ready, "_worker", None) or \
            f"{socket.gethostname()}_{os.getpid()}"
        export_dir = getattr(on_trace_ready, "_export_dir", None)
        if export_dir is not None:
            self.log_dir = export_dir
        self._started = False
        self._prof = None
        self._step_num = 0
        self._step_times = []
        self._t0 = None
        self.traces = []      # the chrome trace files written

    def _state(self):
        if self.scheduler is None:
            return ProfilerState.RECORD
        return self.scheduler(self._step_num)

    def _sync_trace(self):
        want = (not self.timer_only
                and self._state() in (ProfilerState.RECORD,
                                      ProfilerState.RECORD_AND_RETURN))
        if want and self._prof is None:
            self._prof = torch.profiler.profile(
                activities=_activities(self.targets))
            self._prof.__enter__()
        elif not want and self._prof is not None:
            self._close()

    def _close(self):
        prof, self._prof = self._prof, None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"{self._worker}."
                            f"{len(self.traces)}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.traces.append(path)
        self.last_profile = prof
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def start(self):
        self._started = True
        self._sync_trace()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._prof is not None:
            self._close()
        self._started = False

    def step(self):
        now = time.perf_counter()
        if self._t0 is not None:
            self._step_times.append(now - self._t0)
        self._t0 = now
        self._step_num += 1
        if self._started:
            self._sync_trace()

    def step_info(self, unit=None):
        """Step-time summary string; ``unit`` selects milliseconds
        ("ms", default) or seconds ("s")."""
        unit = "ms" if unit is None else str(unit).lower()
        if unit not in ("ms", "s"):
            raise ValueError(f"unit must be 'ms' or 's', got {unit!r}")
        if not self._step_times:
            return "no steps recorded"
        import numpy as np
        arr = np.asarray(self._step_times[1:] or self._step_times)
        scale = 1000.0 if unit == "ms" else 1.0
        return (f"avg step {arr.mean() * scale:.3f} {unit}, "
                f"min {arr.min() * scale:.3f} {unit}, "
                f"max {arr.max() * scale:.3f} {unit}")

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def summary(self, **kwargs):
        return self.step_info()


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None):
    """Legacy fluid.profiler.profiler context (reference:
    python/paddle/fluid/profiler.py:314)."""
    p = Profiler(log_dir=profile_path or "./profiler_log")
    p.start()
    try:
        yield p
    finally:
        p.stop()


_legacy = []


def start_profiler(state="All", tracer_option=None):
    p = Profiler(log_dir="./profiler_log")
    p.start()
    _legacy.append(p)


def stop_profiler(sorted_key=None, profile_path=None):
    while _legacy:
        p = _legacy.pop()
        if profile_path is not None:
            p.log_dir = profile_path
        p.stop()
