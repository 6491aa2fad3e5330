"""Compile watchdog with the reference's interface (a port of
``paddle_tpu/observability/watchdog.py``).

The reference's watchdog attributes every XLA executable its engine
builds (key, abstract-shape signature, call-site) and, once
``declare_warmup_complete()`` is called, flags — or raises, in
``mode="raise"`` — any further build. The port's engine runs eagerly:
PyTorch queues each kernel as the host reaches it and the CUDA kernels
are built once per process, not per shape, so there is no per-shape
program to build and the engine records no compile. The watchdog keeps
the reference's surface all the same (``warmed``, ``declare_warmup_
complete()``, ``reopen_warmup()``, ``report()`` with the reference's
keys) so the supervisor's warmup bookkeeping, ``/debug/state`` and the
``steady_state_compile`` detector work unchanged; a caller that does
build something per shape may ``record()`` it.
"""
import hashlib
import os
import threading
import traceback

_SELF = os.path.basename(__file__)


class CompileAfterWarmupError(RuntimeError):
    """A compile happened after warmup was declared complete. The
    message carries the attribution (key, signature, call-site)."""


def abstract_signature(args, max_leaves_shown=6):
    """Stable abstract-shape signature of a flat sequence of tensors or
    arrays: the first few as ``dtype[shape]`` plus a digest over all of
    them — two argument sets get the same signature iff every entry
    matches in dtype and shape."""
    leaves = list(args) if isinstance(args, (list, tuple)) else [args]
    parts = []
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None:
            parts.append(type(leaf).__name__)
        else:
            dims = ",".join(str(d) for d in shape)
            parts.append(f"{dtype}[{dims}]")
    digest = hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]
    shown = ";".join(parts[:max_leaves_shown])
    more = len(parts) - max_leaves_shown
    if more > 0:
        shown += f";+{more} leaves"
    return f"{shown}#{digest}"


def _call_site(skip=0):
    frames = [fr for fr in traceback.extract_stack()
              if os.path.basename(fr.filename) != _SELF]
    if not frames:
        return "<unknown>"
    fr = frames[max(0, len(frames) - 1 - skip)]
    return f"{fr.filename}:{fr.lineno} ({fr.name})"


class CompileWatchdog:
    """Attributed compile log with a declared-warmup alarm.

    ``mode="flag"`` (default) records steady-state compiles and
    surfaces them in ``report()``; ``mode="raise"`` additionally
    raises CompileAfterWarmupError at the offending ``record()``."""

    def __init__(self, mode="flag"):
        if mode not in ("flag", "raise"):
            raise ValueError(f"mode must be 'flag' or 'raise', got "
                             f"{mode!r}")
        self.mode = mode
        self._lock = threading.Lock()
        self._events = []
        self._warmed = False

    def record(self, key, signature="", call_site=None, skip=0):
        """Log one build of ``key``; raises in mode='raise' when warm."""
        if call_site is None:
            call_site = _call_site(skip=skip)
        with self._lock:
            event = {
                "seq": len(self._events),
                "key": key if isinstance(key, str) else repr(key),
                "signature": signature,
                "call_site": call_site,
                "steady_state": self._warmed,
                "cost": None,
                "memory": None,
            }
            self._events.append(event)
            warmed = self._warmed
        if warmed and self.mode == "raise":
            raise CompileAfterWarmupError(
                f"compile after declared warmup: key={event['key']} "
                f"signature={signature} at {call_site}")
        return event

    def declare_warmup_complete(self):
        """From here on, every compile is a steady-state violation."""
        with self._lock:
            self._warmed = True

    def reopen_warmup(self):
        """Re-enter warmup (supervisor restart); the supervisor
        re-declares it once the replay drains."""
        with self._lock:
            self._warmed = False

    @property
    def warmed(self):
        return self._warmed

    @property
    def compiles(self):
        with self._lock:
            return len(self._events)

    def events(self):
        with self._lock:
            return [dict(e) for e in self._events]

    def steady_state_events(self):
        return [e for e in self.events() if e["steady_state"]]

    def report(self):
        """The reference's ``watchdog`` section: warm state, mode and
        the compile counts (all 0 on the port's engine)."""
        events = self.events()
        steady = [e for e in events if e["steady_state"]]
        return {
            "warmed": self._warmed,
            "mode": self.mode,
            "compiles_total": len(events),
            "warmup_compiles": len(events) - len(steady),
            "steady_state_compiles": len(steady),
            "events": events,
            "steady_state_events": steady,
        }
