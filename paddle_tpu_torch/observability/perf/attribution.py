"""Per-program device-time attribution: which serving program the step
wall went to, and how close each one runs to its roofline (a port of
``paddle_tpu/observability/perf/attribution.py``).

Every dispatch (bucketed/grouped prefill, the chunk program, the pooled
decode, the speculative verify) and every harvest sync records its
measured wall seconds against its program key, accumulated into
per-program registry histograms::

    serving_program_dispatch_seconds{program="decode"}
    serving_program_sync_seconds{program="prefill/b16/g4"}
    serving_roofline_fraction{program="decode"}

The roofline fraction joins three facts: the measured per-dispatch wall
(here), the program's flops and bytes, and the device's peak FLOP/s and
HBM bandwidth (``set_device``). The reference binds each program's
flops and bytes once, from XLA's ``cost_analysis`` (``bind_cost``, kept
here). The port compiles nothing, so its engine prices each dispatch
from its shapes (``roofline.program_cost``) and accrues the price with
``accrue_cost``; a program's ``cost`` is then the mean price of its
priced dispatches, and fraction = floor of that mean cost / measured
mean per-dispatch wall. An unknown device prices with None (fractions
read None, ``device_peak`` false); the reference falls back to another
chip's figures there.

``report()`` is the ``snapshot()["perf"]`` / ``/debug/perf`` body, with
the reference's key set. Hot-path cost is two perf_counter reads plus
one histogram observe per dispatch and per sync.
"""
import threading

from .roofline import decode_step_model, roofline_floor

__all__ = ["ProgramPerf", "disabled_perf_report",
           "disabled_spec_report", "format_program_key", "PERF_KEYS",
           "PERF_PROGRAM_KEYS", "PERF_SPEC_KEYS"]

# snapshot()["perf"] schema contract (additions only, never renames)
PERF_KEYS = (
    "enabled", "device", "programs", "attributed_s", "step_total_s",
    "attributed_fraction", "decode_roofline", "spec",
)
# the "spec" sub-section (speculative-decoding economy; the serving
# metrics facade fills it from its counters, this module only pins the
# disabled shape so the schema contract holds on bare reports)
PERF_SPEC_KEYS = (
    "enabled", "k", "drafted_tokens", "accepted_tokens",
    "rejected_tokens", "emitted_tokens", "verify_steps", "slot_steps",
    "fallback_steps", "acceptance_rate",
    "effective_tokens_per_dispatch",
)
# per-program entry schema inside "programs"
PERF_PROGRAM_KEYS = (
    "dispatches", "dispatch_s", "syncs", "sync_s", "total_s",
    "avg_ms", "cost", "roofline_floor_ms", "roofline_fraction",
    "bound",
)


def format_program_key(key):
    """Stable human-readable label for an engine AOT-table key:
    ("decode",) -> "decode", ("prefill", 16, 4) -> "prefill/b16/g4",
    ("paged_prefill", 32) -> "paged_prefill/b32",
    ("chunk_prefill", 8) -> "chunk_prefill/c8"."""
    if isinstance(key, str):
        return key
    kind, rest = key[0], key[1:]
    if kind == "prefill" and len(rest) == 2:
        return f"prefill/b{rest[0]}/g{rest[1]}"
    if kind == "paged_prefill" and len(rest) == 1:
        return f"paged_prefill/b{rest[0]}"
    if kind == "chunk_prefill" and len(rest) == 1:
        return f"chunk_prefill/c{rest[0]}"
    return "/".join(str(p) for p in key)


def disabled_spec_report():
    """The ``perf["spec"]`` section when speculative decoding is off
    (or the report is produced outside a serving engine) — same key
    set as the live section the serving metrics facade fills."""
    return {"enabled": False, "k": None, "drafted_tokens": 0,
            "accepted_tokens": 0, "rejected_tokens": 0,
            "emitted_tokens": 0, "verify_steps": 0, "slot_steps": 0,
            "fallback_steps": 0, "acceptance_rate": None,
            "effective_tokens_per_dispatch": None}


def disabled_perf_report():
    """The ``snapshot()["perf"]`` section of an engine built with
    perf=False — same key set as a live report, so the snapshot
    schema contract holds either way."""
    return {"enabled": False, "device": None, "programs": {},
            "attributed_s": 0.0, "step_total_s": None,
            "attributed_fraction": None, "decode_roofline": None,
            "spec": disabled_spec_report()}


class _Program:
    """One program's measured-time accumulators (histogram children
    read directly — count/sum ARE the dispatch count and total wall)
    plus its compile-time cost annotation."""

    __slots__ = ("h_dispatch", "h_sync", "g_frac", "cost", "priced",
                 "flops_sum", "bytes_sum")

    def __init__(self, h_dispatch, h_sync, g_frac):
        self.h_dispatch = h_dispatch
        self.h_sync = h_sync
        self.g_frac = g_frac
        self.cost = None
        self.priced = 0           # dispatches priced by accrue_cost
        self.flops_sum = 0.0
        self.bytes_sum = 0.0

    def measured_avg_s(self):
        """Host-observed seconds per dispatch: (dispatch + sync wall)
        over dispatch count. Pipelining overlaps a step's sync with
        the next step's dispatch, so this is the engine's EFFECTIVE
        per-dispatch cost — conservative vs pure device time, which
        makes the roofline fraction an honest lower bound."""
        n = self.h_dispatch.count
        if not n:
            return None
        return (self.h_dispatch.sum + self.h_sync.sum) / n


class ProgramPerf:
    """Registry-backed per-program perf accumulator. ``enabled=False``
    registers nothing and turns every record into a no-op (the engine
    additionally skips the perf_counter reads), so a perf-off engine
    pays zero and exposes the disabled report shape."""

    def __init__(self, registry, enabled=True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._programs = {}      # AOT key tuple -> _Program
        self._device = None
        self._peak_flops = None
        self._hbm_bps = None
        self._decode_model = None
        if not self.enabled:
            return
        self._h_dispatch = registry.histogram(
            "serving_program_dispatch_seconds",
            "measured wall seconds issuing ONE dispatch of each "
            "compiled program (AOT-table key as the program label)",
            labelnames=("program",))
        self._h_sync = registry.histogram(
            "serving_program_sync_seconds",
            "measured wall seconds blocked reading back each "
            "program's dispatched results",
            labelnames=("program",))
        self._g_frac = registry.gauge(
            "serving_roofline_fraction",
            "achieved fraction of the device roofline per program: "
            "priced floor over measured per-dispatch wall "
            "(0 until the program has cost + measurements)",
            labelnames=("program",))

    # ------------------------------------------------------- device
    def set_device(self, platform, kind, peak_flops=None,
                   hbm_bps=None):
        """Price the roofline: the device's peak FLOP/s and HBM
        bytes/sec. An unknown value stays None (its roofline term drops
        out; with both unknown no fraction is computed) and the report's
        ``device_peak`` / ``device_hbm`` flags read false."""
        self._peak_flops = float(peak_flops) if peak_flops else None
        self._hbm_bps = float(hbm_bps) if hbm_bps else None
        self._device = {
            "platform": str(platform),
            "kind": str(kind),
            "peak_flops": self._peak_flops,
            "hbm_bps": self._hbm_bps,
            "device_peak": bool(peak_flops),
            "device_hbm": bool(hbm_bps),
        }

    @property
    def peak_flops(self):
        return self._peak_flops

    @property
    def hbm_bps(self):
        return self._hbm_bps

    def set_decode_model(self, model):
        """Attach the analytic decode-step model (roofline.
        decode_step_model output) the report joins against the decode
        program's measurements."""
        self._decode_model = dict(model)

    # ---------------------------------------------------- recording
    def _prog(self, key):
        p = self._programs.get(key)
        if p is None:
            with self._lock:
                p = self._programs.get(key)
                if p is None:
                    label = format_program_key(key)
                    p = _Program(self._h_dispatch.labels(label),
                                 self._h_sync.labels(label),
                                 self._g_frac.labels(label))
                    self._programs[key] = p
        return p

    def prefill_seconds(self):
        """Measured wall seconds accrued by the prefill-family
        programs (bucketed/grouped, paged, chunked) — dispatch + sync.
        The cache observatory divides this by prefill-computed tokens
        for its per-token savings attribution."""
        if not self.enabled:
            return 0.0
        with self._lock:
            items = list(self._programs.items())
        total = 0.0
        for key, prog in items:
            kind = key if isinstance(key, str) else key[0]
            if kind in ("prefill", "paged_prefill", "chunk_prefill"):
                total += prog.h_dispatch.sum + prog.h_sync.sum
        return total

    def record_dispatch(self, key, dt):
        if not self.enabled:
            return
        self._prog(key).h_dispatch.observe(dt)

    def record_sync(self, key, dt):
        if not self.enabled:
            return
        self._prog(key).h_sync.observe(dt)

    def bind_cost(self, key, cost):
        """Attach a program's fixed cost (``{"flops", "bytes_accessed"}``
        per dispatch) and arm its pull-gauge: the Prometheus fraction is
        computed from live accumulators at scrape time."""
        if not self.enabled or not cost:
            return
        prog = self._prog(key)
        prog.cost = dict(cost)
        self._arm(prog)

    def accrue_cost(self, key, flops, bytes_accessed):
        """Price ONE dispatch of ``key`` (the port's engine calls this
        beside ``record_dispatch`` with ``roofline.program_cost``'s
        numbers): the program's ``cost`` becomes the mean over its
        priced dispatches, so the work a dispatch needs may change with
        the data (live KV lengths, prompt tails). Returns that mean cost
        (None with perf off)."""
        if not self.enabled:
            return None
        prog = self._prog(key)
        prog.priced += 1
        prog.flops_sum += float(flops)
        prog.bytes_sum += float(bytes_accessed)
        first = prog.cost is None
        prog.cost = {"flops": prog.flops_sum / prog.priced,
                     "bytes_accessed": prog.bytes_sum / prog.priced}
        if first:
            self._arm(prog)
        return prog.cost

    def _arm(self, prog):
        def frac(prog=prog, self=self):
            f = self._fraction(prog)
            return 0.0 if f is None else f
        prog.g_frac.set_function(frac)

    # ---------------------------------------------------- reporting
    def _floor_s(self, prog):
        cost = prog.cost
        if not cost:
            return None, None
        return roofline_floor(cost.get("flops"),
                              cost.get("bytes_accessed"),
                              self._peak_flops, self._hbm_bps)

    def _fraction(self, prog):
        floor_s, _ = self._floor_s(prog)
        measured = prog.measured_avg_s()
        if floor_s is None or not measured:
            return None
        return floor_s / measured

    def report(self, step_total_s=None):
        """The ``snapshot()["perf"]`` / ``/debug/perf`` body. Pass the
        accrued ``serving/step`` span seconds as ``step_total_s`` so
        the report carries how much of the step wall the per-program
        attribution accounts for."""
        if not self.enabled:
            return disabled_perf_report()
        with self._lock:
            items = sorted(self._programs.items(),
                           key=lambda kv: format_program_key(kv[0]))
        programs = {}
        attributed = 0.0
        decode_measured = None
        for key, prog in items:
            d_n, d_s = prog.h_dispatch.count, prog.h_dispatch.sum
            s_n, s_s = prog.h_sync.count, prog.h_sync.sum
            if not d_n and not s_n:
                continue
            total = d_s + s_s
            attributed += total
            avg_ms = total / d_n * 1e3 if d_n else None
            floor_s, bound = self._floor_s(prog)
            frac = self._fraction(prog)
            label = format_program_key(key)
            if key == ("decode",):
                decode_measured = avg_ms
            programs[label] = {
                "dispatches": d_n,
                "dispatch_s": round(d_s, 6),
                "syncs": s_n,
                "sync_s": round(s_s, 6),
                "total_s": round(total, 6),
                "avg_ms": round(avg_ms, 4) if avg_ms is not None
                else None,
                "cost": dict(prog.cost) if prog.cost else None,
                "roofline_floor_ms": round(floor_s * 1e3, 6)
                if floor_s is not None else None,
                "roofline_fraction": round(frac, 6)
                if frac is not None else None,
                "bound": bound,
            }
        decode_roofline = None
        if self._decode_model is not None:
            model = dict(self._decode_model)
            floor_ms = model.get("floor_ms")
            decode_roofline = {
                "model": model,
                "measured_avg_ms": decode_measured,
                "achieved_fraction": round(floor_ms / decode_measured,
                                           6)
                if floor_ms and decode_measured else None,
            }
        return {
            "enabled": True,
            "device": dict(self._device) if self._device else None,
            "programs": programs,
            "attributed_s": round(attributed, 6),
            "step_total_s": round(step_total_s, 6)
            if step_total_s is not None else None,
            "attributed_fraction": round(attributed / step_total_s, 4)
            if step_total_s else None,
            "decode_roofline": decode_roofline,
            # overwritten by the serving metrics facade with the live
            # speculation economy; the key exists on every report
            "spec": disabled_spec_report(),
        }


def build_decode_model(batch, kv_len, num_layers, num_heads, head_dim,
                       n_params, param_bytes, kv_bytes, paged,
                       peak_flops, hbm_bps, layout=None):
    """Thin convenience wrapper over ``roofline.decode_step_model``.
    ``layout`` names the attention path the engine runs ("contiguous" |
    "paged_xla" | "paged_pallas"); the bool ``paged`` alone means the
    composed gather."""
    return decode_step_model(
        batch=batch, kv_len=kv_len, num_layers=num_layers,
        num_heads=num_heads, head_dim=head_dim, n_params=n_params,
        param_bytes=param_bytes, kv_bytes=kv_bytes, paged=paged,
        layout=layout, peak_flops=peak_flops, hbm_bps=hbm_bps)
