"""Continuous-batching inference engine (a port of
``paddle_tpu/serving/engine.py``). One engine step:

  1. prerelease: slots whose request's max-token stop is already decided
     by tokens in flight free now;
  2. triage: the scheduling policy sheds or defers queued requests whose
     TTFT target is already lost (FIFO by default: nothing);
  3. admission + prefill. On the paged pool (the port's default) each
     admitted request pins its longest cached prefix (radix index) and
     prefills only the uncached tail; on the slot-contiguous pool
     (``paged=False``, the reference's default) admissions prefill in
     same-bucket groups, one call a group. With ``prefill_chunk`` set,
     prompts longer than a chunk prefill chunk by chunk, under
     ``prefill_token_budget`` chunk tokens a step, between decode steps;
  4. ONE pooled decode advances every slot a token: on the paged pool
     its attention goes through the paged decode kernel (K4), on the
     slot pool through ``cached_slot_attention``. With ``speculative=
     True`` a step where some slot has an n-gram draft runs the k-token
     verify program instead, which emits 1..k+1 tokens a slot;
  5. harvest: the PREVIOUS step's tokens are read on the host (with
     speculation, at the top of the step, since drafts extend the last
     harvested token).

One-step-deep pipeline (``async_depth=1``): the token and position
vectors stay on the device and chain from one program to the next; each
step's tokens are copied without blocking into pinned host memory behind
a CUDA event, and that event is waited on only after the next step has
been queued, so the host's bookkeeping overlaps the card's work. A
request that stops on EOS has one more token in flight, which the
harvest masks; max-token stops are known at dispatch and pay nothing.
``async_depth=0`` harvests every dispatch at once.

``sampling=True`` gives each slot its own temperature / top-k / top-p
and seed (``serving.sched.sampling``) inside the same programs.
Disaggregation: a ``role="prefill"`` engine serves ``hold_kv=True``
requests, whose slots stay live after they retire until ``export_kv``
serializes the prompt's blocks (``serving.kv_wire``); a ``role="decode"``
engine's ``import_kv`` binds them into fresh blocks and resumes the
stream at its first decode step. Roles need the paged pool.

The engine runs eagerly; PyTorch queues each kernel as the host reaches
it, so there is nothing to compile or warm.

Hardening (``serving.resilience``): ``add_request(deadline_ms=)``
retires a request past its deadline, queued or decoding; a failed
dispatch rolls back leak-free (slot, blocks and radix refs released,
request re-queued) and, with ``max_dispatch_retries`` > 0, is retried
on a later step (``retry_backoff_s`` spaces the retries) until the
request's budget runs out and it retires with reason "error"; a slot
that keeps failing is quarantined (``quarantine_after``), never the
last one; ``drain()`` finishes submitted work, ``close()`` aborts it
explicitly; a raising ``on_token`` callback is counted, never fatal.
``chaos=`` arms the seeded fault injector at the reference's seams,
each of which fires BEFORE its device call, so a rollback leaves the
device state as it was. With ``health=True`` (the default) every step
appends a row to the health ledger and runs the anomaly detectors; the
supervisor (on with health) answers a wedge verdict with an in-process
restart: fresh pools and programs, in-flight requests re-queued for an
exact greedy replay.

Observatories, as in the reference, all on by default: the request
flight recorder (``/debug/requests``, ``?tenant=`` filters), the SLO
tracker (``slo_ttft_ms``/``slo_tpot_ms`` over ``slo_window_s``), the
tenant ledger (``add_request(tenant_id=)``, at most ``max_tenants`` live
ids), per-program perf attribution with roofline fractions (``perf``,
``/debug/perf``), the cache observatory over the paged pool
(``cache_observatory``, ``/debug/cache``) and the per-hop trace span
ring (``trace_spans``, ``/debug/traces``). The perf observatory prices
each dispatch from its shapes (``observability.perf.program_cost``):
the reference prices its compiled programs with XLA's
``cost_analysis``. The decode program runs K4 on the card and is priced
as the ``"paged_pallas"`` layout, with each slot's live length; on the
CPU the plain paged version gathers and is priced as ``"paged_xla"``;
the slot pool is ``"contiguous"``. The dispatch leg is the host time to
queue a program (CUDA launches return at once) and the sync leg the
wait in the host read-back: nothing synchronizes the card to time a
dispatch.
"""
import time
import weakref

import numpy as np
import torch

from ..core.device import resolve_device
from ..observability.fleet import ReplicaIdentity
from ..observability.flight import FlightRecorder
from ..observability.health import HealthMonitor, IncidentRecorder
from ..observability.perf import (build_decode_model, hbm_bps_for,
                                  peak_flops_for, program_cost)
from ..observability.registry import start_metrics_server
from ..observability.trace import (TraceAssembler, TraceContext,
                                   TraceRecorder)
from ..observability.tracing import default_recorder
from ..observability.watchdog import CompileWatchdog
from . import kv_wire
from .kv_pool import SlotKVPool
from .metrics import ServingMetrics
from .paged.pool import PagedKVPool, upload
from .paged.programs import build_paged_fns
from .resilience import EngineSupervisor, resolve_chaos
from .sched import (ChunkPlan, SlotSampler, request_sampling_params,
                    resolve_policy)
from .sched.sampling import upload_params
from .scheduler import QUEUED, RUNNING, Request, StepScheduler
from .spec import SpecDecoder


def _weak_method(method, default):
    """A bound engine method as a weakly-referencing callable
    (``default()`` once the engine is gone): callbacks handed to the
    health monitor and the metrics must not keep a dead engine alive."""
    ref = weakref.WeakMethod(method)

    def call():
        m = ref()
        return default() if m is None else m()
    return call


def default_buckets(cache_len, bucket_min=32):
    """Geometric prefill bucket set bucket_min, 2x, 4x, ... capped at
    cache_len, which is always included."""
    if bucket_min < 1:
        raise ValueError(f"bucket_min must be >= 1, got {bucket_min}")
    buckets = []
    b = int(bucket_min)
    while b < cache_len:
        buckets.append(b)
        b *= 2
    buckets.append(int(cache_len))
    return buckets


def default_group_sizes(num_slots):
    """Geometric prefill group sizes 1, 2, 4, ... capped at
    num_slots."""
    if num_slots < 1:
        raise ValueError(f"num_slots must be >= 1, got {num_slots}")
    sizes = []
    g = 1
    while g <= num_slots:
        sizes.append(g)
        g *= 2
    return sizes


class ServingConfig:
    """num_slots sizes the decode batch; max_len is the per-slot capacity
    (default: the model's max_seq_len); buckets/bucket_min the prefill
    pad widths; prefill_group_sizes the slot pool's prefill group sizes
    (default 1, 2, 4, ... up to num_slots); eos_id the default stop
    token; async_depth 1 (pipelined) or 0 (synchronous); device where the
    engine runs (None = the card).

    paged selects the pool: True (the port's default) the paged pool with
    its radix prefix cache (block_size/num_blocks), False the
    slot-contiguous pool (the reference's default, read there from
    PADDLE_PAGED_KV). prefill_chunk/prefill_token_budget chunk long
    prompts (budget default: one chunk a step); policy ("fifo",
    "slo_feedback" or a SchedulingPolicy) with slo_ttft_ms triages the
    queue; sampling turns on per-slot sampling; speculative/spec_k/
    spec_min_accept self-drafting speculative decoding (greedy only);
    role "monolithic", "prefill" or "decode" (the last two need the
    paged pool).

    Operations, as in the reference: ``health`` (default on) runs the
    per-step ledger and anomaly detectors (``health_audit_every`` steps
    between paged-pool conservation audits, ``health_ledger_keep`` rows,
    ``health_detectors`` per-detector overrides, ``incident_dir`` /
    ``incident_keep`` / ``health_debounce_s`` incident bundles);
    ``chaos`` a FaultPlan / seed / dict arming fault injection;
    ``max_dispatch_retries`` (0: a failed dispatch rolls back and
    raises) with ``retry_backoff_s`` the base of the exponential
    admission backoff; ``quarantine_after`` same-slot failures exclude a
    slot; ``supervisor`` (None: on with health) with
    ``supervisor_max_restarts`` / ``supervisor_cooldown_s``;
    ``replica_id`` (default host:pid); ``watchdog_mode`` "flag" or
    "raise".

    Observatories, as in the reference: ``perf`` (per-program
    attribution; ``peak_flops`` overrides the card's table), the cache
    observatory (``cache_observatory``, ``cache_sample_rate``), the SLO
    tracker (``slo_ttft_ms``, ``slo_tpot_ms``, ``slo_window_s``), the
    flight recorder (``completed_keep`` retired requests kept by the
    scheduler, ``trace_keep`` traces, a progress event every
    ``trace_decode_window`` tokens), the trace span ring
    (``trace_spans``, ``trace_span_keep``) and the tenant ledger
    (``max_tenants``; 0 disables it). Each defaults as the reference's
    does with its environment variable unset.

    Not taken: the reference's environment gates, ``donate_buffers``
    (PyTorch has no buffer donation) and ``paged_attn`` (the card always
    runs K4)."""

    def __init__(self, num_slots=8, max_len=None, buckets=None,
                 bucket_min=32, eos_id=None, prefill_group_sizes=None,
                 async_depth=1, block_size=16, num_blocks=None, device=None,
                 paged=True, prefill_chunk=None, prefill_token_budget=None,
                 policy=None, slo_ttft_ms=None, sampling=False,
                 speculative=False, spec_k=4, spec_min_accept=0.35,
                 role="monolithic", health=True, health_audit_every=64,
                 health_ledger_keep=512, health_detectors=None,
                 incident_dir=None, incident_keep=16,
                 health_debounce_s=60.0, chaos=None,
                 max_dispatch_retries=0, retry_backoff_s=0.0,
                 quarantine_after=3, supervisor=None,
                 supervisor_max_restarts=8, supervisor_cooldown_s=1.0,
                 replica_id=None, watchdog_mode="flag", perf=True,
                 peak_flops=None, cache_observatory=True,
                 cache_sample_rate=0.125, slo_tpot_ms=None,
                 slo_window_s=60.0, completed_keep=4096, trace_keep=256,
                 trace_decode_window=32, trace_spans=True,
                 trace_span_keep=4096, max_tenants=32):
        self.num_slots = int(num_slots)
        self.max_len = max_len
        self.buckets = buckets
        self.bucket_min = int(bucket_min)
        self.eos_id = eos_id
        self.prefill_group_sizes = prefill_group_sizes
        self.async_depth = int(async_depth)
        if self.async_depth not in (0, 1):
            raise ValueError(
                f"async_depth must be 0 (synchronous) or 1 (one-step-"
                f"deep pipeline), got {async_depth}")
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        self.device = device
        self.paged = bool(paged)
        self.prefill_chunk = None if prefill_chunk is None \
            else int(prefill_chunk)
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefill_token_budget is not None:
            if self.prefill_chunk is None:
                raise ValueError(
                    "prefill_token_budget requires chunked prefill (set "
                    "prefill_chunk); without chunking the budget would "
                    "silently never apply")
            prefill_token_budget = int(prefill_token_budget)
            if prefill_token_budget < self.prefill_chunk:
                raise ValueError(
                    f"prefill_token_budget {prefill_token_budget} cannot "
                    f"be smaller than prefill_chunk {self.prefill_chunk} "
                    f"(no chunk could ever dispatch)")
        else:
            prefill_token_budget = self.prefill_chunk
        self.prefill_token_budget = prefill_token_budget
        self.policy = policy
        self.slo_ttft_ms = slo_ttft_ms
        self.sampling = bool(sampling)
        self.speculative = bool(speculative)
        self.spec_k = int(spec_k)
        self.spec_min_accept = float(spec_min_accept)
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if not 0.0 <= self.spec_min_accept <= 1.0:
            raise ValueError(f"spec_min_accept must be in [0, 1], got "
                             f"{spec_min_accept}")
        if self.speculative and self.sampling:
            raise ValueError(
                "speculative decoding is greedy-only (draft acceptance "
                "compares against argmax); drop sampling=True or "
                "speculative=True")
        role = str(role)
        if role not in ("prefill", "decode", "monolithic"):
            raise ValueError(f"role must be 'prefill', 'decode' or "
                             f"'monolithic', got {role!r}")
        self.role = role
        self.health = bool(health)
        self.health_audit_every = int(health_audit_every)
        if self.health_audit_every < 1:
            raise ValueError(f"health_audit_every must be >= 1, got "
                             f"{health_audit_every}")
        self.health_ledger_keep = int(health_ledger_keep)
        self.health_detectors = health_detectors
        self.incident_dir = incident_dir
        self.incident_keep = int(incident_keep)
        self.health_debounce_s = float(health_debounce_s)
        self.chaos = chaos
        self.max_dispatch_retries = int(max_dispatch_retries)
        if self.max_dispatch_retries < 0:
            raise ValueError(f"max_dispatch_retries must be >= 0, got "
                             f"{max_dispatch_retries}")
        self.retry_backoff_s = float(retry_backoff_s)
        self.quarantine_after = int(quarantine_after)
        if self.quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {quarantine_after}")
        self.supervisor = supervisor
        self.supervisor_max_restarts = int(supervisor_max_restarts)
        self.supervisor_cooldown_s = float(supervisor_cooldown_s)
        self.replica_id = replica_id
        self.watchdog_mode = watchdog_mode
        self.perf = bool(perf)
        self.peak_flops = peak_flops
        self.cache_observatory = bool(cache_observatory)
        self.cache_sample_rate = float(cache_sample_rate)
        self.slo_tpot_ms = slo_tpot_ms
        self.slo_window_s = float(slo_window_s)
        self.completed_keep = completed_keep
        self.trace_keep = int(trace_keep)
        self.trace_decode_window = int(trace_decode_window)
        self.trace_spans = bool(trace_spans)
        self.trace_span_keep = int(trace_span_keep)
        if self.trace_span_keep < 1:
            raise ValueError(
                f"trace_span_keep must be >= 1, got {trace_span_keep}")
        self.max_tenants = int(max_tenants)
        if self.max_tenants < 0:
            raise ValueError(f"max_tenants must be >= 0, got {max_tenants}")


class ServingEngine:
    """Continuous-batching engine over a GPTForCausalLM. Weights are
    snapshotted at construction. Typical use::

        eng = ServingEngine(model, num_slots=8)
        reqs = [eng.add_request(p, max_new_tokens=64) for p in prompts]
        eng.run()                 # or eng.step() in a service loop
        reqs[0].output_ids        # prompt + generated
    """

    def __init__(self, model, config=None, **kwargs):
        if config is None:
            config = ServingConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either config= or knob kwargs, not both")
        self.config = config
        self.device = resolve_device(config.device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, the engine on "
                             f"{self.device}")
        cfg = model.cfg
        cache_len = int(config.max_len or cfg.max_seq_len)
        if cache_len > cfg.max_seq_len:
            raise ValueError(
                f"max_len {cache_len} exceeds the model's position "
                f"table max_seq_len {cfg.max_seq_len}")
        buckets = config.buckets or default_buckets(cache_len,
                                                    config.bucket_min)
        if max(buckets) > cache_len:
            raise ValueError("prefill buckets cannot exceed max_len")
        sizes = (config.prefill_group_sizes
                 or default_group_sizes(config.num_slots))
        self.group_sizes = sorted(int(g) for g in sizes)
        if self.group_sizes[0] != 1:
            raise ValueError("prefill_group_sizes must include 1")
        if self.group_sizes[-1] > config.num_slots:
            raise ValueError(
                f"prefill group size {self.group_sizes[-1]} exceeds "
                f"num_slots {config.num_slots}")
        self.cache_len = cache_len
        self._model = model
        self.params = model.export_decode_params()
        self.paged = config.paged
        self.sampling = config.sampling
        self.chunk_len = config.prefill_chunk
        self.prefill_token_budget = config.prefill_token_budget
        if self.chunk_len is not None and self.chunk_len > cache_len:
            raise ValueError(
                f"prefill_chunk {self.chunk_len} exceeds the per-slot "
                f"capacity {cache_len}")
        self.role = config.role
        if self.role != "monolithic" and not self.paged:
            raise ValueError(
                f"role={self.role!r} requires the paged pool "
                f"(paged=True): the refcounted block is the KV wire unit")
        S = config.num_slots
        self.speculative = config.speculative
        self.spec_k = config.spec_k
        self._spec = None
        if self.speculative:
            if self.spec_k + 1 > cache_len:
                raise ValueError(
                    f"spec_k + 1 ({self.spec_k + 1}) exceeds the per-slot "
                    f"cache capacity {cache_len}")
            self._spec = SpecDecoder(S, self.spec_k, config.spec_min_accept)
        # the reference's program keys (its AOT table's): the chaos
        # harness's compile_storm seam is drawn where a keyed program
        # is used again, as the reference draws where it reuses one
        self._verify_key = (("paged_spec_verify",) if self.paged
                            else ("spec_verify",))
        self._used_programs = set()
        self.pool = self._new_pool()
        self._build_programs()
        self._sampler = SlotSampler(S, self.device) if self.sampling \
            else None
        self._chunk_q = []        # ChunkPlans awaiting chunk dispatch
        self._prefilling = set()  # slots parked mid-chunked-prefill
        self._policy = resolve_policy(config.policy, config.slo_ttft_ms)
        self.flight = FlightRecorder(
            keep_last=config.trace_keep,
            decode_window=config.trace_decode_window)
        self.scheduler = StepScheduler(
            buckets, cache_len, completed_keep=config.completed_keep,
            policy=self._policy, flight=self.flight)
        self.metrics = M = ServingMetrics(
            slo_ttft_ms=config.slo_ttft_ms, slo_tpot_ms=config.slo_tpot_ms,
            slo_window_s=config.slo_window_s, perf=config.perf,
            cache=config.cache_observatory,
            cache_sample_rate=config.cache_sample_rate,
            max_tenants=config.max_tenants)
        self._perf_on = config.perf
        if self.paged:
            M.set_prefix_pool(self.pool.stats)
            M.cache.attach_pool(self.pool)
        M.set_spec(self.speculative, self.spec_k)

        # scrape-time per-tenant queue depth: a read-only walk of the
        # queue
        def _tenant_queue_depths(sch=self.scheduler):
            depths = {}
            for r in sch.queue:
                depths[r.tenant_id] = depths.get(r.tenant_id, 0) + 1
            return depths
        M.tenants.set_queue_probe(_tenant_queue_depths)
        M.set_scheduler_info(self._policy.name, self.chunk_len,
                             self.prefill_token_budget)
        # rolling device state: last token and next write position per
        # slot; programs chain them, so step N+1 never waits on step N's
        # values reaching the host
        self._toks = torch.zeros(S, dtype=torch.int32, device=self.device)
        self._pos = torch.zeros(S, dtype=torch.int32, device=self.device)
        self._pending = []        # dispatched, not yet read back
        self._held_exports = {}   # rid -> retired hold_kv request
        self._metric_servers = []
        self.identity = ReplicaIdentity(config.replica_id)
        self.replica_id = self.identity.replica_id
        M.set_identity(self.identity, torch_version=torch.__version__)
        # this replica's per-hop trace spans, keyed by each request's
        # TraceContext: /debug/traces, snapshot()["trace"], incidents
        self.trace = TraceRecorder(self.replica_id,
                                   capacity=config.trace_span_keep,
                                   enabled=config.trace_spans)
        M.set_trace(self.trace.snapshot)
        self.watchdog = CompileWatchdog(mode=config.watchdog_mode)
        # resilience: chaos harness + retry/quarantine/drain state
        self.chaos = resolve_chaos(config.chaos)
        if self.chaos is not None:
            self.chaos.bind(on_fire=M.record_fault,
                            recorder=default_recorder())
        self.max_dispatch_retries = config.max_dispatch_retries
        self.retry_backoff_s = config.retry_backoff_s
        self._retry_at = 0.0          # admission backoff gate
        self._decode_fail_streak = 0
        self._slot_failures = {}      # slot -> consecutive failures
        self._draining = False
        self._closed = False
        self._deadlines_armed = False
        self._restart_epoch = 0       # bumped by supervisor restarts
        M.set_resilience(_weak_method(
            self._resilience_state,
            lambda: {"quarantined_slots": [], "draining": False,
                     "supervisor": {"enabled": False},
                     "chaos": {"enabled": False}}))
        # health observatory: per-step ledger + anomaly detectors +
        # (with an incident_dir) bundle capture
        self._step_id = 0
        self._hprev = None            # previous step's cumulative counts
        self.health = None
        if config.health:
            incidents = None
            if config.incident_dir:
                incidents = IncidentRecorder(
                    config.incident_dir, keep_last=config.incident_keep,
                    debounce_s=config.health_debounce_s)
            rec = default_recorder()

            def _spans_tail(rec=rec):
                return [{"name": sp.name, "t0": round(sp.t0, 6),
                         "dur": round(sp.dur, 6), "tid": sp.tid}
                        for sp in rec.spans()[-120:]]

            def _incident_traces(trace=self.trace, flight=self.flight):
                # assembled traces of the requests in flight at capture
                # time, from the spans this replica holds
                tids = sorted({t.trace_id for t in flight.active()
                               if t.trace_id is not None})
                asm = TraceAssembler()
                asm.add_recorder(trace)
                out = []
                for tid in tids:
                    at = asm.assemble(tid)
                    if at is not None:
                        out.append(at.as_dict())
                return out

            context = {"metrics": M.snapshot,
                       "watchdog": self.watchdog.report,
                       "requests": self.flight.debug_requests,
                       "spans_tail": _spans_tail,
                       "traces": _incident_traces,
                       "replica": M.identity_report,
                       # the noisy-neighbor suspect list
                       "tenants": M.tenants.top}
            if self.chaos is not None:
                # a chaos-found incident replays from its bundle alone
                context["chaos"] = self.chaos.report
            self.health = HealthMonitor(
                M.registry, ledger_keep=config.health_ledger_keep,
                detector_config=config.health_detectors,
                incidents=incidents, context=context)
            self.health.attach_resilience(_weak_method(
                self._health_resilience,
                lambda: {"degraded": False, "draining": False,
                         "restarts": 0}))
            self.health.attach_identity(M.identity_report)
            M.set_health(self.health.summary)
        # the supervisor is on with the health observatory (its wedge
        # verdicts are the restart triggers); True works without it
        # (the dispatch-failure escalation needs no detector)
        sup_on = config.supervisor if config.supervisor is not None \
            else self.health is not None
        self.supervisor = EngineSupervisor(
            self, max_restarts=config.supervisor_max_restarts,
            cooldown_s=config.supervisor_cooldown_s) if sup_on else None
        self._slo_on = (config.slo_ttft_ms is not None
                        or config.slo_tpot_ms is not None)
        self._bind_device_cost(model)

    def _bind_device_cost(self, model):
        """The device's peak FLOP/s and HBM bandwidth (the card's
        data-sheet table by ``torch.cuda.get_device_name()``; None on the
        CPU unless ``peak_flops`` is given), the HBM gauges (a CUDA
        device only), the decode layout the perf observatory prices, and
        the static decode-step model (every slot at its full capacity:
        the most a decode can read)."""
        config, cfg, M = self.config, model.cfg, self.metrics
        dev = self.device
        if dev.type == "cuda":
            kind = torch.cuda.get_device_name(dev)
            hbm = hbm_bps_for(kind)
            peak = config.peak_flops or peak_flops_for(kind)

            def memory(dev=dev):
                in_use = torch.cuda.memory_allocated(dev)
                limit = torch.cuda.mem_get_info(dev)[1]
                return {"bytes_in_use": in_use, "bytes_limit": limit,
                        "bytes_free": limit - in_use}
            M.enable_device_memory(memory)
            self.decode_layout = "paged_pallas" if self.paged \
                else "contiguous"
        else:
            kind, hbm, peak = "cpu", None, config.peak_flops
            self.decode_layout = "paged_xla" if self.paged \
                else "contiguous"
        M.set_peak_flops(peak)
        nh = cfg.num_heads
        self._cost_dims = dims = dict(
            # tied weights are one parameter: each tensor counts once
            n_params=sum(p.numel() for p in model.parameters()),
            num_layers=cfg.num_layers, num_heads=nh,
            head_dim=cfg.hidden_size // nh,
            param_bytes=self.params["wemb"].element_size(),
            kv_bytes=self.pool.kc.element_size(), layout=self.decode_layout)
        if not self._perf_on:
            return
        M.perf.set_device(dev.type, kind, peak_flops=peak, hbm_bps=hbm)
        M.perf.set_decode_model(build_decode_model(
            batch=config.num_slots, kv_len=self.cache_len,
            paged=self.paged, peak_flops=peak, hbm_bps=hbm, **dims))

    def _price(self, key, positions):
        """Price one dispatch of program ``key`` from its shapes
        (``positions``: ``(cached, new tokens)`` per sequence) into the
        perf observatory; the decode program's mean price also feeds the
        MFU gauge."""
        cost = program_cost(positions, kv_len=self.cache_len,
                            **self._cost_dims)
        mean = self.metrics.perf.accrue_cost(key, cost["flops"],
                                             cost["bytes_accessed"])
        if key == ("decode",):
            self.metrics.set_decode_cost(mean["flops"],
                                         mean["bytes_accessed"])

    def _timed(self, key, fn, *args):
        """Run one serving program: its host seconds go to the dispatch
        leg (the health ledger's ``dispatch_s``) and, with perf on, to
        its program key."""
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        self.metrics.dispatch_s += dt
        if self._perf_on:
            self.metrics.perf.record_dispatch(key, dt)
        return out

    def _new_pool(self):
        cfg, config = self._model.cfg, self.config
        nh = cfg.num_heads
        args = (config.num_slots, cfg.num_layers, nh, self.cache_len,
                cfg.hidden_size // nh)
        if self.paged:
            return PagedKVPool(*args, block_size=config.block_size,
                               num_blocks=config.num_blocks,
                               device=self.device)
        return SlotKVPool(*args, device=self.device)

    def _build_programs(self):
        """The serving programs over the current pool's geometry (the
        supervisor's restart builds them anew, dropping whatever a
        wedged one held)."""
        model, pool, S = self._model, self.pool, self.config.num_slots
        if self.paged:
            geometry = (pool.block_size, pool.num_blocks,
                        pool.blocks_per_slot)
            self._prefill_fn, self._decode_fn = build_paged_fns(
                model.cfg, S, *geometry, sampling=self.sampling)
            self._chunk_fn = self._prefill_fn   # chunks are tails
        else:
            self._prefill_fn, self._decode_fn = model.build_serving_fns(
                S, self.cache_len, sampling=self.sampling)
            self._chunk_fn = model.build_chunk_prefill_fn(
                self.cache_len, sampling=self.sampling) \
                if self.chunk_len is not None else None
        self._verify_fn = None
        if self.speculative:
            self._verify_fn = model.build_paged_spec_verify_fn(
                S, *geometry, self.spec_k) if self.paged \
                else model.build_spec_verify_fn(S, self.cache_len,
                                                self.spec_k)

    def _use_program(self, key):
        """The reference's compile_storm seam: it draws where a compiled
        program is reused (a fire evicts it and the call rebuilds it).
        The port builds nothing per shape, so a fire evicts nothing and
        no compile is recorded; the draw keeps the fault schedule
        aligned with the reference's."""
        if key in self._used_programs:
            if self.chaos is not None:
                self.chaos.fires("compile_storm", key=str(key))
        else:
            self._used_programs.add(key)

    # ---------------------------------------------------------- requests

    def add_request(self, prompt, max_new_tokens, eos_id=None,
                    on_token=None, temperature=0.0, top_k=0, top_p=1.0,
                    seed=None, deadline_ms=None, hold_kv=False,
                    trace=None, tenant_id=None):
        """Queue a prompt; returns the Request at once. Tokens stream
        through ``on_token(request, token)`` as they are read back.
        ``temperature``/``top_k``/``top_p``/``seed`` sample this request
        (the engine must have ``sampling=True``); the defaults are
        greedy. ``deadline_ms`` bounds the request from its arrival:
        past it the request retires, queued or decoding, with stop
        reason "deadline". ``hold_kv=True`` (paged pool) keeps the slot
        and its blocks after the request retires, for ``export_kv``.
        ``trace`` is the propagated trace context (a TraceContext, a
        traceparent string or its dict form); whatever arrives is
        coerced, a missing or malformed one to a locally minted root.
        ``tenant_id`` bills the request in the tenant observatory; None
        falls back to the trace baggage's ``"tenant"`` entry, then to
        ``"default"``, and the resolved id is written back into the
        baggage so every later hop inherits it. Raises RuntimeError once
        the engine drains or is closed."""
        if self._draining or self._closed:
            raise RuntimeError(
                "engine is draining/closed: no new requests (drain() "
                "finishes already-submitted work, close() aborts it)")
        if hold_kv and not self.paged:
            raise ValueError("hold_kv requires the paged pool (paged=True):"
                             " the KV wire unit is the paged block")
        ctx = TraceContext.coerce(trace)
        if tenant_id is None:
            tenant_id = ctx.baggage.get("tenant")
        req = Request(prompt, max_new_tokens,
                      eos_id=self.config.eos_id if eos_id is None
                      else eos_id, on_token=on_token,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, deadline_ms=deadline_ms, hold_kv=hold_kv,
                      tenant_id=tenant_id)
        if ctx.baggage.get("tenant") != req.tenant_id:
            # annotation, not a new hop: same trace and span ids
            ctx = TraceContext(ctx.trace_id, ctx.span_id,
                               baggage={**ctx.baggage,
                                        "tenant": req.tenant_id},
                               minted_local=ctx.minted_local)
        req.trace = ctx
        if req.sampled and not self.sampling:
            raise ValueError(
                "sampled request on a greedy engine: build the engine "
                "with ServingConfig(sampling=True) to serve temperature/"
                "top-k/top-p traffic")
        if req.deadline_ms is not None:
            self._deadlines_armed = True
        return self.scheduler.submit(req)

    @property
    def pending(self):
        return self.scheduler.pending or bool(self._pending)

    # ------------------------------------------------------ device reads

    def _to_host(self, *ts):
        """Start the device->host copy of ``ts``: on the card
        non-blocking copies into pinned memory behind one recorded
        event."""
        if ts[0].device.type == "cpu":
            return ts, None
        hosts = []
        for t in ts:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
        ev = torch.cuda.Event()
        ev.record()
        return hosts, ev

    def _read_back(self, handle, key):
        """Wait for one dispatch's host copy and return it as numpy; the
        wait is program ``key``'s sync leg. A failed read (the
        ``transfer`` seam) retries at once up to the retry budget: the
        values stay in their host buffers, so nothing is lost; past the
        budget the failure propagates."""
        hosts, ev = handle
        M = self.metrics
        attempt = 0
        while True:
            try:
                if self.chaos is not None:
                    self.chaos.maybe_raise("transfer")
                t0 = time.perf_counter()
                if ev is not None:
                    ev.synchronize()
                dt = time.perf_counter() - t0
                M.sync_s += dt
                if self._perf_on:
                    M.perf.record_sync(key, dt)
                return [h.numpy() for h in hosts]
            except Exception as e:  # noqa: BLE001 - gated below
                M.record_dispatch_failure("transfer")
                if attempt >= self.max_dispatch_retries \
                        or not self._retryable(e):
                    raise
                attempt += 1
                M.record_retry()

    # --------------------------------------------------------- host side

    def _emit(self, req, token):
        """Account one generated token; retire the request on stop."""
        first = not req.generated
        req.generated.append(token)
        self.metrics.tokens_generated += 1
        if first:
            self.metrics.record_first_token(req)
            if req.t_admitted is not None:
                # the SLO policy's service estimate follows what the
                # engine delivers (nothing here is ever compiled, so no
                # sample is tainted by a build)
                self._policy.observe_service(
                    (req.t_first_token - req.t_admitted) * 1000.0)
                # prefill-side TTFT spans: queue (arrival -> admission)
                # and compute (admission -> first token)
                w = self.trace.wall
                self.trace.record(
                    req.trace, "prefill/queue", w(req.t_arrival),
                    max(0.0, req.t_admitted - req.t_arrival),
                    {"rid": req.rid})
                self.trace.record(
                    req.trace, "prefill/compute", w(req.t_admitted),
                    max(0.0, req.t_first_token - req.t_admitted),
                    {"rid": req.rid})
        elif req.imported and len(req.generated) == 2 \
                and req.t_decode0 is not None:
            # decode-side TTFT spans, closed at the first locally
            # decoded token: queue (import -> first decode dispatch) and
            # first_step (dispatch -> this token)
            w = self.trace.wall
            self.trace.record(
                req.trace, "decode/queue", w(req.t_admitted),
                max(0.0, req.t_decode0 - req.t_admitted), {"rid": req.rid})
            self.trace.record(
                req.trace, "decode/first_step", w(req.t_decode0),
                max(0.0, time.perf_counter() - req.t_decode0),
                {"rid": req.rid})
        self.flight.token_emitted(req, len(req.generated))
        if req.on_token is not None:
            # a user callback never takes the step loop down: a raise
            # is caught and counted, and every slot keeps streaming
            try:
                if self.chaos is not None:
                    self.chaos.maybe_raise("callback",
                                           step=self._step_id + 1)
                req.on_token(req, token)
            except Exception as e:  # noqa: BLE001 - isolation boundary
                self.metrics.record_callback_error()
                self.flight.callback_error(req, e)
        reason = self.scheduler.stop_reason(req, token)
        if reason is not None:
            self.scheduler.finish(req, self.pool, reason)
            violations = self.metrics.record_completion(req)
            self.flight.retired(req, reason,
                                slo_violations=list(violations))
            if self.supervisor is not None:
                self.supervisor.note_completion(req.rid)
            if req.hold_kv and req.slot is not None:
                # prefill-tier retirement: slot and blocks stay live
                # for export_kv(rid)
                self._held_exports[req.rid] = req

    def _harvest(self, pending):
        """Read back dispatched tokens (prefills, chunks and the decode
        of one step, in dispatch order) and run the stop checks."""
        M = self.metrics
        for kind, handle, members, key, *extra in pending:
            vals = self._read_back(handle, key)
            if kind == "prefill":
                for (req, _slot), tok in zip(members, vals[0]):
                    req.inflight -= 1
                    self._emit(req, int(tok))
            elif kind == "spec":
                out, acc = vals
                drafted = extra[0]
                for slot, req in members.items():
                    n_draft = drafted.get(slot, 0)
                    if req.state != RUNNING:
                        # retired (EOS) after this verify went out: the
                        # whole block is masked, its drafts rejected
                        M.speculative_masked += 1
                        M.spec_drafted += n_draft
                        M.spec_rejected += n_draft
                        continue
                    req.inflight -= 1
                    M.spec_slot_steps += 1
                    n_acc = int(acc[slot])
                    # the accepted drafts, then the bonus token; an EOS
                    # inside the block retires the request there
                    for i in range(n_acc + 1):
                        self._emit(req, int(out[slot, i]))
                        M.spec_tokens_emitted += 1
                        if req.state != RUNNING:
                            break
                    if n_draft:
                        M.spec_drafted += n_draft
                        M.spec_accepted += n_acc
                        M.spec_rejected += n_draft - n_acc
                        self._spec.observe(req.rid, n_draft, n_acc)
                        if n_acc:
                            self.flight.draft_accepted(req, n_acc, n_draft)
                        if n_draft > n_acc:
                            self.flight.draft_rejected(
                                req, n_draft - n_acc, n_draft)
            else:
                for slot, req in members.items():
                    if req.state != RUNNING:
                        # stopped on EOS after this decode went out: the
                        # extra token is masked
                        M.speculative_masked += 1
                        continue
                    req.inflight -= 1
                    self._emit(req, int(vals[0][slot]))

    # ------------------------------------------------------------- steps

    def _dispatch(self, entry, sync):
        if sync:
            self._harvest([entry])
        else:
            self._pending.append(entry)

    def _samp_scalars(self, req):
        """``[1]`` sampling parameters of a singleton prefill (paged tail
        or chunk); nothing on a greedy engine."""
        if not self.sampling:
            return ()
        dev = self.device
        return tuple(torch.full((1,), x, dtype=dt, device=dev)
                     for x, dt in zip(request_sampling_params(req),
                                      (torch.int64, torch.float32,
                                       torch.int32, torch.float32)))

    def _triage(self):
        M = self.metrics
        shed, deprioritized = self.scheduler.triage()
        M.record_deprioritized(len(deprioritized))
        for req, headroom in deprioritized:
            self.flight.deprioritized(req, headroom)
        for req, headroom in shed:
            M.record_shed(req.shed_reason, req.tenant_id)
            self.flight.shed(req, req.shed_reason, headroom)

    def _slot_prefills(self, sync):
        """Admission + grouped bucketed prefill over the slot pool. A
        failed dispatch rolls this group and every later one back to the
        queue (slots released), then is absorbed for a retry or raises.
        Prompts longer than the chunk width claim their slot here and
        prefill in ``_dispatch_chunks``."""
        sch, pool, M = self.scheduler, self.pool, self.metrics
        if self.chaos is not None and self.chaos.fires(
                "block_exhaustion", step=self._step_id + 1):
            return          # a simulated dry pool: admission waits
        groups, chunked = sch.admit_chunked(pool, self.group_sizes,
                                            self.chunk_len)
        self._register_chunked(chunked)
        for gi, group in enumerate(groups):
            G = len(group)
            bucket = sch.bucket_for(len(group[0][0].prefill_ids))
            tokens = np.zeros((G, bucket), np.int64)
            lengths = np.zeros((G,), np.int32)
            slots = np.zeros((G,), np.int64)
            for g, (req, slot) in enumerate(group):
                ids = req.prefill_ids
                tokens[g, :len(ids)] = ids
                lengths[g] = len(ids)
                slots[g] = slot
                req.inflight += 1
                if self._sampler is not None:
                    self._sampler.set_slot(slot, req)
            samp = () if not self.sampling else upload_params(
                SlotSampler.gather([r for r, _ in group]), self.device)
            try:
                if self.chaos is not None:
                    self.chaos.maybe_raise("prefill_dispatch",
                                           step=self._step_id + 1)
                key = ("prefill", bucket, G)
                self._use_program(key)
                for req, _slot in group:
                    self.flight.prefill_dispatched(req, bucket, G)
                first, self._toks, self._pos = self._timed(
                    key, self._prefill_fn, self.params,
                    upload(tokens, self.device),
                    upload(lengths, self.device), upload(slots, self.device),
                    self._toks, self._pos, pool.kc, pool.vc, *samp)
            except BaseException as e:
                for req, _slot in group:
                    req.inflight -= 1
                sch.rollback_admission(
                    [r for g in groups[gi:] for r, _ in g], pool)
                if self._absorb_dispatch_failure(e, "prefill", group):
                    return      # rolled back; the retry runs later
                raise
            if self._perf_on:
                self._price(key, [(0, int(n)) for n in lengths])
            # admission accounting lands only once the dispatch stuck
            for req, _slot in group:
                M.record_admission(req)
            M.requests_admitted += G
            M.prefills += 1
            M.prefill_requests += G
            M.record_prefill_group(G, int(lengths.sum()))
            self._dispatch(("prefill", self._to_host(first), group, key),
                           sync)

    def _paged_prefills(self, sync):
        """Prefix-aware admission + tail-only prefill. The prompt's full
        blocks are committed to the radix index only after the prefill
        ran, so a failed prefill rolls back (slot, blocks and radix refs
        released, request re-queued) without poisoning the cache. A tail
        longer than the chunk width is left to ``_dispatch_chunks``."""
        sch, pool, M = self.scheduler, self.pool, self.metrics
        while True:
            if self.chaos is not None and self.chaos.fires(
                    "block_exhaustion", step=self._step_id + 1):
                break       # a simulated dry pool: admission waits
            admission = sch.admit_paged(pool, self.chunk_len)
            if admission is None:
                break
            req, alloc, bucket, chunked = admission
            if chunked:
                self._register_chunked([(req, alloc.slot)],
                                       alloc.prefix_tokens)
                continue
            if self._sampler is not None:
                self._sampler.set_slot(alloc.slot, req)
            ids = req.prefill_ids
            start = alloc.prefix_tokens
            tail = len(ids) - start
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :tail] = ids[start:]
            req.inflight += 1
            try:
                if self.chaos is not None:
                    self.chaos.maybe_raise("prefill_dispatch",
                                           step=self._step_id + 1)
                key = ("paged_prefill", bucket)
                self._use_program(key)
                if start:
                    self.flight.prefix_hit(
                        req, start, tail,
                        saved_ms=M.cache.estimate_saved_ms(start))
                self.flight.prefill_dispatched(req, bucket, 1)
                first, self._toks, self._pos = self._timed(
                    key, self._prefill_fn, self.params,
                    upload(tokens, self.device), tail, start,
                    alloc.slot, 1, pool.table_row(alloc.slot), self._toks,
                    self._pos, pool.kc, pool.vc, *self._samp_scalars(req))
            except BaseException as e:
                req.inflight -= 1
                sch.rollback_admission([req], pool)
                if self._absorb_dispatch_failure(
                        e, "prefill", [(req, alloc.slot)]):
                    return      # rolled back; the retry runs later
                raise
            if self._perf_on:
                self._price(key, [(start, tail)])
            pool.commit_prefix(alloc.slot, ids)
            M.record_admission(req)
            M.requests_admitted += 1
            M.prefills += 1
            M.prefill_requests += 1
            M.record_prefill_group(1, 0)
            M.record_prefix_reuse(start, tail, req.tenant_id)
            self._dispatch(("prefill", self._to_host(first),
                            [(req, alloc.slot)], key), sync)

    def _register_chunked(self, chunked, start0=0):
        """Queue freshly admitted long prompts (their first ``start0``
        tokens cached) for chunk-by-chunk prefill and park their slots
        out of the decode harvest."""
        for req, slot in chunked:
            if self._sampler is not None:
                self._sampler.set_slot(slot, req)
            self._chunk_q.append(ChunkPlan(req, slot, start0,
                                           self.chunk_len))
            self._prefilling.add(slot)

    def _dispatch_chunks(self, sync):
        """Advance chunked prefills: chunks go out FIFO across the queued
        plans until the step's token budget runs out. Interior chunks
        park the slot; the FINAL chunk sets the first token, returns the
        slot to the decode set and lands the admission accounting, so a
        failure anywhere rolls the request back to the queue uncounted,
        all its chunks voided (then absorbed for a retry, or raised)."""
        sch, pool, M = self.scheduler, self.pool, self.metrics
        budget = self.prefill_token_budget
        C = self.chunk_len
        while self._chunk_q and budget > 0:
            plan = self._chunk_q[0]
            req = plan.req
            start, clen, final = plan.peek()
            if clen > budget:
                break           # FIFO: never skip ahead of the head
            tokens = np.zeros((1, C), np.int64)
            tokens[0, :clen] = plan.ids[start:start + clen]
            args = [self.params, upload(tokens, self.device), clen, start,
                    plan.slot, int(final)]
            if self.paged:
                args.append(pool.table_row(plan.slot))
            if final:
                req.inflight += 1
            try:
                if self.chaos is not None:
                    self.chaos.maybe_raise("chunk_dispatch",
                                           step=self._step_id + 1,
                                           chunk=plan.next)
                key = ("paged_prefill", C) if self.paged \
                    else ("chunk_prefill", C)
                self._use_program(key)
                if plan.next == 0 and plan.start0:
                    self.flight.prefix_hit(
                        req, plan.start0, len(plan.ids) - plan.start0,
                        saved_ms=M.cache.estimate_saved_ms(plan.start0))
                self.flight.prefill_chunk(req, plan.next, start, clen,
                                          final)
                if final:
                    self.flight.prefill_dispatched(req, C, 1)
                first, self._toks, self._pos = self._timed(
                    key, self._chunk_fn, *args, self._toks, self._pos,
                    pool.kc, pool.vc, *self._samp_scalars(req))
            except BaseException as e:
                if final:
                    req.inflight -= 1
                self._chunk_q.remove(plan)
                self._prefilling.discard(plan.slot)
                sch.rollback_admission([req], pool)
                if self._absorb_dispatch_failure(
                        e, "chunk", [(req, plan.slot)]):
                    return      # rolled back; the retry re-plans later
                raise
            if self._perf_on:
                self._price(key, [(start, clen)])
            M.record_prefill_chunk(clen)
            budget -= clen
            plan.advance()
            if final:
                self._chunk_q.pop(0)
                self._prefilling.discard(plan.slot)
                if self.paged:
                    pool.commit_prefix(plan.slot, plan.ids)
                    M.record_prefix_reuse(plan.start0, 0, req.tenant_id)
                M.record_admission(req)
                M.requests_admitted += 1
                M.prefill_requests += 1
                M.chunked_requests += 1
                self._dispatch(("prefill", self._to_host(first),
                                [(req, plan.slot)], key), sync)

    def _decode(self, snapshot, sync):
        """One pooled decode (or, when some slot drafted, one verify)
        advancing every slot of ``snapshot``."""
        pool, M = self.pool, self.metrics
        drafted = None
        if self._spec is not None:
            drafts, dlen, drafted = self._spec.propose(snapshot)
            # nobody drafted: the plain decode program outright
            drafted = drafted or None
        if self._perf_on:
            # each slot's cached length before this call: prompt plus
            # tokens read plus tokens in flight, minus the one this call
            # writes
            bases = [len(r.prompt) + len(r.generated) + r.inflight - 1
                     for r in snapshot.values()]
        t_dec = time.perf_counter()
        for req in snapshot.values():
            req.inflight += 1
            if req.t_decode0 is None:
                # an imported request's decode/queue ends here
                req.t_decode0 = t_dec
        try:
            if self.chaos is not None:
                self.chaos.maybe_raise("decode_dispatch",
                                       step=self._step_id + 1)
            self._use_program(("decode",))
            if self._spec is not None:
                self._use_program(self._verify_key)
            tables = (pool.device_tables(),) if self.paged else ()
            if drafted is not None:
                key = self._verify_key
                out, acc, nxt, self._pos = self._timed(
                    key, self._verify_fn, self.params, self._toks,
                    self._pos, upload(drafts, self.device),
                    upload(dlen, self.device), *tables, pool.kc, pool.vc)
            else:
                key = ("decode",)
                samp = self._sampler.device_arrays() if self.sampling \
                    else ()
                nxt, self._pos = self._timed(
                    key, self._decode_fn, self.params, self._toks,
                    self._pos, *tables, pool.kc, pool.vc, *samp)
        except BaseException as e:
            # the seam fires before the call, so the device state is as
            # it was: undo the in-flight marks, then retry on a later
            # step, escalate to the supervisor, or raise
            for req in snapshot.values():
                req.inflight -= 1
            if not self._absorb_decode_failure(e):
                raise
            return
        if self._perf_on:
            width = 1 if drafted is None else self.spec_k + 1
            self._price(key, [(b, width) for b in bases])
        self._toks = nxt
        self._decode_fail_streak = 0
        M.decode_steps += 1
        if drafted is not None:
            M.spec_verify_steps += 1
            entry = ("spec", self._to_host(out, acc), snapshot, key,
                     drafted)
        else:
            if self._spec is not None:
                M.spec_fallback_steps += 1
            entry = ("decode", self._to_host(nxt), snapshot, key)
        self._dispatch(entry, sync)

    @torch.inference_mode()
    def step(self):
        """One engine iteration; returns True while work remains. With
        the health observatory on, the step's row goes to the ledger and
        the detectors after the timed step."""
        t0 = time.perf_counter()
        more = self._step_inner()
        dt = time.perf_counter() - t0
        self.metrics.note_step(dt)
        if self.health is not None:
            self._health_tick(dt)
        # a supervisor restart re-queued work the stale verdict predates
        return more or self.pending

    def _step_inner(self):
        sch, M = self.scheduler, self.metrics
        t0 = time.perf_counter()
        sync = self.config.async_depth == 0
        prev, self._pending = self._pending, []
        worked = bool(prev)
        epoch = self._restart_epoch
        if self._spec is not None and prev:
            # drafts extend the last HARVESTED token: read the previous
            # step's results before proposing
            self._harvest(prev)
            prev = []

        if self.chaos is not None and self.chaos.fires(
                "step_latency", step=self._step_id + 1):
            time.sleep(self.chaos.latency_s())
        if self._deadlines_armed:
            self._expire_deadlines()

        # hold_kv requests never prerelease: their blocks must survive
        # retirement for export_kv
        for req in [r for r in sch.active.values()
                    if sch.saturated(r) and not r.hold_kv]:
            sch.prerelease(req, self.pool)

        self._triage()
        # the backoff gate: after an absorbed dispatch failure admission
        # pauses until the retry moment (running slots keep decoding)
        if time.perf_counter() >= self._retry_at:
            if self.paged:
                self._paged_prefills(sync)
            else:
                self._slot_prefills(sync)
            if self._chunk_q:
                self._dispatch_chunks(sync)

        # slots parked mid-chunked-prefill decode physically (the pooled
        # call advances every slot) but their tokens are never harvested
        snapshot = {slot: req for slot, req in sch.active.items()
                    if not sch.saturated(req)
                    and slot not in self._prefilling}
        if snapshot:
            self._decode(snapshot, sync)
            worked = True

        # after a supervisor restart this step, ``prev`` belongs to the
        # old schedule: its requests were re-queued, and the greedy
        # replay regenerates every unread token exactly
        if epoch == self._restart_epoch:
            self._harvest(prev)
        if worked:
            M.note_work(t0, time.perf_counter())
        M.queue_depth = len(sch.queue)
        M.slot_occupancy = self.pool.occupancy
        return self.pending

    def run(self):
        """Step until every submitted request is done; returns the
        completed requests in submission order."""
        while self.step():
            pass
        return sorted(self.scheduler.completed, key=lambda r: r.rid)

    # ------------------------------------------------- disaggregation

    def export_kv(self, rid):
        """Serialize a retired ``hold_kv`` request's prompt blocks into a
        wire payload (``serving.kv_wire``) and release its slot, even
        when serialization fails. The blocks are read in row order, one
        copy of ``ceil(prompt / block_size)`` blocks to the host."""
        if not self.paged:
            raise RuntimeError("export_kv requires the paged pool "
                               "(paged=True)")
        req = self._held_exports.pop(rid, None)
        if req is None:
            raise KeyError(f"no held KV export for rid {rid}: submit with "
                           f"hold_kv=True and let the request retire first")
        pool = self.pool
        self._use_program(("kv_export",))
        # the kv/export span starts when the KV was ready to ship (the
        # first token emitted, the blocks parked): the dwell until the
        # router collects it is part of the handoff's price
        t0_exp = self.trace.wall(req.t_first_token) \
            if req.t_first_token is not None else time.time()
        try:
            n = kv_wire.blocks_for_prompt(len(req.prompt), pool.block_size)
            k, v = self._timed(("kv_export",), pool.read_blocks,
                               pool.row_blocks(req.slot, n))
            payload = kv_wire.serialize_handoff(
                k, v, req.prompt, req.generated[0],
                trace=req.trace.as_dict() if req.trace is not None
                else None)
        finally:
            pool.release(req.slot)
            req.slot = None
        wire_bytes = kv_wire.payload_wire_bytes(payload)
        self.trace.record(req.trace, "kv/export", t0_exp,
                          time.time() - t0_exp, {"rid": req.rid, "blocks": n})
        self.flight.kv_exported(req, n, wire_bytes)
        self.metrics.kv_exports += 1
        self.metrics.kv_export_bytes += wire_bytes
        return payload

    def import_kv(self, payload, max_new_tokens, eos_id=None,
                  on_token=None, deadline_ms=None):
        """Bind a KV handoff into this engine's pool and resume the
        stream at its first decode step: the prompt's K/V comes off the
        wire, no prefill runs. ``max_new_tokens`` counts every new token,
        the first (already produced) one included. The payload is
        verified in full (digests, then shape and dtype against this
        pool) before the pool changes: a bad one raises ``KVWireError``
        and leaves the pool as it was. The prompt's full blocks are then
        shared through the radix index. ``deadline_ms`` bounds the
        decode from now. The payload's trace context (and the tenant in
        its baggage) carries over, so the import joins the prefill
        tier's trace. Returns the live Request."""
        if not self.paged:
            raise RuntimeError("import_kv requires the paged pool "
                               "(paged=True)")
        if self._draining or self._closed:
            raise RuntimeError(
                "engine is draining/closed: no new requests (drain() "
                "finishes already-submitted work, close() aborts it)")
        t0_imp = time.time()
        handoff = kv_wire.deserialize_handoff(payload)
        pool, sch, M = self.pool, self.scheduler, self.metrics
        layers, _, heads, bs, hd = pool.kc.shape
        if handoff.block_size != pool.block_size:
            raise kv_wire.KVWireError(
                f"block_size drift: payload {handoff.block_size}, pool "
                f"{pool.block_size}")
        if handoff.k.shape[0] != layers \
                or tuple(handoff.k.shape[2:]) != (heads, bs, hd):
            raise kv_wire.KVWireError(
                f"tile shape drift: payload {tuple(handoff.k.shape)}, "
                f"pool tiles [{layers}, ., {heads}, {bs}, {hd}]")
        if handoff.k.dtype != pool.kc.dtype:
            raise kv_wire.KVWireError(
                f"tile dtype drift: payload {handoff.k.dtype}, pool "
                f"{pool.kc.dtype}")
        req = Request(handoff.prompt, max_new_tokens,
                      eos_id=self.config.eos_id if eos_id is None
                      else eos_id, on_token=on_token,
                      deadline_ms=deadline_ms)
        req.trace = TraceContext.coerce(handoff.trace)
        tenant = req.trace.baggage.get("tenant")
        if tenant:
            req.tenant_id = str(tenant)
        req.imported = True
        if req.deadline_ms is not None:
            self._deadlines_armed = True
        ids = req.prompt
        alloc = pool.acquire(req.rid, ids, req.cache_tokens, 0)
        if alloc is None:
            raise RuntimeError("kv import refused: pool at capacity")
        slot = alloc.slot
        try:
            self._use_program(("kv_import",))
            self._timed(("kv_import",), pool.write_blocks,
                        pool.row_blocks(slot, handoff.n_blocks), handoff.k,
                        handoff.v)
            # new tensors: a pending harvest may still read the old ones
            toks = self._toks.clone()
            pos = self._pos.clone()
            toks[slot] = handoff.first_token
            pos[slot] = len(ids)
        except BaseException:
            pool.release(slot)
            raise
        self._toks, self._pos = toks, pos
        pool.commit_prefix(slot, ids)
        if self._sampler is not None:
            self._sampler.set_slot(slot, req)
        now = time.perf_counter()
        req.state = RUNNING
        req.slot = slot
        req.generated = [handoff.first_token]
        # admission and first token happened on the prefill side
        req.t_admitted = req.t_first_token = now
        sch.active[slot] = req
        M.record_admission(req)
        M.requests_admitted += 1
        M.kv_imports += 1
        M.kv_import_bytes += handoff.wire_bytes
        self.flight.enqueued(req)
        self.flight.kv_imported(req, handoff.n_blocks, handoff.wire_bytes)
        # kv/import covers deserialization, verification and the
        # splice; decode/queue starts here
        self.trace.record(req.trace, "kv/import", t0_imp,
                          time.time() - t0_imp,
                          {"rid": req.rid, "blocks": handoff.n_blocks,
                           "wire_bytes": handoff.wire_bytes})
        reason = sch.stop_reason(req, handoff.first_token)
        if reason is not None:
            # nothing left to decode: retire at once
            sch.finish(req, pool, reason)
            violations = M.record_completion(req)
            self.flight.retired(req, reason,
                                slo_violations=list(violations))
            if self.supervisor is not None:
                self.supervisor.note_completion(req.rid)
        return req

    def warmup_kv_handoff(self):
        """The reference compiles its export and import programs here.
        The port compiles nothing (export and import are eager tensor
        copies), so this only checks the pool and marks both programs
        used, as the reference's table then holds them."""
        if not self.paged:
            raise RuntimeError("warmup_kv_handoff requires the paged pool "
                               "(paged=True)")
        self._use_program(("kv_export",))
        self._use_program(("kv_import",))

    def start_draining(self):
        """Flip the drain flag without stepping: new requests raise at
        once and ``/debug/health`` reports ``draining: true``, while
        whoever owns the step loop (a router gateway's stepping thread)
        steps the submitted work to completion."""
        self._draining = True

    def drain(self):
        """Graceful drain: refuse new requests, finish every submitted
        one (queued and in flight), then close. Returns the completed
        requests in submission order."""
        self.start_draining()
        while self.step():
            pass
        done = sorted(self.scheduler.completed, key=lambda r: r.rid)
        self.close()
        return done

    def close(self):
        """Shut down: whatever is still owed tokens (queued, running,
        mid-chunk, or in flight) retires with stop reason "aborted",
        counted, slots and blocks released (dispatched results are
        discarded unread), parked exports give their blocks back, then
        the metrics servers stop. Idempotent; also the context-manager
        exit."""
        if not self._closed and (self.scheduler.pending or self._pending
                                 or self._chunk_q or self._held_exports):
            self._abort_inflight()
        self._closed = True
        servers, self._metric_servers = self._metric_servers, []
        for handle in servers:
            handle.close()

    def _owed(self):
        """Requests the engine still owes tokens: active, mid-chunk, and
        those whose dispatched results are unread (prereleased finals
        included), by rid."""
        sch = self.scheduler
        owed = {r.rid: r for r in sch.active.values()}
        for plan in self._chunk_q:
            owed.setdefault(plan.req.rid, plan.req)
        for _, _, members, *_ in self._pending:
            rs = members.values() if isinstance(members, dict) \
                else [r for r, _ in members]
            for r in rs:
                if r.state == RUNNING:
                    owed.setdefault(r.rid, r)
        return owed

    def _abort_inflight(self):
        sch = self.scheduler
        owed = self._owed()
        owed.update((r.rid, r) for r in sch.queue)
        self._pending = []
        self._chunk_q = []
        self._prefilling.clear()
        held, self._held_exports = self._held_exports, {}
        for r in sorted(held.values(), key=lambda r: r.rid):
            if r.slot is not None:
                self.pool.release(r.slot)
                r.slot = None
        for r in sorted(owed.values(), key=lambda r: r.rid):
            r.inflight = 0
            sch.abort(r, self.pool)
            self.metrics.record_abort(r.tenant_id)
            self.flight.retired(r, "aborted")
            if self.supervisor is not None:
                self.supervisor.note_completion(r.rid)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------ resilience

    def _retryable(self, exc):
        """A failed dispatch or read may be absorbed when the engine is
        hardened (``max_dispatch_retries`` > 0) and the failure is an
        ordinary Exception (KeyboardInterrupt and the like propagate)."""
        return self.max_dispatch_retries > 0 and isinstance(exc, Exception)

    def _absorb_dispatch_failure(self, exc, kind, pairs):
        """Account a rolled-back prefill or chunk dispatch failure and
        decide its fate: True = absorbed (the requests are back in the
        queue and retry on a later step, minus any whose budget ran out,
        which retire with reason "error"), False = the caller raises.
        The slots the failed dispatch wrote through count failures, and
        a slot that keeps failing is quarantined."""
        M = self.metrics
        M.record_dispatch_failure(kind)
        for req, slot in pairs:
            req.dispatch_failures += 1
            self.flight.dispatch_failed(req, kind, exc)
            self._slot_failures[slot] = self._slot_failures.get(slot, 0) + 1
        if not self._retryable(exc):
            return False
        for req, slot in pairs:
            self._maybe_quarantine(slot)
            if req.dispatch_failures > self.max_dispatch_retries:
                self._abort_request(req, "error")
            else:
                M.record_retry()
        if self.retry_backoff_s > 0:
            worst = max(r.dispatch_failures for r, _ in pairs)
            self._retry_at = time.perf_counter() \
                + self.retry_backoff_s * (2 ** (worst - 1))
        return True

    def _absorb_decode_failure(self, exc):
        """The pooled decode failed. It advances every slot, so no one
        request is to blame: the step is retried up to the budget, then
        escalated to the supervisor. False = the caller raises."""
        M = self.metrics
        M.record_dispatch_failure("decode")
        self._decode_fail_streak += 1
        if not self._retryable(exc):
            return False
        if self._decode_fail_streak <= self.max_dispatch_retries:
            M.record_retry()
            if self.retry_backoff_s > 0:
                self._retry_at = time.perf_counter() \
                    + self.retry_backoff_s \
                    * (2 ** (self._decode_fail_streak - 1))
            return True
        return self.supervisor is not None and self.supervisor.trigger(
            "dispatch_failure",
            {"detector": "dispatch_failure",
             "streak": self._decode_fail_streak,
             "error": f"{type(exc).__name__}: {exc}"[:200]})

    def _maybe_quarantine(self, slot):
        """Quarantine ``slot`` once its failures reach
        ``quarantine_after``, unless it is the last admissible slot (a
        fully quarantined pool would deadlock the queue)."""
        if self._slot_failures.get(slot, 0) < self.config.quarantine_after:
            return
        pool = self.pool
        if slot in pool.quarantined \
                or pool.num_slots - len(pool.quarantined) <= 1:
            return
        pool.quarantine(slot)
        self.metrics.record_quarantine()
        self._slot_failures.pop(slot, None)

    def _abort_request(self, req, reason):
        """Retire a request (already rolled back into the queue) with no
        further tokens."""
        self.scheduler.abort(req, self.pool)
        req.stop_reason = reason
        self.metrics.record_abort(req.tenant_id)
        self.flight.retired(req, reason)
        if self.supervisor is not None:
            self.supervisor.note_completion(req.rid)

    def _expire_deadlines(self):
        """Retire requests past their ``deadline_ms`` (queued or
        decoding) with stop reason "deadline"."""
        now = time.perf_counter()
        expired_q, expired_a = self.scheduler.expire_deadlines(
            self.pool, prefilling=self._prefilling, now=now)
        for req in expired_q + expired_a:
            if req.hold_kv and req.slot is not None:
                # nobody will export a handoff dead on its deadline
                self.pool.release(req.slot)
                req.slot = None
            self.metrics.record_timeout(req.tenant_id)
            over = (now - req.t_arrival) * 1000.0 - req.deadline_ms
            self.flight.deadline_exceeded(req, over)
            self.flight.retired(req, "deadline",
                                slo_violations=["deadline"])
            if self.supervisor is not None:
                self.supervisor.note_completion(req.rid)

    def _supervisor_restart(self, reason):
        """In-process recovery (called only by the supervisor): drop the
        suspect state — unread device results, the pool (on the paged
        pool with its radix index), the serving programs, per-slot
        failure counts — and re-queue every request still owed tokens
        for a re-prefill of its prompt plus the tokens it already
        emitted (greedy decoding makes the replay exact). Returns the
        re-queued requests."""
        sch = self.scheduler
        replayed = sorted(self._owed().values(), key=lambda r: r.rid)
        self._pending = []
        self._chunk_q = []
        self._prefilling.clear()
        sch.active.clear()
        # parked exports die with the pool: the router re-drives them
        for r in self._held_exports.values():
            r.slot = None
        self._held_exports.clear()
        # free the old cache tensors before the new pool allocates them:
        # the allocator hands the same memory to the new pool (kernels
        # already queued on this stream finish first), so a restart
        # never holds two pools
        old, self.pool = self.pool, None
        self.metrics.set_prefix_pool(None)
        old.kc = old.vc = None
        self.pool = self._new_pool()
        if self.paged:
            self.metrics.set_prefix_pool(self.pool.stats)
            # the cache observatory keeps its history across the swap
            self.metrics.cache.attach_pool(self.pool)
        S = self.config.num_slots
        self._toks = torch.zeros(S, dtype=torch.int32, device=self.device)
        self._pos = torch.zeros(S, dtype=torch.int32, device=self.device)
        self._build_programs()
        self._used_programs.clear()
        self.watchdog.reopen_warmup()
        if self._spec is not None:
            self._spec.reset()
        self._slot_failures.clear()
        self._decode_fail_streak = 0
        self._retry_at = 0.0
        self._restart_epoch += 1
        for req in reversed(replayed):
            req.slot = None
            req.state = QUEUED
            req.t_admitted = None
            req.inflight = 0
            req.dispatch_failures = 0
            sch.queue.appendleft(req)
            self.flight.requeued(req, reason)
        self.metrics.record_restart()
        return replayed

    def _resilience_state(self):
        """The live half of ``snapshot()["resilience"]``."""
        sup = self.supervisor
        return {
            "quarantined_slots": list(self.pool.quarantined),
            "draining": self._draining,
            "supervisor": sup.report() if sup is not None
            else {"enabled": False},
            "chaos": self.chaos.report() if self.chaos is not None
            else {"enabled": False},
        }

    def _health_resilience(self):
        """The replica-posture facts ``/debug/health`` folds in."""
        sup = self.supervisor
        return {
            "degraded": sup.degraded if sup is not None else False,
            "draining": self._draining,
            "restarts": sup.restarts if sup is not None else 0,
        }

    # ---------------------------------------------------------- health

    def _health_tick(self, wall_s):
        """Author one step-ledger row (counter deltas against the
        previous tick) and feed the health monitor; its wedge verdicts
        go to the supervisor. The paged pool's conservation audit runs
        every ``health_audit_every`` steps. The port compiles nothing,
        so ``new_compiles`` and ``steady_compiles`` are always 0."""
        M, pool = self.metrics, self.pool
        self._step_id += 1
        step = self._step_id
        conservation_ok = conservation_error = None
        if self.paged and step % self.config.health_audit_every == 0:
            audit = pool.audit()
            conservation_ok, conservation_error = audit["ok"], audit["error"]
        cur = (M.tokens_generated, M.requests_admitted,
               M.requests_completed, M.prefill_tokens, M.prefill_chunks,
               M.deprioritized, M.dispatch_s, M.sync_s, M.shed_count,
               pool.index.thrash_count if self.paged else 0,
               pool.evictable_blocks if self.paged else 0,
               M.slo.goodput_tokens)
        prev = self._hprev or (0,) * len(cur)
        self._hprev = cur
        hits, misses = M.prefix_hits, M.prefix_misses
        queue = self.scheduler.queue
        fired = self.health.observe({
            "step": step,
            "t": time.time(),
            "wall_s": wall_s,
            "dispatch_s": cur[6] - prev[6],
            "sync_s": cur[7] - prev[7],
            "queue_depth": len(queue),
            "queue_age_s": time.perf_counter() - queue[0].t_arrival
            if queue else 0.0,
            # parked exports still own their slot and blocks
            "occupied_slots": (len(self.scheduler.active)
                               + len(self._held_exports)),
            "chunked_inflight": len(self._chunk_q),
            "admitted": cur[1] - prev[1],
            "tokens": cur[0] - prev[0],
            "completed": cur[2] - prev[2],
            "goodput_tokens": cur[11] - prev[11],
            "prefill_tokens": cur[3] - prev[3],
            "prefill_chunks": cur[4] - prev[4],
            "shed": cur[8] - prev[8],
            "deprioritized": cur[5] - prev[5],
            "new_compiles": 0,
            "steady_compiles": 0,
            "slo_on": self._slo_on,
            "prefix_hit_rate": round(hits / (hits + misses), 4)
            if (hits + misses) else None,
            "pool_free_blocks": pool.free_blocks if self.paged else None,
            "pool_evictable_blocks": pool.evictable_blocks
            if self.paged else None,
            "pool_live_blocks": pool.live_blocks if self.paged else None,
            # a restart's fresh radix index restarts its thrash count
            "cache_thrash": max(0, cur[9] - prev[9])
            if self.paged else None,
            "pool_evictable_delta": cur[10] - prev[10]
            if self.paged else None,
            "conservation_ok": conservation_ok,
            "conservation_error": conservation_error,
        })
        if fired and self.supervisor is not None:
            self.supervisor.consider(fired)

    # ------------------------------------------------- observability

    def declare_warmup(self):
        """Declare warmup complete: the watchdog's steady state begins
        (the port records no compile, so it never flags one) and the
        admission policy forgets the warmup's service samples."""
        self.watchdog.declare_warmup_complete()
        self._policy.reset_service()

    def request_trace(self, rid):
        """The flight recorder's RequestTrace for request ``rid``
        (completed and kept, or in flight); None when unknown."""
        return self.flight.trace(rid)

    def debug_state(self):
        """The ``/debug/state`` JSON body: live queue, slot and pipeline
        state, the flight recorder's summary and the SLO, cache,
        scheduler, health, resilience and tenant sections."""
        sch, M = self.scheduler, self.metrics
        wd = self.watchdog.report()
        return {
            "replica": M.identity_report(),
            "queue_depth": len(sch.queue),
            "queued_rids": [r.rid for r in sch.queue],
            "active_slots": {str(slot): req.rid
                             for slot, req in sorted(sch.active.items())},
            "slot_occupancy": self.pool.occupancy,
            "inflight_harvests": len(self._pending),
            "completed_kept": len(sch.completed),
            "compiles": wd["compiles_total"],
            "watchdog": {k: wd[k] for k in
                         ("warmed", "mode", "compiles_total",
                          "steady_state_compiles")},
            "kv_donation": dict(M.kv_donation),
            "flight": self.flight.state(),
            "slo": M.slo.report(),
            "paged": self.paged,
            "paged_attn": self.paged and self.device.type == "cuda",
            "role": self.role,
            "held_exports": len(self._held_exports),
            "decode_layout": self.decode_layout,
            "speculative": self.speculative,
            "spec_k": self.spec_k,
            "prefix_cache": M.prefix_cache_report(),
            "cache": M.cache_report(),
            "scheduler": dict(M.scheduler_report(),
                              chunked_inflight=len(self._chunk_q)),
            "health": M.health_report(),
            "resilience": M.resilience_report(),
            "tenants": M.tenant_report(),
        }

    def serve_metrics(self, port=0, addr="127.0.0.1", post_routes=None,
                      lock=None):
        """Serve this engine over HTTP: GET ``/metrics`` (Prometheus
        text), ``/metrics.json``, ``/debug`` (the route index),
        ``/debug/state``, ``/debug/requests`` (the flight recorder's
        traces; ``?tenant=<id>`` keeps one tenant's), ``/debug/traces``
        (this replica's trace span ring), ``/debug/perf``,
        ``/debug/cache``, ``/debug/tenants`` and, with the health
        observatory on, ``/debug/health`` (the router's per-replica
        signal) and ``/debug/ledger``. ``post_routes`` mounts POST handlers beside
        them (the router's gateway mounts ``/v1/generate`` this way);
        ``lock``, when given, is held while a debug route reads the
        engine (the gateway passes the lock its stepping thread steps
        under). Returns the server's handle; ``close()`` stops every
        server this engine started."""
        def _debug_requests(params):
            return self.flight.debug_requests(tenant=params.get("tenant"))
        _debug_requests.accepts_query = True
        routes = {"/debug/state": self.debug_state,
                  "/debug/requests": _debug_requests,
                  "/debug/perf": self.metrics.perf_report,
                  "/debug/cache": self.metrics.cache_report,
                  "/debug/traces": self.trace.debug_traces,
                  "/debug/tenants": self.metrics.tenant_report}
        if self.health is not None:
            routes["/debug/health"] = self.health.report
            routes["/debug/ledger"] = self.health.debug_ledger
        if lock is not None:
            def locked(fn):
                if getattr(fn, "accepts_query", False):
                    def call(params):
                        with lock:
                            return fn(params)
                    call.accepts_query = True
                    return call

                def call():
                    with lock:
                        return fn()
                return call
            routes = {path: locked(fn) for path, fn in routes.items()}
        handle = start_metrics_server(
            self.metrics.registry, port=port, addr=addr,
            extra_routes=routes, post_routes=post_routes)
        self._metric_servers.append(handle)
        return handle
