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
"""
import time

import numpy as np
import torch

from ..core.device import resolve_device
from . import kv_wire
from .kv_pool import SlotKVPool
from .metrics import ServingMetrics
from .paged.pool import PagedKVPool, upload
from .paged.programs import build_paged_fns
from .sched import (ChunkPlan, SlotSampler, request_sampling_params,
                    resolve_policy)
from .sched.sampling import upload_params
from .scheduler import RUNNING, Request, StepScheduler
from .spec import SpecDecoder


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

    The reference's environment gates and its fleet and operations knobs
    (health, chaos, retries, supervisor, perf, cache observatory, replica
    id, trace spans, tenants, watchdog, donation, deadlines) are not
    taken."""

    def __init__(self, num_slots=8, max_len=None, buckets=None,
                 bucket_min=32, eos_id=None, prefill_group_sizes=None,
                 async_depth=1, block_size=16, num_blocks=None, device=None,
                 paged=True, prefill_chunk=None, prefill_token_budget=None,
                 policy=None, slo_ttft_ms=None, sampling=False,
                 speculative=False, spec_k=4, spec_min_accept=0.35,
                 role="monolithic"):
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
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        if self.paged:
            self.pool = PagedKVPool(
                S, cfg.num_layers, nh, cache_len, hd,
                block_size=config.block_size, num_blocks=config.num_blocks,
                device=self.device)
            self._prefill_fn, self._decode_fn = build_paged_fns(
                cfg, S, self.pool.block_size, self.pool.num_blocks,
                self.pool.blocks_per_slot, sampling=self.sampling)
            self._chunk_fn = self._prefill_fn   # chunks are tails
        else:
            self.pool = SlotKVPool(S, cfg.num_layers, nh, cache_len, hd,
                                   device=self.device)
            self._prefill_fn, self._decode_fn = model.build_serving_fns(
                S, cache_len, sampling=self.sampling)
            self._chunk_fn = model.build_chunk_prefill_fn(
                cache_len, sampling=self.sampling) \
                if self.chunk_len is not None else None
        self.speculative = config.speculative
        self.spec_k = config.spec_k
        self._spec = self._verify_fn = None
        if self.speculative:
            if self.spec_k + 1 > cache_len:
                raise ValueError(
                    f"spec_k + 1 ({self.spec_k + 1}) exceeds the per-slot "
                    f"cache capacity {cache_len}")
            if self.paged:
                self._verify_fn = model.build_paged_spec_verify_fn(
                    S, self.pool.block_size, self.pool.num_blocks,
                    self.pool.blocks_per_slot, self.spec_k)
            else:
                self._verify_fn = model.build_spec_verify_fn(
                    S, cache_len, self.spec_k)
            self._spec = SpecDecoder(S, self.spec_k, config.spec_min_accept)
        self._sampler = SlotSampler(S, self.device) if self.sampling \
            else None
        self._chunk_q = []        # ChunkPlans awaiting chunk dispatch
        self._prefilling = set()  # slots parked mid-chunked-prefill
        self._policy = resolve_policy(config.policy, config.slo_ttft_ms)
        self.scheduler = StepScheduler(buckets, cache_len,
                                       policy=self._policy)
        self.metrics = ServingMetrics()
        if self.paged:
            self.metrics.set_prefix_pool(self.pool.stats)
        self.metrics.set_spec(self.speculative, self.spec_k)
        self.metrics.set_scheduler_info(self._policy.name, self.chunk_len,
                                        self.prefill_token_budget)
        # rolling device state: last token and next write position per
        # slot; programs chain them, so step N+1 never waits on step N's
        # values reaching the host
        self._toks = torch.zeros(S, dtype=torch.int32, device=self.device)
        self._pos = torch.zeros(S, dtype=torch.int32, device=self.device)
        self._pending = []        # dispatched, not yet read back
        self._held_exports = {}   # rid -> retired hold_kv request
        self._closed = False

    # ---------------------------------------------------------- requests

    def add_request(self, prompt, max_new_tokens, eos_id=None,
                    on_token=None, temperature=0.0, top_k=0, top_p=1.0,
                    seed=None, hold_kv=False):
        """Queue a prompt; returns the Request at once. Tokens stream
        through ``on_token(request, token)`` as they are read back.
        ``temperature``/``top_k``/``top_p``/``seed`` sample this request
        (the engine must have ``sampling=True``); the defaults are
        greedy. ``hold_kv=True`` (paged pool) keeps the slot and its
        blocks after the request retires, for ``export_kv``."""
        if self._closed:
            raise RuntimeError("engine is closed: no new requests")
        if hold_kv and not self.paged:
            raise ValueError("hold_kv requires the paged pool (paged=True):"
                             " the KV wire unit is the paged block")
        req = Request(prompt, max_new_tokens,
                      eos_id=self.config.eos_id if eos_id is None
                      else eos_id, on_token=on_token,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, hold_kv=hold_kv)
        if req.sampled and not self.sampling:
            raise ValueError(
                "sampled request on a greedy engine: build the engine "
                "with ServingConfig(sampling=True) to serve temperature/"
                "top-k/top-p traffic")
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

    @staticmethod
    def _read_back(handle):
        hosts, ev = handle
        if ev is not None:
            ev.synchronize()
        return [h.numpy() for h in hosts]

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
        if req.on_token is not None:
            req.on_token(req, token)
        reason = self.scheduler.stop_reason(req, token)
        if reason is not None:
            self.scheduler.finish(req, self.pool, reason)
            self.metrics.record_completion(req)
            if req.hold_kv and req.slot is not None:
                # prefill-tier retirement: slot and blocks stay live
                # for export_kv(rid)
                self._held_exports[req.rid] = req

    def _harvest(self, pending):
        """Read back dispatched tokens (prefills, chunks and the decode
        of one step, in dispatch order) and run the stop checks."""
        M = self.metrics
        for kind, handle, members, *extra in pending:
            vals = self._read_back(handle)
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
        shed, deprioritized = self.scheduler.triage()
        self.metrics.deprioritized += len(deprioritized)
        for req, _ in shed:
            self.metrics.record_shed(req.shed_reason)

    def _slot_prefills(self, sync):
        """Admission + grouped bucketed prefill over the slot pool. A
        failed dispatch rolls this group and every later one back to the
        queue (slots released) and raises. Prompts longer than the chunk
        width claim their slot here and prefill in ``_dispatch_chunks``."""
        sch, pool, M = self.scheduler, self.pool, self.metrics
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
                first, self._toks, self._pos = self._prefill_fn(
                    self.params, upload(tokens, self.device),
                    upload(lengths, self.device), upload(slots, self.device),
                    self._toks, self._pos, pool.kc, pool.vc, *samp)
            except BaseException:
                for req, _slot in group:
                    req.inflight -= 1
                sch.rollback_admission(
                    [r for g in groups[gi:] for r, _ in g], pool)
                raise
            M.requests_admitted += G
            M.prefills += 1
            M.prefill_requests += G
            M.record_prefill_group(G, int(lengths.sum()))
            self._dispatch(("prefill", self._to_host(first), group), sync)

    def _paged_prefills(self, sync):
        """Prefix-aware admission + tail-only prefill. The prompt's full
        blocks are committed to the radix index only after the prefill
        ran, so a failed prefill rolls back (slot and blocks released,
        request re-queued) without poisoning the cache. A tail longer
        than the chunk width is left to ``_dispatch_chunks``."""
        sch, pool, M = self.scheduler, self.pool, self.metrics
        while True:
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
                first, self._toks, self._pos = self._prefill_fn(
                    self.params, upload(tokens, self.device), tail, start,
                    alloc.slot, 1, pool.table_row(alloc.slot), self._toks,
                    self._pos, pool.kc, pool.vc, *self._samp_scalars(req))
            except BaseException:
                req.inflight -= 1
                sch.rollback_admission([req], pool)
                raise
            pool.commit_prefix(alloc.slot, ids)
            M.requests_admitted += 1
            M.prefills += 1
            M.prefill_requests += 1
            M.record_prefill_group(1, 0)
            M.record_prefix_reuse(start, tail)
            self._dispatch(("prefill", self._to_host(first),
                            [(req, alloc.slot)]), sync)

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
        failure anywhere rolls the request back to the queue uncounted
        (and raises)."""
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
                first, self._toks, self._pos = self._chunk_fn(
                    *args, self._toks, self._pos, pool.kc, pool.vc,
                    *self._samp_scalars(req))
            except BaseException:
                if final:
                    req.inflight -= 1
                self._chunk_q.remove(plan)
                self._prefilling.discard(plan.slot)
                sch.rollback_admission([req], pool)
                raise
            M.record_prefill_chunk(clen)
            budget -= clen
            plan.advance()
            if final:
                self._chunk_q.pop(0)
                self._prefilling.discard(plan.slot)
                if self.paged:
                    pool.commit_prefix(plan.slot, plan.ids)
                    M.record_prefix_reuse(plan.start0, 0)
                M.requests_admitted += 1
                M.prefill_requests += 1
                M.chunked_requests += 1
                self._dispatch(("prefill", self._to_host(first),
                                [(req, plan.slot)]), sync)

    def _decode(self, snapshot, sync):
        """One pooled decode (or, when some slot drafted, one verify)
        advancing every slot of ``snapshot``."""
        pool, M = self.pool, self.metrics
        drafted = None
        if self._spec is not None:
            drafts, dlen, drafted = self._spec.propose(snapshot)
            # nobody drafted: the plain decode program outright
            drafted = drafted or None
        tables = (pool.device_tables(),) if self.paged else ()
        for req in snapshot.values():
            req.inflight += 1
        try:
            if drafted is not None:
                out, acc, nxt, self._pos = self._verify_fn(
                    self.params, self._toks, self._pos,
                    upload(drafts, self.device), upload(dlen, self.device),
                    *tables, pool.kc, pool.vc)
            else:
                samp = self._sampler.device_arrays() if self.sampling \
                    else ()
                nxt, self._pos = self._decode_fn(
                    self.params, self._toks, self._pos, *tables, pool.kc,
                    pool.vc, *samp)
        except BaseException:
            for req in snapshot.values():
                req.inflight -= 1
            raise
        self._toks = nxt
        M.decode_steps += 1
        if drafted is not None:
            M.spec_verify_steps += 1
            entry = ("spec", self._to_host(out, acc), snapshot, drafted)
        else:
            if self._spec is not None:
                M.spec_fallback_steps += 1
            entry = ("decode", self._to_host(nxt), snapshot)
        self._dispatch(entry, sync)

    @torch.inference_mode()
    def step(self):
        """One engine iteration; returns True while work remains."""
        sch, pool, M = self.scheduler, self.pool, self.metrics
        t0 = time.perf_counter()
        sync = self.config.async_depth == 0
        prev, self._pending = self._pending, []
        worked = bool(prev)
        if self._spec is not None and prev:
            # drafts extend the last HARVESTED token: read the previous
            # step's results before proposing
            self._harvest(prev)
            prev = []

        # hold_kv requests never prerelease: their blocks must survive
        # retirement for export_kv
        for req in [r for r in sch.active.values()
                    if sch.saturated(r) and not r.hold_kv]:
            sch.prerelease(req, pool)

        self._triage()
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

        self._harvest(prev)
        if worked:
            M.note_work(t0, time.perf_counter())
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
        try:
            n = kv_wire.blocks_for_prompt(len(req.prompt), pool.block_size)
            k, v = pool.read_blocks(pool.row_blocks(req.slot, n))
            payload = kv_wire.serialize_handoff(k, v, req.prompt,
                                                req.generated[0])
        finally:
            pool.release(req.slot)
            req.slot = None
        self.metrics.kv_exports += 1
        self.metrics.kv_export_bytes += kv_wire.payload_wire_bytes(payload)
        return payload

    def import_kv(self, payload, max_new_tokens, eos_id=None,
                  on_token=None):
        """Bind a KV handoff into this engine's pool and resume the
        stream at its first decode step: the prompt's K/V comes off the
        wire, no prefill runs. ``max_new_tokens`` counts every new token,
        the first (already produced) one included. The payload is
        verified in full (digests, then shape and dtype against this
        pool) before the pool changes: a bad one raises ``KVWireError``
        and leaves the pool as it was. The prompt's full blocks are then
        shared through the radix index. Returns the live Request."""
        if not self.paged:
            raise RuntimeError("import_kv requires the paged pool "
                               "(paged=True)")
        if self._closed:
            raise RuntimeError("engine is closed: no new requests")
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
                      else eos_id, on_token=on_token)
        ids = req.prompt
        alloc = pool.acquire(req.rid, ids, req.cache_tokens, 0)
        if alloc is None:
            raise RuntimeError("kv import refused: pool at capacity")
        slot = alloc.slot
        try:
            pool.write_blocks(pool.row_blocks(slot, handoff.n_blocks),
                              handoff.k, handoff.v)
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
        M.requests_admitted += 1
        M.kv_imports += 1
        M.kv_import_bytes += handoff.wire_bytes
        reason = sch.stop_reason(req, handoff.first_token)
        if reason is not None:
            # nothing left to decode: retire at once
            sch.finish(req, pool, reason)
            M.record_completion(req)
        return req

    def warmup_kv_handoff(self):
        """The reference compiles its export and import programs here.
        The port compiles nothing (export and import are eager tensor
        copies), so this only checks the pool and returns."""
        if not self.paged:
            raise RuntimeError("warmup_kv_handoff requires the paged pool "
                               "(paged=True)")

    def close(self):
        """Retire whatever is still owed tokens as ``aborted`` (slots
        and blocks released) and release parked exports. Idempotent;
        also the context-manager exit."""
        if self._closed:
            return
        sch = self.scheduler
        owed = {r.rid: r for r in sch.queue}
        owed.update((r.rid, r) for r in sch.active.values())
        for plan in self._chunk_q:
            owed.setdefault(plan.req.rid, plan.req)
        for _, _, members, *_ in self._pending:
            rs = members.values() if isinstance(members, dict) \
                else [r for r, _ in members]
            owed.update((r.rid, r) for r in rs if r.state == RUNNING)
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
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
