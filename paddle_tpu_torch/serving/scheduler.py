"""Step scheduler: request queue, admission, stop conditions.

Ports ``paddle_tpu/serving/scheduler.py``: continuous batching admits at
every engine step, the moment a slot (and, on the paged pool, its
blocks) is free; per-slot stop conditions (EOS / max-new-tokens) retire
requests one by one. Admission on the slot pool returns same-bucket
prefill groups; prompts longer than the chunk width come back apart, to
be prefilled chunk by chunk. A scheduling policy (``serving.sched``)
triages the queue before admission. A request past its
``deadline_ms`` retires, queued or decoding.
"""
import collections
import itertools
import time

import numpy as np

QUEUED = "queued"
RUNNING = "running"
DONE = "done"

_rid = itertools.count()


class Request:
    """One generation request. ``on_token(request, token)`` streams
    tokens as they are read back; ``output_ids`` is prompt + generated
    once ``done``.

    ``temperature`` / ``top_k`` / ``top_p`` / ``seed`` select per-slot
    sampling (engines built with ``sampling=True``); ``sampled`` is
    ``generate()``'s condition (temperature > 0 and top_k != 1), and the
    seed defaults to the request id. ``deadline_ms`` bounds the request
    end to end from its arrival (None: no deadline). ``hold_kv`` keeps
    the slot and its blocks past retirement for ``export_kv``.
    ``tenant_id`` bills the request in the tenant observatory (None:
    ``"default"``)."""

    def __init__(self, prompt, max_new_tokens, eos_id=None, on_token=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=None,
                 deadline_ms=None, hold_kv=False, tenant_id=None):
        self.rid = next(_rid)
        self.prompt = np.asarray(prompt).reshape(-1).astype(np.int64)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_id = eos_id
        self.on_token = on_token
        self.temperature = float(temperature)
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        self.top_k = int(top_k)
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        self.top_p = float(top_p)
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.seed = self.rid if seed is None else int(seed)
        self.sampled = self.temperature > 0.0 and self.top_k != 1
        self.deadline_ms = None if deadline_ms is None \
            else float(deadline_ms)
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        self.hold_kv = bool(hold_kv)
        # policy facts: deferred once ("defer" mode), or shed before
        # admission (done with no tokens)
        self.deprioritized = False
        self.shed_reason = None
        self.state = QUEUED
        self.slot = None
        self.generated = []
        self.inflight = 0   # tokens dispatched on device, not yet read
        self.dispatch_failures = 0   # dispatch attempts that raised
        self.stop_reason = None
        self.trace = None   # the propagated TraceContext
        # perf_counter lifecycle: arrival -> admission -> first token ->
        # done; the deltas feed ServingMetrics
        self.t_arrival = time.perf_counter()
        self.t_admitted = None
        self.t_first_token = None
        self.t_done = None
        # disaggregation: an imported request's first token came over
        # the KV wire; its first decode dispatch (t_decode0) closes the
        # decode-side trace spans
        self.imported = False
        self.t_decode0 = None
        self.tenant_id = str(tenant_id) if tenant_id else "default"

    @property
    def done(self):
        return self.state == DONE

    @property
    def output_ids(self):
        """Prompt + generated tokens."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int64)])

    @property
    def prefill_ids(self):
        """What a prefill must cover: the prompt plus any tokens already
        emitted (a re-queued request re-prefills them)."""
        if not self.generated:
            return self.prompt
        return self.output_ids

    @property
    def cache_tokens(self):
        """Cache rows the request can ever need (prompt + max_new)."""
        return len(self.prompt) + self.max_new_tokens

    def past_deadline(self, now=None):
        if self.deadline_ms is None:
            return False
        now = time.perf_counter() if now is None else now
        return (now - self.t_arrival) * 1000.0 > self.deadline_ms


class StepScheduler:
    """FIFO queue + slot table + per-slot stop conditions. ``completed``
    keeps the last ``completed_keep`` retired requests; ``policy`` (a
    ``serving.sched`` policy, None = strict FIFO) triages the queue;
    ``flight`` (an observability.FlightRecorder, optional) is told of
    every enqueue, admission and admission rollback."""

    def __init__(self, buckets, cache_len, completed_keep=4096,
                 policy=None, flight=None):
        self.buckets = sorted(int(b) for b in buckets)
        self.cache_len = int(cache_len)
        if not self.buckets:
            raise ValueError("need at least one prefill bucket")
        if completed_keep is not None and completed_keep < 1:
            raise ValueError("completed_keep must be >= 1 (or None "
                             "for unbounded)")
        self.queue = collections.deque()
        self.active = {}       # slot -> Request
        self.completed = collections.deque(maxlen=completed_keep)
        self.policy = policy
        self.flight = flight

    def bucket_for(self, prompt_len):
        """Smallest bucket that holds the prompt."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket {self.buckets[-1]}")

    def submit(self, request):
        n = len(request.prompt)
        self.bucket_for(n)  # raises on oversized prompts
        if n + request.max_new_tokens > self.cache_len:
            raise ValueError(
                f"prompt {n} + max_new_tokens {request.max_new_tokens} "
                f"exceeds the per-slot cache capacity {self.cache_len}")
        self.queue.append(request)
        if self.flight is not None:
            self.flight.enqueued(request)
        return request

    def triage(self):
        """Apply the policy to the queue before admission: shed requests
        leave it and retire at once with no tokens (``shed_reason``
        "slo_lost"), deprioritized ones move to its back in their order,
        flagged so the defer happens once. Returns ``(shed,
        deprioritized)`` as ``[(request, headroom_ms), ...]``."""
        if self.policy is None or not self.queue:
            return [], []
        decision = self.policy.triage(list(self.queue), time.perf_counter())
        if decision.empty:
            return [], []
        drop = {id(r) for r, _ in decision.shed}
        defer = {id(r) for r, _ in decision.deprioritized}
        keep = [r for r in self.queue
                if id(r) not in drop and id(r) not in defer]
        self.queue = collections.deque(
            keep + [r for r, _ in decision.deprioritized])
        for req, _ in decision.deprioritized:
            req.deprioritized = True
        for req, _ in decision.shed:
            req.state = DONE
            req.shed_reason = "slo_lost"
            req.stop_reason = "shed"
            req.t_done = time.perf_counter()
            self.completed.append(req)
        return decision.shed, decision.deprioritized

    def admit(self, pool, group_sizes=(1,)):
        """Claim free slot-pool slots for queued requests (FIFO) and
        return the admissions as same-bucket prefill groups: lists of
        ``(request, slot)`` whose lengths come from ``group_sizes``
        (largest fitting first). Buckets appear in first-arrival order,
        members in arrival order."""
        return self.admit_chunked(pool, group_sizes, None)[0]

    def admit_chunked(self, pool, group_sizes=(1,), chunk_len=None):
        """``admit``, with prompts longer than ``chunk_len`` returned
        apart as ``(request, slot)`` chunked admissions. Returns
        ``(groups, chunked)`` in FIFO order."""
        sizes = sorted(int(g) for g in group_sizes)
        if not sizes or sizes[0] != 1:
            raise ValueError(f"group_sizes must include 1, got "
                             f"{group_sizes}")
        by_bucket = {}
        chunked = []
        while self.queue and pool.free_count:
            req = self.queue.popleft()
            slot = pool.acquire(req.rid)
            req.slot = slot
            req.state = RUNNING
            req.t_admitted = time.perf_counter()
            self.active[slot] = req
            n_fill = len(req.prefill_ids)
            if chunk_len is not None and n_fill > chunk_len:
                chunked.append((req, slot))
                if self.flight is not None:
                    # chunked prefills dispatch at the chunk width
                    self.flight.admitted(req, slot, int(chunk_len), 1)
                continue
            by_bucket.setdefault(self.bucket_for(n_fill),
                                 []).append((req, slot))
        groups = []
        for bucket, members in by_bucket.items():
            i = 0
            while i < len(members):
                take = max(g for g in sizes if g <= len(members) - i)
                group = members[i:i + take]
                groups.append(group)
                if self.flight is not None:
                    for req, slot in group:
                        self.flight.admitted(req, slot, bucket, len(group))
                i += take
        return groups, chunked

    def plan_prefix(self, prompt_len, cached_tokens, block_size,
                    slot_capacity):
        """``(start, bucket)``: how much of a cached prefix a paged
        admission uses. ``start`` is block-aligned, leaves at least one
        prompt token in the tail (its logits give the first generated
        token), and shrinks a block at a time until the bucket-padded
        tail fits the slot's capacity. Using less cached prefix is
        always correct: the tail just recomputes it."""
        start = min(int(cached_tokens), prompt_len - 1)
        start -= start % block_size
        while start > 0 and \
                start + self.bucket_for(prompt_len - start) > slot_capacity:
            start -= block_size
        return start, self.bucket_for(prompt_len - start)

    def admit_paged(self, pool, chunk_len=None):
        """Prefix-aware FIFO admission, one request at a time:
        ``(request, alloc, bucket, chunked)`` or None when the head of the
        queue does not fit (no free slot, or its fresh blocks exceed free
        + evictable). One at a time lets the engine prefill and commit
        each prompt before the next lookup, so same-prefix arrivals in
        one step share the first one's blocks. With ``chunk_len`` set, an
        uncached tail longer than one chunk comes back ``chunked`` with
        ``bucket = chunk_len``; it keeps the whole block-aligned cached
        prefix, since end-aligned chunks never write past the prompt."""
        if not self.queue:
            return None
        req = self.queue[0]
        ids = req.prefill_ids
        n = len(ids)
        cached = pool.match_prefix(ids)
        bs = pool.block_size
        raw = min(int(cached), n - 1)
        raw -= raw % bs
        if chunk_len is not None and n - raw > chunk_len:
            start, bucket, chunked = raw, int(chunk_len), True
        else:
            start, bucket = self.plan_prefix(n, cached, bs,
                                             pool.slot_capacity)
            chunked = False
        alloc = pool.acquire(req.rid, ids, req.cache_tokens, start)
        if alloc is None:
            return None
        self.queue.popleft()
        req.slot = alloc.slot
        req.state = RUNNING
        req.t_admitted = time.perf_counter()
        self.active[alloc.slot] = req
        if self.flight is not None:
            self.flight.admitted(req, alloc.slot, bucket, 1)
        return req, alloc, bucket, chunked

    def rollback_admission(self, requests, pool):
        """Undo admissions whose prefill failed: release each slot (and
        its blocks) and put the requests back at the FRONT of the queue
        in their order."""
        for req in reversed(list(requests)):
            if req.slot is not None:
                pool.release(req.slot)
                self.active.pop(req.slot, None)
                req.slot = None
            req.state = QUEUED
            req.t_admitted = None
            self.queue.appendleft(req)
            if self.flight is not None:
                self.flight.admission_rolled_back(req)

    def abort(self, request, pool):
        """Retire ``request`` unfinished with no further tokens."""
        if request.slot is not None and request.slot in self.active:
            pool.release(request.slot)
            del self.active[request.slot]
            request.slot = None
        try:
            self.queue.remove(request)
        except ValueError:
            pass
        request.state = DONE
        request.stop_reason = "aborted"
        request.t_done = time.perf_counter()
        self.completed.append(request)

    def expire_deadlines(self, pool, prefilling=(), now=None):
        """Retire requests past their ``deadline_ms``: queued ones (no
        tokens) and running ones that are decoding (first token already
        read; slots mid-prefill or parked in ``prefilling`` expire on a
        later step, once their prefill has landed). Returns
        ``(expired_queued, expired_active)``, each with stop reason
        "deadline". A retired decode's token still in flight is masked
        at harvest like an EOS stop's."""
        now = time.perf_counter() if now is None else now
        expired_q = [r for r in self.queue if r.past_deadline(now)]
        for req in expired_q:
            self.abort(req, pool)
            req.stop_reason = "deadline"
        expired_a = [r for slot, r in sorted(self.active.items())
                     if r.generated and slot not in prefilling
                     and r.past_deadline(now)]
        for req in expired_a:
            self.finish(req, pool, "deadline")
        return expired_q, expired_a

    def stop_reason(self, request, token):
        """"eos" / "max_tokens" / None (keep decoding)."""
        if request.eos_id is not None and token == request.eos_id:
            return "eos"
        if len(request.generated) >= request.max_new_tokens:
            return "max_tokens"
        return None

    def should_stop(self, request, token):
        return self.stop_reason(request, token) is not None

    def saturated(self, request):
        """Tokens read plus tokens in flight reach max_new_tokens: the
        request needs no further decode, so its slot can be released
        before the next decode goes out."""
        return (len(request.generated) + request.inflight
                >= request.max_new_tokens)

    def prerelease(self, request, pool):
        """Free a saturated request's slot ahead of its final token's
        harvest; the request stays RUNNING until finish()."""
        pool.release(request.slot)
        del self.active[request.slot]
        request.slot = None

    def finish(self, request, pool, reason=None):
        """Retire a request, freeing its slot unless prereleased. A
        ``hold_kv`` request keeps its slot and blocks for ``export_kv``;
        only its active-table entry goes."""
        if request.slot is not None:
            del self.active[request.slot]
            if not request.hold_kv:
                pool.release(request.slot)
                request.slot = None
        request.state = DONE
        request.stop_reason = reason
        request.t_done = time.perf_counter()
        self.completed.append(request)

    @property
    def pending(self):
        return bool(self.queue or self.active)
