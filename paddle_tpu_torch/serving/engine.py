"""Continuous-batching inference engine over the paged KV pool.

Ports the paged path of ``paddle_tpu/serving/engine.py``
(``ServingEngine(model, paged=True, paged_attn=True)`` there). One
engine step:

  1. prerelease: slots whose request's max-token stop is already decided
     by tokens in flight free now;
  2. admission + prefill: each admitted request pins its longest cached
     prefix (radix index) and prefills only the uncached tail;
  3. ONE pooled decode advances every slot a token, its attention
     through the paged decode kernel;
  4. harvest: the PREVIOUS step's tokens are read on the host.

One-step-deep pipeline (``async_depth=1``): the token and position
vectors stay on the device and chain from one program to the next; each
step's tokens are copied without blocking into pinned host memory behind
a CUDA event, and that event is waited on only after the next step has
been queued, so the host's bookkeeping overlaps the card's work. A
request that stops on EOS has one more token in flight, which the
harvest masks; max-token stops are known at dispatch and pay nothing.
``async_depth=0`` harvests every dispatch at once.

The engine runs eagerly; PyTorch queues each kernel as the host reaches
it.
"""
import time

import numpy as np
import torch

from ..core.device import resolve_device
from .metrics import ServingMetrics
from .paged.pool import PagedKVPool, upload
from .paged.programs import build_paged_fns
from .scheduler import RUNNING, Request, StepScheduler


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


class ServingConfig:
    """num_slots sizes the decode batch; max_len is the per-slot capacity
    (default: the model's max_seq_len); buckets/bucket_min the prefill
    pad widths; eos_id the default stop token; async_depth 1 (pipelined)
    or 0 (synchronous); block_size/num_blocks the paged pool; device
    where the engine runs (None = the card).

    The reference's other paths are not ported and raise: the
    slot-contiguous pool (``paged=False``), sampling, speculative
    decoding, chunked prefill and disaggregated roles."""

    def __init__(self, num_slots=8, max_len=None, buckets=None,
                 bucket_min=32, eos_id=None, async_depth=1, block_size=16,
                 num_blocks=None, device=None, paged=True, sampling=False,
                 speculative=False, prefill_chunk=None, role="monolithic"):
        if not paged:
            raise NotImplementedError(
                "paged=False: the slot-contiguous pool is not ported; the "
                "paged pool serves every request")
        if sampling:
            raise NotImplementedError(
                "sampling: greedy only until the serving.sched slice")
        if speculative:
            raise NotImplementedError(
                "speculative decoding comes with the serving.spec slice")
        if prefill_chunk is not None:
            raise NotImplementedError(
                "prefill_chunk comes with the serving.sched slice")
        if role != "monolithic":
            raise NotImplementedError(
                "prefill/decode roles come with the kv_wire slice")
        self.num_slots = int(num_slots)
        self.max_len = max_len
        self.buckets = buckets
        self.bucket_min = int(bucket_min)
        self.eos_id = eos_id
        self.async_depth = int(async_depth)
        if self.async_depth not in (0, 1):
            raise ValueError(
                f"async_depth must be 0 (synchronous) or 1 (one-step-"
                f"deep pipeline), got {async_depth}")
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        self.device = device


class ServingEngine:
    """Continuous-batching engine over a GPTForCausalLM. Weights are
    snapshotted at construction; greedy decoding. Typical use::

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
        self.cache_len = cache_len
        self.params = model.export_decode_params()
        self.pool = PagedKVPool(
            config.num_slots, cfg.num_layers, cfg.num_heads, cache_len,
            cfg.hidden_size // cfg.num_heads, block_size=config.block_size,
            num_blocks=config.num_blocks, device=self.device)
        self._prefill_fn, self._decode_fn = build_paged_fns(
            cfg, config.num_slots, self.pool.block_size,
            self.pool.num_blocks, self.pool.blocks_per_slot)
        self.scheduler = StepScheduler(buckets, cache_len)
        self.metrics = ServingMetrics()
        self.metrics.set_prefix_pool(self.pool.stats)
        # rolling device state: last token and next write position per
        # slot; programs chain them, so step N+1 never waits on step N's
        # values reaching the host
        self._toks = torch.zeros(config.num_slots, dtype=torch.int32,
                                 device=self.device)
        self._pos = torch.zeros(config.num_slots, dtype=torch.int32,
                                device=self.device)
        self._pending = []   # dispatched, not yet read back
        self._closed = False

    # ---------------------------------------------------------- requests

    def add_request(self, prompt, max_new_tokens, eos_id=None,
                    on_token=None):
        """Queue a prompt; returns the Request at once. Tokens stream
        through ``on_token(request, token)`` as they are read back."""
        if self._closed:
            raise RuntimeError("engine is closed: no new requests")
        req = Request(prompt, max_new_tokens,
                      eos_id=self.config.eos_id if eos_id is None
                      else eos_id, on_token=on_token)
        return self.scheduler.submit(req)

    @property
    def pending(self):
        return self.scheduler.pending or bool(self._pending)

    # ------------------------------------------------------ device reads

    def _to_host(self, t):
        """Start the device->host copy of ``t``: on the card a
        non-blocking copy into pinned memory behind a recorded event."""
        if t.device.type == "cpu":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _read_back(handle):
        host, ev = handle
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    # --------------------------------------------------------- host side

    def _emit(self, req, token):
        """Account one generated token; retire the request on stop."""
        first = not req.generated
        req.generated.append(token)
        self.metrics.tokens_generated += 1
        if first:
            self.metrics.record_first_token(req)
        if req.on_token is not None:
            req.on_token(req, token)
        reason = self.scheduler.stop_reason(req, token)
        if reason is not None:
            self.scheduler.finish(req, self.pool, reason)
            self.metrics.record_completion(req)

    def _harvest(self, pending):
        """Read back dispatched tokens (the prefills and the decode of
        one step, in dispatch order) and run the stop checks."""
        M = self.metrics
        for kind, handle, members in pending:
            vals = self._read_back(handle)
            if kind == "prefill":
                for (req, _slot), tok in zip(members, vals):
                    req.inflight -= 1
                    self._emit(req, int(tok))
                continue
            for slot, req in members.items():
                if req.state != RUNNING:
                    # stopped on EOS after this decode went out: the
                    # extra token is masked
                    M.speculative_masked += 1
                    continue
                req.inflight -= 1
                self._emit(req, int(vals[slot]))

    # ------------------------------------------------------------- steps

    def _dispatch(self, entry, sync):
        if sync:
            self._harvest([entry])
        else:
            self._pending.append(entry)

    def _paged_prefills(self, sync):
        """Prefix-aware admission + tail-only prefill. The prompt's full
        blocks are committed to the radix index only after the prefill
        ran, so a failed prefill rolls back (slot and blocks released,
        request re-queued) without poisoning the cache."""
        sch, pool, M = self.scheduler, self.pool, self.metrics
        while True:
            admission = sch.admit_paged(pool)
            if admission is None:
                break
            req, alloc, bucket = admission
            ids = req.prefill_ids
            start = alloc.prefix_tokens
            tail = len(ids) - start
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :tail] = ids[start:]
            req.inflight += 1
            try:
                first, self._toks, self._pos = self._prefill_fn(
                    self.params,
                    upload(tokens, self.device),
                    tail, start, alloc.slot, pool.table_row(alloc.slot),
                    self._toks, self._pos, pool.kc, pool.vc)
            except BaseException:
                req.inflight -= 1
                sch.rollback_admission([req], pool)
                raise
            pool.commit_prefix(alloc.slot, ids)
            M.requests_admitted += 1
            M.prefills += 1
            M.record_prefix_reuse(start, tail)
            self._dispatch(("prefill", self._to_host(first),
                            [(req, alloc.slot)]), sync)

    @torch.inference_mode()
    def step(self):
        """One engine iteration; returns True while work remains."""
        sch, pool, M = self.scheduler, self.pool, self.metrics
        t0 = time.perf_counter()
        sync = self.config.async_depth == 0
        prev, self._pending = self._pending, []

        for req in [r for r in sch.active.values() if sch.saturated(r)]:
            sch.prerelease(req, pool)

        self._paged_prefills(sync)

        snapshot = {slot: req for slot, req in sch.active.items()
                    if not sch.saturated(req)}
        if snapshot:
            for req in snapshot.values():
                req.inflight += 1
            nxt, self._pos = self._decode_fn(
                self.params, self._toks, self._pos, pool.device_tables(),
                pool.kc, pool.vc)
            self._toks = nxt
            M.decode_steps += 1
            self._dispatch(("decode", self._to_host(nxt), snapshot), sync)

        self._harvest(prev)
        if prev or snapshot:
            M.note_work(t0, time.perf_counter())
        return self.pending

    def run(self):
        """Step until every submitted request is done; returns the
        completed requests in submission order."""
        while self.step():
            pass
        return sorted(self.scheduler.completed, key=lambda r: r.rid)

    def close(self):
        """Retire whatever is still owed tokens as ``aborted`` (slots
        and blocks released). Idempotent; also the context-manager
        exit."""
        if self._closed:
            return
        sch = self.scheduler
        owed = {r.rid: r for r in sch.queue}
        owed.update((r.rid, r) for r in sch.active.values())
        for _, _, members in self._pending:
            rs = members.values() if isinstance(members, dict) \
                else [r for r, _ in members]
            owed.update((r.rid, r) for r in rs if r.state == RUNNING)
        self._pending = []
        for r in sorted(owed.values(), key=lambda r: r.rid):
            r.inflight = 0
            sch.abort(r, self.pool)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
