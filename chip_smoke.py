#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--parent TREE]
(``--fleet`` runs phases 1, 4, 16 and 17 alone and prints no kernels
line)

Phases, one line each:
  1. build   every csrc/*.cu kernel with nvcc (one process per source,
             all started together) and print the build seconds, with
             ptxas's registers and spills and the blocks an SM of the f32
             K1 (at each key split), K2/K3, K5 and K6/K7; beside them the
             parent commit's fused_ce.cu (from --parent TREE or git
             history, where either is at hand) for phases 9 and 11;
  2. K4      paged decode attention against its plain PyTorch version at
             the engine's shapes: ragged lengths, mid-block tails,
             trash-padded tables over garbage, a length past MB*BS,
             f32 and bf16, plus head_dim 32/128 and a length-0 slot;
             lengths one row before, on and past a chunk boundary, a
             1-row slot among long ones, every slot at MB*BS; every case
             twice for the same bits; K4 timed with the bound;
  3. K1      flash-attention forward against its plain version for O and
             LSE: [2,12,1024,64], a ragged [1,12,333,64], the serving
             cross-check's longest shape and head_dim-128 cases, causal
             and not, f32 and bf16; bf16 against both plain variants (P
             kept f32, and P rounded to bf16 as the kernel rounds it);
             f32 also at S = 1, 17, 63, 65, 1024 and 2048, D = 128, B*H
             1 .. 96 and an operand not 16-byte aligned, each twice for
             the same bits; the f32 K1 timed twice in turns with SDPA's f32
             forward, at [1,12,661,64] and [8,12,1024,64] causal, with
             TFLOP/s and the share of the bound;
  4. serve   GPT-124M (random weights from a seeded torch.Generator) in
             ServingEngine(num_slots=8, block_size=16, async_depth=1):
             16 greedy requests in two staggered waves, four sharing a
             256-token prefix; K4 launches must equal decode steps x 12;
  5. check   every request's stream against the teacher-forced argmax of
             the port's own forward (through K1): a token may differ only
             where the reference's top-2 logit margin is below 1e-4;
  6. K2/K3   flash-attention backward (dQ; dK and dV) against the plain
             backward: the training shape [8,12,1024,64] causal f32 and
             bf16, a ragged [1,12,333,64] causal and not, D = 128 at
             [1,4,200,128] and [2,3,65,128]; bf16 against both plain
             variants (P and dS kept f32, and rounded to bf16 as the
             kernels round them); every case run twice for the same
             bits; K2, K3, the plain backward and the backward of
             PyTorch's scaled_dot_product_attention timed at the training
             shape in f32, with SDPA's backward around them (median and
             spread), and in bf16 (the flagship's dtype)
             with K1, SDPA's forward and SDPA's backward three times
             between them, with TFLOP/s and the fraction of the bound;
  7. train   GPT-124M with an untied head (random weights from a seeded
             torch.Generator), batch 8 x seq 1024, labels = ids, AdamW(1e-4,
             weight_decay 0.01, ClipGradByGlobalNorm(1.0)), 6 steps: every
             loss finite, the last below the first, K1 = K2 = K3 launches =
             6 x 12; median step ms of steps 2-6, tokens/s, peak memory;
  8. cpu     a 2-layer GPT at full width, untied and tied (the tied one
             puts K5-K7 and K7's dW in the word-embedding grad), batch 1 x
             seq 256, the same weights on the card and on the CPU: 3 AdamW
             steps each, per-step losses and step 1's gradient of every
             parameter within the stated tolerances;
  9. K5-K7   the fused linear cross-entropy kernels (K5 loss and LSE, K6
             dx, K7 dW) against their plain versions at the flagship shape
             (T = 8 x 1024, H = 768, V = 50304, about 5 % of the rows
             ignore_index) in f32 and bf16 and at ragged shapes (T = 1 ..
             1000, H = 13 .. 1536, V = 7 .. 50304); bf16 K6/K7 against
             both plain variants (d kept f32, and d rounded to bf16 as the
             kernels round it); every case twice for the same bits, the
             f32 K5's loss and LSE within the same tolerance of the
             parent's; K5, K6, K7 (30 calls in bf16), the plain forward
             and backward and, as a yardstick, the two-call composition
             F.cross_entropy(F.linear) forward and backward timed in both
             dtypes, with TFLOP/s and the fraction of the bound; the f32
             K5 timed in turns with the parent's (this tree, parent,
             parent, this tree), every turn faster than every one of the
             parent's;
 10. flagship the reference's flagship training step
             (tools/baseline_bench.py bench_gpt): GPT-124M with the default
             tied head, dropout 0, batch 8 x seq 1024, labels = ids,
             AdamW(1e-4, weight_decay 0.01), under
             amp.auto_cast(level="O1", dtype="bfloat16"), 6 steps: every
             loss finite, the last below the first, K1 = K2 = K3 launches
             = 6 x 12 and K5 = K6 = K7 = 6; median step ms, tokens/s, peak
             memory;
 11. f32     the same step in f32 (no auto_cast, TF32 off): the tied
             head through the f32 K5, K6 and K7 once a step; the same
             gates and numbers. Then, where the parent's K5 was
             built, the same 6 steps with it, in turns (this tree,
             parent, parent, this tree): every step's loss within 1e-4
             relative (the sums run in another order), peak memory no
             more than the parent's + 64 MiB, and each side's median step
             over its two runs;
 12. optim   phase 8's tied 2-layer GPT at full width, batch 1 x seq 256,
             the same weights on the card and on the CPU: 3 steps of each of
             SGD, Momentum, Adamax, Adagrad, RMSProp, Lamb, LarsMomentum,
             Adadelta and Ftrl, of Adam with an L1Decay and a
             ClipGradByValue, and of AdamW over two param groups: every
             step's loss within LOSS_RTOL of the CPU's, and every
             parameter's move within the stated tolerance of the CPU's.
             Then on the card AdamW with a schedule: 2 steps,
             state_dict(), a fresh model and optimizer loaded, 2 more steps
             give the bits of 4 straight steps. K1-K3 = 82, K5-K7 = 41;
 13. recompute phase 11's step with TransformerLMConfig(recompute=True), 6
             steps: losses within 1e-5 relative of phase 11's, K1 = 2 x 6 x
             12 (each block's forward again in the backward), K2 = K3 = 72,
             K5-K7 = 6, peak memory below phase 11's, step ms beside it;
             then 2 steps of phase 10's O1 bf16 step with recompute: losses
             within 1e-3 relative of phase 10's first two (the
             recomputation casts as its forward did);
 14. generate GPT-124M (phase 4's weights) model.generate(): greedy, 4
             prompts of 128 tokens, 96 new: every token the teacher-forced
             argmax of the port's forward (through K1) and the
             ServingEngine's stream for the prompt (through K4), either
             differing only at a top-2 margin below 1e-4; top-k 40 at
             temperature 0.8, seed 1 twice: the same tokens, each within
             the teacher-forced top 40 (less 1e-4); beam search (4 beams,
             batch 2, 32 new) on phase 8's 2-layer model, card against
             CPU, the same tokens; generated tokens/s of greedy and beams;
 15. rest    the rest of the serving engine on phase 4's GPT-124M, seed
             and 16 requests in phase 4's two waves, num_slots 8, every
             stream held to phase 5's rule (token for token, or parting at
             a top-2 margin below 1e-4 in the port's forward; for a
             sampled token the margin of the logits the head draws from)
             and each run's tokens/s printed beside phase 4's: 15a the slot
             pool (paged=False, max_len 1024) at async_depth 1 and 0
             against phase 4's streams; 15b prefill_chunk 128 under a
             256-token budget on both pools against the same pool
             unchunked, with the chunk dispatches; 15c speculative
             decoding (spec_k 4) on both pools against phase 4, with the
             drafted and accepted tokens and the acceptance rate; 15d
             sampling=True with 8 greedy and 8 sampled requests
             (temperature 0.8, top-k 40, top-p 0.95, seeds 0-7) on both
             pools: greedy rows against phase 4, a second run the same
             bits, the sampled rows across pools and chunking, and phase
             8's 2-layer model card against CPU; 15e a role="prefill"
             engine (hold_kv, max_new_tokens 1) exporting each prompt
             through json.dumps/loads into a role="decode" engine against
             phase 4, the wire bytes a prompt token and the handoff ms,
             and one flipped byte refused with KVWireError, the pool
             unchanged. On every paged run K4 = 12 x its plain decode
             steps (verify steps attend in plain torch), set to 0 before
             and read after; every pool conserved and empty at the end.
 16. fleet   the hardened engine and the router on phase 4's GPT-124M,
             weights and 16 requests, every replica a ServingEngine(
             paged=True, num_slots=8, block_size=16) on the card with its
             own replica_id, every stream held to phase 5's rule against
             phase 4's: 16a Router over two InProcessTransport replicas
             (EngineGateway stepping threads), its state() keys, tokens/s
             beside phase 4's and each replica's share, then the same
             requests to the two gateways and to one straight from the
             main thread (no router threads); 16b the same
             router with replica r0 killed once two of its requests are
             streaming: every request completes by journal replay, >= 1
             failover, the kill -> done wall; 16c one engine under
             FaultPlan(seed=13) at DEFAULT_RATES with max_dispatch_retries
             8, twice: a non-empty fault log, the same both runs, no abort;
             16d supervisor=True with a wedged decode: queue_stall fires,
             exactly one restart, health degraded during the replay and
             healthy after, the peak memory over the start below a
             second pool (the old one is freed first); 16e one
             replica behind EngineGateway.serve() on 127.0.0.1 and a
             router over HTTPTransport: 4 requests, GET /metrics and
             /debug/health answer 200. Every run's pool conserved and
             empty; K4 = 12 x its engines' decode steps.
 17. observe the observatories and the fleet telemetry on phase 4's
             GPT-124M, weights and 16 requests, spread over three
             tenant_ids, on ServingEngine(paged=True, num_slots=8,
             block_size=16) with perf, the cache observatory, trace
             spans and SLO targets on: 17a every stream held to phase
             5's rule against phase 4's, the pool conserved and empty;
             17b the decode program's roofline floor equal to this
             script's reckoning (parameters once, each slot's live K/V
             read and its new row written, over HBM_BPS), its roofline
             fraction in (0, 1], attributed_fraction printed, the MFU
             gauge in (0, 1), the HBM gauges within a pool block of
             torch.cuda.memory_allocated; 17c tokens per tenant summing
             to the engine's, SLO attained + violating = completed,
             /debug/requests?tenant= exactly that tenant's, one trace a
             request from /debug/traces through the TraceAssembler,
             /debug/cache with the cache keys and an MRC, every route
             200; 17d two replicas behind EngineGateway.serve() with a
             FleetPoller and a FleetServer: both up and healthy, the
             rollup's sums equal the replicas', /fleet/* 200, one killed
             and down after down_after cycles with one replica_flap for
             it alone; 17e tokens/s with every observatory on and off
             (perf, cache, trace spans, health), on/off/off/on, then on
             with a poller scraping every 0.25 s, each beside phase 4's.
             K4 = 12 x each run's decode steps.
Then the card's name and power limit, one JSON line of kernel numbers
(launches summed over the main paths: phases 4, 14, 15's paged runs, 16
and 17 for K4, 5, 14, 16 and 17 for the serving K1 row, 7, 11, 12 and 13 for the
f32 training rows, 10 and 13 for the bf16 ones), and as the last line
{"ok": true, "device": {...}}.

TF32 is off for matmuls and cuDNN, so every f32 product is full f32.
Any failure raises: the exit code is non-zero and no "ok" line prints.
Without a CUDA device, or without the package beside this file, it
exits non-zero at once.
"""
import argparse
import base64
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = 1e-5    # f32 sums over <= 1024 rows, only their order differs
F32_FLASH_TOL = 2e-5   # f32 flash: 64-key tiles rescaled, O(1) values
BF16_TOL = 2e-2   # kernel output rounded to bf16 (half an ulp at |x|~4)
TIE_MARGIN = 1e-4
# K2/K3 grads against the plain backward, relative to the largest grad:
# f32 sums over up to 1024 rows in another order; bf16 grads are rounded
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 2e-2
# bf16 K2/K3 against the plain backward that rounds P and dS to bf16 as the
# kernels (and the Pallas kernels) do: half a bf16 ulp of the largest grad
# for the kernels' final rounding, plus an occasional P or dS element that
# an exp or a sum in another order rounds the other way
BWD_BF16P_TOL = 5e-3
# card against CPU, the same f32 model: sums in another order (cuBLAS vs
# the CPU's BLAS); losses relative, grads relative to each parameter's
# largest grad
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
TRAIN_STEPS = 6
# K5 against its plain version: the loss and LSE are f32 sums over H and
# a logsumexp over V = 50304 on both sides, in another order; K6/K7
# relative to the largest grad: f32 sums over V or T in another order,
# bf16 grads rounded once (half an ulp is 2e-3 of the value)
CE_LOSS_TOL = 1e-4
CE_F32_TOL = 1e-4
CE_BF16_TOL = 1e-2
# bf16 K6/K7 against the plain backward with d rounded to bf16 as the
# kernels (and the Pallas kernels) round it: half a bf16 ulp of the
# largest grad for the kernel's final rounding (at most 2^-8 = 3.9e-3 of
# it), plus f32 sums in another order
CE_BF16D_TOL = 5e-3
# bf16 K1 against the plain version that rounds P to bf16 over 64-key
# blocks as the kernel does: both round O once (2^-8 of |O|), and an exp or
# a sum in another order can round a P element or O the other way; LSE
# is f32 on both sides (sums over up to 1024 keys, exp2 for exp)
BF16P_TOL = 1e-2
FLASH_LSE_TOL = 5e-5
# the commit whose f32 K5 (the port's first one) phases 9 and 11 hold the
# redesigned one against, where its source is at hand: {(source, symbol):
# ctypes argtypes of its C entry point}. Its K5 has this tree's signature,
# so the wrapper launches it (parent_kernels), with the parent's own vocab
# split of its 64-row tiles (its _FWD_SPLIT[torch.float32])
PARENT = "911c96e"
PARENT_SYMBOLS = {("fused_ce", "fused_ce_forward"): (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}
PARENT_F32_SPLIT = (64, 4)
FLAGSHIP = dict(batch=8, seq=1024)
OPTIM_STEPS = 3
# phase 12, card against CPU after 3 steps: per parameter, the L2 norm of
# the difference between the card's and the CPU's move within this share
# of the CPU's move. The updates linear in the grad (SGD, Momentum, RMSProp
# with epsilon inside its root, LarsMomentum, Adadelta) carry the grads'
# rounding differences (phase 8) as they are; the ones that divide a grad
# by its own size (Adam, Adamax, Adagrad, Lamb, Ftrl) turn an element whose
# grad is near 0 into a step of full size on either side, which a few
# elements of a tensor add to its norm. Every element within twice the
# largest move; the key third of each QKV bias (its true grad is 0, all
# noise) is held to that alone
OPT_LINEAR_TOL = 1e-3
OPT_SIGN_TOL = 5e-2
RECOMPUTE_F32_RTOL = 1e-5
RECOMPUTE_BF16_RTOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate for the dtype."""
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters=30, warmup=3):
    """Mean device time of one call: CUDA events around each call, the
    50 MB L2 flushed before each by reading 256 MB (a decode step finds
    each layer's cache cold; a read leaves no dirty lines for the timed
    call to write back). The card then sleeps about 0.1 ms before the
    start event, so that the host has queued the call before the card
    reaches it: a kernel of tens of microseconds is not timed with the
    host's Python between its two events."""
    flush = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.max()
        torch.cuda._sleep(200_000)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# ---------------------------------------------------------------- phase 1

def ptxas_lines(log):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: the kernel's
    name (``flash_bwd_dq_mma_kernel<64>`` through ``c++filt``, of the
    toolchain nvcc uses; the mangled name without it), its registers and
    its stack and spills."""
    kernels, stats, spill = [], [], ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernels.append(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            stats.append(f"{line.split(':', 1)[1].strip()}; {spill}")
    try:
        names = subprocess.run(["c++filt"], input="\n".join(kernels),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines() or kernels
    except OSError:
        names = kernels
    names = [re.sub(r"^void |\(.*", "", n.replace("(anonymous namespace)::",
                                                   "")) for n in names]
    return [f"{n}: {st}" for n, st in zip(names, stats)]


# ---------------------------------------------------------------- phase 2

def paged_case(torch, S, nh, hd, BS, MB, lengths, dtype, seed):
    """Engine layout: block 0 is trash (filled with 1e4 garbage), slot s
    owns blocks 1 + s*MB .. for its live prefix, padding entries name
    trash, and rows past each length inside a slot's own blocks hold
    garbage too (a recycled slot's previous tenant)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    NB = S * MB + 1
    kc = torch.randn(NB, nh, BS, hd, generator=g, device="cuda")
    vc = torch.randn(NB, nh, BS, hd, generator=g, device="cuda")
    q = torch.randn(S, nh, hd, generator=g, device="cuda")
    kc[0] = 1e4
    vc[0] = 1e4
    tables = torch.zeros(S, MB, dtype=torch.int32)
    for s, n in enumerate(lengths):
        used = min(-(-max(n, 0) // BS), MB)
        tables[s, :used] = 1 + s * MB + torch.arange(used)
        for r in range(max(n, 0), used * BS):
            b = int(tables[s, r // BS])
            kc[b, :, r % BS] = 1e4
            vc[b, :, r % BS] = 1e4
    dt = getattr(torch, dtype)
    return (q.to(dt), kc.to(dt), vc.to(dt), tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def k4_case(torch, pa, label, args, tol):
    """K4 against the plain version in f32 on the same (rounded) inputs,
    on the slots with a length > 0 (one <= 0 must give finite zeros);
    twice for the same bits. Returns the error against the plain
    version."""
    got = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_plain(*(a.float() if a.is_floating_point() else a
                                  for a in args))
    lens = args[4].tolist()
    live = [i for i, n in enumerate(lens) if n > 0]
    dead = [i for i, n in enumerate(lens) if n <= 0]
    torch.cuda.synchronize()
    err = (got[live].float() - ref[live]).abs().max().item()
    check(err <= tol, f"K4 {label}: max abs err {err} > {tol}")
    check(not got[dead].float().abs().any() and bool(
        torch.isfinite(got).all()), f"K4 {label}: a length <= 0 slot is "
          "not zeros")
    check(torch.equal(got, pa.paged_decode_attention(*args)),
          f"K4 {label}: two runs differ")
    print(f"  K4 {label}: max_abs_err={err:.3e} (tol {tol}); a second run "
          "gives the same bits")
    return err


def phase_k4(torch, pa):
    S, nh, hd, BS, MB = 8, 12, 64, 16, 64
    lengths = [1, 16, 17, 300, 555, 1024, 1100, 733]   # 1100 > MB*BS
    out = {}
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        args = paged_case(torch, S, nh, hd, BS, MB, lengths, dtype, 1)
        pages, chunks = pa.decode_chunks(BS, MB, hd, args[0].element_size())
        out[dtype] = (k4_case(torch, pa, f"{dtype} S={S} nh={nh} "
                              f"hd={hd} BS={BS} MB={MB} lengths={lengths} "
                              f"({chunks} chunks of {pages} pages)", args,
                              tol), args)
        cr = pages * BS
        cap = BS * MB
        edges = [cr - 1, cr, cr + 1, 1, cap, 2 * cr, 3 * cr - 1, cap + 5]
        k4_case(torch, pa, f"{dtype} chunk edges {edges} "
                f"(chunk {cr} rows)",
                paged_case(torch, S, nh, hd, BS, MB, edges, dtype, 4), tol)
        k4_case(torch, pa, f"{dtype} every slot at MB*BS = {cap}",
                paged_case(torch, S, nh, hd, BS, MB, [cap] * S, dtype, 5),
                tol)
        for hd2 in (32, 128):
            k4_case(torch, pa, f"{dtype} hd={hd2}",
                    paged_case(torch, 3, 4, hd2, 8, 5, [1, 13, 40], dtype, 2),
                    tol)
    k4_case(torch, pa, "float32 length<=0 slots [0, 5, -3]",
            paged_case(torch, 3, 4, 64, 16, 4, [0, 5, -3], "float32", 3),
            F32_TOL)

    err, args = out["float32"]
    q, kc, vc, tables, lens = args
    ms = time_ms(torch, lambda: pa.paged_decode_attention(*args))
    plain_ms = time_ms(torch, lambda: pa.paged_decode_plain(*args))
    rows = sum(min(n, MB * BS) for n in lengths)
    row_bytes = nh * hd * 4
    nbytes = 2 * S * row_bytes + 2 * rows * row_bytes + tables.numel() * 4 \
        + lens.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * rows * nh * hd, "float32")
    print(f"  K4 float32 time {ms:.4f} ms ({b_ms / ms:.3f} of the bound), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "paged_decode_attention", "route": "cuda",
            "dtype": "float32",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/ops/paged_attention.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# ---------------------------------------------------------------- phase 3

def phase_k1(torch, attn, main_shape, train_shape, _build):
    import torch.nn.functional as F
    cases = [((2, 12, 1024, 64), c, dt) for c in (True, False)
             for dt in ("float32", "bfloat16")]
    cases += [((1, 12, 333, 64), c, dt) for c in (True, False)
              for dt in ("float32", "bfloat16")]
    cases += [(main_shape, True, "float32"), (main_shape, True, "bfloat16"),
              ((1, 4, 200, 128), True, "float32"),
              ((1, 4, 200, 128), False, "bfloat16"),
              ((1, 4, 200, 128), True, "bfloat16"),
              ((2, 3, 65, 128), True, "bfloat16"),
              ((1, 3, 1, 64), False, "bfloat16")]
    # the f32 K1's short and long grids, every key split, ragged S
    cases += [((1, 1, 1, 64), True, "float32"), ((1, 1, 1, 128), False,
                                                  "float32"),
              ((2, 3, 17, 64), True, "float32"),
              ((1, 5, 63, 128), True, "float32"),
              ((1, 5, 63, 64), False, "float32"),
              ((2, 2, 65, 64), True, "float32"),
              ((2, 2, 65, 128), False, "float32"),
              ((1, 12, 661, 128), True, "float32"),
              (train_shape, True, "float32"),
              ((1, 4, 2048, 128), True, "float32"),
              ((1, 2, 2048, 64), False, "float32")]
    g = torch.Generator(device="cuda").manual_seed(4)
    main = big = None
    for shape, causal, dtype in cases:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for _ in range(3))
        scale = 1.0 / shape[-1] ** 0.5
        o, lse = attn.flash_attention_forward(q, k, v, scale, causal)
        # bf16: against P kept f32 and against P rounded as the kernel
        # rounds it
        variants = ([(None, F32_FLASH_TOL, F32_FLASH_TOL)]
                    if dtype == "float32" else
                    [(None, BF16_TOL, FLASH_LSE_TOL),
                     (torch.bfloat16, BF16P_TOL, FLASH_LSE_TOL)])
        line = []
        for p_dtype, tol, ltol in variants:
            ro, rlse = attn.flash_attention_plain(q, k, v, scale, causal,
                                                  p_dtype=p_dtype)
            torch.cuda.synchronize()
            eo = (o.float() - ro.float()).abs().max().item()
            el = (lse - rlse).abs().max().item()
            check(eo <= tol and el <= ltol,
                  f"K1 {shape} causal={causal} {dtype} (P "
                  f"{p_dtype or 'f32'}): O err {eo} > {tol} or LSE err {el} "
                  f"> {ltol}")
            line.append(f"vs P {'bf16' if p_dtype else 'f32'}: O err "
                        f"{eo:.3e} (tol {tol}), LSE err {el:.3e} (tol "
                        f"{ltol})")
            del ro, rlse
        if dtype == "float32":
            again = attn.flash_attention_forward(q, k, v, scale, causal)
            check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
                  f"K1 {shape} causal={causal} f32: two runs differ")
            line.append("a second run gives the same bits")
        print(f"  K1 {list(shape)} causal={causal} {dtype}: "
              + "; ".join(line))
        if dtype == "float32" and causal and shape == main_shape:
            main = (q, k, v, scale, max(eo, el))
        elif dtype == "float32" and causal and shape == train_shape:
            big = (q, k, v, scale, max(eo, el))

    # an operand one float past a 16-byte boundary: the element-by-element
    # staging, at a short grid and a long one
    for shape in (main_shape, (2, 12, 1024, 64)):
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   for _ in range(3))
        buf = torch.empty(q.numel() + 1, device="cuda")
        shifted = buf[1:].view_as(q)
        shifted.copy_(q)
        got = attn.flash_attention_forward(shifted, k, v, 0.125, True)
        want = attn.flash_attention_forward(q, k, v, 0.125, True)
        ref = attn.flash_attention_plain(q, k, v, 0.125, True)
        torch.cuda.synchronize()
        e1 = max((a - r).abs().max().item() for a, r in zip(got, ref))
        e2 = max((a - w).abs().max().item() for a, w in zip(got, want))
        check(shifted.data_ptr() % 16 and e1 <= F32_FLASH_TOL
              and e2 <= F32_FLASH_TOL, f"K1 {shape} f32, q not 16-byte "
              f"aligned: {e1} from the plain version, {e2} from the aligned "
              "q's")
        print(f"  K1 {list(shape)} causal f32, q not 16-byte aligned: "
              f"{e1:.3e} from the plain version, {e2:.3e} from the aligned "
              f"q's output (tol {F32_FLASH_TOL})")

    key_split = _build.function("flash_fwd",
                                "flash_attention_forward_f32_key_split",
                                [ctypes.c_int] * 3)
    rows = []
    for q, k, v, scale, err in (main, big):
        b, h, s, d = q.shape
        times, libs = [], []
        for _ in range(2):  # in turns with SDPA, whose reading drifts
            times.append(time_ms(torch, lambda: attn.flash_attention_forward(
                q, k, v, scale, True)))
            libs.append(time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)))
        ms = float(np.median(times))
        lib_ms = float(np.median(libs))
        plain_ms = time_ms(torch, lambda: attn.flash_attention_plain(
            q, k, v, scale, True), iters=10)
        pairs = b * h * s * (s + 1) // 2
        flops = 4 * d * pairs
        b_ms, b_by = bound(4 * b * h * s * d * 4 + b * h * s * 4, flops,
                           "float32")
        print(f"  K1 {list(q.shape)} causal f32 (KS = "
              f"{key_split(b * h, s, d)}): "
              f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{b_ms / ms:.4f} of its bound {b_ms:.4f} ms ({b_by}); sdpa f32 "
              f"median {lib_ms:.4f} ms of {[round(x, 4) for x in libs]} "
              f"({ms / lib_ms:.2f}x); plain {plain_ms:.4f} ms")
        rows.append({"name": "flash_attention_forward", "route": "cuda",
                     "dtype": "float32",
                     "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
                     "replaces": "paddle_tpu/ops/attention.py:67",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})
    return rows


# ------------------------------------------------------------ phases 4-5

def workload(vocab):
    """16 greedy requests: prompt lengths 16-600, max_new 32-128, four
    sharing one 256-token prefix; two waves of eight."""
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, vocab, 256)
    shared = [np.concatenate([prefix, rs.randint(0, vocab, k)])
              for k in (20, 45, 100, 7)]
    lone = [rs.randint(0, vocab, n)
            for n in (16, 40, 64, 100, 150, 200, 256, 333, 400, 480, 550,
                      600)]
    prompts = [lone[0], shared[0], lone[1], lone[2], shared[1], lone[3],
               lone[4], lone[5],
               lone[6], shared[2], lone[7], lone[8], shared[3], lone[9],
               lone[10], lone[11]]
    max_new = [int(x) for x in rs.randint(32, 129, len(prompts))]
    return prompts, max_new


def phase_serve(torch, model, prompts, max_new, pa, attn):
    from paddle_tpu_torch.serving import ServingEngine
    L = model.cfg.num_layers
    # warm-up on its own engine: cuBLAS handles, allocator, kernel load
    warm = ServingEngine(model, num_slots=8, block_size=16, async_depth=1)
    warm.add_request(prompts[0], max_new_tokens=4)
    warm.run()
    del warm
    torch.cuda.synchronize()

    eng = ServingEngine(model, num_slots=8, block_size=16, async_depth=1)
    pa.paged_decode_attention.launches = 0
    attn.flash_attention_forward.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts[:8], max_new[:8])]
    for _ in range(24):
        eng.step()
    reqs += [eng.add_request(p, max_new_tokens=n)
             for p, n in zip(prompts[8:], max_new[8:])]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = eng.metrics.snapshot()
    k4 = pa.paged_decode_attention.launches
    steps = eng.metrics.decode_steps
    for r, n in zip(reqs, max_new):
        check(r.done and len(r.generated) == n,
              f"request {r.rid} incomplete: {len(r.generated)}/{n}")
    eng.pool.check_conservation()
    hits = snap["prefix_cache"]["hits"]
    check(hits >= 3, f"prefix cache hits {hits} < 3")
    check(k4 == steps * L, f"K4 launches {k4} != decode steps {steps} x {L}")
    print(f"  served {len(reqs)} requests, {snap['tokens_generated']} "
          f"tokens in {wall:.3f} s wall: tokens/s {snap['tokens_per_sec']:.1f}"
          f", median TTFT {snap['ttft_p50_ms']:.2f} ms, decode steps "
          f"{steps}, prefix_cache hits {hits} (cached tokens "
          f"{snap['prefix_cache']['cached_tokens']}), K4 launches {k4} = "
          f"{steps} x {L}")
    return reqs, k4, snap, wall


def phase_check(torch, model, reqs, attn):
    L = model.cfg.num_layers
    exact, min_margin, ties = 0, float("inf"), 0
    with torch.inference_mode():
        for r in reqs:
            ids = torch.from_numpy(r.output_ids).cuda()[None]
            logits = model(ids)[0].float()
            check(bool(torch.isfinite(logits).all()),
                  f"request {r.rid}: non-finite logits")
            n0 = len(r.prompt)
            lg = logits[n0 - 1:-1]
            top2 = lg.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            pred = lg.argmax(-1).cpu().numpy()
            gen = np.asarray(r.generated)
            bad = np.nonzero(pred != gen)[0]
            min_margin = min(min_margin, float(margin.min()))
            for i in bad:
                check(margin[i] < TIE_MARGIN,
                      f"request {r.rid} token {i}: engine {gen[i]} vs "
                      f"forward {pred[i]} at margin {margin[i]:.3e}")
            ties += len(bad)
            exact += not len(bad)
    k1 = attn.flash_attention_forward.launches
    check(k1 == len(reqs) * L, f"K1 launches {k1} != {len(reqs)} x {L}")
    print(f"  {exact}/{len(reqs)} streams match the teacher-forced forward "
          f"outright, {ties} tokens differ at near-ties (< {TIE_MARGIN}); "
          f"smallest top-2 margin {min_margin:.3e}; K1 launches {k1}")
    return k1


# ---------------------------------------------------------------- phase 6

def bwd_case(torch, attn, shape, causal, dtype, g):
    """q, k, v, dO in ``dtype`` on the card, with O and LSE from K1 and
    delta = rowsum(dO * O) in f32."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for _ in range(4))
    scale = 1.0 / shape[-1] ** 0.5
    o, lse = attn.flash_attention_forward(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    return q, k, v, do, lse, delta, scale


def phase_k2k3(torch, attn, train_shape):
    import torch.nn.functional as F
    cases = [(train_shape, True, "float32"), (train_shape, True, "bfloat16"),
             ((1, 12, 333, 64), True, "float32"),
             ((1, 12, 333, 64), False, "float32"),
             ((1, 12, 333, 64), True, "bfloat16"),
             ((1, 12, 333, 64), False, "bfloat16"),
             ((1, 4, 200, 128), True, "float32"),
             ((1, 4, 200, 128), False, "bfloat16"),
             ((2, 3, 65, 128), True, "bfloat16")]
    g = torch.Generator(device="cuda").manual_seed(6)
    errs = {}
    for shape, causal, dtype in cases:
        q, k, v, do, lse, delta, scale = bwd_case(torch, attn, shape, causal,
                                                  dtype, g)
        args = (q, k, v, lse, do, delta, scale, causal)
        got = (attn.flash_bwd_dq(*args), *attn.flash_bwd_dkv(*args))
        # bf16: against P and dS kept f32 and against P and dS rounded to
        # bf16 as the kernels round them; the plain grads stay f32
        variants = ([(None, BWD_F32_TOL)] if dtype == "float32" else
                    [(None, BWD_BF16_TOL), (torch.bfloat16, BWD_BF16P_TOL)])
        line = []
        for p_dtype, tol in variants:
            ref = attn.flash_attention_backward_plain(
                q.float(), k.float(), v.float(), lse, do.float(), delta,
                scale, causal, p_dtype=p_dtype)
            torch.cuda.synchronize()
            for name, a, want in zip(("dq", "dk", "dv"), got, ref):
                check(a.dtype == q.dtype and a.shape == want.shape,
                      f"K2/K3 {name} {shape}: dtype/shape")
                err = (a.float() - want).abs().max().item()
                top = want.abs().max().item()
                check(bool(torch.isfinite(a).all()) and err <= tol * top,
                      f"K2/K3 {name} {shape} causal={causal} {dtype} (P, dS "
                      f"{p_dtype or 'f32'}): max abs err {err} > {tol} x max "
                      f"|grad| {top}")
                # a row's error: against the plain version that rounds as
                # the kernel does
                if p_dtype is not None or dtype == "float32":
                    errs[(shape, causal, dtype, name)] = err
                line.append(f"{name} err {err:.3e} vs P "
                            f"{'bf16' if p_dtype else 'f32'} (tol {tol} x "
                            f"max |grad| {top:.3e})")
        again = (attn.flash_bwd_dq(*args), *attn.flash_bwd_dkv(*args))
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K2/K3 {shape} causal={causal} {dtype}: two runs differ")
        line.append("a second run gives the same bits")
        print(f"  K2/K3 {list(shape)} causal={causal} {dtype}: "
              + "; ".join(line))

    # timing at the training shape, f32 causal: K2 and K3, with SDPA's
    # backward around them
    q, k, v, do, lse, delta, scale = bwd_case(torch, attn, train_shape, True,
                                              "float32", g)
    args = (q, k, v, lse, do, delta, scale, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)

    def sdpa_bwd():
        return time_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True))

    libs = [sdpa_bwd()]
    dq_ms = time_ms(torch, lambda: attn.flash_bwd_dq(*args))
    dkv_ms = time_ms(torch, lambda: attn.flash_bwd_dkv(*args))
    libs.append(sdpa_bwd())
    lib_ms = float(np.median(libs))
    plain_ms = time_ms(torch, lambda: attn.flash_attention_backward_plain(
        *args))
    b, h, s, d = train_shape
    n = b * h * s
    pairs = b * h * s * (s + 1) // 2
    reads = 4 * n * d * 4 + 2 * n * 4          # q, k, v, dO; lse, delta
    k2_flops, k3_flops = 3 * 2 * d * pairs, 4 * 2 * d * pairs
    k2_b = bound(reads + n * d * 4, k2_flops, "float32")
    k3_b = bound(reads + 2 * n * d * 4, k3_flops, "float32")
    all_b = bound(reads + 3 * n * d * 4, 5 * 2 * d * pairs, "float32")
    rate = [f"{name} {ms:.4f} ms, {f / ms / 1e9:.1f} TFLOP/s, "
            f"{bd[0] / ms:.4f} of its bound {bd[0]:.4f} ms ({bd[1]})"
            for name, ms, f, bd in (("K2", dq_ms, k2_flops, k2_b),
                                    ("K3", dkv_ms, k3_flops, k3_b))]
    print(f"  {list(train_shape)} causal f32: " + "; ".join(rate)
          + f"; K2 + K3 {dq_ms + dkv_ms:.4f} ms against the backward's "
          f"bound {all_b[0]:.4f} ms ({all_b[1]}, 5 products over {pairs} "
          f"pairs); sdpa backward median {lib_ms:.4f} ms of "
          f"{[round(x, 4) for x in libs]} ({(dq_ms + dkv_ms) / lib_ms:.2f}x);"
          f" plain backward {plain_ms:.4f} ms")
    main = [(train_shape, True, "float32", nm) for nm in ("dq", "dk", "dv")]
    rows = []
    for name, src_line, ms, (b_ms, b_by), err in (
            ("flash_bwd_dq", ":200", dq_ms, k2_b, errs[main[0]]),
            ("flash_bwd_dkv", ":236", dkv_ms, k3_b,
             max(errs[main[1]], errs[main[2]]))):
        rows.append({"name": name, "route": "cuda", "dtype": "float32",
                     "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
                     "replaces": "paddle_tpu/ops/attention.py" + src_line,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})
    return rows + flash_bf16_rows(torch, attn, train_shape, errs, g)


def flash_bf16_rows(torch, attn, train_shape, errs, g):
    """K1, K2 and K3 in bf16 at the training shape, causal, as the
    flagship step (phase 10) runs them: time against the plain versions,
    the bf16 bound and PyTorch's SDPA forward / backward in bf16. SDPA's
    backward moved between 0.19 and 0.70 ms from one call to the next, so
    it is timed three times between the kernels: its median is the row's
    library time, and the spread is printed."""
    import torch.nn.functional as F
    q, k, v, do, lse, delta, scale = bwd_case(torch, attn, train_shape, True,
                                              "bfloat16", g)
    o, _ = attn.flash_attention_forward(q, k, v, scale, True)
    k1_err = 0.0
    for p_dtype, tol in ((None, BF16_TOL), (torch.bfloat16, BF16P_TOL)):
        ro, rlse = attn.flash_attention_plain(q, k, v, scale, True,
                                              p_dtype=p_dtype)
        eo = (o.float() - ro.float()).abs().max().item()
        el = (lse - rlse).abs().max().item()
        check(eo <= tol and el <= FLASH_LSE_TOL,
              f"K1 {train_shape} bf16 (P {p_dtype or 'f32'}): O err {eo}, "
              f"LSE err {el}")
        if p_dtype is not None:
            k1_err = max(eo, el)
        del ro, rlse
    del o
    args = (q, k, v, lse, do, delta, scale, True)
    k1_ms = time_ms(torch, lambda: attn.flash_attention_forward(
        q, k, v, scale, True))
    k1_plain = time_ms(torch, lambda: attn.flash_attention_plain(
        q, k, v, scale, True))
    k1_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)

    def sdpa_bwd():
        return time_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True))

    libs = [sdpa_bwd()]
    dq_ms = time_ms(torch, lambda: attn.flash_bwd_dq(*args))
    libs.append(sdpa_bwd())
    dkv_ms = time_ms(torch, lambda: attn.flash_bwd_dkv(*args))
    libs.append(sdpa_bwd())
    lib_ms = float(np.median(libs))
    plain_ms = time_ms(torch, lambda: attn.flash_attention_backward_plain(
        *args))
    b, h, s, d = train_shape
    n = b * h * s
    pairs = b * h * s * (s + 1) // 2
    k1_flops = 2 * 2 * d * pairs
    k1_b = bound(4 * n * d * 2 + n * 4, k1_flops, "bfloat16")
    reads = 4 * n * d * 2 + 2 * n * 4
    k2_flops, k3_flops = 3 * 2 * d * pairs, 4 * 2 * d * pairs
    k2_b = bound(reads + n * d * 2, k2_flops, "bfloat16")
    k3_b = bound(reads + 2 * n * d * 2, k3_flops, "bfloat16")
    print(f"  {list(train_shape)} causal bf16 (the flagship's): K1 "
          f"{k1_ms:.4f} ms, {k1_flops / k1_ms / 1e9:.1f} TFLOP/s, "
          f"{k1_b[0] / k1_ms:.4f} of its bound {k1_b[0]:.4f} ms ({k1_b[1]}); "
          f"sdpa {k1_lib:.4f} ms ({k1_ms / k1_lib:.2f}x); err vs P bf16 "
          f"{k1_err:.3e}; plain {k1_plain:.4f} ms")
    rate = [f"{name} {ms:.4f} ms, {f / ms / 1e9:.1f} TFLOP/s, "
            f"{bd[0] / ms:.4f} of its bound {bd[0]:.4f} ms ({bd[1]})"
            for name, ms, f, bd in (("K2", dq_ms, k2_flops, k2_b),
                                    ("K3", dkv_ms, k3_flops, k3_b))]
    print(f"  {list(train_shape)} causal bf16: " + "; ".join(rate)
          + f"; K2 + K3 {dq_ms + dkv_ms:.4f} ms, sdpa backward median "
          f"{lib_ms:.4f} ms of {[round(x, 4) for x in libs]} "
          f"({(dq_ms + dkv_ms) / lib_ms:.2f}x), plain backward "
          f"{plain_ms:.4f} ms")
    main = [(train_shape, True, "bfloat16", nm) for nm in ("dq", "dk", "dv")]
    rows = []
    for name, src, line, ms, pl, lib, (b_ms, b_by), err in (
            ("flash_attention_forward", "flash_fwd.cu", ":67", k1_ms,
             k1_plain, k1_lib, k1_b, k1_err),
            ("flash_bwd_dq", "flash_bwd.cu", ":200", dq_ms, plain_ms, lib_ms,
             k2_b, errs[main[0]]),
            ("flash_bwd_dkv", "flash_bwd.cu", ":236", dkv_ms, plain_ms,
             lib_ms, k3_b, max(errs[main[1]], errs[main[2]]))):
        rows.append({"name": name, "route": "cuda", "dtype": "bfloat16",
                     "source": "paddle_tpu_torch/csrc/" + src,
                     "replaces": "paddle_tpu/ops/attention.py" + line,
                     "max_abs_err": err, "ms": ms, "plain_ms": pl,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
    return rows


# ------------------------------------------------------------ phases 7-8

def train_run(torch, cfg, optimizer, nn, clip):
    """TRAIN_STEPS f32 steps of ``GPTForCausalLM(cfg)`` from the same seeded
    weights, AdamW(1e-4, weight_decay 0.01), with ClipGradByGlobalNorm(1.0)
    when ``clip``: (losses, step ms, peak bytes, tokens a step)."""
    from paddle_tpu_torch.text.models import GPTForCausalLM
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).train()
    opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                          weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0) if clip
                          else None)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, cfg.max_seq_len)).astype(np.int64)).cuda()
    labels = ids.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    del model, opt, loss
    return losses, times, peak, ids.numel()


def train_checked(torch, wrappers, want, cfg, optimizer, nn, clip):
    """One train_run with every wrapper's count set to 0 just before it
    and read just after: the loss finite and falling, the launches
    ``want``. Prints and returns (losses, step ms, peak bytes, tokens)."""
    for fn in wrappers:
        fn.launches = 0
    losses, times, peak, tokens = train_run(torch, cfg, optimizer, nn, clip)
    counts = tuple(fn.launches for fn in wrappers)
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(counts == want, f"launches {counts} != {want}")
    step_ms = float(np.median(times[1:]))
    print(f"  losses {[round(x, 6) for x in losses]}; step ms "
          f"{[round(t, 2) for t in times]}")
    print(f"  median step (steps 2-{TRAIN_STEPS}) {step_ms:.2f} ms, "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; launches "
          + ", ".join(f"{fn.__name__} {n}" for fn, n in zip(wrappers,
                                                            counts)))
    return losses, times, peak, tokens


def phase_train(torch, attn, cfg, optimizer, nn):
    L = cfg.num_layers
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)
    train_checked(torch, wrappers, (TRAIN_STEPS * L,) * 3, cfg, optimizer,
                  nn, True)
    return tuple(fn.launches for fn in wrappers)


def phase_tied_f32(torch, attn, tce, cfg, optimizer, nn, _build, parent):
    """The flagship's step in f32 (phase 10 without auto_cast): the tied
    head through the f32 K5-K7 once a step. Where the parent's K5 was
    built, the same steps with it, in turns (this tree, the parent, the
    parent, this tree): the host's speed drifts within a call. Its sums
    run in another order, so every step's loss is held within LOSS_RTOL
    of the parent's, and the peak memory to the parent's + 64 MiB."""
    L = cfg.num_layers
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    first = train_checked(torch, wrappers,
                          (TRAIN_STEPS * L,) * 3 + (TRAIN_STEPS,) * 3, cfg,
                          optimizer, nn, False)
    counts = tuple(fn.launches for fn in wrappers)
    losses, tokens = first[0], first[3]
    if not parent:
        return counts, first
    runs = {"this tree": [first[:3]], "the parent": []}
    for side in ("the parent", "the parent", "this tree"):
        with (parent_kernels(torch, _build, tce, parent)
              if side == "the parent" else contextlib.nullcontext()):
            runs[side].append(train_run(torch, cfg, optimizer, nn,
                                        False)[:3])
    (p_losses, _, _), _ = runs["the parent"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, p_losses)]
    med = {}
    for side, rs in runs.items():
        med[side] = float(np.median([t for _, ts, _ in rs for t in ts[1:]]))
        print(f"  {side}'s K5: step ms "
              + ", ".join(f"{[round(t, 2) for t in ts]}" for _, ts, _ in rs)
              + f"; median of steps 2-{TRAIN_STEPS} of both runs "
              f"{med[side]:.2f} ms, {tokens / med[side] * 1e3:.1f} "
              f"tokens/s; peak memory "
              + ", ".join(f"{pk / 2**30:.3f}" for _, _, pk in rs)
              + " GiB; the two runs' losses "
              + ("the same" if rs[0][0] == rs[1][0] else "differ"))
    print(f"  the parent's ({PARENT}) losses "
          f"{[round(x, 6) for x in p_losses]}; "
          f"relative differences {[float(f'{r:.3e}') for r in rel]}; "
          f"this tree's median step "
          f"{med['the parent'] - med['this tree']:.2f} ms shorter")
    check(max(rel) <= LOSS_RTOL, f"losses {losses} vs the parent's "
          f"{p_losses}")
    peaks = {side: max(pk for _, _, pk in rs) for side, rs in runs.items()}
    check(peaks["this tree"] <= peaks["the parent"] + (64 << 20),
          f"peak memory {peaks}")
    return counts, first


def phase_card_vs_cpu(torch, optimizer, nn, TransformerLMConfig, tie):
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(num_layers=2, tie_embeddings=tie,
                              dropout=0.0)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 256))
    runs = []
    for device in ("cpu", None):
        model = GPTForCausalLM(cfg, device=device,
                               generator=torch.Generator().manual_seed(7))
        opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                              weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        t = torch.from_numpy(ids.astype(np.int64)).to(model.device)
        losses, grads = [], None
        for step in range(3):
            loss = model(t, labels=t)
            loss.backward()
            if step == 0:
                grads = {n: p.grad.detach().float().cpu()
                         for n, p in model.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        runs.append((losses, grads))
    (cl, cg), (gl, gg) = runs
    rel = [abs(a - b) / abs(b) for a, b in zip(gl, cl)]
    check(max(rel) <= LOSS_RTOL, f"card losses {gl} vs CPU {cl}")
    worst, worst_name = 0.0, ""
    for name, want in cg.items():
        err = (gg[name] - want).abs().max().item()
        top = want.abs().max().item()
        r = err / max(top, 1e-30)
        check(r <= GRAD_TOL, f"step-1 grad {name}: max abs err {err} > "
              f"{GRAD_TOL} x max |grad| {top}")
        if r > worst:
            worst, worst_name = r, name
    print(f"  {'tied' if tie else 'untied'}: losses card {gl} vs CPU {cl}: "
          f"max rel diff {max(rel):.3e} "
          f"(tol {LOSS_RTOL}); step-1 grads of {len(cg)} parameters: "
          f"worst max|diff|/max|grad| {worst:.3e} at {worst_name} (tol "
          f"{GRAD_TOL})")


# ---------------------------------------------------------------- phase 9

def ce_case(torch, t, h, v, dtype, g):
    """x [t, h] ~ N(0, 1) (a LayerNorm output), W [v, h] ~ N(0, 0.02) (the
    embedding's init), int64 labels with about 5 % ignore_index, and a
    per-token cotangent of 1 / n_valid (the model's mean), on the card."""
    dt = getattr(torch, dtype)
    x = torch.randn(t, h, generator=g, device="cuda").to(dt)
    w = (torch.randn(v, h, generator=g, device="cuda") * 0.02).to(dt)
    labels = torch.randint(0, v, (t,), generator=g, device="cuda")
    labels[torch.rand(t, generator=g, device="cuda") < 0.05] = -100
    n_valid = int((labels != -100).sum())
    gg = torch.full((t,), 1.0 / max(n_valid, 1), device="cuda")
    return x, w, labels, gg


def parent_sources(parent_tree):
    """{source name: text} of the parent commit's ``csrc/fused_ce.cu`` (its
    f32 K5 is the port's first one): from ``--parent TREE``, a checkout of
    it, else from git history; None where neither is at hand."""
    names = sorted({name for name, _ in PARENT_SYMBOLS})
    out = {}
    for name in names:
        rel = f"paddle_tpu_torch/csrc/{name}.cu"
        if parent_tree:
            with open(os.path.join(parent_tree, rel)) as f:
                out[name] = f.read()
            continue
        if not os.path.isdir(os.path.join(HERE, ".git")):
            return None
        r = subprocess.run(["git", "show", f"{PARENT}:{rel}"], cwd=HERE,
                           capture_output=True, text=True, timeout=60)
        if r.returncode != 0:
            return None
        out[name] = r.stdout
    return out


def start_parent_build(_build, texts):
    """Start one ``nvcc`` per parent source into ``_build/parent/``;
    {name: (process, library path)}, or None without sources."""
    if texts is None:
        return None
    d = _build.BUILD_DIR / "parent"
    d.mkdir(parents=True, exist_ok=True)
    started = {}
    for name, text in texts.items():
        (d / f"{name}.cu").write_text(text)
        so = d / f"{name}.so"
        started[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(d / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    return started


def load_parent(started):
    """{(source, symbol): ctypes function} of the parent's K5, or None."""
    if started is None:
        return None
    libs = {}
    for name, (proc, so) in started.items():
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"the parent's {name}.cu did not build:"
              f"\n{out}")
        libs[name] = ctypes.CDLL(str(so))
    fns = {}
    for (name, sym), argtypes in PARENT_SYMBOLS.items():
        fn = getattr(libs[name], sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[(name, sym)] = fn
    return fns


@contextlib.contextmanager
def parent_kernels(torch, _build, tce, parent):
    """Inside this block the wrappers launch the parent's kernels of
    ``parent`` ({(source, symbol): ctypes function}, of this tree's C
    signatures): the functions they look up in ``_build`` are swapped,
    and so is the f32 K5's vocab split, which the parent's kernel counts
    in its own tiles; both are put back after."""
    saved = {key: _build._fns.get(key) for key in parent}
    split = tce._FWD_SPLIT[torch.float32]
    _build._fns.update(parent)
    tce._FWD_SPLIT[torch.float32] = PARENT_F32_SPLIT
    try:
        yield
    finally:
        tce._FWD_SPLIT[torch.float32] = split
        for key, fn in saved.items():
            if fn is None:
                del _build._fns[key]
            else:
                _build._fns[key] = fn


def phase_k5k7(torch, tce, t, h, v, _build, parent):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [(t, h, v, "float32"), (t, h, v, "bfloat16"),
             (333, 768, 50304, "float32"), (333, 768, 50304, "bfloat16"),
             (1000, 200, 1234, "float32"), (1000, 200, 1234, "bfloat16"),
             (77, 800, 5000, "float32"), (77, 800, 5000, "bfloat16"),
             (33, 1536, 1234, "float32"), (1, 64, 7, "float32"),
             (1, 64, 7, "bfloat16"), (65, 13, 300, "float32"),
             (65, 13, 300, "bfloat16")]
    errs = {}
    for ct, ch, cv, dtype in cases:
        x, w, labels, gg = ce_case(torch, ct, ch, cv, dtype, g)
        loss, lse = tce.fused_ce_forward(x, w, labels)
        dx = tce.fused_ce_bwd_dx(x, w, labels, lse, gg)
        dw = tce.fused_ce_bwd_dw(x, w, labels, lse, gg)
        rloss, rlse = tce.fused_linear_cross_entropy_plain(
            x.float(), w.float(), labels)
        torch.cuda.synchronize()
        el = max((loss - rloss).abs().max().item(),
                 (lse - rlse).abs().max().item())
        check(el <= CE_LOSS_TOL, f"K5 [{ct},{ch},{cv}] {dtype}: loss/LSE err "
              f"{el} > {CE_LOSS_TOL}")
        errs[(ct, ch, cv, dtype, "loss")] = el
        line = [f"loss/LSE err {el:.3e}"]
        # bf16: against d kept f32 and against d rounded as the kernel does
        variants = ([(None, CE_F32_TOL)] if dtype == "float32" else
                    [(None, CE_BF16_TOL), (torch.bfloat16, CE_BF16D_TOL)])
        for d_dtype, tol in variants:
            ref = tce.fused_linear_cross_entropy_backward_plain(
                x.float(), w.float(), labels, lse, gg, d_dtype=d_dtype)
            for name, got, want in zip(("dx", "dW"), (dx, dw), ref):
                check(got.dtype == x.dtype and got.shape == want.shape,
                      f"K6/K7 {name}: dtype/shape")
                err = (got.float() - want).abs().max().item()
                top = want.abs().max().item()
                check(bool(torch.isfinite(got).all()) and err <= tol * top,
                      f"K6/K7 {name} [{ct},{ch},{cv}] {dtype} (d "
                      f"{d_dtype or 'f32'}): err {err} > {tol} x max |grad| "
                      f"{top}")
                line.append(f"{name} err {err:.3e} vs d "
                            f"{'bf16' if d_dtype else 'f32'} (tol {tol}, max "
                            f"|grad| {top:.3e})")
                errs[(ct, ch, cv, dtype, name)] = err
            del ref
        again = (*tce.fused_ce_forward(x, w, labels),
                 tce.fused_ce_bwd_dx(x, w, labels, lse, gg),
                 tce.fused_ce_bwd_dw(x, w, labels, lse, gg))
        check(all(torch.equal(a, b)
                  for a, b in zip(again, (loss, lse, dx, dw))),
              f"K5-K7 [{ct},{ch},{cv}] {dtype}: two runs differ")
        line.append("a second run gives the same bits")
        if parent and dtype == "float32":
            # the parent's K5 sums in another order: within CE_LOSS_TOL
            with parent_kernels(torch, _build, tce, parent):
                theirs = tce.fused_ce_forward(x, w, labels)
            e2 = max((a - b).abs().max().item()
                     for a, b in zip((loss, lse), theirs))
            check(e2 <= CE_LOSS_TOL, f"K5 [{ct},{ch},{cv}] f32: loss/LSE "
                  f"{e2} from the parent's")
            line.append(f"loss/LSE within {e2:.3e} of the parent's")
        print(f"  K5-K7 [T={ct}, H={ch}, V={cv}] {dtype}: " + "; ".join(line))

    # times at the flagship shape, in both dtypes: the f32 K5-K7 run on
    # phase 11's path, the bf16 ones on phase 10's. The f32 K5 is timed in
    # turns with the parent's (this tree, the parent, the parent, this
    # tree) where it was built
    flops = 2.0 * t * v * h
    rows = []
    for dtype in ("float32", "bfloat16"):
        x, w, labels, gg = ce_case(torch, t, h, v, dtype, g)
        loss, lse = tce.fused_ce_forward(x, w, labels)
        n6 = 30 if dtype == "bfloat16" else 5
        n5 = 30 if dtype == "bfloat16" else 10
        turns = {"this tree": [], "the parent": []}
        for side in (("this tree", "the parent", "the parent", "this tree")
                     if parent and dtype == "float32" else ("this tree",)):
            with (parent_kernels(torch, _build, tce, parent)
                  if side == "the parent" else contextlib.nullcontext()):
                turns[side].append(time_ms(
                    torch, lambda: tce.fused_ce_forward(x, w, labels),
                    iters=n5, warmup=3 if dtype == "bfloat16" else 1))
        k5 = float(np.median(turns["this tree"]))
        k6 = time_ms(torch, lambda: tce.fused_ce_bwd_dx(x, w, labels, lse,
                                                        gg),
                     iters=n6, warmup=3)
        k7 = time_ms(torch, lambda: tce.fused_ce_bwd_dw(x, w, labels, lse,
                                                        gg),
                     iters=n6, warmup=3)
        pf = time_ms(torch, lambda: tce.fused_linear_cross_entropy_plain(
            x, w, labels), iters=5, warmup=1)
        pb = time_ms(torch, lambda: tce.fused_linear_cross_entropy_backward_plain(
            x, w, labels, lse, gg), iters=5, warmup=1)
        leaves = [a.clone().requires_grad_() for a in (x, w)]

        def comp():
            return F.cross_entropy(F.linear(leaves[0], leaves[1]), labels,
                                   ignore_index=-100, reduction="none")
        cf = time_ms(torch, comp, iters=5, warmup=1)
        closs = comp()
        cb = time_ms(torch, lambda: torch.autograd.grad(
            closs, leaves, gg.to(closs.dtype), retain_graph=True),
            iters=5, warmup=1)
        del closs, leaves
        esz = x.element_size()
        ins = (t * h + v * h) * esz + t * 8
        b5 = bound(ins + 2 * t * 4, flops, dtype)
        b6 = bound(ins + 2 * t * 4 + t * h * esz, 2 * flops, dtype)
        b7 = bound(ins + 2 * t * 4 + v * h * esz, 2 * flops, dtype)
        rate = [f"{name} {ms:.3f} ms, {f / ms / 1e9:.1f} TFLOP/s, "
                f"{b[0] / ms:.4f} of its bound {b[0]:.4f} ms ({b[1]})"
                for name, ms, f, b in (("K5", k5, flops, b5),
                                       ("K6", k6, 2 * flops, b6),
                                       ("K7", k7, 2 * flops, b7))]
        print(f"  [T={t}, H={h}, V={v}] {dtype}: " + "; ".join(rate))
        print(f"  [T={t}, H={h}, V={v}] {dtype}: plain forward {pf:.3f} ms, "
              f"plain backward {pb:.3f} ms; composition yardstick "
              f"F.cross_entropy(F.linear) forward {cf:.3f} ms, backward (dx "
              f"and dW) {cb:.3f} ms")
        mine, theirs = turns["this tree"], turns["the parent"]
        if theirs:
            p_ms = float(np.median(theirs))
            print(f"  K5 {dtype} in turns: this tree "
                  f"{[round(m, 3) for m in mine]} ms ({b5[0] / k5:.4f} of "
                  f"its bound {b5[0]:.4f} ms), the parent's ({PARENT}) "
                  f"{[round(m, 3) for m in theirs]} ms "
                  f"({flops / p_ms / 1e9:.1f} TFLOP/s, {b5[0] / p_ms:.4f} "
                  f"of the bound): {p_ms / k5:.2f}x faster; the composition's "
                  f"forward {cf:.3f} ms")
            check(max(mine) < min(theirs), f"K5 {dtype}: this tree's "
                  f"{mine} ms not below the parent's {theirs}")
        # library_ms: the two-call composition F.cross_entropy(F.linear)
        for name, line, ms, plain_ms, lib_ms, (b_ms, b_by), key in (
                ("fused_ce_forward", ":93", k5, pf, cf, b5, "loss"),
                ("fused_ce_bwd_dx", ":183", k6, pb, cb, b6, "dx"),
                ("fused_ce_bwd_dw", ":198", k7, pb, cb, b7, "dW")):
            rows.append({"name": name, "route": "cuda", "dtype": dtype,
                         "source": "paddle_tpu_torch/csrc/fused_ce.cu",
                         "replaces": "paddle_tpu/ops/fused_ce.py" + line,
                         "max_abs_err": errs[(t, h, v, dtype, key)],
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms})
        del x, w, labels, gg, loss, lse
    return rows


# --------------------------------------------------------------- phase 10

def phase_flagship(torch, attn, tce, amp, optimizer, TransformerLMConfig,
                   recompute=False, steps=TRAIN_STEPS):
    """The reference's bench_gpt step (tools/baseline_bench.py:163-197),
    ``steps`` times from seeded weights, with per-block recompute when
    ``recompute`` (each block's K1 again in the backward). Returns the
    launches, the losses, the step ms and the peak bytes."""
    from paddle_tpu_torch.text.models import GPTForCausalLM
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    cfg = TransformerLMConfig(dropout=0.0, use_flash_attention=True,
                              max_seq_len=FLAGSHIP["seq"],
                              recompute=recompute)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).train()
    opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                          weight_decay=0.01)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (FLAGSHIP["batch"], FLAGSHIP["seq"])).astype(
            np.int64)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers:
        fn.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    counts = tuple(fn.launches for fn in wrappers)
    peak = torch.cuda.max_memory_allocated()
    check(loss.dtype == torch.float32, f"O1 loss dtype {loss.dtype}")
    del model, opt, loss
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = ((steps * L * (2 if recompute else 1),) + (steps * L,) * 2
            + (steps,) * 3)
    check(counts == want, f"K1/K2/K3/K5/K6/K7 launches {counts} != {want}")
    step_ms = float(np.median(times[1:]))
    tokens = ids.numel()
    print(f"  losses {[round(x, 6) for x in losses]}; step ms "
          f"{[round(t, 2) for t in times]}")
    print(f"  median step (steps 2-{steps}) {step_ms:.2f} ms, "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; K1/K2/K3 launches {counts[:3]}, K5/K6/K7 "
          f"{counts[3:]} ({steps} steps x {L} layers"
          + (", K1 twice a block" if recompute else "") + ")")
    return counts, losses, times, peak


# --------------------------------------------------------------- phase 12

def optim_cases(optimizer, nn, regularizer):
    """(label, linear in the grad?, make(named parameters)) of phase 12,
    each at a learning rate that moves the 2-layer model in 3 steps."""
    O = optimizer
    return [
        ("SGD", True, lambda ps: O.SGD(0.1, parameters=ps)),
        ("Momentum(use_nesterov)", True, lambda ps: O.Momentum(
            0.05, parameters=ps, use_nesterov=True, weight_decay=0.01)),
        ("Adamax", False, lambda ps: O.Adamax(1e-3, parameters=ps)),
        ("Adagrad", False, lambda ps: O.Adagrad(1e-2, parameters=ps)),
        ("RMSProp(centered, momentum)", True, lambda ps: O.RMSProp(
            1e-4, parameters=ps, centered=True, momentum=0.9)),
        ("Lamb", False, lambda ps: O.Lamb(
            1e-3, parameters=ps,
            exclude_from_weight_decay_fn=lambda p: p.dim() == 1)),
        ("LarsMomentum", True, lambda ps: O.LarsMomentum(
            0.1, parameters=ps, exclude_from_weight_decay=["bias"])),
        ("Adadelta", True, lambda ps: O.Adadelta(1.0, parameters=ps)),
        ("Ftrl", False, lambda ps: O.Ftrl(1e-3, parameters=ps)),
        ("Adam(L1Decay, ClipGradByValue)", False, lambda ps: O.Adam(
            1e-4, parameters=ps, weight_decay=regularizer.L1Decay(1e-4),
            grad_clip=nn.ClipGradByValue(1e-3))),
        ("AdamW(param groups)", False, lambda ps: O.AdamW(
            1e-4, weight_decay=0.01,
            parameters=[{"params": ps[:8]}, {"params": ps[8:]}])),
    ]


def optim_run(model, init, make, ids, steps=OPTIM_STEPS):
    """``steps`` steps from the weights ``init``: (losses, the parameters
    on the CPU)."""
    model.load_state_dict(init)
    opt = make(list(model.named_parameters()))
    losses = []
    for _ in range(steps):
        loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, {n: p.detach().cpu().clone()
                    for n, p in model.named_parameters()}


def moves_apart(torch, card, cpu, init, hidden):
    """Every element of the card's parameters within twice the largest
    move of the CPU's; returns the worst ratio of ||card - cpu|| to
    ||cpu - init|| over the parameters (the key third of each QKV bias
    left out of the norm), its parameter and the largest move."""
    scale = max((cpu[n] - init[n]).abs().max().item() for n in cpu)
    worst, where = 0.0, ""
    for n in cpu:
        a, b, a0 = card[n], cpu[n], init[n]
        el = (a - b).abs().max().item()
        check(el <= 2 * scale, f"{n}: an element {el} apart, past twice the "
              f"largest move {scale}")
        if n.endswith("attn.qkv.bias"):
            keep = torch.ones(a.numel(), dtype=torch.bool)
            keep[hidden:2 * hidden] = False
            a, b, a0 = a[keep], b[keep], a0[keep]
        move = (b - a0).norm().item()
        diff = (a - b).norm().item()
        r = diff / move if move else (float("inf") if diff else 0.0)
        if r >= worst:
            worst, where = r, n
    return worst, where, scale


def phase_optim(torch, wrappers, optimizer, nn, regularizer,
                TransformerLMConfig):
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(num_layers=2, dropout=0.0)
    L = cfg.num_layers
    ids_np = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 256))
    models = {dev: GPTForCausalLM(cfg, device=dev, generator=torch.Generator()
                                  .manual_seed(7)).train()
              for dev in ("cpu", None)}
    init = {k: v.clone() for k, v in models["cpu"].state_dict().items()}
    ids = {dev: torch.from_numpy(ids_np.astype(np.int64)).to(m.device)
           for dev, m in models.items()}
    for fn in wrappers:
        fn.launches = 0
    cases = optim_cases(optimizer, nn, regularizer)
    for label, linear, make in cases:
        (cl, cp), (gl, gp) = (optim_run(models[d], init, make, ids[d])
                              for d in ("cpu", None))
        rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
        check(all(np.isfinite(gl)) and rel <= LOSS_RTOL,
              f"{label}: card losses {gl} vs CPU {cl}")
        tol = OPT_LINEAR_TOL if linear else OPT_SIGN_TOL
        worst, where, scale = moves_apart(torch, gp, cp, init,
                                          cfg.hidden_size)
        check(worst <= tol, f"{label}: the card's move of {where} is "
              f"{worst:.3e} of the CPU's apart (tol {tol})")
        print(f"  {label}: losses card {[round(x, 6) for x in gl]}, max rel "
              f"diff {rel:.3e} (tol {LOSS_RTOL}); parameters moved up to "
              f"{scale:.3e}, card vs CPU at most {worst:.3e} of a tensor's "
              f"move ({where}; tol {tol})")

    # on the card: 4 straight steps against 2, a save, a fresh model and
    # optimizer loaded, 2 more
    card_ids = ids[None]

    def adamw(params):
        sched = optimizer.lr.CosineAnnealingDecay(1e-4, 4)
        return optimizer.AdamW(sched, parameters=params, weight_decay=0.01,
                               grad_clip=nn.ClipGradByGlobalNorm(1.0)), sched

    def steps(model, opt, sched, n):
        out = []
        for _ in range(n):
            loss = model(card_ids, labels=card_ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            out.append(loss.item())
        return out

    card = models[None]
    card.load_state_dict(init)
    opt, sched = adamw(list(card.named_parameters()))
    straight = steps(card, opt, sched, 4)
    want = {n: p.detach().clone() for n, p in card.named_parameters()}
    card.load_state_dict(init)
    opt, sched = adamw(list(card.named_parameters()))
    first = steps(card, opt, sched, 2)
    saved_opt = opt.state_dict()
    saved = {k: v.clone() for k, v in card.state_dict().items()}
    fresh = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        99)).train()
    fresh.load_state_dict(saved)
    opt2, sched2 = adamw(list(fresh.named_parameters()))
    opt2.set_state_dict(saved_opt)
    resumed = first + steps(fresh, opt2, sched2, 2)
    differ = [n for n, p in fresh.named_parameters()
              if not torch.equal(p, want[n])]
    check(resumed == straight and not differ,
          f"resumed AdamW: losses {resumed} vs {straight}; parameters that "
          f"differ: {differ}")
    counts = tuple(fn.launches for fn in wrappers)
    n = OPTIM_STEPS * len(cases) + 4 + 2 + 2
    want_counts = (n * L,) * 3 + (n,) * 3
    check(counts == want_counts, f"phase 12 launches {counts} != "
          f"{want_counts}")
    print(f"  AdamW on the card: 2 steps, state_dict ({len(saved_opt) - 1} "
          f"tensors), a fresh model and optimizer loaded, 2 more steps: "
          f"the losses {resumed} and every parameter the bits of 4 straight "
          f"steps; launches K1/K2/K3 {counts[:3]}, K5/K6/K7 {counts[3:]} ({n}"
          f" steps x {L} layers)")
    del models, card, fresh, opt, opt2
    return counts


# --------------------------------------------------------------- phase 13

def phase_recompute(torch, wrappers, cfg, optimizer, nn, f32_run, amp, attn,
                    tce, TransformerLMConfig, flagship_losses):
    """Phase 11's step with recompute against phase 11's run ``f32_run``
    (losses, step ms, peak bytes, tokens), then 2 steps of phase 10's
    with recompute against ``flagship_losses``."""
    L = cfg.num_layers
    want = (2 * TRAIN_STEPS * L,) + (TRAIN_STEPS * L,) * 2 + (TRAIN_STEPS,) * 3
    losses, times, peak, tokens = train_checked(
        torch, wrappers, want, cfg, optimizer, nn, False)
    counts = tuple(fn.launches for fn in wrappers)
    ref_losses, ref_times, ref_peak, _ = f32_run
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    check(max(rel) <= RECOMPUTE_F32_RTOL, f"recompute losses {losses} vs "
          f"phase 11's {ref_losses}")
    check(peak < ref_peak, f"recompute peak {peak} not below phase 11's "
          f"{ref_peak}")
    ms, ref_ms = (float(np.median(t[1:])) for t in (times, ref_times))
    print(f"  against phase 11 (no recompute): losses within "
          f"{max(rel):.3e} relative (tol {RECOMPUTE_F32_RTOL}); peak "
          f"{peak / 2**30:.3f} GiB against {ref_peak / 2**30:.3f}; median "
          f"step {ms:.2f} ms against {ref_ms:.2f} ({ms / ref_ms:.3f}x)")
    bf_counts, bf_losses, _, _ = phase_flagship(
        torch, attn, tce, amp, optimizer, TransformerLMConfig,
        recompute=True, steps=2)
    rel = [abs(a - b) / abs(b) for a, b in zip(bf_losses, flagship_losses)]
    check(max(rel) <= RECOMPUTE_BF16_RTOL, f"O1 recompute losses {bf_losses}"
          f" vs phase 10's {flagship_losses[:2]}")
    print(f"  O1 bf16 with recompute: losses {bf_losses} within {max(rel):.3e}"
          f" relative of phase 10's first two (tol {RECOMPUTE_BF16_RTOL})")
    return counts, bf_counts


# --------------------------------------------------------------- phase 14

def first_divergence(a, b):
    """The first index where the token lists differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def phase_generate(torch, pa, attn, TransformerLMConfig):
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(dropout=0.0)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    s0, n_new, b = 128, 96, 4
    prompts = np.random.RandomState(14).randint(0, cfg.vocab_size, (b, s0))
    ids = torch.from_numpy(prompts.astype(np.int64)).cuda()
    model.generate(ids[:, :16], max_new_tokens=4, temperature=0.0)  # warm-up
    torch.cuda.synchronize()
    pa.paged_decode_attention.launches = 0
    attn.flash_attention_forward.launches = 0
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=n_new, temperature=0.0)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    check(out.dtype == torch.int64 and out.shape == (b, s0 + n_new)
          and out.device == model.device and torch.equal(out[:, :s0], ids),
          f"generate: {out.dtype} {tuple(out.shape)} on {out.device}")
    gen = out[:, s0:].cpu().numpy()
    with torch.inference_mode():
        lg = model(out[:, :-1])[:, s0 - 1:].float()
    check(bool(torch.isfinite(lg).all()), "non-finite teacher-forced logits")
    top2 = lg.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    pred = lg.argmax(-1).cpu().numpy()
    bad = np.argwhere(pred != gen)
    for r, i in bad:
        check(margin[r, i] < TIE_MARGIN, f"generate row {r} token {i}: "
              f"{gen[r, i]} vs forward {pred[r, i]} at margin "
              f"{margin[r, i]:.3e}")

    eng = ServingEngine(model, num_slots=8, block_size=16, async_depth=1)
    reqs = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    steps = eng.metrics.decode_steps
    k4 = pa.paged_decode_attention.launches
    check(k4 == steps * L, f"K4 launches {k4} != decode steps {steps} x {L}")
    same = 0
    for r, req in enumerate(reqs):
        i = first_divergence(req.generated, gen[r].tolist())
        check(len(req.generated) == n_new, f"request {req.rid} incomplete")
        if i is None:
            same += 1
            continue
        check(margin[r, i] < TIE_MARGIN, f"engine row {r} token {i}: "
              f"{req.generated[i]} vs generate {gen[r, i]} at margin "
              f"{margin[r, i]:.3e}")

    kw = dict(max_new_tokens=n_new, temperature=0.8, top_k=40, seed=1)
    t0 = time.perf_counter()
    drawn = model.generate(ids, **kw)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    check(torch.equal(drawn, model.generate(ids, **kw)),
          "top-k sampling: seed 1 twice gives other tokens")
    with torch.inference_mode():
        lg = model(drawn[:, :-1])[:, s0 - 1:].float()
    kth = lg.topk(40, dim=-1).values[..., -1]
    got = lg.gather(-1, drawn[:, s0:, None])[..., 0]
    check(bool((got >= kth - TIE_MARGIN).all()),
          "top-k sampling: a token outside the teacher-forced top 40")
    k1 = attn.flash_attention_forward.launches
    check(k1 == 2 * L, f"K1 launches {k1} != 2 forwards x {L}")

    cfg2 = TransformerLMConfig(num_layers=2, dropout=0.0)
    p2 = np.random.RandomState(15).randint(0, cfg2.vocab_size, (2, 64))
    beams = []
    for device in ("cpu", None):
        m2 = GPTForCausalLM(cfg2, device=device, generator=torch.Generator()
                            .manual_seed(7)).eval()
        t = torch.from_numpy(p2.astype(np.int64)).to(m2.device)
        if device is None:
            m2.generate(t, max_new_tokens=2, num_beams=4)        # warm-up
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        beams.append(m2.generate(t, max_new_tokens=32, num_beams=4).cpu())
        if device is None:
            torch.cuda.synchronize()
        beam_s = time.perf_counter() - t0
    check(torch.equal(beams[0], beams[1]), f"beam search: card "
          f"{beams[1][:, 64:].tolist()} vs CPU {beams[0][:, 64:].tolist()}")
    print(f"  greedy: {b} x {n_new} tokens in {greedy_s:.3f} s, "
          f"{b * n_new / greedy_s:.1f} generated tokens/s; "
          f"{len(bad)} tokens differ from the teacher-forced argmax at "
          f"near-ties (< {TIE_MARGIN}); smallest top-2 margin "
          f"{margin.min():.3e}; {same}/{b} engine streams identical to "
          f"generate()'s ({b - same} diverging at a near-tie); K4 launches "
          f"{k4} = {steps} x {L}")
    print(f"  top-k 40 at T 0.8: seed 1 twice the same tokens, each within "
          f"the teacher-forced top 40; {b * n_new / sample_s:.1f} generated "
          f"tokens/s; K1 launches {k1} (the two teacher-forced forwards)")
    print(f"  beam search (4 beams, batch 2, 32 new) on the 2-layer model: "
          f"card = CPU token for token; {2 * 32 / beam_s:.1f} generated "
          f"tokens/s on the card")
    del model
    return k1, k4


# --------------------------------------------------------------- phase 15

# 15d's sampled requests: every other one of the 16, seeds 0-7
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)


def request_kwargs(n, sampled):
    """Per-request add_request keywords: greedy, or with ``sampled`` the
    odd requests sampled at SAMPLED with seeds 0, 1, ..."""
    if not sampled:
        return [{} for _ in range(n)]
    return [dict(SAMPLED, seed=i // 2) if i % 2 else {} for i in range(n)]


def drive(eng, prompts, max_new, kws):
    """Phase 4's arrivals: eight requests, 24 steps, the other eight;
    returns the requests and the wall seconds (ending in a sync)."""
    import torch
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=n, **kw)
            for p, n, kw in zip(prompts[:8], max_new[:8], kws[:8])]
    for _ in range(24):
        eng.step()
    reqs += [eng.add_request(p, max_new_tokens=n, **kw)
             for p, n, kw in zip(prompts[8:], max_new[8:], kws[8:])]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, n in zip(reqs, max_new):
        check(r.done and len(r.generated) == n,
              f"request {r.rid} incomplete: {len(r.generated)}/{n}")
    return reqs, wall


def same_stream(torch, model, prompt, got, want, kw):
    """Phase 5's rule: token for token, except that the streams may part
    at a token whose top-2 margin in the port's forward (over the prompt
    and the tokens both streams share) is below TIE_MARGIN; for a sampled
    request the margin is taken on the logits the sampling head draws
    from (scaled, masked, Gumbel noise added). Returns None when equal,
    else the margin where they part."""
    from paddle_tpu_torch.serving.sched.sampling import (gumbel_noise,
                                                         masked_logits)
    i = first_divergence(got, want)
    if i is None:
        check(len(got) == len(want), f"stream lengths {len(got)} vs "
              f"{len(want)}")
        return None
    ids = torch.from_numpy(np.concatenate(
        [prompt, np.asarray(want[:i], np.int64)])).to(model.device)[None]
    with torch.inference_mode():
        lg = model(ids)[0, -1:].float()
        if kw:
            dev = lg.device
            lg = masked_logits(
                lg, torch.tensor([kw["temperature"]], device=dev),
                torch.tensor([kw["top_k"]], device=dev),
                torch.tensor([kw["top_p"]], device=dev)) + gumbel_noise(
                torch.tensor([kw["seed"]], device=dev),
                torch.tensor([len(prompt) - 1 + i], device=dev),
                lg.shape[-1])
    top2 = lg[0].topk(2).values
    margin = float(top2[0] - top2[1])
    check(margin < TIE_MARGIN, f"streams part at token {i}: {got[i]} vs "
          f"{want[i]} at margin {margin:.3e}")
    return margin


def compare(torch, model, prompts, reqs, want, kws, label):
    """Every stream of ``reqs`` against ``want`` (token lists) under the
    margin rule; prints and returns the number that parted at a tie."""
    ties = [m for p, r, w, kw in zip(prompts, reqs, want, kws)
            if (m := same_stream(torch, model, p, r.generated, w, kw))
            is not None]
    print(f"    {label}: {len(reqs) - len(ties)}/{len(reqs)} streams equal"
          + (f", {len(ties)} parting at a near-tie (margins "
             f"{', '.join(f'{m:.2e}' for m in ties)})" if ties else ""))
    return len(ties)


def serve_case(torch, model, prompts, max_new, pa, label, kws=None,
               **knobs):
    """One main-path run of phase 15 with the K4 count set to 0 just
    before and read just after: on the paged pool K4 = 12 x the plain
    decode steps (verify steps attend without it), on the slot pool 0."""
    from paddle_tpu_torch.serving import ServingEngine
    L = model.cfg.num_layers
    kws = kws or [{} for _ in prompts]
    eng = ServingEngine(model, num_slots=8, block_size=16, **knobs)
    pa.paged_decode_attention.launches = 0
    reqs, wall = drive(eng, prompts, max_new, kws)
    k4 = pa.paged_decode_attention.launches
    M = eng.metrics
    plain = M.decode_steps - M.spec_verify_steps
    if eng.paged:
        eng.pool.check_conservation()
        check(eng.pool.live_blocks == 0, f"{label}: blocks leaked")
        check(k4 == plain * L and k4 > 0, f"{label}: K4 launches {k4} != "
              f"{plain} plain decode steps x {L}")
    else:
        check(k4 == 0, f"{label}: K4 launched {k4} times on the slot pool")
    return reqs, eng, k4, M.tokens_per_sec(), wall


def phase_rest(torch, pa, TransformerLMConfig, prompts, max_new, ref, tps4):
    """Phase 15, the rest of the serving engine on phase 4's GPT-124M
    (same seed, weights and 16 requests; ``ref`` phase 4's paged greedy
    streams, ``tps4`` its tokens/s): 15a the slot pool at both pipeline
    depths; 15b chunked prefill on both pools; 15c speculative decoding
    on both pools; 15d per-slot sampling on both pools, twice, chunked,
    and card against CPU on phase 8's 2-layer model; 15e a prefill-role
    engine exporting each prompt's KV through JSON into a decode-role
    engine. Returns the K4 launches of its paged runs."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.kv_wire import KVWireError
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(dropout=0.0)
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    n = len(prompts)
    greedy = [{} for _ in range(n)]
    k4_total = 0

    def line(label, eng, tps, wall, k4, extra=""):
        print(f"  {label}: {eng.metrics.tokens_generated} tokens in "
              f"{wall:.3f} s, tokens/s {tps:.1f} (phase 4: {tps4:.1f}); "
              f"decode steps {eng.metrics.decode_steps}, K4 launches {k4}"
              + extra)

    print("  [15a] slot pool (paged=False, max_len=1024)")
    slot_ref = None
    for depth in (1, 0):
        reqs, eng, k4, tps, wall = serve_case(
            torch, model, prompts, max_new, pa, "15a", paged=False,
            max_len=1024, async_depth=depth)
        line(f"async_depth={depth}", eng, tps, wall, k4,
             f"; prefill groups {eng.metrics.prefill_group_hist}")
        compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4")
        if depth == 1:
            slot_ref = [r.generated for r in reqs]
    print("  [15b] chunked prefill (prefill_chunk=128, "
          "prefill_token_budget=256)")
    for paged, want in ((False, slot_ref), (True, ref)):
        reqs, eng, k4, tps, wall = serve_case(
            torch, model, prompts, max_new, pa, "15b", paged=paged,
            max_len=1024, prefill_chunk=128, prefill_token_budget=256)
        k4_total += k4
        sch = eng.metrics.snapshot()["scheduler"]
        line("paged" if paged else "slot pool", eng, tps, wall, k4,
             f"; chunk dispatches {sch['prefill_chunks']} for "
             f"{sch['chunked_requests']} chunked requests")
        # on the paged pool a cached prefix shortens the tail to chunk
        long = sum(len(p) > 128 for p in prompts)
        check(0 < sch["chunked_requests"] <= long and (
            paged or sch["chunked_requests"] == long),
            f"15b: chunked requests {sch['chunked_requests']} of {long}")
        compare(torch, model, prompts, reqs, want, greedy,
                "vs the same pool unchunked")
    print("  [15c] speculative decoding (spec_k=4)")
    for paged in (False, True):
        reqs, eng, k4, tps, wall = serve_case(
            torch, model, prompts, max_new, pa, "15c", paged=paged,
            max_len=1024, speculative=True, spec_k=4)
        k4_total += k4
        sp = eng.metrics.snapshot()["perf"]["spec"]
        line("paged" if paged else "slot pool", eng, tps, wall, k4,
             f" (12 x {sp['fallback_steps']} plain steps; "
             f"{sp['verify_steps']} verify steps); drafted "
             f"{sp['drafted_tokens']}, accepted {sp['accepted_tokens']}, "
             f"acceptance rate {sp['acceptance_rate']}, tokens a slot-leg "
             f"{sp['effective_tokens_per_dispatch']}")
        check(sp["verify_steps"] > 0, "15c: no verify step ran")
        compare(torch, model, prompts, reqs, ref, greedy, "vs plain greedy")
    print(f"  [15d] sampling: 8 greedy, 8 sampled at {SAMPLED}, seeds 0-7")
    kws = request_kwargs(n, True)
    sampled = [i for i in range(n) if kws[i]]
    first = {}
    for paged, chunk in ((False, None), (True, None), (True, 128)):
        runs = []
        for _ in range(1 if chunk else 2):
            reqs, eng, k4, tps, wall = serve_case(
                torch, model, prompts, max_new, pa, "15d", kws, paged=paged,
                max_len=1024, sampling=True, prefill_chunk=chunk)
            k4_total += k4
            runs.append(reqs)
            line(("paged" if paged else "slot pool")
                 + (f", chunk {chunk}" if chunk else f", run {len(runs)}"),
                 eng, tps, wall, k4)
        compare(torch, model, [prompts[i] for i in range(n) if i % 2 == 0],
                [runs[0][i] for i in range(n) if i % 2 == 0],
                [ref[i] for i in range(n) if i % 2 == 0], greedy,
                "greedy rows vs phase 4")
        if len(runs) == 2:
            check(all(runs[0][i].generated == runs[1][i].generated
                      for i in sampled), "15d: a second run with the same "
                  "seeds drew other tokens")
            print("    sampled rows: the second run drew the same tokens, "
                  "bit for bit")
        if first:
            compare(torch, model, [prompts[i] for i in sampled],
                    [runs[0][i] for i in sampled],
                    [first["slot"][i].generated for i in sampled],
                    [kws[i] for i in sampled],
                    "sampled rows vs the slot pool's")
        else:
            first["slot"] = runs[0]
    cfg2 = TransformerLMConfig(num_layers=2, dropout=0.0)
    outs = {}
    for device in ("cpu", None):
        m2 = GPTForCausalLM(cfg2, device=device, generator=torch.Generator()
                            .manual_seed(7)).eval()
        eng = ServingEngine(m2, num_slots=8, block_size=16, device=device,
                            sampling=True)
        reqs = [eng.add_request(p, max_new_tokens=k, **kw)
                for p, k, kw in zip(prompts, max_new, kws)]
        eng.run()
        outs[device] = (m2, reqs)
    compare(torch, outs[None][0], prompts, outs[None][1],
            [r.generated for r in outs["cpu"][1]], kws,
            "2-layer model, card vs CPU, all 16 rows")
    del outs
    print("  [15e] disaggregation: role=prefill -> JSON -> role=decode")
    pe = ServingEngine(model, num_slots=8, block_size=16, max_len=1024,
                       role="prefill")
    de = ServingEngine(model, num_slots=8, block_size=16, max_len=1024,
                       role="decode")
    de.warmup_kv_handoff()
    pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    held = [pe.add_request(p, max_new_tokens=1, hold_kv=True)
            for p in prompts]
    dreqs, handoff_s, corrupt = {}, [], None
    while len(dreqs) < n:
        pe.step()
        for i, r in enumerate(held):
            if not r.done or i in dreqs:
                continue
            t1 = time.perf_counter()
            payload = json.loads(json.dumps(pe.export_kv(r.rid)))
            while de.pool.free_count == 0:
                de.step()
            dreqs[i] = de.import_kv(payload, max_new[i])
            handoff_s.append(time.perf_counter() - t1)
            corrupt = corrupt or payload
        de.step()
    de.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4 = pa.paged_decode_attention.launches
    k4_total += k4
    check(k4 == de.metrics.decode_steps * cfg.num_layers and k4 > 0,
          f"15e: K4 launches {k4} != {de.metrics.decode_steps} x 12")
    reqs = [dreqs[i] for i in range(n)]
    for r, k in zip(reqs, max_new):
        check(r.done and len(r.generated) == k, f"15e: request {r.rid} "
              f"incomplete")
    for e in (pe, de):
        e.pool.check_conservation()
        check(e.pool.live_blocks == 0, "15e: blocks leaked")
    wire = pe.metrics.snapshot()["kv_wire"]
    ptoks = sum(len(p) for p in prompts)
    tps = de.metrics.tokens_per_sec()
    line("decode engine", de, tps, wall, k4,
         f"; {wire['exports']} handoffs, {wire['export_bytes']} wire bytes "
         f"= {wire['export_bytes'] / ptoks:.1f} a prompt token; handoff "
         f"(export, JSON both ways, import) {np.mean(handoff_s) * 1e3:.2f} "
         f"ms mean, {max(handoff_s) * 1e3:.2f} max")
    compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4")
    # one flipped byte: refused, the pool as it was
    frame = corrupt["frames"][0]
    raw = bytearray(base64.b64decode(frame["k"]))
    raw[len(raw) // 2] ^= 0x01
    frame["k"] = base64.b64encode(bytes(raw)).decode()
    before = (de.pool.free_count, de.pool.free_blocks, de.pool.stats())
    try:
        de.import_kv(corrupt, 4)
        check(False, "15e: a corrupted payload was imported")
    except KVWireError as e:
        print(f"    a payload with one flipped byte: KVWireError ({e})")
    check((de.pool.free_count, de.pool.free_blocks, de.pool.stats())
          == before, "15e: the refused import changed the pool")
    de.pool.check_conservation()
    del model, pe, de
    return k4_total


# --------------------------------------------------------------- phase 16

def fleet_engine(model, rid, **knobs):
    """One replica of phase 16: phase 4's engine on the card, with its
    own replica id."""
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, paged=True, num_slots=8, block_size=16,
                         replica_id=rid, **knobs)


def settle(gw, label):
    """Wait for a live gateway's engine to go idle, then audit its pool
    under the gateway's lock: conserved, every slot free, no block
    referenced. Returns its decode steps."""
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        with gw._lock:
            if not gw.engine.pending:
                break
        time.sleep(0.005)
    with gw._lock:
        eng = gw.engine
        check(not eng.pending, f"{label}: {gw.replica_id} still busy")
        eng.pool.check_conservation()
        check(eng.pool.free_count == eng.config.num_slots
              and eng.pool.live_blocks == 0,
              f"{label}: {gw.replica_id}'s pool not empty")
        return eng.metrics.decode_steps


def phase_fleet(torch, pa, attn, TransformerLMConfig, prompts, max_new,
                ref, tps4, wall4):
    """Phase 16, the hardened engine and the router on phase 4's
    GPT-124M (same seed, weights and 16 requests; ``ref`` phase 4's
    streams, ``tps4``/``wall4`` its tokens/s and wall): 16a the router
    over two in-process replicas; 16b a replica killed mid-stream; 16c
    one engine under the default chaos plan, twice; 16d a forced wedge
    and the supervisor's restart; 16e one replica over HTTP on
    127.0.0.1. Every stream is held to phase 5's rule against phase 4's;
    K4 = 12 x the decode steps of each run's engines, the counts set to
    0 just before and read just after. Returns (K4, K1) launches."""
    from paddle_tpu_torch.serving.resilience import FaultPlan
    from paddle_tpu_torch.serving.router import (
        ROUTER_STATE_KEYS, EngineGateway, HTTPTransport, InProcessTransport,
        Router, RouterConfig)
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(dropout=0.0)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    n = len(prompts)
    greedy = [{} for _ in range(n)]
    k4_total = k1_total = 0
    router_cfg = dict(max_retries=4, backoff_base_s=0.001,
                      backoff_max_s=0.01, refresh_s=0.05, affinity=False)

    class Done:
        """A finished routed request in the Request's shape compare()
        reads."""
        def __init__(self, tokens):
            self.generated = tokens

    def route(router, idx):
        t0 = time.perf_counter()
        tickets = [router.submit(prompts[i], max_new[i]) for i in idx]
        results = [t.result(timeout=300.0) for t in tickets]
        wall = time.perf_counter() - t0
        for i, r in zip(idx, results):
            check(r["ok"] and len(r["tokens"]) == max_new[i],
                  f"routed request {i}: {r['reason']}, "
                  f"{len(r['tokens'])}/{max_new[i]} tokens")
        return results, wall

    print("  [16a] Router over two in-process replicas")
    gws = [EngineGateway(fleet_engine(model, f"r{i}")) for i in range(2)]
    try:
        router = Router([InProcessTransport(g) for g in gws],
                        config=RouterConfig(**router_cfg))
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0
        results, wall = route(router, range(n))
        steps0 = sum(settle(g, "16a") for g in gws)
        state = router.state()
        check(tuple(sorted(state)) == tuple(sorted(ROUTER_STATE_KEYS)),
              f"16a: router state keys {sorted(state)}")
        share = {g.replica_id: sum(r["replica_id"] == g.replica_id
                                   for r in results) for g in gws}
        tokens = sum(len(r["tokens"]) for r in results)
        print(f"    {tokens} tokens in {wall:.3f} s: tokens/s "
              f"{tokens / wall:.1f} (phase 4: {tps4:.1f} busy, "
              f"{sum(max_new) / wall4:.1f} over its {wall4:.3f} s wall); "
              f"requests a replica {share}; decode steps {steps0}")
        compare(torch, model, prompts, [Done(r["tokens"]) for r in results],
                ref, greedy, "vs phase 4")
        router.close()
        # the same requests without the router's worker threads: from
        # this thread to the two gateways in turn, then to one alone
        for label, targets in (("two gateways, no router", gws),
                               ("one gateway, no router", gws[:1])):
            t0 = time.perf_counter()
            direct = [targets[i % len(targets)].submit(
                prompts[i], max_new_tokens=max_new[i]) for i in range(n)]
            for i, r in enumerate(direct):
                check(targets[i % len(targets)].wait(r, timeout=300.0),
                      f"16a: {label}: request {i} timed out")
            dwall = time.perf_counter() - t0
            print(f"    {label}: {tokens} tokens in {dwall:.3f} s, "
                  f"tokens/s {tokens / dwall:.1f}")
            compare(torch, model, prompts, direct, ref, greedy,
                    "vs phase 4")
        steps = sum(settle(g, "16a") for g in gws)
        k4 = pa.paged_decode_attention.launches
        k1_total += attn.flash_attention_forward.launches
        check(k4 == steps * L and k4 > 0,
              f"16a: K4 launches {k4} != {steps} decode steps x {L}")
        k4_total += k4
        fired = {g.replica_id: g.engine.health.summary()["detectors"]
                 for g in gws if g.engine.health.anomalies_total}
        print(f"    16a's decode steps {steps}, K4 launches {k4}; health "
              f"anomalies {fired or 'none'}")
    finally:
        for g in gws:
            g.close()

    gws = [EngineGateway(fleet_engine(model, f"r{i}")) for i in range(2)]
    try:
        print("  [16b] replica r0 killed mid-stream (fresh replicas)")
        router = Router([InProcessTransport(g) for g in gws],
                        config=RouterConfig(**router_cfg))
        victim, survivor = gws
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0
        steps0 = [g.engine.metrics.decode_steps for g in gws]
        t0 = time.perf_counter()
        tickets = [router.submit(prompts[i], max_new[i]) for i in range(n)]
        deadline = time.monotonic() + 120.0
        streaming = 0
        while streaming < 2 and time.monotonic() < deadline:
            with victim._lock:
                streaming = sum(1 for r in victim.engine.scheduler.active
                                .values() if r.generated)
            time.sleep(0.001)
        check(streaming >= 2, "16b: r0 never streamed two requests")
        t_kill = time.perf_counter()
        victim.kill()
        kill_ms = (time.perf_counter() - t_kill) * 1e3
        results = [t.result(timeout=300.0) for t in tickets]
        done_s = time.perf_counter() - t_kill
        wall = time.perf_counter() - t0
        for i, r in enumerate(results):
            check(r["ok"] and len(r["tokens"]) == max_new[i],
                  f"16b: request {i} {r['reason']}")
        failovers = router._stats["failovers"]
        check(failovers >= 1, "16b: no failover")
        steps = victim.engine.metrics.decode_steps - steps0[0] \
            + settle(survivor, "16b") - steps0[1]
        k4 = pa.paged_decode_attention.launches
        k1_total += attn.flash_attention_forward.launches
        check(k4 == steps * L, f"16b: K4 launches {k4} != {steps} x {L}")
        k4_total += k4
        moved = [r for r in results if r["failovers"]]
        print(f"    killed r0 with {streaming} of its requests streaming; "
              f"kill() {kill_ms:.1f} ms; failovers {failovers} "
              f"({len(moved)} requests moved to r1); kill -> every request "
              f"done {done_s:.3f} s; whole run {wall:.3f} s; K4 launches "
              f"{k4}")
        compare(torch, model, prompts, [Done(r["tokens"]) for r in results],
                ref, greedy, "vs phase 4 (journal replay)")
        router.close()
    finally:
        for g in gws:
            g.close()

    print("  [16c] chaos: FaultPlan(seed=13) at DEFAULT_RATES, "
          "max_dispatch_retries=8")
    logs = []
    kws = [dict(on_token=lambda r, t: None) for _ in range(n)]
    for run in range(2):
        eng = fleet_engine(model, "c0", chaos=FaultPlan(seed=13),
                           max_dispatch_retries=8)
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0
        reqs, wall = drive(eng, prompts, max_new, kws)
        k4 = pa.paged_decode_attention.launches
        k1_total += attn.flash_attention_forward.launches
        check(k4 == eng.metrics.decode_steps * L,
              f"16c: K4 launches {k4} != {eng.metrics.decode_steps} x {L}")
        k4_total += k4
        eng.pool.check_conservation()
        check(eng.pool.live_blocks == 0 and eng.pool.free_count == 8,
              "16c: pool not empty")
        res = eng.metrics.snapshot()["resilience"]
        log = eng.chaos.fault_log()
        logs.append(log)
        print(f"    run {run + 1}: {eng.metrics.tokens_generated} tokens in "
              f"{wall:.3f} s, tokens/s {eng.metrics.tokens_per_sec():.1f} "
              f"(phase 4: {tps4:.1f}); {len(log)} faults "
              f"{res['faults_injected']}, retries "
              f"{res['dispatch_retries']}, callback errors "
              f"{res['callback_errors']}, aborted {res['requests_aborted']};"
              f" K4 launches {k4}")
        check(res["requests_aborted"] == 0, "16c: a request was aborted")
        compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4")
        eng.close()
    check(logs[0], "16c: the plan fired no fault")
    check(logs[0] == logs[1], "16c: the second run's fault log differs")
    print(f"    the second run's fault log equals the first's "
          f"({len(logs[0])} entries)")

    print("  [16d] supervisor: a wedged decode, queue_stall after 4 steps")
    eng = fleet_engine(model, "s0", supervisor=True,
                       supervisor_cooldown_s=0.0, max_dispatch_retries=1000,
                       health_detectors={"queue_stall": {"stall_steps": 4}})
    pa.paged_decode_attention.launches = 0
    attn.flash_attention_forward.launches = 0
    reqs = [eng.add_request(p, max_new_tokens=k)
            for p, k in zip(prompts, max_new)]
    for _ in range(12):
        eng.step()
    check(eng.health.report()["healthy"], "16d: unhealthy before the wedge")
    pool_bytes = eng.pool.kc.nbytes + eng.pool.vc.nbytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def wedged(*a, **k):
        raise RuntimeError("decode wedged")

    eng._decode_fn = wedged
    t0 = time.perf_counter()
    wedge_steps = 0
    while eng.supervisor.restarts == 0:
        eng.step()
        wedge_steps += 1
        check(wedge_steps < 50, "16d: the supervisor never restarted")
    restart_ms = (time.perf_counter() - t0) * 1e3
    during = eng.health.report()
    check(during["degraded"] and not during["healthy"],
          f"16d: after the restart health says {during['healthy']}, "
          f"degraded {during['degraded']}")
    eng.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    after = eng.health.report()
    check(eng.supervisor.restarts == 1,
          f"16d: {eng.supervisor.restarts} restarts")
    check(after["healthy"] and not after["degraded"],
          "16d: not healthy after the replay")
    k4 = pa.paged_decode_attention.launches
    k1_total += attn.flash_attention_forward.launches
    check(k4 == eng.metrics.decode_steps * L,
          f"16d: K4 launches {k4} != {eng.metrics.decode_steps} x {L}")
    k4_total += k4
    eng.pool.check_conservation()
    check(eng.pool.live_blocks == 0, "16d: blocks leaked")
    # the restart frees the old pool before it builds the new one: the
    # peak over the start stays below a second pool
    check(peak < pool_bytes,
          f"16d: peak {peak} over the start holds a second pool "
          f"({pool_bytes} bytes)")
    for r, k in zip(reqs, max_new):
        check(r.done and len(r.generated) == k, f"16d: request {r.rid} "
              f"incomplete")
    print(f"    wedged for {wedge_steps} steps ({restart_ms:.1f} ms) to the "
          f"restart; health during the replay: healthy {during['healthy']}"
          f", degraded {during['degraded']}; after: healthy "
          f"{after['healthy']}; restarts 1; peak memory over the start "
          f"{peak / 2**20:.1f} MiB (a pool is {pool_bytes / 2**20:.1f} "
          f"MiB); K4 launches {k4}")
    compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4 "
            "(replayed)")
    eng.close()
    del eng

    print("  [16e] HTTP: EngineGateway.serve() on 127.0.0.1, a router "
          "over HTTPTransport")
    gw = EngineGateway(fleet_engine(model, "h0"))
    handle = gw.serve(port=0, addr="127.0.0.1")
    router = None
    try:
        router = Router([HTTPTransport(f"127.0.0.1:{handle.port}",
                                       replica_id="h0", timeout_s=300.0)],
                        config=RouterConfig(**router_cfg))
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0
        idx = range(4)
        results, wall = route(router, idx)
        steps = settle(gw, "16e")
        k4 = pa.paged_decode_attention.launches
        k1_total += attn.flash_attention_forward.launches
        check(k4 == steps * L, f"16e: K4 launches {k4} != {steps} x {L}")
        k4_total += k4
        codes = {}
        for path in ("/metrics", "/debug/health"):
            with urllib.request.urlopen(handle.url + path,
                                        timeout=30.0) as resp:
                codes[path] = resp.status
        check(all(c == 200 for c in codes.values()), f"16e: {codes}")
        print(f"    4 requests over the wire in {wall:.3f} s; GET {codes};"
              f" K4 launches {k4}")
        compare(torch, model, [prompts[i] for i in idx],
                [Done(r["tokens"]) for r in results],
                [ref[i] for i in idx], greedy, "vs phase 4")
    finally:
        if router is not None:
            router.close()
        gw.close()
    check(handle.closed, "16e: the server is still up")
    del model
    return k4_total, k1_total


# --------------------------------------------------------------- phase 17

# phase 17's SLO targets and tenants, and the observatories on and off
OBS_SLO = dict(slo_ttft_ms=2000.0, slo_tpot_ms=50.0)
OBS_TENANTS = ("acme", "zeta", "ortho")
OBS_ON = dict(perf=True, cache_observatory=True, trace_spans=True,
              health=True, **OBS_SLO)
OBS_OFF = dict(perf=False, cache_observatory=False, trace_spans=False,
               health=False)
# the debug surface every replica answers over serve_metrics()
OBS_ROUTES = ("/metrics", "/metrics.json", "/debug", "/debug/state",
              "/debug/requests", "/debug/traces", "/debug/perf",
              "/debug/cache", "/debug/tenants", "/debug/health",
              "/debug/ledger")


def get_json(url):
    """(status, body): JSON bodies decoded, text ones as bytes."""
    with urllib.request.urlopen(url, timeout=30.0) as resp:
        body = resp.read()
        if "json" in resp.headers.get("Content-Type", ""):
            body = json.loads(body)
        return resp.status, body


def decode_kv_bytes(prompts, max_new, cfg, kv_bytes):
    """This script's reckoning of the K/V bytes the decode dispatches
    move: every request rides max_new - 1 decodes (no EOS; a max-token
    stop is known at dispatch), at cached lengths P .. P + max_new - 2;
    each reads its live K/V (length + 1 positions: K4 stops there) and
    writes one position."""
    nh = cfg.num_heads
    per_pos = 2 * cfg.num_layers * nh * (cfg.hidden_size // nh) * kv_bytes
    return sum((base + 2) * per_pos for p, n in zip(prompts, max_new)
               for base in range(len(p), len(p) + n - 1))


def obs_run(torch, model, prompts, max_new, knobs, poll_s=None):
    """Phase 4's arrivals on a fresh engine, every request tagged with
    one of three tenants. With ``poll_s`` the engine is served on
    127.0.0.1 and a FleetPoller scrapes it every ``poll_s`` seconds on
    its own thread while it serves; the engine then steps and takes
    requests under the lock its debug routes read under. Returns
    (engine, requests, wall, tokens/s, poller)."""
    import threading
    from paddle_tpu_torch.observability.fleet import FleetPoller
    eng = fleet_engine(model, "o0", **knobs)
    poller = None
    if poll_s is not None:
        lock = threading.Lock()
        step, add = eng.step, eng.add_request

        def locked_step():
            with lock:
                return step()

        def locked_add(*a, **k):
            with lock:
                return add(*a, **k)
        eng.step, eng.add_request = locked_step, locked_add
        handle = eng.serve_metrics(lock=lock)
        poller = FleetPoller([f"127.0.0.1:{handle.port}"],
                             interval_s=poll_s, timeout_s=5.0)
        poller.start()
    kws = [dict(tenant_id=OBS_TENANTS[i % 3]) for i in range(len(prompts))]
    try:
        reqs, wall = drive(eng, prompts, max_new, kws)
    finally:
        if poller is not None:
            poller.stop()
    return eng, reqs, wall, eng.metrics.tokens_per_sec(), poller


def phase_observe(torch, pa, attn, TransformerLMConfig, prompts, max_new,
                  ref, tps4):
    """Phase 17, the serving engine's observatories and the fleet
    telemetry on phase 4's GPT-124M (same seed, weights and 16 requests,
    spread over three tenants; ``ref`` phase 4's streams, ``tps4`` its
    tokens/s): 17a every observatory on changes no token; 17b the decode
    program's roofline floor against this script's reckoning, its
    roofline fraction, the MFU gauge and the HBM gauges; 17c tenants,
    SLO, flight recorder, traces, the cache section and every route; 17d
    two replicas over HTTP behind a FleetPoller and a FleetServer, one
    killed; 17e tokens/s with every observatory on and off in turns, and
    on with a poller scraping every 0.25 s. K4 = 12 x the decode steps
    of each run's engines, the counts set to 0 just before and read just
    after. Returns (K4, K1) launches."""
    from paddle_tpu_torch.observability.cache import CACHE_KEYS
    from paddle_tpu_torch.observability.fleet import (FleetPoller,
                                                      FleetServer)
    from paddle_tpu_torch.observability.perf import (PERF_KEYS,
                                                     PERF_SPEC_KEYS)
    from paddle_tpu_torch.observability.tenant import TENANT_KEYS
    from paddle_tpu_torch.observability.trace import TraceAssembler
    from paddle_tpu_torch.serving.router import EngineGateway
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(dropout=0.0)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    n = len(prompts)
    greedy = [{} for _ in range(n)]
    by_tenant = {t: sum(max_new[i] for i in range(n)
                        if OBS_TENANTS[i % 3] == t) for t in OBS_TENANTS}
    totals = {"k4": 0, "k1": 0}

    def start():
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0

    def counted(label, engines):
        k4 = pa.paged_decode_attention.launches
        steps = sum(e.metrics.decode_steps for e in engines)
        totals["k1"] += attn.flash_attention_forward.launches
        check(k4 == steps * L and k4 > 0,
              f"{label}: K4 launches {k4} != {steps} decode steps x {L}")
        totals["k4"] += k4
        return k4

    print(f"  [17a] every observatory on: perf, cache, trace spans, SLO "
          f"{OBS_SLO}, tenants {OBS_TENANTS}")
    start()
    eng, reqs, wall, tps, _ = obs_run(torch, model, prompts, max_new,
                                      OBS_ON)
    k4 = counted("17a", [eng])
    eng.pool.check_conservation()
    check(eng.pool.live_blocks == 0 and eng.pool.free_count == 8,
          "17a: pool not empty")
    M = eng.metrics
    print(f"    {M.tokens_generated} tokens in {wall:.3f} s, tokens/s "
          f"{tps:.1f} (phase 4: {tps4:.1f}); decode steps "
          f"{M.decode_steps}, K4 launches {k4} = {M.decode_steps} x {L}")
    compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4")

    print("  [17b] perf: the decode program against its roofline")
    rep = M.perf_report()
    check(set(rep) == set(PERF_KEYS)
          and set(rep["spec"]) == set(PERF_SPEC_KEYS),
          f"17b: perf keys {sorted(rep)}")
    dev = rep["device"]
    check(dev["device_peak"] and dev["device_hbm"]
          and dev["hbm_bps"] == HBM_BPS
          and dev["peak_flops"] == PEAK_FLOPS["bfloat16"],
          f"17b: device figures {dev}")
    dec = rep["programs"]["decode"]
    steps = M.decode_steps
    check(dec["dispatches"] == steps, f"17b: {dec['dispatches']} decode "
          f"dispatches timed, {steps} run")
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = n_params * eng.params["wemb"].element_size()
    kv = decode_kv_bytes(prompts, max_new, cfg, eng.pool.kc.element_size())
    mean_bytes = param_bytes + kv / steps
    floor_ms = mean_bytes / HBM_BPS * 1e3
    check(dec["bound"] == "hbm", f"17b: decode bound by {dec['bound']}")
    check(abs(dec["roofline_floor_ms"] - floor_ms) <= 2e-6,
          f"17b: decode floor {dec['roofline_floor_ms']} ms vs this "
          f"script's {floor_ms:.6f} ms")
    frac = dec["roofline_fraction"]
    check(frac is not None and 0 < frac <= 1,
          f"17b: decode roofline fraction {frac}")
    mfu = M.estimated_mfu()
    check(0 < mfu < 1, f"17b: estimated MFU {mfu}")
    print(f"    decode: {steps} dispatches, {dec['avg_ms']} ms each "
          f"(dispatch {dec['dispatch_s']} s + sync {dec['sync_s']} s in "
          f"all); {mean_bytes:.6e} B a dispatch ({n_params} f32 "
          f"parameters, {kv / steps:.6e} B of K/V); roofline floor "
          f"{dec['roofline_floor_ms']} ms (this script: {floor_ms:.6f} ms "
          f"at {HBM_BPS:.3e} B/s); roofline fraction {frac}")
    print(f"    attributed_fraction {rep['attributed_fraction']} of "
          f"{rep['step_total_s']} s of steps; estimated MFU {mfu:.3e} "
          f"(decode FLOPs against the bf16 peak; the engine serves f32)")
    for label, prog in sorted(rep["programs"].items()):
        if label != "decode":
            print(f"    {label}: {prog['dispatches']} dispatches, "
                  f"{prog['avg_ms']} ms each, floor "
                  f"{prog['roofline_floor_ms']} ms, fraction "
                  f"{prog['roofline_fraction']}, bound {prog['bound']}")
    torch.cuda.synchronize()
    fams = M.registry.snapshot()
    in_use = fams["serving_hbm_bytes_in_use"]["values"][""]
    free = fams["serving_hbm_bytes_free"]["values"][""]
    direct = torch.cuda.memory_allocated()
    block = 2 * eng.pool.kc[:, 0].nbytes
    total = torch.cuda.mem_get_info()[1]
    check(abs(in_use - direct) <= block, f"17b: HBM gauge {in_use} vs "
          f"memory_allocated {direct} (a pool block is {block} B)")
    check(abs(in_use + free - total) <= block,
          f"17b: in use {in_use} + free {free} != the card's {total}")
    print(f"    HBM gauges: in use {in_use / 2**20:.1f} MiB "
          f"(memory_allocated {direct / 2**20:.1f} MiB), free "
          f"{free / 2**30:.2f} GiB of {total / 2**30:.2f} GiB")

    print("  [17c] tenants, SLO, flight recorder, traces, cache, routes")
    snap = M.snapshot()
    rows = snap["tenants"]["tenants"]
    check(set(snap["tenants"]) == set(TENANT_KEYS)
          and set(rows) == set(OBS_TENANTS), f"17c: tenants {sorted(rows)}")
    got = {t: rows[t]["tokens_out"] for t in OBS_TENANTS}
    check(got == by_tenant and sum(got.values()) == M.tokens_generated,
          f"17c: tokens per tenant {got} vs {by_tenant}")
    slo = snap["slo"]
    violating = sum(1 for r in reqs if eng.request_trace(r.rid)
                    .events[-1].get("slo_violations"))
    check(slo["attained"] + violating == M.requests_completed == n,
          f"17c: attained {slo['attained']} + violating {violating} != "
          f"{M.requests_completed}")
    fl = eng.flight.state()
    check(fl["completed_kept"] == n and fl["active"] == 0,
          f"17c: flight recorder {fl}")
    handle = eng.serve_metrics()
    try:
        base = f"http://127.0.0.1:{handle.port}"
        codes = {route: get_json(base + route)[0] for route in OBS_ROUTES}
        check(all(c == 200 for c in codes.values()), f"17c: {codes}")
        _, body = get_json(base + "/debug/requests?tenant=zeta")
        want = {r.rid for r in reqs if r.tenant_id == "zeta"}
        check({t["rid"] for t in body["completed"]} == want
              and not body["active"], "17c: /debug/requests?tenant=zeta "
              "is not exactly zeta's requests")
        asm = TraceAssembler()
        asm.scrape(base)
        ids = asm.trace_ids()
        check(sorted(ids) == sorted(r.trace.trace_id for r in reqs),
              f"17c: {len(ids)} traces for {n} requests")
        for tid in ids:
            names = sorted(s["name"] for s in asm.assemble(tid).spans)
            check(names == ["prefill/compute", "prefill/queue"],
                  f"17c: trace {tid} has {names}")
        _, cache = get_json(base + "/debug/cache")
        check(set(cache) == set(CACHE_KEYS) and cache["mrc"]
              and cache["accesses"] > 0, f"17c: /debug/cache {cache}")
    finally:
        handle.close()
    print(f"    tokens per tenant {got} (sum {M.tokens_generated}); SLO "
          f"attained {slo['attained']}, violations {slo['violations']}, "
          f"goodput {slo['goodput_tokens']} of {slo['total_tokens']} "
          f"tokens; flight traces {fl['completed_kept']}; {len(ids)} "
          f"assembled traces, each prefill/queue + prefill/compute (a "
          f"monolithic request's segments); cache: {cache['accesses']} "
          f"block accesses, {cache['hits']} hits, MRC "
          f"{[(p['factor'], p['est_hit_rate']) for p in cache['mrc']]}; "
          f"{len(codes)} routes answer 200")
    eng.close()
    del eng

    print("  [17d] the fleet: two replicas over HTTP, a FleetPoller and a "
          "FleetServer, one replica killed")
    gws = [EngineGateway(fleet_engine(model, f"f{i}", **OBS_ON))
           for i in range(2)]
    server = None
    try:
        urls = [f"127.0.0.1:{g.serve().port}" for g in gws]
        start()
        t0 = time.perf_counter()
        sub = [gws[i % 2].submit(prompts[i], max_new_tokens=max_new[i],
                                 tenant_id=OBS_TENANTS[i % 3])
               for i in range(n)]
        for i, r in enumerate(sub):
            check(gws[i % 2].wait(r, timeout=300.0),
                  f"17d: request {i} timed out")
        wall = time.perf_counter() - t0
        for g in gws:
            settle(g, "17d")
        counted("17d", [g.engine for g in gws])
        compare(torch, model, prompts, sub, ref, greedy, "vs phase 4")
        clock = {"t": 0.0}
        poller = FleetPoller(urls, timeout_s=30.0, down_after=2,
                             clock=lambda: clock["t"])
        check(poller.poll_once() == [],
              "17d: a fleet detector fired on a healthy fleet")
        state = poller.snapshot()
        verdicts = {e["replica_id"]: (e["verdict"], e["healthy"])
                    for e in state["replicas"].values()}
        check(verdicts == {"f0": ("up", True), "f1": ("up", True)},
              f"17d: verdicts {verdicts}")
        fleet = state["fleet"]
        sums = {"tokens_generated": sum(g.engine.metrics.tokens_generated
                                        for g in gws),
                "requests_completed": sum(
                    g.engine.metrics.requests_completed for g in gws),
                "goodput_tokens": sum(g.engine.metrics.slo.goodput_tokens
                                      for g in gws)}
        check({k: fleet[k] for k in sums} == sums,
              f"17d: fleet sums {fleet} vs the replicas' {sums}")
        ftok = {t: e["tokens_out"]
                for t, e in fleet["tenants"]["tenants"].items()}
        check(ftok == by_tenant, f"17d: fleet tokens per tenant {ftok}")
        server = FleetServer(poller)
        fbase = f"http://127.0.0.1:{server.serve(poll=False).port}"
        fcodes = {r: get_json(fbase + r)[0] for r in (
            "/fleet/health", "/fleet/state", "/fleet/metrics",
            "/fleet/tenants")}
        check(all(c == 200 for c in fcodes.values()), f"17d: {fcodes}")
        print(f"    16 requests to two gateways in {wall:.3f} s; verdicts "
              f"{verdicts}; fleet sums {sums} = the replicas'; TTFT "
              f"p50/p99 {fleet['latency']['ttft']['p50_ms']}/"
              f"{fleet['latency']['ttft']['p99_ms']} ms from merged "
              f"buckets; decode roofline fraction (mean) "
              f"{fleet['roofline_fraction']}; /fleet routes {fcodes}")
        gws[1].kill()
        fired, seen = [], []
        for _ in range(poller.down_after):
            clock["t"] += 10.0
            fired += poller.poll_once()
            seen.append({e["replica_id"]: e["verdict"]
                         for e in poller.snapshot()["replicas"].values()})
        check(seen[-1] == {"f0": "up", "f1": "down"}
              and all(v["f1"] != "down" for v in seen[:-1]),
              f"17d: verdicts a cycle after the kill {seen}")
        # the reference's replica_flap fires on an up->down transition:
        # once, on the eviction cycle, naming the killed replica alone
        check(len(fired) == 1 and fired[0]["detector"] == "replica_flap"
              and fired[0]["replicas"] == ["f1"], f"17d: fired {fired}")
        print(f"    killed f1: verdicts a cycle {seen}; replica_flap once, "
              f"on the eviction cycle ({fired[0]['reason']}), none for f0")
    finally:
        if server is not None:
            server.close()
        for g in gws:
            g.close()

    print("  [17e] what the observatories cost: tokens/s on, off, off, "
          "on; then on, scraped every 0.25 s")
    rates = {"on": [], "off": []}
    for label in ("on", "off", "off", "on"):
        start()
        e, rq, w, t, _ = obs_run(torch, model, prompts, max_new,
                                 OBS_ON if label == "on" else OBS_OFF)
        counted(f"17e {label}", [e])
        compare(torch, model, prompts, rq, ref, greedy, f"17e {label}")
        rates[label].append(t)
        print(f"    {label}: tokens/s {t:.1f} ({w:.3f} s wall; phase 4: "
              f"{tps4:.1f})")
        e.close()
    start()
    e, rq, w, t, poller = obs_run(torch, model, prompts, max_new, OBS_ON,
                                  poll_s=0.25)
    counted("17e polled", [e])
    compare(torch, model, prompts, rq, ref, greedy, "17e polled")
    (st,) = poller.replicas
    check(st.polls >= 1 and st.failures == 0,
          f"17e: {st.polls} scrapes, {st.failures} failed")
    e.close()
    print(f"    on, scraped every 0.25 s: tokens/s {t:.1f} ({w:.3f} s "
          f"wall; {st.polls} scrapes, last {st.scrape_s * 1e3:.1f} ms); "
          f"on {[round(x, 1) for x in rates['on']]}, off "
          f"{[round(x, 1) for x in rates['off']]}, phase 4 {tps4:.1f}")
    del model
    return totals["k4"], totals["k1"]


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return card[0] if card else "nvidia-smi: no output"


def main():
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--parent", metavar="TREE",
                    help=f"a checkout of {PARENT}, whose fused_ce.cu (its "
                    "f32 K5) phases 9 and 11 compare with (default: git "
                    "history, where the checkout has it)")
    ap.add_argument("--fleet", action="store_true",
                    help="phases 1, 4, 16 and 17 only (the build, phase "
                    "4's streams, the hardened engine and the router, the "
                    "observatories and the fleet telemetry); prints no "
                    "kernels line")
    args = ap.parse_args()
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from paddle_tpu_torch import amp, nn, optimizer, regularizer
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.ops import attention as attn
        from paddle_tpu_torch.ops import fused_ce as tce
        from paddle_tpu_torch.ops import paged_attention as pa
        from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                                  TransformerLMConfig)
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch not found beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    # full f32 products everywhere: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; TF32 off for matmuls and "
          f"cuDNN")

    print("[1] build")
    parent_build = start_parent_build(_build, parent_sources(args.parent))
    secs = _build.build_all()
    for name in _build.sources():
        for line in ptxas_lines(_build.build_log(name)):
            print(f"  {name}: {line}")
    print(f"  built {_build.sources()} in {secs:.2f} s")
    blocks = _build.function("flash_bwd",
                             "flash_attention_backward_f32_blocks_per_sm",
                             [ctypes.c_int, ctypes.c_int])
    print("  f32 K2/K3 blocks an SM: " + ", ".join(
        f"D = {d}: {blocks(d, 0)} / {blocks(d, 1)}" for d in (64, 128)))
    k1_blocks = _build.function("flash_fwd",
                                "flash_attention_forward_f32_blocks_per_sm",
                                [ctypes.c_int, ctypes.c_int])
    print("  f32 K1 blocks an SM, by the warps that share 16 query rows (KS):"
          " " + ", ".join(f"D = {d}, KS = {ks}: {k1_blocks(d, ks)}"
                          for d, ks in ((64, 1), (64, 2), (64, 4), (128, 1),
                                        (128, 2))))
    ce_blocks = _build.function("fused_ce",
                                "fused_ce_backward_f32_blocks_per_sm",
                                [ctypes.c_int])
    k5_blocks = _build.function("fused_ce",
                                "fused_ce_forward_f32_blocks_per_sm", [])
    print(f"  f32 K5 blocks an SM: {k5_blocks()}; f32 K6/K7: "
          f"{ce_blocks(1)} / {ce_blocks(0)}")
    parent = load_parent(parent_build)
    print(f"  the parent's ({PARENT}) f32 K5: " + (
        "built, for phases 9 and 11" if parent else
        "no source at hand (no git history, no --parent): not compared"))

    cfg = TransformerLMConfig(dropout=0.0)
    prompts, max_new = workload(cfg.vocab_size)
    longest = max(len(p) + n for p, n in zip(prompts, max_new))

    train_cfg = TransformerLMConfig(tie_embeddings=False, dropout=0.0,
                                    use_flash_attention=True)
    train_shape = (8, train_cfg.num_heads, train_cfg.max_seq_len,
                   train_cfg.hidden_size // train_cfg.num_heads)
    if not args.fleet:
        print("[2] K4 paged decode attention vs plain")
        k4_row = phase_k4(torch, pa)
        print("[3] K1 flash-attention forward vs plain")
        k1_row, k1t_row = phase_k1(
            torch, attn, (1, cfg.num_heads, longest,
                          cfg.hidden_size // cfg.num_heads), train_shape,
            _build)
    print("[4] serve GPT-124M")
    gen = torch.Generator().manual_seed(1234)
    model = GPTForCausalLM(cfg, generator=gen).eval()
    reqs, k4, snap, wall = phase_serve(torch, model, prompts, max_new, pa,
                                       attn)
    if args.fleet:
        del model
        print("[16] the hardened engine and the router")
        k4_fleet, k1_fleet = phase_fleet(
            torch, pa, attn, TransformerLMConfig, prompts, max_new,
            [r.generated for r in reqs], snap["tokens_per_sec"], wall)
        print("[17] the observatories and the fleet telemetry")
        k4_obs, k1_obs = phase_observe(
            torch, pa, attn, TransformerLMConfig, prompts, max_new,
            [r.generated for r in reqs], snap["tokens_per_sec"])
        print(f"phases 1, 4, 16 and 17 in "
              f"{time.perf_counter() - t_start:.1f} s; phase 16's K4 "
              f"launches {k4_fleet}, K1 {k1_fleet}; phase 17's K4 "
              f"{k4_obs}, K1 {k1_obs}")
        print(card_line())
        return 0
    print("[5] greedy cross-check against the forward")
    k1 = phase_check(torch, model, reqs, attn)
    del model
    print("[6] K2/K3 flash-attention backward vs plain")
    k2_row, k3_row, k1b_row, k2b_row, k3b_row = phase_k2k3(torch, attn,
                                                           train_shape)
    print("[7] train GPT-124M (untied head)")
    k1_train, k2, k3 = phase_train(torch, attn, train_cfg, optimizer, nn)
    print("[8] card against CPU: 2-layer GPT at full width")
    for tie in (False, True):
        phase_card_vs_cpu(torch, optimizer, nn, TransformerLMConfig, tie)
    print("[9] K5/K6/K7 fused linear cross-entropy vs plain")
    (k5f_row, k6f_row, k7f_row, k5_row, k6_row,
     k7_row) = phase_k5k7(torch, tce, FLAGSHIP["batch"] * FLAGSHIP["seq"],
                          cfg.hidden_size, cfg.vocab_size, _build, parent)
    print("[10] the reference's flagship step: GPT-124M tied, AMP O1 bf16")
    flagship, flagship_losses, _, _ = phase_flagship(
        torch, attn, tce, amp, optimizer, TransformerLMConfig)
    print("[11] the flagship step in f32: GPT-124M tied, f32 K5-K7")
    tied_cfg = TransformerLMConfig(dropout=0.0, use_flash_attention=True,
                                   max_seq_len=FLAGSHIP["seq"])
    counts, f32_run = phase_tied_f32(torch, attn, tce, tied_cfg, optimizer,
                                     nn, _build, parent)
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    print("[12] the optimizers: 2-layer GPT at full width, card against CPU")
    optim = phase_optim(torch, wrappers, optimizer, nn, regularizer,
                        TransformerLMConfig)
    print("[13] recompute: phase 11's step, then 2 of phase 10's")
    rc_cfg = TransformerLMConfig(dropout=0.0, use_flash_attention=True,
                                 max_seq_len=FLAGSHIP["seq"], recompute=True)
    rc_f32, rc_bf16 = phase_recompute(
        torch, wrappers, rc_cfg, optimizer, nn, f32_run, amp, attn, tce,
        TransformerLMConfig, flagship_losses)
    print("[14] generate(): GPT-124M greedy and top-k, beams on 2 layers")
    k1_gen, k4_gen = phase_generate(torch, pa, attn, TransformerLMConfig)
    print("[15] serve the rest: slot pool, chunked prefill, speculative "
          "decoding, sampling, disaggregation")
    k4_rest = phase_rest(torch, pa, TransformerLMConfig, prompts, max_new,
                         [r.generated for r in reqs],
                         snap["tokens_per_sec"])
    print("[16] the hardened engine and the router: two replicas, a kill, "
          "chaos, the supervisor, HTTP")
    k4_fleet, k1_fleet = phase_fleet(
        torch, pa, attn, TransformerLMConfig, prompts, max_new,
        [r.generated for r in reqs], snap["tokens_per_sec"], wall)
    print("[17] the observatories (perf, cache, tenants, SLO, flight "
          "recorder, traces) and the fleet poller, rollup and server")
    k4_obs, k1_obs = phase_observe(
        torch, pa, attn, TransformerLMConfig, prompts, max_new,
        [r.generated for r in reqs], snap["tokens_per_sec"])

    # launches summed over the main paths that run each row's kernel: K4
    # on phases 4, 14, 15's paged runs, 16 and 17, the serving K1 row on
    # phases 5, 14, 16 and 17 (the engine's prefill attends without K1,
    # so 16 and 17 add only what their stream checks run through the
    # forward); the f32 training rows
    # (K1 at the training shape, K2, K3, K5-K7) on phases 7, 11, 12 and
    # 13; the bf16 rows on phases 10 and 13
    k4_row["launches"] = k4 + k4_gen + k4_rest + k4_fleet + k4_obs
    k1_row["launches"] = k1 + k1_gen + k1_fleet + k1_obs
    f32 = [a + b + c for a, b, c in zip(counts, optim, rc_f32)]
    k1t_row["launches"] = k1_train + f32[0]
    k2_row["launches"] = k2 + f32[1]
    k3_row["launches"] = k3 + f32[2]
    k5f_row["launches"], k6f_row["launches"], k7f_row["launches"] = f32[3:]
    bf16 = [a + b for a, b in zip(flagship, rc_bf16)]
    for row, n in zip((k1b_row, k2b_row, k3b_row, k5_row, k6_row, k7_row),
                      bf16):
        row["launches"] = n
    print(f"phases 1-17 in {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    keys = ("name", "route", "dtype", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in (k4_row, k1_row, k1t_row,
                                              k2_row, k3_row, k1b_row,
                                              k2b_row, k3b_row, k5_row,
                                              k6_row, k7_row, k5f_row,
                                              k6f_row, k7f_row)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
