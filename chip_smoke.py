#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each:
  1. build   every csrc/*.cu kernel with nvcc (one process per source,
             all started together) and print the build seconds;
  2. K4      paged decode attention against its plain PyTorch version at
             the engine's shapes: ragged lengths, mid-block tails,
             trash-padded tables over garbage, a length past MB*BS,
             f32 and bf16, plus head_dim 32/128 and a length-0 slot;
  3. K1      flash-attention forward against its plain version for O and
             LSE: [2,12,1024,64], a ragged [1,12,333,64], the serving
             cross-check's longest shape and a head_dim-128 case,
             causal and not, f32 and bf16;
  4. serve   GPT-124M (random weights from a seeded torch.Generator) in
             ServingEngine(num_slots=8, block_size=16, async_depth=1):
             16 greedy requests in two staggered waves, four sharing a
             256-token prefix; K4 launches must equal decode steps x 12;
  5. check   every request's stream against the teacher-forced argmax of
             the port's own forward (through K1): a token may differ only
             where the reference's top-2 logit margin is below 1e-4.
Then the card's name and power limit, one JSON line of kernel numbers,
and as the last line {"ok": true, "device": {...}}.

TF32 is off for matmuls and cuDNN, so every f32 product is full f32.
Any failure raises: the exit code is non-zero and no "ok" line prints.
Without a CUDA device, or without the package beside this file, it
exits non-zero at once.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = 1e-5    # f32 sums over <= 1024 rows, only their order differs
F32_FLASH_TOL = 2e-5   # f32 flash: 64-key tiles rescaled, O(1) values
BF16_TOL = 2e-2   # kernel output rounded to bf16 (half an ulp at |x|~4)
TIE_MARGIN = 1e-4


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
    50 MB L2 flushed before each (a decode step finds each layer's cache
    cold)."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


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


def phase_k4(torch, pa):
    S, nh, hd, BS, MB = 8, 12, 64, 16, 64
    lengths = [1, 16, 17, 300, 555, 1024, 1100, 733]   # 1100 > MB*BS
    out = {}
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        args = paged_case(torch, S, nh, hd, BS, MB, lengths, dtype, 1)
        got = pa.paged_decode_attention(*args).float()
        # plain version in f32 on the same (rounded) inputs
        ref = pa.paged_decode_plain(*(a.float() if a.is_floating_point()
                                      else a for a in args))
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(err <= tol, f"K4 {dtype} max abs err {err} > {tol}")
        out[dtype] = (err, args)
        print(f"  K4 {dtype} S={S} nh={nh} hd={hd} BS={BS} MB={MB} "
              f"lengths={lengths}: max_abs_err={err:.3e} (tol {tol})")
    for hd2 in (32, 128):
        args = paged_case(torch, 3, 4, hd2, 8, 5, [1, 13, 40], "float32", 2)
        err = (pa.paged_decode_attention(*args)
               - pa.paged_decode_plain(*args)).abs().max().item()
        check(err <= F32_TOL, f"K4 hd={hd2} max abs err {err}")
        print(f"  K4 float32 hd={hd2}: max_abs_err={err:.3e}")
    args = paged_case(torch, 3, 4, 64, 16, 4, [0, 5, -3], "float32", 3)
    o = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o).all()), "K4 length<=0 slot not finite")
    err = (o[1] - pa.paged_decode_plain(*args)[1]).abs().max().item()
    check(err <= F32_TOL, f"K4 beside a length-0 slot: err {err}")
    print("  K4 length<=0 slots: finite output")

    err, args = out["float32"]
    q, kc, vc, tables, lens = args
    ms = time_ms(torch, lambda: pa.paged_decode_attention(*args))
    plain_ms = time_ms(torch, lambda: pa.paged_decode_plain(*args))
    rows = sum(min(n, MB * BS) for n in lengths)
    row_bytes = nh * hd * 4
    nbytes = 2 * S * row_bytes + 2 * rows * row_bytes + tables.numel() * 4 \
        + lens.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * rows * nh * hd, "float32")
    print(f"  K4 float32 time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/ops/paged_attention.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# ---------------------------------------------------------------- phase 3

def phase_k1(torch, attn, main_shape):
    import torch.nn.functional as F
    cases = [((2, 12, 1024, 64), c, dt) for c in (True, False)
             for dt in ("float32", "bfloat16")]
    cases += [((1, 12, 333, 64), c, dt) for c in (True, False)
              for dt in ("float32", "bfloat16")]
    cases += [(main_shape, True, "float32"), ((1, 4, 200, 128), True,
                                              "float32"),
              ((1, 4, 200, 128), False, "bfloat16")]
    g = torch.Generator(device="cuda").manual_seed(4)
    main = None
    for shape, causal, dtype in cases:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for _ in range(3))
        scale = 1.0 / shape[-1] ** 0.5
        o, lse = attn.flash_attention_forward(q, k, v, scale, causal)
        ro, rlse = attn.flash_attention_plain(q.float(), k.float(),
                                              v.float(), scale, causal)
        torch.cuda.synchronize()
        eo = (o.float() - ro).abs().max().item()
        el = (lse - rlse).abs().max().item()
        tol = F32_FLASH_TOL if dtype == "float32" else BF16_TOL
        check(eo <= tol and el <= tol,
              f"K1 {shape} causal={causal} {dtype}: O err {eo}, LSE err "
              f"{el} > {tol}")
        print(f"  K1 {list(shape)} causal={causal} {dtype}: O err "
              f"{eo:.3e}, LSE err {el:.3e} (tol {tol})")
        if shape == main_shape and dtype == "float32" and causal:
            main = (q, k, v, scale, max(eo, el))
    q, k, v, scale, err = main

    def timed(shape_q, sc):
        ms = time_ms(torch, lambda: attn.flash_attention_forward(
            shape_q[0], shape_q[1], shape_q[2], sc, True))
        plain_ms = time_ms(torch, lambda: attn.flash_attention_plain(
            shape_q[0], shape_q[1], shape_q[2], sc, True))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            shape_q[0], shape_q[1], shape_q[2], is_causal=True))
        b, h, s, d = shape_q[0].shape
        pairs = s * (s + 1) // 2
        nbytes = 4 * b * h * s * d * 4 + b * h * s * 4
        return (ms, plain_ms, lib_ms) + bound(nbytes, 4 * b * h * d * pairs,
                                              "float32")

    ms, plain_ms, lib_ms, b_ms, b_by = timed((q, k, v), scale)
    print(f"  K1 {list(main_shape)} causal f32 time {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    big = tuple(torch.randn(2, 12, 1024, 64, generator=g, device="cuda")
                for _ in range(3))
    r = timed(big, 0.125)
    print(f"  K1 [2, 12, 1024, 64] causal f32 time {r[0]:.4f} ms, plain "
          f"{r[1]:.4f} ms, sdpa {r[2]:.4f} ms, bound {r[3]:.4f} ms "
          f"({r[4]})")
    return {"name": "flash_attention_forward", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "paddle_tpu/ops/attention.py:67",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


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


def main():
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
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.ops import attention as attn
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
    secs = _build.build_all()
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"  built {_build.sources()} in {secs:.2f} s")

    cfg = TransformerLMConfig(dropout=0.0)
    prompts, max_new = workload(cfg.vocab_size)
    longest = max(len(p) + n for p, n in zip(prompts, max_new))

    print("[2] K4 paged decode attention vs plain")
    k4_row = phase_k4(torch, pa)
    print("[3] K1 flash-attention forward vs plain")
    k1_row = phase_k1(torch, attn, (1, cfg.num_heads, longest,
                                    cfg.hidden_size // cfg.num_heads))
    print("[4] serve GPT-124M")
    gen = torch.Generator().manual_seed(1234)
    model = GPTForCausalLM(cfg, generator=gen).eval()
    reqs, k4, snap, wall = phase_serve(torch, model, prompts, max_new, pa,
                                       attn)
    print("[5] greedy cross-check against the forward")
    k1 = phase_check(torch, model, reqs, attn)

    k4_row["launches"] = k4
    k1_row["launches"] = k1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi: no output")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in (k4_row, k1_row)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
