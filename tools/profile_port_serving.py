#!/usr/bin/env python3
"""Where the time goes when paddle_tpu_torch serves GPT-124M on one card.

Runs the serving phase of chip_smoke.py (same model, seed and 16-request
workload) twice on the card: once plain, for the wall time, and once
under torch.profiler, for the device time by kernel class, the number
of kernels a decode step launches, and the device's idle share over the
run (one minus the union of kernel intervals over the span from the
first to the last kernel). Prints one line per figure and writes the
numbers and the top kernels to chiprun_out/profile_port_serving.json
(a git-ignored directory; the run's chrome trace is too large to keep).
``--slot`` serves through the slot-contiguous pool instead
(``ServingConfig(paged=False, max_len=1024)``, chip_smoke.py phase 15a)
and writes profile_port_serving_slot.json.

    python3 tools/profile_port_serving.py [--slot]
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def classify(name):
    n = name.lower()
    if "paged_decode_kernel" in n or "paged_decode_combine" in n:
        # the split chunks and the merge of their partials
        return "K4 paged decode attention"
    if "flash_fwd_" in n:
        # f32 (CUDA cores: flash_fwd_f32_kernel, the parent commit's
        # flash_fwd_kernel) or bf16 (tensor cores: flash_fwd_mma_kernel)
        return "K1 flash forward"
    if "flash_bwd_dq_" in n:
        # f32 (CUDA cores: flash_bwd_dq_f32_kernel, the parent commit's
        # flash_bwd_dq_kernel) or bf16 (tensor cores)
        return "K2 flash backward dQ"
    if "flash_bwd_dkv_" in n:
        return "K3 flash backward dK/dV"
    if "fused_ce_fwd_" in n:
        # f32 (CUDA cores: fused_ce_fwd_f32_kernel, the parent commit's
        # fused_ce_fwd_kernel) or bf16 (tensor cores: fused_ce_fwd_mma_
        # kernel), and the split merge (fused_ce_fwd_combine)
        return "K5 fused CE forward"
    if "fused_ce_bwd_" in n:
        # f32 (CUDA cores: fused_ce_bwd_f32_kernel, the parent commit's
        # fused_ce_bwd_kernel) or bf16 (tensor cores); the template's last
        # argument: true (K6, dx) or false (K7, dW)
        return ("K6 fused CE dx" if "true>" in n or "lb1e" in n
                else "K7 fused CE dW")
    if any(t in n for t in ("gemm", "gemv", "cutlass", "sm90_x", "cublas",
                            "nvjet")):
        return "matmul (cuBLAS)"
    if "layer_norm" in n or "layernorm" in n:
        return "layer norm"
    if "index" in n or "gather" in n or "scatter" in n:
        return "index / gather / scatter"
    if "softmax" in n or "reduce" in n or "argmax" in n:
        return "softmax / reductions"
    return "elementwise and copies"


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


LABELS = ("port/prefill", "port/decode")


def labelled(torch, fn, label, host):
    """``fn`` inside a profiler range, so the kernels it launches add up
    under ``label``; its host time (the call returns once its kernels
    are queued) accumulates in ``host[label]``."""
    def call(*args):
        t0 = time.perf_counter()
        with torch.profiler.record_function(label):
            out = fn(*args)
        n, t = host.get(label, (0, 0.0))
        host[label] = (n + 1, t + time.perf_counter() - t0)
        return out
    return call


def serve(torch, model, prompts, max_new, ServingEngine, knobs):
    """The smoke's serving phase; returns (engine, wall s, host time per
    program label)."""
    eng = ServingEngine(model, num_slots=8, block_size=16, async_depth=1,
                        **knobs)
    host = {}
    eng._prefill_fn = labelled(torch, eng._prefill_fn, LABELS[0], host)
    eng._decode_fn = labelled(torch, eng._decode_fn, LABELS[1], host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, n in zip(prompts[:8], max_new[:8]):
        eng.add_request(p, max_new_tokens=n)
    for _ in range(24):
        eng.step()
    for p, n in zip(prompts[8:], max_new[8:]):
        eng.add_request(p, max_new_tokens=n)
    eng.run()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0, host


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slot", action="store_true",
                    help="serve through the slot-contiguous pool")
    args = ap.parse_args()
    knobs = dict(paged=False, max_len=1024) if args.slot else {}
    import torch
    if not torch.cuda.is_available():
        print("profile_port_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import workload
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              TransformerLMConfig)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    cfg = TransformerLMConfig(dropout=0.0)
    model = GPTForCausalLM(
        cfg, generator=torch.Generator().manual_seed(1234)).eval()
    prompts, max_new = workload(cfg.vocab_size)
    serve(torch, model, prompts[:2], max_new[:2], ServingEngine,
          knobs)                                                 # warm-up

    walls = []
    for _ in range(3):
        eng, wall, host = serve(torch, model, prompts, max_new,
                                ServingEngine, knobs)
        walls.append(wall)
    snap = eng.metrics.snapshot()
    steps = snap["decode_steps"]
    print(f"plain runs: wall {', '.join(f'{w:.4f}' for w in walls)} s; "
          f"{snap['tokens_generated']} tokens, {steps} decode steps, "
          f"tokens/s {snap['tokens_per_sec']:.1f}, median TTFT "
          f"{snap['ttft_p50_ms']:.2f} ms")
    for label, (n, t) in host.items():
        print(f"  {label}: {n} calls, host {t / n * 1e6:.1f} us per call "
              f"(last plain run)")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, wall, _ = serve(torch, model, prompts, max_new,
                             ServingEngine, knobs)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in LABELS]
    if not kernels:
        print("profiler saw no device activity", file=sys.stderr)
        return 1
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = union_us(spans)
    by_class, by_name = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        c = classify(e.name)
        by_class[c] = by_class.get(c, 0.0) + d
        by_name[e.name] = by_name.get(e.name, 0.0) + d
    total = sum(by_class.values())
    print(f"profiled run: wall {wall:.4f} s, device window "
          f"{window / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle "
          f"share {1 - busy / window:.4f}; {len(kernels)} device "
          f"activities, {len(kernels) / steps:.1f} per decode step")
    for c, d in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {c:28s} {d / 1e3:10.3f} ms  {d / total:.4f} of device "
              f"time  {d / steps:9.2f} us per decode step")
    ranges = {}
    for row in prof.key_averages():
        if row.key in LABELS and row.cpu_time_total > 0:
            ranges[row.key] = {
                "calls": row.count,
                "host_us": row.cpu_time_total,
                "device_us": getattr(row, "device_time_total",
                                     getattr(row, "cuda_time_total", 0.0))}
            r = ranges[row.key]
            print(f"  {row.key}: {r['calls']} calls, device "
                  f"{r['device_us'] / r['calls']:.1f} us per call (kernels "
                  f"it launched); host under the profiler "
                  f"{r['host_us'] / r['calls']:.1f} us")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "profile_port_serving_slot.json" if args.slot \
        else "profile_port_serving.json"
    print(f"pool: {'slot-contiguous' if args.slot else 'paged'}")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0),
                   "plain_wall_s": walls, "profiled_wall_s": wall,
                   "decode_steps": steps, "snapshot": snap,
                   "device_window_us": window, "device_busy_us": busy,
                   "by_class_us": by_class, "ranges": ranges,
                   "top_kernels_us": top}, f, indent=1, default=str)
    for name, d in top:
        print(f"  top {d / 1e3:9.3f} ms  {name[:110]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
