#!/usr/bin/env python3
"""Where the time goes when paddle_tpu_torch trains GPT-124M on one card.

By default the reference's flagship step, chip_smoke.py phase 10 (the
default tied head through the fused cross-entropy K5-K7, batch 8 x seq
1024, dropout 0, AdamW(1e-4, weight_decay 0.01), the forward under
amp.auto_cast(level="O1", dtype="bfloat16")); with --untied-f32 the step
of phase 7 (untied head, f32 without TF32, AdamW with
ClipGradByGlobalNorm(1.0)); with --tied-f32 the step of phase 11 (the
flagship's step without auto_cast: f32 without TF32, the tied head through
the f32 K5-K7). Random weights from a seeded generator. Two
warm-up steps, three plain steps for the wall time and the host time of
each part of the step (forward, backward, optimizer), two steps under
torch.profiler for the device time by kernel class and the device's idle
share (one minus the union of kernel intervals over the span from the
first to the last kernel), and two more with a device sync closing each
part, so that every kernel falls inside its part's host range: device
busy time, host range and kernel classes per part. Prints one line per figure
and writes the numbers and the top kernels to
chiprun_out/profile_port_training.json (profile_port_training_untied_f32.json
with --untied-f32, profile_port_training_tied_f32.json with --tied-f32; a
git-ignored directory).

    python3 tools/profile_port_training.py [--untied-f32 | --tied-f32]
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

from profile_port_serving import classify, union_us  # noqa: E402

PARTS = ("train/forward", "train/backward", "train/optimizer")


def step(torch, model, opt, ids, host, sync=False, amp=None):
    """One step of the reference's loop, each part in a profiler range
    (closed by a device sync when ``sync``), the forward under
    ``amp.auto_cast`` O1 bf16 when ``amp`` is given; the host time of
    each part accumulates in ``host``."""
    def part(label, fn):
        t0 = time.perf_counter()
        with torch.profiler.record_function(label):
            out = fn()
            if sync:
                torch.cuda.synchronize()
        host[label] = host.get(label, 0.0) + time.perf_counter() - t0
        return out

    def forward():
        if amp is None:
            return model(ids, labels=ids)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(ids, labels=ids)

    loss = part(PARTS[0], forward)
    part(PARTS[1], loss.backward)

    def update():
        opt.step()
        opt.clear_grad()
    part(PARTS[2], update)
    return loss


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_port_training: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import amp as amp_mod
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              TransformerLMConfig)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    untied = "--untied-f32" in sys.argv[1:]
    tied_f32 = "--tied-f32" in sys.argv[1:]
    cfg = TransformerLMConfig(tie_embeddings=not untied, dropout=0.0)
    model = GPTForCausalLM(
        cfg, generator=torch.Generator().manual_seed(1234)).train()
    opt = optimizer.AdamW(
        1e-4, parameters=model.named_parameters(), weight_decay=0.01,
        grad_clip=nn.ClipGradByGlobalNorm(1.0) if untied else None)
    amp = None if untied or tied_f32 else amp_mod
    config = ("untied_f32" if untied else "tied_f32" if tied_f32
              else "tied_o1_bf16")
    print("config: " + {
        "untied_f32": "untied head, f32, global-norm clip",
        "tied_f32": "tied head (f32 K5-K7), f32, no clip",
        "tied_o1_bf16": "tied head (K5-K7), AMP O1 bf16, no clip"}[config])
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, cfg.max_seq_len)).astype(np.int64)).cuda()
    for _ in range(2):
        step(torch, model, opt, ids, {}, amp=amp)
    torch.cuda.synchronize()

    walls, host = [], {}
    for _ in range(3):
        t0 = time.perf_counter()
        step(torch, model, opt, ids, host, amp=amp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"plain steps: wall {', '.join(f'{w * 1e3:.2f}' for w in walls)}"
          f" ms; {ids.numel() / np.median(walls):.1f} tokens/s")
    for label in PARTS:
        print(f"  {label}: host {host[label] / 3 * 1e3:.2f} ms per step "
              "(until its kernels are queued)")

    from torch.profiler import ProfilerActivity, profile

    def profiled(sync):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                step(torch, model, opt, ids, {}, sync, amp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in PARTS]
        ranges = [e for e in events if e.name in PARTS
                  and e.device_type == torch.autograd.DeviceType.CPU]
        if not kernels:
            raise RuntimeError("profiler saw no device activity")
        return wall, kernels, ranges

    n_prof = 2
    wall, kernels, _ = profiled(False)
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
    print(f"profiled {n_prof} steps: wall {wall * 1e3:.2f} ms, device window"
          f" {window / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle "
          f"share {1 - busy / window:.4f}; {len(kernels) / n_prof:.0f} "
          f"device activities per step")
    for c, d in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {c:28s} {d / n_prof / 1e3:9.3f} ms per step  "
              f"{d / total:.4f} of device time")

    # parts: each kernel belongs to the host range (closed by a sync)
    # that its start falls in
    _, kernels, ranges = profiled(True)
    parts = {}
    for label in PARTS:
        own = [r for r in ranges if r.name == label]
        ks = [e for e in kernels if any(
            r.time_range.start <= e.time_range.start <= r.time_range.end
            for r in own)]
        sp = [(e.time_range.start, e.time_range.end) for e in ks]
        cls = {}
        for e in ks:
            c = classify(e.name)
            cls[c] = cls.get(c, 0.0) + e.time_range.end - e.time_range.start
        host_us = sum(r.time_range.end - r.time_range.start for r in own)
        parts[label] = {"kernels": len(ks) / n_prof,
                        "busy_us": union_us(sp) / n_prof,
                        "host_range_us": host_us / n_prof,
                        "by_class_us": {c: d / n_prof for c, d in cls.items()}}
        p = parts[label]
        print(f"  {label}: {p['kernels']:.0f} kernels, device busy "
              f"{p['busy_us'] / 1e3:.3f} ms of a {p['host_range_us'] / 1e3:.3f}"
              f" ms range (sync-closed) per step; " + ", ".join(
                  f"{c} {d / 1e3:.3f}" for c, d in sorted(
                      p["by_class_us"].items(), key=lambda kv: -kv[1])[:4]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    for name, d in top:
        print(f"  top {d / n_prof / 1e3:9.3f} ms/step  {name[:100]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "profile_port_training" + ("" if config == "tied_o1_bf16"
                                      else "_" + config)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "card": card,
                   "config": config,
                   "plain_step_wall_s": walls, "profiled_steps": n_prof,
                   "profiled_wall_s": wall, "device_window_us": window,
                   "device_busy_us": busy, "by_class_us": by_class,
                   "parts": parts, "top_kernels_us": top}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
