#!/usr/bin/env python3
"""Time the fused cross-entropy kernels (K5 forward, K6 dx, K7 dW) of
several fused_ce.cu sources in one call on one card, in bf16 or f32.

    python3 tools/ab_fused_ce.py [--f32] [SOURCE.cu[@TILE:PER_SM] ...]

Builds the tree's own paddle_tpu_torch/csrc/fused_ce.cu and every SOURCE
(each one nvcc, all started together; each must keep the C interface of
fused_ce_forward / fused_ce_backward_dx / fused_ce_backward_dw). Each K5
runs with its own vocab split: the tree's with the wrapper's rule
(``_FWD_SPLIT``), a SOURCE with ``@TILE:PER_SM`` where its K5 walks
other tiles or aims at other blocks an SM (the first f32 K5, 64-row tiles:
``@64:4``), else with the wrapper's. It prints ptxas's registers and
spills for each kernel of the dtype, then for each source: K5's loss and
LSE against the plain forward, and K6 and K7 against the plain backward
(bf16: with d rounded to bf16; f32: d kept f32), relative to the largest
grad, at ragged shapes and at the flagship's T = 8192, H = 768, V =
50304, and the mean time of each kernel there over 30 calls (5 in f32;
CUDA events, the L2 flushed before each) with TFLOP/s and the median SM
clock and power draw that nvidia-smi read every 100 ms meanwhile (the FMA
peak scales with the clock). Sources are run in turn inside each shape,
so their times compare; times of two calls do not.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [(65, 13, 300), (77, 800, 5000), (1000, 200, 1234), (1, 64, 7),
          (8192, 768, 50304)]
ARGTYPES = {
    "fused_ce_forward": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "fused_ce_backward_dx": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
ARGTYPES["fused_ce_backward_dw"] = ARGTYPES["fused_ce_backward_dx"]
KERNELS = {"bfloat16": ("fused_ce_fwd_mma_kernel", "fused_ce_bwd_mma_kernel"),
           "float32": ("fused_ce_fwd_f32_kernel", "fused_ce_fwd_kernel",
                       "fused_ce_bwd_f32_kernel")}


def sampled(fn):
    """fn()'s result and the median (SM clock MHz, power draw W) of
    nvidia-smi's readings every 100 ms while it ran (None without
    readings)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        out = fn()
    finally:
        proc.terminate()
        lines, _ = proc.communicate(timeout=60)
    rows = [tuple(float(f) for f in ln.split(","))
            for ln in lines.splitlines() if ln.count(",") == 1]
    if not rows:
        return out, None
    return out, tuple(float(sorted(c)[len(c) // 2]) for c in zip(*rows))


def build(_build, sources, out_dir, kernels):
    """{name: {symbol: ctypes function}}, one nvcc per source at once."""
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, f"{i}.so"), path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for i, (name, path) in enumerate(sources.items())}
    fns = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lines = log.splitlines()
        for j, line in enumerate(lines):
            kernel = [k for k in kernels if k in line and "Compiling" in line]
            if kernel:
                info = [x.strip() for x in lines[j + 1:j + 5]
                        if "registers" in x or "spill" in x]
                print(f"{name} {kernel[0]}: {'; '.join(info)}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{i}.so"))
        fns[name] = {}
        for sym, argtypes in ARGTYPES.items():
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name][sym] = fn
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        print("ab_fused_ce: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_ce as tce
    f32 = "--f32" in sys.argv[1:]
    dtype = "float32" if f32 else "bfloat16"
    sources = {"tree": str(_build.CSRC / "fused_ce.cu")}
    splits = {"tree": None}    # None: the wrapper's _FWD_SPLIT
    for arg in sys.argv[1:]:
        if arg == "--f32":
            continue
        path, _, split = arg.partition("@")
        name = os.path.basename(path)
        sources[name] = path
        splits[name] = tuple(map(int, split.split(":"))) if split else None
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        fns = build(_build, sources, d, KERNELS[dtype])
        g = torch.Generator(device="cuda").manual_seed(9)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for t, h, v in SHAPES:
            x, w, labels, gg = cs.ce_case(torch, t, h, v, dtype, g)
            rloss, lse = tce.fused_linear_cross_entropy_plain(
                x.float(), w.float(), labels)
            ref = tce.fused_linear_cross_entropy_backward_plain(
                x.float(), w.float(), labels, lse, gg,
                d_dtype=None if f32 else torch.bfloat16)
            loss, klse = torch.empty_like(lse), torch.empty_like(lse)
            dx, dw = torch.empty_like(x), torch.empty_like(w)
            stream = torch.cuda.current_stream().cuda_stream
            for name, lib in fns.items():
                nsplit, per = tce.vocab_split(
                    t, v, *(splits[name] or tce._FWD_SPLIT[x.dtype]), sms)
                part = torch.empty((3, nsplit, t), device="cuda")
                calls = {
                    "K5": lambda: lib["fused_ce_forward"](
                        x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                        part.data_ptr(), loss.data_ptr(), klse.data_ptr(), t,
                        v, h, nsplit, per, -100, int(not f32), 1, stream),
                    "K6": lambda: lib["fused_ce_backward_dx"](
                        x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                        lse.data_ptr(), gg.data_ptr(), dx.data_ptr(), t, v,
                        h, -100, int(not f32), 1, stream),
                    "K7": lambda: lib["fused_ce_backward_dw"](
                        x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                        lse.data_ptr(), gg.data_ptr(), dw.data_ptr(), t, v,
                        h, -100, int(not f32), 1, stream)}
                for kname, call in calls.items():
                    if call():
                        raise RuntimeError(f"{name} {kname}: launch failed")
                torch.cuda.synchronize()
                errs = [max((loss - rloss).abs().max().item(),
                            (klse - lse).abs().max().item())]
                for got, want in zip((dx, dw), ref):
                    top = want.abs().max().item()
                    err = (got.float() - want).abs().max().item()
                    errs.append(err / top if top else err)
                line = [f"[T={t}, H={h}, V={v}] {name}: K5 loss/LSE err "
                        f"{errs[0]:.3e}, K6 {errs[1]:.3e} and K7 "
                        f"{errs[2]:.3e} of the largest grad"]
                if t == SHAPES[-1][0]:
                    for kname, call in calls.items():
                        ms, clk = sampled(lambda: cs.time_ms(
                            torch, call, iters=5 if f32 else 30))
                        flops = (2.0 if kname == "K5" else 4.0) * t * v * h
                        line.append(f"{kname} {ms:.3f} ms "
                                    f"({flops / ms / 1e9:.1f} TFLOP/s"
                                    + (f"; SM {clk[0]:.0f} MHz, {clk[1]:.1f}"
                                       " W" if clk else "") + ")")
                print(", ".join(line), flush=True)
            del x, w, labels, gg, rloss, lse, ref, part, dx, dw
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
