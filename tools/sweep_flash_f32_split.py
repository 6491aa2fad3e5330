#!/usr/bin/env python3
"""Time the f32 flash-attention forward (K1, csrc/flash_fwd.cu) at each key
split on one card, to choose the split from the shape.

    python3 tools/sweep_flash_f32_split.py

The f32 kernel holds 64 / KS query rows a block, with KS warps (1, 2 or
4; 1 or 2 at head_dim 128) sharing each 16 rows and splitting the key
tiles. For causal shapes [B, 12, S, 64] and [B, 4, S, 128] it prints,
for each KS, the mean time of one call over 30 (CUDA events, the 50 MB
L2 flushed before each) and the share of the f32 bound, beside the KS
that flash_attention_forward picks (f32_key_split) and the 64-row
blocks' waves over the card's SMs. The KS are timed in turn inside each
shape, so their times compare; times of two calls do not.
"""
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [(1, 12, 64, 64), (1, 12, 256, 64), (1, 12, 333, 64),
          (1, 12, 661, 64), (1, 12, 1024, 64), (2, 12, 661, 64),
          (2, 12, 1024, 64), (4, 12, 1024, 64), (8, 12, 1024, 64),
          (1, 4, 661, 128), (4, 4, 1024, 128), (8, 12, 1024, 128)]


def main():
    import torch

    from chip_smoke import bound, time_ms
    from paddle_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    split = _build.function(
        "flash_fwd", "flash_attention_forward_f32_split",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    pick = _build.function("flash_fwd", "flash_attention_forward_f32_key_split",
                           [ctypes.c_int] * 3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs")
    for b, h, s, d in SHAPES:
        q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda")
                   for _ in range(3))
        o = torch.empty_like(q)
        lse = torch.empty(b, h, 1, s, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run(ks):
            err = split(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), b * h, s, d, d ** -0.5, 1, ks, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        pairs = b * h * s * (s + 1) // 2
        b_ms, _ = bound(4 * b * h * s * d * 4 + b * h * s * 4, 4 * d * pairs,
                        "float32")
        row = []
        for ks in (1, 2, 4) if d == 64 else (1, 2):
            ms = time_ms(torch, lambda: run(ks))
            row.append(f"KS={ks} {ms:.4f} ms ({b_ms / ms:.3f} of bound)")
        waves = b * h * -(-s // 64) / sms
        print(f"[{b},{h},{s},{d}] causal: 64-row blocks {waves:.2f} waves; "
              + "; ".join(row) + f"; bound {b_ms:.4f} ms; the wrapper takes "
              f"KS={pick(b * h, s, d)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
