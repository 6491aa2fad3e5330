#!/usr/bin/env python3
"""Time chip_smoke.py's serving phase for one checkout of the port.

    python3 tools/ab_port_serving.py TREE

TREE is the root of a checkout (the repo itself, or one unpacked with
``git archive`` into a git-ignored directory); its ``paddle_tpu_torch``
and ``chip_smoke.py`` are the ones imported. Builds the kernels, serves
the smoke's 16 requests once to warm up, then four more times, and
prints the tree's name with each run's wall seconds and tokens/s.

To compare two versions, run both in one call on one card, alternating:

    for t in A B B A A B; do python3 tools/ab_port_serving.py trees/$t; done

The host's speed varies from call to call by more than most changes
move these numbers, so only runs of the same call compare.
"""
import os
import sys
import time


def main():
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_port_serving: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
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

    def serve():
        eng = ServingEngine(model, num_slots=8, block_size=16,
                            async_depth=1)
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
        return (time.perf_counter() - t0,
                eng.metrics.snapshot()["tokens_per_sec"])

    serve()
    runs = [serve() for _ in range(4)]
    print(os.path.basename(root),
          [f"{w:.4f}s/{t:.0f}tps" for w, t in runs], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
