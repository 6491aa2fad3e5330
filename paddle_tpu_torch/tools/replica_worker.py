"""One routable serving-engine replica process (a port of the reference's
``tests/router_replica_worker.py``), for the router drill
(:mod:`.router_drill`) and for any multi-process fleet.

An :class:`EngineGateway` steps the engine on its own thread and mounts
``POST /v1/generate`` (with ``/v1/prefill`` and ``/v1/import``) beside
the GET debug surface, so a parent routes real traffic over the wire and
may SIGKILL this process mid-request. Two POST routes of the worker's
own let the parent audit it:

* ``/v1/counts`` — the kernel launches (K4 and K1) and decode steps since
  the last reset (``{"reset": true}`` zeroes them after reading), read
  under the gateway's lock so the two agree;
* ``/v1/audit`` — the engine idle, every slot free, no block referenced
  and the paged pool's conservation audit passed.

Every worker builds the SAME model from one seeded CPU
``torch.Generator`` and then moves it to its device, so every replica
holds the same weights bit for bit (the router's journal replay relies
on it). On the card the kernels are loaded from the package's
``_build/``, which the parent builds before it starts any worker.

Prints ONE JSON ready-line ``{"port", "replica_id", "pid"}`` after its
warm-up, then sleeps until killed, or until its parent is gone.

    python -m paddle_tpu_torch.tools.replica_worker --replica-id r0 \\
        --device cpu --model tiny
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

MODELS = {
    # the reference worker's tiny GPT (tests/router_replica_worker.py)
    "tiny": dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=64, dropout=0.0),
    # GPT-124M at its published widths
    "gpt": dict(dropout=0.0),
}


def build_model(name, seed, device):
    """The seeded model every replica shares: weights drawn on the CPU
    from ``torch.Generator().manual_seed(seed)``, then put on
    ``device``."""
    from ..text.models import GPTForCausalLM, TransformerLMConfig
    cfg = TransformerLMConfig(**MODELS[name])
    return GPTForCausalLM(cfg, device=device, generator=torch.Generator()
                          .manual_seed(seed)).eval()


class _Counts:
    """Kernel launches and decode steps since the last reset."""

    def __init__(self, engine):
        from ..ops import attention, paged_attention
        self.engine = engine
        self.k4 = paged_attention.paged_decode_attention
        self.k1 = attention.flash_attention_forward
        self.reset()

    def reset(self):
        self.k4.launches = 0
        self.k1.launches = 0
        self.steps0 = self.engine.metrics.decode_steps

    def read(self):
        return {"k4": self.k4.launches, "k1": self.k1.launches,
                "decode_steps": self.engine.metrics.decode_steps
                - self.steps0,
                "num_layers": self.engine._model.cfg.num_layers}


def _audit(eng):
    out = {"pending": bool(eng.pending),
           "free_slots": eng.pool.free_count,
           "num_slots": eng.config.num_slots,
           "live_blocks": getattr(eng.pool, "live_blocks", 0),
           "conserved": True, "detail": None}
    if eng.paged:
        try:
            eng.pool.check_conservation()
        except AssertionError as e:
            out["conserved"], out["detail"] = False, str(e)[:300]
    out["ok"] = (not out["pending"] and out["conserved"]
                 and out["free_slots"] == out["num_slots"]
                 and out["live_blocks"] == 0)
    return out


def main(argv=None):
    from ..serving import ServingEngine
    from ..serving.router import EngineGateway
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replica-id", required=True)
    ap.add_argument("--role", default="monolithic",
                    choices=("monolithic", "prefill", "decode"))
    ap.add_argument("--paged", action="store_true",
                    help="the paged pool (any non-monolithic role uses it)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--model", default="tiny", choices=sorted(MODELS))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--num-slots", type=int, default=2)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's CPU threads (tests pin 1)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)

    model = build_model(args.model, args.seed, args.device)
    vocab = model.cfg.vocab_size
    paged = args.role != "monolithic" or args.paged
    knobs = {"block_size": args.block_size} if args.block_size else {}
    eng = ServingEngine(model, device=args.device,
                        num_slots=args.num_slots, bucket_min=8,
                        paged=paged, role=args.role,
                        replica_id=args.replica_id, slo_ttft_ms=60000.0,
                        **knobs)
    gateway = EngineGateway(eng)
    # warm-up before declaring ready, as the reference's: a lone prompt,
    # then a pair admitted as one group-2 prefill, and the handoff path
    rs = np.random.RandomState(0)
    solo = gateway.submit(rs.randint(0, vocab, (5,)).astype(np.int64),
                          max_new_tokens=4)
    gateway.wait(solo, timeout=300.0)
    with gateway._lock:
        pair = [gateway.submit(rs.randint(0, vocab, (6,)).astype(np.int64),
                               max_new_tokens=4) for _ in range(2)]
    for req in pair:
        gateway.wait(req, timeout=300.0)
    if eng.paged:
        with gateway._lock:
            eng.warmup_kv_handoff()
    eng.declare_warmup()
    counts = _Counts(eng)

    def handle_counts(body):
        with gateway._lock:
            out = counts.read()
            if body.get("reset"):
                counts.reset()
        return dict(out, replica_id=eng.replica_id)

    def handle_audit(body):
        with gateway._lock:
            return dict(_audit(eng), replica_id=eng.replica_id)

    handle = eng.serve_metrics(
        port=args.port,
        post_routes={"/v1/generate": gateway.handle_generate,
                     "/v1/prefill": gateway.handle_prefill,
                     "/v1/import": gateway.handle_import,
                     "/v1/counts": handle_counts,
                     "/v1/audit": handle_audit},
        lock=gateway._lock)
    print(json.dumps({"port": handle.port, "replica_id": eng.replica_id,
                      "pid": os.getpid()}), flush=True)
    parent = os.getppid()
    while os.getppid() == parent:
        time.sleep(0.1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
