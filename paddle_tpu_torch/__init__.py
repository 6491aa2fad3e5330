"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package computes
the same functions with PyTorch for plain tensor code and hand-written
CUDA C++ kernels (``csrc/``, built for ``sm_90a`` at first use) where
the reference had a Pallas TPU kernel. It never imports ``jax`` or
``paddle_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper computes its plain PyTorch version.

Ported so far: GPT-124M paged serving (``serving.ServingEngine`` over
``text.models.GPTForCausalLM``) with the paged decode-attention kernel
and the flash-attention forward kernel, and the model's own
``generate()`` (greedy, top-k sampling, beam search); training of the
GPT, tied head (the default) or untied (``model(ids, labels=labels)``,
``loss.backward()``, every optimizer of ``optimizer`` with
``regularizer`` objects, ``state_dict`` and ``minimize``, the clips of
``nn``, ``optimizer.lr``), with per-block recompute, under
``amp.auto_cast`` O1/O2 with ``amp.GradScaler`` or in f32, with the
flash-attention backward kernels and the fused linear cross-entropy
kernels; ``seed`` seeds the dropout generators.
"""
from . import amp, nn, optimizer, regularizer
from .core.device import resolve_device
from .core.rng import seed

__all__ = ["amp", "nn", "optimizer", "regularizer", "resolve_device",
           "seed"]
