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
and the flash-attention forward kernel; training of the GPT with an
untied head (``model(ids, labels=labels)``, ``loss.backward()``,
``optimizer.AdamW``, ``nn.ClipGradByGlobalNorm``, ``optimizer.lr``)
with the flash-attention backward kernels.
"""
from . import nn, optimizer
from .core.device import resolve_device

__all__ = ["nn", "optimizer", "resolve_device"]
