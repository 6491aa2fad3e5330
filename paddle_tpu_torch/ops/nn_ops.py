"""Losses and dropout of the port (reference ``paddle_tpu/ops/nn_ops.py``).

The logits product before a loss is a plain large matmul that the
reference also leaves to XLA, so it stays ``torch.matmul`` /
``nn.Linear`` and no kernel is written for it.
"""
import torch
import torch.nn.functional as F

from ..amp.auto_cast import cast_inputs, op_body
from ..core import rng


def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator=None):
    """Reference ``dropout`` (nn_ops.py:719-728): in training keep each
    element with probability ``1 - p`` (``upscale_in_train`` divides the
    kept ones by it); out of training return ``x``, or with
    ``downscale_in_infer`` ``x * (1 - p)``. The mask is drawn from
    ``generator``, a ``torch.Generator`` on x's device, or the port's
    default generator for that device (``paddle_tpu_torch.seed``), never
    from torch's global generator."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * 0.0
    (x,) = cast_inputs("dropout", x)
    with op_body():
        gen = generator if generator is not None \
            else rng.default_generator(x.device)
        keep = 1.0 - p
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        kept = x / keep if mode == "upscale_in_train" else x
        return torch.where(mask, kept, torch.zeros_like(x))


def cross_entropy(input, label, ignore_index=-100,  # noqa: A002
                  reduction="mean"):
    """Hard-label softmax cross-entropy over the last axis of ``input``
    ``[N, C]`` (reference ``cross_entropy``, nn_ops.py:872-899). Rows
    whose label is ``ignore_index`` lose 0. ``"mean"`` divides the sum by
    ``max(n_valid, 1e-12)``, so a batch with every row ignored gives a
    loss of 0 and zero grads, where ``F.cross_entropy``'s own mean gives
    NaN."""
    label = label.long()
    if reduction == "none":
        return F.cross_entropy(input, label, ignore_index=ignore_index,
                               reduction="none")
    total = F.cross_entropy(input, label, ignore_index=ignore_index,
                            reduction="sum")
    if reduction == "sum":
        return total
    if reduction != "mean":
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    n_valid = (label != ignore_index).sum().to(total.dtype)
    return total / n_valid.clamp(min=1e-12)
