"""Losses of the port (reference ``paddle_tpu/ops/nn_ops.py``).

The logits product before a loss is a plain large matmul that the
reference also leaves to XLA, so it stays ``torch.matmul`` /
``nn.Linear`` and no kernel is written for it.
"""
import torch.nn.functional as F


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
