"""Device resolution for the port's entry points.

``None`` means the card: entry points run on ``cuda`` unless the caller
asks for the CPU explicitly. Without CUDA and without an explicit
``device="cpu"`` they raise; they never carry on quietly on the CPU.
"""
import torch


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises when CUDA is absent); anything else
    goes through ``torch.device`` and a ``cuda`` request is checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # name the card, so it compares equal to a tensor's device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
