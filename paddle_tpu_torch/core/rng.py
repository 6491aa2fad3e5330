"""Random generators (reference ``paddle_tpu/core/rng.py``).

The port draws random numbers only from explicit ``torch.Generator``s,
never from torch's global generator: a caller passes one, or the port
uses its default generator for the tensor's device, one per device,
which ``seed(n)`` (``paddle.seed``) reseeds. The reference's bits come
from ``jax.random`` and cannot be matched, so a seed gives determinism,
not the reference's numbers.
"""
import torch

_seed = 0
_generators = {}   # torch.device -> torch.Generator


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_generator(device="cpu"):
    """The port's generator for ``device``, made on first use from the
    last ``seed`` (0 before any)."""
    dev = _key(device)
    gen = _generators.get(dev)
    if gen is None:
        gen = _generators[dev] = torch.Generator(device=dev)
        gen.manual_seed(_seed)
    return gen


def seed(s):
    """``paddle.seed``: reseed every device's default generator with
    ``s``; returns the CPU one."""
    global _seed
    _seed = int(s)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    return default_generator("cpu")
