"""Random generators (reference ``paddle_tpu/core/rng.py``).

The port draws random numbers only from explicit ``torch.Generator``s,
never from torch's global generator: a caller passes one, or the port
uses its default generator for the tensor's device, one per device,
which ``seed(n)`` (``paddle.seed``) reseeds. The reference's bits come
from ``jax.random`` and cannot be matched, so a seed gives determinism,
not the reference's numbers.
"""
import torch

from .device import resolve_device

_seed = 0
_generators = {}   # torch.device -> torch.Generator


def default_generator(device=None):
    """The port's generator for ``device`` (``paddle.default_generator``;
    None: the current device, the card unless ``set_device`` says
    otherwise), made on first use from the last ``seed`` (0 before
    any)."""
    if isinstance(device, torch.device) and device.type == "meta":
        return None     # a lazy op's shapes inferred on meta: no draw
    from . import lazy
    if lazy.enabled() and lazy.pending():
        # pending deferred draws come first, as in immediate order
        lazy.flush()
    dev = resolve_device(device)
    gen = _generators.get(dev)
    if gen is None:
        gen = _generators[dev] = torch.Generator(device=dev)
        gen.manual_seed(_seed)
    return gen


def seed(s):
    """``paddle.seed``: reseed every device's default generator with
    ``s``; returns the CPU one."""
    global _seed
    from . import lazy
    lazy.flush()        # pending draws use the generators as they were
    _seed = int(s)
    for gen in _generators.values():
        gen.manual_seed(_seed)
    return default_generator("cpu")


def get_state(device=None):
    """The state of the port's default generator for ``device`` (None:
    the current device; raises without CUDA unless that is the CPU), a
    CPU ``uint8`` tensor as ``torch.Generator.get_state`` gives it.
    Pending lazy draws run first."""
    from . import lazy
    lazy.flush()
    return default_generator(device).get_state()


def set_state(state, device=None):
    """Set the port's default generator for ``device`` to ``state`` (from
    ``get_state``): the draws after it repeat the ones after that
    ``get_state``."""
    from . import lazy
    lazy.flush()
    default_generator(device).set_state(state)
