"""Activation recompute (a port of
``paddle_tpu/distributed/utils_recompute.py``; ``fleet.utils.recompute``).

``recompute(function, *args)`` keeps only the inputs of ``function`` in
the forward and runs it again in the backward, through
``torch.utils.checkpoint`` (non-reentrant), with what the first run saw
put back for the second: the port's default generators of the
arguments' devices (``core.rng``, which ``paddle_tpu_torch.seed`` seeds
and dropout draws from without an explicit generator) at their state
before the forward, when ``preserve_rng_state`` (the reference's
default, :17-73), and the ``amp.auto_cast`` state of the forward, which
the backward would otherwise run outside of.
"""
import torch
from torch.utils.checkpoint import checkpoint

from ..amp.auto_cast import amp_state, resume
from ..core import rng


def _devices(args):
    devs = []
    for a in args:
        t = getattr(a, "_value", a)
        if isinstance(t, torch.Tensor) and t.device not in devs:
            devs.append(t.device)
    return devs


def _requires_grad(a):
    t = getattr(a, "_value", a)
    return isinstance(t, torch.Tensor) and t.requires_grad


def recompute(function, *args, **kwargs):
    """``fleet.utils.recompute(fn, *args, preserve_rng_state=True)``."""
    preserve = kwargs.pop("preserve_rng_state", True)
    if kwargs:
        raise ValueError(f"unexpected kwargs {list(kwargs)}")
    if not torch.is_grad_enabled() or not any(map(_requires_grad, args)):
        return function(*args)
    gens = [rng.default_generator(d) for d in _devices(args)] \
        if preserve else []
    states = [g.get_state() for g in gens]
    cast = amp_state()
    runs = [0]

    def run(*a):
        runs[0] += 1
        if runs[0] == 1:
            return function(*a)
        # the recomputation: the forward's generator states and cast
        left = [g.get_state() for g in gens]
        for g, s in zip(gens, states):
            g.set_state(s)
        try:
            with resume(cast):
                return function(*a)
        finally:
            for g, s in zip(gens, left):
                g.set_state(s)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve)
