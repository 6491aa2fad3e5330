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

``RecomputeFunction`` is the reference's form of the same (:16, Paddle's
``fleet/utils/recompute.py:63``): a ``PyLayer`` over the eager core's
Tensors whose forward runs ``run_function`` without recording and whose
backward runs it again with grads, the generators and the cast put back,
and takes the grads of its Tensor inputs. ``recompute`` keeps torch's
checkpoint, which also takes plain torch tensors.
"""
import torch
from torch.utils.checkpoint import checkpoint

from ..amp.auto_cast import amp_state, resume
from ..autograd import PyLayer
from ..core import rng
from ..core.tensor import Tensor


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


class RecomputeFunction(PyLayer):
    """``RecomputeFunction.apply(run_function, preserve_rng_state,
    *args)``."""

    @staticmethod
    def forward(ctx, run_function, preserve_rng_state, *args):
        ctx.run_function = run_function
        ctx.gens = [rng.default_generator(d) for d in _devices(args)] \
            if preserve_rng_state else []
        ctx.states = [g.get_state() for g in ctx.gens]
        ctx.cast = amp_state()
        ctx.inputs = args
        with torch.no_grad():
            return run_function(*args)

    @staticmethod
    def backward(ctx, *grads):
        detached = [Tensor._wrap(a._value.detach().requires_grad_(
            not a.stop_gradient)) if isinstance(a, Tensor) else a
            for a in ctx.inputs]
        left = [g.get_state() for g in ctx.gens]
        for g, s in zip(ctx.gens, ctx.states):
            g.set_state(s)
        try:
            with torch.enable_grad(), resume(ctx.cast):
                outputs = ctx.run_function(*detached)
        finally:
            for g, s in zip(ctx.gens, left):
                g.set_state(s)
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        pairs = [(o._value, g._value) for o, g in zip(outs, grads)
                 if isinstance(o, Tensor) and o._value.requires_grad]
        leaves = [d._value for d in detached
                  if isinstance(d, Tensor) and d._value.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], leaves,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and leaves else [None] * len(leaves))
        # one grad a Tensor input of apply(), None where it takes none
        results = [(next(got) if d._value.requires_grad else None)
                   for d in detached if isinstance(d, Tensor)]
        return tuple(results) if len(results) > 1 else results[0]


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
