"""``paddle.autograd`` (a port of ``paddle_tpu/autograd/__init__.py``):
``PyLayer`` custom autograd, ``backward`` and ``paddle.grad``, all on
torch's autograd.

A ``PyLayer`` subclass becomes a ``torch.autograd.Function`` of its own:
its ``forward(ctx, ...)`` runs without recording, on Tensors, and its
``backward(ctx, *grads)`` runs without recording too, so under
``create_graph`` the grads it returns are constants: the chain stops
there, as in the reference, whose PyLayer needs explicit double-grad
support. Both run their ops at once (not into the lazy graph), and each
call counts in ``core.engine.host_callbacks``: a step through a PyLayer
is not captured by lazy eager, whose replay would skip them.
"""
import torch

from ..core import lazy
from ..core.dispatch import enable_grad, is_grad_enabled, no_grad  # noqa: F401
from ..core.engine import host_callbacks, run_backward, run_grad
from ..core.tensor import Tensor, as_torch


class PyLayerContext:
    def __init__(self):
        self._saved = []
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


def _function_of(layer):
    """The ``torch.autograd.Function`` of PyLayer subclass ``layer``,
    made on its first ``apply``."""
    fn = layer.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Function(torch.autograd.Function):
        @staticmethod
        def forward(tctx, spec, *values):
            args, kwargs, slots = spec
            full = list(args)
            for i, v in zip(slots, values):
                full[i] = Tensor._wrap(v)
            ctx = PyLayerContext()
            tctx.paddle_ctx = ctx
            host_callbacks[0] += 1
            with lazy.suspended():
                out = layer.forward(ctx, *full, **kwargs)
            multi = isinstance(out, (tuple, list))
            outs = list(out) if multi else [out]
            tctx.multi = multi
            res = tuple(as_torch(o) for o in outs)
            return res if multi else res[0]

        @staticmethod
        def backward(tctx, *grads):
            host_callbacks[0] += 1
            with torch.no_grad(), lazy.suspended():
                gin = layer.backward(tctx.paddle_ctx,
                                     *[Tensor._wrap(g) for g in grads])
            gins = gin if isinstance(gin, (tuple, list)) else (gin,)
            return (None,) + tuple(None if g is None else as_torch(g)
                                   for g in gins)

    _Function.__name__ = f"PyLayer_{layer.__name__}"
    layer._torch_function = _Function
    return _Function


class PyLayerMeta(type):
    """Reference autograd/__init__.py:39: a metaclass that refuses to
    instantiate (``PyLayer`` is used through ``apply``); defined, and as
    there, not set on ``PyLayer``."""

    def __call__(cls, *args, **kwargs):
        raise RuntimeError("PyLayer is not instantiable; use .apply()")


class PyLayer:
    """User subclasses define ``@staticmethod forward(ctx, ...)`` and
    ``backward(ctx, *grads)``; call ``.apply(...)``."""

    @classmethod
    def apply(cls, *args, **kwargs):
        slots = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        spec = ([None if isinstance(a, Tensor) else a for a in args],
                kwargs, slots)
        out = _function_of(cls).apply(spec,
                                      *[args[i]._value for i in slots])
        if isinstance(out, tuple):
            return tuple(Tensor._wrap(o) for o in out)
        return Tensor._wrap(out)

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError


def backward(tensors, grad_tensors=None, retain_graph=False):
    ts = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    gs = grad_tensors if isinstance(grad_tensors, (list, tuple)) else \
        [grad_tensors] * len(ts)
    for t, g in zip(ts, gs):
        run_backward(t, g, retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: grads of ``outputs`` with respect to ``inputs``,
    without touching any ``.grad`` (reference: partial_grad_engine.cc).
    ``retain_graph`` defaults to ``create_graph``; an input the outputs
    do not reach raises RuntimeError unless ``allow_unused``."""
    outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    gouts = grad_outputs if isinstance(grad_outputs, (list, tuple)) else \
        [grad_outputs] * len(outs)
    retain = retain_graph if retain_graph is not None else create_graph
    res = run_grad(list(outs), list(ins), list(gouts),
                   retain_graph=bool(retain),
                   create_graph=bool(create_graph))
    out = []
    for t, g in zip(ins, res):
        if g is None:
            if not allow_unused:
                raise RuntimeError(f"input {t.name} unused in graph "
                                   "(pass allow_unused=True)")
            out.append(None)
        else:
            out.append(Tensor._wrap(g, name=t.name + "@GRAD"))
    return out
