"""Optimizer base (reference ``paddle_tpu/optimizer/optimizer.py:22-125``).

The training loop is the reference's, in user code::

    loss = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.clear_grad()

``step()`` runs under ``torch.no_grad()`` in the reference's order: the
grad clip first (it returns new grads and leaves ``p.grad`` as it is),
then one update per parameter, which writes the parameter and its f32
state in place (the reference returned new arrays).

The learning rate is a Python float rounded to f32, as the reference's
f32 learning-rate tensor holds it; an ``LRScheduler`` writes into it.
Inside an ``amp.auto_cast`` the update runs uncast, like the body of a
port op.
"""
import torch

from ..amp.auto_cast import op_body
from .lr import LRScheduler


def _f32(x):
    return float(torch.tensor(float(x), dtype=torch.float32))


class Optimizer:
    """``parameters``: tensors (``model.parameters()``) or ``(name,
    tensor)`` pairs (``model.named_parameters()``); a tensor without a
    name is called ``param_<i>`` by its place in the list. Only
    parameters with ``requires_grad`` and a grad are updated.
    ``weight_decay``: a float is L2 decay coupled into the grad;
    regularizer objects are not ported."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters must be given (pass "
                             "model.parameters() or model.named_parameters())")
        self._params = []
        for i, entry in enumerate(parameters):
            if isinstance(entry, tuple):
                self._params.append(entry)
            else:
                self._params.append((f"param_{i}", entry))
        self._grad_clip = grad_clip
        self._accumulators = {}
        if isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)  # grad += wd * param
        elif weight_decay is None:
            self._weight_decay = 0.0
        else:
            raise NotImplementedError(
                "regularizer objects as weight_decay are not ported; pass "
                "a float (L2 decay)")
        self._lr = 0.0
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            learning_rate._bind(self)
        else:
            self._lr_scheduler = None
            self.set_lr(learning_rate)

    def get_lr(self):
        return self._lr

    def set_lr(self, value):
        self._lr = _f32(value)

    def _parameter_list(self):
        return [p for _, p in self._params]

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list():
            p.grad = None

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list()
                        if p.grad is not None and p.requires_grad]
        for _, g in params_grads:
            if g.is_sparse:
                raise NotImplementedError("sparse grads are not ported")
        with op_body():
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            names = {id(p): n for n, p in self._params}
            for p, g in params_grads:
                self._apply_one(names[id(p)], p, g)

    def _acc(self, kind, param, init=0.0, shape=None):
        """The f32 state ``kind`` of ``param`` on its device, made on
        first use and filled with ``init``."""
        store = self._accumulators.setdefault(kind, {})
        key = id(param)
        if key not in store:
            store[key] = torch.full(param.shape if shape is None else shape,
                                    init, dtype=torch.float32,
                                    device=param.device)
        return store[key]

    def _apply_one(self, name, param, grad):
        raise NotImplementedError
