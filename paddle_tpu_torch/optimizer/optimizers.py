"""Adam and AdamW (reference ``paddle_tpu/optimizer/optimizers.py``:
``_adam`` :111-128, ``Adam`` :239, ``AdamW`` :289).

Plain PyTorch: the reference has no Pallas kernel here either (one XLA
fusion per parameter). The update runs in f32 and writes the parameter,
its two f32 moments and its ``beta1_pow``/``beta2_pow`` scalars in
place.
"""
from .optimizer import Optimizer


def _adam(param, grad, m, v, beta1_pow, beta2_pow, lr, *, beta1, beta2,
          epsilon, wd, decoupled):
    """One Adam step in the reference's order of operations: coupled L2
    into the grad, the moments, the bias-corrected
    ``update = m_hat / (sqrt(v_hat) + eps)``, decoupled decay added to
    the update (``update + wd * p``), then ``p - lr * update``. That is
    not ``torch.optim.AdamW``'s order (it decays ``p`` before the Adam
    step)."""
    g = grad.float()
    p32 = param.float()
    if wd and not decoupled:
        g = g + wd * p32
    m.mul_(beta1).add_(g, alpha=1.0 - beta1)
    v.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
    beta1_pow.mul_(beta1)
    beta2_pow.mul_(beta2)
    m_hat = m / (1.0 - beta1_pow)
    v_hat = v / (1.0 - beta2_pow)
    update = m_hat / (v_hat.sqrt() + epsilon)
    if wd and decoupled:
        update = update + wd * p32
    param.copy_(p32 - lr * update)


class Adam(Optimizer):
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if multi_precision:
            raise NotImplementedError("multi_precision is not ported")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        # lazy_mode: only sparse grads read it in the reference, and they
        # raise here

    def _apply_one(self, name, p, g, wd=None):
        _adam(
            p, g, self._acc("moment1", p), self._acc("moment2", p),
            self._acc("beta1_pow", p, 1.0, ()),
            self._acc("beta2_pow", p, 1.0, ()), self._lr,
            beta1=self._beta1, beta2=self._beta2, epsilon=self._epsilon,
            wd=self._weight_decay if wd is None else wd,
            decoupled=self._decoupled)


class AdamW(Adam):
    """Decoupled weight decay (reference: operators/optimizers/adamw_op).
    ``apply_decay_param_fun(name)`` returning False exempts a parameter
    from the decay; names are those given with the parameters."""
    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lr_ratio=None, apply_decay_param_fun=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._weight_decay = float(weight_decay or 0.0)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_one(self, name, p, g, wd=None):
        fun = self._apply_decay_param_fun
        super()._apply_one(name, p, g,
                           0.0 if fun is not None and not fun(name) else wd)
