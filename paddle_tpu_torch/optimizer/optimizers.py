"""The optimizers (reference ``paddle_tpu/optimizer/optimizers.py``):
``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adamax``, ``Adagrad``,
``RMSProp``, ``Lamb``, ``LarsMomentum``, ``Adadelta`` and ``Ftrl``.

Plain PyTorch: the reference has no Pallas kernel here either (one XLA
fusion per parameter). Each update function follows the reference's
``register_op`` function of the same name in its order of operations,
computes in f32 and writes the parameter and its f32 state in place;
one chain of launches per parameter. SGD and Adam/AdamW also update a
sparse grad's rows (``_apply_sparse``, reference optimizers.py:41-108
and :204-320); Momentum's sparse update is dense-equivalent in the
reference (absent rows see grad 0), which the base class's densified
update is.
"""
import torch

from .optimizer import Optimizer


def _f32_grad(param, grad, wd=0.0):
    """The grad and the parameter in f32, with coupled L2 decay."""
    g = grad.float()
    p32 = param.float()
    if wd:
        g = g + wd * p32
    return g, p32


def _sgd(param, grad, lr, *, wd):
    g, p32 = _f32_grad(param, grad, wd)
    param.copy_(p32 - lr * g)


def _momentum(param, grad, velocity, lr, *, mu, wd, use_nesterov):
    g, p32 = _f32_grad(param, grad, wd)
    velocity.copy_(mu * velocity + g)
    if use_nesterov:
        param.copy_(p32 - lr * (g + mu * velocity))
    else:
        param.copy_(p32 - lr * velocity)


def _adam(param, grad, m, v, beta1_pow, beta2_pow, lr, *, beta1, beta2,
          epsilon, wd, decoupled):
    """One Adam step in the reference's order of operations: coupled L2
    into the grad, the moments, the bias-corrected
    ``update = m_hat / (sqrt(v_hat) + eps)``, decoupled decay added to
    the update (``update + wd * p``), then ``p - lr * update``. That is
    not ``torch.optim.AdamW``'s order (it decays ``p`` before the Adam
    step)."""
    g, p32 = _f32_grad(param, grad, wd if not decoupled else 0.0)
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


# ---- sparse (SelectedRows) row updates --------------------------------------
# Reference optimizers.py:41-108. ``rows`` is a coalesced IndexedSlices:
# unique sorted row indices and their grads. index_select / index_copy_
# / index_add_ read and write those rows alone.

def _sgd_sparse(param, rows, lr, *, wd):
    idx = rows.indices
    p_rows = param.index_select(0, idx).float()
    g = rows.values.float()
    if wd:
        g = g + wd * p_rows
    param.index_copy_(0, idx, (p_rows - lr * g).to(param.dtype))


def _adam_rows_lazy(param, rows, m, v, beta1_pow, beta2_pow, lr, *, beta1,
                    beta2, epsilon, wd, decoupled):
    """``lazy_mode=True``: only the looked-up rows of the parameter and
    its moments change, in the reference's order (the learning rate
    inside the update, the decoupled decay ``lr * wd * p`` added to
    it)."""
    idx = rows.indices
    g = rows.values.float()
    p_rows = param.index_select(0, idx).float()
    if wd and not decoupled:
        g = g + wd * p_rows
    beta1_pow.mul_(beta1)
    beta2_pow.mul_(beta2)
    m_rows = beta1 * m.index_select(0, idx) + (1.0 - beta1) * g
    v_rows = beta2 * v.index_select(0, idx) + (1.0 - beta2) * g * g
    m_hat = m_rows / (1.0 - beta1_pow)
    v_hat = v_rows / (1.0 - beta2_pow)
    upd = lr * m_hat / (v_hat.sqrt() + epsilon)
    if wd and decoupled:
        upd = upd + lr * wd * p_rows
    param.index_copy_(0, idx, (p_rows - upd).to(param.dtype))
    m.index_copy_(0, idx, m_rows)
    v.index_copy_(0, idx, v_rows)


_ROW_CHUNK = 1 << 16


def _adam_rows_dense(param, rows, m, v, beta1_pow, beta2_pow, lr, *, beta1,
                     beta2, epsilon, wd, decoupled):
    """``lazy_mode=False``: the dense update with the grad zero on the
    rows it does not touch, so every moment decays and every parameter
    keeps moving, as ``_adam`` would move them; the grad itself is never
    made dense. The moments of the absent rows take ``beta * m`` (the
    dense ``beta * m + (1 - beta) * 0``), the looked-up rows the dense
    expressions; the update then runs over chunks of rows, so no
    temporary is as large as the table. With coupled L2 decay the grad
    is ``wd * p`` on every row, dense by nature, and ``_adam`` takes
    it."""
    idx = rows.indices
    if wd and not decoupled:
        g = wd * param.float()
        g.index_add_(0, idx, rows.values.float())
        _adam(param, g, m, v, beta1_pow, beta2_pow, lr, beta1=beta1,
              beta2=beta2, epsilon=epsilon, wd=0.0, decoupled=False)
        return
    g = rows.values.float()
    m_rows = m.index_select(0, idx)
    v_rows = v.index_select(0, idx)
    m.mul_(beta1)
    v.mul_(beta2)
    m_rows.mul_(beta1).add_(g, alpha=1.0 - beta1)
    v_rows.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
    m.index_copy_(0, idx, m_rows)
    v.index_copy_(0, idx, v_rows)
    beta1_pow.mul_(beta1)
    beta2_pow.mul_(beta2)
    for r in range(0, param.shape[0], _ROW_CHUNK):
        sl = slice(r, r + _ROW_CHUNK)
        p32 = param[sl].float()
        update = (m[sl] / (1.0 - beta1_pow)) / (
            (v[sl] / (1.0 - beta2_pow)).sqrt() + epsilon)
        if wd:
            update = update + wd * p32
        param[sl] = p32 - lr * update


def _adamax(param, grad, m, inf_norm, beta1_pow, lr, *, beta1, beta2,
            epsilon, wd):
    g, p32 = _f32_grad(param, grad, wd)
    m.copy_(beta1 * m + (1.0 - beta1) * g)
    inf_norm.copy_(torch.maximum(beta2 * inf_norm, g.abs()))
    beta1_pow.mul_(beta1)
    param.copy_(p32 - (lr / (1.0 - beta1_pow)) * m / (inf_norm + epsilon))


def _adagrad(param, grad, moment, lr, *, epsilon, wd):
    g, p32 = _f32_grad(param, grad, wd)
    moment.copy_(moment + g * g)
    param.copy_(p32 - lr * g / (moment.sqrt() + epsilon))


def _rmsprop(param, grad, mean_square, mean_grad, moment, lr, *, rho,
             epsilon, momentum, centered, wd):
    """Epsilon inside the square root, as the reference."""
    g, p32 = _f32_grad(param, grad, wd)
    mean_square.copy_(rho * mean_square + (1.0 - rho) * g * g)
    if centered:
        mean_grad.copy_(rho * mean_grad + (1.0 - rho) * g)
        denom = (mean_square - mean_grad * mean_grad + epsilon).sqrt()
    else:
        denom = (mean_square + epsilon).sqrt()
    moment.copy_(momentum * moment + lr * g / denom)
    param.copy_(p32 - moment)


def _lamb(param, grad, m, v, beta1_pow, beta2_pow, lr, *, beta1, beta2,
          epsilon, wd):
    g, p32 = _f32_grad(param, grad)
    m.copy_(beta1 * m + (1.0 - beta1) * g)
    v.copy_(beta2 * v + (1.0 - beta2) * g * g)
    beta1_pow.mul_(beta1)
    beta2_pow.mul_(beta2)
    m_hat = m / (1.0 - beta1_pow)
    v_hat = v / (1.0 - beta2_pow)
    r = m_hat / (v_hat.sqrt() + epsilon) + wd * p32
    w_norm = (p32 * p32).sum().sqrt()
    r_norm = (r * r).sum().sqrt()
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    param.copy_(p32 - lr * trust * r)


def _lars(param, grad, velocity, lr, *, mu, lars_coeff, wd, epsilon):
    g, p32 = _f32_grad(param, grad)
    p_norm = (p32 * p32).sum().sqrt()
    g_norm = (g * g).sum().sqrt()
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lars_coeff * p_norm / (g_norm + wd * p_norm + epsilon),
        torch.ones_like(p_norm))
    velocity.copy_(mu * velocity + lr * local_lr * (g + wd * p32))
    param.copy_(p32 - velocity)


def _adadelta(param, grad, avg_sq_grad, avg_sq_update, *, rho, epsilon):
    """No learning rate: ``param += update``, as the reference."""
    g, p32 = _f32_grad(param, grad)
    avg_sq_grad.copy_(rho * avg_sq_grad + (1.0 - rho) * g * g)
    update = -((avg_sq_update + epsilon) / (avg_sq_grad + epsilon)).sqrt() \
        * g
    avg_sq_update.copy_(rho * avg_sq_update + (1.0 - rho) * update * update)
    param.copy_(p32 + update)


def _ftrl(param, grad, sq_accum, lin_accum, lr, *, l1, l2, lr_power):
    g, p32 = _f32_grad(param, grad)
    new_accum = sq_accum + g * g
    if lr_power == -0.5:
        lin_accum.copy_(lin_accum + g
                        - (new_accum.sqrt() - sq_accum.sqrt()) / lr * p32)
        y = new_accum.sqrt() / lr + 2.0 * l2
    else:
        lin_accum.copy_(lin_accum + g
                        - (new_accum ** (-lr_power)
                           - sq_accum ** (-lr_power)) / lr * p32)
        y = new_accum ** (-lr_power) / lr + 2.0 * l2
    sq_accum.copy_(new_accum)
    x = l1 * torch.sign(lin_accum) - lin_accum
    param.copy_(torch.where(lin_accum.abs() > l1, x / y,
                            torch.zeros_like(x)))


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _apply_one(self, name, p, g):
        _sgd(p, g, self._lr_of(p), wd=self._weight_decay)

    def _apply_sparse(self, name, p, rows):
        _sgd_sparse(p, rows, self._lr_of(p), wd=self._weight_decay)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)

    def _apply_one(self, name, p, g):
        _momentum(p, g, self._acc("velocity", p), self._lr_of(p),
                  mu=self._momentum, wd=self._weight_decay,
                  use_nesterov=self._use_nesterov)


class Adam(Optimizer):
    """``multi_precision`` is taken and, as in the reference, not read:
    the state is f32 whatever the parameter's dtype."""
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        # lazy_mode: read by the sparse update alone, as in the reference
        self._lazy_mode = bool(lazy_mode)

    def _apply_one(self, name, p, g, wd=None):
        _adam(
            p, g, self._acc("moment1", p), self._acc("moment2", p),
            self._acc("beta1_pow", p, 1.0, ()),
            self._acc("beta2_pow", p, 1.0, ()), self._lr_of(p),
            beta1=self._beta1, beta2=self._beta2, epsilon=self._epsilon,
            wd=self._weight_decay if wd is None else wd,
            decoupled=self._decoupled)

    def _apply_sparse(self, name, p, rows, wd=None):
        """Reference ``_adam_sparse``: ``lazy_mode=True`` updates the
        looked-up rows alone; the default is dense-equivalent."""
        fn = _adam_rows_lazy if self._lazy_mode else _adam_rows_dense
        fn(p, rows, self._acc("moment1", p), self._acc("moment2", p),
           self._acc("beta1_pow", p, 1.0, ()),
           self._acc("beta2_pow", p, 1.0, ()), self._lr_of(p),
           beta1=self._beta1, beta2=self._beta2, epsilon=self._epsilon,
           wd=self._weight_decay if wd is None else wd,
           decoupled=self._decoupled)


class AdamW(Adam):
    """Decoupled weight decay (reference: operators/optimizers/adamw_op).
    ``apply_decay_param_fun(name)`` returning False exempts a parameter
    from the decay; names are those given with the parameters (a
    ``Parameter``'s ``.name``, as the reference's).
    ``lr_ratio`` is taken and, as in the reference, not read."""
    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lr_ratio=None, apply_decay_param_fun=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._weight_decay = float(weight_decay or 0.0)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_one(self, name, p, g, wd=None):
        fun = self._apply_decay_param_fun
        super()._apply_one(name, p, g,
                           0.0 if fun is not None and not fun(name) else wd)

    def _apply_sparse(self, name, p, rows, wd=None):
        fun = self._apply_decay_param_fun
        super()._apply_sparse(
            name, p, rows, 0.0 if fun is not None and not fun(name) else wd)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _apply_one(self, name, p, g):
        _adamax(p, g, self._acc("moment", p), self._acc("inf_norm", p),
                self._acc("beta1_pow", p, 1.0, ()), self._lr_of(p),
                beta1=self._beta1, beta2=self._beta2, epsilon=self._epsilon,
                wd=self._weight_decay)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _apply_one(self, name, p, g):
        _adagrad(p, g, self._acc("moment", p, self._init_acc),
                 self._lr_of(p),
                 epsilon=self._epsilon, wd=self._weight_decay)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)

    def _apply_one(self, name, p, g):
        _rmsprop(p, g, self._acc("mean_square", p),
                 self._acc("mean_grad", p), self._acc("momentum_acc", p),
                 self._lr_of(p), rho=self._rho, epsilon=self._epsilon,
                 momentum=self._momentum, centered=self._centered,
                 wd=self._weight_decay)


class Lamb(Optimizer):
    """``exclude_from_weight_decay_fn(param)`` is called with the
    parameter as it was given (a ``Parameter``, as the reference calls
    it, or a torch tensor); True exempts it from ``lamb_weight_decay``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._lamb_wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _apply_one(self, name, p, g):
        wd = self._lamb_wd
        if self._exclude_fn is not None \
                and self._exclude_fn(self._given(p)):
            wd = 0.0
        _lamb(p, g, self._acc("moment1", p), self._acc("moment2", p),
              self._acc("beta1_pow", p, 1.0, ()),
              self._acc("beta2_pow", p, 1.0, ()), self._lr_of(p),
              beta1=self._beta1, beta2=self._beta2, epsilon=self._epsilon,
              wd=wd)


class LarsMomentum(Optimizer):
    """Layer-wise adaptive rate scaling (reference:
    operators/optimizers/lars_momentum_op.cc). A parameter whose name
    (as given with the parameters; a ``Parameter``'s ``.name``) contains a
    tag of ``exclude_from_weight_decay`` is not decayed."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, epsilon=1e-9, name=None,
                 exclude_from_weight_decay=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = float(momentum)
        self._lars_coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._epsilon = float(epsilon)
        self._exclude = exclude_from_weight_decay or []

    def _apply_one(self, name, p, g):
        wd = self._lars_wd
        if any(tag in name for tag in self._exclude):
            wd = 0.0
        _lars(p, g, self._acc("velocity", p), self._lr_of(p),
              mu=self._momentum,
              lars_coeff=self._lars_coeff, wd=wd, epsilon=self._epsilon)


class Adadelta(Optimizer):
    """Reference: operators/optimizers/adadelta_op.h. The update has no
    learning rate; weight decay is added to the grad before it, in the
    grad's dtype."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = float(rho), float(epsilon)

    def _apply_one(self, name, p, g):
        if self._weight_decay:
            g = g + self._weight_decay * p
        _adadelta(p, g, self._acc("avg_squared_grad", p),
                  self._acc("avg_squared_update", p), rho=self._rho,
                  epsilon=self._epsilon)


class Ftrl(Optimizer):
    """Follow-the-regularized-leader (reference:
    operators/optimizers/ftrl_op.h); 1e-10 is added to ``l1`` and ``l2``,
    as the reference's op does."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._l1 = float(l1) + 1e-10
        self._l2 = float(l2) + 1e-10
        self._lr_power = float(lr_power)

    def _apply_one(self, name, p, g):
        _ftrl(p, g, self._acc("squared_accum", p),
              self._acc("linear_accum", p), self._lr_of(p), l1=self._l1,
              l2=self._l2, lr_power=self._lr_power)
