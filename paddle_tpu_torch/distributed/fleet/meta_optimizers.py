"""Fleet meta-optimizers (a port of
``paddle_tpu/distributed/fleet/meta_optimizers.py``): GradientMerge,
LocalSGD and its adaptive form, the 16-bit grad all-reduce and DGC.

The reference (and Paddle) rewrite the program; here, as in the
reference, each is a transform of the grads or of the step around the
inner optimizer, over the torch leaves of its parameters (after the pending lazy graph
has run). Where the
reference's single controller makes a collective the identity (LocalSGD's
parameter average, its replicas being equal by construction), the port's
ranks each hold a replica and the collective is real: the parameters are
averaged over the ``dp`` group (the hybrid topology's, or the world's).
Parameters that each rank holds a different part of (tensor-parallel
shards, MoE experts: ``tp_split`` or ``is_distributed``) are never
averaged.
"""
import torch

from .. import collective, topology
from ...core import lazy
from ...optimizer.optimizers import Momentum


class _WrappedOptimizer:
    """Reference ``optimizer.WrappedOptimizer``: everything goes to the
    inner optimizer; a subclass overrides ``step``."""

    def __init__(self, inner_opt):
        self._inner_opt = inner_opt

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad


def _trainable(p):
    return p.requires_grad


class GradientMergeOptimizer(_WrappedOptimizer):
    """Accumulate grads over ``k_steps`` steps before one real update
    (reference gradient_merge_optimizer.py): a merge buffer per
    parameter, the inner step every ``k``-th call with the buffers'
    mean (``avg``) or sum as the grads."""

    def __init__(self, inner_opt, k_steps=1, avg=True):
        super().__init__(inner_opt)
        self._k = max(1, int(k_steps))
        self._avg = bool(avg)
        self._step_idx = 0
        self._buffers = {}

    @torch.no_grad()
    def step(self):
        lazy.flush()
        self._step_idx += 1
        params = self._inner_opt._parameter_list()
        final = self._step_idx % self._k == 0
        for p in params:
            if p.grad is None or not _trainable(p):
                continue
            g = p.grad.float()
            acc = self._buffers.get(id(p))
            acc = g.clone() if acc is None else acc + g
            if final:
                merged = acc / self._k if self._avg else acc
                p.grad = merged.to(p.grad.dtype)
                self._buffers.pop(id(p), None)
            else:
                self._buffers[id(p)] = acc
        if final:
            # a parameter with merged grads earlier in the cycle and none
            # now: its buffer is its grad, never carried into the next
            if self._buffers:
                for p in params:
                    acc = self._buffers.get(id(p))
                    if acc is not None:
                        p.grad = (acc / self._k if self._avg
                                  else acc).to(p.dtype)
                self._buffers.clear()
            self._inner_opt.step()


def _dp_group(group):
    if group is not None:
        return group
    hcg = topology.get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_data_parallel_group()
    return collective._default_group()


def _replicated(p):
    """Not a part of a parameter (a torch tensor's own ``is_distributed``
    is a method: only the attribute set to True marks a part)."""
    from .meta_parallel.mp_layers import split_of
    return split_of(p) is None and getattr(p, "is_distributed",
                                           False) is not True


class LocalSGDOptimizer(_WrappedOptimizer):
    """Step locally every iteration; average the parameters over the
    ``dp`` group every ``k_steps`` from ``begin_step`` on (reference
    localsgd_optimizer.py)."""

    def __init__(self, inner_opt, k_steps=1, begin_step=1, group=None):
        super().__init__(inner_opt)
        self._k = max(1, int(k_steps))
        self._begin = int(begin_step)
        self._group = group
        self._step_idx = 0

    @torch.no_grad()
    def step(self):
        self._inner_opt.step()
        self._step_idx += 1
        if self._step_idx >= self._begin and self._step_idx % self._k == 0:
            self._sync_params()

    @torch.no_grad()
    def _sync_params(self):
        g = _dp_group(self._group)
        if g.nranks == 1:
            return
        for p in self._inner_opt._parameter_list():
            if _trainable(p) and _replicated(p):
                collective.all_reduce(p.data, op="avg", group=g)


class AdaptiveLocalSGDOptimizer(LocalSGDOptimizer):
    """The interval adapts to the loss (reference localsgd_optimizer.py
    AdaptiveLocalSGDOptimizer): while ``minimize``'s loss improves on the
    best seen by 0.1 % the interval stays; when it stalls it doubles, up
    to ``max_k_steps``. ``step()`` alone keeps the interval."""

    def __init__(self, inner_opt, init_k_steps=1, begin_step=1, group=None,
                 max_k_steps=16):
        super().__init__(inner_opt, init_k_steps, begin_step, group)
        self._max_k = int(max_k_steps)
        self._best_loss = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        cur = float(loss.detach() if hasattr(loss, "detach") else loss)
        if self._best_loss is None or cur < self._best_loss * 0.999:
            self._best_loss = min(cur, self._best_loss or cur)
        else:
            self._k = min(self._max_k, self._k * 2)
        return None, None


class FP16AllReduceOptimizer(_WrappedOptimizer):
    """The grads in a 16-bit format before the inner step (reference
    fp16_allreduce_optimizer.py; bfloat16 by default, the reference's
    wire format). With a ``group`` of more than one rank the grads are
    averaged over it in that format; without one (``DataParallel`` has
    averaged them) they are rounded through it."""

    def __init__(self, inner_opt, dtype="bfloat16", group=None):
        super().__init__(inner_opt)
        self._wire = torch.bfloat16 if dtype == "bfloat16" \
            else torch.float16
        self._group = group

    @torch.no_grad()
    def step(self):
        lazy.flush()
        g = self._group
        for p in self._inner_opt._parameter_list():
            if p.grad is None or not _trainable(p):
                continue
            low = p.grad.to(self._wire)
            if g is not None and g.nranks > 1:
                collective.all_reduce(low, op="avg", group=g)
            p.grad.copy_(low.to(p.grad.dtype))
        self._inner_opt.step()


def _dgc_sparsity(global_step, rampup_begin_step, rampup_step, sparsity):
    """Reference dgc.py get_sparsity: through the sparsity list over the
    rampup window, then the last value."""
    if global_step < rampup_begin_step:
        return 0.0
    progress = global_step - rampup_begin_step
    if rampup_step <= 0 or progress >= rampup_step:
        return float(sparsity[-1])
    idx = int(progress * len(sparsity) / rampup_step)
    return float(sparsity[min(idx, len(sparsity) - 1)])


def _dgc_update(param, grad, u, v, lr, *, mu, ratio, wd):
    """DGC: momentum correction, then the ``ratio`` share of the largest
    ``|v|`` applied (every element at or above the ``k``-th largest,
    ``k = max(1, int(numel * ratio))``, so ties at the threshold are all
    kept, as the reference's ``>=``), the rest kept in the velocity
    accumulators (reference dgc_op + dgc_momentum_op). Writes ``param``,
    ``u`` and ``v`` in place."""
    g = grad.float()
    p32 = param.float()
    if wd:
        g = g + wd * p32
    u_new = mu * u + g
    v_new = v + u_new
    flat = v_new.abs().reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    thr = torch.topk(flat, k).values[-1]
    mask = (v_new.abs() >= thr).float()
    encoded = v_new * mask
    v.copy_(v_new * (1.0 - mask))
    u.copy_(u_new * (1.0 - mask))
    param.copy_((p32 - lr * encoded).to(param.dtype))


class DGCMomentumOptimizer(Momentum):
    """Deep gradient compression momentum (reference dgc_optimizer.py):
    plain Momentum before ``rampup_begin_step`` and for parameters of
    fewer than 16 elements, else the top-k sparsified update of
    :func:`_dgc_update` with its residual accumulation."""

    def __init__(self, learning_rate, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
                 name=None):
        super().__init__(learning_rate, momentum=momentum,
                         parameters=parameters, use_nesterov=use_nesterov,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = int(rampup_step)
        self._sparsity = list(sparsity)
        self._global_step = 0

    def step(self):
        super().step()
        self._global_step += 1

    def _apply_one(self, name, p, g):
        s = _dgc_sparsity(self._global_step, self._rampup_begin,
                          self._rampup_step, self._sparsity)
        if s <= 0.0 or p.numel() < 16:
            return super()._apply_one(name, p, g)
        _dgc_update(p, g, self._acc("dgc_u", p), self._acc("dgc_v", p),
                    self._lr_of(p), mu=self._momentum, ratio=1.0 - s,
                    wd=self._weight_decay)


def apply_meta_optimizers(optimizer, strategy):
    """The reference's StrategyCompiler (strategy_compiler.py): the
    meta-optimizers the strategy turns on, innermost first: the DGC swap
    of a Momentum, the 16-bit all-reduce, gradient merge, LocalSGD (or
    its adaptive form)."""
    if strategy is None:
        return optimizer
    if getattr(strategy, "dgc", False) and isinstance(optimizer, Momentum) \
            and not isinstance(optimizer, DGCMomentumOptimizer):
        cfg = getattr(strategy, "dgc_configs", {}) or {}
        optimizer = DGCMomentumOptimizer(
            optimizer._lr_scheduler or optimizer.get_lr(),
            momentum=optimizer._momentum, parameters=optimizer._params,
            use_nesterov=optimizer._use_nesterov,
            weight_decay=optimizer._weight_decay or None,
            grad_clip=optimizer._grad_clip,
            rampup_begin_step=cfg.get("rampup_begin_step", 0),
            rampup_step=cfg.get("rampup_step", 1),
            sparsity=cfg.get("sparsity", [0.999]))
    if getattr(strategy, "fp16_allreduce", False):
        optimizer = FP16AllReduceOptimizer(optimizer)
    if getattr(strategy, "gradient_merge", False):
        cfg = strategy.gradient_merge_configs
        optimizer = GradientMergeOptimizer(optimizer,
                                           k_steps=cfg.get("k_steps", 1),
                                           avg=cfg.get("avg", True))
    if getattr(strategy, "localsgd", False):
        cfg = strategy.localsgd_configs
        optimizer = LocalSGDOptimizer(optimizer,
                                      k_steps=cfg.get("k_steps", 1),
                                      begin_step=cfg.get("begin_step", 1))
    elif getattr(strategy, "adaptive_localsgd", False):
        cfg = getattr(strategy, "adaptive_localsgd_configs", {}) or {}
        optimizer = AdaptiveLocalSGDOptimizer(
            optimizer, init_k_steps=cfg.get("init_k_steps", 1),
            begin_step=cfg.get("begin_step", 1))
    return optimizer
