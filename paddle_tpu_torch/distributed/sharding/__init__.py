"""ZeRO sharded data parallelism (a port of
``paddle_tpu/distributed/sharding/__init__.py``).

The reference places the optimizer's state (``os``), the grads too
(``os_g``) and the parameters too (``p_g_os``) on the mesh's
``sharding`` axis and lets GSPMD emit the reduce-scatters and
all-gathers. The port runs one rank a process, as Paddle's
``DygraphShardingOptimizer`` does: the parameters are partitioned over
the group's ranks by Paddle's greedy rule (:func:`partition`: each
parameter, in order, to the rank holding the fewest elements so far), and
rank ``r`` keeps the optimizer state of its partition only. At each step
(:class:`ZeroEngine`):

* ``os``: the grads are all-reduced (averaged) over the group, each rank
  steps its partition, and each partition is broadcast from its owner;
* ``os_g``: each grad is averaged onto its owner the moment the
  backward has it (a hook on the parameter reduces that backward's grad
  to the owner, and the other ranks drop theirs once it has accumulated),
  so a rank holds the grads of its own partition only; then the step and
  the broadcast. Several backwards before a step (gradient merge, a
  pipeline's microbatches) each add their average on the owner;
* ``p_g_os``: the parameters outside a rank's partition hold no storage
  at rest; a block (each module of an ``nn.ModuleList``) gathers its
  parameters from their owners before its forward and again before its
  backward, and frees them after its forward and once each grad has
  accumulated; the other parameters are gathered for the whole step. The
  grads go as at ``os_g``; the step is ``os_g``'s without the broadcast.

The partition keeps each parameter whole, so an ``AdamW``'s decay
exclusions (by name) and the rest of the per-parameter options keep their
meaning. The update of a partition sees its grads alone, so a global-norm
clip sums each partition's squares over the group
(``fleet.HybridParallelClipGrad``). For the same reason a grad scaler
(``amp.GradScaler``) asks the engine (the optimizer's ``_sharding``) for
the grads to unscale (every rank's own before an ``os`` reduction, the
partition's after an ``os_g`` one) and whether any rank found one not
finite (:meth:`ZeroEngine.found_inf`), as Paddle's
``GroupShardedScaler`` does, so every rank skips or steps together.
"""
import contextlib

import torch

from .. import collective, topology
from ..parallel import sync_params, torch_leaves

LEVELS = ("os", "os_g", "p_g_os")


def level_of(strategy):
    """The ZeRO level of ``strategy.sharding_configs["stage"]``: 1
    ``os``, 2 ``os_g``, 3 ``p_g_os``."""
    stage = 1
    if strategy is not None:
        stage = int(strategy.sharding_configs.get("stage", 1))
    return LEVELS[min(max(stage, 1), 3) - 1]


def partition(leaves, n):
    """Paddle's greedy partition: each tensor, in order, to the rank with
    the fewest elements so far; the owner of each, by position."""
    sizes = [0] * n
    owners = []
    for p in leaves:
        r = sizes.index(min(sizes))
        owners.append(r)
        sizes[r] += int(p.numel())
    return owners


def _unwrap(opt):
    """The optimizer under the wrappers (meta-optimizers, the hybrid
    one) that hold it as ``_inner_opt``."""
    while "_inner_opt" in vars(opt):
        opt = vars(opt)["_inner_opt"]
    return opt


def _leaf(p):
    return getattr(p, "_value", p)


def _free(t):
    t.data.untyped_storage().resize_(0)


def _drop_grad(t):
    t.grad = None


def _gather(t, src, group):
    """Storage for ``t`` again, filled from global rank ``src``."""
    st = t.data.untyped_storage()
    if st.size() == 0:
        st.resize_(t.numel() * t.element_size())
    collective.broadcast(t.data, src=src, group=group)


def state_bytes(optimizer):
    """The bytes of the optimizer's state tensors on this rank."""
    base = _unwrap(optimizer)
    return sum(t.numel() * t.element_size()
               for store in base._accumulators.values()
               for t in store.values())


def _kinds(tensors):
    by = {}
    for t in tensors:
        by.setdefault((t.dtype, t.device), []).append(t)
    return by.values()


def _flat(ts):
    return torch.cat([t.reshape(-1) for t in ts]) if ts else None


def _unflat(flat, ts):
    at = 0
    for t in ts:
        n = t.numel()
        t.copy_(flat[at:at + n].view_as(t))
        at += n


class ZeroEngine:
    """The partitioned update of ``optimizer`` over ``group`` at
    ``level``; ``step()`` replaces the optimizer's (``inner_step``, by
    default ``optimizer.step``, runs the update of this rank's
    partition). The partition is the ``zero_owner`` each parameter was
    given (``partition_model``), else :func:`partition` of the
    optimizer's parameters in order."""

    def __init__(self, optimizer, group, level="os_g", inner_step=None):
        if level not in LEVELS:
            raise ValueError(f"unknown sharding level {level!r}")
        self.optimizer = optimizer
        self._inner_step = inner_step or optimizer.step
        self.base = base = _unwrap(optimizer)
        self._base_clear = base.clear_grad
        self.group, self.level = group, level
        self.partitions_grads = level != "os"
        self.all = list(base._params)
        leaves = [_leaf(p) for _, p in self.all]
        owners = [getattr(t, "zero_owner", None) for t in leaves]
        if any(o is None for o in owners):
            owners = partition(leaves, group.nranks)
        self.owner = {id(t): o for t, o in zip(leaves, owners)}
        self.leaves = leaves
        me = group.rank
        base._params = [(n, p) for (n, p), o in zip(self.all, owners)
                        if o == me]
        self.sizes = [sum(int(t.numel()) for t, o in zip(leaves, owners)
                          if o == r) for r in range(group.nranks)]
        # the update sees this partition's grads alone: the global norm
        # sums the partitions' squares over the group
        from ..fleet.hybrid_optimizer import HybridParallelClipGrad
        from ...nn.clip import ClipGradByGlobalNorm
        if isinstance(getattr(base, "_grad_clip", None),
                      ClipGradByGlobalNorm):
            base._grad_clip = HybridParallelClipGrad(base._grad_clip, None,
                                                     group)
        if self.partitions_grads and group.nranks > 1:
            for t in leaves:
                if not t.requires_grad:
                    continue
                t.register_hook(lambda g, t=t: self._to_owner(t, g))
                if not self._mine(t):
                    t.register_post_accumulate_grad_hook(_drop_grad)

    def _mine(self, t):
        return self.owner[id(t)] == self.group.rank

    @torch.no_grad()
    def _to_owner(self, t, grad):
        """``os_g``'s hook: this backward's grad of ``t`` averaged over the
        group onto its owner, which accumulates the average; another rank
        accumulates its own grad, which ``_drop_grad`` then drops."""
        avg = grad.detach().clone()
        collective.reduce(avg, dst=self.group.ranks[self.owner[id(t)]],
                          op="avg", group=self.group)
        return avg if self._mine(t) else grad

    def grad_leaves(self):
        """The grads a scaler unscales: every parameter's that has one (at
        ``os`` before the all-reduce every rank holds all of them; at
        ``os_g`` and ``p_g_os`` its partition's)."""
        return [t for t in self.leaves if t.grad is not None]

    def found_inf(self, found):
        """Whether any rank of the group found a grad not finite (``found``
        this rank's: True, False, or None when it unscaled none); None
        when no rank unscaled any."""
        if self.group.nranks == 1:
            return found
        flag = torch.tensor(-1.0 if found is None else float(found),
                            device=self.leaves[0].device)
        collective.all_reduce(flag, op="max", group=self.group)
        v = float(flag)
        return None if v < 0 else v > 0

    @torch.no_grad()
    def reduce_grads(self):
        """``os``: every grad averaged over the group."""
        for ts in _kinds(self.grad_leaves()):
            grads = [t.grad for t in ts]
            flat = _flat(grads)
            collective.all_reduce(flat, op="avg", group=self.group)
            _unflat(flat, grads)

    @torch.no_grad()
    def broadcast_params(self):
        g = self.group
        for r in range(g.nranks):
            owned = [t for t in self.leaves if self.owner[id(t)] == r]
            for ts in _kinds(owned):
                flat = _flat(ts) if r == g.rank else torch.empty(
                    sum(t.numel() for t in ts), dtype=ts[0].dtype,
                    device=ts[0].device)
                collective.broadcast(flat, src=g.ranks[r], group=g)
                if r != g.rank:
                    _unflat(flat, [t.data for t in ts])

    def clear_grad(self, set_to_zero=False):
        """Clear every parameter's grad (the optimizer's own
        ``clear_grad`` sees its partition alone)."""
        self._base_clear(set_to_zero)
        for t in self.leaves:
            t.grad = None

    def step(self):
        if self.group.nranks > 1 and not self.partitions_grads:
            self.reduce_grads()
        self._inner_step()
        if self.group.nranks == 1:
            return
        if self.level == "p_g_os":
            for t in self.leaves:
                if not self._mine(t):
                    _free(t)
        else:
            self.broadcast_params()


def partition_model(model, group, level):
    """Give each parameter of ``model`` its owner in ``group``
    (``zero_owner``, :func:`partition` in the model's order) and, at
    ``p_g_os``, free the others and hook the model to gather them on
    use."""
    leaves = torch_leaves(model)
    for t, o in zip(leaves, partition(leaves, group.nranks)):
        t.zero_owner = o
    if level == "p_g_os" and group.nranks > 1:
        model._zero_gather = _GatherOnUse(model, leaves, group)


@contextlib.contextmanager
def gathered(model):
    """Every parameter of a ``p_g_os`` model whole inside (for a state
    dict or an evaluation); every rank of its group must enter it."""
    hooks = getattr(model, "_zero_gather", None)
    if hooks is None:
        yield model
        return
    hooks._gather(hooks.leaves)
    try:
        yield model
    finally:
        hooks._release([t for t in hooks.leaves if not hooks._mine(t)])


class _GatherOnUse:
    """``p_g_os``'s hooks (the module's docstring). A torch module's
    ``nn.ModuleList`` members are blocks; every other parameter (and all
    of a Paddle-surface model's) is gathered for the whole step, from its
    forward until the optimizer's step frees it again."""

    def __init__(self, model, leaves, group):
        self.group = group
        self.me = group.rank
        self.leaves = leaves
        blocks = []
        if isinstance(model, torch.nn.Module):
            for m in model.modules():
                if isinstance(m, torch.nn.ModuleList):
                    blocks.extend(m)
        in_block = {id(p) for b in blocks for p in b.parameters()}
        self.rest = [t for t in leaves if id(t) not in in_block]
        # every rank joins each broadcast (the owner sends), so a unit's
        # gather runs over all its parameters; only the others are freed
        for b in blocks:
            ps = list(b.parameters())
            theirs = [p for p in ps if not self._mine(p)]
            b.register_forward_pre_hook(
                lambda m, a, ps=ps: self._gather(ps))
            b.register_forward_hook(
                lambda m, a, o, ps=theirs: self._release(ps))
            b.register_full_backward_pre_hook(
                lambda m, g, ps=ps: self._gather(ps))
            for p in theirs:
                p.register_post_accumulate_grad_hook(_free)
        rest = self.rest
        model.register_forward_pre_hook(lambda m, a: self._gather(rest))
        for t in leaves:
            if not self._mine(t):
                _free(t)

    def _mine(self, t):
        return t.zero_owner == self.me

    def _gather(self, ps):
        with torch.no_grad():
            for p in ps:
                _gather(p, self.group.ranks[p.zero_owner], self.group)

    def _release(self, ps):
        for p in ps:
            _free(p)


def _group_of(group):
    if group is not None:
        return group
    hcg = topology.get_hybrid_communicate_group()
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        return hcg.get_sharding_parallel_group()
    return collective._default_group()


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, axis="sharding"):
    """Reference python/paddle/distributed/sharding/group_sharded.py:
    ``level`` ``"os"`` (ZeRO-1), ``"os_g"`` (ZeRO-2) or ``"p_g_os"``
    (ZeRO-3) over ``group`` (the hybrid topology's ``sharding`` group
    when it has more than one rank, else every rank). The parameters are
    broadcast from the group's first rank; ``optimizer.step`` becomes the
    partitioned step (the same optimizer object, as the reference patches
    its ``step``) and ``optimizer._sharding`` the engine, which a
    ``GradScaler`` stepping it asks for the grads to unscale and the
    group's inf flag. Returns ``(model, optimizer, scaler)``."""
    if level not in LEVELS:
        raise ValueError(f"unknown sharding level {level!r}")
    g = _group_of(group)
    if g.nranks == 1:
        return model, optimizer, scaler
    sync_params(torch_leaves(model), [(g, g.ranks[0])])
    partition_model(model, g, level)
    engine = ZeroEngine(optimizer, g, level)
    optimizer._sharding = engine
    optimizer.step = engine.step
    optimizer.clear_grad = optimizer.clear_gradients = engine.clear_grad
    return model, optimizer, scaler


class DygraphShardingOptimizer:
    """Reference dygraph_sharding_optimizer.py:27: the inner optimizer
    built over ``params``, its state partitioned over the hybrid
    topology's ``sharding`` group (ZeRO-1: grads all-reduced)."""

    def __init__(self, hcg=None, user_defined_strategy=None, params=None,
                 inner_optimizer_class=None, **inner_kw):
        self._inner = inner_optimizer_class(parameters=params, **inner_kw)
        self._hcg = hcg
        group = hcg.get_sharding_parallel_group() if hcg is not None \
            else _group_of(None)
        self._sharding = ZeroEngine(self._inner, group, "os")

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def step(self):
        self._sharding.step()

    def clear_grad(self, *args, **kwargs):
        self._sharding.clear_grad(*args, **kwargs)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None
