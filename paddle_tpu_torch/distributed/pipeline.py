"""Pipeline parallelism over the ``pp`` group (a port of
``paddle_tpu/distributed/pipeline.py``).

The reference runs every stage in one SPMD program: a ``lax.scan`` over
``M + pp - 1`` ticks whose activation ring advances by ``ppermute``, with
the backward from autodiff. The port runs one stage a rank, as Paddle's
``PipelineParallel`` does: rank ``s`` of the ``pp`` group runs stage
``s`` on each microbatch, receives its input from rank ``s - 1`` and
sends its output to rank ``s + 1`` (``collective.p2p_exchange``; on gloo,
CUDA tensors stage through pinned host memory), and the grads of those
activations go back the same way. :func:`run_schedule` is the one
schedule, 1F1B (Paddle's ``section_worker.cc:34`` and Megatron's): stage
``s`` runs ``min(pp - s - 1, M)`` forwards ahead, then alternates one
forward with one backward, then drains the backwards, so at most
``pp - s`` microbatches' activations are alive on it, whatever ``M``.

The functional API keeps the reference's names and arguments; ``mesh``
may be the port's ``topology.Mesh`` or None, and the group is the
hybrid topology's ``axis_name`` group either way. The stacked parameters
are torch tensors (or nests of lists, tuples and dicts of them) with the
stage on the leading axis; rank ``s`` runs its slice ``[s]``.
:func:`pipeline_apply` and :func:`pipeline_blocks_apply` run the forward
and return the last stage's outputs on every rank;
:func:`pipeline_loss_and_grad` runs forward and backward and returns the
mean loss over the microbatches and the grads in the stacked layout on
every rank (this rank's stage filled in, then summed over the group).
``remat=True`` keeps only each stage's input per microbatch and runs the
stage again in its backward (``torch.utils.checkpoint``), the reference's
per-tick ``jax.checkpoint``.
"""
import torch
from torch.utils.checkpoint import checkpoint

from . import collective, topology

_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32, torch.bool, torch.uint8, torch.int8)
_META_LEN = 10      # dtype code, ndim, up to 8 dims


def _meta(t):
    shape = list(t.shape)
    if len(shape) > _META_LEN - 2:
        raise ValueError(f"a pipeline activation of {len(shape)} dims "
                         f"(at most {_META_LEN - 2})")
    m = [_DTYPES.index(t.dtype), len(shape)] + shape
    return torch.tensor(m + [0] * (_META_LEN - len(m)), dtype=torch.int64)


def _unmeta(m):
    m = m.tolist()
    return tuple(m[2:2 + m[1]]), _DTYPES[m[0]]


class P2P:
    """This rank's links to its neighbours in the ``pp`` group. The first
    activation a stage sends in a schedule is preceded by its shape and
    dtype; every later one (the microbatches are alike) and every grad
    sent back (shaped as the activation it belongs to) goes bare."""

    def __init__(self, group, device):
        self.g = group
        self.s, self.n = group.rank, group.nranks
        self.prev = group.ranks[self.s - 1] if self.s > 0 else None
        self.next = group.ranks[self.s + 1] if self.s < self.n - 1 else None
        self.device = device
        self.reset()

    def reset(self):
        self.in_meta = None     # what the previous stage sends
        self.out_meta = None    # what this stage sends

    def exchange(self, send_fwd=None, recv_bwd=False, send_bwd=None,
                 recv_fwd=False):
        """One round with the neighbours; returns what was received (the
        next activation, or the grad of the last one sent), else None."""
        sends, recvs, got = [], [], None
        if recv_fwd and self.in_meta is None:
            m = torch.zeros(_META_LEN, dtype=torch.int64)
            collective.p2p_exchange(recvs=[(m, self.prev)], group=self.g)
            self.in_meta = _unmeta(m)
        if send_fwd is not None:
            if self.out_meta is None:
                self.out_meta = (tuple(send_fwd.shape), send_fwd.dtype)
                sends.append((_meta(send_fwd), self.next))
            sends.append((send_fwd.detach(), self.next))
        if send_bwd is not None:
            sends.append((send_bwd.detach(), self.prev))
        if recv_fwd:
            shape, dtype = self.in_meta
            got = torch.empty(shape, dtype=dtype, device=self.device)
            recvs.append((got, self.prev))
        if recv_bwd:
            shape, dtype = self.out_meta
            got = torch.empty(shape, dtype=dtype, device=self.device)
            recvs.append((got, self.next))
        collective.p2p_exchange(sends, recvs, group=self.g)
        return got


def run_schedule(p2p, m, forward_step, backward_step=None):
    """Run ``m`` microbatches through this rank's stage.

    ``forward_step(i, x)`` runs microbatch ``i`` on the stage (``x`` the
    activation received, None on the first stage) and returns its output
    (the activation to send on, or whatever the last stage makes);
    ``backward_step(i, out, grad)`` runs its backward from the grad of
    ``out`` (None on the last stage) and returns the grad of ``x`` (None
    on the first stage). Without ``backward_step`` the microbatches run
    forward only, in order. 1F1B otherwise (the module's docstring)."""
    p2p.reset()
    s, n = p2p.s, p2p.n
    first, last = s == 0, s == n - 1
    if backward_step is None:
        for i in range(m):
            x = None if first else p2p.exchange(recv_fwd=True)
            out = forward_step(i, x)
            if not last:
                p2p.exchange(send_fwd=out)
        return
    warm = min(n - s - 1, m)
    steady = m - warm
    pending = []
    for i in range(warm):
        x = None if first else p2p.exchange(recv_fwd=True)
        out = forward_step(i, x)
        p2p.exchange(send_fwd=out)
        pending.append((i, out))
    x = p2p.exchange(recv_fwd=True) if steady and not first else None
    for k in range(steady):
        out = forward_step(warm + k, x)
        g = None if last else p2p.exchange(send_fwd=out, recv_bwd=True)
        pending.append((warm + k, out))
        j, o = pending.pop(0)
        gin = backward_step(j, o, g)
        x = None
        if not first:
            if k == steady - 1:
                p2p.exchange(send_bwd=gin)
            else:
                x = p2p.exchange(send_bwd=gin, recv_fwd=True)
    for _ in range(warm):
        j, o = pending.pop(0)
        g = p2p.exchange(recv_bwd=True)
        gin = backward_step(j, o, g)
        if not first:
            p2p.exchange(send_bwd=gin)


def broadcast_from_last(t, group, device):
    """The last stage's tensor ``t`` on every rank of ``group`` (the
    reference psums the one non-zero contribution)."""
    n = group.nranks
    if n == 1:
        return t
    src = group.ranks[-1]
    mine = group.rank == n - 1
    m = _meta(t) if mine else torch.zeros(_META_LEN, dtype=torch.int64)
    collective.broadcast(m, src=src, group=group)
    if not mine:
        shape, dtype = _unmeta(m)
        t = torch.empty(shape, dtype=dtype, device=device)
    with torch.no_grad():
        out = t.detach().contiguous().clone()
        collective.broadcast(out, src=src, group=group)
    return out


# --------------------------------------------------------- functional API

def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def stack_stage_params(per_stage_params):
    """[stage][nest] -> the nest with a leading stage axis."""
    return _tree_map(lambda *xs: torch.stack(xs, dim=0), *per_stage_params)


def _group(mesh, axis_name):
    g = topology.axis_group(axis_name)
    if mesh is not None and axis_name in getattr(mesh, "shape", {}) \
            and int(mesh.shape[axis_name]) != g.nranks:
        raise ValueError(f"mesh axis {axis_name!r} has "
                         f"{mesh.shape[axis_name]} ranks, the topology's "
                         f"group {g.nranks}")
    return g


def _stage_call(fn, remat):
    if not remat:
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _forward_pipeline(stage, x_microbatches, group):
    """Microbatches ``[M, ...]`` through every rank's ``stage(x)``; the
    outputs ``[M, ...]`` on every rank."""
    m = x_microbatches.shape[0]
    p2p = P2P(group, x_microbatches.device)
    outs = [None] * m

    def fwd(i, x):
        with torch.no_grad():
            y = stage(x_microbatches[i] if x is None else x)
        if p2p.s == p2p.n - 1:
            outs[i] = y
        return y

    run_schedule(p2p, m, fwd)
    mine = torch.stack(outs) if p2p.s == p2p.n - 1 else None
    return broadcast_from_last(mine, group, x_microbatches.device)


def pipeline_apply(stage_fn, stacked_params, x_microbatches, mesh=None,
                   axis_name="pp", remat=True):
    """``stage_fn(params_slice, x) -> y`` of each stage in turn over the
    microbatches ``x_microbatches`` ``[M, ...]``; ``[M, ...]`` outputs of
    the last stage on every rank."""
    g = _group(mesh, axis_name)
    params = _tree_map(lambda a: a[max(g.rank, 0)], stacked_params)
    return _forward_pipeline(lambda x: stage_fn(params, x), x_microbatches,
                             g)


def _blocks_stage(block_fn, params, flags):
    def stage(x):
        for j, keep in enumerate(flags.tolist()):
            if keep:
                x = block_fn(_tree_map(lambda a: a[j], params), x)
        return x
    return stage


def pipeline_blocks_apply(block_fn, stacked_params, valid, h, microbatches,
                          mesh=None, axis_name="pp", remat=True):
    """The model's homogeneous blocks over the stages: leaves of
    ``stacked_params`` are ``[pp, L, ...]`` (stage-major, ``L`` slots a
    stage), ``valid`` ``[pp, L]`` marks the slots that hold a block;
    ``h`` ``[B, ...]`` is split into ``microbatches``. Returns ``[B,
    ...]`` after the last block, on every rank."""
    g = _group(mesh, axis_name)
    b, m = h.shape[0], int(microbatches)
    if b % m:
        raise ValueError(f"batch {b} must divide microbatches {m}")
    s = max(g.rank, 0)
    stage = _blocks_stage(block_fn,
                          _tree_map(lambda a: a[s], stacked_params),
                          torch.as_tensor(valid)[s])
    xs = h.reshape((m, b // m) + tuple(h.shape[1:]))
    return _forward_pipeline(stage, xs, g).reshape(h.shape)


def pipeline_loss_and_grad(stage_fn, loss_fn, stacked_params,
                           x_microbatches, y_microbatches, mesh=None,
                           axis_name="pp", remat=True):
    """The mean over the microbatches of ``loss_fn(out, y)`` and its grads
    with respect to ``stacked_params`` (the stacked layout), both on
    every rank, by the 1F1B schedule."""
    g = _group(mesh, axis_name)
    s = max(g.rank, 0)
    m = x_microbatches.shape[0]
    mine = [a[s].detach().clone().requires_grad_()
            for a in _leaves(stacked_params)]
    it = iter(mine)
    params = _tree_map(lambda a: next(it), stacked_params)
    call = _stage_call(lambda x, *p: stage_fn(params, x), remat)
    p2p = P2P(g, x_microbatches.device)
    last = p2p.s == p2p.n - 1
    total = torch.zeros((), dtype=torch.float32,
                        device=x_microbatches.device)
    inputs = {}

    def fwd(i, x):
        if x is None:
            x = x_microbatches[i]
        elif x.is_floating_point():
            x.requires_grad_()
        inputs[i] = x
        y = call(x, *mine)
        if last:
            loss = loss_fn(y, y_microbatches[i]) / m
            total.add_(loss.detach().float())
            return loss
        return y

    def bwd(i, out, grad):
        torch.autograd.backward(out, grad)
        x = inputs.pop(i)
        return x.grad if p2p.s > 0 else None

    run_schedule(p2p, m, fwd, bwd)
    loss = broadcast_from_last(total if last else None, g, total.device)
    grads = []
    for a, p in zip(_leaves(stacked_params), mine):
        full = torch.zeros_like(a)
        if p.grad is not None:
            full[s] = p.grad
        collective.all_reduce(full, group=g)
        grads.append(full)
    it = iter(grads)
    return loss, _tree_map(lambda a: next(it), stacked_params)
