"""Collective communication (a port of
``paddle_tpu/distributed/collective.py``).

One rank is one process on ``torch.distributed``, as in Paddle itself: a
collective combines the values that the ranks of a group each hold. The
reference runs one controller over every chip and treats a Tensor's
leading-axis blocks as the ranks' values (its eager form,
:14-22); the port's rank ``r`` holds what is block ``r`` there. A
:class:`Group` is a set of global ranks with its process group; a group
of one rank (and a world of one) makes every collective the identity,
as the reference does.

The collectives take torch tensors or the port's ``Tensor``. With
``FLAGS_lazy_eager`` on, a collective first runs the pending lazy graph
(``core/lazy.py``), then runs at once, as a host read does. Under
``to_static`` capture a collective on a gloo group raises
``ToStaticError``: gloo runs on the host, which a CUDA graph cannot
hold.

Which route each collective takes is decided up front, from the group's
backend and the tensor's device, from two tables keyed by ``(backend,
op)`` (:data:`CUDA_NATIVE`, :data:`COMPOSED`), never by trying one and
catching its error:

* gloo takes CUDA tensors in ``all_reduce`` and ``broadcast`` only. The
  other collectives of a gloo group on CUDA tensors (``all_gather``,
  ``reduce``, ``scatter``, ``alltoall``, ``reduce_scatter``, ``send``,
  ``recv``) are staged through pinned host memory: copied out, run on
  the host copy, copied back. ``host_staged`` counts them by name and
  ``host_staged_bytes`` the bytes each name copied out. This is the
  route of ranks that share one card (NCCL refuses two ranks on one
  device).
* on gloo, ``reduce_scatter`` is an ``all_reduce`` of the stacked inputs
  of which each rank keeps its own block, and ``ReduceOp.AVG`` a sum
  divided by the group's size.

``_c_identity``/``_mp_allreduce`` (the tensor-parallel pair: identity
forward with an all-reduced grad, and the reverse), ``_c_concat``/
``_c_split`` (gather and split along the last axis), ``_ring_shift``
(each rank's value to the next, the ring attention's hop) and
``_all_to_all`` (the Ulysses exchange) are ``torch.autograd.Function``s
whose backward is the collective's transpose. ``p2p_exchange`` posts a
round of sends and receives at once (the pipeline's neighbours send to
each other in the same round).
"""
import torch
import torch.distributed as dist

from . import env

_GROUPS = {}
_next_group_id = [1]    # gid 0 is the default group
_default = [None]

# (backend, op) that take CUDA tensors: NCCL takes every op, gloo these
# two; gloo's other ops on a CUDA tensor stage through pinned host memory
CUDA_NATIVE = frozenset({("gloo", "all_reduce"), ("gloo", "broadcast")})
# (backend, op) built from other collectives
COMPOSED = frozenset({("gloo", "reduce_scatter"), ("gloo", "avg")})

# collectives staged through pinned host memory, by name, and the bytes
# each name copied out to the host and back
host_staged = {}
host_staged_bytes = {}


def _initialized():
    return dist.is_available() and dist.is_initialized()


class Group:
    """A communication group: global ``ranks`` (in group order), the
    ``torch.distributed`` process group over them (None for one rank or
    before ``init_parallel_env``), the mesh ``axis`` it runs along, if
    any."""

    def __init__(self, ranks, process_group=None, axis=None, gid=None):
        self.ranks = [int(r) for r in ranks]
        self.process_group = process_group
        self.axis = axis
        if gid is None:
            gid = _next_group_id[0]
            _next_group_id[0] += 1
        self.id = gid
        me = env.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return self.nranks

    @property
    def backend(self):
        if self.process_group is None:
            return None
        return str(dist.get_backend(self.process_group))

    def is_member(self):
        return self.rank >= 0

    def get_group_rank(self, rank):
        """The index of global ``rank`` in the group, -1 if not in it."""
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, axis={self.axis}, ranks={self.ranks}, "
                f"backend={self.backend})")


def _default_group():
    world = env.get_world_size() if _initialized() else 1
    cached = _default[0]
    if cached is None or cached.nranks != world or (
            _initialized() and cached.process_group is None):
        pg = dist.group.WORLD if _initialized() and world > 1 else None
        cached = Group(range(world), pg, gid=0)
        _default[0] = cached
        _GROUPS[0] = cached
    return cached


def new_group(ranks=None, backend=None, timeout=None, axis=None):
    """A group over global ``ranks`` (reference collective.py:209); every
    process calls it with the same ranks, in the same order, as
    ``torch.distributed.new_group`` requires. The group is registered so
    ``get_group(g.id)`` finds it again."""
    if ranks is None:
        return _default_group()
    ranks = [int(r) for r in ranks]
    pg = None
    if _initialized() and len(ranks) > 1:
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks, backend=backend, **kw)
    g = Group(ranks, pg, axis=axis)
    _GROUPS[g.id] = g
    return g


def get_group(gid=0):
    if gid == 0:
        return _default_group()
    g = _GROUPS.get(gid)
    if g is None:
        from ..core.errors import InvalidArgumentError
        raise InvalidArgumentError(
            f"no group with id {gid}; create it via new_group")
    return g


def reset():
    """Forget every group (after ``destroy_process_group``)."""
    _GROUPS.clear()
    _default[0] = None


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


def _op_name(op):
    name = op if isinstance(op, str) else "sum"
    if name not in ("sum", "max", "min", "prod", "avg"):
        raise ValueError(f"unknown reduce op {op!r}")
    return name


# ------------------------------------------------------------ plumbing

def _torch(x):
    """The torch tensor of ``x`` after the pending lazy graph has run."""
    from ..core import lazy
    from ..core.tensor import Tensor
    lazy.flush()
    return x._value if isinstance(x, Tensor) else x


def _set(x, value):
    """Write ``value`` into ``x`` (a port ``Tensor`` or a torch tensor)
    in place when the shapes agree, else rebind the port Tensor."""
    from ..core.tensor import Tensor
    t = x._value if isinstance(x, Tensor) else x
    if tuple(t.shape) == tuple(value.shape):
        with torch.no_grad():
            t.copy_(value)
        return x
    if isinstance(x, Tensor):
        x._value = value
        return x
    return value


def _like(x, value):
    from ..core.tensor import Tensor
    return Tensor._wrap(value) if isinstance(x, Tensor) else value


def _check_capture(g, what):
    from ..core import trace as trace_mod
    ctx = trace_mod.current_trace()
    capturing = (ctx is not None and ctx.mode == "capture") or (
        torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())
    if capturing and g.backend == "gloo":
        raise trace_mod.ToStaticError(
            f"{what} on a gloo group inside a captured step: gloo runs on "
            "the host, which a CUDA graph cannot hold (use NCCL, one card "
            "a rank)")


def _staged(g, t, op):
    """Does ``op`` on tensor ``t`` go through pinned host memory?"""
    return g.backend == "gloo" and t.is_cuda \
        and (g.backend, op) not in CUDA_NATIVE


class _Stage:
    """Host copies of CUDA tensors for a gloo collective: ``host(t)``
    gives the pinned copy to run on (with ``t``'s values unless
    ``copy=False``), ``back()`` writes each copy the collective writes
    (``out``) into its tensor; an input only read is never written back,
    so autograd sees no write to it."""

    def __init__(self, g, op, tensors):
        self.on = any(_staged(g, t, op) for t in tensors)
        self.op = op
        self.pairs = []
        if self.on:
            host_staged[op] = host_staged.get(op, 0) + 1

    def host(self, t, copy=True, out=True):
        if not self.on:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        if t.is_cuda:
            host_staged_bytes[self.op] = host_staged_bytes.get(self.op, 0) \
                + t.numel() * t.element_size()
        if copy:
            h.copy_(t)
        if out:
            self.pairs.append((t, h))
        return h

    def back(self):
        for t, h in self.pairs:
            t.copy_(h)


def _group(group):
    return group if group is not None else _default_group()


# ---------------------------------------------------------- collectives

def _all_reduce_t(t, op, g):
    """``t`` all-reduced over ``g`` in place (a torch tensor)."""
    name = _op_name(op)
    if name == "avg" and (g.backend, "avg") in COMPOSED:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g.process_group)
        t.div_(g.nranks)
        return t
    top = dist.ReduceOp.AVG if name == "avg" else _TORCH_OPS[name]
    dist.all_reduce(t, op=top, group=g.process_group)
    return t


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=True):
    """Every rank's ``tensor`` becomes the reduction of all of them
    (reference collective.py:415), in place."""
    g = _group(group)
    _op_name(op)
    if g.nranks == 1:
        return tensor
    _check_capture(g, "all_reduce")
    with torch.no_grad():
        _all_reduce_t(_torch(tensor), op, g)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Appends every rank's ``tensor``, in group order, to
    ``tensor_list`` (reference :589)."""
    g = _group(group)
    if g.nranks == 1:
        tensor_list.append(tensor)
        return tensor_list
    _check_capture(g, "all_gather")
    t = _torch(tensor)
    with torch.no_grad():
        outs = [torch.empty_like(t) for _ in range(g.nranks)]
        st = _Stage(g, "all_gather", [t])
        dist.all_gather([st.host(o, copy=False) for o in outs],
                        st.host(t, out=False), group=g.process_group)
        st.back()
    tensor_list.extend(_like(tensor, o) for o in outs)
    return tensor_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Every rank's ``tensor`` becomes global rank ``src``'s, in place
    (reference :348)."""
    g = _group(group)
    if g.nranks == 1:
        return tensor
    if g.get_group_rank(src) < 0:
        raise ValueError(f"broadcast: src rank {src} not in group "
                         f"{g.ranks}")
    _check_capture(g, "broadcast")
    with torch.no_grad():
        dist.broadcast(_torch(tensor), src=src, group=g.process_group)
    return tensor


def _check_dst(g, dst, what):
    if g.get_group_rank(dst) < 0:
        if g.id == 0:
            raise ValueError(f"{what}: dst rank {dst} out of range for "
                             f"group of size {g.nranks}")
        raise ValueError(f"{what}: dst rank {dst} not in group {g.ranks}")


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):  # noqa: A001
    """Only global rank ``dst`` receives the reduction; the other ranks
    keep their input (reference :495)."""
    g = _group(group)
    _check_dst(g, dst, "reduce")
    if g.nranks == 1:
        return tensor
    _check_capture(g, "reduce")
    t = _torch(tensor)
    with torch.no_grad():
        keep = t.clone()
        st = _Stage(g, "reduce", [t])
        h = st.host(t)
        name = _op_name(op)
        top = _TORCH_OPS["sum" if name == "avg" else name]
        dist.reduce(h, dst=dst, op=top, group=g.process_group)
        if name == "avg":
            h.div_(g.nranks)
        st.back()
        if env.get_rank() != dst:
            t.copy_(keep)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``i`` of the group receives ``tensor_list[i]`` of global rank
    ``src`` into ``tensor`` (reference :667)."""
    g = _group(group)
    if g.nranks == 1:
        if tensor_list:
            _set(tensor, _torch(tensor_list[0]))
        return tensor
    if g.get_group_rank(src) < 0:
        raise ValueError(f"scatter: src rank {src} not in group {g.ranks}")
    _check_capture(g, "scatter")
    t = _torch(tensor)
    with torch.no_grad():
        st = _Stage(g, "scatter", [t])
        lst = None
        if env.get_rank() == src:
            if tensor_list is None or len(tensor_list) != g.nranks:
                raise ValueError(
                    f"scatter: need exactly {g.nranks} tensors on the "
                    f"source rank, got "
                    f"{0 if tensor_list is None else len(tensor_list)}")
            lst = [st.host(_torch(x).contiguous(), out=False)
                   for x in tensor_list]
        dist.scatter(st.host(t, copy=False), lst, src=src,
                     group=g.process_group)
        st.back()
    return tensor


def _check_blocks(what, vals, n):
    if len(vals) != n:
        raise ValueError(f"{what}: need exactly {n} input tensors (one per "
                         f"rank), got {len(vals)}")
    shapes = {tuple(v.shape) for v in vals}
    if len(shapes) != 1:
        raise ValueError(f"{what}: the input tensors differ in shape: "
                         f"{sorted(shapes)}")


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Rank ``r`` receives ``in_tensor_list[r]`` of every rank ``j`` as
    its ``out[j]`` (reference alltoall)."""
    g = _group(group)
    n = g.nranks
    if n == 1:
        outs = list(in_tensor_list)
    else:
        _check_capture(g, "alltoall")
        vals = [_torch(x) for x in in_tensor_list]
        _check_blocks("alltoall", vals, n)
        with torch.no_grad():
            src = torch.stack(vals)
            dst = torch.empty_like(src)
            st = _Stage(g, "alltoall", [src])
            dist.all_to_all_single(st.host(dst, copy=False),
                                   st.host(src, out=False),
                                   group=g.process_group)
            st.back()
        outs = [_like(in_tensor_list[0], o) for o in dst.unbind(0)]
    if out_tensor_list is not None:
        out_tensor_list.extend(outs)
        return out_tensor_list
    return outs


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Rank ``r`` receives the reduction over the ranks of their
    ``tensor_list[r]`` into ``tensor`` (reference reduce_scatter). With
    no ``tensor_list``, ``tensor`` is split in ``nranks`` blocks along
    its first axis and rank ``r`` keeps the reduction of the blocks
    ``r`` (a new tensor of the block's shape; a port Tensor is rebound to
    it)."""
    g = _group(group)
    n = g.nranks
    if tensor_list is not None:
        vals = [_torch(x) for x in tensor_list]
        if n == 1:
            return _set(tensor, vals[0])
        _check_blocks("reduce_scatter", vals, n)
        blocks = torch.stack(vals)
    else:
        t = _torch(tensor)
        if n == 1:
            return tensor
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(
                f"reduce_scatter: leading dim of shape {tuple(t.shape)} is "
                f"not divisible by group size {n}")
        blocks = t.reshape((n, t.shape[0] // n) + tuple(t.shape[1:]))
    _check_capture(g, "reduce_scatter")
    with torch.no_grad():
        if (g.backend, "reduce_scatter") in COMPOSED:
            full = blocks.clone()
            _all_reduce_t(full, op, g)
            mine = full[g.rank].clone()
        else:
            mine = torch.empty_like(blocks[0])
            name = _op_name(op)
            top = dist.ReduceOp.AVG if name == "avg" else _TORCH_OPS[name]
            dist.reduce_scatter(mine, list(blocks.unbind(0)), op=top,
                                group=g.process_group)
    return _set(tensor, mine)


def barrier(group=None):
    """Every rank of the group reaches this point before any leaves it;
    the card's queued work is finished first."""
    g = _group(group)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if g.nranks > 1:
        dist.barrier(group=g.process_group)


def wait(tensor, group=None, use_calc_stream=True):
    """The collectives here are synchronous; ``wait`` finishes the work
    queued on ``tensor``'s card."""
    t = _torch(tensor)
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return tensor


_P2P_STAGE = {}


def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to global rank ``dst`` (reference send). In a
    world of one the value is staged for the matching ``recv`` (the
    reference's loopback)."""
    g = _group(group)
    if g.nranks == 1:
        _P2P_STAGE.setdefault(g.id, []).append(_torch(tensor).clone())
        return tensor
    _check_dst(g, dst, "send")
    _check_capture(g, "send")
    t = _torch(tensor).contiguous()
    st = _Stage(g, "send", [t])
    dist.send(st.host(t, out=False), dst=dst, group=g.process_group)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` from global rank ``src`` (reference
    recv)."""
    g = _group(group)
    if g.nranks == 1:
        staged = _P2P_STAGE.get(g.id, [])
        if staged:
            _set(tensor, staged.pop(0))
        return tensor
    if g.get_group_rank(src) < 0:
        raise ValueError(f"recv: src rank {src} not in group {g.ranks}")
    _check_capture(g, "recv")
    t = _torch(tensor)
    with torch.no_grad():
        st = _Stage(g, "recv", [t])
        dist.recv(st.host(t, copy=False), src=src, group=g.process_group)
        st.back()
    return tensor


def p2p_exchange(sends=(), recvs=(), group=None):
    """Post every ``(tensor, dst)`` send and ``(tensor, src)`` receive
    (global ranks) at once and wait for all of them: neighbours that
    send to each other at the same moment do not wait on each other. A
    receive writes its tensor in place. On gloo, CUDA tensors are staged
    through pinned host memory (``host_staged["send"]`` / ``["recv"]``)."""
    g = _group(group)
    _check_capture(g, "p2p_exchange")
    sends = [(_torch(t).contiguous(), d) for t, d in sends]
    recvs = [(_torch(t), s) for t, s in recvs]
    with torch.no_grad():
        st_s = _Stage(g, "send", [t for t, _ in sends])
        st_r = _Stage(g, "recv", [t for t, _ in recvs])
        reqs = [dist.irecv(st_r.host(t, copy=False), src=s,
                           group=g.process_group) for t, s in recvs]
        reqs += [dist.isend(st_s.host(t, out=False), dst=d,
                            group=g.process_group) for t, d in sends]
        for r in reqs:
            r.wait()
        st_r.back()


def get_rank(group=None):
    """This process's rank in ``group`` (global rank without one)."""
    if group is None:
        return env.get_rank()
    return group.rank


def get_world_size(group=None):
    if group is None:
        return env.get_world_size()
    return group.nranks


def is_initialized():
    return _initialized()


# ------------------------------------------- differentiable collectives

def _ar(t, g):
    out = t.contiguous().clone()
    with torch.no_grad():
        st = _Stage(g, "all_reduce", [out])
        _all_reduce_t(out, "sum", g)
        st.back()
    return out


def _gather_last(t, g):
    """Every rank's ``t`` concatenated along the last axis, group
    order."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(g.nranks)]
    st = _Stage(g, "all_gather", [t])
    dist.all_gather([st.host(o, copy=False) for o in outs],
                    st.host(t, out=False), group=g.process_group)
    st.back()
    return torch.cat(outs, dim=-1)


def _split_last(t, g):
    n = t.shape[-1] // g.nranks
    return t[..., g.rank * n:(g.rank + 1) * n].contiguous()


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ar(grad, ctx.g), None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _ar(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _gather_last(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _split_last(grad, ctx.g), None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _split_last(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _gather_last(grad, ctx.g), None


def _mp_group(group):
    from . import topology
    return topology.axis_group("mp", group)


def _c_identity(tensor, group=None):
    """Identity forward, grad all-reduced over the ``mp`` group backward
    (reference :461)."""
    g = _mp_group(group)
    if g.nranks == 1:
        return tensor
    _check_capture(g, "_c_identity")
    return _CIdentity.apply(tensor, g)


def _mp_allreduce(tensor, op=ReduceOp.SUM, group=None,
                  use_calc_stream=True, use_model_parallel=True):
    """All-reduce (sum) forward, grad passed through backward (reference
    :485)."""
    g = _mp_group(group)
    if g.nranks == 1:
        return tensor
    _check_capture(g, "_mp_allreduce")
    return _MpAllreduce.apply(tensor, g)


def _c_concat(tensor, group=None):
    """Every rank's ``tensor`` concatenated along the last axis; the grad
    of this rank's slice backward."""
    g = _mp_group(group)
    if g.nranks == 1:
        return tensor
    _check_capture(g, "_c_concat")
    return _CConcat.apply(tensor, g)


def _c_split(tensor, group=None):
    """This rank's slice of the last axis; the gathered grad backward."""
    g = _mp_group(group)
    if g.nranks == 1:
        return tensor
    _check_capture(g, "_c_split")
    return _CSplit.apply(tensor, g)


def _shift(t, g, step):
    """Each rank's ``t`` to the rank ``step`` after it in the group; the
    value of the rank ``step`` before it comes back."""
    t = t.contiguous()
    out = torch.empty_like(t)
    st = _Stage(g, "send", [t])
    nxt = g.ranks[(g.rank + step) % g.nranks]
    prv = g.ranks[(g.rank - step) % g.nranks]
    hs, hr = st.host(t, out=False), st.host(out, copy=False)
    reqs = [dist.irecv(hr, src=prv, group=g.process_group),
            dist.isend(hs, dst=nxt, group=g.process_group)]
    for r in reqs:
        r.wait()
    st.back()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _shift(x, g, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.g, -1), None


def _ring_shift(tensor, group):
    """Rank ``i``'s ``tensor`` goes to rank ``i + 1`` of the group (the
    reference's ``ppermute`` around the ring); its grad goes back."""
    if group.nranks == 1:
        return tensor
    _check_capture(group, "ring shift")
    return _RingShift.apply(tensor, group)


def _a2a(t, g, split_dim, concat_dim):
    parts = [p.contiguous() for p in t.chunk(g.nranks, dim=split_dim)]
    src = torch.stack(parts)
    dst = torch.empty_like(src)
    st = _Stage(g, "alltoall", [src])
    dist.all_to_all_single(st.host(dst, copy=False), st.host(src, out=False),
                           group=g.process_group)
    st.back()
    return torch.cat(dst.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split_dim, concat_dim):
        ctx.args = (g, split_dim, concat_dim)
        return _a2a(x, g, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        g, split_dim, concat_dim = ctx.args
        return _a2a(grad, g, concat_dim, split_dim), None, None, None


def _all_to_all(tensor, group, split_dim, concat_dim):
    """``tensor`` split in ``nranks`` blocks along ``split_dim``, block
    ``j`` sent to rank ``j``, the received blocks concatenated along
    ``concat_dim`` in group order (``lax.all_to_all(tiled=True)``)."""
    if group.nranks == 1:
        return tensor
    _check_capture(group, "all_to_all")
    return _AllToAll.apply(tensor, group, split_dim, concat_dim)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Reference collective.py:558 — builds the tensor-parallel layer of
    ``operation`` over the ``mp`` group and applies it to ``x``."""
    from .fleet.meta_parallel.mp_layers import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    dev = _torch(x).device
    if operation == "linear":
        in_f, out_f = size
        if axis == 1:
            layer = ColumnParallelLinear(in_f, out_f,
                                         gather_output=gather_out,
                                         has_bias=bias_attr is not False,
                                         device=dev)
        else:
            layer = RowParallelLinear(in_f, out_f, input_is_parallel=False,
                                      has_bias=bias_attr is not False,
                                      device=dev)
        return layer(_torch(x))
    if operation == "embedding":
        vocab, dim = size
        return VocabParallelEmbedding(vocab, dim, device=dev)(_torch(x))
    raise ValueError(f"unknown split operation {operation!r}")
