"""Lazy eager executor (a port of ``paddle_tpu/core/lazy.py``).

With ``FLAGS_lazy_eager`` on (the default), an eager op does not run
when it is called: ``Op.__call__`` (``core/dispatch.py``) appends it to
the thread's ``LazyGraph`` and hands back a Tensor over a ``LazyArray``
placeholder. The placeholder carries the output's shape, strides, dtype,
device and ``requires_grad`` (its ``stop_gradient``), which come from
running the op's body once on ``torch.device("meta")`` tensors, cached
by op, attributes and input metadata (the reference's ``_aval_cache``
over ``jax.eval_shape``). A backward (``core/engine.py``), an optimizer
``step()`` (``optimizer/optimizer.py``) and a write of a pending value
into a Tensor that existed before (``Tensor._assign``) are deferred as
nodes too, so a whole eager training step is one graph.

The graph runs at a flush: a host read (``numpy``, ``item``, ``float``,
``bool``, ...), any use of a pending Tensor's torch value outside the
dispatcher (``Tensor._value``), ``optimizer.clear_grad()``, a write to
an existing Tensor, ``to_static`` / program building / ``Executor.run``
on entry, an op that cannot be deferred (``Fallback``: an output shape
that depends on values, such as ``nonzero`` or ``masked_select``), or
``_MAX_NODES`` pending nodes. The nodes run in record order:

* on the CPU, in one Python call;
* on CUDA, by the replay-cache key (the nodes and their wiring, the
  consts' shapes, dtypes and devices, the live outputs; each node's
  key holds its grad mode and its ``auto_cast`` dtype, fixed at
  record), as ``jit.to_static`` runs a step (``jit/to_static.py``): a
  key's first flush runs the nodes one by one (warm-up), its second
  under a recording trace (the leaves that take grads, the generators,
  the writes), its third captures them into one CUDA graph and replays
  it, and every later flush replays it. Each generator drawn from is
  registered with the graph, so every replay draws anew; the leaves'
  grad-is-None state keys the graphs as ``to_static`` keys them.

Consts (inputs that no pending node made) are bound two ways. A
persistable Tensor's storage (parameters, buffers) and the storage a
deferred write targets are bound by address: the graph reads and writes
them in place, and a replay checks their addresses. Any other const (a
batch made from host data, a scalar tensor, a value an earlier flush
handed back) is copied into a static buffer at each replay. Live
outputs (placeholders still referenced) come back as clones.
Optimizer state and the 0-d learning rate are read by the step node
itself, by address, as a captured ``to_static`` step reads them.

A CUDA segment is captured only when its record shows nothing a graph
cannot replay; otherwise every flush of its key runs node by node on
the card and ``stats["eager"]`` counts it. It does not qualify when a
live output still carries an autograd graph that no backward of the
segment released (a ``float(loss)`` before ``backward()``), a live
output shares storage with a const or another live output (a view), a
const carries an autograd graph from outside the segment or is a
fresh leaf that takes grads, a node runs on the CPU, a tensor hook or a
``PyLayer`` ran (host code a replay would skip), a leaf's grad is sparse
(its rows, and the optimizer's coalesce, depend on the data), or a
Tensor was rebound.
A qualifying segment whose capture fails raises ``ToStaticError`` with
its cause; nothing runs eagerly in its place.

All entries of one thread share one graph pool (``pool_bytes()``) and
capture on the thread's capture stream (``trace.capture_stream()``,
which ``clear()`` keeps, so no new cuBLAS workspace is carved);
``_MAX_CACHED_REPLAYS`` entries are kept, the oldest evicted first with
its graphs, and an entry whose parameters or optimizer were freed is
dropped at the next insertion or at its key's next flush (new ones may
sit at the freed ones' addresses). ``stats`` counts the flushes by form
(``cpu``, ``warmup``, ``record``, ``capture``, ``replay``, ``eager``)
and the ops that fell back; ``forms`` holds the recent flushes' forms
and node counts, ``forms_since`` those after a count of ``flushes``.
"""
import collections
import contextlib
import itertools
import threading
import weakref

import torch

from . import flags as flags_mod
from . import trace as _trace

_MAX_NODES = 4096
_MAX_CACHED_REPLAYS = 64
# the metadata and interned-key caches key on Python scalar inputs and
# attributes, which a loop may change every step: both drop their oldest
# entries past these sizes (an id is never reused, so a dropped key only
# misses)
_MAX_META = 1 << 14
_MAX_INTERNED = 1 << 16

_state = threading.local()
# guards the caches below, which every thread's graphs share
_lock = threading.Lock()

_replay_cache = {}      # key -> _Entry, oldest first
_meta_cache = collections.OrderedDict()   # node key + input metadata ->
                                          # output metadata
_intern_ids = collections.OrderedDict()
_next_id = itertools.count()
# deferred writes (backward, step, assign) pending in any thread: a read
# of a Tensor's torch value flushes while there are any
_writes = [0]

stats = collections.Counter()
forms = collections.deque(maxlen=512)   # (form, nodes) of recent flushes
flushes = [0]                           # flushes so far

_FALLBACK = object()    # a meta-cache entry for an op that cannot defer


class Fallback(Exception):
    """An op that cannot be deferred: the pending graph is flushed and the
    op runs immediately."""


def enabled():
    """True when an op called now defers: the flag is on, no trace is
    active (``to_static``'s record or capture) and no flush, meta run or
    ``suspended()`` block is in progress on this thread."""
    if not flags_mod.get_flag("FLAGS_lazy_eager"):
        return False
    return _trace._active is None and not getattr(_state, "suspended", 0)


@contextlib.contextmanager
def suspended():
    """Ops called inside run immediately (the pending graph stays)."""
    _state.suspended = getattr(_state, "suspended", 0) + 1
    try:
        yield
    finally:
        _state.suspended -= 1


def _put(cache, key, value, cap):
    """Store ``value`` under ``key``, dropping the oldest entries past
    ``cap``; returns the value stored first, when another thread got
    there before."""
    with _lock:
        value = cache.setdefault(key, value)
        while len(cache) > cap:
            cache.popitem(last=False)
    return value


def _intern(key):
    """A structured key as a small int, never given to another key."""
    i = _intern_ids.get(key)
    if i is None:
        i = _put(_intern_ids, key, next(_next_id), _MAX_INTERNED)
    return i


class LazyArray:
    """The placeholder of a deferred op's output: its metadata, read
    without a flush, and its value once the graph has run."""
    __slots__ = ("_graph", "_ref", "shape", "_stride", "dtype", "device",
                 "requires_grad", "_concrete", "__weakref__")

    def __init__(self, graph, ref, shape, stride, dtype, device,
                 requires_grad):
        self._graph = graph
        self._ref = ref
        self.shape = shape
        self._stride = stride
        self.dtype = dtype
        self.device = device
        self.requires_grad = requires_grad
        self._concrete = None

    # -- the torch metadata the port reads (no flush) ------------------
    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()

    def element_size(self):
        return torch.empty((), dtype=self.dtype, device="meta").element_size()

    # -- the value -----------------------------------------------------
    def materialize(self):
        if self._concrete is None:
            g = self._graph
            if g is None:
                raise RuntimeError("deferred value has no graph and no "
                                   "concrete result (internal error)")
            g.flush()
            if self._concrete is None:
                raise RuntimeError(
                    "deferred value lost: its lazy graph failed to run "
                    f"({g.error!r})") from g.error
        return self._concrete

    def __array__(self, dtype=None, copy=None):
        v = self.materialize().detach()
        a = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
        return a.astype(dtype) if dtype is not None else a

    def __getattr__(self, item):
        # any other torch attribute: the value (its graph runs first);
        # never a private name, which is a real missing attribute
        if item.startswith("_"):
            raise AttributeError(item)
        return getattr(self.materialize(), item)

    def __repr__(self):
        if self._concrete is not None:
            return repr(self._concrete)
        return (f"LazyArray(shape={list(self.shape)}, dtype={self.dtype}, "
                f"device={self.device}, deferred)")


def _meta_of(x):
    """A meta tensor with ``x``'s shape, strides, dtype and
    requires_grad."""
    if isinstance(x, LazyArray):
        shape, stride, rg = x.shape, x._stride, x.requires_grad
    else:
        if x.layout != torch.strided:
            raise Fallback(f"{x.layout} input")
        shape, stride, rg = x.shape, x.stride(), x.requires_grad
    m = torch.empty_strided(shape, stride, dtype=x.dtype, device="meta")
    if rg:
        m.requires_grad_(True)
    return m


def _sig_of(x):
    if isinstance(x, LazyArray):
        return ("t", tuple(x.shape), x._stride, x.dtype, x.device.type,
                x.requires_grad)
    if isinstance(x, torch.Tensor):
        if x.layout != torch.strided:
            raise Fallback(f"{x.layout} input")
        return ("t", tuple(x.shape), x.stride(), x.dtype, x.device.type,
                x.requires_grad)
    return ("s", type(x), x)


def _infer(fn, key, inputs):
    """The output metadata of ``fn`` over ``inputs``: (multi, [(shape,
    stride, dtype, device or None, requires_grad)]), from a run on meta
    tensors, cached."""
    mkey = (key, tuple(_sig_of(a) for a in inputs))
    hit = _meta_cache.get(mkey)
    if hit is _FALLBACK:
        raise Fallback(f"{key[0]!r} cannot be deferred")
    if hit is not None:
        return hit
    metas = [_meta_of(a) if isinstance(a, (LazyArray, torch.Tensor))
             else a for a in inputs]
    try:
        with suspended():
            outs = fn(*metas)
    except Exception as e:   # noqa: BLE001 - value-dependent: run it
        _put(_meta_cache, mkey, _FALLBACK, _MAX_META)
        raise Fallback(f"{key[0]!r} cannot run on meta: {e}") from e
    multi = isinstance(outs, (tuple, list))
    out_list = list(outs) if multi else [outs]
    meta = []
    for o in out_list:
        if not isinstance(o, torch.Tensor) or o.layout != torch.strided:
            _put(_meta_cache, mkey, _FALLBACK, _MAX_META)
            raise Fallback(f"{key[0]!r} returns {type(o).__name__}")
        dev = None if o.device.type == "meta" else o.device
        meta.append((o.shape, o.stride(), o.dtype, dev, o.requires_grad))
    return _put(_meta_cache, mkey, (multi, tuple(meta)), _MAX_META)


class _Node:
    __slots__ = ("run", "args", "outs", "out_wrefs", "cache_key")

    def __init__(self, run, args, outs, cache_key):
        self.run = run
        self.args = args          # ("c", i) | ("n", node, out) | ("s", v)
        self.outs = outs          # [(requires_grad, device)]
        self.out_wrefs = []
        self.cache_key = cache_key


class LazyGraph:
    def __init__(self):
        self.nodes = []
        self.consts = []
        self.bound = []           # per const: bound by address
        self.owners = []          # per const: weakref of its Tensor
        self.holders = []         # weakrefs of objects a node's run reads
        self._const_ids = {}
        self.writes = 0
        self.cuda = False
        self.flushed = False
        self.error = None
        # the lazy nodes and torch autograd nodes a pending backward
        # without retain_graph will release
        self.released = set()
        self.released_fns = set()

    # -- building ------------------------------------------------------
    def const_ref(self, t, owner=None, bound=False):
        idx = self._const_ids.get(id(t))
        if idx is None:
            idx = len(self.consts)
            self.consts.append(t)
            self.bound.append(bound)
            self.owners.append(None if owner is None
                               else weakref.ref(owner))
            self._const_ids[id(t)] = idx
        elif bound and not self.bound[idx]:
            self.bound[idx] = True
            if owner is not None:
                self.owners[idx] = weakref.ref(owner)
        return ("c", idx)

    def ref_of(self, a, owner=None, bound=False):
        if isinstance(a, LazyArray):
            if a._concrete is not None:
                return self.const_ref(a._concrete, owner, bound)
            if a._graph is not self:
                return self.const_ref(a.materialize(), owner, bound)
            return a._ref
        if isinstance(a, torch.Tensor):
            return self.const_ref(a, owner, bound)
        return ("s", a)

    def append(self, run, key, inputs, owners=(), writer=False,
               bound=(), device=None, holder=None):
        """Defer ``run(*inputs)``; returns its outputs' placeholders (a
        tuple when ``run`` returns several, None when it returns none).
        ``owners[i]``: the Tensor input i came from (a persistable one is
        bound by address), ``bound``: the inputs bound by address
        whatever their owner (the targets of writes), ``holder``: an
        object whose state ``run`` reads by address (an optimizer): the
        replay entry dies with it."""
        multi, meta = _infer(run, key, inputs) if not writer \
            else (True, ())
        dev = device
        for a in inputs:
            if isinstance(a, (LazyArray, torch.Tensor)):
                if dev is None or a.device.type == "cuda":
                    dev = a.device
        if dev is None and meta:
            raise Fallback(f"{key[0]!r} has no tensor input")
        refs = []
        for i, a in enumerate(inputs):
            owner = owners[i] if i < len(owners) else None
            keep = i in bound or (owner is not None
                                  and getattr(owner, "persistable", False))
            refs.append(self.ref_of(a, owner, keep))
        refs = tuple(refs)
        node_idx = len(self.nodes)
        outs = [(rg, d if d is not None else dev)
                for _, _, _, d, rg in meta]
        node = _Node(run, refs, outs, _intern((key, tuple(
            r if r[0] != "s" else ("s", type(r[1]), r[1]) for r in refs))))
        if dev is not None and dev.type == "cuda" or any(
                d.type == "cuda" for _, d in outs):
            self.cuda = True
        self.nodes.append(node)
        if holder is not None:
            self.holders.append(weakref.ref(holder))
        if writer:
            self.writes += 1
            _writes[0] += 1
        placeholders = []
        for j, (shape, stride, dtype, d, rg) in enumerate(meta):
            la = LazyArray(self, ("n", node_idx, j), shape, stride, dtype,
                           d if d is not None else dev, rg)
            node.out_wrefs.append(weakref.ref(la))
            placeholders.append(la)
        if not meta:
            return None
        return tuple(placeholders) if multi else placeholders[0]

    def reach(self, la):
        """The lazy nodes a backward from placeholder ``la`` walks (through
        outputs that take grads), and the concrete consts with an
        autograd graph it reaches."""
        seen, consts, stack = set(), [], [la._ref[1]]
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            for r in self.nodes[i].args:
                if r[0] == "n":
                    if self.nodes[r[1]].outs[r[2]][0]:
                        stack.append(r[1])
                elif r[0] == "c":
                    c = self.consts[r[1]]
                    if c.requires_grad and c.grad_fn is not None:
                        consts.append(c)
        return seen, consts

    # -- running -------------------------------------------------------
    def flush(self):
        if self.flushed:
            return
        self.flushed = True
        if getattr(_state, "graph", None) is self:
            _state.graph = None
        _writes[0] -= self.writes
        if not self.nodes:
            return
        live, live_arrays = [], []
        for i, n in enumerate(self.nodes):
            for j, w in enumerate(n.out_wrefs):
                la = w()
                if la is not None and la._concrete is None:
                    live.append((i, j))
                    live_arrays.append(la)
        try:
            with suspended():
                outs = _run_segment(self, tuple(live))
        except BaseException as e:
            self.error = e
            raise
        for la, val in zip(live_arrays, outs):
            if la.requires_grad and not val.requires_grad:
                # a replay hands back a clone: it keeps stop_gradient
                val.requires_grad_(True)
            la._concrete = val
            la._graph = None
        self.nodes = self.consts = self._const_ids = None


def _const_key(c, cuda):
    sig = (tuple(c.shape), c.dtype, c.device.type, c.requires_grad,
           c.grad_fn is not None)
    if cuda and c.device.type == "cpu" and c.numel() == 1:
        # a CPU scalar joins a CUDA kernel by value: a graph holds it
        sig += (c.item(),)
    return _intern(sig)


def _drops(nodes, live):
    """Per node, the values no later node reads and no live output is
    (freed after it runs, as eager frees them)."""
    last = {}
    for k, n in enumerate(nodes):
        for r in n.args:
            if r[0] == "n":
                last[(r[1], r[2])] = k
    keep = set(live)
    drops = [[] for _ in nodes]
    for i, n in enumerate(nodes):
        for j in range(len(n.outs)):
            if (i, j) not in keep:
                drops[last.get((i, j), i)].append((i, j))
    return drops


def _run_nodes(nodes, consts, live, drops):
    vals = []
    for k, n in enumerate(nodes):
        args = [consts[r[1]] if r[0] == "c" else
                vals[r[1]][r[2]] if r[0] == "n" else r[1] for r in n.args]
        out = n.run(*args)
        vals.append(list(out) if isinstance(out, (tuple, list))
                    else [] if out is None else [out])
        for i, j in drops[k]:
            vals[i][j] = None
    return tuple(vals[i][j] for i, j in live)


class _Entry:
    """One replay-cache key's state: its drop lists, and on CUDA the
    capture (``seg``), whether it qualifies, its bound consts' owners."""

    def __init__(self, graph, live):
        self.drops = _drops(graph.nodes, live)
        self.seg = None
        self.eager = None     # the reason it does not qualify, or None
        # what its graphs read by address: the bound consts' Tensors and
        # the holders (a fresh const is copied in at each replay)
        self.owners = [o for o, b in zip(graph.owners, graph.bound)
                       if o is not None and b] + graph.holders
        self.ptrs = None

    def alive(self):
        return all(o() is not None for o in self.owners)


def _shared():
    """This thread's capture stream and graph pools (every entry's)."""
    sh = getattr(_state, "shared", None)
    if sh is None:
        sh = _state.shared = {"pool": None, "stream": None,
                              "body_pool": None}
    return sh


def pool_bytes():
    """Bytes the card holds in this thread's graph pool."""
    pool = _shared()["pool"]
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _entry_for(key, graph, live):
    """The replay-cache entry of ``key``, made and inserted on a miss or
    when the entry's parameters or holders were freed (new ones may sit
    at their addresses: the entry's graphs are not theirs)."""
    entry = _replay_cache.get(key)
    if entry is not None and entry.alive():
        return entry
    entry = _Entry(graph, live)
    with _lock:
        for k in [k for k, e in _replay_cache.items() if not e.alive()]:
            del _replay_cache[k]
        while len(_replay_cache) >= _MAX_CACHED_REPLAYS:
            # FIFO: the oldest entry goes, and its graphs with it
            _replay_cache.pop(next(iter(_replay_cache)))
        return _replay_cache.setdefault(key, entry)


def clear():
    """Drop every replay-cache entry and its graphs, and this thread's
    graph pool (which ``torch.cuda.empty_cache`` can then return once
    nothing allocated from it is alive)."""
    with _lock:
        _replay_cache.clear()
    _state.shared = None


def _note(form, graph):
    stats[form] += 1
    flushes[0] += 1
    forms.append((form, len(graph.nodes)))


def forms_since(count):
    """The forms of the flushes after the ``count``-th (``flushes[0]``
    read before), the latest ``forms.maxlen`` of them."""
    n = flushes[0] - count
    return [f for f, _ in list(forms)[-n:]] if n > 0 else []


def _run_segment(graph, live):
    cuda = graph.cuda or any(c.is_cuda for c in graph.consts)
    key = (tuple(n.cache_key for n in graph.nodes),
           tuple(_const_key(c, cuda) for c in graph.consts),
           tuple(graph.bound), live,
           threading.get_ident() if cuda else 0)
    entry = _entry_for(key, graph, live)
    if not cuda:
        _note("cpu", graph)
        return _run_nodes(graph.nodes, graph.consts, live, entry.drops)
    if entry.eager is None:
        entry.eager = _disqualified_by_consts(graph)
    if entry.eager is not None:
        _note("eager", graph)
        return _run_nodes(graph.nodes, graph.consts, live, entry.drops)
    return _run_captured(graph, live, entry)


def _disqualified_by_consts(graph):
    for n in graph.nodes:
        for _, d in n.outs:
            if d.type != "cuda":
                return "a node runs on the CPU"
    for c, b in zip(graph.consts, graph.bound):
        if c.requires_grad and c.grad_fn is not None:
            return "a const carries an autograd graph from outside"
        if c.requires_grad and not b:
            return "a fresh leaf takes grads"
    return None


def _disqualified_by_run(graph, outs, callbacks):
    from .engine import _RELEASED, host_callbacks
    if host_callbacks[0] != callbacks:
        return "a tensor hook or a PyLayer ran"
    for c in graph.consts:
        if c.requires_grad and c.grad is not None \
                and c.grad.layout != torch.strided:
            return "a sparse grad (its rows depend on the data)"
    stores = {c.untyped_storage().data_ptr() for c in graph.consts}
    for o in outs:
        if o.requires_grad and (o.grad_fn is None
                                or not o.grad_fn.metadata.get(_RELEASED)):
            return "a live output carries an autograd graph"
        if o.layout != torch.strided:
            return "a live output is not strided"
        p = o.untyped_storage().data_ptr()
        if p in stores:
            return "a live output shares storage with a const or another"
        stores.add(p)
    return None


def _run_captured(graph, live, entry):
    from ..amp.auto_cast import _state as amp_state
    from .engine import host_callbacks
    bound = [c for c, b in zip(graph.consts, graph.bound) if b]
    fresh = [c for c, b in zip(graph.consts, graph.bound) if not b]
    ptrs = tuple(c.data_ptr() for c in bound)
    if entry.seg is None or (entry.ptrs is not None and ptrs != entry.ptrs):
        # new, or a bound const moved (its graphs read the old storage)
        entry.seg, entry.ptrs = _new_segment(entry), None
    seg = entry.seg
    seg.graph, seg.live, seg.bound_now = graph, live, bound
    before = host_callbacks[0]
    # every node holds its own grad mode and casts: the call is keyed
    # without the ones the flush happens under
    amp, amp_state.amp = amp_state.amp, None
    try:
        with torch.enable_grad():
            outs = seg._dispatch(tuple(fresh), {})
            form = seg.last_form
    finally:
        amp_state.amp = amp
        seg.graph = seg.bound_now = None
    if form in ("warmup", "record"):
        why = _disqualified_by_run(graph, outs, before) or (
            "a Tensor was rebound" if form == "record" and seg.rebinds
            else None)
        if why is not None:
            entry.eager = why
            entry.seg = None
            form = "eager"
    elif form == "capture":
        entry.ptrs = ptrs
    _note(form, graph)
    return outs


def _make_segment_class():
    from ..jit.to_static import TracedFunction, _Record

    class _Segment(TracedFunction):
        """One replay-cache entry's step, as ``to_static`` runs a step:
        its argument is the fresh consts, its output the live values."""

        def __init__(self, entry):
            self._entry = entry
            super().__init__(self._run, warmup=1, enable_ast=False)
            self.rebinds = ()
            self.graph = self.live = self.bound_now = None

        def _run(self, *fresh):
            g = self.graph
            it_b, it_f = iter(self.bound_now), iter(fresh)
            consts = [next(it_b) if b else next(it_f) for b in g.bound]
            return _run_nodes(g.nodes, consts, self.live, self._entry.drops)

        def _record(self, entry, args, kwargs, leaves):
            ctx = _trace.TraceContext("record")
            out = self._eager(args, kwargs, leaves, ctx)
            self.rebinds = tuple(ctx.rebinds.values())
            entry["record"] = _Record(ctx)
            return out

    return _Segment


_segment_cls = []


def _new_segment(entry):
    if not _segment_cls:
        _segment_cls.append(_make_segment_class())
    seg = _segment_cls[0](entry)
    seg._shared = _shared()
    return seg


# -- the thread's graph ---------------------------------------------------
def _cur():
    g = getattr(_state, "graph", None)
    if g is None:
        g = _state.graph = LazyGraph()
    return g


def current():
    """This thread's pending graph, or None."""
    return getattr(_state, "graph", None)


def pending():
    """True when this thread has deferred nodes that have not run."""
    g = getattr(_state, "graph", None)
    return g is not None and bool(g.nodes)


def flush():
    """Run this thread's pending graph (a step boundary, a host read, a
    write)."""
    g = getattr(_state, "graph", None)
    if g is not None:
        g.flush()


def flush_writes():
    """Flush this thread's graph if it holds a deferred write."""
    g = getattr(_state, "graph", None)
    if g is not None and g.writes:
        g.flush()


def concrete(x):
    return x.materialize() if isinstance(x, LazyArray) else x


def dispatch(fn, fn_key, inputs, owners=(), writer=False, bound=(),
             device=None, holder=None):
    """Defer ``fn(*inputs)`` into this thread's graph; returns the output
    placeholder(s) (None for a writer, a node run for what it writes:
    its ``device`` says where; ``holder``: see ``LazyGraph.append``).
    Raises ``Fallback`` for an op that cannot defer."""
    g = _cur()
    if len(g.nodes) >= _MAX_NODES:
        g.flush()
        g = _cur()
    return g.append(fn, fn_key, inputs, owners, writer, bound, device,
                    holder)
