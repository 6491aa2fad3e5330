"""The backward engine (a port of ``paddle_tpu/core/engine.py``) on
torch's own autograd: there is no second tape.

Torch keeps the graph each op records, accumulates leaf grads into
``.grad`` across backward calls and runs tensor hooks. What this module
adds is the reference's visible semantics where torch's differ:

* **a released graph raises.** The reference marks every node a backward
  without ``retain_graph`` went through and raises on the next backward
  through any of them. Torch raises only where a node's saved tensors
  were freed (``x * 2`` saves none). So each backward marks the nodes it
  walks (``Node.metadata``) and the next one through them raises the
  reference's RuntimeError first. Leaf accumulators are never marked: a
  leaf goes on to other graphs.
* **hooks under create_graph raise** NotImplementedError, as the
  reference's do (an opaque Python hook would cut the double-grad
  chain). Torch runs a backward with grad mode on exactly when it
  creates a graph, on whatever thread runs the hook, so the hook wrapper
  checks that.
* **a tensor with no graph** (stop_gradient, or a leaf) raises
  RuntimeError on ``backward``, as in the reference.

Under lazy eager (``core/lazy.py``) ``backward()`` is one deferred node
that calls ``torch.autograd.backward`` when the graph runs; the
reference's checks (a graph to go through, none released) run when it
is deferred, over the pending nodes a backward would walk. A leaf's
``.grad`` read while that node is pending runs the graph.
``create_graph=True`` and ``paddle.grad`` run the graph and then run at
once, as the reference keeps lazy off for them. ``host_callbacks``
counts the tensor hooks and ``PyLayer`` calls that ran (host code a
captured graph would skip).
"""
import torch

from ..amp.auto_cast import amp_state, resume
from . import lazy as _lazy
from .tensor import Tensor, as_torch

_RELEASED = "paddle_tpu_torch.released"
_HOOK_CREATE_GRAPH = (
    "tensor hooks are not supported together with create_graph=True (the "
    "hook would cut the double-grad chain)")
_RELEASED_MSG = ("trying to backward through a released graph; pass "
                 "retain_graph=True to backward()")

# tensor hooks and PyLayer forwards/backwards run so far
host_callbacks = [0]


def register_tensor_hook(tensor, hook):
    """Hook called with the gradient Tensor when it is computed; may
    return a replacement (reference: VarBase::RegisterGradHook). Fires
    for a leaf's gradient before it accumulates and for a non-leaf's on
    the gradient flowing into its producer. Returns a handle whose
    ``remove()`` drops it."""
    def torch_hook(g):
        if torch.is_grad_enabled():
            raise NotImplementedError(_HOOK_CREATE_GRAPH)
        host_callbacks[0] += 1
        with _lazy.suspended():
            out = hook(Tensor._wrap(g, name=tensor.name + "@GRAD"))
            if out is None:
                return None
            return as_torch(out, g.dtype, g.device)
    return tensor._value.register_hook(torch_hook)


def _graph_nodes(roots):
    """Every node reachable from the ``roots`` (grad_fns), leaf
    accumulators excepted."""
    seen, stack, nodes = set(), [r for r in roots if r is not None], []
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "AccumulateGrad":
            continue
        nodes.append(fn)
        stack.extend(nxt for nxt, _ in fn.next_functions if nxt is not None)
    return nodes


def _check_live(nodes):
    for fn in nodes:
        if fn.metadata.get(_RELEASED):
            raise RuntimeError(_RELEASED_MSG)


def _release(nodes):
    for fn in nodes:
        fn.metadata[_RELEASED] = True


def _roots(tensors):
    for t in tensors:
        if t._value.grad_fn is None:
            raise RuntimeError(
                f"Tensor {t.name!r} has no grad graph (stop_gradient=True "
                f"or no recorded ops)")
    return [t._value.grad_fn for t in tensors]


def _backward(v, seed, retain_graph, create_graph=False):
    """The backward of torch value ``v`` seeded by ``seed`` (None: ones),
    marking the nodes it walked unless the graph is retained."""
    nodes = _graph_nodes([v.grad_fn])
    _check_live(nodes)
    if seed is None:
        seed = torch.ones_like(v)
    torch.autograd.backward(v, seed, retain_graph=bool(retain_graph),
                            create_graph=bool(create_graph))
    if not retain_graph:
        _release(nodes)


def _defer_backward(loss, grad_tensor, retain_graph):
    """``loss.backward()`` as a node of the lazy graph, after the
    reference's checks over what it would walk."""
    v = loss._v
    if not v.requires_grad:
        raise RuntimeError(
            f"Tensor {loss.name!r} has no grad graph (stop_gradient=True "
            f"or no recorded ops)")
    if type(v) is not _lazy.LazyArray and v.grad_fn is None:
        _roots([loss])
    graph = _lazy._cur()
    if type(v) is _lazy.LazyArray and v._concrete is None \
            and v._graph is graph:
        lazy_nodes, consts = graph.reach(v)
    else:
        v = _lazy.concrete(v)
        lazy_nodes, consts = set(), [v]
    fns = set()
    for c in consts:
        nodes = _graph_nodes([c.grad_fn])
        _check_live(nodes)
        fns.update(nodes)
    if lazy_nodes & graph.released or fns & graph.released_fns:
        raise RuntimeError(_RELEASED_MSG)
    seed = None
    if grad_tensor is not None:
        seed = grad_tensor._v if isinstance(grad_tensor, Tensor) else None
        if seed is None or seed.dtype != v.dtype or seed.device != v.device:
            seed = as_torch(grad_tensor, v.dtype, v.device)
    amp = amp_state()
    retain = bool(retain_graph)

    def run(value, seed_value=None):
        if amp is None:
            _backward(value, seed_value, retain)
        else:
            with resume(amp):
                _backward(value, seed_value, retain)

    inputs = [v] if seed is None else [v, seed]
    _lazy.dispatch(run, ("backward", retain, amp, seed is None), inputs,
                   writer=True, device=v.device)
    if not retain:
        graph.released |= lazy_nodes
        graph.released_fns |= fns


def run_backward(loss, grad_tensor=None, retain_graph=False,
                 create_graph=False):
    """``loss.backward()``: grads of every leaf that reaches ``loss``
    accumulate into their ``.grad``; ``grad_tensor`` seeds the backward
    (ones by default). Deferred under lazy eager unless it creates a
    graph."""
    if not create_graph and _lazy.enabled():
        _defer_backward(loss, grad_tensor, retain_graph)
        return
    _lazy.flush()
    nodes = _graph_nodes(_roots([loss]))
    _check_live(nodes)
    v = loss._value
    seed = torch.ones_like(v) if grad_tensor is None \
        else as_torch(grad_tensor, v.dtype, v.device)
    torch.autograd.backward(v, seed, retain_graph=bool(retain_graph),
                            create_graph=bool(create_graph))
    if not retain_graph:
        _release(nodes)


def run_grad(outputs, inputs, grad_outputs=None, retain_graph=False,
             create_graph=False):
    """Grads of ``outputs`` with respect to ``inputs`` (torch tensors, or
    None where an input is not reached), touching no ``.grad``; the
    pending lazy graph runs first."""
    _lazy.flush()
    nodes = _graph_nodes(_roots(outputs))
    _check_live(nodes)
    seeds = [torch.ones_like(o._value) if g is None
             else as_torch(g, o._value.dtype, o._value.device)
             for o, g in zip(outputs, grad_outputs)]
    wanted = [i for i, t in enumerate(inputs) if t._value.requires_grad]
    got = torch.autograd.grad(
        [o._value for o in outputs], [inputs[i]._value for i in wanted],
        grad_outputs=seeds, retain_graph=bool(retain_graph),
        create_graph=bool(create_graph), allow_unused=True) \
        if wanted else ()
    if not retain_graph:
        _release(nodes)
    res = [None] * len(inputs)
    for i, g in zip(wanted, got):
        res[i] = g
    return res
