"""Control flow (``cond``, ``while_loop``, ``switch_case``, ``case``) and
``fc`` of ``paddle.static.nn`` (a port of ``paddle_tpu/static/nn.py``;
reference fluid/layers/control_flow.py).

The reference lowers the branches and bodies, Python callables, to
``lax.cond`` / ``lax.while_loop`` / ``lax.switch``. The port runs them:

- eagerly (on the CPU, outside ``jit.to_static``, and in its eager and
  record calls): the predicate is read on the host and only the branch
  it picks runs; a loop runs its body while its condition reads true;
- under ``jit.to_static``'s capture, with a CUDA predicate: each branch
  and each loop body is captured into a CUDA conditional node
  (``core/graph_cond.py``), so one graph serves every predicate value
  and trip count, and a branch the data does not pick never runs;
- in ``to_static``'s record call, a branch the predicate did not pick
  (and a loop body that ran no trip) is warmed: captured into a graph
  that is thrown away, so its first launches (a kernel's module load,
  cuBLAS's workspace) do not happen inside the real capture.

As in the reference, the outputs are new Tensors without grad (the
reference wraps the raw arrays of its ``lax`` primitives): a branch's
Python scalars become 0-d tensors (float32, int32, bool, as JAX's
defaults make them); the branches and bodies run without recording
grads. Both branches must give the same structure, shapes and dtypes
under capture (a ``TypeError`` otherwise, as ``lax.cond``'s); a loop's
body must keep its carry's structure and shapes (a structure change is
the ``TypeError`` dy2static turns into its static-shapes advice).

``fc`` keeps the reference's per-program parameter cache. The 33
``fluid.layers`` forwards (``batch_norm``, ``conv2d``, ...) need
``fluid/``, which is not ported: they raise ``NotImplementedError``.
"""
import contextlib
import warnings

import numpy as np
import torch

from ..core import trace as trace_mod
from ..core.tensor import Tensor

_SCALAR_DTYPES = {bool: torch.bool, int: torch.int32, float: torch.float32}


def _label_scope(label):
    """The ``analysis.birth`` scope of a branch or body run under a
    trace (a shared no-op while tracking is off)."""
    if trace_mod._active is None:
        return contextlib.nullcontext()
    from ..analysis import birth
    return birth.subtrace(label)


def _device_of(*objs):
    for o in objs:
        if isinstance(o, Tensor):
            return o._v.device
        if isinstance(o, torch.Tensor):
            return o.device
        if isinstance(o, (list, tuple)):
            d = _device_of(*o)
            if d is not None:
                return d
    return None


def _to_torch(v, device):
    """A branch or carry leaf as a torch tensor (no grad)."""
    if isinstance(v, Tensor):
        return v._value.detach()
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(v), device=device)
    dt = _SCALAR_DTYPES.get(type(v))
    if dt is None:
        raise TypeError(
            f"a control-flow output must be a Tensor or a Python scalar, "
            f"got {v!r} ({type(v).__name__})")
    return torch.full((), v, dtype=dt, device=device)


def _flatten(tree, leaves):
    """Structure token of a (nested list/tuple) output; leaves appended."""
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    if tree is None:
        return None
    leaves.append(tree)
    return "*"


def _rebuild(struct, it):
    if struct is None:
        return None
    if struct == "*":
        return next(it)
    kind, subs = struct
    return kind(_rebuild(s, it) for s in subs)


def _wrap(t):
    return Tensor._wrap(t)


def _call(fn, args, label):
    """``fn(*args)`` without grads, in ``label``'s birth scope."""
    with torch.no_grad(), _label_scope(label):
        return fn(*args)


def _run(fn, args, label):
    """``fn(*args)`` as (output structure, leaves)."""
    leaves = []
    struct = _flatten(_call(fn, args, label), leaves)
    return struct, leaves


def _pred(pred):
    """The predicate as a torch tensor, or a Python bool."""
    if isinstance(pred, Tensor):
        return pred._value.detach()
    if isinstance(pred, torch.Tensor):
        return pred.detach()
    return bool(pred)


def _capturing(p):
    ctx = trace_mod._active
    return (isinstance(p, torch.Tensor) and p.is_cuda and ctx is not None
            and ctx.mode == "capture" and ctx.graph is not None)


def _warming(p):
    """Inside ``_warm``'s thrown-away capture (to_static's record): run
    every branch, read nothing on the host. Any other CUDA-graph capture
    that ``to_static`` did not start cannot hold a Tensor predicate: the
    branches would need conditional nodes, which only ``to_static``'s
    capture makes, and a host read cannot be captured."""
    if not (isinstance(p, torch.Tensor) and p.is_cuda):
        return False
    if trace_mod._warming:
        return True
    if torch.cuda.is_current_stream_capturing():
        raise trace_mod.ToStaticError(
            "a Tensor predicate in static.nn's cond/while_loop/switch_case/"
            "case inside a CUDA-graph capture that jit.to_static did not "
            "start: capture the step with jit.to_static, which puts each "
            "branch and loop body in a conditional node")
    return False


def _recording(p):
    """``to_static``'s record call with a CUDA predicate: the capture
    that follows will need the conditional-node helper and its streams,
    which cannot be made inside it."""
    if isinstance(p, torch.Tensor) and p.is_cuda \
            and trace_mod._active is not None \
            and trace_mod._active.mode == "record":
        from ..core import graph_cond
        graph_cond.warm(p.device)
        return True
    return False


def _warm(fns, device):
    """Capture ``fns`` into a graph that is never replayed, so that
    their first launches happen now and not inside the real capture.
    The launch counters are left as they were. State kept on the host
    (an optimizer's first moments, a learning rate) is refused here as
    in the real capture (``trace.refuse_in_capture``): made in this
    graph, it would never get its values. Any other failure is left for
    the real capture to report."""
    from ..core import graph_cond
    from ..jit.to_static import _counted, no_collection
    counted = _counted()
    before = [w.launches for w in counted]
    graph = torch.cuda.CUDAGraph()
    side = graph_cond.warm_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    trace_mod._warming = True
    try:
        # a branch with no kernel captures an empty graph; torch warns
        with warnings.catch_warnings(), no_collection():
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="relaxed"):
                for fn in fns:
                    fn()
    except Exception as e:  # noqa: BLE001 - the real capture reports it
        # a refusal, also when ending the capture raised after it
        refusal = e if isinstance(e, trace_mod.ToStaticError) \
            else e.__context__
        if isinstance(refusal, trace_mod.ToStaticError):
            raise refusal from None
    finally:
        trace_mod._warming = False
        for w, b in zip(counted, before):
            w.launches = b
        torch.cuda.current_stream(device).wait_stream(side)


def _select_captured(flags, fns, labels):
    """Capture each ``fns[i]`` into an ``if`` node on ``flags[i]`` (at
    most one set on the device); the first one's outputs are copied into
    buffers of their own, which every later one writes. Returns the
    output structure and the buffers."""
    from ..core import graph_cond
    ctx = trace_mod._active
    device = flags[0].device
    struct, bufs = None, None
    for flag, fn, label in zip(flags, fns, labels):
        with graph_cond.node(flag, "if", ctx.body_pool):
            s, leaves = _run(fn, (), label)
            outs = [_to_torch(v, device) for v in leaves]
            if bufs is None:
                struct = s
                bufs = [o.clone() for o in outs]
            else:
                _same(struct, s, bufs, outs, "the branches")
                for b, o in zip(bufs, outs):
                    b.copy_(o)
    return struct, bufs


def _same(struct, s, bufs, outs, what):
    if s != struct or len(bufs) != len(outs):
        raise TypeError(f"{what} must give the same output structure, got "
                        f"{struct} and {s}")
    for b, o in zip(bufs, outs):
        if b.shape != o.shape or b.dtype != o.dtype:
            raise TypeError(
                f"{what} must give identical types, got "
                f"{b.dtype}{list(b.shape)} and {o.dtype}{list(o.shape)}")


def _branch(fn, label, device):
    s, leaves = _run(fn, (), label)
    return _rebuild(s, iter(_wrap(_to_torch(v, device)) for v in leaves))


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Reference control_flow.py cond: ``true_fn()`` where ``pred`` holds,
    else ``false_fn()``; a missing branch gives None."""
    p = _pred(pred)
    true_fn = true_fn or (lambda: None)
    false_fn = false_fn or (lambda: None)
    if isinstance(p, bool):
        return _branch(true_fn if p else false_fn,
                       "cond_true" if p else "cond_false", None)
    device = p.device
    if _capturing(p):
        flag = p.reshape(()).to(torch.bool).clone()
        struct, bufs = _select_captured(
            [flag, torch.logical_not(flag)], [true_fn, false_fn],
            ["cond_true", "cond_false"])
        return _rebuild(struct, iter(_wrap(b) for b in bufs))
    if _warming(p):
        _branch(false_fn, "cond_false", device)
        return _branch(true_fn, "cond_true", device)
    taken = bool(p.reshape(()).item())
    if _recording(p):
        other = false_fn if taken else true_fn
        _warm([lambda: _run(other, (), "warm")], device)
    return _branch(true_fn if taken else false_fn,
                   "cond_true" if taken else "cond_false", device)


def _carry(v, device):
    if isinstance(v, (list, tuple)):
        return type(v)(_carry(x, device) for x in v)
    return _to_torch(v, device)


def _as_args(vals):
    def w(v):
        if isinstance(v, (list, tuple)):
            return type(v)(w(x) for x in v)
        return _wrap(v)
    return [w(v) for v in vals]


def _shape_struct(vals):
    leaves = []
    struct = _flatten(list(vals), leaves)
    return struct, leaves


def _check_carry(before, after):
    s0, l0 = _shape_struct(before)
    s1, l1 = _shape_struct(after)
    if s0 != s1 or len(l0) != len(l1):
        raise TypeError(
            "while_loop: body_fn output and input must have the same "
            f"structure, got {s0} and {s1}")
    for a, b in zip(l0, l1):
        if tuple(a.shape) != tuple(b.shape):
            raise TypeError(
                "while_loop: body_fn output and input must have identical "
                f"types, got {a.dtype}{list(a.shape)} and "
                f"{b.dtype}{list(b.shape)}")


def _body_out(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Reference control_flow.py while_loop: ``body_fn`` over the carried
    ``loop_vars`` while ``cond_fn`` holds; returns the final carry as a
    list."""
    device = _device_of(*loop_vars)
    vals = [_carry(v, device) for v in loop_vars]
    c = _pred(_call(cond_fn, _as_args(vals), "while_cond"))
    if _capturing(c):
        return _while_captured(cond_fn, body_fn, vals, c)
    if _warming(c):
        _call(body_fn, _as_args(vals), "while_body")
        return _as_args(vals)
    trips = 0
    while c if isinstance(c, bool) else bool(c.reshape(()).item()):
        out = _body_out(_call(body_fn, _as_args(vals), "while_body"))
        new = [_carry(o, device) for o in out]
        _check_carry(vals, new)
        vals = new
        trips += 1
        c = _pred(_call(cond_fn, _as_args(vals), "while_cond"))
    if _recording(c) and trips == 0:
        args = _as_args(vals)
        _warm([lambda: _call(body_fn, args, "warm")], device)
    return _as_args(vals)


def _while_captured(cond_fn, body_fn, vals, c):
    """The loop as a CUDA ``while`` node: the carry in buffers made
    before it, the body writing the new carry and the new condition."""
    from ..core import graph_cond
    bufs = [_carry(v, c.device) for v in vals]
    bufs = [_clone(b) for b in bufs]
    flag = c.reshape(()).to(torch.bool).clone()
    leaves = []
    _flatten(bufs, leaves)

    def end():
        nc = _pred(_call(cond_fn, _as_args(bufs), "while_cond"))
        flag.copy_(nc.reshape(()).to(torch.bool))
        return flag

    with graph_cond.node(flag, "while", trace_mod._active.body_pool,
                         end_flag=end):
        out = _body_out(_call(body_fn, _as_args(bufs), "while_body"))
        new = [_carry(o, c.device) for o in out]
        _check_carry(bufs, new)
        new_leaves = []
        _flatten(new, new_leaves)
        ptrs = {b.data_ptr() for b in leaves}
        # a new value that is a carry buffer itself (a swap) is copied
        # first, so no buffer is read after it was written
        new_leaves = [o.clone() if o.data_ptr() in ptrs else o
                      for o in new_leaves]
        for b, o in zip(leaves, new_leaves):
            b.copy_(o)
    return _as_args(bufs)


def _clone(v):
    if isinstance(v, (list, tuple)):
        return type(v)(_clone(x) for x in v)
    return v.clone()


def _index_of(branch_index):
    if isinstance(branch_index, Tensor):
        return branch_index._value.detach()
    if isinstance(branch_index, torch.Tensor):
        return branch_index.detach()
    return int(branch_index)


def _select(flags, fns, labels, device):
    """Run the first ``fns[i]`` whose flag holds (the last one when none
    does): eagerly by reading the flags, or as ``if`` nodes under
    capture."""
    if _capturing(flags[0]):
        n = len(fns)
        hit = torch.stack([f.reshape(()).to(torch.bool) for f in flags])
        # position of the first true flag, else the last branch
        first = torch.where(hit.any(), torch.argmax(hit.to(torch.int32)),
                            torch.full((), n - 1, dtype=torch.int64,
                                       device=device))
        picks = [first == i for i in range(n)]
        struct, bufs = _select_captured(picks, fns, labels)
        return _rebuild(struct, iter(_wrap(b) for b in bufs))
    if _warming(flags[0]):
        outs = [_branch(fn, label, device) for fn, label in zip(fns, labels)]
        return outs[0]
    pos = len(fns) - 1
    for i, f in enumerate(flags):
        if bool(f.reshape(()).item()):
            pos = i
            break
    if _recording(flags[0]):
        others = [fn for i, fn in enumerate(fns) if i != pos]
        _warm([lambda fn=fn: _run(fn, (), "warm") for fn in others],
              device)
    return _branch(fns[pos], labels[pos], device)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Reference control_flow.py switch_case: ``branch_fns`` a list of
    callables, ``(index, callable)`` pairs or a dict; an index no key
    matches takes ``default``, else the last branch."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        items = sorted((int(i), f) for i, f in branch_fns)
    else:
        items = list(enumerate(branch_fns))
    keys = [k for k, _ in items]
    fns = [f for _, f in items]
    labels = [f"switch_branch{i}" for i in range(len(fns))]
    if default is not None:
        fns.append(default)
        labels.append("switch_default")
    idx = _index_of(branch_index)
    if isinstance(idx, int):
        pos = keys.index(idx) if idx in keys else len(fns) - 1
        return _branch(fns[pos], labels[pos], None)
    flat = idx.reshape(()).to(torch.int32)
    flags = [flat == k for k in keys]
    if default is not None:
        flags.append(torch.ones((), dtype=torch.bool, device=idx.device))
    return _select(flags, fns, labels, idx.device)


def case(pred_fn_pairs, default=None, name=None):
    """Reference control_flow.py case: the first pair whose predicate
    holds, else ``default`` (else the last pair's callable)."""
    preds = [_pred(p) for p, _ in pred_fn_pairs]
    fns = [f for _, f in pred_fn_pairs]
    labels = [f"case_branch{i}" for i in range(len(fns))]
    fns.append(default if default is not None else fns[-1])
    labels.append("case_default")
    tensors = [p for p in preds if isinstance(p, torch.Tensor)]
    if not tensors:
        pos = next((i for i, p in enumerate(preds) if p), len(fns) - 1)
        return _branch(fns[pos], labels[pos], None)
    device = tensors[0].device
    flags = [p.reshape(()).to(torch.bool) if isinstance(p, torch.Tensor)
             else torch.full((), bool(p), device=device) for p in preds]
    flags.append(torch.ones((), dtype=torch.bool, device=device))
    return _select(flags, fns, labels, device)


def fc(x, size, num_flatten_dims=1, activation=None, name=None,
       weight_attr=None, bias_attr=None):
    """Reference paddle.static.nn.fc: an unnamed call makes fresh
    parameters; a ``name`` reuses that layer's parameters within the
    same program only."""
    from ..nn.layer.common import Linear
    from ..ops import nn_ops
    from .program import building_program
    x, in_dim = nn_ops.fc_flatten(x, num_flatten_dims)
    prog = building_program()
    cache = prog._layer_cache if prog is not None else {}
    key = ("fc", name, in_dim, int(size)) if name is not None else None
    layer = cache.get(key) if key is not None else None
    if layer is None:
        layer = Linear(in_dim, int(size), weight_attr=weight_attr,
                       bias_attr=bias_attr)
        if key is not None:
            cache[key] = layer
    out = layer(x)
    if activation:
        act = getattr(nn_ops, activation, None)
        if act is None:
            raise ValueError(f"unknown activation {activation!r}")
        out = act(out)
    return out


# ---- fluid-layer forwards (reference: paddle/static/nn/__init__.py
# __all__ — the static op-assembly API IS the fluid.layers surface).
# Resolved lazily (PEP 562): fluid.layers imports static.data at load.

_FLUID_FORWARDS = (
    "batch_norm", "embedding", "bilinear_tensor_product", "conv2d",
    "conv2d_transpose", "conv3d", "conv3d_transpose", "crf_decoding",
    "data_norm", "group_norm", "instance_norm",
    "layer_norm", "multi_box_head", "nce", "prelu", "py_func",
    "row_conv", "spectral_norm", "sequence_conv", "sequence_softmax",
    "sequence_pool", "sequence_concat", "sequence_first_step",
    "sequence_last_step", "sequence_slice", "sequence_expand",
    "sequence_expand_as", "sequence_pad", "sequence_unpad",
    "sequence_reshape", "sequence_scatter", "sequence_enumerate",
    "sequence_reverse",
)


def __getattr__(name):
    if name in _FLUID_FORWARDS:
        from ..fluid import layers as _fl
        return getattr(_fl, name)
    if name == "deform_conv2d":
        from ..fluid import layers as _fl
        return _fl.deformable_conv
    if name == "sparse_embedding":
        from ..fluid import layers as _fl

        def sparse_embedding(input, size, **kw):  # noqa: A002
            kw.setdefault("is_sparse", True)
            return _fl.embedding(input, size, **kw)
        return sparse_embedding
    raise AttributeError(f"module 'paddle.static.nn' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(set(globals()) | set(_FLUID_FORWARDS)
                  | {"sparse_embedding", "deform_conv2d"})
