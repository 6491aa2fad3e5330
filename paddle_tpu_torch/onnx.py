"""``paddle.onnx.export`` (a port of ``paddle_tpu/onnx.py``; reference
python/paddle/onnx/export.py:21, which delegates to paddle2onnx over the
traced ProgramDesc).

The reference walks the jaxpr of the forward; the port walks the same
recorded ``Program`` as ``jit.save`` (``jit/save_load.py::record``),
built at the reference's concrete example shapes (an InputSpec's
``None`` becomes 1), and maps each record's op type to ONNX nodes.
Parameters become initializers under their structured names; a record
whose inputs are all constants or persistables is evaluated here (on
the CPU) and folded into an initializer, as the reference folds every
equation not reachable from the inputs. ``flash_attention`` expands to
the reference's composition: MatMul, the scale, the causal mask as a
constant, Softmax and MatMul. An op with no mapping raises
``NotImplementedError`` naming its type. The protobuf bindings are a
byte-identical copy of the reference's (``onnx_proto/``), so a file
written by either package parses in the other.

opset_version: 13-17 as declared; below 13 is raised to 13 with a
warning, above 17 clamped to 17 (the reductions' axes move to inputs in
18). ``ir_version`` 8; the file is ``path + '.onnx'``.
"""
import os
import warnings

import numpy as np
import torch

_OPSET = 13
_IR_VERSION = 8

_DTYPE_TO_ONNX = {
    "float32": 1, "uint8": 2, "int8": 3, "uint16": 4, "int16": 5,
    "int32": 6, "int64": 7, "bool": 9, "float16": 10, "float64": 11,
    "uint32": 12, "uint64": 13, "bfloat16": 16,
}
_NEG = -1e30   # the causal mask's fill (ops/attention.py::reference_attention)


def _pb():
    from .onnx_proto import onnx_pb2
    return onnx_pb2


def _np_of(t):
    """A torch tensor (or scalar) as a numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            raise NotImplementedError("onnx export: bfloat16 values")
        return t.numpy()
    return np.asarray(t)


def _onnx_dtype(dt):
    if isinstance(dt, torch.dtype):
        dt = str(dt).replace("torch.", "")
    code = _DTYPE_TO_ONNX.get(str(np.dtype(dt)) if dt != "bfloat16"
                              else "bfloat16")
    if code is None:
        raise NotImplementedError(f"onnx export: dtype {dt}")
    return code


class _Graph:
    """The graph being built: nodes, initializers, fresh names."""

    def __init__(self):
        self.pb = _pb()
        self.nodes = []
        self.initializers = {}
        self._n = 0

    def fresh(self, hint="t"):
        self._n += 1
        return f"{hint}_{self._n}"

    def tensor_proto(self, name, arr):
        arr = np.asarray(arr)
        t = self.pb.TensorProto()
        t.name = name
        t.dims.extend(arr.shape)
        t.data_type = _onnx_dtype(arr.dtype)
        t.raw_data = np.ascontiguousarray(arr).tobytes()
        return t

    def add_init(self, arr, hint="const", name=None):
        name = name or self.fresh(hint)
        if name not in self.initializers:
            self.initializers[name] = self.tensor_proto(name, arr)
        return name

    def node(self, op_type, inputs, n_out=1, **attrs):
        n = self.pb.NodeProto()
        n.op_type = op_type
        n.input.extend(inputs)
        outs = [self.fresh(op_type.lower()) for _ in range(n_out)]
        n.output.extend(outs)
        n.name = outs[0]
        for k, v in attrs.items():
            a = n.attribute.add()
            a.name = k
            if isinstance(v, (bool, int, np.integer)):
                a.type = self.pb.AttributeProto.INT
                a.i = int(v)
            elif isinstance(v, float):
                a.type = self.pb.AttributeProto.FLOAT
                a.f = v
            elif isinstance(v, str):
                a.type = self.pb.AttributeProto.STRING
                a.s = v.encode()
            elif isinstance(v, (list, tuple)):
                if all(isinstance(x, (int, np.integer)) for x in v):
                    a.type = self.pb.AttributeProto.INTS
                    a.ints.extend(int(x) for x in v)
                else:
                    a.type = self.pb.AttributeProto.FLOATS
                    a.floats.extend(float(x) for x in v)
            else:
                raise TypeError(f"attr {k}={v!r}")
        self.nodes.append(n)
        return outs[0] if n_out == 1 else outs


class _In:
    """One input of a record: a live graph edge (``edge``, with the
    variable's ``shape`` and ``dtype``; ``dynamic`` when it descends from
    a feed with a -1 dim, whose recorded shapes then hold 1 there), a
    known value (``value``: a torch tensor or a Python scalar), or absent
    (both None)."""

    __slots__ = ("g", "edge", "value", "shape", "dtype", "init_name",
                 "dynamic", "_init")

    def __init__(self, g, edge=None, value=None, shape=None, dtype=None,
                 init_name=None, dynamic=False):
        self.g = g
        self.edge = edge
        self.value = value
        self.shape = shape
        self.dtype = dtype
        self.init_name = init_name
        self.dynamic = dynamic
        self._init = None

    @property
    def known(self):
        return self.edge is None

    def name(self, like=None):
        """The graph name of this input; a value becomes an initializer
        (a Python scalar in the dtype of ``like``)."""
        if self.edge is not None:
            return self.edge
        v = self.value
        if not isinstance(v, torch.Tensor):
            dt = like.dtype if like is not None else torch.float32
            return self.g.add_init(np.asarray(_np_of(torch.tensor(
                v, dtype=dt))), "const")
        if self._init is None:
            self._init = self.g.add_init(_np_of(v), "const", self.init_name)
        return self._init


def _static(shape, what, dynamic=False):
    if dynamic or any(int(s) < 0 for s in shape):
        raise NotImplementedError(
            f"onnx export: dynamic dims (-1) in {what} {list(shape)}: the "
            "exporter bakes static shapes; export with concrete shapes")
    return [int(s) for s in shape]


def _i64(g, vals, hint):
    return g.add_init(np.asarray(list(vals), np.int64), hint)


# ---- per-op emitters -------------------------------------------------------

_UNARY = {"relu": "Relu", "sigmoid_act": "Sigmoid", "tanh_act": "Tanh",
          "tanh": "Tanh", "exp": "Exp", "log": "Log", "sqrt": "Sqrt",
          "abs": "Abs", "neg": "Neg", "erf": "Erf", "floor": "Floor",
          "ceil": "Ceil", "reciprocal": "Reciprocal", "sign": "Sign",
          "logical_not": "Not"}
_BINARY = {"elementwise_add": "Add", "elementwise_sub": "Sub",
           "elementwise_mul": "Mul", "elementwise_div": "Div",
           "elementwise_max": "Max", "elementwise_min": "Min",
           "elementwise_pow": "Pow"}


def _emit(g, rec, ins, out_shapes):
    """ONNX node(s) for one record with a live input; returns its
    outputs' graph names. An emitter that bakes a shape raises on an
    input that descends from a -1 feed dim."""
    op, a = rec.type, rec.attrs
    dyn = any(i.dynamic for i in ins)

    def static(shape, what):
        return _static(shape, what, dyn)

    def nm(i):
        return ins[i].name(like=_first_edge(ins))

    if op in _UNARY:
        return [g.node(_UNARY[op], [nm(0)])]
    if op in _BINARY:
        return [g.node(_BINARY[op], [nm(0), nm(1)])]
    if op == "linear":
        y = g.node("MatMul", [nm(0), nm(1)])
        return [g.node("Add", [y, nm(2)]) if ins[2].value is not None
                or ins[2].edge is not None else y]
    if op == "matmul_v2":
        x, y = nm(0), nm(1)
        if a.get("transpose_x"):
            x = _swap_last(g, x, len(ins[0].shape))
        if a.get("transpose_y"):
            y = _swap_last(g, y, len(ins[1].shape))
        return [g.node("MatMul", [x, y])]
    if op == "softmax":
        return [g.node("Softmax", [nm(0)], axis=int(a["axis"]))]
    if op == "gelu":
        return [_gelu(g, nm(0), bool(a["approximate"]), ins[0].dtype)]
    if op == "layer_norm":
        return [_layer_norm(g, ins, a, nm, static)]
    if op in ("reshape", "flatten2", "squeeze2", "unsqueeze2"):
        shape = static(out_shapes[0], op)
        return [g.node("Reshape", [nm(0), _i64(g, shape, "shape")])]
    if op == "transpose2":
        return [g.node("Transpose", [nm(0)], perm=list(a["perm"]))]
    if op == "scale":
        s = float(a["scale"])
        b = float(a["bias"])
        sc = g.add_init(np.asarray(s, _np_dtype(ins[0].dtype)), "c")
        bc = g.add_init(np.asarray(b, _np_dtype(ins[0].dtype)), "c")
        if a["bias_after_scale"]:
            return [g.node("Add", [g.node("Mul", [nm(0), sc]), bc])]
        return [g.node("Mul", [g.node("Add", [nm(0), bc]), sc])]
    if op == "dropout":
        p = float(a["p"])
        if a["training"] and p > 0.0:
            raise NotImplementedError(
                "onnx export: dropout in training mode (export an eval "
                "model)")
        if not a["training"] and a["mode"] == "downscale_in_infer":
            k = g.add_init(np.asarray(1.0 - p, _np_dtype(ins[0].dtype)), "c")
            return [g.node("Mul", [nm(0), k])]
        return [g.node("Identity", [nm(0)])]
    if op == "cast":
        from .core import dtype as dtype_mod
        return [g.node("Cast", [nm(0)], to=_onnx_dtype(
            dtype_mod.to_torch_dtype(a["dtype"])))]
    if op in ("reduce_mean", "reduce_sum", "reduce_max", "reduce_min"):
        axis = a["axis"]
        nd = len(ins[0].shape)
        axes = list(range(nd)) if axis is None else [
            int(x) % nd for x in (axis if isinstance(axis, tuple)
                                  else (axis,))]
        keep = int(bool(a["keepdim"]))
        if op == "reduce_sum":
            return [g.node("ReduceSum", [nm(0), _i64(g, axes, "axes")],
                           keepdims=keep)]
        kind = {"reduce_mean": "ReduceMean", "reduce_max": "ReduceMax",
                "reduce_min": "ReduceMin"}[op]
        return [g.node(kind, [nm(0)], axes=axes, keepdims=keep)]
    if op == "lookup_table_v2":
        if ins[1].known is False:
            raise NotImplementedError("onnx export: an embedding table "
                                      "computed from the inputs")
        pad = a.get("padding_idx")
        if pad is not None and pad >= 0:
            raise NotImplementedError("onnx export: embedding padding_idx")
        return [g.node("Gather", [nm(1), nm(0)], axis=0)]
    if op == "unbind":
        axis = int(a["axis"])
        n = ins[0].shape[axis]
        return [g.node("Gather", [nm(0), g.add_init(np.asarray(i, np.int64),
                                                   "index")], axis=axis)
                for i in range(n)]
    if op == "conv2d":
        return [_conv(g, ins, a, nm, static)]
    if op in ("pool2d_max", "pool2d_avg"):
        k, s, p = list(a["ksize"]), list(a["strides"]), list(a["paddings"])
        if op == "pool2d_max":
            return [g.node("MaxPool", [nm(0)], kernel_shape=k, strides=s,
                           pads=p + p, ceil_mode=int(bool(a["ceil_mode"])))]
        return [g.node("AveragePool", [nm(0)], kernel_shape=k, strides=s,
                       pads=p + p, count_include_pad=int(
                           not a["exclusive"]))]
    if op == "adaptive_avg_pool2d":
        h, w = static(ins[0].shape, op)[2:]
        oh, ow = a["output_size"]
        if (oh, ow) == (1, 1):
            return [g.node("GlobalAveragePool", [nm(0)])]
        if h % oh or w % ow:
            raise NotImplementedError(
                "onnx export: adaptive_avg_pool2d whose bins do not divide "
                "the input")
        k = [h // oh, w // ow]
        return [g.node("AveragePool", [nm(0)], kernel_shape=k, strides=k,
                       pads=[0, 0, 0, 0])]
    if op == "batch_norm_infer":
        if int(a["channel_axis"]) != 1 or any(
                i.value is None and i.edge is None for i in ins[1:]):
            raise NotImplementedError(
                "onnx export: batch_norm other than channels-first with a "
                "scale and bias")
        return [g.node("BatchNormalization",
                       [nm(0), nm(3), nm(4), nm(1), nm(2)],
                       epsilon=float(a["epsilon"]))]
    if op == "einsum":
        return [_einsum(g, ins, a["equation"], static)]
    if op == "flash_attention":
        return [_attention(g, ins, a, nm, static)]
    raise NotImplementedError(
        f"onnx export: op {op!r} has no ONNX mapping in this build "
        "(supported: elementwise, linear/matmul/einsum, conv, pools, "
        "norms, reductions, shape ops, embedding, attention). Keep the "
        "exported forward to inference ops, or use jit.save")


def _first_edge(ins):
    for i in ins:
        if i.edge is not None and i.dtype is not None:
            return i
    return None


def _np_dtype(dt):
    return torch.empty((), dtype=dt).numpy().dtype


def _swap_last(g, name, nd):
    perm = list(range(nd))
    perm[-1], perm[-2] = perm[-2], perm[-1]
    return g.node("Transpose", [name], perm=perm)


def _gelu(g, x, approximate, dtype):
    def c(v):
        return g.add_init(np.asarray(v, _np_dtype(dtype)), "c")
    if approximate:
        # 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
        x3 = g.node("Mul", [g.node("Mul", [x, x]), x])
        inner = g.node("Add", [x, g.node("Mul", [x3, c(0.044715)])])
        t = g.node("Tanh", [g.node("Mul", [inner,
                                           c(np.sqrt(2.0 / np.pi))])])
    else:
        # 0.5 x (1 + erf(x / sqrt(2)))
        t = g.node("Erf", [g.node("Div", [x, c(np.sqrt(2.0))])])
    return g.node("Mul", [g.node("Mul", [x, c(0.5)]),
                          g.node("Add", [t, c(1.0)])])


def _layer_norm(g, ins, a, nm, static):
    x = nm(0)
    nd = len(ins[0].shape)
    axes = list(range(int(a["begin_norm_axis"]), nd))
    shape = static(ins[0].shape[axes[0]:], "layer_norm")
    dt = _np_dtype(ins[0].dtype)
    mean = g.node("ReduceMean", [x], axes=axes, keepdims=1)
    d = g.node("Sub", [x, mean])
    var = g.node("ReduceMean", [g.node("Mul", [d, d])], axes=axes, keepdims=1)
    eps = g.add_init(np.asarray(float(a["epsilon"]), dt), "eps")
    y = g.node("Div", [d, g.node("Sqrt", [g.node("Add", [var, eps])])])
    for i, kind in ((1, "Mul"), (2, "Add")):
        if ins[i].value is None and ins[i].edge is None:
            continue
        w = nm(i)
        if list(ins[i].shape) != shape:
            w = g.node("Reshape", [w, _i64(g, shape, "shape")])
        y = g.node(kind, [y, w])
    return y


def _conv(g, ins, a, nm, static):
    from .ops.nn_ops import _pads_of
    x = nm(0)
    nhwc = a["data_format"] == "NHWC"
    xs = list(ins[0].shape)
    if nhwc:
        x = g.node("Transpose", [x], perm=[0, 3, 1, 2])
        xs = [xs[0], xs[3], xs[1], xs[2]]
    meta_x = torch.empty(static(xs, "conv2d"), device="meta")
    meta_w = torch.empty(list(ins[1].shape), device="meta")
    pads = _pads_of(a["paddings"], meta_x, meta_w, a["strides"],
                    a["dilations"])
    inputs = [x, nm(1)]
    if ins[2].value is not None or ins[2].edge is not None:
        inputs.append(nm(2))
    out = g.node("Conv", inputs, strides=list(a["strides"]),
                 pads=[p[0] for p in pads] + [p[1] for p in pads],
                 dilations=list(a["dilations"]), group=int(a["groups"]))
    return g.node("Transpose", [out], perm=[0, 2, 3, 1]) if nhwc else out


def _einsum(g, ins, equation, static):
    """A two-operand einsum as Transpose / Reshape / MatMul / Reshape /
    Transpose (the reference's dot_general canonicalization): batch
    letters (both operands and the output), contracted (both, not the
    output), each side's free letters; a letter of one side only and not
    the output is summed first."""
    eq = equation.replace(" ", "")
    if "..." in eq or "->" not in eq or len(ins) != 2:
        raise NotImplementedError(
            f"onnx export: einsum {equation!r} (two operands with an "
            "explicit output, no ellipsis)")
    lhs, out = eq.split("->")
    la, lb = lhs.split(",")
    names = [ins[0].name(), ins[1].name()]
    shapes = [list(ins[0].shape), list(ins[1].shape)]
    sides = []
    for i, (letters, other) in enumerate(((la, lb), (lb, la))):
        drop = [j for j, c in enumerate(letters)
                if c not in other and c not in out]
        if drop:
            names[i] = g.node("ReduceSum", [names[i],
                                            _i64(g, drop, "axes")],
                              keepdims=0)
            shapes[i] = [d for j, d in enumerate(shapes[i]) if j not in drop]
            letters = "".join(c for j, c in enumerate(letters)
                              if j not in drop)
        sides.append(letters)
    la, lb = sides
    size = {}
    for letters, shp in ((la, shapes[0]), (lb, shapes[1])):
        for c, d in zip(letters, static(shp, "einsum")):
            size[c] = d
    batch = [c for c in la if c in lb and c in out]
    contract = [c for c in la if c in lb and c not in out]
    free_l = [c for c in la if c not in lb]
    free_r = [c for c in lb if c not in la]
    def prod(cs):
        return int(np.prod([size[c] for c in cs], dtype=np.int64))
    bshape = [size[c] for c in batch]
    perm_l = [la.index(c) for c in batch + free_l + contract]
    perm_r = [lb.index(c) for c in batch + contract + free_r]
    a_, b_ = names
    if perm_l != list(range(len(la))):
        a_ = g.node("Transpose", [a_], perm=perm_l)
    if perm_r != list(range(len(lb))):
        b_ = g.node("Transpose", [b_], perm=perm_r)
    a_ = g.node("Reshape", [a_, _i64(g, bshape + [prod(free_l),
                                                  prod(contract)], "shape")])
    b_ = g.node("Reshape", [b_, _i64(g, bshape + [prod(contract),
                                                  prod(free_r)], "shape")])
    mm = g.node("MatMul", [a_, b_])
    got = batch + free_l + free_r
    y = g.node("Reshape", [mm, _i64(g, [size[c] for c in got], "shape")])
    if got != list(out):
        y = g.node("Transpose", [y], perm=[got.index(c) for c in out])
    return y


def _attention(g, ins, a, nm, static):
    """The reference's attention composition
    (ops/attention.py::reference_attention): S = (Q K^T) * scale, the
    causal mask, Softmax over keys, then P V."""
    q, k, v = nm(0), nm(1), nm(2)
    dt = _np_dtype(ins[0].dtype)
    nd = len(ins[1].shape)
    s = g.node("MatMul", [q, _swap_last(g, k, nd)])
    s = g.node("Mul", [s, g.add_init(np.asarray(float(a["scale"]), dt),
                                     "scale")])
    if a["causal"]:
        sq = static(ins[0].shape, "attention")[-2]
        sk = static(ins[1].shape, "attention")[-2]
        keep = np.tril(np.ones((sq, sk), bool), sk - sq)
        mask = g.add_init(keep, "causal_mask", f"causal_mask_{sq}x{sk}")
        s = g.node("Where", [mask, s, g.add_init(np.asarray(_NEG, dt),
                                                 "neg", f"neg_{dt}")])
    if ins[3].value is not None or ins[3].edge is not None:
        s = g.node("Add", [s, nm(3)])
    p = g.node("Softmax", [s], axis=-1)
    return g.node("MatMul", [p, v])


# ---- conversion ------------------------------------------------------------

def _fold(rec, values):
    from .amp.auto_cast import op_body
    with torch.no_grad(), op_body():
        out = rec.op.fn(*values, **rec.attrs)
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _convert(program, feed_names, fetch_names, values, init_names,
             graph_name):
    """The ONNX ModelProto of ``program``: ``values`` holds each
    persistable's value (name -> CPU torch tensor), ``init_names`` the
    initializer name of each parameter (program name -> structured
    name)."""
    from .static.program import AliasRecord, ConstRecord, OpRecord
    pb = _pb()
    g = _Graph()
    env = {}
    for n in feed_names:
        var = program.vars[n]
        env[n] = _In(g, edge=n, shape=list(var._shape),
                     dtype=var._v.dtype, dynamic=-1 in var._shape)
    for n, val in values.items():
        env[n] = _In(g, value=val, shape=list(val.shape), dtype=val.dtype,
                     init_name=init_names.get(n))

    for rec in program.ops:
        if isinstance(rec, ConstRecord):
            v = rec.array.detach().cpu()
            env[rec.name] = _In(g, value=v, shape=list(v.shape),
                                dtype=v.dtype)
            continue
        if isinstance(rec, AliasRecord):
            env[rec.dst] = env[rec.src]
            continue
        if not isinstance(rec, OpRecord):
            raise NotImplementedError(
                f"onnx export: record {rec.type!r} (control flow, grads and "
                "updates do not export)")
        if rec.cast is not None:
            raise NotImplementedError(
                f"onnx export: op {rec.type!r} recorded under auto_cast")
        ins = []
        for r in rec.in_refs:
            if r is None:
                ins.append(_In(g))
            elif isinstance(r, str):
                ins.append(env[r])
            else:
                v = r[1].detach().cpu() if isinstance(r[1], torch.Tensor) \
                    else r[1]
                shape = list(v.shape) if isinstance(v, torch.Tensor) else []
                dt = v.dtype if isinstance(v, torch.Tensor) else None
                ins.append(_In(g, value=v, shape=shape, dtype=dt))
        if all(i.known for i in ins):
            outs = _fold(rec, [i.value for i in ins])
            for name, o in zip(rec.out_names, outs):
                env[name] = _In(g, value=o, shape=list(o.shape),
                                dtype=o.dtype)
            continue
        out_shapes = [list(program.vars[n]._shape) for n in rec.out_names]
        names = _emit(g, rec, ins, out_shapes)
        dyn = any(i.dynamic for i in ins)
        for name, edge in zip(rec.out_names, names):
            var = program.vars[name]
            env[name] = _In(g, edge=edge, shape=list(var._shape),
                            dtype=var._v.dtype, dynamic=dyn)

    model = pb.ModelProto()
    model.ir_version = _IR_VERSION
    model.producer_name = "paddle_tpu_torch"
    opset = model.opset_import.add()
    opset.domain = ""
    opset.version = _OPSET
    graph = model.graph
    graph.name = graph_name

    # resolve the outputs before copying nodes and initializers: a fully
    # folded output becomes an initializer, and ONNX wants every graph
    # output produced by a node (an Identity)
    for n in feed_names:
        graph.input.add().CopyFrom(_vinfo(pb, n, env[n].shape,
                                         env[n].dtype))
    for f in fetch_names:
        src = env[f]
        name = src.name()
        if src.value is not None or name in feed_names:
            name = g.node("Identity", [name])
        graph.output.add().CopyFrom(_vinfo(pb, name, src.shape, src.dtype))
    graph.node.extend(g.nodes)
    for t in g.initializers.values():
        graph.initializer.add().CopyFrom(t)
    return model


# ---- a torch.nn.Module through torch.export -------------------------------

# aten ops that only view or copy their input: the edge passes through
_PASS = ("contiguous", "clone", "alias", "detach", "lift_fresh_copy")
# ops that move a parameter's layout: kept as nodes on its initializer
# (folding them would write a second copy of the weight)
_LAYOUT = ("t", "transpose", "permute", "view", "reshape", "_unsafe_view",
           "expand")
_ATEN_UNARY = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
               "exp": "Exp", "log": "Log", "sqrt": "Sqrt", "abs": "Abs",
               "neg": "Neg", "erf": "Erf", "reciprocal": "Reciprocal"}
_ATEN_BINARY = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
                "maximum": "Max", "minimum": "Min", "pow": "Pow"}
_FLASH_OP = "paddle_tpu_torch.flash_attention_forward"


def _op_name(target):
    """``'aten.linear'`` of ``aten.linear.default``; the custom op's
    ``'paddle_tpu_torch.flash_attention_forward'``."""
    name = getattr(target, "name", None)
    name = name() if callable(name) else str(target)
    name = name.replace("::", ".")
    return name.rsplit(".", 1)[0] if name.count(".") > 1 else name


def _emit_aten(g, op, args, ins, out):
    """ONNX node(s) for one live aten node: ``args`` its arguments with
    each Node replaced by its ``_In`` (``ins`` those, in order), ``out``
    its output's FakeTensor (or tuple of them). Returns the output name
    (or list of names)."""
    short = op.split(".", 1)[1] if op.startswith("aten.") else op

    def nm(x, like=None):
        return x.name(like=like or _first_edge(ins))

    def shape_of(o):
        return _static(list(o.shape), op)

    if short in _PASS or (short == "dropout" and not args[2]):
        return nm(args[0])
    if short in _ATEN_UNARY:
        return g.node(_ATEN_UNARY[short], [nm(args[0])])
    if short in _ATEN_BINARY:
        a, b = (x if isinstance(x, _In) else _In(g, value=x)
                for x in args[:2])
        if short in ("add", "sub") and len(args) > 2 and args[2] != 1:
            raise NotImplementedError(f"onnx export: {op} with alpha")
        return g.node(_ATEN_BINARY[short], [nm(a), nm(b)])
    if short in ("matmul", "mm", "bmm"):
        return g.node("MatMul", [nm(args[0]), nm(args[1])])
    if short == "linear":
        x, w = args[0], args[1]
        if w.known and w.init_name is not None:
            wt = g.add_init(_np_of(w.value.t()), name=w.init_name)
        else:
            wt = _swap_last(g, nm(w), 2)
        y = g.node("MatMul", [nm(x), wt])
        if len(args) > 2 and args[2] is not None:
            y = g.node("Add", [y, nm(args[2])])
        return y
    if short == "t":
        return g.node("Transpose", [nm(args[0])], perm=[1, 0])
    if short == "transpose":
        perm = list(range(len(args[0].shape)))
        d0, d1 = (int(d) % len(perm) for d in args[1:3])
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return g.node("Transpose", [nm(args[0])], perm=perm)
    if short == "permute":
        return g.node("Transpose", [nm(args[0])],
                      perm=[int(d) % len(args[0].shape) for d in args[1]])
    if short in ("view", "reshape", "_unsafe_view", "squeeze",
                 "unsqueeze", "flatten"):
        return g.node("Reshape", [nm(args[0]),
                                  _i64(g, shape_of(out), "shape")])
    if short == "expand":
        return g.node("Expand", [nm(args[0]),
                                 _i64(g, shape_of(out), "shape")])
    if short == "embedding":
        return g.node("Gather", [nm(args[0]), nm(args[1])], axis=0)
    if short in ("unbind", "select"):
        axis = (int(args[1]) if len(args) > 1 else 0) % len(args[0].shape)
        idx = range(args[0].shape[axis]) if short == "unbind" \
            else [int(args[2])]
        outs = [g.node("Gather", [nm(args[0]), g.add_init(
            np.asarray(i, np.int64), "index")], axis=axis) for i in idx]
        return outs if short == "unbind" else outs[0]
    if short in ("softmax", "_softmax"):
        return g.node("Softmax", [nm(args[0])], axis=int(args[1]))
    if short == "gelu":
        approx = len(args) > 1 and args[1] == "tanh"
        return _gelu(g, nm(args[0]), approx, args[0].dtype)
    if short == "layer_norm":
        nd = len(args[0].shape)
        a = {"begin_norm_axis": nd - len(args[1]),
             "epsilon": float(args[4]) if len(args) > 4 else 1e-5}
        ln_ins = [args[0]] + [x if isinstance(x, _In) else _In(g)
                              for x in args[2:4]]
        return _layer_norm(g, ln_ins, a, lambda i: nm(ln_ins[i]),
                           lambda shp, what: _static(shp, what))
    if op == _FLASH_OP:
        a = {"scale": float(args[3]), "causal": bool(args[4])}
        at_ins = list(args[:3]) + [_In(g)]
        return [_attention(g, at_ins, a, lambda i: nm(at_ins[i]),
                           lambda shp, what: _static(shp, what)), None]
    raise NotImplementedError(
        f"onnx export: aten op {op!r} has no ONNX mapping in this build "
        "(supported: elementwise, linear/matmul, shape ops, embedding, "
        "layer_norm, gelu, softmax, the flash attention node)")


def _module_model(ep, graph_name):
    """The ONNX ModelProto of the exported program ``ep``: parameters and
    buffers become initializers under their structured names (a linear
    weight in the reference's ``[in, out]`` layout), a node whose inputs
    are all known is evaluated on the CPU and folded (the position
    lookup), every other node is mapped by its aten op."""
    import torch.fx
    from torch.export.graph_signature import InputKind
    pb = _pb()
    g = _Graph()
    kinds = {s.arg.name: s for s in ep.graph_signature.input_specs}
    env, feeds = {}, []
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            spec = kinds[node.name]
            val = node.meta["val"]
            if spec.kind == InputKind.USER_INPUT:
                name = f"x{len(feeds)}"
                feeds.append((name, list(val.shape), val.dtype))
                env[node] = _In(g, edge=name, shape=list(val.shape),
                                dtype=val.dtype)
                continue
            store = ep.constants if spec.kind in (
                InputKind.CONSTANT_TENSOR, InputKind.CUSTOM_OBJ) \
                else ep.state_dict
            v = store[spec.target].detach().cpu()
            env[node] = _In(g, value=v, shape=list(v.shape), dtype=v.dtype,
                            init_name=spec.target if spec.kind in (
                                InputKind.PARAMETER, InputKind.BUFFER)
                            else None)
            continue
        if node.op == "output":
            outs = node.args[0]
            break
        if node.op != "call_function":
            raise NotImplementedError(f"onnx export: fx node {node.op}")
        args = torch.fx.node.map_arg(node.args, lambda n: env[n])
        ins = []
        torch.fx.node.map_aggregate(
            args, lambda x: ins.append(x) if isinstance(x, _In) else x)
        if node.target is __import__("operator").getitem:
            env[node] = args[0][args[1]]
            continue
        op = _op_name(node.target)
        short = op.split(".", 1)[-1]
        known = all(i.known for i in ins)
        if known and not (short in _LAYOUT
                          and any(i.init_name for i in ins)):
            vals = torch.fx.node.map_aggregate(
                args, lambda x: x.value if isinstance(x, _In) else x)
            kw = dict(node.kwargs)
            if "device" in kw:            # folded on the CPU
                kw["device"] = torch.device("cpu")
            with torch.no_grad():
                res = node.target(*vals, **kw)
            env[node] = _known(g, res)
            continue
        kw = dict(node.kwargs)
        if kw and op != "aten.gelu":
            kw.pop("memory_format", None)
            if kw:
                raise NotImplementedError(
                    f"onnx export: {op} with keyword arguments {kw}")
        if kw:
            args = (args[0], kw.get("approximate", "none"))
        val = node.meta["val"]
        names = _emit_aten(g, op, args, ins, val)
        if isinstance(names, list):
            env[node] = [None if n is None else _In(
                g, edge=n, shape=list(v.shape), dtype=v.dtype)
                for n, v in zip(names, val)]
        else:
            env[node] = _In(g, edge=names, shape=list(val.shape),
                            dtype=val.dtype)

    model = pb.ModelProto()
    model.ir_version = _IR_VERSION
    model.producer_name = "paddle_tpu_torch"
    opset = model.opset_import.add()
    opset.domain = ""
    opset.version = _OPSET
    graph = model.graph
    graph.name = graph_name
    for name, shape, dtype in feeds:
        graph.input.add().CopyFrom(_vinfo(pb, name, shape, dtype))
    for o in (outs if isinstance(outs, (list, tuple)) else [outs]):
        src = env[o]
        name = src.name()
        if src.value is not None or name in [f[0] for f in feeds]:
            name = g.node("Identity", [name])
        graph.output.add().CopyFrom(_vinfo(pb, name, src.shape, src.dtype))
    graph.node.extend(g.nodes)
    for t in g.initializers.values():
        graph.initializer.add().CopyFrom(t)
    return model


def _known(g, res):
    if isinstance(res, (list, tuple)):
        return [_known(g, r) for r in res]
    if isinstance(res, torch.Tensor):
        return _In(g, value=res, shape=list(res.shape), dtype=res.dtype)
    return _In(g, value=res, shape=[], dtype=None)


def _vinfo(pb, name, shape, dtype):
    vi = pb.ValueInfoProto()
    vi.name = name
    tt = vi.type.tensor_type
    tt.elem_type = _onnx_dtype(dtype)
    for i, s in enumerate(shape):
        d = tt.shape.dim.add()
        if int(s) < 0:
            d.dim_param = f"{name}_d{i}"
        else:
            d.dim_value = int(s)
    return vi


def export(layer, path, input_spec=None, opset_version=_OPSET, **configs):
    """Write ``path + '.onnx'``; returns the .onnx path. Reference:
    paddle.onnx.export (export.py:21)."""
    from .jit.save_load import record
    if input_spec is None:
        raise ValueError("onnx.export requires input_spec")
    opset = int(opset_version)
    if opset < _OPSET:
        warnings.warn(
            f"onnx export: opset_version={opset_version} is below the "
            f"minimum this converter's op forms need; emitting opset "
            f"{_OPSET}")
        opset = _OPSET
    elif opset > 17:
        warnings.warn(
            f"onnx export: opset_version={opset_version} is beyond the "
            "validated range (13-17: ReduceMax/Min axes moved to "
            "inputs in 18); emitting opset 17")
        opset = 17
    if isinstance(layer, torch.nn.Module):
        from .jit.save_load import export_module
        model = _module_model(export_module(layer, input_spec, concrete=True),
                              graph_name=type(layer).__name__)
        return _write(model, opset, path)
    prog, feeds, fetch, params, program_names = record(
        layer, input_spec, concrete=True, what="onnx.export")
    values, init_names = {}, {}
    for sname, pname in program_names.items():
        if pname not in values:
            values[pname] = params[sname].value.detach().cpu()
            init_names[pname] = sname
    for pname, t in prog.persist.items():
        if pname not in values:          # a constant the forward made
            values[pname] = t.value.detach().cpu()
    model = _convert(prog, feeds, fetch, values, init_names,
                     graph_name=type(layer).__name__)
    return _write(model, opset, path)


def _write(model, opset, path):
    model.opset_import[0].version = opset
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(model.SerializeToString())
    return out_path
