"""paddle_tpu_torch's ``onnx.export`` against the JAX package's on the CPU:
``tests/test_onnx_export.py``'s cases, each model built in both packages
with the reference's weights carried into the port's layer of the same
structure, exported by both, and both files run by one numpy evaluator
on the same inputs. Each port file's outputs agree with the port's layer
and with the reference's file within the reference test's tolerance.

The evaluator is a copy of the reference test's ``_run_onnx``, extended
with the ONNX ops the port emits where the reference's walk emits their
primitives (Relu, Softmax, BatchNormalization, GlobalAveragePool,
ReduceMean): the port maps each recorded op to its ONNX op, the
reference each jaxpr primitive.

The GPT case builds the port's side in the Paddle surface with the
structure of ``paddle_tpu/text/models.py`` (``SelfAttention`` :58 to
``GPTForCausalLM`` :288, tied head; ``test_torch_deploy_cuda.py``'s
``surface_gpt``); the port's ``text.models.GPTForCausalLM``, a
``torch.nn.Module``, exports through ``torch.export``
(tests/test_torch_jit_save_module.py).

The reference's jaxpr-only ``test_general_dot_general_symbolic_dims_raise_clearly``
has the port's own case: a program with a -1 feed dim reaching a shape
the exporter bakes raises naming the dynamic dims.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from test_torch_deploy_cuda import surface_gpt
from test_torch_jit_save_load import carry

PACKAGES = (ref, paddle)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _load(path, P=paddle):
    onnx_pb2 = (P.onnx_proto.onnx_pb2 if hasattr(P, "onnx_proto")
                else __import__(f"{P.__name__}.onnx_proto",
                                fromlist=["onnx_pb2"]).onnx_pb2)
    m = onnx_pb2.ModelProto()
    with open(path, "rb") as f:
        m.ParseFromString(f.read())
    return m


_NP_DTYPE = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
             10: np.float16, 11: np.float64, 2: np.uint8, 3: np.int8}


def _tensor_value(t):
    dt = _NP_DTYPE[t.data_type]
    return np.frombuffer(t.raw_data, dt).reshape(list(t.dims)).copy()


def _run_onnx(model, inputs):
    """Numpy evaluator for the exported op subset (the reference test's,
    with the port's extra ops)."""
    env = {t.name: _tensor_value(t) for t in model.graph.initializer}
    for vi, x in zip(model.graph.input, inputs):
        env[vi.name] = np.asarray(x)

    def conv(x, w, attrs):
        import jax.lax as lax
        return np.asarray(lax.conv_general_dilated(
            x.astype(np.float32), w.astype(np.float32),
            window_strides=attrs.get("strides", [1, 1]),
            padding=list(zip(attrs["pads"][:2], attrs["pads"][2:])),
            rhs_dilation=attrs.get("dilations", [1, 1]),
            feature_group_count=attrs.get("group", 1)))

    def pool(x, attrs, mode):
        import jax.lax as lax
        k = [1, 1] + list(attrs["kernel_shape"])
        s = [1, 1] + list(attrs.get("strides", attrs["kernel_shape"]))
        pads = attrs.get("pads", [0] * 4)
        pad = [(0, 0), (0, 0)] + list(zip(pads[:2], pads[2:]))
        if mode == "max":
            return np.asarray(lax.reduce_window(
                x, -np.inf, lax.max, k, s, pad))
        acc = np.asarray(lax.reduce_window(x, 0.0, lax.add, k, s, pad))
        return acc / np.prod(attrs["kernel_shape"])

    for node in model.graph.node:
        a = {at.name: (list(at.ints) if at.ints else
                       (at.i if at.type == 2 else
                        (at.f if at.type == 1 else
                         at.s.decode() if at.type == 3 else None)))
             for at in node.attribute}
        ins = [env[n] for n in node.input]
        op = node.op_type
        if op == "MatMul":
            out = ins[0] @ ins[1]
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Sub":
            out = ins[0] - ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Div":
            out = ins[0] / ins[1]
        elif op == "Max":
            out = np.maximum(ins[0], ins[1])
        elif op == "Min":
            out = np.minimum(ins[0], ins[1])
        elif op == "Neg":
            out = -ins[0]
        elif op == "Exp":
            out = np.exp(ins[0])
        elif op == "Log":
            out = np.log(ins[0])
        elif op == "Tanh":
            out = np.tanh(ins[0])
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-ins[0]))
        elif op == "Sqrt":
            out = np.sqrt(ins[0])
        elif op == "Erf":
            from scipy.special import erf as _erf
            out = _erf(ins[0]).astype(ins[0].dtype)
        elif op == "Pow":
            out = ins[0] ** ins[1]
        elif op == "Where":
            out = np.where(ins[0], ins[1], ins[2])
        elif op == "Cast":
            out = ins[0].astype(_NP_DTYPE[a["to"]])
        elif op == "Reshape":
            out = ins[0].reshape([int(s) for s in ins[1]])
        elif op == "Transpose":
            out = np.transpose(ins[0], a["perm"])
        elif op == "Expand":
            out = np.broadcast_to(
                ins[0], np.broadcast_shapes(tuple(int(s) for s in
                                                  ins[1]),
                                            ins[0].shape)).copy()
        elif op == "Concat":
            out = np.concatenate(ins, axis=a["axis"])
        elif op == "Slice":
            starts, ends, axes, steps = (ins[1].astype(int),
                                         ins[2].astype(int),
                                         ins[3].astype(int),
                                         ins[4].astype(int))
            idx = [slice(None)] * ins[0].ndim
            for st, en, ax, sp in zip(starts, ends, axes, steps):
                idx[ax] = slice(st, en, sp)
            out = ins[0][tuple(idx)]
        elif op == "ReduceSum":
            out = ins[0].sum(axis=tuple(int(x) for x in ins[1]),
                             keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceMax":
            out = ins[0].max(axis=tuple(a["axes"]),
                             keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceMin":
            out = ins[0].min(axis=tuple(a["axes"]),
                             keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceMean":
            out = ins[0].mean(axis=tuple(a["axes"]),
                              keepdims=bool(a.get("keepdims", 1)))
        elif op == "Conv":
            out = conv(ins[0], ins[1], a)
            if len(ins) > 2:
                out = out + ins[2].reshape(1, -1, 1, 1)
        elif op == "MaxPool":
            out = pool(ins[0], a, "max")
        elif op == "AveragePool":
            out = pool(ins[0], a, "avg")
        elif op == "GlobalAveragePool":
            out = ins[0].mean(axis=(2, 3), keepdims=True)
        elif op == "BatchNormalization":
            x, sc, b, mu, var = ins
            c = (1, -1) + (1,) * (x.ndim - 2)
            out = ((x - mu.reshape(c)) / np.sqrt(var.reshape(c) + a["epsilon"])
                   * sc.reshape(c) + b.reshape(c)).astype(x.dtype)
        elif op == "Relu":
            out = np.maximum(ins[0], 0).astype(ins[0].dtype)
        elif op == "Softmax":
            z = ins[0] - ins[0].max(axis=a["axis"], keepdims=True)
            e = np.exp(z)
            out = e / e.sum(axis=a["axis"], keepdims=True)
        elif op == "Gather":
            out = np.take(ins[0], ins[1].astype(int),
                          axis=a.get("axis", 0))
        elif op == "GatherND":
            data, idx = ins[0], ins[1].astype(int)
            k = idx.shape[-1]
            flat = idx.reshape(-1, k)
            picked = data[tuple(flat[:, i] for i in range(k))]
            out = picked.reshape(idx.shape[:-1] + data.shape[k:])
        elif op == "Identity":
            out = ins[0]
        elif op == "Less":
            out = ins[0] < ins[1]
        elif op == "LessOrEqual":
            out = ins[0] <= ins[1]
        elif op == "Greater":
            out = ins[0] > ins[1]
        elif op == "GreaterOrEqual":
            out = ins[0] >= ins[1]
        elif op == "Equal":
            out = ins[0] == ins[1]
        elif op == "Pad":
            pads = ins[1].astype(int)
            n = ins[0].ndim
            out = np.pad(ins[0],
                         list(zip(pads[:n], pads[n:])),
                         constant_values=float(ins[2]))
        elif op == "Split":
            sizes = ins[1].astype(int)
            out = np.split(ins[0], np.cumsum(sizes)[:-1],
                           axis=a["axis"])
        else:
            raise AssertionError(f"evaluator: unexpected op {op}")
        if isinstance(out, list):
            for name, o in zip(node.output, out):
                env[name] = o
        else:
            env[node.output[0]] = out
    return [env[o.name] for o in model.graph.output]


def _both(build, specs, inputs, tmp_path, tag, rtol, atol, seed=0):
    """Build ``build(P)`` in both packages (the reference's weights
    carried into the port's), export each, run both files and both
    layers on ``inputs``; every output pair within rtol/atol. Returns
    (port model proto, port layer)."""
    ref.seed(seed)
    r = build(ref)
    r.eval()
    p = build(paddle)
    carry(r, p)
    p.eval()
    files = {}
    for P, layer in ((ref, r), (paddle, p)):
        spec = [P.static.InputSpec(list(s), dt) for s, dt in specs]
        files[P] = P.onnx.export(layer, str(tmp_path / f"{tag}_{P.__name__}"),
                                 input_spec=spec)
    got_ref, = _run_onnx(_load(files[ref], ref), inputs)
    got, = _run_onnx(_load(files[paddle]), inputs)
    want = p(*[paddle.to_tensor(x) for x in inputs]).numpy()
    want_ref = r(*[ref.to_tensor(x) for x in inputs]).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, got_ref, rtol=rtol, atol=atol)
    np.testing.assert_allclose(want, want_ref, rtol=rtol, atol=atol)
    return _load(files[paddle]), p


def test_export_mlp_matches_layer(tmp_path):
    def build(P):
        nn = P.nn
        return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4),
                             nn.Softmax())
    x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    model, _ = _both(build, [((2, 8), "float32")], [x], tmp_path, "mlp",
                     1e-5, 1e-6)
    assert model.ir_version == 8
    assert model.opset_import[0].version == 13
    assert "MatMul" in {n.op_type for n in model.graph.node}
    got, = _run_onnx(model, [x])
    assert got.sum() == pytest.approx(2.0, rel=1e-4)  # softmax rows


def test_export_conv_net_matches_layer(tmp_path):
    def build(P):
        nn = P.nn
        return nn.Sequential(
            nn.Conv2D(1, 4, 3, padding=1), nn.ReLU(), nn.MaxPool2D(2, 2),
            nn.Conv2D(4, 8, 3), nn.Sigmoid(), nn.Flatten(),
            nn.Linear(8 * 12 * 12, 10))
    x = np.random.RandomState(1).randn(1, 1, 28, 28).astype(np.float32)
    model, _ = _both(build, [((1, 1, 28, 28), "float32")], [x], tmp_path,
                     "conv", 2e-5, 2e-5, seed=1)
    ops = [n.op_type for n in model.graph.node]
    # the port records the pool as one op: a MaxPool node (the
    # reference's walk emits its strided-window gathers and Max)
    assert "Conv" in ops and "MaxPool" in ops


def test_export_embedding_model(tmp_path):
    def build(P):
        nn = P.nn

        class Emb(nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = nn.Embedding(50, 8)
                self.fc = nn.Linear(8, 3)

            def forward(self, ids):
                return self.fc(self.emb(ids).mean(axis=1))
        return Emb()
    ids = np.random.RandomState(2).randint(0, 50, (2, 5)).astype(np.int64)
    model, _ = _both(build, [((2, 5), "int64")], [ids], tmp_path, "emb",
                     1e-5, 1e-6, seed=2)
    assert any(n.op_type == "Gather" for n in model.graph.node)


def test_export_layernorm_mlp(tmp_path):
    def build(P):
        nn = P.nn
        return nn.Sequential(nn.Linear(6, 12), nn.LayerNorm(12), nn.GELU(),
                             nn.Linear(12, 2))
    x = np.random.RandomState(3).randn(3, 6).astype(np.float32)
    _both(build, [((3, 6), "float32")], [x], tmp_path, "ln", 2e-5, 2e-5,
          seed=3)


@pytest.mark.parametrize("i,eqn,sa,sb", [
    (0, "bijh,bhk->bijk", (2, 3, 4, 5), (2, 5, 6)),  # 2 lhs free dims
    (1, "bxy,bxy->b", (2, 3, 4), (2, 3, 4)),   # multi-dim contraction
    (2, "ibh,bhk->bik", (3, 2, 5), (2, 5, 4)),  # non-leading batch
    (3, "bh,bhk->bk", (2, 5), (2, 5, 4)),       # vector (no-free) lhs
])
def test_export_general_dot_general_canonicalized(tmp_path, i, eqn, sa, sb):
    """einsum outside MatMul's numpy batching exports through the
    Transpose / Reshape / MatMul / Reshape canonicalization in both
    packages and matches numpy.einsum."""
    def build(P):
        class Net(P.nn.Layer):
            def forward(self, x, y):
                return P.einsum(eqn, x, y)
        return Net()
    rs = np.random.RandomState(i)
    x = rs.randn(*sa).astype(np.float32)
    y = rs.randn(*sb).astype(np.float32)
    model, _ = _both(build, [(sa, "float32"), (sb, "float32")], [x, y],
                     tmp_path, f"dg{i}", 1e-4, 1e-5)
    got, = _run_onnx(model, [x, y])
    np.testing.assert_allclose(got, np.einsum(eqn, x, y), rtol=1e-4,
                               atol=1e-5, err_msg=eqn)
    ops = [n.op_type for n in model.graph.node]
    assert "Reshape" in ops and "MatMul" in ops


def test_export_unsupported_op_raises_clearly(tmp_path):
    for P in PACKAGES:
        class Sorty(P.nn.Layer):
            def forward(self, x):
                return P.sort(x, axis=-1)
        with pytest.raises(NotImplementedError,
                           match="primitive" if P is ref else "op 'sort'"):
            P.onnx.export(Sorty(), str(tmp_path / f"bad_{P.__name__}"),
                          input_spec=[P.static.InputSpec([4, 4],
                                                         "float32")])


def test_initializers_carry_param_values(tmp_path):
    """Weights land as initializers under their structured names; no
    dangling node inputs (the reference's case, in the port)."""
    paddle.seed(4)
    net = paddle.nn.Linear(5, 7)
    net.eval()
    path = paddle.onnx.export(net, str(tmp_path / "lin"),
                              input_spec=[paddle.static.InputSpec(
                                  [1, 5], "float32")])
    model = _load(path)
    inits = {t.name: _tensor_value(t) for t in model.graph.initializer}
    produced = {o for n in model.graph.node for o in n.output}
    avail = set(inits) | {vi.name for vi in model.graph.input} | produced
    for n in model.graph.node:
        for i in n.input:
            assert i in avail, f"dangling input {i} of {n.op_type}"
    np.testing.assert_array_equal(inits["weight"], net.weight.numpy())
    np.testing.assert_array_equal(inits["bias"], net.bias.numpy())


def test_export_transformer_encoder_layer(tmp_path):
    def build(P):
        return P.nn.TransformerEncoderLayer(d_model=32, nhead=4,
                                            dim_feedforward=64, dropout=0.0)
    x = np.random.RandomState(5).randn(2, 10, 32).astype(np.float32)
    _both(build, [((2, 10, 32), "float32")], [x], tmp_path, "enc", 2e-4,
          2e-5, seed=5)


def test_export_resnet18(tmp_path):
    def build(P):
        return P.vision.models.resnet18(num_classes=10)
    x = np.random.RandomState(0).randn(1, 3, 64, 64).astype(np.float32)
    model, _ = _both(build, [((1, 3, 64, 64), "float32")], [x], tmp_path,
                     "r18", 5e-4, 5e-4)
    assert sum(n.op_type == "Conv" for n in model.graph.node) >= 20


def test_export_gpt_logits(tmp_path):
    """The reference's GPTForCausalLM (tied head) against the port's
    surface GPT of the same structure on the reference's weights: the
    attention expands to MatMul, scale, the causal mask as a constant,
    Softmax and MatMul; the position lookup folds into a constant."""
    from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig
    cfg = TransformerLMConfig(vocab_size=128, hidden_size=32,
                              num_layers=2, num_heads=2, max_seq_len=16,
                              dropout=0.0)

    def build(P):
        return GPTForCausalLM(cfg) if P is ref else surface_gpt(paddle, cfg)
    ids = np.random.RandomState(0).randint(0, 128, (1, 16)).astype(np.int64)
    model, p = _both(build, [((1, 16), "int64")], [ids], tmp_path, "gpt",
                     2e-4, 2e-4)
    ops = [n.op_type for n in model.graph.node]
    assert ops.count("Softmax") == 2 and ops.count("Where") == 2
    inits = {t.name: _tensor_value(t) for t in model.graph.initializer}
    np.testing.assert_array_equal(inits["gpt.word_embeddings.weight"],
                                  p.gpt.word_embeddings.weight.numpy())
    assert "gpt.position_embeddings.weight" not in inits   # folded


def test_dynamic_dim_that_cannot_export_raises(tmp_path):
    """The port's own case of the reference's symbolic-dims test: a
    program whose feed has a -1 dim exports where no shape is baked
    (the input keeps a dim_param) and raises naming the dynamic dims
    where one is (a reshape)."""
    from paddle_tpu_torch import onnx as onnx_mod
    from paddle_tpu_torch.jit.save_load import record
    from paddle_tpu_torch.static import InputSpec
    lin = paddle.nn.Linear(4, 6)
    prog, feeds, fetch, params, names = record(
        lin, [InputSpec([None, 4], "float32")])
    values = {n: params[s].value for s, n in names.items()}
    model = onnx_mod._convert(prog, feeds, fetch, values,
                              {n: s for s, n in names.items()}, "g")
    assert model.graph.input[0].type.tensor_type.shape.dim[0].dim_param

    class Flat(paddle.nn.Layer):
        def forward(self, x):
            return paddle.reshape(x, [-1, 2, 2])
    prog, feeds, fetch, params, names = record(
        Flat(), [InputSpec([None, 4], "float32")])
    with pytest.raises(NotImplementedError, match="dynamic dims"):
        onnx_mod._convert(prog, feeds, fetch, {}, {}, "g")


def test_both_protos_in_one_process(tmp_path):
    """The port's proto is the reference's, byte for byte: both import
    in one process, share message classes, and a file written by either
    package parses in the other."""
    from paddle_tpu.onnx_proto import onnx_pb2 as rpb
    from paddle_tpu_torch.onnx_proto import onnx_pb2 as ppb
    assert rpb.ModelProto is ppb.ModelProto
    import os
    import paddle_tpu_torch.onnx_proto as pdir
    import paddle_tpu.onnx_proto as rdir
    for f in ("__init__.py", "paddle_tpu_onnx.proto", "paddle_tpu_onnx_pb2.py"):
        with open(os.path.join(os.path.dirname(rdir.__file__), f), "rb") as a, \
                open(os.path.join(os.path.dirname(pdir.__file__), f),
                     "rb") as b:
            assert a.read() == b.read(), f
    paths = {}
    for P in PACKAGES:
        lin = P.nn.Linear(3, 2)
        paths[P] = P.onnx.export(lin, str(tmp_path / P.__name__),
                                 input_spec=[P.static.InputSpec(
                                     [1, 3], "float32")])
    for P, other in ((ref, paddle), (paddle, ref)):
        m = _load(paths[P], other)
        assert m.ir_version == 8 and len(m.graph.node) >= 1


@pytest.mark.parametrize("asked,emitted", [(11, 13), (13, 13), (17, 17),
                                           (19, 17)])
def test_opset_clamps_warn(tmp_path, asked, emitted):
    lin = paddle.nn.Linear(3, 2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        path = paddle.onnx.export(lin, str(tmp_path / f"o{asked}"),
                                  input_spec=[paddle.static.InputSpec(
                                      [1, 3], "float32")],
                                  opset_version=asked)
    assert _load(path).opset_import[0].version == emitted
    assert any("opset" in str(x.message) for x in w) == (asked != emitted)


def test_torch_module_refused(tmp_path):
    """A torch.nn.Module goes through torch.export
    (tests/test_torch_jit_save_module.py); refused are a module without
    an input_spec and an object that is neither a Layer nor a Module."""
    from paddle_tpu_torch.text.models import GPTForCausalLM, TransformerLMConfig
    m = GPTForCausalLM(TransformerLMConfig(vocab_size=64, hidden_size=32,
                                           num_layers=1, num_heads=2,
                                           max_seq_len=8), device="cpu")
    with pytest.raises(ValueError, match="input_spec"):
        paddle.onnx.export(m, str(tmp_path / "t"))
    with pytest.raises((TypeError, AttributeError)):
        paddle.onnx.export(object(), str(tmp_path / "o"), input_spec=[
            paddle.static.InputSpec([1, 8], "int64")])
