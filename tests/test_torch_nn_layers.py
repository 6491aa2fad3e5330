"""paddle_tpu_torch's ``nn`` layers against the JAX package's on the CPU:
tests/test_nn_layers.py's ``TestLayerBase`` whole, and its
``test_linear_semantics``, ``test_activations``, ``test_embedding``,
``test_losses``, ``test_grad_clip`` and ``test_norm_layers``' LayerNorm,
in both packages; every activation and loss layer on the same inputs;
``set_state_dict`` carrying the reference layer's weights (the same
construction gives the same structured names, and the same forward);
the initializers' distributions (the reference draws from
``jax.random``, the port from ``torch.Generator``s, so each is held to
its law: mean and std within a stated bound, ``TruncatedNormal`` within
two std, ``Uniform`` within its bounds, Xavier/Kaiming scales from
``_fans``); and the optimizers over ``Layer.parameters()``: ``AdamW``
against the reference's ``AdamW`` over its layer's parameters for 3
steps, with ``apply_decay_param_fun`` seeing each ``Parameter.name``.

Forward values at f32 ``allclose`` (rtol 1e-6, atol 1e-6), updates and
grads at rtol 1e-5.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL = ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def t(P, a):
    return P.to_tensor(np.asarray(a, dtype=np.float32))


def _carry(src, dst):
    """The reference layer's state_dict, as numpy arrays, into the port's
    layer; the keys must be the same."""
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    assert list(sd) == list(dst.state_dict())
    assert dst.set_state_dict(sd) == []


# ------------------------------------------------- TestLayerBase, whole

@pytest.mark.parametrize("P", [ref, paddle], ids=["ref", "port"])
class TestLayerBase:
    def test_registration(self, P):
        nn = P.nn

        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 3)
                self.w = P.Parameter(np.ones((2, 2), np.float32))
                self.register_buffer("buf", P.ones([2]))

            def forward(self, x):
                return self.fc(x)

        net = Net()
        names = dict(net.named_parameters())
        assert "w" in names and "fc.weight" in names and "fc.bias" in names
        assert len(net.parameters()) == 3
        assert len(net.buffers()) == 1
        assert net.fc is net._sub_layers["fc"]
        assert list(net.state_dict()) == ["w", "fc.weight", "fc.bias", "buf"]
        del net.w
        assert "w" not in dict(net.named_parameters())

    def test_state_dict_roundtrip(self, P):
        net = P.nn.Linear(3, 2)
        sd = net.state_dict()
        assert set(sd) == {"weight", "bias"}
        net2 = P.nn.Linear(3, 2)
        net2.set_state_dict({k: v.numpy() for k, v in sd.items()})
        np.testing.assert_array_equal(net2.weight.numpy(),
                                      net.weight.numpy())
        with pytest.raises(ValueError):
            net2.set_state_dict({"weight": np.zeros((2, 3), np.float32)})
        assert net2.set_state_dict({"weight": sd["weight"]}) == ["bias"]

    def test_train_eval_propagates(self, P):
        net = P.nn.Sequential(P.nn.Linear(2, 2), P.nn.Dropout(0.5))
        net.eval()
        assert not net[1].training
        net.train()
        assert net[1].training

    def test_forward_hooks(self, P):
        net = P.nn.Linear(2, 2)
        calls = []
        h = net.register_forward_post_hook(
            lambda layer, inp, out: calls.append(1))
        pre = net.register_forward_pre_hook(
            lambda layer, inp: (inp[0] * 0.0,))
        out = net(t(P, np.ones((1, 2))))
        assert calls == [1]
        np.testing.assert_allclose(out.numpy()[0], net.bias.numpy())
        h.remove()
        pre.remove()
        net(t(P, np.zeros((1, 2))))
        assert calls == [1]

    def test_apply_and_to_dtype(self, P):
        net = P.nn.Linear(2, 2)
        net.to(dtype="bfloat16")
        assert net.weight.dtype == P.bfloat16
        seen = []
        P.nn.Sequential(P.nn.Linear(2, 2), P.nn.ReLU()).apply(
            lambda layer: seen.append(type(layer).__name__))
        assert seen == ["Sequential", "Linear", "ReLU"]
        net.float()
        assert net.weight.dtype == P.float32

    def test_containers(self, P):
        nn = P.nn
        seq = nn.Sequential(nn.Linear(2, 4), nn.ReLU(), nn.Linear(4, 1))
        out = seq(t(P, np.ones((3, 2))))
        assert out.shape == [3, 1]
        assert len(seq) == 3 and len(seq[1:]) == 2
        ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
        assert len(ll) == 3 and len(ll.parameters()) == 6
        ll.append(nn.Linear(2, 2))
        assert len(ll) == 4
        ll.insert(0, nn.ReLU())
        assert type(ll[0]).__name__ == "ReLU" and len(ll) == 5
        pl = nn.ParameterList([P.Parameter(np.zeros(2, np.float32))])
        assert len(pl.parameters()) == 1
        ld = nn.LayerDict({"a": nn.Linear(2, 2)})
        assert "a" in ld and list(ld.keys()) == ["a"]
        named = nn.Sequential(collections.OrderedDict(
            [("first", nn.Linear(2, 3)), ("act", nn.Tanh())]))
        assert list(named.state_dict()) == ["first.weight", "first.bias"]

    def test_full_name_and_clear_gradients(self, P):
        a, b = P.nn.Linear(2, 2), P.nn.Linear(2, 2)
        na, nb = a.full_name(), b.full_name()
        assert na.startswith("linear_") and nb.startswith("linear_")
        assert int(nb.split("_")[1]) == int(na.split("_")[1]) + 1
        a(t(P, np.ones((1, 2)))).sum().backward()
        assert a.weight.grad is not None
        a.clear_gradients()
        assert a.weight.grad is None or not a.weight.grad.numpy().any()


# ------------------------------------------- TestLayers, in both packages

def test_linear_semantics():
    """Paddle's layout: weight [in, out], y = x W + b; the reference's
    weights carried across give the reference's output."""
    x = np.random.RandomState(0).randn(4, 3).astype("float32")
    rfc, fc = ref.nn.Linear(3, 2), paddle.nn.Linear(3, 2)
    assert fc.weight.shape == [3, 2] and fc.bias.shape == [2]
    np.testing.assert_allclose(fc(t(paddle, x)).numpy(),
                               x @ fc.weight.numpy() + fc.bias.numpy(),
                               rtol=1e-5)
    _carry(rfc, fc)
    np.testing.assert_allclose(fc(t(paddle, x)).numpy(),
                               rfc(t(ref, x)).numpy(), rtol=RTOL, atol=ATOL)
    nb = paddle.nn.Linear(3, 2, bias_attr=False)
    assert nb.bias is None and list(nb.state_dict()) == ["weight"]


ACT_LAYERS = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish",
              "Hardswish", "Hardsigmoid", "Softsign", "Tanhshrink",
              "LogSigmoid", "GELU", "LeakyReLU", "ELU", "SELU", "CELU",
              "Hardtanh", "Hardshrink", "Softshrink", "Softplus",
              "ThresholdedReLU", "Softmax", "LogSoftmax", "PReLU"]


@pytest.mark.parametrize("name", ACT_LAYERS)
def test_activation_layer(name):
    """test_nn_layers.py::test_activations, every activation layer on
    the same input in both packages."""
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32) * 2

    def run(P):
        return getattr(P.nn, name)()(t(P, x)).numpy()
    np.testing.assert_allclose(run(paddle), run(ref), rtol=RTOL, atol=ATOL)


def test_activation_layers_with_arguments():
    x = np.random.RandomState(2).randn(2, 6, 2).astype(np.float32)
    layers = [("GELU", (True,)), ("LeakyReLU", (0.2,)), ("ELU", (0.3,)),
              ("CELU", (2.0,)), ("Hardtanh", (-0.2, 0.3)),
              ("Softplus", (2.0, 1.0)), ("Softmax", (1,)), ("GLU", ()),
              ("Maxout", (2,)), ("LogSoftmax", (0,))]
    for name, args in layers:
        want = getattr(ref.nn, name)(*args)(t(ref, x)).numpy()
        got = getattr(paddle.nn, name)(*args)(t(paddle, x)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    for P in (ref, paddle):
        assert P.nn.Softmax()(t(P, x[0])).numpy().sum() == \
            pytest.approx(6.0, rel=1e-5)


def test_embedding():
    """test_nn_layers.py::test_embedding, and the padding row zeroed at
    construction on the parameter's own device."""
    ids = np.array([[1, 2], [3, 4]])
    for P in (ref, paddle):
        emb = P.nn.Embedding(10, 4)
        assert emb(P.to_tensor(ids)).shape == [2, 2, 4]
        pad = P.nn.Embedding(6, 3, padding_idx=-2)
        assert not pad.weight.numpy()[4].any()
        assert pad.weight.numpy()[3].any()
    re, pe = ref.nn.Embedding(6, 3, padding_idx=1), \
        paddle.nn.Embedding(6, 3, padding_idx=1)
    _carry(re, pe)
    assert pe.weight.value.device == torch.device("cpu")
    lookup = np.array([[1, 5, 0]])
    np.testing.assert_array_equal(pe(paddle.to_tensor(lookup)).numpy(),
                                  re(ref.to_tensor(lookup)).numpy())


LOSS_LAYERS = [
    ("CrossEntropyLoss", (), lambda rs: (rs.randn(5, 4),
                                         rs.randint(0, 4, 5))),
    ("CrossEntropyLoss", ("w", 2, "sum"),
     lambda rs: (rs.randn(5, 4), rs.randint(0, 4, 5))),
    ("MSELoss", (), lambda rs: (rs.randn(4, 3), rs.randn(4, 3))),
    ("L1Loss", ("none",), lambda rs: (rs.randn(4, 3), rs.randn(4, 3))),
    ("NLLLoss", (), lambda rs: (rs.randn(5, 4), rs.randint(0, 4, 5))),
    ("BCELoss", (), lambda rs: (rs.uniform(0.1, 0.9, (4, 3)),
                                (rs.rand(4, 3) > 0.5))),
    ("BCEWithLogitsLoss", (), lambda rs: (rs.randn(4, 3),
                                          (rs.rand(4, 3) > 0.5))),
    ("SmoothL1Loss", ("mean", 0.5), lambda rs: (rs.randn(4, 3),
                                                rs.randn(4, 3))),
    ("KLDivLoss", ("batchmean",), lambda rs: (rs.randn(4, 3),
                                              rs.uniform(0, 1, (4, 3)))),
    ("MarginRankingLoss", (0.2,), lambda rs: (rs.randn(5), rs.randn(5),
                                              np.sign(rs.randn(5)))),
]


@pytest.mark.parametrize("i", range(len(LOSS_LAYERS)))
def test_loss_layer(i):
    """test_nn_layers.py::test_losses and every loss layer of the slice,
    value and the grad of its first input, in both packages."""
    name, args, make = LOSS_LAYERS[i]
    arrays = make(np.random.RandomState(10 + i))
    w = np.random.RandomState(3).uniform(0.5, 1.5, 4).astype(np.float32)

    def run(P):
        ins = [P.to_tensor(a.astype(np.int64)) if a.dtype.kind == "i"
               else P.to_tensor(a.astype(np.float32)) for a in arrays]
        ins[0].stop_gradient = False
        a = [P.to_tensor(w) if x == "w" else x for x in args]
        loss = getattr(P.nn, name)(*a)(*ins)
        loss.sum().backward()
        return loss.numpy(), ins[0].grad.numpy()

    (wv, wg), (gv, gg) = run(ref), run(paddle)
    assert gv.shape == wv.shape
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gg, wg, rtol=1e-5, atol=1e-6)


def test_losses_shapes():
    pred = np.random.RandomState(4).randn(4, 3)
    label = np.array([0, 1, 2, 1])
    for P in (ref, paddle):
        p = t(P, pred)
        assert P.nn.CrossEntropyLoss()(p, P.to_tensor(label)).shape == []
        assert P.nn.MSELoss()(p, t(P, pred * 2)).shape == []
        assert P.nn.L1Loss("none")(p, p).shape == [4, 3]


def test_layer_norm():
    """test_nn_layers.py::test_norm_layers' LayerNorm: the mean of the
    output, the shapes, and the reference's output on its weights."""
    x = np.random.RandomState(5).randn(2, 4, 3, 3).astype(np.float32)
    seq = np.random.RandomState(6).randn(2, 5, 8).astype(np.float32)
    for P in (ref, paddle):
        ln = P.nn.LayerNorm([4, 3, 3])
        assert abs(ln(t(P, x)).numpy().mean()) < 1e-5
        l8 = P.nn.LayerNorm(8)
        assert l8(t(P, seq)).shape == [2, 5, 8]
        np.testing.assert_array_equal(l8.weight.numpy(), np.ones(8))
        np.testing.assert_array_equal(l8.bias.numpy(), np.zeros(8))
        assert l8._epsilon == 1e-5
    rl, pl = ref.nn.LayerNorm([4, 3, 3]), paddle.nn.LayerNorm([4, 3, 3])
    rl.weight.set_value(np.random.RandomState(7).randn(36).astype("f4"))
    rl.bias.set_value(np.random.RandomState(8).randn(36).astype("f4"))
    _carry(rl, pl)
    np.testing.assert_allclose(pl(t(paddle, x)).numpy(),
                               rl(t(ref, x)).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer", ["Flatten", "Identity", "Pad1D", "Pad2D",
                                   "Pad3D", "CosineSimilarity",
                                   "PairwiseDistance", "Bilinear"])
def test_common_layers(layer):
    rs = np.random.RandomState(9)
    make = {
        "Flatten": (lambda nn: nn.Flatten(), [rs.randn(2, 3, 4)]),
        "Identity": (lambda nn: nn.Identity(7), [rs.randn(2, 3)]),
        "Pad1D": (lambda nn: nn.Pad1D([1, 2], mode="reflect"),
                  [rs.randn(1, 2, 5)]),
        "Pad2D": (lambda nn: nn.Pad2D(1, value=2.0), [rs.randn(1, 2, 3, 3)]),
        "Pad3D": (lambda nn: nn.Pad3D([1, 0, 0, 1, 1, 1],
                                      mode="replicate"),
                  [rs.randn(1, 1, 2, 3, 3)]),
        "CosineSimilarity": (lambda nn: nn.CosineSimilarity(axis=-1),
                             [rs.randn(3, 5), rs.randn(3, 5)]),
        "PairwiseDistance": (lambda nn: nn.PairwiseDistance(),
                             [rs.randn(3, 5), rs.randn(3, 5)]),
        "Bilinear": (lambda nn: nn.Bilinear(3, 4, 2),
                     [rs.randn(5, 3), rs.randn(5, 4)]),
    }[layer]
    build, arrays = make
    rl, pl = build(ref.nn), build(paddle.nn)
    if rl.state_dict():
        _carry(rl, pl)
    want = rl(*[t(ref, a) for a in arrays]).numpy()
    got = pl(*[t(paddle, a) for a in arrays]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dropout_layers_train_and_eval():
    x = np.ones((8, 6, 4, 4), np.float32)
    for name in ("Dropout", "Dropout2D", "Dropout3D", "AlphaDropout"):
        layer = getattr(paddle.nn, name)(0.5)
        inp = paddle.to_tensor(x if name != "Dropout3D"
                               else x.reshape(8, 6, 2, 2, 4))
        assert (layer(inp).numpy() != inp.numpy()).any()
        layer.eval()
        np.testing.assert_array_equal(layer(inp).numpy(), inp.numpy())
    down = paddle.nn.Dropout(0.25, mode="downscale_in_infer").eval()
    np.testing.assert_allclose(down(paddle.to_tensor(x)).numpy(), 0.75)


def test_no_draw_from_torchs_global_generator():
    """Linear's initializer, randn and Dropout in training draw from the
    port's generators: torch's global generator state is unchanged."""
    state = torch.random.get_rng_state()
    fc = paddle.nn.Linear(16, 8)
    paddle.randn([4])
    drop = paddle.nn.Dropout(0.5)
    drop(fc(paddle.randn([3, 16])))
    paddle.nn.Embedding(5, 2, padding_idx=0)
    assert torch.equal(torch.random.get_rng_state(), state)


# ------------------------------------------------------------ initializers

INITS = [
    # (make(I), shape, mean, std, bounds)
    ("Constant", lambda I: I.Constant(0.5), (40, 50), 0.5, 0.0, None),
    ("Normal", lambda I: I.Normal(1.0, 2.0), (200, 100), 1.0, 2.0, None),
    ("TruncatedNormal", lambda I: I.TruncatedNormal(0.5, 2.0), (200, 100),
     0.5, 2.0 * 0.87962566, (0.5 - 4.0, 0.5 + 4.0)),
    ("Uniform", lambda I: I.Uniform(-0.5, 1.5), (200, 100), 0.5,
     2.0 / np.sqrt(12.0), (-0.5, 1.5)),
    ("XavierNormal", lambda I: I.XavierNormal(), (300, 100), 0.0,
     np.sqrt(2.0 / 400.0), None),
    ("XavierUniform", lambda I: I.XavierUniform(), (300, 100), 0.0,
     np.sqrt(6.0 / 400.0) / np.sqrt(3.0),
     (-np.sqrt(6.0 / 400.0), np.sqrt(6.0 / 400.0))),
    ("XavierNormal_conv", lambda I: I.XavierNormal(), (32, 16, 3, 3), 0.0,
     np.sqrt(2.0 / (16 * 9 + 32 * 9)), None),
    ("KaimingNormal", lambda I: I.KaimingNormal(), (300, 100), 0.0,
     np.sqrt(2.0 / 300.0), None),
    ("KaimingUniform", lambda I: I.KaimingUniform(negative_slope=0.5),
     (300, 100), 0.0, np.sqrt(2.0 / 1.25) * np.sqrt(3.0 / 300.0)
     / np.sqrt(3.0), (-np.sqrt(2.0 / 1.25) * np.sqrt(3.0 / 300.0),
                      np.sqrt(2.0 / 1.25) * np.sqrt(3.0 / 300.0))),
]


@pytest.mark.parametrize("i", range(len(INITS)))
def test_initializer_distribution(i):
    """Mean within five standard errors, std within 3 %, bounds exact;
    the dtype is the one asked for, the shape the same as the
    reference's; the same seed gives the same values."""
    name, make, shape, mean, std, bounds = INITS[i]
    want = np.asarray(make(ref.nn.initializer)(shape, "float32"))
    paddle.seed(21)
    got = make(paddle.nn.initializer)(shape, "float32")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == shape
    g = got.numpy().astype(np.float64)
    n = g.size
    if std == 0.0:
        assert np.all(g == mean)
    else:
        assert abs(g.mean() - mean) < 5 * std / np.sqrt(n)
        assert abs(g.std() - std) < 0.03 * std
    if bounds is not None:
        assert g.min() >= bounds[0] and g.max() <= bounds[1]
    paddle.seed(21)
    np.testing.assert_array_equal(
        make(paddle.nn.initializer)(shape, "float32").numpy(), g)
    assert make(paddle.nn.initializer)(shape, "bfloat16").dtype \
        == torch.bfloat16


def test_assign_bilinear_and_fans():
    I, RI = paddle.nn.initializer, ref.nn.initializer
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(I.Assign(v)((2, 3), "float32").numpy(), v)
    with pytest.raises(ValueError):
        I.Assign(v)((3, 2), "float32")
    np.testing.assert_allclose(
        I.Bilinear()((2, 3, 4, 4), "float32").numpy(),
        np.asarray(RI.Bilinear()((2, 3, 4, 4), "float32")))
    for shape in [(7,), (3, 5), (4, 2, 3, 3)]:
        assert I._fans(shape) == RI._fans(shape)


def test_param_attr_and_global_initializer():
    """create_parameter's precedence (reference layer_base.py:99-137):
    the attr's initializer beats the global one, which beats the layer's
    default; ParamAttr's name, trainable and need_clip reach the
    Parameter."""
    for P in (ref, paddle):
        I = P.nn.initializer
        fc = P.nn.Linear(3, 4, weight_attr=P.nn.ParamAttr(
            name="w0", initializer=I.Constant(2.0), trainable=False,
            need_clip=False), bias_attr=I.Constant(0.5))
        assert fc.weight.name == "w0" and fc.weight.stop_gradient
        np.testing.assert_array_equal(fc.weight.numpy(), 2.0)
        np.testing.assert_array_equal(fc.bias.numpy(), 0.5)
        I.set_global_initializer(I.Constant(3.0), I.Constant(-1.0))
        try:
            g = P.nn.Linear(2, 2)
            np.testing.assert_array_equal(g.weight.numpy(), 3.0)
            np.testing.assert_array_equal(g.bias.numpy(), -1.0)
            ln = P.nn.LayerNorm(3)           # its default loses too
            np.testing.assert_array_equal(ln.weight.numpy(), 3.0)
            attr = P.nn.Linear(2, 2, weight_attr=I.Constant(7.0))
            np.testing.assert_array_equal(attr.weight.numpy(), 7.0)
        finally:
            I.set_global_initializer(None, None)
        assert I.get_global_initializer() is None
    assert not paddle.nn.Linear(
        2, 2, weight_attr=paddle.ParamAttr(need_clip=False)).weight.need_clip


def test_linear_xavier_scale():
    paddle.seed(0)
    w = paddle.nn.Linear(512, 256).weight.numpy()
    assert abs(w.std() - np.sqrt(2.0 / 768.0)) < 0.02 * np.sqrt(2.0 / 768.0)


# ------------------------------------------------------ weights carried over

def _mlp(P):
    nn = P.nn
    return nn.Sequential(nn.Linear(6, 8), nn.GELU(), nn.LayerNorm(8),
                         nn.Dropout(0.0), nn.Linear(8, 3))


def test_set_state_dict_carries_the_references_weights():
    rm, pm = _mlp(ref), _mlp(paddle)
    assert list(rm.state_dict()) == list(pm.state_dict())
    _carry(rm, pm)
    x = np.random.RandomState(12).randn(5, 6).astype(np.float32)
    np.testing.assert_allclose(pm(t(paddle, x)).numpy(),
                               rm(t(ref, x)).numpy(), rtol=1e-5, atol=1e-6)
    # the port's own state_dict round-trips through numpy
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    fresh = _mlp(paddle)
    assert fresh.set_state_dict(sd) == []
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_to_keeps_the_parameters_identity():
    """Layer.to casts in place: the Parameter and its torch tensor stay
    the same objects, so an optimizer built before still updates
    them."""
    fc = paddle.nn.Linear(3, 2)
    w, leaf = fc.weight, fc.weight.value
    opt = paddle.optimizer.SGD(0.1, parameters=fc.parameters())
    fc.to(dtype="float64")
    fc.to(device="cpu")
    assert fc.weight is w and w.value is leaf and leaf.dtype == torch.float64
    before = w.numpy().copy()
    fc(paddle.to_tensor(np.ones((1, 3)))).sum().backward()
    opt.step()      # the update runs in f32, as every optimizer's does
    np.testing.assert_allclose(w.numpy(), before - 0.1, rtol=1e-6)


# --------------------------------------------------- optimizers and clips

def test_grad_clip():
    """test_nn_layers.py::test_grad_clip in both packages, and a
    Parameter with need_clip False left as it is."""
    for P in (ref, paddle):
        p = P.Parameter(np.ones(4, np.float32))
        (p * 100).sum().backward()
        out = P.nn.ClipGradByGlobalNorm(1.0)([(p, p.grad)])
        assert np.linalg.norm(out[0][1].numpy()) == pytest.approx(1.0,
                                                                  rel=1e-4)
        out2 = P.nn.ClipGradByValue(0.5)([(p, p.grad)])
        assert out2[0][1].numpy().max() <= 0.5
        out3 = P.nn.ClipGradByNorm(2.0)([(p, p.grad)])
        assert np.linalg.norm(out3[0][1].numpy()) == pytest.approx(2.0,
                                                                   rel=1e-4)
        p.need_clip = False
        for clip in (P.nn.ClipGradByGlobalNorm(1.0),
                     P.nn.ClipGradByValue(0.5), P.nn.ClipGradByNorm(2.0)):
            np.testing.assert_array_equal(clip([(p, p.grad)])[0][1].numpy(),
                                          100.0)


def _net(P):
    P.seed(0)
    nn = P.nn
    return nn.Sequential(nn.Linear(5, 7), nn.Tanh(), nn.LayerNorm(7),
                         nn.Linear(7, 3))


def _train(P, net, make, steps=3):
    x = np.random.RandomState(13).randn(6, 5).astype(np.float32)
    y = np.random.RandomState(14).randint(0, 3, 6)
    opt = make(P, net)
    losses = []
    for _ in range(steps):
        loss = P.nn.functional.cross_entropy(net(t(P, x)), P.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, [p.numpy() for p in net.parameters()], opt


def _pair():
    rn, pn = _net(ref), _net(paddle)
    _carry(rn, pn)
    return rn, pn


OPTS = {
    "AdamW": lambda P, net: P.optimizer.AdamW(
        0.01, parameters=net.parameters(), weight_decay=0.1,
        grad_clip=P.nn.ClipGradByGlobalNorm(0.5)),
    "Momentum_L2": lambda P, net: P.optimizer.Momentum(
        0.1, parameters=net.parameters(), weight_decay=0.01),
    "Adam_L1": lambda P, net: P.optimizer.Adam(
        0.01, parameters=net.parameters(),
        weight_decay=P.regularizer.L1Decay(0.001),
        grad_clip=P.nn.ClipGradByValue(0.05)),
    "Lamb_exclude": lambda P, net: P.optimizer.Lamb(
        0.01, parameters=net.parameters(),
        exclude_from_weight_decay_fn=lambda p: p.ndim == 1),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_over_layer_parameters_matches_the_reference(name):
    """Repair: the optimizers and clips take the core's Parameters
    (Layer.parameters()); 3 steps against the reference's optimizer over
    its layer's parameters, from the same weights."""
    rn, pn = _pair()
    (rl, rp, _), (pl, pp, popt) = (_train(ref, rn, OPTS[name]),
                                   _train(paddle, pn, OPTS[name]))
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    for a, b in zip(pp, rp):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # the Parameters kept their identity; state keys use Parameter.name
    keys = [k for k in popt.state_dict() if k != "LR_Scheduler"]
    names = [p.name for p in pn.parameters()]
    assert keys and all(any(k.startswith(n + "_") for n in names)
                        for k in keys)


def test_apply_decay_param_fun_sees_parameter_names():
    """AdamW's apply_decay_param_fun is called with each Parameter's
    .name, as the reference's (the names each package gave are
    recorded: the reference's "param_<n>" counter and the port's are
    separate, so each sees its own)."""
    rn, pn = _pair()
    seen = {}

    def make(P, net):
        names = seen.setdefault(P.__name__, [])
        decayed = {net[0].weight.name}

        def fun(n):
            names.append(n)
            return n in decayed
        return P.optimizer.AdamW(0.01, parameters=net.parameters(),
                                 weight_decay=0.5,
                                 apply_decay_param_fun=fun)

    (rl, rp, _), (pl, pp, _) = _train(ref, rn, make), _train(paddle, pn,
                                                             make)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    for a, b in zip(pp, rp):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    pnames = [p.name for p in pn.parameters()]
    rnames = [p.name for p in rn.parameters()]
    assert seen["paddle_tpu_torch"] == pnames * 3
    assert seen["paddle_tpu"] == rnames * 3
    assert all(n.startswith("param_") for n in pnames + rnames)


def test_lars_tags_and_minimize_take_parameters():
    """LarsMomentum's exclude tags match Parameter.name; minimize takes
    a core Tensor loss."""
    rn, pn = _pair()
    tag = pn[0].bias.name
    rtag = rn[0].bias.name

    def lars(P, net):
        return P.optimizer.LarsMomentum(
            0.1, parameters=net.parameters(),
            exclude_from_weight_decay=[rtag if P is ref else tag])

    (rl, rp, _), (pl, pp, _) = _train(ref, rn, lars), _train(paddle, pn,
                                                             lars)
    for a, b in zip(pp, rp):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    fc = paddle.nn.Linear(2, 1)
    opt = paddle.optimizer.SGD(0.5, parameters=fc.parameters())
    before = fc.bias.numpy().copy()
    assert opt.minimize(fc(paddle.ones([1, 2])).sum()) == (None, None)
    np.testing.assert_allclose(fc.bias.numpy(), before - 0.5)
