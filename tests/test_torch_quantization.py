"""paddle_tpu_torch's ``quantization`` against the JAX package's on the
CPU: every case of ``tests/test_quantization.py`` and
``tests/test_int8_inference.py``, each run in both packages, and the two
held to each other on the same numpy inputs and carried weights.

Tolerances and their causes: the fake quant-dequant outputs, the EMA
observer's state and the scale of an observer that sees the data are
bits (the same f32 operations in the same order: divide, multiply, round
half to even, clip, multiply by qmax's reciprocal as XLA rewrites the
division); an observer behind a Linear within 1e-6 (the f32 matmul sums
in another order); STE grads and the QAT toy regression's 60 losses,
teacher-forced, within 1e-5 relative (the same cause, through Adam);
``Int8Linear``'s ``w_q``/``w_scale`` are
bits (numpy computes them in both), its outputs within 1e-6 relative
(the int32 sums are exact; the f32 rescale and bias add round the same
way up to the activation scale's division); the NHWC/NDHWC conv cases
keep the reference test's tolerances (rtol 1e-4, atol 1e-5).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from test_torch_jit_save_load import carry

PACKAGES = (ref, paddle)
IDS = ["ref", "port"]


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _q(P):
    return __import__(f"{P.__name__}.quantization", fromlist=["x"])


def _qdq_np(x, bits=8):
    qmax = 2 ** (bits - 1) - 1
    scale = np.max(np.abs(x))
    if scale < 1e-8:
        scale = 1e-8
    return np.clip(np.round(x / scale * qmax), -qmax, qmax) * scale / qmax


# ---- test_quantization.py ---------------------------------------------------

def test_abs_max_qdq_matches_numpy_and_reference():
    x = np.random.RandomState(0).randn(16, 8).astype("float32")
    outs = [_q(P).quant_dequant_abs_max(P.to_tensor(x), bits=8).numpy()
            for P in PACKAGES]
    np.testing.assert_allclose(outs[1], _qdq_np(x), atol=1e-6)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_channel_wise_qdq():
    w = np.random.RandomState(1).randn(4, 8).astype("float32") * np.array(
        [[1.0], [10.0], [0.1], [5.0]], np.float32)
    outs = [_q(P).quant_dequant_channel_wise(P.to_tensor(w), bits=8,
                                             axis=0).numpy()
            for P in PACKAGES]
    expect = np.stack([_qdq_np(w[i]) for i in range(4)])
    np.testing.assert_allclose(outs[1], expect, atol=1e-6)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_ste_gradient_passes_through():
    x_np = np.random.RandomState(2).randn(8).astype("float32")
    grads = []
    for P in PACKAGES:
        x = P.to_tensor(x_np)
        x.stop_gradient = False
        y = _q(P).quant_dequant_abs_max(x, bits=8)
        (y * P.to_tensor(np.arange(8, dtype="float32"))).sum().backward()
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(grads[1], np.arange(8, dtype="float32"))
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5)


@pytest.mark.parametrize("P", PACKAGES, ids=IDS)
def test_moving_average_observer_updates_in_train_only(P):
    q = _q(P).FakeQuantMovingAverageAbsMax(bits=8, moving_rate=0.9)
    x = P.to_tensor(np.full((4,), 2.0, np.float32))
    q.train()
    q(x)
    s1 = float(q.scale.numpy())
    assert s1 > 0
    q.eval()
    q(P.to_tensor(np.full((4,), 100.0, np.float32)))
    assert float(q.scale.numpy()) == s1  # frozen in eval


def test_observer_ema_scales_are_the_reference_bits():
    xs = [np.random.RandomState(i).randn(6, 5).astype("float32") * (i + 1)
          for i in range(4)]
    got = []
    for P in PACKAGES:
        q = _q(P).FakeQuantMovingAverageAbsMax(bits=8, moving_rate=0.9)
        q.train()
        trail = []
        for x in xs:
            out = q(P.to_tensor(x)).numpy()
            trail.append((float(q.scale.numpy()), float(q.accum.numpy()),
                          float(q.state.numpy()), out))
        got.append(trail)
    for (s0, a0, st0, o0), (s1, a1, st1, o1) in zip(*got):
        assert (s0, a0, st0) == (s1, a1, st1)
        np.testing.assert_array_equal(o1, o0)


def _conv_fc(P):
    nn = P.nn
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.ReLU(),
                         nn.Flatten(), nn.Linear(8 * 4 * 4, 10))


def test_imperative_quant_aware_swaps_layers():
    ref.seed(0)
    r = _conv_fc(ref)
    p = _conv_fc(paddle)
    carry(r, p)
    x = np.random.RandomState(3).randn(2, 3, 4, 4).astype("float32")
    outs, grads = [], []
    for P, model in ((ref, r), (paddle, p)):
        _q(P).ImperativeQuantAware().quantize(model)
        kinds = [type(layer).__name__ for layer in model._sub_layers.values()]
        assert "QuantizedConv2D" in kinds and "QuantizedLinear" in kinds
        model.train()
        out = model(P.to_tensor(x))
        assert tuple(out.shape) == (2, 10)
        out.sum().backward()  # QAT backward works end to end
        for prm in model.parameters():
            if prm.trainable:
                assert prm.grad is not None
        outs.append(out.numpy())
        grads.append([prm.grad.numpy() for prm in model.parameters()])
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    for g1, g0 in zip(grads[1], grads[0]):
        np.testing.assert_allclose(g1, g0, rtol=1e-5,
                                   atol=1e-5 * np.abs(g0).max())


def test_qat_training_converges_on_toy_regression():
    """The reference's toy regression in both packages from the same
    weights: 60 Adam steps each, every loss falling below a fifth of the
    first. Teacher-forced against the reference (its weights and
    observer state carried into the port before each step), every
    step's loss within 1e-5 relative. Left to run apart, the two part
    by up to 8e-4 relative (step 7 of this seed): an activation within an
    ulp of a rounding boundary, where the f32 matmuls sum in another
    order, lands in the next quantum and the trajectories separate."""
    ref.seed(7)
    models = {}
    for P in PACKAGES:
        nn = P.nn
        models[P] = nn.Sequential(nn.Linear(4, 16), nn.ReLU(),
                                  nn.Linear(16, 1))
    carry(models[ref], models[paddle])
    w_true = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    x_np = np.random.RandomState(7).randn(64, 4).astype("float32")
    y_np = x_np @ w_true
    opts = {}
    for P, model in models.items():
        _q(P).ImperativeQuantAware().quantize(model)
        opts[P] = P.optimizer.Adam(0.01, parameters=model.parameters())
        model.train()

    def step(P, model):
        loss = ((model(P.to_tensor(x_np)) - P.to_tensor(y_np)) ** 2).mean()
        loss.backward()
        opts[P].step()
        opts[P].clear_grad()
        return float(loss.numpy())

    r, p = models[ref], models[paddle]
    forced = []
    for _ in range(60):
        p.set_state_dict({k: np.asarray(v.numpy())
                          for k, v in r.state_dict().items()})
        forced.append((step(ref, r), step(paddle, p)))
    want, got = np.array(forced).T
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[-1] < want[0] * 0.2
    paddle.seed(7)
    free = paddle.nn.Sequential(paddle.nn.Linear(4, 16), paddle.nn.ReLU(),
                                paddle.nn.Linear(16, 1))
    _q(paddle).ImperativeQuantAware().quantize(free)
    opts[paddle] = paddle.optimizer.Adam(0.01, parameters=free.parameters())
    free.train()
    losses = [step(paddle, free) for _ in range(60)]
    assert losses[-1] < losses[0] * 0.2


def test_post_training_quantization():
    ref.seed(0)
    r = ref.nn.Sequential(ref.nn.Linear(4, 8), ref.nn.ReLU(),
                          ref.nn.Linear(8, 2))
    p = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.ReLU(),
                             paddle.nn.Linear(8, 2))
    carry(r, p)
    data = [np.random.RandomState(i).randn(8, 4).astype("float32")
            for i in range(3)]
    scales, outs = [], []
    for P, model in ((ref, r), (paddle, p)):
        ptq = _q(P).PostTrainingQuantization(model)
        ptq.sample(*[P.to_tensor(d) for d in data])
        qmodel = ptq.convert()
        assert not qmodel.training
        out = qmodel(P.to_tensor(data[0])).numpy()
        assert np.all(np.isfinite(out))
        found = [float(sub._act_quant.scale.numpy())
                 for sub in qmodel._sub_layers.values()
                 if isinstance(sub, _q(P).QuantizedLinear)]
        assert found and all(s > 0 for s in found)
        scales.append(found)
        outs.append(out)
    # the first observer sees the data: bits; the next sees the first
    # Linear's f32 output, whose sums run in another order
    assert scales[1][0] == scales[0][0]
    np.testing.assert_allclose(scales[1], scales[0], rtol=1e-6)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("P", PACKAGES, ids=IDS)
def test_ptq_abs_max_takes_max_over_batches(P):
    model = P.nn.Sequential(P.nn.Linear(4, 4, bias_attr=False))
    ptq = _q(P).PostTrainingQuantization(model, algo="abs_max")
    ptq.sample(P.to_tensor(np.full((2, 4), 100.0, np.float32)))
    ptq.sample(P.to_tensor(np.full((2, 4), 1.0, np.float32)))
    ptq.convert()
    quantized = [sub for sub in model._sub_layers.values()
                 if isinstance(sub, _q(P).QuantizedLinear)]
    assert len(quantized) == 1
    assert float(quantized[0]._act_quant.scale.numpy()) >= 100.0


@pytest.mark.parametrize("P", PACKAGES, ids=IDS)
def test_observer_calibration_survives_reload(P):
    """A reloaded observer reuses its saved scale (the port's through
    set_state_dict's repaired _after_load_state_dict call)."""
    Q = _q(P)
    q = Q.FakeQuantMovingAverageAbsMax(bits=8, moving_rate=0.9)
    q.train()
    q(P.to_tensor(np.full((4, 4), 2.0, "float32")))
    q.eval()
    want = q(P.to_tensor(np.full((2, 2), 100.0, "float32"))).numpy()
    q2 = Q.FakeQuantMovingAverageAbsMax(bits=8, moving_rate=0.9)
    assert not q2._calibrated
    q2.set_state_dict(q.state_dict())
    assert q2._calibrated
    q2.eval()
    out = q2(P.to_tensor(np.full((2, 2), 100.0, "float32"))).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-6)
    assert out.max() < 50.0   # the frozen scale (~2.0) clips hard


@pytest.mark.parametrize("P", PACKAGES, ids=IDS)
def test_observer_uncalibrated_reload_clears_flag(P):
    Q = _q(P)
    q = Q.FakeQuantMovingAverageAbsMax(bits=8, moving_rate=0.9)
    q.train()
    q(P.to_tensor(np.full((4, 4), 2.0, "float32")))
    q.set_state_dict(Q.FakeQuantMovingAverageAbsMax(
        bits=8, moving_rate=0.9).state_dict())
    assert not q._calibrated
    q.eval()
    out = q(P.to_tensor(np.full((2, 2), 3.0, "float32"))).numpy()
    assert out.max() > 1.0  # dynamic fallback, not scale-0 collapse


# ---- test_int8_inference.py -------------------------------------------------

def _int8_model(P):
    nn = P.nn
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.ReLU(),
                         nn.Flatten(), nn.Linear(8 * 8 * 8, 32), nn.ReLU(),
                         nn.Linear(32, 10))


def _int8_pair():
    ref.seed(3)
    r = _int8_model(ref)
    p = _int8_model(paddle)
    carry(r, p)
    return r, p


def test_accuracy_close_to_fp32():
    r, p = _int8_pair()
    x = np.random.RandomState(0).randn(4, 3, 8, 8).astype("float32")
    qs = []
    for P, m in ((ref, r), (paddle, p)):
        want = m(P.to_tensor(x)).numpy()
        _q(P).convert_to_int8(m)
        q = m(P.to_tensor(x)).numpy()
        assert (want.argmax(1) == q.argmax(1)).all()
        rel = np.abs(want - q).max() / (np.abs(want).max() + 1e-6)
        assert rel < 0.1, rel
        qs.append(q)
    np.testing.assert_allclose(qs[1], qs[0], rtol=1e-5,
                               atol=1e-6 * np.abs(qs[0]).max())


def test_weights_are_int8_and_the_reference_bytes():
    r, p = _int8_pair()
    layers = {}
    for P, m in ((ref, r), (paddle, p)):
        _q(P).convert_to_int8(m)
        layers[P] = [s for s in m._sub_layers.values()
                     if isinstance(s, (_q(P).Int8Linear, _q(P).Int8Conv2D))]
        assert sum(isinstance(s, _q(P).Int8Linear) for s in layers[P]) == 2
        for layer in layers[P]:
            assert str(layer.w_q.numpy().dtype) == "int8"
    for a, b in zip(layers[ref], layers[paddle]):
        np.testing.assert_array_equal(b.w_q.numpy(), a.w_q.numpy())
        np.testing.assert_array_equal(b.w_scale.numpy(), a.w_scale.numpy())
        assert b.w_q.value.dtype == torch.int8


def test_int8_linear_outputs_within_1e6():
    ref.seed(11)
    r = ref.nn.Linear(48, 24)
    p = paddle.nn.Linear(48, 24)
    carry(r, p)
    x = np.random.RandomState(11).randn(5, 7, 48).astype("float32")
    outs = [_q(P).Int8Linear(m)(P.to_tensor(x)).numpy()
            for P, m in ((ref, r), (paddle, p))]
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6,
                               atol=1e-6 * np.abs(outs[0]).max())


@pytest.mark.parametrize("P", PACKAGES, ids=IDS)
def test_int32_accumulation_path(P):
    # int8 x int8 -> int32, not a dequantized product: inputs saturating
    # at +-127 keep the products exact in int32
    lin = P.nn.Linear(4, 2)
    lin.weight.set_value(np.full((4, 2), 1.0, np.float32))
    lin.bias.set_value(np.zeros(2, np.float32))
    q = _q(P).Int8Linear(lin)
    out = q(P.to_tensor(np.full((1, 4), 2.0, np.float32)))
    np.testing.assert_allclose(out.numpy(), [[8.0, 8.0]], rtol=1e-3)


def test_plain_int8_product_against_int_mm():
    """The CPU's plain product (int32 sums of int8 x int8) against
    torch._int_mm, and against an f32 product where that one is exact
    and where it is not (127^2 x 3072 passes 2^24)."""
    from paddle_tpu_torch.quantization import int8_matmul, int8_matmul_plain
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (32, 3072), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (3072, 16), dtype=torch.int8, generator=g)
    got = int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, int8_matmul_plain(a, b))
    assert torch.equal(got, torch._int_mm(a, b))
    big = torch.full((32, 3072), 127, dtype=torch.int8)
    assert int(int8_matmul(big, big.t().contiguous()[:, :16])[0, 0]) \
        == 127 * 127 * 3072


@pytest.mark.parametrize("P", PACKAGES, ids=IDS)
def test_state_dict_contains_quantized_weights(P):
    m = _int8_model(P)
    _q(P).convert_to_int8(m)
    assert any("w_q" in k for k in m.state_dict())


def test_converts_qat_wrapped_model():
    r, p = _int8_pair()
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype("float32")
    outs = []
    for P, m in ((ref, r), (paddle, p)):
        Q = _q(P)
        Q.ImperativeQuantAware().quantize(m)
        m(P.to_tensor(x))                   # calibrate observers once
        Q.convert_to_int8(m)
        assert sum(isinstance(s, Q.Int8Linear)
                   for s in m._sub_layers.values()) == 2
        out = m(P.to_tensor(x)).numpy()
        assert np.isfinite(out).all()
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5,
                               atol=1e-6 * np.abs(outs[0]).max())


@pytest.mark.parametrize("P", PACKAGES, ids=IDS)
def test_nhwc_conv_preserved(P):
    P.seed(0)
    conv = P.nn.Conv2D(3, 4, 3, padding=1, data_format="NHWC")
    x = P.to_tensor(np.random.RandomState(2).randn(1, 8, 8, 3)
                    .astype("float32"))
    want = conv(x).numpy()
    got = _q(P).Int8Conv2D(conv)(x).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-6) < 0.1


@pytest.mark.parametrize("P", PACKAGES, ids=IDS)
def test_nhwc_conv2d_matches_nchw(P):
    P.seed(0)
    a = P.nn.Conv2D(3, 4, 3, padding=1)
    b = P.nn.Conv2D(3, 4, 3, padding=1, data_format="NHWC")
    b.weight.set_value(a.weight.numpy())
    b.bias.set_value(a.bias.numpy())
    x = np.random.RandomState(0).randn(2, 3, 8, 8).astype("float32")
    want = a(P.to_tensor(x)).numpy()
    out = b(P.to_tensor(x.transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_allclose(out.transpose(0, 3, 1, 2), want, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("P", PACKAGES, ids=IDS)
def test_ndhwc_conv3d_matches_ncdhw(P):
    F = P.nn.functional
    rs = np.random.RandomState(1)
    x = rs.randn(1, 3, 4, 4, 4).astype("float32")
    w = rs.randn(4, 3, 2, 2, 2).astype("float32")
    want = F.conv3d(P.to_tensor(x), P.to_tensor(w)).numpy()
    out = F.conv3d(P.to_tensor(x.transpose(0, 2, 3, 4, 1)),
                   P.to_tensor(w), data_format="NDHWC").numpy()
    np.testing.assert_allclose(out.transpose(0, 4, 1, 2, 3), want,
                               rtol=1e-4, atol=1e-5)


def test_int8_jit_save_load_and_predictor(tmp_path):
    """An int8 model through jit.save, jit.load and the Predictor in both
    packages (its int8 ops are registered ops in the recorded program)."""
    ref.seed(0)
    mods = {}
    for P in PACKAGES:
        nn = P.nn
        mods[P] = nn.Sequential(nn.Flatten(), nn.Linear(16, 32), nn.ReLU(),
                                nn.Linear(32, 4))
    carry(mods[ref], mods[paddle])
    x = np.random.RandomState(0).randn(2, 16).astype("float32")
    outs = {}
    for P, m in mods.items():
        _q(P).convert_to_int8(m)
        q = m(P.to_tensor(x)).numpy()
        path = str(tmp_path / f"int8_{P.__name__}")
        P.jit.save(m, path, input_spec=[P.static.InputSpec([None, 16],
                                                           "float32")])
        loaded = P.jit.load(path)
        np.testing.assert_allclose(loaded(P.to_tensor(x)).numpy(), q,
                                   rtol=1e-4)
        inf = __import__(f"{P.__name__}.inference", fromlist=["x"])
        pred = inf.create_predictor(inf.Config(path + ".pdmodel"))
        got, = pred.run([x])
        np.testing.assert_allclose(got, q, rtol=1e-4)
        outs[P] = got
    np.testing.assert_allclose(outs[paddle], outs[ref], rtol=1e-5,
                               atol=1e-6 * np.abs(outs[ref]).max())
    from paddle_tpu_torch.jit.save_load import load_program
    prog = load_program(str(tmp_path / "int8_paddle_tpu_torch"),
                        torch.device("cpu"))[0]
    assert [r.type for r in prog.ops].count("int8_linear") == 2
