"""paddle_tpu_torch's ``vision.models`` against the JAX package's on the
CPU: the canonical parameter counts of tests/test_models.py
(:250-266) and of the other ResNets; the same ``state_dict`` keys and
shapes for every model of ``vision.models``; LeNet, ``resnet18`` and a
``BottleneckBlock`` trained 2 Momentum steps with weight decay (config
2's optimizer) in f32 from the reference's weights (the losses, every
grad, every parameter after the steps and the batch norms' ``_mean`` /
``_variance``); ``paddle.save`` / ``load`` of a ResNet's state across
the packages both ways; and the Momentum ``velocity`` state carried
through ``text.convert.optimizer_state_from_paddle_tpu``. The dtypes
under ``auto_cast`` are in tests/test_torch_vision_amp.py.

``resnet18`` trains at [4, 3, 64, 64], where its last stage normalizes
16 values a channel. At [2, 3, 32, 32] that stage's batch norms see 2
values a channel: ``(x - mean) / sqrt(var + eps)`` with two close values
turns their rounding into a large relative error, and the reference's
own f32 run is 1e-3 of the loss from an f64 run there. So at that shape
each package's f32 run is held to the port's f64 run, and the port's
must be no farther from it than the reference's.

Tolerances: f32 losses rtol 1e-5; grads within 1e-4 of each tensor's
largest (a conv's sums in another order: XLA's against oneDNN's, through
up to 20 batch norms; the readings are 1e-5 to 3e-5); each tensor after
the steps, running statistics included, within 5e-5 of its largest.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.text.convert import optimizer_state_from_paddle_tpu

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STATE_TOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _count(model):
    return sum(int(np.prod(p.shape)) for p in model.parameters())


@pytest.mark.parametrize("name, kwargs, want", [
    ("resnet50", dict(num_classes=1000), 25557032),
    ("resnet18", dict(num_classes=1000), 11689512),
    ("resnet34", dict(), 21797672),
    ("resnext50_32x4d", dict(), 25028904),
    ("wide_resnet50_2", dict(), 68883240),
    ("vgg16", dict(num_classes=1000), 138357544),
    ("mobilenet_v2", dict(num_classes=1000), 3504872),
    ("LeNet", dict(), 61610),
])
def test_canonical_parameter_counts(name, kwargs, want):
    """tests/test_models.py::test_zoo_canonical_parameter_counts on the
    port (torchvision's published counts for the other ResNets)."""
    assert _count(getattr(paddle.vision.models, name)(**kwargs)) == want


MODELS = {
    "LeNet": lambda P: P.vision.models.LeNet(),
    "resnet18": lambda P: P.vision.models.resnet18(num_classes=10),
    "resnet50": lambda P: P.vision.models.resnet50(num_classes=10),
    "resnext50_32x4d": lambda P: P.vision.models.resnext50_32x4d(
        num_classes=10, with_pool=False),
    "vgg11_bn": lambda P: P.vision.models.vgg11(batch_norm=True,
                                                num_classes=0),
    "mobilenet_v1": lambda P: P.vision.models.mobilenet_v1(
        scale=0.25, num_classes=10),
    "mobilenet_v2": lambda P: P.vision.models.mobilenet_v2(
        scale=0.5, num_classes=10),
}


@pytest.fixture
def cheap_reference_init():
    """The reference draws each new weight shape through a compiled
    jax.random call; a constant global initializer builds the same
    layers (keys and shapes do not depend on the values) in a fraction
    of the time."""
    init = ref.nn.initializer
    init.set_global_initializer(init.Constant(0.0), init.Constant(0.0))
    yield
    init.set_global_initializer(None, None)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_dict_keys_and_shapes_match(name, cheap_reference_init):
    r, t = MODELS[name](ref), MODELS[name](paddle)
    rs = {k: tuple(v.shape) for k, v in r.state_dict().items()}
    ts = {k: tuple(v.shape) for k, v in t.state_dict().items()}
    assert list(rs) == list(ts) and rs == ts
    assert [n for n, _ in r.named_parameters()] == \
        [n for n, _ in t.named_parameters()]


def test_pretrained_raises():
    for fn in (paddle.vision.models.resnet50, paddle.vision.models.vgg16,
               paddle.vision.models.mobilenet_v2):
        with pytest.raises(RuntimeError):
            fn(pretrained=True)


def _carry(r, t):
    sd = {k: np.asarray(v.numpy()) for k, v in r.state_dict().items()}
    assert t.set_state_dict(sd) == []


def _train(P, model, batches):
    opt = P.optimizer.Momentum(0.1, momentum=0.9,
                               parameters=model.parameters(),
                               weight_decay=1e-4)
    loss_fn = P.nn.CrossEntropyLoss()
    losses, grads = [], []
    for x, y in batches:
        loss = loss_fn(model(P.to_tensor(x)), P.to_tensor(y))
        loss.backward()
        grads.append({n: p.grad.numpy() for n, p in model.named_parameters()})
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    state = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    return losses, grads, state


def _batches(shape, classes, n=2, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape).astype(np.float32),
             rs.randint(0, classes, (shape[0],)).astype(np.int64))
            for _ in range(n)]


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _check_training(r_run, t_run):
    (rl, rg, rs), (tl, tg, ts) = r_run, t_run
    np.testing.assert_allclose(tl, rl, rtol=LOSS_RTOL)
    for step in range(len(rg)):
        for n, want in rg[step].items():
            assert _rel(tg[step][n], want) <= GRAD_TOL, (step, n)
    assert list(ts) == list(rs)
    for k, want in rs.items():
        assert _rel(ts[k], want) <= STATE_TOL, k


TRAINED = {
    "LeNet": (lambda P: P.vision.models.LeNet(), (2, 1, 28, 28), 10),
    "resnet18": (lambda P: P.vision.models.resnet18(num_classes=10),
                 (4, 3, 64, 64), 10),
}


@pytest.mark.parametrize("name", sorted(TRAINED))
def test_two_momentum_steps_match_the_reference(name):
    make, shape, classes = TRAINED[name]
    ref.seed(0)
    r, t = make(ref), make(paddle)
    _carry(r, t)
    data = _batches(shape, classes)
    _check_training(_train(ref, r, data), _train(paddle, t, data))


def test_resnet18_at_2x32x32_is_no_farther_from_f64_than_the_reference():
    """The small shape [2, 3, 32, 32], where the last stage's batch norms
    see 2 values a channel: the first step's loss and every grad of each f32
    run against the port's f64 run of the same weights and batch."""
    make = TRAINED["resnet18"][0]
    ref.seed(0)
    r, t, t64 = make(ref), make(paddle), make(paddle)
    t64.to(dtype="float64")
    _carry(r, t)
    _carry(r, t64)
    data = _batches((2, 3, 32, 32), 10, n=1)
    runs = [_train(ref, r, data), _train(paddle, t, data),
            _train(paddle, t64, [(x.astype(np.float64), y)
                                 for x, y in data])]
    (rl, rg, _), (tl, tg, _), (dl, dg, _) = runs
    assert abs(tl[0] - dl[0]) <= abs(rl[0] - dl[0])
    worst = {name: max(_rel(g[0][n], dg[0][n]) for n in dg[0])
             for name, g in (("ref", rg), ("port", tg))}
    assert worst["port"] <= worst["ref"], worst


def test_bottleneck_block_two_momentum_steps():
    """A downsampling BottleneckBlock (1x1, 3x3/2, 1x1 and the 1x1/2
    downsample, four batch norms) under a Linear head."""
    def make(P):
        from_mod = P.vision.models.resnet
        down = P.nn.Sequential(P.nn.Conv2D(16, 32, 1, stride=2,
                                           bias_attr=False),
                               P.nn.BatchNorm2D(32))
        return P.nn.Sequential(
            from_mod.BottleneckBlock(16, 8, stride=2, downsample=down),
            P.nn.AdaptiveAvgPool2D(1), P.nn.Flatten(), P.nn.Linear(32, 5))
    ref.seed(1)
    r, t = make(ref), make(paddle)
    _carry(r, t)
    data = _batches((3, 16, 9, 9), 5, seed=2)
    _check_training(_train(ref, r, data), _train(paddle, t, data))


def test_save_load_across_packages(tmp_path):
    """A reference ResNet's paddle.save file loads into the port (and its
    eval forward gives the reference's), and the port's file into the
    reference; the batch-norm buffers travel under ``_mean`` and
    ``_variance``."""
    make = TRAINED["resnet18"][0]
    ref.seed(3)
    r, t = make(ref), make(paddle)
    data = _batches((4, 3, 64, 64), 10, n=1, seed=4)
    _train(ref, r, data)                # moves weights and statistics
    ref.save(r.state_dict(), str(tmp_path / "ref.pdparams"))
    loaded = paddle.load(str(tmp_path / "ref.pdparams"))
    assert any(k.endswith("_variance") for k in loaded)
    assert t.set_state_dict(loaded) == []
    x = data[0][0]
    r.eval()
    t.eval()
    np.testing.assert_allclose(t(paddle.to_tensor(x)).numpy(),
                               r(ref.to_tensor(x)).numpy(), rtol=1e-4,
                               atol=1e-5)
    _train(paddle, t.train(), _batches((4, 3, 64, 64), 10, n=1, seed=5))
    paddle.save(t.state_dict(), str(tmp_path / "port.pdparams"))
    back = ref.load(str(tmp_path / "port.pdparams"))
    r2 = make(ref)
    r2.set_state_dict(back)
    for k, v in t.state_dict().items():
        np.testing.assert_array_equal(np.asarray(r2.state_dict()[k].numpy()),
                                      v.numpy())


def test_momentum_velocity_carried_across():
    """Two reference Momentum steps, its state carried into the port's
    optimizer over the carried weights (the names map each reference
    Parameter.name to the port's), then one more step on each side."""
    make = TRAINED["LeNet"][0]
    ref.seed(6)
    r, t = make(ref), make(paddle)
    data = _batches((2, 1, 28, 28), 10, n=3, seed=7)
    ropt = ref.optimizer.Momentum(0.1, momentum=0.9,
                                  parameters=r.parameters(),
                                  weight_decay=1e-4)
    loss_fn = ref.nn.CrossEntropyLoss()
    for x, y in data[:2]:
        loss_fn(r(ref.to_tensor(x)), ref.to_tensor(y)).backward()
        ropt.step()
        ropt.clear_grad()
    _carry(r, t)
    state = {k: (v if k == "LR_Scheduler" else np.asarray(v.numpy()))
             for k, v in ropt.state_dict().items()}
    names = {rp.name: tp.name for rp, tp in zip(r.parameters(),
                                                t.parameters())}
    topt = paddle.optimizer.Momentum(0.1, momentum=0.9,
                                     parameters=t.parameters(),
                                     weight_decay=1e-4)
    topt.set_state_dict(optimizer_state_from_paddle_tpu(state, names))
    x, y = data[2]
    for P, m, o in ((ref, r, ropt), (paddle, t, topt)):
        P.nn.CrossEntropyLoss()(m(P.to_tensor(x)), P.to_tensor(y)).backward()
        o.step()
    for (n, rp), (_, tp) in zip(r.named_parameters(), t.named_parameters()):
        assert _rel(tp.numpy(), rp.numpy()) <= STATE_TOL, n
