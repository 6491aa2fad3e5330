"""paddle_tpu_torch's vision ops on the card against the same ops on the
CPU (chip_smoke.py phase 22a's cases at small sizes): the convolutions
of a ResNet (the 7x7/2 stem, a bottleneck's 1x1 and 3x3/2, the 1x1/2
downsample) and MobileNet's depthwise conv, the max pool with planted
ties and its grad, the batch norm in training (with the running buffers
after the step) and in eval, the adaptive average pool, ``interpolate``
in each mode and ``grid_sample``. Marked ``cuda``: without a CUDA device
every test skips. On a machine with a card and no JAX, run them without
the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_vision_cuda.py

f32 with TF32 off in cuBLAS and cuDNN: values within 1e-5 and grads
within 1e-4 of the largest element (sums in another order); the tie
grads, the pools' picks and the masks exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle

pytestmark = pytest.mark.cuda

TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def F():
    return paddle.nn.functional


def _both(dev, fn, arrays, exact=False):
    """``fn`` over Tensors of ``arrays`` on the card and on the CPU; the
    outputs and every input's grad (against a fixed cotangent), the
    card's held to the CPU's."""
    runs = []
    for d in (dev, torch.device("cpu")):
        ts = [paddle.Tensor._wrap(torch.tensor(a, device=d,
                                               requires_grad=a.dtype.kind
                                               == "f")) for a in arrays]
        out = fn(*ts)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        total = None
        for k, o in enumerate(outs):
            if o.value.is_floating_point():
                cot = torch.from_numpy(np.random.RandomState(k).randn(
                    *o.shape).astype(np.float32)).to(d)
                term = (o.value * cot).sum()
                total = term if total is None else total + term
        total.backward()
        runs.append(([o.value.detach().cpu() for o in outs],
                     [t.value.grad.cpu() for t in ts
                      if t.value.grad is not None]))
    for got, want in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert got.shape == want.shape and got.dtype == want.dtype
        if exact or not got.is_floating_point():
            assert torch.equal(got, want)
        else:
            scale = want.abs().max().clamp_min(1e-30)
            assert ((got - want).abs().max() / scale).item() <= GRAD_TOL
    return runs


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name, x, w, kw", [
    ("stem 7x7/2", (2, 3, 64, 64), (16, 3, 7, 7), dict(stride=2, padding=3)),
    ("bottleneck 1x1", (2, 32, 16, 16), (16, 32, 1, 1), dict()),
    ("bottleneck 3x3/2", (2, 16, 16, 16), (16, 16, 3, 3),
     dict(stride=2, padding=1)),
    ("downsample 1x1/2", (2, 32, 16, 16), (64, 32, 1, 1), dict(stride=2)),
    ("depthwise 3x3/2", (2, 24, 16, 16), (24, 1, 3, 3),
     dict(stride=2, padding=1, groups=24)),
    ("same at stride 2", (2, 8, 15, 15), (8, 8, 3, 3),
     dict(stride=2, padding="SAME")),
])
def test_conv_on_the_card(dev, name, x, w, kw):
    _both(dev, lambda a, b: F().conv2d(a, b, **kw), [_r(*x), _r(*w, seed=1)])


def test_max_pool_ties_on_the_card(dev):
    x = np.random.RandomState(2).randint(0, 3, (2, 4, 17, 17)).astype(
        np.float32)
    _both(dev, lambda a: F().max_pool2d(a, 3, 2, 1), [x], exact=True)
    _both(dev, lambda a: F().max_pool2d(a, 3, 2, 1, return_mask=True), [x],
          exact=True)


def test_batch_norm_on_the_card(dev):
    x = _r(4, 8, 9, 9) * 3 + 1
    cot = _r(4, 8, 9, 9, seed=4)
    layers = []
    for d in (dev, torch.device("cpu")):
        paddle.set_device("gpu" if d.type == "cuda" else "cpu")
        try:
            layers.append(paddle.nn.BatchNorm2D(8))
        finally:
            from paddle_tpu_torch.core import device as device_mod
            device_mod._current_place = None
    outs = []
    for lay, d in zip(layers, (dev, torch.device("cpu"))):
        xt = paddle.Tensor._wrap(torch.tensor(x, device=d,
                                              requires_grad=True))
        out = lay(xt)
        (out.value * torch.from_numpy(cot).to(d)).sum().backward()
        lay.eval()
        ev = lay(paddle.Tensor._wrap(torch.tensor(x, device=d)))
        outs.append([t.detach().cpu() for t in (
            out.value, xt.value.grad, lay._mean.value, lay._variance.value,
            ev.value)])
    for got, want in zip(*outs):
        scale = want.abs().max().clamp_min(1e-30)
        assert ((got - want).abs().max() / scale).item() <= GRAD_TOL


@pytest.mark.parametrize("mode, align, size", [
    ("nearest", False, (13, 7)), ("nearest", True, (13, 7)),
    ("bilinear", False, (13, 7)), ("bilinear", True, (13, 7)),
    ("bicubic", False, (5, 19)), ("bicubic", True, (5, 19)),
])
def test_interpolate_on_the_card(dev, mode, align, size):
    _both(dev, lambda a: F().interpolate(a, size=size, mode=mode,
                                         align_corners=align),
          [_r(2, 3, 9, 11)])


def test_adaptive_avg_pool_and_grid_sample_on_the_card(dev):
    _both(dev, lambda a: F().adaptive_avg_pool2d(a, (1, 1)), [_r(4, 32, 7,
                                                                  7)])
    _both(dev, lambda a: F().adaptive_avg_pool2d(a, (3, 5)), [_r(2, 3, 7,
                                                                 8)])
    grid = np.random.RandomState(3).uniform(-1.2, 1.2, (2, 5, 6, 2)).astype(
        np.float32)
    for pad in ("zeros", "border", "reflection"):
        _both(dev, lambda a, g: F().grid_sample(a, g, padding_mode=pad),
              [_r(2, 3, 8, 9), grid])
