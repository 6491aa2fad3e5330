"""paddle_tpu_torch's ``nn.utils`` (``weight_norm``,
``remove_weight_norm``, ``spectral_norm``) and ``nn.SpectralNorm``
against the JAX package's on the CPU.

``tests/test_functional_gaps.py``'s ``TestSpectralNorm`` (:107-142) on
the port; ``SpectralNorm`` and the functional power iteration against
the reference's with the same u/v; each reparameterization on a
``Linear`` (and weight norm around each dim) attached in both packages,
the reference's factors and power-iteration state carried in, then 3
Adam steps: the trained factors, the recomputed weight, the
power-iteration state and the losses against the reference's. f32, no
TF32: rtol/atol 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.nn.utils as ref_utils
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.core import device as device_mod

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL, err_msg=msg)


# -------------------- tests/test_functional_gaps.py TestSpectralNorm, ported

class TestSpectralNorm:
    def test_sigma_converges_to_largest_singular_value(self):
        paddle.seed(0)
        rs = np.random.RandomState(4)
        w = rs.randn(6, 4).astype(np.float32)
        sn = nn.SpectralNorm(w.shape, dim=0, power_iters=20)
        out = sn(paddle.to_tensor(w))
        sigma = np.linalg.svd(w, compute_uv=False)[0]
        np.testing.assert_allclose(out.numpy(), w / sigma, rtol=1e-3)

    def test_conv_weight_and_state_refresh(self):
        paddle.seed(0)
        rs = np.random.RandomState(5)
        w = rs.randn(8, 4, 3, 3).astype(np.float32)
        sn = nn.SpectralNorm(w.shape, dim=0, power_iters=2)
        u0 = sn.weight_u.numpy().copy()
        out = sn(paddle.to_tensor(w))
        assert out.shape == list(w.shape)
        assert not np.allclose(sn.weight_u.numpy(), u0)  # state advanced
        mat = out.numpy().reshape(8, -1)
        assert np.linalg.svd(mat, compute_uv=False)[0] < 1.5

    def test_gradient_flows_to_weight(self):
        paddle.seed(0)
        w = paddle.to_tensor(
            np.random.RandomState(6).randn(4, 4).astype(np.float32))
        w.stop_gradient = False
        sn = nn.SpectralNorm((4, 4), power_iters=3)
        sn(w).sum().backward()
        assert w.grad is not None
        assert np.isfinite(w.grad.numpy()).all()


@pytest.mark.parametrize("shape,dim,iters", [((6, 4), 0, 1),
                                             ((6, 4), 1, 3),
                                             ((8, 4, 3, 3), 0, 2),
                                             ((4, 8, 3, 3), 1, 1)])
def test_spectral_norm_layer_matches_reference(shape, dim, iters):
    rs = np.random.RandomState(7)
    w = rs.randn(*shape).astype(np.float32)
    gw = rs.randn(*shape).astype(np.float32)
    ref.seed(1)
    layers = {ref: ref.nn.SpectralNorm(shape, dim=dim, power_iters=iters),
              paddle: nn.SpectralNorm(shape, dim=dim, power_iters=iters)}
    layers[paddle].set_state_dict(
        {k: v.numpy() for k, v in layers[ref].state_dict().items()})
    got = []
    for P, sn in layers.items():
        x = P.to_tensor(w, stop_gradient=False)
        out = sn(x)
        P.sum(out * P.to_tensor(gw)).backward()
        got.append((out.numpy(), x.grad.numpy(), sn.weight_u.numpy(),
                    sn.weight_v.numpy()))
    for g, r in zip(got[1], got[0]):
        _close(g, r)


def _linear_pair(seed=2, din=5, dout=3):
    ref.seed(seed)
    r = ref.nn.Linear(din, dout)
    t = nn.Linear(din, dout)
    t.set_state_dict({k: v.numpy() for k, v in r.state_dict().items()})
    return r, t


def _train(P, layer, steps=3):
    opt = P.optimizer.Adam(0.05, parameters=layer.parameters())
    rs = np.random.RandomState(8)
    losses = []
    for _ in range(steps):
        x = P.to_tensor(rs.randn(4, layer.weight.shape[0]).astype(
            np.float32))
        loss = P.sum(layer(x) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_trains_as_the_reference(dim):
    r, t = _linear_pair()
    ref_utils.weight_norm(r, dim=dim)
    nn.utils.weight_norm(t, dim=dim)
    names = [n for n, _ in t.named_parameters()]
    assert names == [n for n, _ in r.named_parameters()]
    assert "weight" not in names and {"weight_g", "weight_v"} <= set(names)
    _close(t.weight_g.numpy(), r.weight_g.numpy())
    _close(t.weight.numpy(), r.weight.numpy())
    lt, lr = _train(paddle, t), _train(ref, r)
    _close(lt, lr, "losses")
    for n in ("weight_g", "weight_v", "bias"):
        _close(getattr(t, n).numpy(), getattr(r, n).numpy(), n)
    ref_utils.remove_weight_norm(r)
    nn.utils.remove_weight_norm(t)
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in r.named_parameters()] == ["bias", "weight"]
    _close(t.weight.numpy(), r.weight.numpy())
    with pytest.raises(ValueError):
        nn.utils.remove_weight_norm(t)


def test_spectral_norm_hook_trains_as_the_reference():
    r, t = _linear_pair(seed=4, din=6, dout=4)
    ref_utils.spectral_norm(r, n_power_iterations=2)
    nn.utils.spectral_norm(t, n_power_iterations=2)
    sd = {k: v.numpy() for k, v in r.state_dict().items()}
    assert list(sd) == list(t.state_dict())
    # Linear's weight [in, out] iterates around dim 1: u has out entries
    assert sd["_weight_spectral_norm.weight_u"].shape == (4,)
    assert t.set_state_dict(sd) == []
    lt, lr = _train(paddle, t), _train(ref, r)
    _close(lt, lr, "losses")
    for k, v in r.state_dict().items():
        _close(t.state_dict()[k].numpy(), v.numpy(), k)
    _close(t.weight.numpy(), r.weight.numpy())
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in r.named_parameters()]
