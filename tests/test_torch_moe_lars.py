"""The port's MoE (incubate/moe.py) and LARS against the reference's.

In one process: ``_moe_forward``'s output and aux loss at capacity
factors that bind and that do not, the grads of every parameter and of
the tokens, and a few Adam steps of a small MoE. Then dp = 2 x ep = 2
over four gloo rank processes (tests/torch_dist_worker.py, suite
``moe``, about 10 s): each dp rank holds half the tokens and each ep
rank half the experts; the reference's capacity and slot positions count
the global tokens, so capacity binding drops the same tokens only if the
ranks offset their slots by the lower dp ranks' counts. Tolerances, f32:
rtol 1e-5, atol 1e-6 (the combine summed over the ep ranks in another
order); the token grads of a dp rank are its share of the global loss,
dp times the reference's (DataParallel averages the ranks).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.moe import MoELayer

from _torch_dist import run_ranks
from torch_dist_worker import MOE_SHAPE, _port_moe
from paddle_tpu_torch import optimizer as port_opt

T = 64
TOL = dict(rtol=1e-5, atol=1e-6)
PARAMS = ("gate", "w1", "b1", "w2", "b2")


def _np(t):
    return np.asarray(t.numpy())


def _ref_weights(seed=3):
    paddle.seed(seed)
    ref = MoELayer(capacity_factor=1.0, **MOE_SHAPE)
    rs = np.random.RandomState(seed)
    ref.b1.set_value(rs.randn(*ref.b1.shape).astype(np.float32) * 0.1)
    ref.b2.set_value(rs.randn(*ref.b2.shape).astype(np.float32) * 0.1)
    inputs = {f"moe.{k}": _np(getattr(ref, k)) for k in PARAMS}
    inputs["moe.x"] = rs.randn(T, MOE_SHAPE["d_model"]).astype(np.float32)
    inputs["moe.cot"] = rs.randn(T, MOE_SHAPE["d_model"]).astype(np.float32)
    return inputs


def _ref_run(inputs, cf):
    """The reference layer's output, aux and the grads of
    mean-over-tokens (y * cot).sum(-1) + aux."""
    layer = MoELayer(capacity_factor=cf, **MOE_SHAPE)
    for k in PARAMS:
        getattr(layer, k).set_value(inputs[f"moe.{k}"])
    x = paddle.to_tensor(inputs["moe.x"], stop_gradient=False)
    y = layer(x)
    loss = (y * paddle.to_tensor(inputs["moe.cot"])).sum() / T \
        + layer.aux_loss
    loss.backward()
    out = {"y": _np(y), "aux": _np(layer.aux_loss), "dx": _np(x.grad)}
    for k in PARAMS:
        out[f"d{k}"] = _np(getattr(layer, k).grad)
    return out


@pytest.fixture(scope="module")
def weights():
    return _ref_weights()


@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
def test_moe_matches_reference_in_one_process(weights, cf):
    want = _ref_run(weights, cf)
    layer = _port_moe(weights, cf)
    x = torch.from_numpy(weights["moe.x"]).requires_grad_()
    y = layer(x)
    ((y * torch.from_numpy(weights["moe.cot"])).sum() / T
     + layer.aux_loss).backward()
    np.testing.assert_allclose(y.detach().numpy(), want["y"], **TOL)
    np.testing.assert_allclose(layer.aux_loss.item(), want["aux"], **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want["dx"], **TOL)
    for k in PARAMS:
        np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                   want[f"d{k}"], err_msg=k, **TOL)


def test_moe_capacity_binding_drops_tokens(weights):
    """At capacity factor 0.5 some tokens find their expert full: the
    output differs from an unbounded layer's, as the reference's."""
    tight, loose = _ref_run(weights, 0.5), _ref_run(weights, 4.0)
    assert not np.allclose(tight["y"], loose["y"])


def test_moe_trains_as_reference(weights):
    """8 Adam steps of the MSE plus 0.01 x aux: the reference's losses."""
    tgt = np.random.RandomState(7).randn(T, MOE_SHAPE["d_model"]).astype(
        np.float32)
    ref = MoELayer(capacity_factor=1.25, **MOE_SHAPE)
    for k in PARAMS:
        getattr(ref, k).set_value(weights[f"moe.{k}"])
    ropt = paddle.optimizer.Adam(1e-2, parameters=ref.parameters())
    mine = _port_moe(weights, 1.25)
    mopt = port_opt.Adam(1e-2, parameters=list(mine.parameters()))
    rl, ml = [], []
    for _ in range(8):
        loss = paddle.nn.functional.mse_loss(
            ref(paddle.to_tensor(weights["moe.x"])),
            paddle.to_tensor(tgt)) + ref.aux_loss * 0.01
        loss.backward()
        ropt.step()
        ropt.clear_grad()
        rl.append(float(loss.numpy()))
        loss = torch.nn.functional.mse_loss(
            mine(torch.from_numpy(weights["moe.x"])),
            torch.from_numpy(tgt)) + mine.aux_loss * 0.01
        loss.backward()
        mopt.step()
        mopt.clear_grad()
        ml.append(loss.item())
    np.testing.assert_allclose(ml, rl, rtol=1e-4)
    assert ml[-1] < ml[0]


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    return run_ranks("moe", 4, tmp_path_factory.mktemp("moe"), weights)


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_dp2_ep2_matches_reference(weights, ranks, cf):
    want = _ref_run(weights, cf)
    lines, arrays = ranks
    el = MOE_SHAPE["num_experts"] // 2
    per = T // 2
    for line, a in zip(lines, arrays):
        assert line["local_experts"] == el
        rows = slice(line["dp"] * per, (line["dp"] + 1) * per)
        np.testing.assert_allclose(a[f"y{cf}"], want["y"][rows], **TOL)
        np.testing.assert_allclose(a[f"aux{cf}"], want["aux"], **TOL)
        np.testing.assert_allclose(a[f"dx{cf}"] / 2, want["dx"][rows],
                                   **TOL)
        experts = slice(line["ep"] * el, (line["ep"] + 1) * el)
        np.testing.assert_allclose(a[f"dgate{cf}"], want["dgate"], **TOL)
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(a[f"d{k}{cf}"],
                                       want[f"d{k}"][experts], err_msg=k,
                                       **TOL)


def test_lars_momentum_matches_reference():
    """LarsMomentum's step (queue 1 item 13's reference test beside MoE)
    on the same parameter and grad."""
    from paddle_tpu.core.tensor import Tensor
    p = paddle.Parameter(np.ones(4, np.float32))
    opt = paddle.optimizer.LarsMomentum(0.1, parameters=[p])
    p._grad = Tensor(np.full(4, 0.5, np.float32))
    opt.step()
    q = torch.ones(4, requires_grad=True)
    mopt = port_opt.LarsMomentum(0.1, parameters=[q])
    q.grad = torch.full((4,), 0.5)
    mopt.step()
    np.testing.assert_allclose(q.detach().numpy(), _np(p), rtol=1e-6)
