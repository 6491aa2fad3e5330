"""paddle_tpu_torch's ``save``/``load`` against the JAX package's on the
CPU.

``tests/test_checkpoint.py``'s state-dict, bf16, nested-object and
optimizer-resume tests (:11-58), the bit-equal resume (:89-132) and the
name-matching restore (:195) on the port; its ``jit``, ``hapi`` and
sharded cases wait for those modules. Then files written by either
package loaded by the other: a layer's and an optimizer's state dicts
(a step after the load in both packages gives the same weights, f32
rtol 1e-6), bf16 under the reference's ``"__bf16__"`` marker both ways
(the same bits), nested objects, and ``load``'s return types (numpy
arrays; a torch bf16 tensor for the marker).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.core import device as device_mod


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


# ------------------------------------ tests/test_checkpoint.py, ported

def test_save_load_state_dict(tmp_path):
    net = nn.Sequential(nn.Linear(4, 8), nn.Linear(8, 2))
    path = str(tmp_path / "model.pdparams")
    paddle.save(net.state_dict(), path)
    loaded = paddle.load(path)
    net2 = nn.Sequential(nn.Linear(4, 8), nn.Linear(8, 2))
    net2.set_state_dict(loaded)
    for (n1, p1), (n2, p2) in zip(net.named_parameters(),
                                  net2.named_parameters()):
        np.testing.assert_array_equal(p1.numpy(), p2.numpy())


def test_save_load_bfloat16(tmp_path):
    net = nn.Linear(3, 3)
    net.to(dtype="bfloat16")
    path = str(tmp_path / "bf16.pdparams")
    paddle.save(net.state_dict(), path)
    loaded = paddle.load(path)
    assert loaded["weight"].dtype == torch.bfloat16
    assert torch.equal(loaded["weight"], net.weight.value)


def test_save_load_nested(tmp_path):
    obj = {"a": paddle.ones([2]), "b": [paddle.zeros([3]), 7], "c": "str",
           "d": (paddle.full([1], 2.0), torch.arange(3))}
    path = str(tmp_path / "obj.pkl")
    paddle.save(obj, path)
    loaded = paddle.load(path)
    np.testing.assert_array_equal(np.asarray(loaded["a"]), [1, 1])
    assert loaded["b"][1] == 7 and loaded["c"] == "str"
    assert isinstance(loaded["d"], tuple)
    np.testing.assert_array_equal(loaded["d"][1], [0, 1, 2])


def test_optimizer_checkpoint_resume(tmp_path):
    paddle.seed(0)
    net = nn.Linear(4, 4)
    for p in net.parameters():
        p.name = "p_" + p.name
    opt = paddle.optimizer.Adam(1e-2, parameters=net.parameters())
    x = paddle.to_tensor(np.random.randn(2, 4).astype("float32"))
    net(x).sum().backward()
    opt.step()
    opt.clear_grad()
    paddle.save(opt.state_dict(), str(tmp_path / "opt.pdopt"))
    paddle.save(net.state_dict(), str(tmp_path / "net.pdparams"))

    state = paddle.load(str(tmp_path / "opt.pdopt"))
    opt2 = paddle.optimizer.Adam(1e-2, parameters=net.parameters())
    opt2.set_state_dict(state)
    m1 = list(opt._accumulators["moment1"].values())[0].numpy()
    m2 = list(opt2._accumulators["moment1"].values())[0].numpy()
    np.testing.assert_array_equal(m1, m2)


def test_resume_training_is_bit_equivalent(tmp_path):
    """Save at step 5, restore into fresh model and optimizer instances,
    continue to step 10: the losses and final parameters equal the
    uninterrupted run's."""
    def make():
        paddle.seed(11)
        net = nn.Sequential(nn.Linear(6, 12), nn.Tanh(), nn.Linear(12, 3))
        opt = paddle.optimizer.Adam(5e-3, parameters=net.parameters())
        return net, opt

    rs = np.random.RandomState(3)
    xs = [rs.randn(4, 6).astype("float32") for _ in range(10)]
    ys = [rs.randint(0, 3, (4,)).astype("int64") for _ in range(10)]
    loss_fn = nn.CrossEntropyLoss()

    def step(net, opt, i):
        loss = loss_fn(net(paddle.to_tensor(xs[i])),
                       paddle.to_tensor(ys[i]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.numpy())

    net_a, opt_a = make()
    losses_a = [step(net_a, opt_a, i) for i in range(10)]
    net_b, opt_b = make()
    losses_b = [step(net_b, opt_b, i) for i in range(5)]
    paddle.save(net_b.state_dict(), str(tmp_path / "m.pdparams"))
    paddle.save(opt_b.state_dict(), str(tmp_path / "o.pdopt"))
    net_c, opt_c = make()
    net_c.set_state_dict(paddle.load(str(tmp_path / "m.pdparams")))
    opt_c.set_state_dict(paddle.load(str(tmp_path / "o.pdopt")))
    losses_b += [step(net_c, opt_c, i) for i in range(5, 10)]
    assert losses_a == losses_b
    for (n1, p1), (n2, p2) in zip(net_a.named_parameters(),
                                  net_c.named_parameters()):
        np.testing.assert_array_equal(p1.numpy(), p2.numpy())


def test_optimizer_restore_prefers_name_matching_on_reorder(tmp_path):
    paddle.seed(0)
    net = nn.Linear(4, 4)
    w, b = net.weight, net.bias
    opt = paddle.optimizer.Adam(1e-2, parameters=[w, b])
    x = paddle.to_tensor(np.random.randn(2, 4).astype("float32"))
    net(x).sum().backward()
    opt.step()
    opt.clear_grad()
    paddle.save(opt.state_dict(), str(tmp_path / "o.pdopt"))
    m_w = opt._accumulators["moment1"][id(w.value)].numpy()
    opt2 = paddle.optimizer.Adam(1e-2, parameters=[b, w])  # reordered
    opt2.set_state_dict(paddle.load(str(tmp_path / "o.pdopt")))
    np.testing.assert_allclose(
        opt2._accumulators["moment1"][id(w.value)].numpy(), m_w)
    assert opt2._accumulators["moment1"][id(b.value)].numpy().shape == (4,)


# ---------------------------------------------- across the two packages

def _net(P, seed):
    P.seed(seed)
    return P.nn.Sequential(P.nn.Linear(5, 7), P.nn.Tanh(), P.nn.Linear(7, 2))


def _train_step(P, net, opt, x):
    loss = P.sum(net(P.to_tensor(x)) ** 2)
    loss.backward()
    opt.step()
    opt.clear_grad()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_state_dicts_load_across_packages(tmp_path, writer):
    """One package trains a step and saves its layer and AdamW state; the
    other loads both into fresh objects; the next step in each gives the
    same weights."""
    src_p, dst_p = (ref, paddle) if writer == "ref" else (paddle, ref)
    x = np.random.RandomState(4).randn(3, 5).astype("float32")
    net = _net(src_p, 2)
    opt = src_p.optimizer.AdamW(1e-2, parameters=net.parameters(),
                                weight_decay=0.1)
    _train_step(src_p, net, opt, x)
    src_p.save(net.state_dict(), str(tmp_path / "n.pdparams"))
    src_p.save(opt.state_dict(), str(tmp_path / "o.pdopt"))
    _train_step(src_p, net, opt, x)

    net2 = _net(dst_p, 9)
    opt2 = dst_p.optimizer.AdamW(1e-2, parameters=net2.parameters(),
                                 weight_decay=0.1)
    net2.set_state_dict(dst_p.load(str(tmp_path / "n.pdparams")))
    # the parameters' auto names differ between the packages: the state
    # lands by the saved parameter order
    opt2.set_state_dict(dst_p.load(str(tmp_path / "o.pdopt")))
    _train_step(dst_p, net2, opt2, x)
    for p1, p2 in zip(net.parameters(), net2.parameters()):
        np.testing.assert_allclose(p2.numpy(), p1.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_bf16_marker_both_ways(tmp_path, writer):
    src_p, dst_p = (ref, paddle) if writer == "ref" else (paddle, ref)
    net = src_p.nn.Linear(4, 3)
    net.to(dtype="bfloat16")
    want = np.asarray(net.weight.numpy(), np.float32)   # bf16 values
    path = str(tmp_path / "bf16.pdparams")
    src_p.save({"sd": net.state_dict(), "n": 3}, path)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert set(raw["sd"]["weight"]) == {"__bf16__"}
    assert raw["sd"]["weight"]["__bf16__"].dtype == np.float32
    loaded = dst_p.load(path)
    assert loaded["n"] == 3
    assert "bfloat16" in str(loaded["sd"]["weight"].dtype)
    got = np.asarray(loaded["sd"]["weight"].astype("float32")) \
        if dst_p is ref else loaded["sd"]["weight"].float().numpy()
    np.testing.assert_array_equal(got, want)
    net2 = dst_p.nn.Linear(4, 3)
    net2.to(dtype="bfloat16")
    net2.set_state_dict(loaded["sd"])
    np.testing.assert_array_equal(np.asarray(net2.weight.numpy(),
                                             np.float32), want)


def test_load_returns_numpy_where_the_reference_does(tmp_path):
    path = str(tmp_path / "o.pkl")
    obj = {"w": ref.ones([2, 2]), "l": [ref.zeros([1])], "s": "x"}
    ref.save(obj, path)
    got, want = paddle.load(path), ref.load(path)
    assert isinstance(got["w"], np.ndarray) and isinstance(want["w"],
                                                           np.ndarray)
    np.testing.assert_array_equal(got["w"], want["w"])
    assert isinstance(got["l"], list) and got["s"] == "x"
    assert os.path.getsize(path) > 0
