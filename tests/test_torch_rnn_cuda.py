"""paddle_tpu_torch's recurrent surface on the card against the same on
the CPU (chip_smoke.py phase 23a's cases at small sizes): ``LSTM``,
``GRU`` and ``SimpleRNN`` (tanh and relu) forward and bidirectional,
from zeros and from given states; ``LSTMCell`` and ``GRUCell``;
``ctc_loss`` on unnormalised scores with a repeat and an infeasible row;
``hsigmoid_loss``; ``gather_tree``; ``linear_chain_crf`` and
``crf_decoding``; ``dynamic_decode`` with a ``BeamSearchDecoder``; a
``DataLoader`` with workers on the card. Marked ``cuda``: without a CUDA
device every test skips. On a machine with a card and no JAX, run them
without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_rnn_cuda.py

f32 with TF32 off in cuBLAS and cuDNN: every output and grad within 1e-4
of the largest element (sums over the steps in another order, cuDNN's
RNN against the CPU's); integer results exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    yield torch.device("cuda")
    device_mod._current_place = None


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _both(dev, call, arrays, make=None, exact=False):
    """``call(layer, *tensors)`` on the card and on the CPU, the layer
    made on the CPU and carried to its card twin; the outputs and every
    float input's and weight's grad, the card's held to the CPU's."""
    layers = [None, None]
    if make is not None:
        paddle.set_device("cpu")
        paddle.seed(1)
        cpu, card = make(), make()
        card.set_state_dict({k: v.value for k, v in cpu.state_dict().items()})
        paddle.set_device("gpu")
        layers = [card.to(device="gpu"), cpu]
    runs = []
    for layer, d in zip(layers, (dev, torch.device("cpu"))):
        ts = [paddle.Tensor._wrap(torch.tensor(
            a, device=d, requires_grad=a.dtype.kind == "f" and not exact))
            for a in arrays]
        outs = _flat(call(layer, *ts))
        total = None
        for k, o in enumerate(outs):
            if o.value.is_floating_point() and o.value.requires_grad:
                cot = torch.from_numpy(np.asarray(np.random.RandomState(k)
                                                  .randn(*o.shape),
                                                  np.float32)).to(d)
                term = (o.value * cot.to(o.value.dtype)).sum()
                total = term if total is None else total + term
        if total is not None:
            total.backward()
        params = layer.parameters() if layer is not None else []
        runs.append([o.value.detach().cpu() for o in outs]
                    + [t.value.grad.cpu() for t in ts
                       if t.value.grad is not None]
                    + [p.value.grad.cpu() for p in params])
    assert len(runs[0]) == len(runs[1])
    for got, want in zip(*runs):
        assert got.shape == want.shape and got.dtype == want.dtype
        if exact or not got.is_floating_point():
            assert torch.equal(got, want)
        else:
            err = ((got.double() - want.double()).abs().max()
                   / want.double().abs().max().clamp_min(1e-30)).item()
            assert err <= TOL, err


_rs = np.random.RandomState(0)
X = _rs.randn(6, 9, 32).astype(np.float32)
H0 = _rs.randn(4, 6, 24).astype(np.float32)


@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("mode", ["LSTM", "GRU", "tanh", "relu"])
def test_rnn_layers(dev, mode, direction):
    def make():
        kw = dict(num_layers=2, direction=direction)
        if mode in ("tanh", "relu"):
            return paddle.nn.SimpleRNN(32, 24, activation=mode, **kw)
        return getattr(paddle.nn, mode)(32, 24, **kw)
    _both(dev, lambda m, x: m(x), [X], make)
    if mode != "LSTM":
        _both(dev, lambda m, x, h: m(x, h), [X, H0], make)


def test_cells(dev):
    x, h = X[:, 0], H0[0]
    _both(dev, lambda m, a, s, c: m(a, (s, c)), [x, h, h * 0.5],
          lambda: paddle.nn.LSTMCell(32, 24))
    _both(dev, lambda m, a, s: m(a, s), [x, h],
          lambda: paddle.nn.GRUCell(32, 24))


def test_ctc_loss(dev):
    rs = np.random.RandomState(1)
    scores = (rs.randn(30, 4, 7) * 3).astype(np.float32)
    labels = rs.randint(1, 7, (4, 8)).astype(np.int32)
    labels[1, :4] = [3, 3, 5, 5]
    il = np.array([30, 25, 5, 28], np.int64)
    ll = np.array([8, 6, 8, 3], np.int64)
    for red in ("none", "mean", "sum"):
        _both(dev, lambda _, s, lab, i, n, red=red:
              paddle.nn.functional.ctc_loss(s, lab, i, n, reduction=red),
              [scores, labels, il, ll])


def test_hsigmoid_gather_tree_crf(dev):
    rs = np.random.RandomState(2)
    F = paddle.nn.functional
    _both(dev, lambda _, a, lab, w, b: F.hsigmoid_loss(a, lab, 37, w, b),
          [rs.randn(20, 16).astype(np.float32),
           rs.randint(0, 37, (20,)).astype(np.int64),
           rs.randn(36, 16).astype(np.float32),
           rs.randn(36).astype(np.float32)])
    _both(dev, lambda _, i, p: F.gather_tree(i, p),
          [rs.randint(0, 50, (7, 3, 4)).astype(np.int64),
           rs.randint(0, 4, (7, 3, 4)).astype(np.int64)], exact=True)
    em = rs.randn(5, 7, 6).astype(np.float32)
    trans = rs.randn(8, 6).astype(np.float32)
    lab = rs.randint(0, 6, (5, 7)).astype(np.int64)
    ln = np.array([7, 3, 1, 5, 0], np.int64)
    seq = paddle.ops.sequence
    _both(dev, lambda _, e, t, y, n: seq.linear_chain_crf(e, t, y, n),
          [em, trans, lab, ln])
    _both(dev, lambda _, e, t, n: seq.crf_decoding(e, t, n),
          [em, trans, ln], exact=True)


def test_beam_search(dev):
    class Holder(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.cell = paddle.nn.SimpleRNNCell(8, 16)
            self.emb = paddle.nn.Embedding(30, 8)
            self.head = paddle.nn.Linear(16, 30)
    paddle.set_device("cpu")
    paddle.seed(3)
    cpu = Holder()
    card = Holder()
    card.set_state_dict({k: v.value for k, v in cpu.state_dict().items()})
    paddle.set_device("gpu")
    card.to(device="gpu")
    ids = []
    for h, place in ((card, "gpu"), (cpu, "cpu")):
        paddle.set_device(place)
        dec = paddle.nn.BeamSearchDecoder(h.cell, 0, 1, 4, embedding_fn=h.emb,
                                          output_fn=h.head)
        inits = h.cell.get_initial_states(paddle.zeros([3, 8]))
        out, _ = paddle.nn.dynamic_decode(dec, inits=inits, max_step_num=7)
        ids.append(out.value.cpu())
    assert ids[0].shape == (3, 7, 4)
    assert torch.equal(ids[0], ids[1])


def test_dataloader_workers_on_the_card(dev):
    class Ds(paddle.io.Dataset):
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return np.full((64, 64), i, np.float32), np.int64(i)
    plain = [[t.value for t in b] for b in paddle.io.DataLoader(
        Ds(), batch_size=5)]
    workers = [[t.value for t in b] for b in paddle.io.DataLoader(
        Ds(), batch_size=5, num_workers=2)]
    assert len(plain) == len(workers) == 3
    for a, b in zip(plain, workers):
        for x, y in zip(a, b):
            assert x.is_cuda and y.is_cuda and torch.equal(x, y)
