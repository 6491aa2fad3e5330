"""paddle_tpu_torch's recurrent layers against the JAX package's on the
CPU: ``LSTM``, ``GRU`` and ``SimpleRNN`` (tanh and relu) in each
direction, with ``time_major`` and one or two layers, from zeros and
from given ``initial_states``, without biases; the cells; ``RNN`` and
``BiRNN`` over each cell; every output, final state and grad (the input's
and every weight's) on the reference's weights carried across by
``set_state_dict``; the state-dict keys; the dtype of every output under
``auto_cast`` O1 and O2 (the ops ``lstm_layer``, ``gru_layer`` and
``simple_rnn_layer`` are on neither list, so O2 runs them in bf16 and O1
in f32, while ``SimpleRNNCell``'s ``matmul`` is white-listed); dropout
between layers; the reference's own scenarios (``test_nn_layers.py``'s
RNN tests, ``test_api_round2.py``'s cell wrappers).

The reference runs a ``lax.scan`` per layer and direction, the port
torch's fused RNN ops: f32 values within rtol 1e-5 / atol 1e-6, grads
within rtol 1e-4 / atol 1e-5 (sums over the steps in another order);
bf16 runs (O2) within 2e-2.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _carry(r, t):
    sd = {k: np.asarray(v.numpy()) for k, v in r.state_dict().items()}
    assert list(t.state_dict()) == list(sd)
    assert t.set_state_dict(sd) == []


def _pair(make):
    """The same layer in both packages, the reference's weights in the
    port's."""
    ref.seed(0)
    r = make(ref)
    t = make(paddle)
    _carry(r, t)
    return r, t


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _run(P, layer, arrays, call, grad_idx=(0,)):
    """``call(layer, *tensors)``'s outputs, and the grads of the inputs in
    ``grad_idx`` and of every parameter against fixed cotangents."""
    ts = []
    for i, a in enumerate(arrays):
        x = P.to_tensor(a)
        if i in grad_idx:
            x.stop_gradient = False
        ts.append(x)
    outs = _flat(call(layer, *ts))
    total = None
    for k, o in enumerate(outs):
        cot = np.random.RandomState(50 + k).randn(*o.shape).astype(
            np.float32)
        term = (o * P.to_tensor(cot)).sum()
        total = term if total is None else total + term
    total.backward()
    grads = [np.asarray(ts[i].grad.numpy()) for i in grad_idx]
    grads += [np.asarray(p.grad.numpy()) for p in layer.parameters()]
    return [np.asarray(o.numpy()) for o in outs], grads


def _same(make, arrays, call, grad_idx=(0,)):
    r, t = _pair(make)
    (ro, rg), (to, tg) = (_run(P, m, arrays, call, grad_idx)
                          for P, m in ((ref, r), (paddle, t)))
    assert len(ro) == len(to) and len(rg) == len(tg)
    for a, b in zip(to, ro):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, rg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


_rs = np.random.RandomState(0)
X = _rs.randn(3, 5, 4).astype(np.float32)        # [batch, seq, feat]
X_TM = X.transpose(1, 0, 2).copy()               # [seq, batch, feat]

MODES = {
    "LSTM": lambda P, **kw: P.nn.LSTM(4, 6, **kw),
    "GRU": lambda P, **kw: P.nn.GRU(4, 6, **kw),
    "tanh": lambda P, **kw: P.nn.SimpleRNN(4, 6, **kw),
    "relu": lambda P, **kw: P.nn.SimpleRNN(4, 6, activation="relu", **kw),
}


@pytest.mark.parametrize("layers,time_major", [(1, False), (2, True)])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("mode", list(MODES))
def test_layer_outputs_states_and_grads(mode, direction, time_major, layers):
    """Every mode, direction, layout and depth: y, the final states and
    the grads of x and of every weight."""
    _same(lambda P: MODES[mode](P, num_layers=layers, direction=direction,
                                time_major=time_major),
          [X_TM if time_major else X], lambda m, x: m(x))


@pytest.mark.parametrize("mode", list(MODES))
def test_layer_from_initial_states(mode):
    """``initial_states`` ([layers * dirs, B, H], a pair for the LSTM), with
    their grads."""
    rs = np.random.RandomState(3)
    h0 = rs.randn(4, 3, 6).astype(np.float32)
    c0 = rs.randn(4, 3, 6).astype(np.float32)
    if mode == "LSTM":
        _same(lambda P: MODES[mode](P, num_layers=2, direction="bidirect"),
              [X, h0, c0], lambda m, x, h, c: m(x, (h, c)),
              grad_idx=(0, 1, 2))
    else:
        _same(lambda P: MODES[mode](P, num_layers=2, direction="bidirect"),
              [X, h0], lambda m, x, h: m(x, h), grad_idx=(0, 1))


@pytest.mark.parametrize("mode", ["LSTM", "GRU", "tanh"])
def test_layer_without_biases(mode):
    """``bias_ih_attr=False``/``bias_hh_attr=False``: no bias parameters,
    the gates without them."""
    _same(lambda P: MODES[mode](P, num_layers=2, bias_ih_attr=False,
                                bias_hh_attr=False),
          [X], lambda m, x: m(x))


def test_sequence_length_is_not_read():
    """``sequence_length`` is taken and not read, as in the reference:
    the padding reaches the final states."""
    r, t = _pair(lambda P: P.nn.LSTM(4, 6, direction="bidirect"))
    lens = np.array([5, 2, 3], np.int64)
    a = [np.asarray(o.numpy()) for o in _flat(
        t(paddle.to_tensor(X), sequence_length=paddle.to_tensor(lens)))]
    b = [np.asarray(o.numpy()) for o in _flat(t(paddle.to_tensor(X)))]
    c = [np.asarray(o.numpy()) for o in _flat(
        r(ref.to_tensor(X), sequence_length=ref.to_tensor(lens)))]
    for u, v, w in zip(a, b, c):
        np.testing.assert_array_equal(u, v)
        np.testing.assert_allclose(u, w, rtol=RTOL, atol=ATOL)


CELLS = {
    "LSTMCell": lambda P: P.nn.LSTMCell(4, 6),
    "GRUCell": lambda P: P.nn.GRUCell(4, 6),
    "SimpleRNNCell": lambda P: P.nn.SimpleRNNCell(4, 6),
    "SimpleRNNCell_relu": lambda P: P.nn.SimpleRNNCell(4, 6,
                                                       activation="relu"),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_step(cell):
    """One step from zeros and from given states."""
    rs = np.random.RandomState(4)
    x = rs.randn(3, 4).astype(np.float32)
    h = rs.randn(3, 6).astype(np.float32)
    c = rs.randn(3, 6).astype(np.float32)
    _same(CELLS[cell], [x], lambda m, a: m(a))
    if cell == "LSTMCell":
        _same(CELLS[cell], [x, h, c], lambda m, a, b, d: m(a, (b, d)),
              grad_idx=(0, 1, 2))
    else:
        _same(CELLS[cell], [x, h], lambda m, a, b: m(a, b),
              grad_idx=(0, 1))


@pytest.mark.parametrize("is_reverse,time_major", [(False, False),
                                                   (True, True)])
@pytest.mark.parametrize("cell", list(CELLS))
def test_rnn_over_each_cell(cell, is_reverse, time_major):
    _same(lambda P: P.nn.RNN(CELLS[cell](P), is_reverse=is_reverse,
                             time_major=time_major),
          [X_TM if time_major else X], lambda m, x: m(x))


@pytest.mark.parametrize("cell", list(CELLS))
def test_birnn_over_each_cell(cell):
    _same(lambda P: P.nn.BiRNN(CELLS[cell](P), CELLS[cell](P)), [X],
          lambda m, x: m(x))


def test_lstm_cell_is_no_rnn_cell_base():
    """The class hierarchy is the reference's: the LSTM and GRU cells are
    plain Layers, SimpleRNNCell an RNNCellBase; get_initial_states gives
    one [B, H] state (its LSTMCell branch never runs)."""
    for P in (ref, paddle):
        assert not isinstance(P.nn.LSTMCell(4, 6), P.nn.RNNCellBase)
        assert not isinstance(P.nn.GRUCell(4, 6), P.nn.RNNCellBase)
        cell = P.nn.SimpleRNNCell(4, 6)
        assert isinstance(cell, P.nn.RNNCellBase)
        st = cell.get_initial_states(P.to_tensor(X[:, 0]), shape=[99],
                                     init_value=0.5)
        assert st.shape == [3, 6] and float(st.numpy()[0, 0]) == 0.5
        assert cell.state_shape == (6,)


def test_state_dict_keys_and_carry_both_ways():
    """The keys are weight_ih_l{k}[_reverse] and the rest; the port's
    weights load into the reference's layer too."""
    make = lambda P: P.nn.GRU(4, 6, num_layers=2, direction="bidirect")  # noqa: E731
    r, t = _pair(make)
    keys = list(t.state_dict())
    assert keys[:4] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                        "bias_hh_l0"]
    assert "weight_hh_l1_reverse" in keys and len(keys) == 16
    paddle.seed(5)
    t2 = make(paddle)
    ref.seed(6)
    r2 = make(ref)
    r2.set_state_dict({k: v.numpy() for k, v in t2.state_dict().items()})
    a = t2(paddle.to_tensor(X))[0].numpy()
    b = np.asarray(r2(ref.to_tensor(X))[0].numpy())
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    cells = [P.nn.LSTMCell(4, 6).state_dict() for P in (ref, paddle)]
    assert list(cells[0]) == list(cells[1]) == [
        "weight_ih", "weight_hh", "bias_ih", "bias_hh"]


def _dtypes(P, layer, x, level):
    with P.amp.auto_cast(level=level, dtype="bfloat16"):
        outs = _flat(layer(P.to_tensor(x)))
        loss = outs[0].sum()
    return [o.dtype.name for o in outs], loss.dtype.name, \
        [np.asarray(P.cast(o, "float32").numpy()) for o in outs]


AMP_LAYERS = dict(MODES, **{
    "SimpleRNNCell": lambda P, **kw: P.nn.SimpleRNNCell(4, 6),
    "LSTMCell": lambda P, **kw: P.nn.LSTMCell(4, 6),
    "GRUCell": lambda P, **kw: P.nn.GRUCell(4, 6),
    "RNN(SimpleRNNCell)": lambda P, **kw: P.nn.RNN(P.nn.SimpleRNNCell(4, 6)),
})


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", list(AMP_LAYERS))
def test_auto_cast_dtypes(name, level):
    """Every output's dtype under O1 and O2 is the reference's: the layer
    ops bf16 under O2 and f32 under O1; SimpleRNNCell's white-listed
    matmuls are bf16 under O1 too, its f32 biases promote the sums back to
    f32."""
    r, t = _pair(lambda P: AMP_LAYERS[name](P, num_layers=2))
    x = X if "Cell" not in name or "RNN(" in name else X[:, 0]
    (rd, rl, rv), (td, tl, tv) = (_dtypes(P, m, x, level)
                                  for P, m in ((ref, r), (paddle, t)))
    assert (td, tl) == (rd, rl)
    if name in MODES:
        assert set(td) == {"bfloat16" if level == "O2" else "float32"}
    for a, b in zip(tv, rv):
        np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL)


def test_dropout_between_layers():
    """Dropout runs between layers in training only: in eval the layer is
    the reference's; in training the port's mask comes from its
    generator (the same seed, the same output) and changes the output."""
    r, t = _pair(lambda P: P.nn.LSTM(4, 6, num_layers=2, dropout=0.5))
    r.eval()
    t.eval()
    np.testing.assert_allclose(t(paddle.to_tensor(X))[0].numpy(),
                               np.asarray(r(ref.to_tensor(X))[0].numpy()),
                               rtol=RTOL, atol=ATOL)
    evald = t(paddle.to_tensor(X))[0].numpy()
    t.train()
    runs = []
    for _ in range(2):
        paddle.seed(11)
        runs.append(t(paddle.to_tensor(X))[0].numpy())
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.allclose(runs[0], evald)


def test_reference_scenarios_nn_layers():
    """``tests/test_nn_layers.py``'s RNN scenarios on the port."""
    nn = paddle.nn
    x = paddle.to_tensor(np.random.RandomState(1).randn(2, 5, 4).astype(
        np.float32))
    y, (h, c) = nn.LSTM(4, 8)(x)
    assert y.shape == [2, 5, 8] and h.shape == [1, 2, 8] \
        and c.shape == [1, 2, 8]
    y, h = nn.GRU(4, 8, num_layers=2)(x)
    assert y.shape == [2, 5, 8] and h.shape == [2, 2, 8]
    y, (h, c) = nn.LSTM(4, 8, direction="bidirect")(x)
    assert y.shape == [2, 5, 16] and h.shape == [2, 2, 8]
    lstm = nn.LSTM(4, 8)
    y, _ = lstm(x)
    y.sum().backward()
    assert lstm.weight_ih_l0.grad is not None
    assert np.isfinite(lstm.weight_ih_l0.grad.numpy()).all()


def test_reference_scenarios_cell_wrappers():
    """``tests/test_api_round2.py``'s SimpleRNNCell / RNN / BiRNN /
    LSTMCell scenario on the port."""
    nn = paddle.nn
    paddle.seed(0)
    cell = nn.SimpleRNNCell(4, 8)
    y, h = cell(paddle.to_tensor(np.random.RandomState(0).randn(2, 4)
                                 .astype(np.float32)))
    assert y.shape == [2, 8]
    seq = paddle.to_tensor(np.random.RandomState(1).randn(2, 5, 4).astype(
        np.float32))
    out, last = nn.RNN(cell)(seq)
    assert out.shape == [2, 5, 8]
    np.testing.assert_allclose(out.numpy()[:, -1], last.numpy(), rtol=1e-6)
    out2, _ = nn.BiRNN(nn.SimpleRNNCell(4, 8), nn.SimpleRNNCell(4, 8))(seq)
    assert out2.shape == [2, 5, 16]
    out3, (h3, c3) = nn.RNN(nn.LSTMCell(4, 6))(seq)
    assert out3.shape == [2, 5, 6] and c3.shape == [2, 6]


def test_training_steps_match():
    """A 2-layer bidirectional LSTM under Adam, 3 steps from the same
    weights: every loss and the final weights."""
    r, t = _pair(lambda P: P.nn.LSTM(4, 6, num_layers=2,
                                     direction="bidirect"))
    losses = []
    for P, m in ((ref, r), (paddle, t)):
        opt = P.optimizer.Adam(1e-2, parameters=m.parameters())
        got = []
        for _ in range(3):
            y, _ = m(P.to_tensor(X))
            loss = (y * y).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            got.append(float(loss.numpy()))
        losses.append(got)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for a, b in zip(t.parameters(), r.parameters()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   rtol=1e-5, atol=1e-6)
