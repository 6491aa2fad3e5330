"""paddle_tpu_torch's sequence losses and beam search against the JAX
package's on the CPU.

* ``ctc_loss`` is optax's CTC (the reference's ``warpctc``), not torch's:
  unnormalised scores (log-softmaxed inside), an infeasible row at about
  1e5 (optax's log(0) is -1e5; ``F.ctc_loss`` gives inf), repeated
  labels, a blank other than 0, labels past their length, every
  reduction (``"mean"`` divides by the label length with no clamp), the
  grads, ``CTCLoss``, and the dtypes under ``auto_cast`` O1 and O2
  (``warpctc`` is on neither list: O2 log-softmaxes in bf16, the alphas
  are f64 as the reference's, which runs JAX with x64 on); the grads
  against the reference's ``warpctc`` op (its ``ctc_loss`` re-wraps the
  input, so no grad reaches it there); the reference's own scenario
  (``test_api_round2.py``).
* ``hsigmoid_loss`` over the default complete binary tree with a
  ``num_classes`` that is a power of two and one that is not, with and
  without a bias, its grads, its dtype under O1 and O2,
  ``HSigmoidLoss``, and the custom tree's raise.
* ``gather_tree``: the reference's scenario (``test_fluid_layers_round3``)
  and random parents.
* ``dynamic_decode`` with ``BeamSearchDecoder``: the ids of the
  reference on the same weights, ties ordered as ``lax.top_k`` orders them
  (lower index first; ``torch.topk`` does not), finished beams frozen on
  ``end_token``, and the reference's scenarios (``test_api_round2.py``).

f32 losses within rtol 1e-5 (grads 1e-4 of the largest, atol 1e-6); bf16
(O2) within 2e-2; ids exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _ctc_case(seed=0, blank=0, scale=3.0):
    """[T=12, B=4, C=6] unnormalised scores; row 1 repeats a label, row 2
    is infeasible (4 labels, 3 of them the same, in 4 steps), row 3's
    labels run past its length (padding values that are not labels)."""
    rs = np.random.RandomState(seed)
    lp = (rs.randn(12, 4, 6) * scale).astype(np.float32)
    labels = np.array([[1, 2, 3, 4, 5],
                       [2, 2, 3, 3, 1],
                       [4, 4, 4, 1, 0],
                       [3, 1, 99, -7, 2]], np.int32)
    if blank:
        labels = np.where(labels == blank, 0, labels)
    il = np.array([12, 10, 4, 7], np.int64)
    ll = np.array([5, 5, 4, 2], np.int64)
    return lp, labels, il, ll


def _ctc(P, lp, labels, il, ll, **kw):
    x = P.to_tensor(lp)
    x.stop_gradient = False
    out = P.nn.functional.ctc_loss(x, P.to_tensor(labels), P.to_tensor(il),
                                   P.to_tensor(ll), **kw)
    if P is ref:
        # the reference's ctc_loss re-wraps its input (no grads reach
        # it); its op warpctc, reduced as ctc_loss reduces, gives them
        per = ref.ops.nn_ops._ctc_op(x, P.to_tensor(labels),
                                     P.to_tensor(il), P.to_tensor(ll),
                                     blank=kw.get("blank", 0))
        if kw.get("reduction", "mean") == "mean":
            per = (per / ref.to_tensor(ll.astype(np.float64))).mean()
        per.sum().backward()
    else:
        out.sum().backward()
    return np.asarray(out.numpy()), np.asarray(x.grad.numpy())


@pytest.mark.parametrize("blank", [0, 3])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_ctc_loss_and_grads(reduction, blank):
    case = _ctc_case(blank=blank)
    (rv, rg), (tv, tg) = (_ctc(P, *case, blank=blank, reduction=reduction)
                          for P in (ref, paddle))
    np.testing.assert_allclose(tv, rv, rtol=1e-5)
    np.testing.assert_allclose(tg, rg, rtol=0, atol=1e-4 * np.abs(rg).max())
    if reduction == "none":
        assert 9.9e4 < tv[2] < 1.01e5          # the infeasible row


def test_ctc_is_not_torchs():
    """The trap: ``F.ctc_loss`` on the same scores gives inf on the
    infeasible row and other values on unnormalised input."""
    lp, labels, il, ll = _ctc_case()
    ours, _ = _ctc(paddle, lp, labels, il, ll, reduction="none")
    theirs = torch.nn.functional.ctc_loss(
        torch.from_numpy(lp), torch.from_numpy(np.clip(labels, 0, 5)).long(),
        torch.from_numpy(il), torch.from_numpy(ll), reduction="none")
    assert np.isinf(theirs[2].item()) and np.isfinite(ours).all()
    assert abs(theirs[0].item() - ours[0]) > 1.0


def test_ctc_layer_and_reference_scenario():
    """``CTCLoss`` and ``test_api_round2.py``'s case: the none reduction
    equals optax through the reference; the layer's mean is finite and
    positive."""
    rs = np.random.RandomState(0)
    lp = rs.randn(10, 2, 6).astype("float32")
    labels = rs.randint(1, 6, (2, 3)).astype("int32")
    il = np.asarray([10, 8], "int64")
    ll = np.asarray([3, 2], "int64")
    args = lambda P: (P.to_tensor(lp), P.to_tensor(labels),  # noqa: E731
                      P.to_tensor(il), P.to_tensor(ll))
    np.testing.assert_allclose(
        paddle.nn.functional.ctc_loss(*args(paddle), reduction="none")
        .numpy(), np.asarray(ref.nn.functional.ctc_loss(
            *args(ref), reduction="none").numpy()), rtol=1e-5)
    vals = [float(np.asarray(P.nn.CTCLoss()(*args(P)).numpy()))
            for P in (ref, paddle)]
    assert vals[1] > 0 and np.isfinite(vals[1])
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-5)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_ctc_auto_cast_dtype(reduction, level):
    lp, labels, il, ll = _ctc_case()
    got = []
    for P in (ref, paddle):
        with P.amp.auto_cast(level=level, dtype="bfloat16"):
            out = P.nn.functional.ctc_loss(
                P.to_tensor(lp), P.to_tensor(labels), P.to_tensor(il),
                P.to_tensor(ll), reduction=reduction)
        got.append((out.dtype.name,
                    np.asarray(P.cast(out, "float32").numpy())))
    assert got[1][0] == got[0][0]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=2e-2)


def _hsig(P, x, lab, w, b, classes):
    xt, wt = P.to_tensor(x), P.to_tensor(w)
    xt.stop_gradient = wt.stop_gradient = False
    bt = None
    if b is not None:
        bt = P.to_tensor(b)
        bt.stop_gradient = False
    out = P.nn.functional.hsigmoid_loss(xt, P.to_tensor(lab), classes, wt,
                                        bt)
    cot = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    (out * P.to_tensor(cot)).sum().backward()
    grads = [xt.grad, wt.grad] + ([bt.grad] if bt is not None else [])
    return [np.asarray(out.numpy())] + [np.asarray(g.numpy()) for g in grads]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("classes", [8, 11])
def test_hsigmoid_loss(classes, bias):
    rs = np.random.RandomState(classes)
    x = rs.randn(16, 5).astype(np.float32)
    lab = rs.randint(0, classes, (16,)).astype(np.int64)
    lab[:2] = [0, classes - 1]
    w = rs.randn(classes - 1, 5).astype(np.float32)
    b = rs.randn(classes - 1).astype(np.float32) if bias else None
    r, t = (_hsig(P, x, lab, w, b, classes) for P in (ref, paddle))
    assert t[0].shape == (16, 1)
    for a, c in zip(t, r):
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_hsigmoid_auto_cast_dtype(level):
    """``hsigmoid_op`` is on neither list: bf16 under O2, f32 under O1,
    as the reference's."""
    rs = np.random.RandomState(3)
    x = rs.randn(8, 5).astype(np.float32)
    lab = rs.randint(0, 11, (8,)).astype(np.int64)
    w = rs.randn(10, 5).astype(np.float32)
    b = rs.randn(10).astype(np.float32)
    got = []
    for P in (ref, paddle):
        with P.amp.auto_cast(level=level, dtype="bfloat16"):
            out = P.nn.functional.hsigmoid_loss(
                P.to_tensor(x), P.to_tensor(lab), 11, P.to_tensor(w),
                P.to_tensor(b))
        got.append((out.dtype.name,
                    np.asarray(P.cast(out, "float32").numpy())))
    assert got[1][0] == got[0][0] == ("bfloat16" if level == "O2"
                                      else "float32")
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=2e-2, atol=2e-2)


def test_hsigmoid_layer_and_custom_tree():
    ref.seed(0)
    r = ref.nn.HSigmoidLoss(5, 7)
    t = paddle.nn.HSigmoidLoss(5, 7)
    t.set_state_dict({k: np.asarray(v.numpy())
                      for k, v in r.state_dict().items()})
    rs = np.random.RandomState(2)
    x = rs.randn(6, 5).astype(np.float32)
    lab = rs.randint(0, 7, (6, 1)).astype(np.int64)
    np.testing.assert_allclose(
        t(paddle.to_tensor(x), paddle.to_tensor(lab)).numpy(),
        np.asarray(r(ref.to_tensor(x), ref.to_tensor(lab)).numpy()),
        rtol=1e-5)
    with pytest.raises(NotImplementedError):
        paddle.nn.functional.hsigmoid_loss(
            paddle.to_tensor(x), paddle.to_tensor(lab), 7, t.weight,
            path_table=paddle.to_tensor(lab))
    with pytest.raises(NotImplementedError):
        paddle.nn.HSigmoidLoss(5, 7, is_custom=True)


def test_gather_tree_reference_scenario():
    ids = np.asarray([[[2, 5]], [[3, 6]], [[4, 7]]], "int64")
    parents = np.asarray([[[0, 0]], [[0, 0]], [[1, 0]]], "int64")
    out = paddle.nn.functional.gather_tree(paddle.to_tensor(ids),
                                           paddle.to_tensor(parents)).numpy()
    assert list(out[:, 0, 0]) == [2, 6, 4]
    assert list(out[:, 0, 1]) == [2, 3, 7]


def test_gather_tree_random_parents():
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 50, (7, 3, 4)).astype("int64")
    parents = rs.randint(0, 4, (7, 3, 4)).astype("int64")
    np.testing.assert_array_equal(
        paddle.nn.functional.gather_tree(paddle.to_tensor(ids),
                                         paddle.to_tensor(parents)).numpy(),
        np.asarray(ref.nn.functional.gather_tree(
            ref.to_tensor(ids), ref.to_tensor(parents)).numpy()))


def _decoder(P, zero_head=False, hidden=8, vocab=5, beam=3, end=4):
    cell = P.nn.SimpleRNNCell(3, hidden)
    proj = P.nn.Linear(hidden, vocab)
    emb = P.nn.Embedding(vocab, 3)
    holder = P.nn.LayerList([cell, proj, emb])
    return holder, P.nn.BeamSearchDecoder(cell, start_token=0, end_token=end,
                                          beam_size=beam, embedding_fn=emb,
                                          output_fn=proj)


def _decode(P, holder, dec, batch, steps):
    inits = dec.cell.get_initial_states(P.to_tensor(
        np.zeros((batch, 3), "float32")))
    ids, _ = P.nn.dynamic_decode(dec, inits=inits, max_step_num=steps)
    return np.asarray(ids.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_search_ids_match(seed):
    ref.seed(seed)
    rh, rd = _decoder(ref, vocab=9, beam=3, end=2)
    th, td = _decoder(paddle, vocab=9, beam=3, end=2)
    th.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in rh.state_dict().items()})
    a, b = (_decode(P, h, d, 2, 8) for P, h, d in ((ref, rh, rd),
                                                     (paddle, th, td)))
    assert a.shape == b.shape == (2, 8, 3)
    np.testing.assert_array_equal(b, a)


def test_beam_search_ties_in_index_order():
    """A head of zeros: every candidate of a live beam ties, and the
    -1e9 beams tie among themselves; the ids are ``lax.top_k``'s (lower
    index first), which ``torch.topk`` does not give."""
    ref.seed(0)
    rh, rd = _decoder(ref, vocab=7, beam=4, end=6)
    th, td = _decoder(paddle, vocab=7, beam=4, end=6)
    zeroed = {k: np.zeros_like(np.asarray(v.numpy())) if k.startswith("1.")
              else np.asarray(v.numpy()) for k, v in rh.state_dict().items()}
    rh.set_state_dict(zeroed)
    th.set_state_dict(zeroed)
    a, b = (_decode(P, h, d, 2, 5) for P, h, d in ((ref, rh, rd),
                                                     (paddle, th, td)))
    np.testing.assert_array_equal(b, a)
    row = [0.0, -1e9, -1e9, -1e9, -1e9, 1.0, 1.0]
    assert torch.topk(torch.tensor(row), 4).indices.tolist() != [5, 6, 0, 1]
    assert paddle.topk(paddle.to_tensor(row), 4)[1].numpy().tolist() == \
        [5, 6, 0, 1]


def test_beam_search_reference_scenarios():
    """``test_api_round2.py``'s decodes on the port: shapes and range, the
    beams diverge, a finished beam only re-emits end_token."""
    paddle.seed(0)
    _, dec = _decoder(paddle, beam=2)
    v = _decode(paddle, None, dec, 3, 6)
    assert v.shape == (3, 6, 2) and v.min() >= 0 and v.max() < 5
    paddle.seed(0)
    _, dec = _decoder(paddle, beam=3)
    v = _decode(paddle, None, dec, 2, 8)
    assert not (np.array_equal(v[:, :, 0], v[:, :, 1])
                and np.array_equal(v[:, :, 1], v[:, :, 2])), v
    for bi in range(v.shape[0]):
        for k in range(v.shape[2]):
            hits = np.nonzero(v[bi, :, k] == 4)[0]
            if len(hits):
                assert np.all(v[bi, hits[0]:, k] == 4)


def test_dynamic_decode_flat_lstm_states():
    """A cell with a flat tuple of [B, H] states (two LSTM layers' h, c),
    as the encoder-decoder's: ids and final states equal the
    reference's."""
    got = []
    ref.seed(4)
    for P in (ref, paddle):
        class Cell(P.nn.RNNCellBase):
            def __init__(self):
                super().__init__()
                self.hidden_size = 6
                self.cells = P.nn.LayerList([P.nn.LSTMCell(6, 6),
                                             P.nn.LSTMCell(6, 6)])

            def forward(self, x, states):
                new = []
                for i, c in enumerate(self.cells):
                    x, (h, cc) = c(x, (states[2 * i], states[2 * i + 1]))
                    new += [h, cc]
                return x, tuple(new)
        holder = P.nn.LayerList([Cell(), P.nn.Embedding(11, 6),
                                 P.nn.Linear(6, 11)])
        got.append((P, holder))
    (_, rh), (_, th) = got
    th.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in rh.state_dict().items()})
    rs = np.random.RandomState(8)
    init = [rs.randn(3, 6).astype(np.float32) for _ in range(4)]
    outs = []
    for P, h in ((ref, rh), (paddle, th)):
        dec = P.nn.BeamSearchDecoder(h[0], 0, 1, 4, embedding_fn=h[1],
                                     output_fn=h[2])
        ids, st = P.nn.dynamic_decode(
            dec, inits=tuple(P.to_tensor(a) for a in init), max_step_num=6)
        outs.append((np.asarray(ids.numpy()),
                     [np.asarray(s.numpy()) for s in st]))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    for a, b in zip(outs[1][1], outs[0][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("largest", [True, False])
def test_topk_ties_in_index_order(largest):
    """``paddle.topk`` (and ``metric.accuracy`` over it) orders tied values
    as ``lax.top_k`` does, lower index first, largest and smallest."""
    rs = np.random.RandomState(6)
    x = rs.randint(0, 3, (5, 9)).astype(np.float32)
    got = [[np.asarray(a.numpy()) for a in P.topk(P.to_tensor(x), 4, axis=1,
                                                   largest=largest)]
           for P in (ref, paddle)]
    for a, b in zip(got[1], got[0]):
        np.testing.assert_array_equal(a, b)
    label = rs.randint(0, 9, (5, 1)).astype(np.int64)
    accs = [float(np.asarray(P.metric.accuracy(P.to_tensor(x),
                                               P.to_tensor(label),
                                               k=2).numpy()))
            for P in (ref, paddle)]
    assert accs[1] == accs[0]
