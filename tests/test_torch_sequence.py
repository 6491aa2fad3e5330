"""paddle_tpu_torch's LoD tensors, padded sequence ops and linear-chain
CRF against the JAX package's on the CPU: ``tests/test_lod_tensor.py``'s
and ``tests/test_sequence_ops.py``'s scenarios run on both packages with
the results compared, and the CRF (``test_fluid_layers_round3.py``'s
training scenario, the NLL and its grads against the reference, steps
past each length, a clipped last index, planted ties in the Viterbi
path, ``crf_decoding``'s zeros past each length); the dtypes of
``sequence_pool``, ``sequence_softmax`` and ``linear_chain_crf`` under
``auto_cast`` O1 and O2 (on neither list: bf16 under O2).

f32 values within rtol 1e-5 / atol 1e-6, grads within 1e-4; paths and
integer results exactly; bf16 within 2e-2.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu.core import lod as rlod
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import lod as tlod


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


BOTH = [(ref, rlod), (paddle, tlod)]


def _lod(L):
    data = np.arange(12, dtype="float32").reshape(6, 2)
    return L.create_lod_tensor(data, [[2, 3, 1]])


def test_create_and_metadata():
    for P, L in BOTH:
        t = _lod(L)
        assert isinstance(t, L.LoDTensor) and isinstance(t, P.Tensor)
        assert t.lod() == [[0, 2, 5, 6]]
        assert t.recursive_sequence_lengths() == [[2, 3, 1]]
        assert t.has_valid_recursive_sequence_lengths()
        assert t.nseq() == 3
        np.testing.assert_array_equal(t.lengths(), [2, 3, 1])
        np.testing.assert_array_equal(t.segment_ids(), [0, 0, 1, 1, 1, 2])
    np.random.seed(3)
    a = rlod.create_random_int_lodtensor([[2, 2]], [3], low=0, high=9)
    np.random.seed(3)
    b = tlod.create_random_int_lodtensor([[2, 2]], [3], low=0, high=9)
    assert b.lod() == a.lod() == [[0, 2, 4]] and b.shape == [4, 3]
    np.testing.assert_array_equal(b.numpy(), np.asarray(a.numpy()))


def test_invalid_lod_rejected_and_state_kept():
    data = np.ones((4, 1), "float32")
    for match, lod in (("start at 0", [[1, 4]]),
                       ("non-decreasing", [[0, 3, 2, 4]]),
                       ("rows", [[0, 2, 3]])):
        with pytest.raises(ValueError, match=match):
            tlod.LoDTensor(data, lod=lod)
    t = tlod.LoDTensor(data, lod=[[0, 2, 4]])
    with pytest.raises(ValueError):
        t.set_lod([[0, 3, 2, 4]])
    assert t.lod() == [[0, 2, 4]]
    assert t.has_valid_recursive_sequence_lengths()


def test_multilevel_lod():
    data = np.arange(5, dtype="float32").reshape(5, 1)
    t = tlod.create_lod_tensor(data, [[2, 1], [2, 1, 2]])
    assert t.lod() == [[0, 2, 3], [0, 2, 3, 5]]
    assert t.recursive_sequence_lengths() == [[2, 1], [2, 1, 2]]


def test_to_padded_and_sequence_list():
    (rp, rl), (tp, tl) = (_lod(L).to_padded(pad_value=-1.0) for _, L in BOTH)
    assert tp.shape == [3, 3, 2]
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp.numpy()))
    np.testing.assert_array_equal(tl.numpy(), [2, 3, 1])
    seqs = _lod(tlod).sequence_list()
    assert [len(s) for s in seqs] == [2, 3, 1]
    np.testing.assert_allclose(seqs[1], [[4, 5], [6, 7], [8, 9]])


@pytest.mark.parametrize("pool", ["SUM", "AVERAGE", "MAX", "MIN", "FIRST",
                                  "LAST"])
def test_lod_sequence_pool(pool):
    (a, b) = (np.asarray(L.lod_sequence_pool(_lod(L), pool).numpy())
              for _, L in BOTH)
    np.testing.assert_allclose(b, a, rtol=1e-6)
    data = np.arange(8, dtype="float32").reshape(4, 2)
    empty = [np.asarray(L.lod_sequence_pool(
        L.LoDTensor(data, lod=[[0, 2, 2, 4]]), pool).numpy())
        for _, L in BOTH]
    np.testing.assert_array_equal(empty[1], empty[0])


def test_lod_sequence_expand_and_dense_ops():
    outs = []
    for P, L in BOTH:
        x = P.to_tensor(np.asarray([[10.0], [20.0], [30.0]], "float32"))
        out = L.lod_sequence_expand(x, _lod(L))
        assert isinstance(out, L.LoDTensor) and out.lod() == [[0, 2, 5, 6]]
        outs.append(np.asarray(out.numpy()))
    np.testing.assert_array_equal(outs[1], outs[0])
    t = _lod(tlod)
    np.testing.assert_allclose((t * 2.0).numpy(), 2 * t.numpy())


def _ragged():
    rs = np.random.RandomState(4)
    return [rs.randn(n, 3).astype("float32") for n in (2, 4, 1)]


def test_sequence_pad_unpad():
    F = paddle.nn.functional
    seqs = _ragged()
    padded, lens = F.sequence_pad(seqs, pad_value=0.0)
    rp, rl = ref.nn.functional.sequence_pad(seqs, pad_value=0.0)
    assert padded.shape == [3, 4, 3] and lens.numpy().tolist() == [2, 4, 1]
    np.testing.assert_array_equal(padded.numpy(), np.asarray(rp.numpy()))
    for a, b in zip(seqs, F.sequence_unpad(padded, lens)):
        np.testing.assert_array_equal(a, b.numpy())
    p, ln = F.sequence_pad([np.arange(5, dtype="float32"),
                            np.arange(2, dtype="float32")], maxlen=3)
    assert p.shape == [2, 3] and ln.numpy().tolist() == [3, 2]
    np.testing.assert_allclose(
        F.sequence_pool(p, ln, pool_type="last").numpy(), [2.0, 1.0])


def _grads(P, fn, arrays):
    x = P.to_tensor(arrays[0])
    x.stop_gradient = False
    out = fn(P, x, *[P.to_tensor(a) for a in arrays[1:]])
    cot = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    (out * P.to_tensor(cot)).sum().backward()
    return np.asarray(out.numpy()), np.asarray(x.grad.numpy())


@pytest.mark.parametrize("pool", ["SUM", "AVERAGE", "SQRT", "MAX", "LAST",
                                  "FIRST"])
def test_sequence_pool(pool):
    seqs = _ragged()
    padded, lens = ref.nn.functional.sequence_pad(seqs, pad_value=7.0)
    arrays = [np.asarray(padded.numpy()), np.asarray(lens.numpy())]
    (rv, rg), (tv, tg) = (_grads(P, lambda P, x, n: P.nn.functional
                                 .sequence_pool(x, n, pool), arrays)
                          for P in (ref, paddle))
    np.testing.assert_allclose(tv, rv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg, rg, rtol=1e-4, atol=1e-6)


def test_sequence_softmax_expand_reverse():
    seqs = _ragged()
    padded, lens = ref.nn.functional.sequence_pad(seqs, pad_value=99.0)
    arrays = [np.asarray(padded.numpy()), np.asarray(lens.numpy())]
    (rv, rg), (tv, tg) = (_grads(P, lambda P, x, n: P.nn.functional
                                 .sequence_softmax(x, n), arrays)
                          for P in (ref, paddle))
    np.testing.assert_allclose(tv, rv, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tg, rg, rtol=1e-4, atol=1e-6)
    assert np.all(tv[0, 2:] == 0)
    x = np.arange(6, dtype="float32").reshape(3, 2)
    for P in (ref, paddle):
        out = P.nn.functional.sequence_expand(P.to_tensor(x),
                                              np.array([2, 0, 3]))
        np.testing.assert_array_equal(np.asarray(out.numpy()), np.array(
            [[0, 1], [0, 1], [4, 5], [4, 5], [4, 5]], "float32"))
    rev = [np.asarray(P.nn.functional.sequence_reverse(
        P.to_tensor(arrays[0]), P.to_tensor(arrays[1])).numpy())
        for P in (ref, paddle)]
    np.testing.assert_array_equal(rev[1], rev[0])
    for i, s in enumerate(seqs):
        np.testing.assert_array_equal(rev[1][i, :len(s)], s[::-1])


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_sequence_ops_auto_cast_dtype(level):
    seqs = _ragged()
    padded, lens = ref.nn.functional.sequence_pad(seqs)
    x, n = np.asarray(padded.numpy()), np.asarray(lens.numpy())
    em, trans, lab, ln = _crf_case()
    got = []
    for P in (ref, paddle):
        from_p = P.ops.sequence if P is paddle else ref.ops.sequence
        with P.amp.auto_cast(level=level, dtype="bfloat16"):
            outs = [P.nn.functional.sequence_pool(P.to_tensor(x),
                                                  P.to_tensor(n), "SUM"),
                    P.nn.functional.sequence_softmax(P.to_tensor(x),
                                                     P.to_tensor(n)),
                    from_p.linear_chain_crf(P.to_tensor(em),
                                            P.to_tensor(trans),
                                            P.to_tensor(lab),
                                            P.to_tensor(ln))]
        got.append([(o.dtype.name, np.asarray(P.cast(o, "float32").numpy()))
                    for o in outs])
    for (td, tv), (rd, rv) in zip(got[1], got[0]):
        assert td == rd
        np.testing.assert_allclose(tv, rv, rtol=2e-2, atol=2e-2)


def _crf_case(seed=0, b=5, t=7, c=4):
    rs = np.random.RandomState(seed)
    em = rs.randn(b, t, c).astype(np.float32)
    trans = rs.randn(c + 2, c).astype(np.float32)
    lab = rs.randint(0, c, (b, t)).astype(np.int64)
    ln = np.array([7, 3, 1, 5, 0][:b], np.int64)   # a 0 clips last_idx
    return em, trans, lab, ln


def test_linear_chain_crf_nll_and_grads():
    em, trans, lab, ln = _crf_case()
    got = []
    for P in (ref, paddle):
        e, tr = P.to_tensor(em), P.to_tensor(trans)
        e.stop_gradient = tr.stop_gradient = False
        nll = P.ops.sequence.linear_chain_crf(e, tr, P.to_tensor(lab),
                                              P.to_tensor(ln))
        nll.sum().backward()
        got.append([np.asarray(a.numpy()) for a in (nll, e.grad, tr.grad)])
    assert got[1][0].shape == (5, 1)
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(got[1][1:], got[0][1:]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_crf_decoding_with_planted_ties():
    """Integer emissions and transitions make many paths tie; the path
    takes the first maximum at every step, as jnp.argmax, and 0 past each
    length."""
    rs = np.random.RandomState(2)
    em = rs.randint(0, 2, (6, 8, 3)).astype(np.float32)
    trans = rs.randint(0, 2, (5, 3)).astype(np.float32)
    ln = np.array([8, 5, 1, 3, 8, 2], np.int64)
    paths = [np.asarray(P.ops.sequence.crf_decoding(
        P.to_tensor(em), P.to_tensor(trans), P.to_tensor(ln)).numpy())
        for P in (ref, paddle)]
    np.testing.assert_array_equal(paths[1], paths[0])
    assert np.all(paths[1][2, 1:] == 0) and np.all(paths[1][5, 2:] == 0)
    em2, trans2, _, ln2 = _crf_case(seed=3)
    paths = [np.asarray(P.ops.sequence.crf_decoding(
        P.to_tensor(em2), P.to_tensor(trans2), P.to_tensor(ln2)).numpy())
        for P in (ref, paddle)]
    np.testing.assert_array_equal(paths[1], paths[0])


def test_crf_learns_and_decodes():
    """``test_fluid_layers_round3.py``'s scenario on the port's ops: SGD on
    the transition lowers the NLL and Viterbi recovers the gold tags; each
    step's NLL is the reference's."""
    rs = np.random.RandomState(5)
    B, T, C = 4, 6, 3
    gold = rs.randint(0, C, (B, T)).astype("int64")
    em_np = np.full((B, T, C), -1.0, np.float32)
    for b in range(B):
        for t in range(T):
            em_np[b, t, gold[b, t]] = 1.0
    init = np.random.RandomState(1).randn(C + 2, C).astype(np.float32) * 0.1
    curves, decs = [], []
    for P in (ref, paddle):
        trans = P.create_parameter([C + 2, C], "float32")
        trans.set_value(init)
        opt = P.optimizer.SGD(0.5, parameters=[trans])
        ln = P.to_tensor(np.full(B, T, "int64"))
        curve = []
        for _ in range(10):
            nll = P.ops.sequence.linear_chain_crf(
                P.to_tensor(em_np), trans, P.to_tensor(gold), ln)
            loss = nll.mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            curve.append(float(np.asarray(loss.numpy())))
        curves.append(curve)
        decs.append(np.asarray(P.ops.sequence.crf_decoding(
            P.to_tensor(em_np), trans, ln).numpy()))
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-5)
    assert curves[1][-1] < curves[1][0]
    assert (decs[1] == gold).mean() > 0.9
    np.testing.assert_array_equal(decs[1], decs[0])
