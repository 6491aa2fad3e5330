"""paddle_tpu_torch's sparse (SelectedRows) embedding grads against the
JAX package's on the CPU.

``tests/test_sparse_grad.py`` whole on the port, but for
``test_sparse_embedding_in_to_static_falls_back_dense`` (the port has
no ``jit`` yet): where the reference checks that a grad was never made
dense (``g._value is None``), the port checks ``g.is_sparse()``, and
its optimizer state is torch tensors. Then the port against the
reference on the same weights and ids: SGD, Momentum, Adam and AdamW
(lazy and not, with coupled and decoupled decay) over 3 steps whose
rows differ, and ``ClipGradByGlobalNorm`` over a sparse and a dense
grad; and in the port, each sparse step against the dense step of the
same optimizer where the reference says they agree. f32, rtol 1e-5 /
atol 1e-6 (the same f32 expressions, summed in other orders where rows
repeat).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu.core.sparse_grad import IndexedSlices as RefSlices
from paddle_tpu_torch.core.sparse_grad import IndexedSlices, SparseGradTensor

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _ids(vals, P=paddle):
    return P.to_tensor(np.asarray(vals, dtype="int64"))


# --------------------------------------- tests/test_sparse_grad.py, ported

def test_sparse_embedding_grad_is_indexed_slices():
    paddle.seed(0)
    emb = nn.Embedding(10, 4, sparse=True)
    out = emb(_ids([1, 3, 3, 7]))
    out.sum().backward()
    g = emb.weight.grad
    assert isinstance(g, SparseGradTensor) and g.is_sparse()
    assert g.slices.full_shape == (10, 4)
    assert int(g.slices.indices.shape[0]) == 4
    dense = g.slices.to_dense().numpy()
    expect = np.zeros((10, 4), np.float32)
    for i in [1, 3, 3, 7]:
        expect[i] += 1.0
    np.testing.assert_allclose(dense, expect, rtol=1e-6)
    # reading the value densifies for consumers that do not know slices
    np.testing.assert_allclose(g.numpy(), expect, rtol=1e-6)
    assert not g.is_sparse()


def test_sparse_grad_accumulates_sparsely():
    paddle.seed(0)
    emb = nn.Embedding(10, 4, sparse=True)
    for ids in ([0, 2], [2, 5]):
        emb(_ids(ids)).sum().backward()
    g = emb.weight.grad
    assert g.is_sparse()
    assert int(g.slices.indices.shape[0]) == 4  # merged, not densified
    expect = np.zeros((10, 4), np.float32)
    for i in [0, 2, 2, 5]:
        expect[i] += 1.0
    np.testing.assert_allclose(g.slices.to_dense().numpy(), expect,
                               rtol=1e-6)


def test_coalesce_sums_duplicates():
    sl = IndexedSlices(torch.tensor([3, 1, 3]),
                       torch.tensor([[1.0], [2.0], [10.0]]), (5, 1))
    co = sl.coalesce()
    np.testing.assert_array_equal(co.indices.numpy(), [1, 3])
    np.testing.assert_allclose(co.values.numpy(), [[2.0], [11.0]])
    assert co.coalesced and co.coalesce() is co
    want = RefSlices(
        np.asarray([3, 1, 3]), np.asarray([[1.0], [2.0], [10.0]],
                                          np.float32), (5, 1)).coalesce()
    np.testing.assert_array_equal(np.asarray(want.indices), co.indices)
    np.testing.assert_allclose(np.asarray(want.values), co.values)
    np.testing.assert_allclose(co.to_dense().numpy(),
                               np.asarray(want.to_dense()))
    assert sl.merge(sl).indices.shape[0] == 6
    assert sl.scale(2.0).values[2, 0] == 20.0
    assert sl.nbytes == 3 * 8 + 3 * 4


@pytest.mark.parametrize("opt_cls,kw", [
    (paddle.optimizer.SGD, {}),
    (paddle.optimizer.Momentum, {"momentum": 0.9}),
    (paddle.optimizer.Adam, {}),
    (paddle.optimizer.AdamW, {"weight_decay": 0.01}),
])
def test_sparse_step_matches_dense(opt_cls, kw):
    # when every row is touched, lazy sparse updates == dense updates
    def run(sparse):
        paddle.seed(0)
        emb = nn.Embedding(6, 4, sparse=sparse)
        opt = opt_cls(0.1, parameters=emb.parameters(), **kw)
        x = _ids([0, 1, 2, 3, 4, 5])
        for _ in range(3):
            loss = (emb(x) ** 2).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
        return emb.weight.numpy()

    np.testing.assert_allclose(run(True), run(False), rtol=2e-5, atol=2e-6)


def test_sparse_clip_global_norm_matches_dense():
    def run(sparse):
        paddle.seed(0)
        emb = nn.Embedding(6, 4, sparse=sparse)
        fc = nn.Linear(4, 2)
        params = emb.parameters() + fc.parameters()
        opt = paddle.optimizer.SGD(
            0.1, parameters=params,
            grad_clip=nn.ClipGradByGlobalNorm(0.05))
        loss = (fc(emb(_ids([1, 1, 4]))) ** 2).sum()
        loss.backward()
        opt.step()
        return emb.weight.numpy(), fc.weight.numpy()

    w_s, f_s = run(True)
    w_d, f_d = run(False)
    np.testing.assert_allclose(w_s, w_d, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(f_s, f_d, rtol=2e-5, atol=2e-6)


def test_million_vocab_trains_without_dense_grad():
    vocab, dim = 1_000_000, 16
    paddle.seed(0)
    emb = nn.Embedding(vocab, dim, sparse=True)
    opt = paddle.optimizer.Adam(0.01, parameters=emb.parameters())
    x = _ids([5, 123456, 999999, 123456])
    w_before = emb.weight.numpy()[[5, 0]]
    emb(x).sum().backward()
    g = emb.weight.grad
    assert g.is_sparse()
    dense_bytes = vocab * dim * 4
    assert g.slices.nbytes < dense_bytes / 1000, (
        f"sparse grad holds {g.slices.nbytes}B — not sparse")
    assert emb.weight.value.grad.is_sparse
    opt.step()
    opt.clear_grad()
    # the grad was consumed without ever being made dense
    assert g.is_sparse()
    w_after = emb.weight.numpy()[[5, 0]]
    assert not np.allclose(w_after[0], w_before[0])  # touched row moved
    np.testing.assert_allclose(w_after[1], w_before[1])  # untouched row
    m = next(iter(opt._accumulators["moment1"].values()))
    m_rows = m[[5, 0]].numpy()
    assert np.abs(m_rows[0]).max() > 0
    assert np.abs(m_rows[1]).max() == 0


def test_padding_idx_rows_get_no_sparse_grad():
    paddle.seed(0)
    emb = nn.Embedding(10, 4, sparse=True, padding_idx=2)
    out = emb(_ids([1, 2, 2, 3]))
    out.sum().backward()
    dense = emb.weight.grad.slices.to_dense().numpy()
    assert np.abs(dense[2]).max() == 0  # padding row untouched
    assert np.abs(dense[1]).max() > 0
    np.testing.assert_array_equal(out.numpy()[1:3], 0.0)


def test_adam_nonlazy_matches_dense_on_partial_rows():
    def run(sparse):
        paddle.seed(0)
        emb = nn.Embedding(6, 4, sparse=sparse)
        opt = paddle.optimizer.Adam(0.1, parameters=emb.parameters())
        for ids in ([0, 1, 2], [3, 4], [0, 5]):  # different rows per step
            loss = (emb(_ids(ids)) ** 2).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
        return emb.weight.numpy()

    np.testing.assert_allclose(run(True), run(False), rtol=2e-5, atol=2e-6)


def test_adam_lazy_mode_only_touches_rows():
    paddle.seed(0)
    emb = nn.Embedding(6, 4, sparse=True)
    opt = paddle.optimizer.Adam(0.1, parameters=emb.parameters(),
                                lazy_mode=True)
    loss = (emb(_ids([0, 1, 2])) ** 2).sum()
    loss.backward()
    opt.step()
    opt.clear_grad()
    w1 = emb.weight.numpy()
    loss = (emb(_ids([3, 4])) ** 2).sum()
    loss.backward()
    opt.step()
    opt.clear_grad()
    w2 = emb.weight.numpy()
    np.testing.assert_array_equal(w2[:3], w1[:3])
    assert not np.allclose(w2[3:5], w1[3:5])


def test_clip_does_not_mutate_sparse_param_grad():
    paddle.seed(0)
    emb = nn.Embedding(6, 4, sparse=True)
    clip = nn.ClipGradByGlobalNorm(1e-3)
    loss = (emb(_ids([1, 1, 2])) * 100.0).sum()
    loss.backward()
    g = emb.weight.grad
    before = g.slices.to_dense().numpy()
    out = clip([(emb.weight, g)])
    np.testing.assert_array_equal(g.slices.to_dense().numpy(), before)
    np.testing.assert_array_equal(emb.weight.grad.numpy(), before)
    clipped = out[0][1]
    assert clipped is not g and clipped.is_sparse()
    assert np.abs(clipped.slices.values.numpy()).sum() \
        < np.abs(before).sum()


def test_sparse_grad_dtype_accessor():
    paddle.seed(0)
    emb = nn.Embedding(6, 4, sparse=True)
    emb(_ids([1])).sum().backward()
    g = emb.weight.grad
    assert g.is_sparse()
    assert "float32" in str(g.dtype)
    assert g.shape == [6, 4]
    assert g.is_sparse()  # reading dtype and shape must not densify


# ------------------------------------- the port against the reference

def _pair(vocab, dim, sparse, seed=3, padding_idx=None):
    """The reference's sparse embedding and the port's with its
    weights."""
    ref.seed(seed)
    r = ref.nn.Embedding(vocab, dim, sparse=sparse, padding_idx=padding_idx)
    t = nn.Embedding(vocab, dim, sparse=sparse, padding_idx=padding_idx)
    t.set_state_dict({k: v.numpy() for k, v in r.state_dict().items()})
    return r, t


OPTS = [
    ("SGD", {}), ("SGD", {"weight_decay": 0.05}),
    ("Momentum", {"momentum": 0.9}),
    ("Momentum", {"momentum": 0.9, "use_nesterov": True,
                  "weight_decay": 0.05}),
    ("Adam", {}), ("Adam", {"lazy_mode": True}),
    ("Adam", {"weight_decay": 0.05}),
    ("Adam", {"weight_decay": 0.05, "lazy_mode": True}),
    ("AdamW", {"weight_decay": 0.05}),
    ("AdamW", {"weight_decay": 0.05, "lazy_mode": True}),
    ("Adamax", {}),
]


@pytest.mark.parametrize("name,kw", OPTS,
                         ids=[f"{n}-{sorted(k.items())}" for n, k in OPTS])
def test_sparse_steps_match_reference(name, kw):
    r, t = _pair(12, 5, True)
    ro = getattr(ref.optimizer, name)(0.1, parameters=r.parameters(), **kw)
    to = getattr(paddle.optimizer, name)(0.1, parameters=t.parameters(),
                                         **kw)
    rs = np.random.RandomState(0)
    for ids in ([0, 3, 3, 7], [2, 7, 11], [3, 0, 0, 9, 10]):
        w = rs.randn(len(ids), 5).astype("float32")
        for P, emb, opt in ((ref, r, ro), (paddle, t, to)):
            loss = P.sum(emb(_ids(ids, P)) ** 2 * P.to_tensor(w))
            loss.backward()
            g = emb.weight.grad
            assert g.is_sparse()
            opt.step()
            opt.clear_grad()
        np.testing.assert_allclose(t.weight.numpy(), r.weight.numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,kw", [
    ("SGD", {"weight_decay": 0.05}), ("Momentum", {"momentum": 0.9}),
    ("Adam", {}), ("Adam", {"weight_decay": 0.05}),
    ("AdamW", {"weight_decay": 0.05})])
def test_dense_equivalent_sparse_steps_match_dense_steps(name, kw):
    """Momentum and Adam/AdamW without lazy_mode move every row as the
    dense step does, rows absent from the batch included; SGD when
    every row is looked up."""
    every = name == "SGD"
    runs = []
    for sparse in (True, False):
        _, t = _pair(8, 3, sparse)
        opt = getattr(paddle.optimizer, name)(
            0.1, parameters=t.parameters(), **kw)
        for ids in ([0, 1, 2], [3, 4, 4], [0, 5, 7]):
            if every:
                ids = ids + [i for i in range(8) if i not in ids]
            (t(_ids(ids)) ** 2).sum().backward()
            opt.step()
            opt.clear_grad()
        runs.append(t.weight.numpy())
    np.testing.assert_allclose(runs[0], runs[1], rtol=RTOL, atol=ATOL)


def test_sparse_global_norm_clip_matches_reference():
    outs = []
    r_emb, t_emb = _pair(9, 4, True)
    ref.seed(1)
    r_fc = ref.nn.Linear(4, 3)
    t_fc = nn.Linear(4, 3)
    t_fc.set_state_dict({k: v.numpy() for k, v in r_fc.state_dict().items()})
    for P, emb, fc in ((ref, r_emb, r_fc), (paddle, t_emb, t_fc)):
        opt = P.optimizer.SGD(0.5, parameters=emb.parameters()
                              + fc.parameters(),
                              grad_clip=P.nn.ClipGradByGlobalNorm(0.05))
        loss = P.sum(fc(emb(_ids([1, 1, 4, 8], P))) ** 2)
        loss.backward()
        clipped = P.nn.ClipGradByGlobalNorm(0.05)(
            [(emb.weight, emb.weight.grad), (fc.weight, fc.weight.grad)])
        opt.step()
        outs.append((np.asarray(clipped[0][1].slices.to_dense()),
                     clipped[1][1].numpy(), emb.weight.numpy(),
                     fc.weight.numpy()))
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
