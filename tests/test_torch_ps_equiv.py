"""The port's fleet datasets and distributed / host embeddings against
the reference's (tests/test_ps_equiv.py's scenarios through both
packages): InMemoryDataset and QueueDataset batches on the same slot file
(native and pure-Python parsers), the global shuffle a permutation,
HostEmbeddingTable's pull, push (SGD, Adagrad), sparse push, save/load
(the files read across the packages both ways), HostEmbedding trained
end to end against the reference's layer, and DistributedEmbedding over
two gloo ranks at mp = 2 (tests/torch_dist_worker.py, suite ``emb``,
about 6 s) against the whole table's lookup. Tolerances f32: rtol 1e-6;
batches and tables exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import native as ref_native
from paddle_tpu.distributed.fleet import dataset as ref_ds
from paddle_tpu.distributed.fleet import distributed_embedding as ref_emb

from _torch_dist import run_ranks
from paddle_tpu_torch.distributed.fleet import dataset as port_ds
from paddle_tpu_torch.distributed.fleet import distributed_embedding as emb


@pytest.fixture
def slot_file(tmp_path):
    """6 samples: slot 0 a dense label, slot 1 ragged sparse ids."""
    lines = []
    for i in range(6):
        ids = " ".join(str((i + j) % 10) for j in range(1 + i % 3))
        lines.append(f"1 {i % 2} {1 + i % 3} {ids}")
    p = tmp_path / "part-0.txt"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _batches(mod, kind, slot_file, bs=2):
    ds = getattr(mod, kind)()
    ds.init(batch_size=bs, thread_num=2)
    ds.set_filelist([slot_file])
    if kind == "InMemoryDataset":
        ds.load_into_memory()
    return ds, list(ds)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            if isinstance(u, tuple):
                for uu, vv in zip(u, v):
                    np.testing.assert_array_equal(uu, vv)
            else:
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("kind", ["InMemoryDataset", "QueueDataset"])
def test_dataset_batches_match_reference(slot_file, kind):
    _, ref = _batches(ref_ds, kind, slot_file)
    _, mine = _batches(port_ds, kind, slot_file)
    assert len(mine) == 3
    _same(mine, ref)


def test_pure_python_parser_matches_native(slot_file):
    from paddle_tpu_torch.core import native
    text = open(slot_file).read()
    py = port_ds._py_parse_multislot(text, 2)
    ref_py = ref_ds._py_parse_multislot(text, 2)
    for (v, o), (rv, ro) in zip(py, ref_py):
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(o, ro)
    if native.available() and ref_native.available():
        for (v, o), (nv, no) in zip(py, native.parse_multislot(text, 2, 2)):
            np.testing.assert_array_equal(v, nv)
            np.testing.assert_array_equal(o, no)


def test_global_shuffle_in_memory_is_a_permutation(slot_file):
    np.random.seed(0)
    ds, before = _batches(port_ds, "InMemoryDataset", slot_file, bs=6)
    ds.global_shuffle()
    after = list(ds)
    assert sorted(before[0][0].ravel()) == sorted(after[0][0].ravel())
    assert ds.get_memory_data_size() == 6


def test_host_table_pull_push_matches_reference():
    for opt in ("sgd", "adagrad"):
        ref = ref_emb.HostEmbeddingTable(50, 4, init_std=0.1, seed=1,
                                         optimizer=opt)
        mine = emb.HostEmbeddingTable(50, 4, init_std=0.1, seed=1,
                                      optimizer=opt, device="cpu")
        np.testing.assert_array_equal(mine.table, ref.table)
        ids = np.array([3, 7, 3])
        g = np.random.RandomState(2).randn(3, 4).astype(np.float32)
        ref.push(ids, g, lr=0.5)
        mine.push(torch.from_numpy(ids), torch.from_numpy(g), lr=0.5)
        np.testing.assert_allclose(mine.table, ref.table, rtol=1e-6)
        np.testing.assert_array_equal(
            mine.pull(torch.tensor([[3, 7]])).numpy(),
            np.asarray(ref.pull(np.array([[3, 7]])).numpy()))


def test_host_table_push_sparse_merges_duplicates():
    from paddle_tpu.core.sparse_grad import IndexedSlices
    ref = ref_emb.HostEmbeddingTable(10, 3, seed=1)
    mine = emb.HostEmbeddingTable(10, 3, seed=1, device="cpu")
    ref.push_sparse(IndexedSlices(np.array([4, 4, 8]),
                                  np.ones((3, 3), np.float32), (10, 3)),
                    lr=1.0)
    mine.push_sparse(torch.sparse_coo_tensor(
        torch.tensor([[4, 4, 8]]), torch.ones(3, 3), (10, 3)), lr=1.0)
    np.testing.assert_allclose(mine.table, ref.table, rtol=1e-6)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_host_table_files_across_packages(tmp_path, direction):
    src_mod, dst_mod = (emb, ref_emb) if direction == "port_to_ref" \
        else (ref_emb, emb)
    kw = {"device": "cpu"} if src_mod is emb else {}
    t = src_mod.HostEmbeddingTable(10, 3, seed=3, optimizer="adagrad", **kw)
    t.push(np.array([2, 7]), np.ones((2, 3), np.float32), lr=0.5)
    path = str(tmp_path / "state")
    t.save(path)
    kw = {"device": "cpu"} if dst_mod is emb else {}
    t2 = dst_mod.HostEmbeddingTable(10, 3, seed=4, optimizer="sgd", **kw)
    t2.load(path)
    assert t2.optimizer == "adagrad"
    np.testing.assert_array_equal(t.table, t2.table)
    np.testing.assert_array_equal(t._adagrad_acc, t2._adagrad_acc)


def test_host_embedding_trains_as_reference():
    """The pulled rows through a linear layer, 5 steps: the grads of the
    pulled rows pushed by apply_push (the port's through its autograd
    Function's backward), the reference's losses and table."""
    paddle.seed(0)
    ref = ref_emb.HostEmbedding(20, 4, init_std=0.5, seed=2)
    fc = paddle.nn.Linear(4, 1)
    mine = emb.HostEmbedding(20, 4, init_std=0.5, seed=2, device="cpu")
    w = torch.tensor(np.asarray(fc.weight.numpy()))
    b = torch.tensor(np.asarray(fc.bias.numpy()))
    ids = np.array([1, 5, 9, 5])
    rl, ml = [], []
    for _ in range(5):
        out = fc(ref(paddle.to_tensor(ids)))
        loss = (out * out).mean()
        loss.backward()
        ref.apply_push(lr=0.5)
        for p in fc.parameters():
            p.clear_grad()
        rl.append(float(loss.numpy()))
        out = mine(torch.from_numpy(ids)) @ w + b
        loss = (out * out).mean()
        loss.backward()
        mine.apply_push(lr=0.5)
        ml.append(loss.item())
    np.testing.assert_allclose(ml, rl, rtol=1e-6)
    np.testing.assert_allclose(mine.table.table, ref.table.table, rtol=1e-6)
    assert ml[-1] < ml[0]


def test_distributed_embedding_in_one_process():
    e = emb.DistributedEmbedding(100, 8, device="cpu")
    ids = torch.tensor([[1, 2], [3, 1]])
    out = e(ids)
    assert out.shape == (2, 2, 8)
    out.sum().backward()
    assert e.weight.grad[1].sum().item() == pytest.approx(16.0)


def test_distributed_embedding_rows_split_over_two_ranks(tmp_path):
    rs = np.random.RandomState(0)
    inputs = {"emb.w": rs.randn(16, 8).astype(np.float32),
              "emb.ids": rs.randint(0, 16, (3, 5)).astype(np.int64),
              "emb.cot": rs.randn(3, 5, 8).astype(np.float32)}
    lines, arrays = run_ranks("emb", 2, tmp_path, inputs)
    w = torch.from_numpy(inputs["emb.w"]).requires_grad_()
    y = torch.nn.functional.embedding(torch.from_numpy(inputs["emb.ids"]),
                                      w)
    (y * torch.from_numpy(inputs["emb.cot"])).sum().backward()
    for line, a in zip(lines, arrays):
        np.testing.assert_allclose(a["y"], y.detach().numpy(), rtol=1e-6)
        rows = slice(line["start"], line["start"] + line["rows"])
        np.testing.assert_allclose(a["dw"], w.grad.numpy()[rows],
                                   rtol=1e-6)
