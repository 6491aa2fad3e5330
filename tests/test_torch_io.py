"""paddle_tpu_torch's ``io`` pipeline and ``text.datasets`` against the JAX
package's on the CPU: the samplers (the same orders from the same numpy
seed), ``DistributedBatchSampler``'s partition and epochs,
``default_collate_fn``, ``DataLoader`` in this process (``test_io.py``'s
scenarios, every batch equal to the reference's) and over worker
processes (``test_dataloader_mp.py``'s scenarios: order, pids, errors,
``worker_init_fn``/``get_worker_info``, iterable datasets, small arrays
off shared memory, dict batches copied out of it, no leaked segment after
an abandoned or failed iteration, ``batch_size=None``, persistent
workers, the unbuffered path), with no timing bar. Every class of
``text.datasets`` builds the reference's samples bit for bit.
"""
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.io import (BatchSampler, DataLoader, Dataset,
                                 DistributedBatchSampler, IterableDataset,
                                 RandomSampler, SequenceSampler,
                                 WeightedRandomSampler, default_collate_fn,
                                 get_worker_info)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


class _Sq(Dataset):
    def __init__(self, n=20):
        self.n = n

    def __getitem__(self, i):
        return np.float32([i]), np.int64(i % 3)

    def __len__(self):
        return self.n


class _ArrayDs(Dataset):
    """16 KiB features: they ride shared memory."""

    def __init__(self, n=32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((64, 64), i, dtype=np.float32), \
            np.asarray(i, dtype=np.int64)


def _np(batch):
    return [np.asarray(b.numpy()) for b in batch]


def test_samplers_follow_numpy_seed():
    ds = _Sq(12)
    for make in (lambda io: io.RandomSampler(ds),
                 lambda io: io.RandomSampler(ds, replacement=True,
                                             num_samples=7),
                 lambda io: io.WeightedRandomSampler(
                     np.arange(1, 13), 9),
                 lambda io: io.SequenceSampler(ds)):
        orders = []
        for io in (ref.io, paddle.io):
            np.random.seed(4)
            orders.append(list(make(io)))
        assert orders[0] == orders[1]
    assert len(RandomSampler(ds, num_samples=5)) == 5
    assert len(WeightedRandomSampler([1, 2], 3)) == 3
    assert list(SequenceSampler(ds)) == list(range(12))


def test_batch_samplers():
    assert len(BatchSampler(dataset=_Sq(10), batch_size=5)) == 2
    bs = BatchSampler(dataset=_Sq(10), batch_size=4, drop_last=True)
    assert list(bs) == [[0, 1, 2, 3], [4, 5, 6, 7]] and len(bs) == 2
    ds = _Sq(16)
    samplers = [DistributedBatchSampler(ds, batch_size=2, num_replicas=4,
                                        rank=r) for r in range(4)]
    assert sorted(i for s in samplers for b in s for i in b) == \
        list(range(16))
    assert len(samplers[0]) == 2
    one = DistributedBatchSampler(ds, batch_size=5)
    assert (one.nranks, one.local_rank) == (1, 0) and len(one) == 4
    for shuffle in (False, True):
        epochs = []
        for io in (ref.io, paddle.io):
            s = io.DistributedBatchSampler(_Sq(15), batch_size=4,
                                           num_replicas=2, rank=1,
                                           shuffle=shuffle)
            got = []
            for e in range(2):
                s.set_epoch(e)
                got.append([list(b) for b in s])
            epochs.append(got)
        assert epochs[0] == epochs[1]
        if shuffle:
            assert epochs[1][0] != epochs[1][1]


def test_default_collate_fn():
    samples = [(np.float32([i, i]), i, {"a": np.int64(i)}) for i in range(3)]
    a = default_collate_fn(samples)
    b = ref.io.default_collate_fn(samples)
    assert type(a) is type(b) is tuple
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2]["a"], b[2]["a"])
    t = default_collate_fn([paddle.to_tensor([1.0, 2.0])] * 2)
    assert t.shape == (2, 2)


@pytest.mark.parametrize("kw", [dict(batch_size=4),
                                dict(batch_size=3, drop_last=True),
                                dict(batch_size=3, shuffle=True),
                                dict(batch_size=None)])
def test_in_process_loader_equals_reference(kw):
    got = []
    for P in (ref, paddle):
        np.random.seed(7)
        got.append([_np(b) for b in P.io.DataLoader(_Sq(10), **kw)])
    assert len(got[0]) == len(got[1])
    for a, b in zip(got[1], got[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    batches = list(DataLoader(_Sq(10), batch_size=4))
    assert isinstance(batches[0][0], paddle.Tensor)
    assert batches[0][0].shape == [4, 1] and batches[0][1].shape == [4]
    assert batches[0][0].place.is_cpu_place()


def test_iterable_and_tensor_datasets():
    class It(IterableDataset):
        def __iter__(self):
            for i in range(7):
                yield np.float32([i])
    assert [b[0].shape[0] for b in DataLoader(It(), batch_size=3)] == \
        [3, 3, 1]
    with pytest.raises(TypeError):
        len(DataLoader(It(), batch_size=3))
    td = paddle.io.TensorDataset([np.arange(10), np.arange(10) * 2])
    assert len(DataLoader(td, batch_size=4)) == 3


def test_mp_loader_order_values_and_pids():
    dl = DataLoader(_ArrayDs(32), batch_size=4, num_workers=2)
    seen = []
    for x, y in dl:
        assert x.shape == [4, 64, 64]
        np.testing.assert_array_equal(x.numpy()[:, 0, 0].astype(np.int64),
                                      y.numpy())
        seen.extend(y.numpy().tolist())
    assert seen == list(range(32))

    class _PidDs(Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.asarray(os.getpid(), dtype=np.int64)
    pids = {p for (b,) in DataLoader(_PidDs(), batch_size=2, num_workers=2)
            for p in b.numpy().tolist()}
    assert os.getpid() not in pids


def test_mp_loader_equals_in_process():
    """Workers (with and without the buffered reader) yield the batches
    of the in-process path."""
    plain = [_np(b) for b in DataLoader(_ArrayDs(12), batch_size=5)]
    for buffered in (True, False):
        mp = [_np(b) for b in DataLoader(_ArrayDs(12), batch_size=5,
                                         num_workers=2,
                                         use_buffer_reader=buffered)]
        assert len(mp) == len(plain)
        for a, b in zip(mp, plain):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_mp_loader_errors_and_worker_info():
    class _BadDs(Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("boom at 5")
            return np.zeros(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="boom at 5"):
        for _ in DataLoader(_BadDs(), batch_size=2, num_workers=2):
            pass

    class _InfoDs(Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            info = get_worker_info()
            assert info is not None and 0 <= info.id < info.num_workers
            return np.asarray(info.id, dtype=np.int64)
    ids = [int(b[0].numpy()[0]) for b in DataLoader(
        _InfoDs(), batch_size=1, num_workers=2,
        worker_init_fn=lambda wid: None)]
    assert all(0 <= i < 2 for i in ids)
    assert get_worker_info() is None


def test_mp_loader_iterable_small_and_dict():
    class _Stream(IterableDataset):
        def __iter__(self):
            for i in range(10):
                yield np.full((8,), i, dtype=np.float32)
    got = np.concatenate([b[0].numpy()[:, 0] for b in DataLoader(
        _Stream(), batch_size=4, num_workers=1)]).tolist()
    assert sorted(got) == list(range(10))

    class _Tiny(Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return np.asarray([i, i + 1], dtype=np.float32)
    rows = np.concatenate([b[0].numpy() for b in DataLoader(
        _Tiny(), batch_size=3, num_workers=2)], axis=0)
    np.testing.assert_array_equal(rows[:, 0], np.arange(6))

    class _DictDs(Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return {"x": np.full((64, 64), i, dtype=np.float32),
                    "y": np.asarray([i], dtype=np.int64)}
    out = list(DataLoader(_DictDs(), batch_size=2, num_workers=2))
    assert len(out) == 4
    for bi, batch in enumerate(out):
        np.testing.assert_array_equal(
            batch["x"][:, 0, 0].astype(np.int64), batch["y"][:, 0])
        assert batch["y"][:, 0].tolist() == [2 * bi, 2 * bi + 1]


def _shm_segments():
    try:
        return {f for f in os.listdir("/dev/shm") if f.startswith("psm_")}
    except FileNotFoundError:
        return set()


def test_mp_loader_frees_shm():
    before = _shm_segments()
    it = iter(DataLoader(_ArrayDs(64), batch_size=4, num_workers=2,
                         prefetch_factor=4))
    next(it)
    it.close()

    class _BadLate(Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            if i == 9:
                raise ValueError("late boom")
            return np.full((64, 64), i, dtype=np.float32)
    with pytest.raises(RuntimeError, match="late boom"):
        for _ in DataLoader(_BadLate(), batch_size=2, num_workers=2,
                            prefetch_factor=4):
            pass
    time.sleep(0.5)
    leaked = _shm_segments() - before
    assert not leaked, f"leaked shm segments: {leaked}"


def test_mp_loader_batch_none_persistent_unbuffered():
    ys = [int(y.numpy()[0]) for _, y in DataLoader(
        _ArrayDs(6), batch_size=None, num_workers=2)]
    assert ys == list(range(6))
    dl = DataLoader(_ArrayDs(16), batch_size=4, num_workers=2,
                    persistent_workers=True)
    epoch1 = [tuple(y.numpy().tolist()) for _, y in dl]
    it = dl._mp_iter
    pids = [w.pid for w in it.workers]
    epoch2 = [tuple(y.numpy().tolist()) for _, y in dl]
    assert dl._mp_iter is it and [w.pid for w in it.workers] == pids
    assert epoch1 == epoch2 == [(0, 1, 2, 3), (4, 5, 6, 7),
                                (8, 9, 10, 11), (12, 13, 14, 15)]
    it._shutdown()


DATASETS = {
    "Imdb": lambda m, mode: m.Imdb(mode=mode),
    "Imikolov": lambda m, mode: m.Imikolov(mode=mode),
    "Imikolov_seq": lambda m, mode: m.Imikolov(data_type="SEQ", mode=mode),
    "Movielens": lambda m, mode: m.Movielens(mode=mode),
    "UCIHousing": lambda m, mode: m.UCIHousing(data_file="/nonexistent",
                                               mode=mode),
    "Conll05st": lambda m, mode: m.Conll05st(mode=mode),
    "WMT14": lambda m, mode: m.WMT14(mode=mode, dict_size=500),
    "WMT16": lambda m, mode: m.WMT16(mode=mode, src_dict_size=17191,
                                     trg_dict_size=7709),
}


def _flat_sample(s):
    if isinstance(s, (tuple, list)):
        return [np.asarray(x) for x in s]
    return [np.asarray(s)]


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", list(DATASETS))
def test_text_datasets_bit_for_bit(name, mode):
    a = DATASETS[name](ref.text.datasets, mode)
    b = DATASETS[name](paddle.text.datasets, mode)
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        for x, y in zip(_flat_sample(b[i]), _flat_sample(a[i])):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    if hasattr(a, "get_dict"):
        ra, rb = a.get_dict(), b.get_dict()
        assert ra == rb
