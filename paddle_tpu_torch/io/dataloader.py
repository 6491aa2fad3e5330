"""DataLoader (a port of ``paddle_tpu/io/dataloader.py``).

``num_workers=0`` collates in this process and yields core Tensors on
the current device (``set_device``). ``num_workers>0`` forks worker
processes (``io/worker.py``) that collate to numpy, with large arrays
in shared memory; with ``use_buffer_reader`` a background thread turns
the next batches into device Tensors while the current one is consumed
(the reference's buffered reader). A Tensor made from a numpy array
copies it (``Tensor(array)`` is ``torch.tensor``, a blocking copy from
pageable memory), so a shared-memory segment is released only after that
copy has read it; structures left as numpy (dicts, nested lists) are
copied out first, since they would alias the segment.
"""
import queue
import threading

import numpy as np
import torch

from .dataset import IterableDataset
from .sampler import BatchSampler, DistributedBatchSampler  # noqa: F401


def default_collate_fn(batch):
    """Stack samples into batched numpy arrays: arrays, numbers and
    Tensors stacked, tuples, lists and dicts field by field."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch, axis=0)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    from ..core.tensor import Tensor
    if isinstance(sample, Tensor):
        return np.stack([s.numpy() for s in batch], axis=0)
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([s[i] for s in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    return np.asarray(batch)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(2, prefetch_factor)
        self.return_list = return_list
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.persistent_workers = persistent_workers
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                self.batch_sampler = None
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    @staticmethod
    def _to_tensors(collated):
        from ..core.tensor import Tensor
        if isinstance(collated, (list, tuple)):
            return [Tensor(c) if isinstance(c, np.ndarray) else c
                    for c in collated]
        if isinstance(collated, np.ndarray):
            return [Tensor(collated)]
        return collated

    def _make_batches(self):
        to_tensors = self._to_tensors

        if self._iterable_mode:
            bs = self.batch_size or 1  # None = per-sample (no batching)
            buf = []
            for sample in self.dataset:
                buf.append(sample)
                if len(buf) == bs:
                    yield to_tensors(self.collate_fn(buf))
                    buf = []
            if buf and not self.drop_last:
                yield to_tensors(self.collate_fn(buf))
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield to_tensors(self.collate_fn([self.dataset[i]]))
            return
        for indices in self.batch_sampler:
            batch = [self.dataset[i] for i in indices]
            yield to_tensors(self.collate_fn(batch))

    def __iter__(self):
        if self.num_workers == 0:
            yield from self._make_batches()
            return
        yield from self._iter_multiprocess()

    def _convert_batch(self, batch, shm_holds):
        """A decoded worker batch as consumer Tensors, its shm segments
        released once nothing aliases them (always, on an error too)."""
        from .worker import _release
        try:
            if shm_holds and not self._fast_convertible(batch):
                # numpy that _to_tensors leaves as it is would alias the
                # segment after the release
                batch = self._copy_out(batch)
                _release(shm_holds)
                shm_holds = []
            tensors = self._to_tensors(batch)
            if shm_holds:
                # every array was copied by Tensor(); the sync orders any
                # device copy before the unlink
                for t in tensors:
                    v = getattr(t, "value", None)
                    if v is not None and v.is_cuda:
                        torch.cuda.current_stream(v.device).synchronize()
                        break
                _release(shm_holds)
                shm_holds = []
            return tensors
        finally:
            if shm_holds:
                _release(shm_holds)

    @classmethod
    def _copy_out(cls, obj):
        if isinstance(obj, np.ndarray):
            return np.array(obj, copy=True)
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls._copy_out(o) for o in obj)
        if isinstance(obj, dict):
            return {k: cls._copy_out(v) for k, v in obj.items()}
        return obj

    @staticmethod
    def _fast_convertible(b):
        # shapes _to_tensors fully converts to Tensors: a bare
        # ndarray, or a flat list/tuple whose array entries are all
        # top-level (nested containers stay raw numpy inside)
        if isinstance(b, np.ndarray):
            return True
        if isinstance(b, (list, tuple)):
            return not any(isinstance(o, (list, tuple, dict)) for o in b)
        return False

    def _get_mp_iter(self):
        from .worker import _MultiprocessIter
        it = getattr(self, "_mp_iter", None)
        if it is not None and not it._shut \
                and all(w.is_alive() for w in it.workers):
            it.reset()
            return it
        self._mp_iter = None
        it = _MultiprocessIter(self)
        if it.persistent:
            self._mp_iter = it
        return it

    def _finish_epoch(self, mp_iter, completed):
        if completed and mp_iter.persistent and not mp_iter._shut:
            return  # keep the pool for the next epoch
        mp_iter._shutdown()
        if getattr(self, "_mp_iter", None) is mp_iter:
            self._mp_iter = None

    def _iter_multiprocess(self):
        """Worker processes collate; large arrays arrive via shared
        memory; with use_buffer_reader a background thread turns the
        next two batches into device Tensors and releases each shm
        segment once its copy has landed."""
        mp_iter = self._get_mp_iter()

        if not self.use_buffer_reader:
            completed = False
            try:
                for batch, shm_holds in mp_iter:
                    yield self._convert_batch(batch, shm_holds)
                completed = True
            finally:
                self._finish_epoch(mp_iter, completed)
            return

        q = queue.Queue(maxsize=2)
        sentinel = object()
        err = []
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            completed = False
            try:
                for batch, shm_holds in mp_iter:
                    if not put(self._convert_batch(batch, shm_holds)):
                        return  # consumer abandoned the iterator
                completed = True
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                try:
                    self._finish_epoch(mp_iter, completed)
                except BaseException as e:
                    err.append(e)
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            if err:
                raise err[0]
        finally:
            stop.set()
            t.join(timeout=10.0)
