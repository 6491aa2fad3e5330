"""DataLoader worker processes with shared-memory transport (a port of
``paddle_tpu/io/worker.py``).

Worker processes decode, augment and collate to numpy; arrays of 16 KiB
or more travel through POSIX shared memory (``multiprocessing.
shared_memory``), so the pipe carries only descriptors. The main process
wraps each segment as a numpy array and must copy it out (or finish its
device copy) before ``_release`` unlinks it: ``torch.from_numpy`` would
alias the buffer. Workers are forked (Linux): the dataset is inherited,
not pickled, and a worker touches only numpy, never torch's CUDA state,
so a dataset or collate function must not hold CUDA tensors.
"""
import multiprocessing as mp
import os
import queue
import sys
import traceback

import numpy as np

# arrays at or above this many bytes ride shared memory; smaller ones are
# cheaper to pickle straight through the result queue
_SHM_MIN_BYTES = 1 << 14


class WorkerInfo:
    """Visible to dataset code inside a worker (reference:
    fluid/dataloader/worker.py WorkerInfo / paddle.io.get_worker_info)."""

    def __init__(self, id, num_workers, dataset, seed):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, num_workers={self.num_workers}, "
                f"seed={self.seed})")


_worker_info = None


def get_worker_info():
    """Returns the WorkerInfo inside a DataLoader worker process, else
    None (reference: paddle.io.get_worker_info)."""
    return _worker_info


class _ExceptionWrapper:
    def __init__(self, exc):
        self.exc_type_name = type(exc).__name__
        self.msg = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))

    def reraise(self):
        raise RuntimeError(
            f"DataLoader worker raised {self.exc_type_name}:\n{self.msg}")


def _unregister_shm(shm):
    """The worker creates the segment but the main process unlinks it;
    detach the worker-side resource_tracker registration so worker exit
    doesn't unlink (or warn about) segments still in flight."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _encode(obj, use_shared_memory, shm_refs):
    """Recursively replace large numpy arrays with shm descriptors.
    Appends created SharedMemory objects to shm_refs (worker closes its
    mapping after the queue put)."""
    if isinstance(obj, np.ndarray):
        if (use_shared_memory and obj.nbytes >= _SHM_MIN_BYTES
                and obj.dtype != object):
            from multiprocessing import shared_memory
            # NOTE: no resource_tracker.unregister here. Workers are
            # forked AFTER the main process starts the tracker
            # (_MultiprocessIter calls ensure_running), so create
            # registers in the SHARED tracker; the main process's
            # attach re-register is a set no-op and its unlink
            # unregisters — balanced. A worker killed mid-encode leaves
            # the segment registered, so the tracker reclaims it at
            # exit instead of leaking it until reboot.
            shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
            dst = np.ndarray(obj.shape, dtype=obj.dtype, buffer=shm.buf)
            dst[...] = obj
            shm_refs.append(shm)
            return ("_shm", shm.name, obj.dtype.str, obj.shape)
        return obj
    if isinstance(obj, tuple):
        return ("_tuple", [_encode(o, use_shared_memory, shm_refs)
                           for o in obj])
    if isinstance(obj, list):
        return [_encode(o, use_shared_memory, shm_refs) for o in obj]
    if isinstance(obj, dict):
        return {k: _encode(v, use_shared_memory, shm_refs)
                for k, v in obj.items()}
    return obj


def _decode(obj, shm_holds):
    """Inverse of _encode in the main process. Attached SharedMemory
    objects are appended to shm_holds; the returned arrays alias their
    buffers, so the caller must keep shm_holds alive until the arrays are
    consumed (copied out, or copied to the device), then close+unlink
    each."""
    if isinstance(obj, tuple) and obj and obj[0] == "_shm":
        from multiprocessing import shared_memory
        _, name, dtype_str, shape = obj
        # attach registers with the resource_tracker; the later unlink()
        # in _release/_unlink_encoded unregisters — balanced, so no
        # manual unregister here (that would double-unregister)
        shm = shared_memory.SharedMemory(name=name)
        shm_holds.append(shm)
        return np.ndarray(shape, dtype=np.dtype(dtype_str), buffer=shm.buf)
    if isinstance(obj, tuple) and obj and obj[0] == "_tuple":
        return tuple(_decode(o, shm_holds) for o in obj[1])
    if isinstance(obj, list):
        return [_decode(o, shm_holds) for o in obj]
    if isinstance(obj, dict):
        return {k: _decode(v, shm_holds) for k, v in obj.items()}
    return obj


def _unlink_encoded(obj):
    """Free shm segments referenced by a still-encoded batch without
    decoding it (shutdown path for never-consumed prefetched batches)."""
    if isinstance(obj, tuple) and obj and obj[0] == "_shm":
        from multiprocessing import shared_memory
        try:
            shm = shared_memory.SharedMemory(name=obj[1])
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass
        except Exception:
            pass
        return
    if isinstance(obj, tuple) and obj and obj[0] == "_tuple":
        for o in obj[1]:
            _unlink_encoded(o)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _unlink_encoded(o)
    elif isinstance(obj, dict):
        for v in obj.values():
            _unlink_encoded(v)


def _release(shm_holds):
    for shm in shm_holds:
        try:
            shm.close()
            shm.unlink()  # also unregisters from the resource_tracker
        except FileNotFoundError:
            # already unlinked elsewhere: balance the attach-register
            _unregister_shm(shm)


def _worker_loop(dataset, iterable_mode, collate_fn, index_queue,
                 result_queue, worker_id, num_workers, seed, init_fn,
                 use_shared_memory, batch_size, drop_last):
    """Runs in the child process. Pulls (idx, indices) tasks, collates,
    pushes (idx, encoded_batch). A None task means exit. For
    IterableDataset the task is (idx, count): the worker advances its own
    iterator (sharding via get_worker_info is the dataset's job,
    matching the reference's iterable semantics)."""
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset, seed)
    np.random.seed((seed + worker_id) % (2 ** 32))
    try:
        import random
        random.seed(seed + worker_id)
        if init_fn is not None:
            init_fn(worker_id)
        it = iter(dataset) if iterable_mode else None
        while True:
            task = index_queue.get()
            if task is None:
                break
            idx, indices = task
            try:
                if iterable_mode:
                    buf = []
                    for _ in range(indices):
                        try:
                            buf.append(next(it))
                        except StopIteration:
                            break
                    if not buf or (drop_last and len(buf) < indices):
                        result_queue.put((idx, ("_iter_end",)))
                        continue
                    batch = collate_fn(buf)
                else:
                    batch = collate_fn([dataset[i] for i in indices])
                shm_refs = []
                enc = _encode(batch, use_shared_memory, shm_refs)
                result_queue.put((idx, enc))
                for shm in shm_refs:
                    shm.close()  # main process owns the segment now
            except Exception as e:  # per-batch error -> main re-raises
                result_queue.put((idx, _ExceptionWrapper(e)))
    except KeyboardInterrupt:
        pass
    except Exception as e:
        try:
            result_queue.put((-1, _ExceptionWrapper(e)))
        except Exception:
            pass


class _MultiprocessIter:
    """Main-process side: task dispatch, order-restoring receive, worker
    liveness watch (reference: dataloader_iter.py:241 + the SIGCHLD
    watcher in imperative/data_loader.cc)."""

    def __init__(self, loader):
        self.loader = loader
        self._shut = False
        self.num_workers = loader.num_workers
        self.use_shared_memory = loader.use_shared_memory
        self.timeout = loader.timeout or 0
        # start the resource_tracker in THIS process before forking so
        # every worker inherits it: shm segments then live in one shared
        # registry (see the note in _encode)
        try:
            from multiprocessing import resource_tracker
            resource_tracker.ensure_running()
        except Exception:
            pass
        ctx = mp.get_context("fork" if hasattr(os, "fork") else "spawn")
        self.index_queue = ctx.Queue()
        self.result_queue = ctx.Queue()
        self.iterable_mode = loader._iterable_mode
        self.persistent = (loader.persistent_workers
                           and not self.iterable_mode)
        if self.iterable_mode:
            # Each worker iterates its own copy of the stream (reference
            # semantics: fluid/dataloader/worker.py — the dataset must
            # shard itself via get_worker_info() or every worker yields
            # the full stream).
            if self.num_workers > 1:
                import warnings
                warnings.warn(
                    "IterableDataset with num_workers>1: each worker "
                    "iterates the whole dataset; shard inside __iter__ "
                    "with paddle.io.get_worker_info() to avoid "
                    "duplicate samples")
        self.tasks = self._epoch_tasks()
        self.send_idx = 0
        self.rcvd_idx = 0
        self.reorder = {}
        self.iter_ended = False
        seed = int(np.random.randint(0, 2 ** 31 - 1))
        self.workers = []
        for wid in range(self.num_workers):
            w = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, self.iterable_mode, loader.collate_fn,
                      self.index_queue, self.result_queue, wid,
                      self.num_workers, seed, loader.worker_init_fn,
                      self.use_shared_memory, loader.batch_size,
                      loader.drop_last),
                daemon=True)
            w.start()
            self.workers.append(w)
        self.outstanding = 0
        self.max_outstanding = self.num_workers * loader.prefetch_factor
        self._prime()

    # -- dispatch ---------------------------------------------------------
    def _epoch_tasks(self):
        if self.iterable_mode:
            return None
        if self.loader.batch_sampler is None:
            # batch_size=None: per-sample mode (no batching), matching
            # the single-process _make_batches path
            return [[i] for i in range(len(self.loader.dataset))]
        return list(self.loader.batch_sampler)

    def reset(self):
        """Start a new epoch on the SAME worker pool
        (persistent_workers=True, map-style only). Re-lists the sampler
        so shuffling re-randomizes."""
        assert self.outstanding == 0 and not self.reorder
        self.tasks = self._epoch_tasks()
        self.send_idx = 0
        self.rcvd_idx = 0
        self._prime()

    def _have_more_tasks(self):
        if self.iterable_mode:
            return not self.iter_ended
        return self.send_idx < len(self.tasks)

    def _dispatch_one(self):
        if self.iterable_mode:
            self.index_queue.put(
                (self.send_idx, self.loader.batch_size or 1))
        else:
            self.index_queue.put((self.send_idx, self.tasks[self.send_idx]))
        self.send_idx += 1
        self.outstanding += 1

    def _prime(self):
        while self.outstanding < self.max_outstanding \
                and self._have_more_tasks():
            self._dispatch_one()

    # -- receive ----------------------------------------------------------
    def _check_workers(self):
        for w in self.workers:
            if not w.is_alive() and w.exitcode not in (0, None):
                self._shutdown()
                raise RuntimeError(
                    f"DataLoader worker pid={w.pid} exited unexpectedly "
                    f"with code {w.exitcode} (likely killed, e.g. OOM)")

    def _get(self):
        poll = self.timeout if self.timeout > 0 else 5.0
        while True:
            try:
                return self.result_queue.get(timeout=poll)
            except queue.Empty:
                self._check_workers()
                if self.timeout > 0:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader timed out after {self.timeout}s "
                        "waiting for a batch")

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self.outstanding == 0 and not self._have_more_tasks():
                if not self.persistent:
                    self._shutdown()
                raise StopIteration
            if self.rcvd_idx in self.reorder:
                data = self.reorder.pop(self.rcvd_idx)
                self.rcvd_idx += 1
            else:
                idx, data = self._get()
                if idx == -1 or isinstance(data, _ExceptionWrapper):
                    self._shutdown()
                    data.reraise()
                if idx != self.rcvd_idx:
                    self.reorder[idx] = data
                    continue
                self.rcvd_idx += 1
            self.outstanding -= 1
            if isinstance(data, tuple) and data and data[0] == "_iter_end":
                self.iter_ended = True
                if self.outstanding == 0:
                    self._shutdown()
                    raise StopIteration
                continue
            self._prime()
            shm_holds = []
            batch = _decode(data, shm_holds)
            return batch, shm_holds

    def _shutdown(self):
        if self._shut:
            return
        self._shut = True
        try:
            for _ in self.workers:
                self.index_queue.put(None)
            for w in self.workers:
                w.join(timeout=2.0)
            for w in self.workers:
                if w.is_alive():
                    w.terminate()
        except Exception:
            pass
        try:
            self._drain_unlink()
        except Exception:
            pass

    def _drain_unlink(self):
        """Unlink shm segments referenced by batches that were produced
        but never consumed (in-flight prefetch when iteration stops early
        or errors). The workers unregistered these from their
        resource_tracker, so nobody else will free them."""
        for data in self.reorder.values():
            _unlink_encoded(data)
        self.reorder.clear()
        while True:
            try:
                _, data = self.result_queue.get(timeout=0.1)
            except queue.Empty:
                if not any(w.is_alive() for w in self.workers):
                    break
            except Exception:
                break
            else:
                _unlink_encoded(data)

    def __del__(self):
        self._shutdown()
