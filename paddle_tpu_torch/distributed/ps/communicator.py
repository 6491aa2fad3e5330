"""Trainer-side communicators (a copy of
``paddle_tpu/distributed/ps/communicator.py``): sync / async / geo
gradient flow.

Reference: paddle/fluid/distributed/service/communicator.h:197
(Communicator base: send queues + merge), :348 (AsyncCommunicator —
background send thread merging up to max_merge_var_num grads before
pushing), :497 (GeoCommunicator — local SGD with periodic delta sync).
"""
import queue
import threading

import numpy as np


class Communicator:
    """Sync mode: push gradients immediately, callers pull when needed."""

    def __init__(self, client):
        self.client = client

    def send_dense(self, table_id, grad):
        self.client.push_dense(table_id, grad)

    def send_sparse(self, table_id, ids, grads):
        self.client.push_sparse(table_id, ids, grads)

    def recv_dense(self, table_id):
        return self.client.pull_dense(table_id)

    def start(self):
        return self

    def stop(self):
        pass

    def flush(self):
        pass


class AsyncCommunicator(Communicator):
    """Async mode: gradients go to a queue; a background thread merges up
    to `max_merge_var_num` pending grads per table and pushes the sum
    (reference: communicator.h:348, FLAGS_communicator_max_merge_var_num
    platform/flags.cc:210)."""

    def __init__(self, client, max_merge_var_num=20, send_wait_ms=5):
        super().__init__(client)
        self.max_merge = int(max_merge_var_num)
        self.wait_s = send_wait_ms / 1000.0
        self._q = queue.Queue()
        self._stop = threading.Event()
        self._thread = None
        self._inflight = threading.Semaphore(0)
        self._pending = 0
        self._pending_lock = threading.Lock()

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def send_dense(self, table_id, grad):
        with self._pending_lock:
            self._pending += 1
        self._q.put(("dense", table_id, np.asarray(grad)))

    def send_sparse(self, table_id, ids, grads):
        with self._pending_lock:
            self._pending += 1
        self._q.put(("sparse", table_id, (np.asarray(ids),
                                          np.asarray(grads))))

    def _drain(self, first):
        """Collect up to max_merge messages for the same (kind, table)."""
        kind, tid, payload = first
        if kind == "dense":
            acc = payload.astype(np.float32)
        else:
            acc_ids = [payload[0]]
            acc_grads = [payload[1]]
        n = 1
        back = []
        while n < self.max_merge:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item[0] == kind and item[1] == tid:
                if kind == "dense":
                    acc = acc + item[2]
                else:
                    acc_ids.append(item[2][0])
                    acc_grads.append(item[2][1])
                n += 1
            else:
                back.append(item)
        for item in back:
            self._q.put(item)
        if kind == "dense":
            return kind, tid, acc, n
        return kind, tid, (np.concatenate(acc_ids),
                           np.concatenate(acc_grads)), n

    def _loop(self):
        while not self._stop.is_set() or not self._q.empty():
            try:
                first = self._q.get(timeout=self.wait_s)
            except queue.Empty:
                continue
            kind, tid, payload, n = self._drain(first)
            try:
                if kind == "dense":
                    self.client.push_dense(tid, payload)
                else:
                    self.client.push_sparse(tid, payload[0], payload[1])
            except Exception as e:  # noqa: BLE001 — surfaced by flush()
                self._error = e
                with self._pending_lock:
                    self._pending -= n
                return  # dead server: stop consuming, flush() re-raises
            with self._pending_lock:
                self._pending -= n

    _error = None

    def flush(self):
        import time
        while True:
            if self._error is not None:
                raise RuntimeError(
                    "AsyncCommunicator send thread failed") from self._error
            if self._thread is not None and not self._thread.is_alive() \
                    and not self._stop.is_set():
                raise RuntimeError("AsyncCommunicator send thread died")
            with self._pending_lock:
                if self._pending == 0 and self._q.empty():
                    return
            time.sleep(0.005)

    def stop(self):
        self.flush()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)


class GeoCommunicator(Communicator):
    """Geo-SGD: train on a LOCAL copy; every `k_steps` push the delta
    (local - last_synced) and pull the server's merged state (reference:
    communicator.h:497 GeoCommunicator; the server table uses the 'sum'
    rule so deltas from all trainers accumulate)."""

    def __init__(self, client, k_steps=4):
        super().__init__(client)
        self.k_steps = int(k_steps)
        self._local = {}
        self._synced = {}
        self._steps = {}

    def init_dense(self, table_id):
        v = self.client.pull_dense(table_id)
        self._local[table_id] = np.array(v, np.float32)
        self._synced[table_id] = np.array(v, np.float32)
        self._steps[table_id] = 0
        return self._local[table_id]

    def local_value(self, table_id):
        return self._local[table_id]

    def local_update(self, table_id, grad, lr):
        """One local SGD step; triggers a geo sync every k_steps."""
        self._local[table_id] -= lr * np.asarray(grad, np.float32)
        self._steps[table_id] += 1
        if self._steps[table_id] % self.k_steps == 0:
            self._geo_sync(table_id)

    def _geo_sync(self, table_id):
        delta = self._local[table_id] - self._synced[table_id]
        self.client.push_dense(table_id, delta)  # server rule: 'sum'
        fresh = np.asarray(self.client.pull_dense(table_id), np.float32)
        self._local[table_id] = fresh.copy()
        self._synced[table_id] = fresh.copy()

    def flush(self):
        for tid in list(self._local):
            self._geo_sync(tid)
