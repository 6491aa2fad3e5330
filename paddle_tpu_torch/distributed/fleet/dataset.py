"""Fleet datasets: InMemoryDataset / QueueDataset (a port of
``paddle_tpu/distributed/fleet/dataset.py``).

Reference parity: python/paddle/distributed/fleet/dataset/dataset.py:259
(InMemoryDataset) / :1099 (QueueDataset) over the C++ Dataset/DataFeed
(framework/data_feed.cc MultiSlotDataFeed, data_set.cc channels and
preload threads, global shuffle via brpc).

The slot parsing is the port's native C++ (``core/native.py``
``parse_multislot``, a threaded parser), with the reference's
pure-Python parser where the native library is absent. ``global_shuffle``
with the PS endpoints re-deals the samples across the workers through the
servers' shuffle buckets; without them it permutes in memory. Batches pad
ragged sparse slots to the batch's longest.
"""
import threading

import numpy as np

from ...core import native


class DatasetBase:
    def __init__(self):
        self._use_var = []
        self._pipe_command = None
        self._batch_size = 1
        self._thread_num = 4
        self._filelist = []

    def init(self, batch_size=1, thread_num=4, use_var=None,
             pipe_command=None, input_type=0, fs_name="", fs_ugi="",
             download_cmd="cat", **kwargs):
        self._batch_size = batch_size
        self._thread_num = thread_num
        self._use_var = use_var or []
        self._pipe_command = pipe_command

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_batch_size(self, batch_size):
        self._batch_size = batch_size

    def set_thread(self, thread_num):
        self._thread_num = thread_num

    def set_use_var(self, use_var):
        self._use_var = use_var


class InMemoryDataset(DatasetBase):
    """Loads slot-format text files into memory with threaded native
    parsing; supports global shuffle and batch iteration with padded
    sparse slots."""

    def __init__(self):
        super().__init__()
        self._slots = None  # list of (values, offsets) per slot
        self._num_samples = 0
        self._num_slots = 0
        self._slot_is_dense = []

    def init(self, batch_size=1, thread_num=4, use_var=None, **kwargs):
        super().init(batch_size, thread_num, use_var, **kwargs)
        self._num_slots = len(self._use_var) if self._use_var else 0

    def load_into_memory(self):
        texts = []
        lock = threading.Lock()

        def read(path):
            with open(path, "r") as f:
                data = f.read()
            with lock:
                texts.append(data)

        threads = [threading.Thread(target=read, args=(p,))
                   for p in self._filelist]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        text = "".join(texts)
        if not self._num_slots:
            # infer from first line: count of "<n> values..." groups
            first = text.split("\n", 1)[0].split()
            i = 0
            n = 0
            while i < len(first):
                cnt = int(first[i])
                i += cnt + 1
                n += 1
            self._num_slots = n
        if native.available():
            self._slots = native.parse_multislot(
                text, self._num_slots, self._thread_num)
        else:
            self._slots = _py_parse_multislot(text, self._num_slots)
        self._num_samples = len(self._slots[0][1]) - 1
        self._slot_is_dense = [
            bool(np.all(np.diff(offs) == (offs[1] - offs[0])))
            for _, offs in self._slots]

    # -- sample (de)serialization for the shuffle exchange ----------------
    def _export_samples(self):
        """Per-sample rows: sample i -> tuple of per-slot value arrays."""
        out = []
        for i in range(self._num_samples):
            row = []
            for vals, offs in self._slots:
                row.append(vals[offs[i]:offs[i + 1]].copy())
            out.append(row)
        return out

    def _import_samples(self, samples):
        nslots = self._num_slots
        new_slots = []
        for s in range(nslots):
            seqs = [row[s] for row in samples]
            offs = np.zeros(len(seqs) + 1, np.int64)
            np.cumsum([len(q) for q in seqs], out=offs[1:])
            vals = (np.concatenate(seqs) if seqs
                    else np.zeros((0,), np.float32))
            new_slots.append((vals, offs))
        self._slots = new_slots
        self._num_samples = len(samples)
        # NOTE: _slot_is_dense is the dataset SCHEMA — invariant under
        # shuffling. Re-deriving it from whichever samples landed here
        # could classify a sparse slot as dense on one rank and not
        # another, desyncing batch structure across data-parallel ranks.

    def global_shuffle(self, fleet=None, thread_num=None,
                       ps_endpoints=None, rank=None, world=None,
                       seed=None):
        """Reference: InMemoryDataset.global_shuffle — samples are
        re-dealt ACROSS workers through a shuffle service
        (data_feed.h:395 InMemoryDataFeed global shuffle over brpc).

        Distributed path (ps_endpoints given): every worker assigns each
        of its samples a uniform destination rank, deposits the blobs in
        the PS shuffle buckets, barriers, then collects its own bucket —
        samples land on random workers. Without endpoints, the
        single-controller reduction: permute in memory. In a fleet
        parameter-server run the fleet's servers, worker index and worker
        count are the defaults."""
        if not ps_endpoints:
            from . import fleet_base
            if fleet_base.ps_client() is not None:
                ps_endpoints = fleet_base.server_endpoints()
                rank = fleet_base.worker_index() if rank is None else rank
                world = fleet_base.worker_num() if world is None else world
        if ps_endpoints:
            from ..ps import PSClient
            from ...core.errors import enforce, enforce_not_none
            import pickle
            enforce_not_none(rank, "global_shuffle(ps_endpoints=...) "
                             "requires rank=")
            enforce_not_none(world, "global_shuffle(ps_endpoints=...) "
                             "requires world=")
            enforce(0 <= rank < world,
                    f"rank {rank} out of range for world {world}")
            client = PSClient(ps_endpoints)
            try:
                # decorrelate destination draws per worker: a shared
                # seed would give every worker the SAME dests sequence
                # (sample i of every worker co-located, not a shuffle)
                rs = np.random.RandomState(
                    None if seed is None else seed + 7919 * (rank + 1))
                samples = self._export_samples()
                dests = rs.randint(0, world, size=len(samples))
                for d in range(world):
                    idx = np.nonzero(dests == d)[0]
                    if len(idx):
                        client.shuffle_put(
                            int(d),
                            [pickle.dumps(samples[i], protocol=4)
                             for i in idx])
                client.barrier(world)  # all deposits visible
                mine = [pickle.loads(b)
                        for b in client.shuffle_take(rank)]
                rs2 = np.random.RandomState(
                    None if seed is None else seed + rank)
                order = rs2.permutation(len(mine))
                self._import_samples([mine[i] for i in order])
                client.barrier(world)  # everyone done taking
            finally:
                client.close()
            return
        perm = np.random.permutation(self._num_samples)
        new_slots = []
        for vals, offs in self._slots:
            counts = np.diff(offs)
            new_counts = counts[perm]
            new_offs = np.zeros(len(offs), np.int64)
            np.cumsum(new_counts, out=new_offs[1:])
            new_vals = np.empty_like(vals)
            pos = 0
            for i, src in enumerate(perm):
                c = counts[src]
                new_vals[pos:pos + c] = vals[offs[src]:offs[src] + c]
                pos += c
            new_slots.append((new_vals, new_offs))
        self._slots = new_slots

    def local_shuffle(self):
        self.global_shuffle()

    def get_memory_data_size(self, fleet=None):
        return self._num_samples

    def get_shuffle_data_size(self, fleet=None):
        return self._num_samples

    def release_memory(self):
        self._slots = None
        self._num_samples = 0

    def __iter__(self):
        """Yields per-batch lists: dense slots -> [B] or [B, k] arrays;
        sparse slots -> (padded [B, maxlen] int64, [B] lengths)."""
        bs = self._batch_size
        for start in range(0, self._num_samples - bs + 1, bs):
            batch = []
            for (vals, offs), dense in zip(self._slots,
                                           self._slot_is_dense):
                counts = np.diff(offs[start:start + bs + 1])
                if dense:
                    k = counts[0]
                    arr = vals[offs[start]:offs[start + bs]].reshape(bs, k)
                    batch.append(arr.copy())
                else:
                    maxlen = int(counts.max())
                    pad = np.zeros((bs, maxlen), np.int64)
                    for i in range(bs):
                        c = counts[i]
                        o = offs[start + i]
                        pad[i, :c] = vals[o:o + c].astype(np.int64)
                    batch.append((pad, counts.astype(np.int64)))
            yield batch


def _py_parse_multislot(text, num_slots):
    values = [[] for _ in range(num_slots)]
    offsets = [[0] for _ in range(num_slots)]
    for line in text.splitlines():
        toks = line.split()
        i = 0
        for s in range(num_slots):
            cnt = int(toks[i])
            i += 1
            values[s].extend(float(t) for t in toks[i:i + cnt])
            i += cnt
            offsets[s].append(offsets[s][-1] + cnt)
    return [(np.asarray(v, np.float32), np.asarray(o, np.int64))
            for v, o in zip(values, offsets)]


class QueueDataset(DatasetBase):
    """Streaming variant: files parsed on the fly through the native
    blocking queue (reference QueueDataset semantics — one pass, no
    global shuffle)."""

    def __iter__(self):
        inner = InMemoryDataset()
        inner._use_var = self._use_var
        inner._batch_size = self._batch_size
        inner._thread_num = self._thread_num
        for path in self._filelist:
            inner.set_filelist([path])
            inner._num_slots = len(self._use_var) if self._use_var else 0
            inner.load_into_memory()
            yield from inner
            inner.release_memory()
