"""PS server (a copy of ``paddle_tpu/distributed/ps/server.py``, numpy
over the shared wire): owns tables, serves pull/push over TCP.

Reference: paddle/fluid/distributed/service/brpc_ps_server.h BrpcPsServer
+ distributed/table/common_dense_table.h / common_sparse_table.h (tables
with per-table optimizer rules applied server-side on push).
"""
import os
import socketserver
import threading

import numpy as np

from .rpc import send_msg, recv_msg


class DenseTable:
    """Reference: CommonDenseTable — a flat dense param block updated by
    pushed gradients with a server-side rule (sgd / adam / sum)."""

    def __init__(self, shape, optimizer="sgd", lr=0.01, init=None,
                 seed=0):
        self.lock = threading.Lock()
        if init is not None:
            self.value = np.asarray(init, np.float32).copy()
        else:
            rs = np.random.RandomState(seed)
            self.value = (rs.randn(*shape) * 0.01).astype(np.float32)
        self.optimizer = optimizer
        self.lr = float(lr)
        if optimizer == "adam":
            self._m = np.zeros_like(self.value)
            self._v = np.zeros_like(self.value)
            self._t = 0

    def pull(self):
        with self.lock:
            return self.value.copy()

    def push(self, grad):
        # the TCP server is threaded: concurrent trainer pushes must not
        # interleave the read-modify-write (numpy releases the GIL)
        g = np.asarray(grad, np.float32)
        with self.lock:
            if self.optimizer == "sum":
                self.value += g
            elif self.optimizer == "adam":
                self._t += 1
                self._m = 0.9 * self._m + 0.1 * g
                self._v = 0.999 * self._v + 0.001 * g * g
                mh = self._m / (1 - 0.9 ** self._t)
                vh = self._v / (1 - 0.999 ** self._t)
                self.value -= self.lr * mh / (np.sqrt(vh) + 1e-8)
            else:  # sgd
                self.value -= self.lr * g

    def set(self, value):
        with self.lock:
            self.value = np.asarray(value, np.float32).copy()

    def state(self):
        s = {"value": self.value, "optimizer": self.optimizer,
             "lr": self.lr}
        if self.optimizer == "adam":
            s.update(m=self._m, v=self._v, t=self._t)
        return s

    def load_state(self, s):
        self.value = s["value"]
        self.optimizer = s["optimizer"]
        self.lr = s["lr"]
        if self.optimizer == "adam":
            self._m, self._v, self._t = s["m"], s["v"], s["t"]


class SparseTable:
    """Reference: CommonSparseTable — hash-sparse embedding rows created
    on first access, sparse SGD/adagrad applied on push."""

    def __init__(self, dim, optimizer="sgd", lr=0.01, init_std=0.01,
                 seed=0):
        self.lock = threading.Lock()
        self.dim = int(dim)
        self.optimizer = optimizer
        self.lr = float(lr)
        self.init_std = float(init_std)
        self._rs = np.random.RandomState(seed)
        self.rows = {}
        self._acc = {}

    def _row(self, rid):
        r = self.rows.get(rid)
        if r is None:
            r = (self._rs.randn(self.dim) * self.init_std).astype(
                np.float32)
            self.rows[rid] = r
        return r

    def pull(self, ids):
        ids = np.asarray(ids).reshape(-1)
        with self.lock:
            return np.stack([self._row(int(i)).copy() for i in ids],
                            axis=0)

    def push(self, ids, grads):
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        with self.lock:
            for i, g in zip(ids, grads):
                i = int(i)
                row = self._row(i)
                if self.optimizer == "adagrad":
                    acc = self._acc.get(i, 0.0) + float((g * g).mean())
                    self._acc[i] = acc
                    row -= self.lr / (np.sqrt(acc) + 1e-6) * g
                else:
                    row -= self.lr * g

    def state(self):
        with self.lock:
            return {"dim": self.dim, "optimizer": self.optimizer,
                    "lr": self.lr, "rows": dict(self.rows),
                    "acc": dict(self._acc), "init_std": self.init_std,
                    "rs": self._rs.get_state()}

    def load_state(self, s):
        self.dim = s["dim"]
        self.optimizer = s["optimizer"]
        self.lr = s["lr"]
        self.rows = s["rows"]
        self._acc = s["acc"]
        self.init_std = s.get("init_std", 0.01)
        if "rs" in s:
            # restore the row-init RNG stream position: rows created
            # after a restore must not replay pre-save values
            self._rs.set_state(s["rs"])


class SSDSparseTable(SparseTable):
    """Disk-backed sparse table (reference:
    distributed/table/ssd_sparse_table.h — embedding tables larger than
    RAM: a bounded in-memory hot set with LRU eviction, cold rows on
    disk; rocksdb there, an append-log with per-record checksums here).

    Crash durability (r4, the rocksdb-atomicity analogue): spills
    APPEND fixed-size records `[rid int64 | dim+1 float32 | crc32]` —
    the in-memory index advances to a record only after its bytes are
    fully written, and recovery (`recover()` / opening an existing
    path) scans the log keeping the LAST checksum-valid record per rid
    and truncates at the first torn/invalid one. A kill mid-spill
    therefore loses at most the record being written, never corrupts
    older data, and is detected — not silently read back as garbage.
    The log compacts in place (write-temp + atomic rename) when stale
    versions dominate."""

    _MAGIC = b"SSDT\x01"

    def __init__(self, dim, optimizer="sgd", lr=0.01, init_std=0.01,
                 seed=0, cache_rows=4096, path=None):
        super().__init__(dim, optimizer, lr, init_std, seed)
        import collections
        import tempfile
        self.rows = collections.OrderedDict()  # hot set, LRU order
        self.cache_rows = int(cache_rows)
        self._dir = path or tempfile.mkdtemp(prefix="ps_ssd_table_")
        os.makedirs(self._dir, exist_ok=True)
        self._data_path = os.path.join(self._dir, "rows.bin")
        self._rec = 8 + (self.dim + 1) * 4 + 4
        self._slots = {}              # rid -> byte offset of last record
        if os.path.exists(self._data_path):
            self._open_and_recover()
        else:
            self._file = open(self._data_path, "w+b")
            self._file.write(self._MAGIC
                             + np.uint32(self.dim).tobytes())
            self._file.flush()
            self._end = self._file.tell()

    # -- log format -------------------------------------------------------
    def _encode(self, rid, row, acc):
        import zlib
        payload = np.int64(rid).tobytes()
        rec = np.empty(self.dim + 1, np.float32)
        rec[:self.dim] = row
        rec[self.dim] = acc
        payload += rec.tobytes()
        return payload + np.uint32(
            zlib.crc32(payload) & 0xFFFFFFFF).tobytes()

    def _decode(self, buf):
        """(rid, row, acc) or None if torn/corrupt."""
        import zlib
        if len(buf) != self._rec:
            return None
        payload, crc = buf[:-4], buf[-4:]
        if np.frombuffer(crc, np.uint32)[0] != (
                zlib.crc32(payload) & 0xFFFFFFFF):
            return None
        rid = int(np.frombuffer(payload[:8], np.int64)[0])
        vals = np.frombuffer(payload[8:], np.float32)
        return rid, vals[:self.dim].copy(), float(vals[self.dim])

    def _open_and_recover(self):
        """Scan an existing log: keep the last valid record per rid,
        truncate at the first torn/invalid record (everything before it
        was written completely — append-log atomicity)."""
        self._file = open(self._data_path, "r+b")
        head = self._file.read(len(self._MAGIC) + 4)
        if len(head) < len(self._MAGIC) + 4:
            # crash in the window between file creation and the header
            # landing on disk: nothing was ever stored — reinitialize
            # as an empty log rather than refusing to restart
            self._file.seek(0)
            self._file.truncate(0)
            self._file.write(self._MAGIC + np.uint32(self.dim).tobytes())
            self._file.flush()
            self._end = self._file.tell()
            return
        if head[:len(self._MAGIC)] != self._MAGIC:
            raise RuntimeError(
                f"{self._data_path} is not an SSDSparseTable log "
                "(bad magic)")
        fdim = int(np.frombuffer(head[len(self._MAGIC):], np.uint32)[0])
        if fdim != self.dim:
            raise RuntimeError(
                f"SSDSparseTable log at {self._data_path} has dim "
                f"{fdim}, table expects {self.dim}")
        pos = len(head)
        while True:
            buf = self._file.read(self._rec)
            if not buf:
                break
            dec = self._decode(buf)
            if dec is None:
                # torn tail (kill mid-spill): discard it and everything
                # after — records are appended, so nothing valid follows
                self._file.truncate(pos)
                break
            self._slots[dec[0]] = pos
            pos += self._rec
        self._file.seek(0, os.SEEK_END)
        self._end = self._file.tell()

    @classmethod
    def recover(cls, path, dim, **kw):
        """Reopen a table directory after a crash; torn tail records
        from a kill mid-spill are detected (checksum) and dropped."""
        return cls(dim, path=path, **kw)

    def _row(self, rid):
        r = self.rows.get(rid)
        if r is not None:
            self.rows.move_to_end(rid)
            return r
        off = self._slots.get(rid)
        if off is not None:
            self._file.seek(off)
            dec = self._decode(self._file.read(self._rec))
            if dec is None or dec[0] != rid:
                raise RuntimeError(
                    f"SSDSparseTable: corrupt record for row {rid} at "
                    f"offset {off} (checksum mismatch)")
            r, acc = dec[1], dec[2]
            if acc:
                self._acc[rid] = acc
        else:
            r = (self._rs.randn(self.dim) * self.init_std).astype(
                np.float32)
        self.rows[rid] = r
        self._evict()
        return r

    def _spill(self, rid, row):
        buf = self._encode(rid, row, self._acc.pop(rid, 0.0))
        self._file.seek(self._end)
        self._file.write(buf)
        # the index advances ONLY after the full record is written: a
        # crash inside write() leaves the old index target intact
        self._slots[rid] = self._end
        self._end += self._rec

    def _evict(self):
        while len(self.rows) > self.cache_rows:
            rid, row = self.rows.popitem(last=False)  # oldest-touched
            self._spill(rid, row)
        self._maybe_compact()

    def _maybe_compact(self):
        live = max(1, len(self._slots))
        total = (self._end - len(self._MAGIC) - 4) // self._rec
        if total > 2 * live + 64:
            self._compact()

    def _compact(self):
        """Rewrite live records to a temp file and atomically rename —
        a crash mid-compaction leaves the original log untouched."""
        tmp = self._data_path + ".compact"
        with open(tmp, "wb") as f:
            f.write(self._MAGIC + np.uint32(self.dim).tobytes())
            new_slots = {}
            for rid, off in self._slots.items():
                self._file.seek(off)
                new_slots[rid] = f.tell()
                f.write(self._file.read(self._rec))
            f.flush()
            os.fsync(f.fileno())
        self._file.close()
        os.replace(tmp, self._data_path)
        self._file = open(self._data_path, "r+b")
        self._file.seek(0, os.SEEK_END)
        self._end = self._file.tell()
        self._slots = new_slots

    def _flush_locked(self):
        for rid in list(self.rows):
            acc = self._acc.get(rid)  # _spill pops; keep hot copy
            self._spill(rid, self.rows[rid])
            if acc is not None:
                self._acc[rid] = acc
        self._file.flush()
        os.fsync(self._file.fileno())
        # all-hot workloads never reach _evict's compaction check, but
        # every flush appends a fresh record per hot row — compact here
        # too or periodic snapshots grow the log without bound
        self._maybe_compact()

    def flush(self):
        """Spill every hot row to disk (fsynced; rows stay hot); called
        before state snapshots so the file is complete."""
        with self.lock:
            self._flush_locked()

    @property
    def hot_rows(self):
        return len(self.rows)

    @property
    def total_rows(self):
        return len(set(self._slots) | set(self.rows))

    def state(self):
        # point-in-time snapshot: the spill file's CONTENT is copied
        # into the state (referencing the live file would let later
        # evictions mutate the checkpoint, and the path may not exist
        # on a restore host). One lock scope for flush + read: a push
        # landing between them would make blob and acc/hot disagree.
        with self.lock:
            self._flush_locked()
            with open(self._data_path, "rb") as f:
                blob = f.read()
            return {"dim": self.dim, "optimizer": self.optimizer,
                    "lr": self.lr, "init_std": self.init_std,
                    "rs": self._rs.get_state(),
                    "cache_rows": self.cache_rows,
                    "slots": dict(self._slots),
                    "data_blob": blob,
                    "acc": dict(self._acc),
                    "hot_ids": list(self.rows)}

    def load_state(self, s):
        import collections
        import tempfile
        self.dim = s["dim"]
        self.optimizer = s["optimizer"]
        self.lr = s["lr"]
        self.init_std = s["init_std"]
        self._rs.set_state(s["rs"])
        self.cache_rows = s["cache_rows"]
        self._dir = tempfile.mkdtemp(prefix="ps_ssd_table_")
        self._data_path = os.path.join(self._dir, "rows.bin")
        with open(self._data_path, "wb") as f:
            f.write(s["data_blob"])
        self._file = open(self._data_path, "r+b")
        self._file.seek(0, os.SEEK_END)
        self._end = self._file.tell()
        self._slots = dict(s["slots"])
        self._acc = dict(s["acc"])
        self._rec = 8 + (self.dim + 1) * 4 + 4
        self.rows = collections.OrderedDict()
        for rid in s["hot_ids"]:      # rewarm the previously-hot set
            self._row(rid)


class GraphTable:
    """Graph service table for GNN training (reference:
    distributed/table/common_graph_table.h + the graph PS service
    graph_brpc_server.h — node/edge storage with weighted random
    neighbor sampling and node features; reduced: in-memory adjacency,
    same id%n_servers sharding as sparse tables)."""

    def __init__(self, feat_dim=0, seed=0):
        self.lock = threading.Lock()
        self.feat_dim = int(feat_dim)
        self._rs = np.random.RandomState(seed)
        self.adj = {}     # src -> (list of dst, list of weight)
        self.feats = {}   # node -> np.float32[feat_dim]

    def add_edges(self, src, dst, weights=None):
        src = np.asarray(src).reshape(-1)
        dst = np.asarray(dst).reshape(-1)
        w = (np.asarray(weights, np.float32).reshape(-1)
             if weights is not None else np.ones(len(src), np.float32))
        with self.lock:
            for s, d, wt in zip(src, dst, w):
                nbrs = self.adj.setdefault(int(s), ([], []))
                nbrs[0].append(int(d))
                nbrs[1].append(float(wt))

    def set_node_feat(self, ids, feats):
        ids = np.asarray(ids).reshape(-1)
        feats = np.asarray(feats, np.float32).reshape(len(ids),
                                                      self.feat_dim)
        with self.lock:
            for i, f in zip(ids, feats):
                self.feats[int(i)] = f.copy()

    def get_node_feat(self, ids):
        ids = np.asarray(ids).reshape(-1)
        with self.lock:
            return np.stack(
                [self.feats.get(int(i),
                                np.zeros(self.feat_dim, np.float32))
                 for i in ids], axis=0) if len(ids) else \
                np.zeros((0, self.feat_dim), np.float32)

    def sample_neighbors(self, ids, count):
        """Weighted-with-replacement neighbor sampling; nodes without
        edges get -1 padding (reference graph sampling semantics)."""
        ids = np.asarray(ids).reshape(-1)
        out = np.full((len(ids), count), -1, np.int64)
        with self.lock:
            for row, i in enumerate(ids):
                nbrs = self.adj.get(int(i))
                if not nbrs or not nbrs[0]:
                    continue
                d = np.asarray(nbrs[0], np.int64)
                w = np.asarray(nbrs[1], np.float64)
                p = w / w.sum()
                out[row] = self._rs.choice(d, size=count, replace=True,
                                           p=p)
        return out

    def random_nodes(self, count):
        with self.lock:
            pool = np.asarray(sorted(self.adj), np.int64)
        if len(pool) == 0:
            return np.zeros((0,), np.int64)
        return self._rs.choice(pool, size=min(count, len(pool)),
                               replace=False)

    def state(self):
        with self.lock:
            return {"feat_dim": self.feat_dim, "adj": dict(self.adj),
                    "feats": dict(self.feats),
                    "rs": self._rs.get_state()}

    def load_state(self, s):
        self.feat_dim = s["feat_dim"]
        self.adj = s["adj"]
        self.feats = s["feats"]
        self._rs.set_state(s["rs"])


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        server = self.server.ps  # type: PSServer
        while True:
            req = recv_msg(self.request)
            if req is None:
                return
            try:
                resp = server._dispatch(req)
            except Exception as e:  # noqa: BLE001 — serve errors to client
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            send_msg(self.request, resp)
            if req.get("cmd") == "stop":
                return


class _TCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class PSServer:
    """Reference: BrpcPsServer — start() binds and serves until stop().
    Tables are created by client request or locally."""

    def __init__(self, host="127.0.0.1", port=0):
        self._srv = _TCP((host, port), _Handler)
        self._srv.ps = self
        self.host, self.port = self._srv.server_address
        self.tables = {}
        self._shuffle = {}        # dest rank -> list of sample blobs
        self._shuffle_lock = threading.Lock()
        self._barrier_count = 0
        self._barrier_gen = 0
        self._barrier_cv = threading.Condition()
        self._thread = None

    # -- lifecycle --------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()

    def run(self):
        """Blocking serve (server-process entry, reference
        run_server)."""
        self._srv.serve_forever()

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self, req):
        cmd = req.get("cmd")
        if cmd == "create_dense":
            # first creation wins: concurrent trainers racing to create
            # the same table must NOT wipe each other's pushes
            if req["table_id"] not in self.tables:
                self.tables[req["table_id"]] = DenseTable(
                    req.get("shape"),
                    optimizer=req.get("optimizer", "sgd"),
                    lr=req.get("lr", 0.01), init=req.get("init"),
                    seed=req.get("seed", 0))
                return {"ok": True, "created": True}
            return {"ok": True, "created": False}
        if cmd == "create_sparse":
            if req["table_id"] not in self.tables:
                if req.get("ssd"):
                    # an explicit path is broadcast to every server:
                    # give each shard its own subdir or they would
                    # overwrite each other's record slots
                    path = req.get("path")
                    if path is not None:
                        path = os.path.join(path, f"shard_{self.port}")
                    self.tables[req["table_id"]] = SSDSparseTable(
                        req["dim"], optimizer=req.get("optimizer", "sgd"),
                        lr=req.get("lr", 0.01), seed=req.get("seed", 0),
                        cache_rows=req.get("cache_rows", 4096),
                        path=path)
                else:
                    self.tables[req["table_id"]] = SparseTable(
                        req["dim"], optimizer=req.get("optimizer", "sgd"),
                        lr=req.get("lr", 0.01), seed=req.get("seed", 0))
                return {"ok": True, "created": True}
            return {"ok": True, "created": False}
        if cmd == "create_graph":
            if req["table_id"] not in self.tables:
                self.tables[req["table_id"]] = GraphTable(
                    feat_dim=req.get("feat_dim", 0),
                    seed=req.get("seed", 0))
                return {"ok": True, "created": True}
            return {"ok": True, "created": False}
        if cmd == "graph_add_edges":
            self.tables[req["table_id"]].add_edges(
                req["src"], req["dst"], req.get("weights"))
            return {"ok": True}
        if cmd == "graph_set_feat":
            self.tables[req["table_id"]].set_node_feat(req["ids"],
                                                       req["feats"])
            return {"ok": True}
        if cmd == "graph_get_feat":
            return {"ok": True,
                    "feats": self.tables[req["table_id"]].get_node_feat(
                        req["ids"])}
        if cmd == "graph_sample":
            return {"ok": True,
                    "neighbors": self.tables[
                        req["table_id"]].sample_neighbors(
                        req["ids"], req["count"])}
        if cmd == "graph_random_nodes":
            return {"ok": True,
                    "nodes": self.tables[req["table_id"]].random_nodes(
                        req["count"])}
        if cmd == "pull_dense":
            return {"ok": True, "value": self.tables[req["table_id"]].pull()}
        if cmd == "push_dense":
            self.tables[req["table_id"]].push(req["grad"])
            return {"ok": True}
        if cmd == "set_dense":
            self.tables[req["table_id"]].set(req["value"])
            return {"ok": True}
        if cmd == "pull_sparse":
            return {"ok": True,
                    "rows": self.tables[req["table_id"]].pull(req["ids"])}
        if cmd == "push_sparse":
            self.tables[req["table_id"]].push(req["ids"], req["grads"])
            return {"ok": True}
        if cmd == "save":
            state = {tid: t.state() for tid, t in self.tables.items()}
            kinds = {tid: type(t).__name__ for tid, t in self.tables.items()}
            import pickle
            with open(req["path"], "wb") as f:
                pickle.dump({"state": state, "kinds": kinds}, f)
            return {"ok": True}
        if cmd == "load":
            import pickle
            with open(req["path"], "rb") as f:
                data = pickle.load(f)
            for tid, s in data["state"].items():
                cls = {"DenseTable": DenseTable,
                       "SparseTable": SparseTable,
                       "SSDSparseTable": SSDSparseTable,
                       "GraphTable": GraphTable}[
                    data["kinds"][tid]]
                t = cls.__new__(cls)
                t.lock = threading.Lock()
                if cls is not DenseTable:
                    t._rs = np.random.RandomState(0)
                t.load_state(s)
                self.tables[tid] = t
            return {"ok": True}
        if cmd == "barrier":
            n = req["trainers"]
            timeout = float(req.get("timeout", 60.0))
            with self._barrier_cv:
                gen = self._barrier_gen
                self._barrier_count += 1
                if self._barrier_count >= n:
                    self._barrier_count = 0
                    self._barrier_gen += 1
                    self._barrier_cv.notify_all()
                    return {"ok": True}
                released = self._barrier_cv.wait_for(
                    lambda: self._barrier_gen != gen, timeout=timeout)
                if not released:
                    # roll back so a retry doesn't count this waiter twice
                    self._barrier_count = max(0, self._barrier_count - 1)
                    return {"ok": False,
                            "error": f"barrier timeout after {timeout}s "
                                     f"waiting for {n} trainers"}
            return {"ok": True}
        if cmd == "shuffle_put":
            # global-shuffle exchange (reference: InMemoryDataFeed
            # GlobalShuffle over brpc channels, data_feed.h:395): workers
            # deposit sample blobs addressed to a destination rank
            with self._shuffle_lock:
                self._shuffle.setdefault(req["dest"], []).extend(
                    req["blobs"])
            return {"ok": True}
        if cmd == "shuffle_take":
            with self._shuffle_lock:
                blobs = self._shuffle.pop(req["rank"], [])
            return {"ok": True, "blobs": blobs}
        if cmd == "stop":
            threading.Thread(target=self.stop, daemon=True).start()
            return {"ok": True}
        if cmd == "ping":
            return {"ok": True, "tables": sorted(self.tables)}
        raise ValueError(f"unknown command {cmd!r}")


def run_server_forever(host="127.0.0.1", port=0, ready_file=None):
    """Server-process entry: binds, optionally writes 'host:port' to
    ready_file, serves until stop (reference: the listen_and_serv op)."""
    srv = PSServer(host, port)
    if ready_file:
        tmp = ready_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{srv.host}:{srv.port}")
        os.rename(tmp, ready_file)
    srv.run()
