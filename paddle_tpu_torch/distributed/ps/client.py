"""PS client (a copy of ``paddle_tpu/distributed/ps/client.py``, numpy
over the shared wire): table sharding across servers + pull/push API.

Reference: paddle/fluid/distributed/service/brpc_ps_client.h — dense
params are range-split across servers; sparse rows are sharded by
id % n_servers (reference: SparseShard in table accessor).
"""
import threading

import numpy as np

from .rpc import connect, send_msg, recv_msg


class PSClient:
    def __init__(self, endpoints):
        """endpoints: list of 'host:port' strings."""
        self.endpoints = list(endpoints)
        self._socks = []
        self._locks = []
        self._executor = None
        self._sparse_dims = {}
        for ep in self.endpoints:
            host, port = ep.rsplit(":", 1)
            self._socks.append(connect(host, int(port)))
            self._locks.append(threading.Lock())

    @property
    def n_servers(self):
        return len(self._socks)

    def _call(self, server_idx, req):
        with self._locks[server_idx]:
            send_msg(self._socks[server_idx], req)
            resp = recv_msg(self._socks[server_idx])
        if resp is None:
            raise ConnectionError(
                f"PS server {self.endpoints[server_idx]} closed")
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "PS error"))
        return resp

    def _call_parallel(self, reqs):
        """Fan out {server_idx: req} concurrently — one network RTT
        instead of n_servers sequential RTTs (reference: the brpc
        client's async channel fan-out). Returns {server_idx: resp}."""
        if len(reqs) <= 1:
            return {i: self._call(i, r) for i, r in reqs.items()}
        from concurrent.futures import ThreadPoolExecutor
        ex = self._executor
        if ex is None:
            ex = self._executor = ThreadPoolExecutor(
                max_workers=max(2, self.n_servers))
        futs = {i: ex.submit(self._call, i, r) for i, r in reqs.items()}
        return {i: f.result() for i, f in futs.items()}

    def _all(self, req):
        out = self._call_parallel(
            {i: dict(req) for i in range(self.n_servers)})
        return [out[i] for i in range(self.n_servers)]

    # -- dense (replicated per server for simplicity of range bookkeeping:
    # each dense table lives on table_id % n_servers) ----------------------
    def _dense_home(self, table_id):
        # deterministic across processes (python str hash is seeded
        # per-process; every trainer must agree on the home server)
        import zlib
        return zlib.crc32(str(table_id).encode()) % self.n_servers

    def create_dense_table(self, table_id, shape=None, optimizer="sgd",
                           lr=0.01, init=None, seed=0):
        self._call(self._dense_home(table_id), {
            "cmd": "create_dense", "table_id": table_id, "shape": shape,
            "optimizer": optimizer, "lr": lr,
            "init": None if init is None else np.asarray(init),
            "seed": seed})

    def pull_dense(self, table_id):
        return self._call(self._dense_home(table_id),
                          {"cmd": "pull_dense",
                           "table_id": table_id})["value"]

    def push_dense(self, table_id, grad):
        self._call(self._dense_home(table_id),
                   {"cmd": "push_dense", "table_id": table_id,
                    "grad": np.asarray(grad)})

    def set_dense(self, table_id, value):
        self._call(self._dense_home(table_id),
                   {"cmd": "set_dense", "table_id": table_id,
                    "value": np.asarray(value)})

    # -- sparse (rows sharded id % n_servers) ------------------------------
    def create_sparse_table(self, table_id, dim, optimizer="sgd", lr=0.01,
                            seed=0, ssd=False, cache_rows=4096,
                            path=None):
        """ssd=True creates a disk-backed table on each server (reference
        ssd_sparse_table.h): at most cache_rows rows stay in RAM, the
        rest spill to a record file under `path` (server tempdir when
        None)."""
        self._sparse_dims[table_id] = int(dim)
        self._all({"cmd": "create_sparse", "table_id": table_id,
                   "dim": dim, "optimizer": optimizer, "lr": lr,
                   "seed": seed, "ssd": bool(ssd),
                   "cache_rows": int(cache_rows), "path": path})

    def pull_sparse(self, table_id, ids):
        ids = np.asarray(ids).reshape(-1)
        if len(ids) == 0:
            return np.zeros((0, self._sparse_dims.get(table_id, 0)),
                            np.float32)
        reqs, masks = {}, {}
        for s in range(self.n_servers):
            mask = (ids % self.n_servers) == s
            if mask.any():
                reqs[s] = {"cmd": "pull_sparse", "table_id": table_id,
                           "ids": ids[mask]}
                masks[s] = mask
        resps = self._call_parallel(reqs)
        out = np.zeros((len(ids),), dtype=object)
        for s, resp in resps.items():
            out[np.nonzero(masks[s])[0]] = list(resp["rows"])
        return np.stack(list(out), axis=0).astype(np.float32)

    def push_sparse(self, table_id, ids, grads):
        ids = np.asarray(ids).reshape(-1)
        if len(ids) == 0:
            return
        grads = np.asarray(grads, np.float32).reshape(len(ids), -1)
        reqs = {}
        for s in range(self.n_servers):
            mask = (ids % self.n_servers) == s
            if mask.any():
                reqs[s] = {"cmd": "push_sparse", "table_id": table_id,
                           "ids": ids[mask], "grads": grads[mask]}
        self._call_parallel(reqs)

    # -- graph service (GNN; reference graph_brpc_client.h) ----------------
    def create_graph_table(self, table_id, feat_dim=0, seed=0):
        self._graph_feat_dims = getattr(self, "_graph_feat_dims", {})
        self._graph_feat_dims[table_id] = int(feat_dim)
        self._all({"cmd": "create_graph", "table_id": table_id,
                   "feat_dim": feat_dim, "seed": seed})

    def graph_add_edges(self, table_id, src, dst, weights=None):
        src = np.asarray(src).reshape(-1)
        dst = np.asarray(dst).reshape(-1)
        w = np.asarray(weights, np.float32).reshape(-1) \
            if weights is not None else None
        reqs = {}
        for s in range(self.n_servers):
            mask = (src % self.n_servers) == s
            if mask.any():
                reqs[s] = {"cmd": "graph_add_edges",
                           "table_id": table_id, "src": src[mask],
                           "dst": dst[mask],
                           "weights": None if w is None else w[mask]}
        self._call_parallel(reqs)

    def graph_set_node_feat(self, table_id, ids, feats):
        ids = np.asarray(ids).reshape(-1)
        feats = np.asarray(feats, np.float32).reshape(len(ids), -1)
        reqs = {}
        for s in range(self.n_servers):
            mask = (ids % self.n_servers) == s
            if mask.any():
                reqs[s] = {"cmd": "graph_set_feat", "table_id": table_id,
                           "ids": ids[mask], "feats": feats[mask]}
        self._call_parallel(reqs)

    def graph_get_node_feat(self, table_id, ids):
        ids = np.asarray(ids).reshape(-1)
        dim = getattr(self, "_graph_feat_dims", {}).get(table_id, 0)
        if len(ids) == 0:
            return np.zeros((0, dim), np.float32)
        reqs, masks = {}, {}
        for s in range(self.n_servers):
            mask = (ids % self.n_servers) == s
            if mask.any():
                reqs[s] = {"cmd": "graph_get_feat", "table_id": table_id,
                           "ids": ids[mask]}
                masks[s] = mask
        resps = self._call_parallel(reqs)
        out = np.zeros((len(ids),), dtype=object)
        for s, resp in resps.items():
            out[np.nonzero(masks[s])[0]] = list(resp["feats"])
        return np.stack(list(out), axis=0).astype(np.float32)

    def graph_sample_neighbors(self, table_id, ids, count):
        """[len(ids), count] sampled neighbor ids; -1 pads isolated
        nodes. Rows are sharded to each src node's home server."""
        ids = np.asarray(ids).reshape(-1)
        if len(ids) == 0:
            return np.zeros((0, count), np.int64)
        reqs, masks = {}, {}
        for s in range(self.n_servers):
            mask = (ids % self.n_servers) == s
            if mask.any():
                reqs[s] = {"cmd": "graph_sample", "table_id": table_id,
                           "ids": ids[mask], "count": count}
                masks[s] = mask
        resps = self._call_parallel(reqs)
        out = np.full((len(ids), count), -1, np.int64)
        for s, resp in resps.items():
            out[np.nonzero(masks[s])[0]] = resp["neighbors"]
        return out

    def graph_random_nodes(self, table_id, count):
        resps = self._call_parallel(
            {s: {"cmd": "graph_random_nodes", "table_id": table_id,
                 "count": count} for s in range(self.n_servers)})
        pool = np.concatenate([r["nodes"] for r in resps.values()])
        # shuffle before truncating: a plain [:count] would sample only
        # from the first server's shard (even ids), biasing random walks
        return np.random.default_rng().permutation(pool)[:count]

    # -- global shuffle exchange ------------------------------------------
    def shuffle_put(self, dest, blobs):
        """Deposit sample blobs for `dest` rank (bucket homed on server
        dest % n_servers)."""
        self._call(dest % self.n_servers,
                   {"cmd": "shuffle_put", "dest": dest, "blobs": blobs})

    def shuffle_take(self, rank):
        return self._call(rank % self.n_servers,
                          {"cmd": "shuffle_take", "rank": rank})["blobs"]

    # -- control -----------------------------------------------------------
    def barrier(self, n_trainers):
        """Global barrier across trainers via server 0 (reference:
        BarrierTable)."""
        self._call(0, {"cmd": "barrier", "trainers": n_trainers})

    def save(self, path):
        self._call_parallel({i: {"cmd": "save",
                                 "path": f"{path}.server{i}"}
                             for i in range(self.n_servers)})

    def load(self, path):
        self._call_parallel({i: {"cmd": "load",
                                 "path": f"{path}.server{i}"}
                             for i in range(self.n_servers)})

    def ping(self):
        return self._all({"cmd": "ping"})

    def stop_servers(self):
        for i in range(self.n_servers):
            try:
                self._call(i, {"cmd": "stop"})
            except (ConnectionError, OSError):
                pass

    def close(self):
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
