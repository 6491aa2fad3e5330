"""Elastic training manager (a port of
``paddle_tpu/distributed/fleet/elastic.py``).

Reference parity: python/paddle/distributed/fleet/elastic.py:101
ElasticManager — a node registry (etcd3 there, :144-147), membership
watchers both ways (:173-206), relaunch of the local processes with the
new endpoints; the launcher's child monitoring
(LauncherInterface._check_procs :75).

The registry is the reference's shared-directory heartbeat store
(``FileStore``: a file a node, expired after ``ttl`` seconds), under the
temporary directory unless a root is given. On a change of membership
the callback runs; ``relaunch`` kills the children and starts the
command again with the new world (``PADDLE_TRAINERS_NUM``, a fresh
``PADDLE_TRAINER_ENDPOINTS`` rendezvous and each node's id in
``PADDLE_ELASTIC_WORLD``), and ``reinit_process_group`` re-forms the
process group of a running process (``init_parallel_env`` again over the
new rank, world and endpoints). A resumed run restores its train state
from a sharded checkpoint (``incubate.checkpoint``), which re-shards
onto the new world.
"""
import json
import os
import signal
import subprocess
import threading
import time


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class FileStore:
    """Heartbeat registry on a shared filesystem (etcd stand-in)."""

    def __init__(self, root, ttl=10.0):
        self.root = root
        self.ttl = ttl
        os.makedirs(root, exist_ok=True)

    def register(self, node_id, info=None):
        path = os.path.join(self.root, f"{node_id}.hb")
        with open(path, "w") as f:
            json.dump({"ts": time.time(), "info": info or {}}, f)

    def heartbeat(self, node_id):
        self.register(node_id)

    def alive_nodes(self):
        now = time.time()
        nodes = []
        for fn in os.listdir(self.root):
            if not fn.endswith(".hb"):
                continue
            try:
                with open(os.path.join(self.root, fn)) as f:
                    data = json.load(f)
                if now - data["ts"] <= self.ttl:
                    nodes.append(fn[:-3])
            except (OSError, ValueError):
                continue
        return sorted(nodes)

    def deregister(self, node_id):
        try:
            os.remove(os.path.join(self.root, f"{node_id}.hb"))
        except OSError:
            pass


class ElasticManager:
    def __init__(self, node_id=None, store=None, store_root=None,
                 heartbeat_interval=2.0, on_membership_change=None):
        self.node_id = node_id or f"node-{os.getpid()}"
        if store is None:
            import tempfile
            store = FileStore(store_root or os.path.join(
                tempfile.gettempdir(), "paddle_tpu_torch_elastic"))
        self.store = store
        self.interval = heartbeat_interval
        self.on_membership_change = on_membership_change
        self._members = []
        self._stop = threading.Event()
        self._thread = None
        self._procs = []

    # -- membership --------------------------------------------------------
    def start(self):
        self.store.register(self.node_id)
        self._members = self.store.alive_nodes()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self._members

    def _loop(self):
        while not self._stop.is_set():
            self.store.heartbeat(self.node_id)
            current = self.store.alive_nodes()
            if current != self._members:
                old, self._members = self._members, current
                if self.on_membership_change is not None:
                    self.on_membership_change(old, current)
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.store.deregister(self.node_id)

    def world(self):
        return list(self._members)

    # -- child process supervision (launcher role) ------------------------
    def launch(self, cmd, env=None):
        e = dict(os.environ)
        if env:
            e.update(env)
        p = subprocess.Popen(cmd, env=e)
        self._procs.append(p)
        return p

    def check_procs(self):
        """Reference: LauncherInterface._check_procs — returns
        (all_done, failed_list)."""
        failed = []
        alive = False
        for p in self._procs:
            rc = p.poll()
            if rc is None:
                alive = True
            elif rc != 0:
                failed.append((p.pid, rc))
        return (not alive), failed

    def kill_children(self):
        for p in self._procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 10
        for p in self._procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
        self._procs = []

    def relaunch(self, cmd, env=None):
        """Membership changed: kill the children, start ``cmd`` again with
        the new world (reference relaunch with new
        DISTRIBUTED_TRAINER_ENDPOINTS)."""
        self.kill_children()
        world = self.world()
        from ..parallel import _free_port
        e = {"PADDLE_ELASTIC_WORLD": ",".join(world),
             "PADDLE_TRAINERS_NUM": str(len(world)),
             "PADDLE_TRAINER_ENDPOINTS": f"127.0.0.1:{_free_port()}"}
        if env:
            e.update(env)
        return self.launch(cmd, env=e)


def reinit_process_group(rank, world, endpoints, backend=None, timeout=60):
    """Leave the current process group and join a new one as ``rank`` of
    ``world`` over ``endpoints`` (``"host:port,..."``, the first the
    rendezvous); the groups and the hybrid topology of the old one are
    forgotten."""
    import torch.distributed as dist
    from .. import collective, topology
    from ..parallel import init_parallel_env
    if dist.is_initialized():
        dist.destroy_process_group()
    collective.reset()
    topology.reset()
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      PADDLE_TRAINER_ENDPOINTS=endpoints)
    return init_parallel_env(backend=backend, timeout=timeout)
