"""The port's parameter server (distributed/ps, fleet's parameter-server
mode, the launcher's PS cluster, fleet.util) against the reference's
(tests/test_ps_service.py's scenarios).

The wire is the reference's (length-prefixed pickle of numpy), so the
port's client runs every table scenario against a server of each package
(the ``cluster`` fixture, in-process threads): dense and sparse tables
sharded over two servers, save/load, the async and geo communicators,
the barrier and its timeout, empty pulls, the sparse rng stream. Then
processes on 127.0.0.1: port trainer processes against reference server
processes and a reference trainer against a port server process, fleet's
PS lifecycle (init_server/run_server, init_worker/stop_worker), the
port's launcher (``--server_num 1 --worker_num 2``) and util.all_reduce's
sum/min/max between its workers, and the global shuffle of two datasets
through the servers. About 60 s (each process imports its package).
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.ps import server as ref_server

from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed.ps import (AsyncCommunicator,
                                             GeoCommunicator, PSClient)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVERS = {"port": ps.PSServer, "reference": ref_server.PSServer}


@pytest.fixture(params=sorted(SERVERS))
def cluster(request):
    servers = [SERVERS[request.param]().start() for _ in range(2)]
    eps = [f"{s.host}:{s.port}" for s in servers]
    client = PSClient(eps)
    yield client, eps
    client.close()
    for s in servers:
        s.stop()


def test_dense_pull_push(cluster):
    client, _ = cluster
    client.create_dense_table("w", shape=(4, 3), optimizer="sgd", lr=1.0,
                              init=np.ones((4, 3)))
    np.testing.assert_allclose(client.pull_dense("w"), np.ones((4, 3)))
    client.push_dense("w", torch.full((4, 3), 0.5).numpy())
    np.testing.assert_allclose(client.pull_dense("w"),
                               0.5 * np.ones((4, 3)))


def test_sparse_rows_sharded_across_servers(cluster):
    client, _ = cluster
    client.create_sparse_table("emb", dim=4, lr=1.0)
    ids = np.asarray([0, 1, 2, 3, 10, 11])
    before = client.pull_sparse("emb", ids)
    client.push_sparse("emb", ids[:2], np.ones((2, 4), np.float32))
    after = client.pull_sparse("emb", ids)
    np.testing.assert_allclose(after[:2], before[:2] - 1.0, rtol=1e-6)
    np.testing.assert_allclose(after[2:], before[2:], rtol=1e-6)
    for s in (0, 1):
        assert "emb" in client._call(s, {"cmd": "ping"})["tables"]


def test_server_state_save_load(cluster, tmp_path):
    client, _ = cluster
    client.create_dense_table("d", shape=(2, 2), init=np.eye(2))
    client.create_sparse_table("s", dim=3)
    client.push_sparse("s", [7], np.ones((1, 3), np.float32))
    row = client.pull_sparse("s", [7])
    path = str(tmp_path / "ps_state")
    client.save(path)
    client.push_dense("d", np.ones((2, 2)))
    client.push_sparse("s", [7], np.ones((1, 3), np.float32))
    client.load(path)
    np.testing.assert_allclose(client.pull_dense("d"), np.eye(2))
    np.testing.assert_allclose(client.pull_sparse("s", [7]), row)


def test_async_communicator_merges(cluster):
    client, _ = cluster
    client.create_dense_table("g", shape=(3,), optimizer="sum",
                              init=np.zeros(3))
    comm = AsyncCommunicator(client, max_merge_var_num=8).start()
    for _ in range(20):
        comm.send_dense("g", np.ones(3, np.float32))
    comm.flush()
    np.testing.assert_allclose(client.pull_dense("g"), 20 * np.ones(3))
    comm.stop()


def test_geo_communicator_two_trainers(cluster):
    client, eps = cluster
    client.create_dense_table("geo", shape=(4,), optimizer="sum",
                              init=np.zeros(4))
    c1, c2 = PSClient(eps), PSClient(eps)
    g1, g2 = GeoCommunicator(c1, k_steps=2), GeoCommunicator(c2, k_steps=2)
    g1.init_dense("geo")
    g2.init_dense("geo")
    for _ in range(4):
        g1.local_update("geo", np.ones(4, np.float32), lr=0.5)
        g2.local_update("geo", -np.ones(4, np.float32), lr=0.25)
    g1.flush()
    g2.flush()
    np.testing.assert_allclose(client.pull_dense("geo"), -np.ones(4),
                               rtol=1e-5)
    c1.close()
    c2.close()


def test_barrier_across_clients_and_timeout(cluster):
    client, eps = cluster
    with pytest.raises(RuntimeError, match="barrier timeout"):
        client._call(0, {"cmd": "barrier", "trainers": 2, "timeout": 0.3})
    other = PSClient(eps)
    order = []
    t = threading.Thread(target=lambda: (other.barrier(2),
                                         order.append("b")))
    t.start()
    time.sleep(0.2)
    assert not order        # the timed-out waiter was rolled back
    client.barrier(2)
    t.join(timeout=10)
    assert order == ["b"]
    other.close()


def test_pull_sparse_empty_ids_and_rng_stream(cluster, tmp_path):
    client, _ = cluster
    client.create_sparse_table("e2", dim=3, seed=7)
    assert client.pull_sparse("e2", np.asarray([], np.int64)).shape == (0, 3)
    client.push_sparse("e2", np.asarray([], np.int64),
                       np.zeros((0, 3), np.float32))
    before = client.pull_sparse("e2", [0])
    client.save(str(tmp_path / "rng"))
    client.load(str(tmp_path / "rng"))
    assert not np.allclose(client.pull_sparse("e2", [2]), before)
    np.testing.assert_allclose(client.pull_sparse("e2", [0]), before)


def test_ps_embedding_trains_remotely(cluster):
    """PSEmbedding's torch rows: pulled, a linear layer, the rows' grads
    pushed to the servers (SGD there), the layer by the port's SGD."""
    from paddle_tpu_torch import optimizer
    client, _ = cluster
    client.create_sparse_table("vocab", dim=4, lr=0.5)
    emb = ps.PSEmbedding(client, "vocab", dim=4, device="cpu")
    fc = torch.nn.Linear(4, 1)
    opt = optimizer.SGD(0.1, parameters=fc.parameters())
    ids = torch.tensor([1, 5, 9])
    losses = []
    for _ in range(6):
        loss = (fc(emb(ids)) ** 2).mean()
        loss.backward()
        emb.apply_push()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    assert losses[-1] < losses[0]


def test_global_shuffle_across_workers(cluster, tmp_path):
    from paddle_tpu_torch.distributed.fleet.dataset import InMemoryDataset
    _, eps = cluster

    def make_ds(values):
        p = tmp_path / f"part_{values[0]}.txt"
        p.write_text("".join(f"1 {v}\n" for v in values))
        ds = InMemoryDataset()
        ds.init(batch_size=1, thread_num=1)
        ds.set_filelist([str(p)])
        ds.load_into_memory()
        return ds

    ds0, ds1 = make_ds(range(0, 8)), make_ds(range(100, 108))
    t = threading.Thread(target=lambda: ds1.global_shuffle(
        ps_endpoints=eps, rank=1, world=2, seed=123))
    t.start()
    ds0.global_shuffle(ps_endpoints=eps, rank=0, world=2, seed=123)
    t.join(timeout=60)
    v0 = sorted(int(v) for v in ds0._slots[0][0])
    v1 = sorted(int(v) for v in ds1._slots[0][0])
    assert sorted(v0 + v1) == list(range(0, 8)) + list(range(100, 108))
    assert any(v >= 100 for v in v0) or any(v < 100 for v in v1)


def _wait_files(paths, timeout=90):
    deadline = time.time() + timeout
    while time.time() < deadline and not all(os.path.exists(p)
                                             for p in paths):
        time.sleep(0.1)
    return [open(p).read().strip() for p in paths]


_REF_TRAINER = r"""
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from paddle_tpu.distributed.ps import AsyncCommunicator, PSClient
rank, eps, steps = int(sys.argv[1]), sys.argv[2].split(","), int(sys.argv[3])
client = PSClient(eps)
client.barrier(2)
comm = AsyncCommunicator(client, max_merge_var_num=4).start()
for i in range(steps):
    client.pull_dense("w")
    comm.send_dense("w", np.full((4,), 1.0, np.float32))
    comm.send_sparse("emb", np.asarray([rank, 2 + rank, 4 + rank]),
                     np.ones((3, 2), np.float32))
comm.stop()
client.barrier(2)
client.close()
"""

_PORT_TRAINER = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed.ps import (AsyncCommunicator, PSClient,
                                             PSEmbedding)
rank, eps, steps = int(sys.argv[1]), sys.argv[2].split(","), int(sys.argv[3])
client = PSClient(eps)
client.barrier(2)
comm = AsyncCommunicator(client, max_merge_var_num=4).start()
emb = PSEmbedding(client, "emb", 2, communicator=comm, device="cpu")
for i in range(steps):
    client.pull_dense("w")
    comm.send_dense("w", np.full((4,), 1.0, np.float32))
    rows = emb(torch.tensor([rank, 2 + rank, 4 + rank]))
    rows.sum().backward()
    emb.apply_push()
comm.stop()
client.barrier(2)
client.close()
"""


@pytest.mark.parametrize("servers,trainers", [("reference", "port"),
                                              ("port", "reference")])
def test_trainer_processes_against_server_processes(tmp_path, servers,
                                                    trainers):
    """Two trainer processes of one package against two server processes
    of the other, over loopback: 2 x steps pushes of ones summed into the
    dense table, the sparse rows moved by their grads."""
    mod = "paddle_tpu" if servers == "reference" else "paddle_tpu_torch"
    ready = [str(tmp_path / f"srv{i}.ep") for i in range(2)]
    procs = [subprocess.Popen([
        sys.executable, "-c",
        f"import sys; sys.path.insert(0, {REPO!r}); "
        f"from {mod}.distributed.ps.server import run_server_forever; "
        f"run_server_forever(ready_file={rf!r})"]) for rf in ready]
    try:
        eps = _wait_files(ready)
        boot = PSClient(eps)
        boot.create_dense_table("w", shape=(4,), optimizer="sum",
                                init=np.zeros(4))
        boot.create_sparse_table("emb", dim=2, lr=1.0)
        before = boot.pull_sparse("emb", np.asarray([0, 1]))
        script = str(tmp_path / "trainer.py")
        text = (_PORT_TRAINER if trainers == "port" else _REF_TRAINER
                ).format(repo=REPO)
        with open(script, "w") as f:
            f.write(text)
        steps = 5
        env = dict(os.environ, OMP_NUM_THREADS="1")
        tr = [subprocess.Popen([sys.executable, script, str(r),
                                ",".join(eps), str(steps)], env=env)
              for r in range(2)]
        for t in tr:
            assert t.wait(timeout=120) == 0
        np.testing.assert_allclose(boot.pull_dense("w"),
                                   2 * steps * np.ones(4))
        np.testing.assert_allclose(boot.pull_sparse("emb", [0, 1]),
                                   before - steps, rtol=1e-5)
        boot.stop_servers()
        boot.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


_FLEET_SCRIPT = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import (PaddleCloudRoleMaker,
                                                DistributedStrategy, util)

strategy = DistributedStrategy()
strategy.a_sync = True
fleet.init(PaddleCloudRoleMaker(), strategy=strategy)
if fleet.is_server():
    fleet.init_server()
    fleet.run_server()
else:
    client = fleet.init_worker()
    me = fleet.worker_index()
    if me == 0:
        client.create_dense_table("w", shape=(2,), optimizer="sum",
                                  init=np.zeros(2))
    fleet.barrier_worker()
    fleet.communicator().send_dense("w", np.ones(2, np.float32))
    fleet.communicator().flush()
    fleet.barrier_worker()
    arr = np.asarray([1.0 + me, 10.0 - me], np.float32)
    lo = util.all_reduce(arr, mode="min")
    hi = util.all_reduce(arr, mode="max")
    tot = util.all_reduce(arr, mode="sum")
    if me == 0:
        total = client.pull_dense("w")
        with open({marker!r}, "w") as f:
            f.write(",".join(str(float(v)) for v in
                             [float(total.sum())] + list(lo) + list(hi)
                             + list(tot)))
    fleet.stop_worker()
"""


def test_launcher_ps_cluster_with_fleet_and_util(tmp_path):
    """python -m paddle_tpu_torch.distributed.launch --server_num 1
    --worker_num 2 script.py: the same script runs as the server
    (fleet.init_server/run_server) or a trainer (init_worker, the a_sync
    communicator, barrier_worker, util.all_reduce) by the launcher's
    variables; the launcher ends the server when the trainers are done."""
    marker = str(tmp_path / "result.txt")
    script = tmp_path / "ps_script.py"
    script.write_text(_FLEET_SCRIPT.format(repo=REPO, marker=marker))
    rc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--server_num", "1", "--worker_num", "2", str(script)],
        cwd=REPO, timeout=180,
        env=dict(os.environ, OMP_NUM_THREADS="1")).returncode
    assert rc == 0
    vals = [float(v) for v in open(marker).read().split(",")]
    # two workers pushed ones(2) into a sum table: 4; the arrays [1, 10]
    # and [2, 9]: min [1, 9], max [2, 10], sum [3, 19]
    assert vals == [4.0, 1.0, 9.0, 2.0, 10.0, 3.0, 19.0], vals


def test_launcher_argument_errors():
    """The reference's refusals: PS and collective modes together, a
    multi-node job without a rendezvous; exit code 1 with the message."""
    for args in (["--server_num", "1", "--nproc_per_node", "2", "x.py"],
                 ["--nnodes", "2", "x.py"]):
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             *args], cwd=REPO, timeout=120, capture_output=True, text=True)
        assert proc.returncode == 1
        assert "--" in proc.stderr


def test_data_generator_formats_match_reference(tmp_path):
    from paddle_tpu.distributed.fleet import data_generator as ref_gen
    from paddle_tpu_torch.distributed.fleet import data_generator as gen
    from paddle_tpu_torch.distributed.fleet.dataset import InMemoryDataset
    src = tmp_path / "raw.txt"
    src.write_text("1\n2\n3\n")
    texts = []
    for mod in (gen, ref_gen):
        class Gen(mod.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def it():
                    v = int(line.strip())
                    yield [("feat", [v, v + 1]), ("label", [v % 2])]
                return it

        class SGen(mod.MultiSlotStringDataGenerator):
            def generate_sample(self, line):
                def it():
                    yield [("words", line.strip().split())]
                return it
        out, out2 = tmp_path / f"{mod.__name__}.a", \
            tmp_path / f"{mod.__name__}.b"
        g = Gen()
        g.set_batch(2)
        g.run_from_files([str(src)], str(out))
        SGen().run_from_files([str(src)], str(out2))
        texts.append((out.read_text(), out2.read_text()))
    assert texts[0] == texts[1]
    assert texts[0][0].splitlines()[0] == "2 1 2 1 1"
    ds = InMemoryDataset()
    ds.init(batch_size=1, thread_num=1)
    ds.set_filelist([str(tmp_path / f"{gen.__name__}.a")])
    ds.load_into_memory()
    assert ds.get_memory_data_size() == 3


def test_fleet_util_single_worker_and_fs(tmp_path):
    from paddle_tpu_torch.distributed.fleet import util, utils_fs
    files = [f"f{i}" for i in range(5)]
    assert util.get_file_shard(files) == files
    np.testing.assert_allclose(util.all_reduce(np.ones(3, np.float32)),
                               np.ones(3))
    util.barrier()
    fs = utils_fs.LocalFS()
    d = str(tmp_path / "a" / "b")
    fs.mkdirs(d)
    fs.touch(d + "/x")
    assert fs.is_dir(d) and fs.is_file(d + "/x")
    assert fs.ls_dir(str(tmp_path / "a")) == (["b"], [])
    with pytest.raises(utils_fs.ExecuteError, match="hadoop"):
        utils_fs.HDFSClient(hadoop_home=str(tmp_path / "nohadoop"))
