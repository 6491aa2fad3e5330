"""Elastic recovery of a collective job in the port (fleet/elastic.py,
launch_mod, incubate.checkpoint), the reference's
tests/test_elastic_collective.py flow over gloo rank processes
(tests/torch_elastic_worker.py):

* a 2-rank job trains (AdamW; the data-parallel mean over one global
  batch, so the losses do not depend on the world size), saving its whole
  train state after every step and heartbeating into the ElasticManager's
  FileStore;
* shrink: rank 1 is SIGKILLed; its heartbeat expires in the store; the
  survivor is torn down (it would wait forever in its next collective);
  a 1-rank world resumes from the newest checkpoint: parameters and Adam
  moments restored, the next step's;
* grow: a node joins the store, the watcher sees the change, and a
  2-rank world resumes from the 1-rank world's checkpoint;

every logged loss of the three worlds is the uninterrupted run's at its
step (one process, the whole batch).

And the launcher starts ranks: ``launch_mod.spawn`` with the launcher's
variables, ``reinit_process_group`` re-forming a world, and ``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node 2`` (its exit code a
failed rank's). About 90 s (each rank process imports the port).
Tolerance: losses rtol 1e-5.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from paddle_tpu_torch.distributed import launch_mod
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                        FileStore)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_elastic_worker.py")


def _read_log(path):
    out = []
    if os.path.exists(path):
        for line in open(path):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass            # a line torn by the kill
    return out


def _steps(log, rank=0):
    return {e["step"]: e["loss"] for e in _read_log(log)
            if e["event"] == "step" and e["rank"] == rank}


def _wait(cond, timeout, procs, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        dead = [p for p in procs if p.poll() not in (None, 0)]
        if dead:
            raise AssertionError(f"{what}: a rank died:\n"
                                 + dead[0].communicate()[1][-3000:])
        time.sleep(0.2)
    raise AssertionError(f"{what}: timed out")


def _trajectory(steps):
    """The uninterrupted run in one process: the losses of every step."""
    import torch
    from paddle_tpu_torch import optimizer
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 1))
    opt = optimizer.AdamW(1e-2, parameters=model.named_parameters())
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(8, 8).astype(np.float32))
    y = torch.from_numpy(rs.randn(8, 1).astype(np.float32))
    out = {}
    for step in range(1, steps + 1):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        out[step] = loss.item()
    return out


def test_collective_kill_detect_relaunch_resume(tmp_path):
    ckpt, store_root = str(tmp_path / "ckpt"), str(tmp_path / "store")
    os.makedirs(ckpt)
    log = str(tmp_path / "train.log")
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def world(n, logfile):
        ep = f"127.0.0.1:{launch_mod._free_port()}"
        return [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(n), ep, ckpt, store_root,
             logfile], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True) for r in range(n)]

    store = FileStore(store_root, ttl=2.0)
    procs = world(2, log)
    try:
        _wait(lambda: len(_steps(log)) >= 4, 120, procs, "phase 1")
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait()
        deadline = time.time() + 30
        while "w1" in store.alive_nodes() and time.time() < deadline:
            time.sleep(0.2)
        assert "w1" not in store.alive_nodes(), "the heartbeat never expired"
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait()
        first = _steps(log)
        resume = int(open(os.path.join(ckpt, "latest.txt")).read())
        assert resume >= 4
        # shrink: one rank resumes
        log2 = str(tmp_path / "train2.log")
        procs = world(1, log2)
        _wait(lambda: len(_steps(log2)) >= 3, 120, procs, "phase 2")
        start = [e for e in _read_log(log2) if e["event"] == "start"][0]
        assert (start["world"], start["resumed_from"]) == (1, resume)
        second = _steps(log2)
        assert min(second) == resume + 1
        # grow: a node joins; the watcher sees it, the world is relaunched
        seen = []
        watcher = ElasticManager(node_id="launcher", store=store,
                                 heartbeat_interval=0.2,
                                 on_membership_change=lambda old, new:
                                 seen.append(new))
        watcher.start()
        store.register("w-joiner")
        deadline = time.time() + 10
        while not any("w-joiner" in m for m in seen) \
                and time.time() < deadline:
            time.sleep(0.1)
        assert any("w-joiner" in m for m in seen)
        watcher.stop()
        for p in procs:
            p.send_signal(signal.SIGKILL)
            p.wait()
        resume2 = int(open(os.path.join(ckpt, "latest.txt")).read())
        log3 = str(tmp_path / "train3.log")
        procs = world(2, log3)
        _wait(lambda: len(_steps(log3)) >= 3, 120, procs, "phase 3")
        start = [e for e in _read_log(log3) if e["event"] == "start"][0]
        assert (start["world"], start["resumed_from"]) == (2, resume2)
        third = _steps(log3)
        assert min(third) == resume2 + 1
        want = _trajectory(max(third))
        for run in (first, second, third):
            for s, loss in run.items():
                np.testing.assert_allclose(loss, want[s], rtol=1e-5,
                                           err_msg=f"step {s}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_spawn_starts_the_ranks(tmp_path):
    """spawn(func, args, nprocs=2): two processes by the spawn start
    method, each with PADDLE_TRAINER_ID / TRAINERS_NUM / ENDPOINTS /
    CURRENT_ENDPOINT, forming one gloo world."""
    sys.path.insert(0, HERE)
    import torch_elastic_worker
    launch_mod.spawn(torch_elastic_worker.spawn_target,
                     args=(str(tmp_path),), nprocs=2)
    got = [json.load(open(tmp_path / f"spawn{r}.json")) for r in range(2)]
    assert [g["rank"] for g in got] == [0, 1]
    assert all(g["world"] == 2 and g["sum"] == 3.0 for g in got)
    assert got[0]["endpoint"] != got[1]["endpoint"]


def test_reinit_process_group_reforms_the_world(tmp_path):
    """Two ranks all-reduce, leave their process group and join a new one
    at another endpoint with their ranks swapped
    (elastic.reinit_process_group), and all-reduce there."""
    sys.path.insert(0, HERE)
    import torch_elastic_worker
    ep = f"127.0.0.1:{launch_mod._free_port()}"
    launch_mod.spawn(torch_elastic_worker.spawn_reinit_target,
                     args=(str(tmp_path), ep), nprocs=2)
    got = [json.load(open(tmp_path / f"reinit{r}.json")) for r in range(2)]
    assert [(g["first"], g["second"]) for g in got] == [(0, 1), (1, 0)]
    assert all(g["sum"] == 3.0 and g["max"] == 20.0 for g in got)


_LAUNCHED = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from paddle_tpu_torch.distributed import collective, env, init_parallel_env
init_parallel_env(backend="gloo", timeout=60)
x = torch.tensor([float(env.get_rank() + 1)])
collective.all_reduce(x)
out = {{k: os.environ[k] for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                                  "PADDLE_TRAINER_ENDPOINTS",
                                  "PADDLE_CURRENT_ENDPOINT")}}
out["sum"] = float(x)
with open(os.path.join({outdir!r}, f"rank{{env.get_rank()}}.json"), "w") as f:
    json.dump(out, f)
if env.get_rank() == 1 and len(sys.argv) > 1:
    sys.exit(int(sys.argv[1]))
"""


def test_launcher_collective_mode(tmp_path):
    """python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
    script.py: two ranks with the launcher's variables (an endpoint a
    rank, rank 0's the rendezvous) forming one gloo world; a rank's
    non-zero exit is the launcher's."""
    script = tmp_path / "job.py"
    script.write_text(_LAUNCHED.format(repo=os.path.dirname(HERE),
                                       outdir=str(tmp_path)))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", str(script)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cwd = os.path.dirname(HERE)
    assert subprocess.run(cmd, cwd=cwd, env=env, timeout=120).returncode == 0
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    eps = got[0]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == 2 and got[1]["PADDLE_TRAINER_ENDPOINTS"] == ",".join(
        eps)
    for r, g in enumerate(got):
        assert (g["PADDLE_TRAINER_ID"], g["PADDLE_TRAINERS_NUM"]) == (
            str(r), "2")
        assert g["PADDLE_CURRENT_ENDPOINT"] == eps[r]
        assert g["sum"] == 3.0
    assert subprocess.run(cmd + ["3"], cwd=cwd, env=env,
                          timeout=120).returncode == 3
