"""One rank of the port's elastic test (tests/test_torch_elastic_collective.py).

    python tests/torch_elastic_worker.py RANK WORLD ENDPOINT CKPT STORE LOG

joins a gloo process group of WORLD ranks at ENDPOINT, heartbeats into
the ElasticManager's FileStore at STORE as node ``w{RANK}``, resumes from
the newest complete train-state checkpoint under CKPT (written by any
world size: incubate.checkpoint re-shards it) and trains a small MLP by
AdamW on its share of one global batch, averaging the grads over the
ranks (DataParallel), so the losses do not depend on the world size.
After each step it saves the train state and appends a JSON line to LOG.
``spawn_target`` is the function the test starts through
``launch_mod.spawn``.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

STEPS = 40


def spawn_target(outdir):
    """A rank started by launch_mod.spawn: all-reduce its rank + 1 over
    the world and write what it got."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import (collective, env,
                                              init_parallel_env)
    init_parallel_env(backend="gloo", timeout=60)
    x = torch.tensor([float(env.get_rank() + 1)])
    collective.all_reduce(x)
    with open(os.path.join(outdir, f"spawn{env.get_rank()}.json"), "w") as f:
        json.dump({"rank": env.get_rank(), "world": env.get_world_size(),
                   "sum": float(x), "endpoint":
                   os.environ["PADDLE_CURRENT_ENDPOINT"]}, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def spawn_reinit_target(outdir, endpoint):
    """A rank started by launch_mod.spawn: all-reduce in the world it was
    started in, then re-form the process group at ``endpoint`` with the
    ranks swapped (reinit_process_group) and all-reduce again."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import (collective, env,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed.fleet.elastic import \
        reinit_process_group
    init_parallel_env(backend="gloo", timeout=60)
    first = env.get_rank()
    x = torch.tensor([float(first + 1)])
    collective.all_reduce(x)
    reinit_process_group(1 - first, 2, endpoint, backend="gloo")
    y = torch.tensor([float(10 * (env.get_rank() + 1))])
    collective.all_reduce(y, op="max")
    with open(os.path.join(outdir, f"reinit{first}.json"), "w") as f:
        json.dump({"first": first, "second": env.get_rank(),
                   "sum": float(x), "max": float(y)}, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def main():
    rank, world, endpoint, ckpt, store, log = sys.argv[1:7]
    rank, world = int(rank), int(world)
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      PADDLE_TRAINER_ENDPOINTS=endpoint)
    torch.set_num_threads(1)
    import paddle_tpu_torch
    paddle_tpu_torch.set_device("cpu")
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import (DataParallel, collective,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                            FileStore)
    from paddle_tpu_torch.incubate.checkpoint import sharded
    init_parallel_env(backend="gloo", timeout=60)
    manager = ElasticManager(node_id=f"w{rank}",
                             store=FileStore(store, ttl=2.0),
                             heartbeat_interval=0.2)
    manager.start()
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 1))
    opt = optimizer.AdamW(1e-2, parameters=model.named_parameters())
    start = 0
    latest = os.path.join(ckpt, "latest.txt")
    if os.path.exists(latest):
        start = int(open(latest).read())
        sharded.load_sharded_train_state(
            os.path.join(ckpt, f"step{start}"),
            dict(model.named_parameters()), opt)
    dp = DataParallel(model)
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(8, 8).astype(np.float32))
    y = torch.from_numpy(rs.randn(8, 1).astype(np.float32))
    per = 8 // world
    mine = slice(rank * per, (rank + 1) * per)
    with open(log, "a") as f:
        f.write(json.dumps({"event": "start", "rank": rank, "world": world,
                            "resumed_from": start}) + "\n")
    for step in range(start + 1, STEPS + 1):
        loss = ((dp(x[mine]) - y[mine]) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        g = loss.detach().clone()
        collective.all_reduce(g, op="avg")
        path = os.path.join(ckpt, f"step{step}")
        sharded.save_sharded_train_state(dict(model.named_parameters()), opt,
                                         path)
        if rank == 0:
            with open(latest + ".tmp", "w") as f:
                f.write(str(step))
            os.replace(latest + ".tmp", latest)
        with open(log, "a") as f:
            f.write(json.dumps({"event": "step", "rank": rank, "step": step,
                                "loss": float(g)}) + "\n")
        time.sleep(0.3)
    manager.stop()


if __name__ == "__main__":
    main()
