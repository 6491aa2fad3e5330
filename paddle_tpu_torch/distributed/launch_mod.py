"""Launcher (a port of ``paddle_tpu/distributed/launch_mod.py``).

Reference parity: python/paddle/distributed/fleet/launch.py:396 (the
process launcher setting ``PADDLE_TRAINER_ID``/``ENDPOINTS`` for each
process) and python/paddle/distributed/spawn.py.

The port runs one rank a process, as Paddle does, so both start
processes: ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node N script.py ...`` runs the script N times with
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS`` (one ``127.0.0.1:port`` a rank, rank 0's the
rendezvous) and ``PADDLE_CURRENT_ENDPOINT``, the variables ``env`` and
``init_parallel_env`` read; ``--server_num/--worker_num`` runs a local
parameter-server cluster instead (``TRAINING_ROLE``,
``PADDLE_PSERVERS_IP_PORT_LIST``, ...). Its arguments and exit codes are
the reference's: a failed rank's code ends the job (the other ranks are
terminated: they would wait on it in their next collective).
``spawn(func, args, nprocs)`` starts ``nprocs`` processes by the
``spawn`` start method (never ``fork``: a forked CUDA context is not
usable) with the same variables, each calling ``func(*args)``. The
reference's ``spawn`` calls ``func`` once, its single controller driving
every chip; the port's starts the ranks, as Paddle's does.
"""
import os
import runpy
import sys


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank, endpoints):
    return {"PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(len(endpoints)),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank]}


def _spawn_entry(func, args, env):
    os.environ.update(env)
    func(*args)


class MultiprocessContext:
    """The processes ``spawn`` started; ``join()`` waits for them and
    raises when one failed (Paddle's MultiprocessContext)."""

    def __init__(self, processes):
        self.processes = processes

    def join(self, timeout=None):
        import time
        deadline = None if timeout is None else time.time() + timeout
        try:
            while any(p.is_alive() for p in self.processes):
                bad = [p.exitcode for p in self.processes
                       if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(f"a spawned rank exited {bad[0]}")
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError("spawned ranks still running")
                time.sleep(0.1)
            bad = [p.exitcode for p in self.processes if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"a spawned rank exited {bad[0]}")
        finally:
            for p in self.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return True


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run ``func(*args)`` in ``nprocs`` new processes (-1: one a card,
    or one without a card), rank ``i`` with the launcher's variables for
    ``i``; ``func`` must be importable (the ``spawn`` start method pickles
    it). With ``join`` wait for them (raising if one fails), else return
    the ``MultiprocessContext``."""
    import multiprocessing as mp
    if nprocs == -1:
        import torch
        nprocs = torch.cuda.device_count() if torch.cuda.is_available() \
            else 1
    eps = [f"127.0.0.1:{_free_port()}" for _ in range(nprocs)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spawn_entry,
                         args=(func, tuple(args), _rank_env(r, eps)),
                         daemon=daemon) for r in range(nprocs)]
    for p in procs:
        p.start()
    context = MultiprocessContext(procs)
    if join:
        context.join()
    return context


def _launch_ps_cluster(server_num, worker_num, script, script_args):
    """Reference fleet/launch.py PS mode: server processes
    (TRAINING_ROLE=PSERVER, POD_IP/PADDLE_PORT) and worker processes
    (TRAINING_ROLE=TRAINER, PADDLE_TRAINER_ID), all sharing
    PADDLE_PSERVERS_IP_PORT_LIST / PADDLE_TRAINER_ENDPOINTS; the servers
    are terminated when the workers are done."""
    import subprocess
    server_eps = [f"127.0.0.1:{_free_port()}" for _ in range(server_num)]
    worker_eps = [f"127.0.0.1:{_free_port()}" for _ in range(worker_num)]
    base = dict(os.environ)
    base["PADDLE_PSERVERS_IP_PORT_LIST"] = ",".join(server_eps)
    base["PADDLE_TRAINER_ENDPOINTS"] = ",".join(worker_eps)
    base["PADDLE_TRAINERS_NUM"] = str(worker_num)
    procs = []
    for ep in server_eps:
        env = dict(base)
        ip, port = ep.rsplit(":", 1)
        env.update(TRAINING_ROLE="PSERVER", POD_IP=ip, PADDLE_PORT=port)
        procs.append(("server", subprocess.Popen(
            [sys.executable, script] + script_args, env=env)))
    for i in range(worker_num):
        env = dict(base)
        env.update(TRAINING_ROLE="TRAINER", PADDLE_TRAINER_ID=str(i),
                   PADDLE_CURRENT_ENDPOINT=worker_eps[i])
        procs.append(("worker", subprocess.Popen(
            [sys.executable, script] + script_args, env=env)))
    rc = 0
    try:
        for kind, p in procs:
            if kind == "worker":
                rc = p.wait() or rc
    finally:
        _reap([p for _, p in procs])
    return rc


def _reap(procs):
    """SIGTERM, a bounded wait, then SIGKILL every process still
    running."""
    import signal
    import subprocess
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _launch_collective(nproc, script, script_args, coordinator=None,
                       nnodes=1, node_rank=0):
    """Reference fleet/launch.py collective mode (launch.py:396): ``nproc``
    ranks on this node. On one node each rank gets an endpoint of its own
    (rank 0's the rendezvous); across nodes every rank meets at
    ``coordinator``. A rank that fails ends the job with its code."""
    import subprocess
    import time
    world = nnodes * nproc
    if nnodes > 1:      # every rank meets at the coordinator
        eps = [coordinator]
    else:
        eps = ([coordinator] if coordinator else []) + [
            f"127.0.0.1:{_free_port()}"
            for _ in range(world - bool(coordinator))]
    procs = []
    for i in range(nproc):
        rank = node_rank * nproc + i
        env = dict(os.environ, PADDLE_TRAINER_ID=str(rank),
                   PADDLE_TRAINERS_NUM=str(world),
                   PADDLE_TRAINER_ENDPOINTS=",".join(eps))
        if nnodes == 1:
            env["PADDLE_CURRENT_ENDPOINT"] = eps[rank]
        procs.append(subprocess.Popen(
            [sys.executable, script] + script_args, env=env))
    rc = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            if all(c == 0 for c in codes):
                break
            time.sleep(0.2)
    finally:
        _reap(procs)
    return rc


def launch():
    """python -m paddle_tpu_torch.distributed.launch
    [--coordinator host:port] [--nnodes N] [--node_rank R]
    [--nproc_per_node N] [--server_num N --worker_num M]
    script.py args...

    With --server_num/--worker_num, a local parameter-server cluster
    (reference fleet/launch.py PS mode); with --nproc_per_node N (N > 1),
    N local ranks. Otherwise the script runs in this process."""
    argv = sys.argv[1:]
    coordinator = None
    nnodes, node_rank = 1, 0
    server_num = worker_num = 0
    nproc_per_node = 1
    script_idx = 0
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--coordinator":
            coordinator = argv[i + 1]
        elif a == "--nproc_per_node":
            nproc_per_node = int(argv[i + 1])
        elif a == "--nnodes":
            nnodes = int(argv[i + 1])
        elif a == "--node_rank":
            node_rank = int(argv[i + 1])
        elif a == "--server_num":
            server_num = int(argv[i + 1])
        elif a == "--worker_num":
            worker_num = int(argv[i + 1])
        else:
            script_idx = i
            break
        i += 2
    if script_idx >= len(argv) or argv[script_idx].startswith("--"):
        sys.exit("usage: launch [options] script.py [args...]")
    script = argv[script_idx]
    script_args = argv[script_idx + 1:]
    if server_num > 0 and nproc_per_node > 1:
        sys.exit("--server_num (PS mode) and --nproc_per_node "
                 "(collective mode) are mutually exclusive")
    if server_num > 0 and (nnodes > 1 or coordinator):
        sys.exit("--nnodes/--coordinator do not apply to PS mode "
                 "(--server_num)")
    if nnodes > 1 and coordinator is None:
        sys.exit("--nnodes > 1 needs --coordinator host:port (a "
                 "per-node loopback rendezvous cannot form one job)")
    if server_num > 0:
        sys.exit(_launch_ps_cluster(server_num, max(worker_num, 1),
                                    script, script_args))
    if nproc_per_node > 1 or nnodes > 1:
        sys.exit(_launch_collective(nproc_per_node, script, script_args,
                                    coordinator=coordinator,
                                    nnodes=nnodes, node_rank=node_rank))
    sys.argv = argv[script_idx:]
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    launch()
