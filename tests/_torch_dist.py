"""Spawns the ranks of tests/torch_dist_worker.py for the port's
multi-process tests: WORLD gloo processes on the CPU, each with a
120 s limit (the process group's own timeout is 60 s), so a rendezvous
that hangs fails one test instead of the whole run."""
import json
import os
import socket
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(_HERE, "torch_dist_worker.py")
TIMEOUT = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(suite, world, outdir, inputs=None):
    """Run ``suite`` on ``world`` ranks; returns (each rank's JSON line,
    each rank's arrays), in rank order. ``inputs``: arrays every rank
    reads."""
    outdir = str(outdir)
    if inputs is not None:
        np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(_HERE) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, suite, str(r), str(world), str(port),
         outdir], stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines, arrays = [], []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {suite} exited "
                                 f"{p.returncode}:\n{se[-4000:]}")
        lines.append(json.loads(so.strip().splitlines()[-1]))
        with np.load(os.path.join(outdir, f"rank{r}.npz")) as z:
            arrays.append({k: z[k] for k in z.files})
    return lines, arrays
