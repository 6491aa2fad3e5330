"""Distributed environment (a port of ``paddle_tpu/distributed/env.py``).

The reference is one controller process driving every chip, so its rank
is the host's process index. The port is Paddle's own model: one rank is
one process on ``torch.distributed``. ``get_rank``/``get_world_size``
come from the process group once one is initialized
(``init_parallel_env``), and before that from the launcher's variables,
``PADDLE_TRAINER_ID`` and ``PADDLE_TRAINERS_NUM`` (0 and 1 without
them). ``ParallelEnv`` reads those and ``PADDLE_TRAINER_ENDPOINTS`` /
``PADDLE_CURRENT_ENDPOINT``.
"""
import os

import torch
import torch.distributed as dist


def _initialized():
    return dist.is_available() and dist.is_initialized()


def get_rank():
    if _initialized():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size():
    if _initialized():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def _endpoints():
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return [e for e in eps.split(",") if e]


def local_ranks(rank=None, world=None):
    """``(local_rank, local_size)``: this rank's index among the ranks
    on its host, and their count. The launcher's
    ``PADDLE_TRAINER_ENDPOINTS`` lists one ``host:port`` a rank; the
    ranks whose host is that of ``PADDLE_CURRENT_ENDPOINT`` (else of
    this rank's own entry) are local. With fewer endpoints than ranks
    (a single rendezvous address) every rank is taken to be on this
    host."""
    rank = get_rank() if rank is None else rank
    world = get_world_size() if world is None else world
    eps = _endpoints()
    if len(eps) != world:
        return rank, world
    cur = os.environ.get("PADDLE_CURRENT_ENDPOINT") or eps[rank]
    host = cur.rsplit(":", 1)[0]
    local = [r for r, e in enumerate(eps) if e.rsplit(":", 1)[0] == host]
    if rank not in local:
        raise ValueError(f"PADDLE_CURRENT_ENDPOINT {cur} is not on the "
                         f"host of rank {rank}'s endpoint {eps[rank]}")
    return local.index(rank), len(local)


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        return local_ranks()[0]

    @property
    def world_size(self):
        return get_world_size()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def dev_id(self):
        """The card this rank runs on: its local rank modulo the cards
        the host has (0 without a card)."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return self.local_rank % n if n else 0

    @property
    def device_type(self):
        return "gpu" if torch.cuda.is_available() else "cpu"

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        return _endpoints()
