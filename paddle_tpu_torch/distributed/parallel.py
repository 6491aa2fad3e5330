"""Data parallelism (a port of ``paddle_tpu/distributed/parallel.py``).

The reference shards the batch over the mesh's ``dp`` axis and lets
GSPMD insert the gradient all-reduce. The port runs one process a rank,
as Paddle does: ``init_parallel_env`` starts the process group, and
``DataParallel`` broadcasts the parameters from rank 0 at construction
and, when a ``backward()`` ends, all-reduces every parameter's grad over
the ``dp`` group and divides it by the group's size (the mean of the
ranks' grads, which is the grad of the mean loss over the global batch
when the ranks' batches are equal). Under a hybrid topology the same
hook first sums the grads over the ``sp`` group, whose ranks each hold
part of every sequence (``GradSync``).
"""
import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch import nn

from . import collective, env, topology


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend(local_size):
    """NCCL when every rank on this host has a card of its own, gloo on
    the CPU and when ranks share a card (NCCL refuses two ranks on one
    device)."""
    if not torch.cuda.is_available():
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_size else "gloo"


def init_parallel_env(backend=None, timeout=60):
    """Reference distributed/parallel.py:58: start this process's rank of
    the process group from the launcher's variables
    (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, the first of
    ``PADDLE_TRAINER_ENDPOINTS`` as the rendezvous), a world of one on a
    free local port without them. ``backend``: ``"nccl"`` or ``"gloo"``,
    by default NCCL when each rank on this host has a card of its own
    and gloo otherwise; the ranks on this host are counted from the
    endpoints (``env.local_ranks``). On NCCL the rank's card is its
    local rank.
    ``timeout`` (seconds) bounds the rendezvous and every collective.
    Returns a ``ParallelEnv``."""
    if dist.is_initialized():
        return env.ParallelEnv()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    eps = env._endpoints()
    master = eps[0] if eps else f"127.0.0.1:{_free_port()}"
    if world > 1 and not eps:
        raise ValueError("PADDLE_TRAINERS_NUM > 1 needs "
                         "PADDLE_TRAINER_ENDPOINTS (the rendezvous)")
    local_rank, local_size = env.local_ranks(rank, world)
    backend = backend or _backend(local_size)
    if master.split(":")[0] in ("127.0.0.1", "localhost"):
        # every rank on this host: gloo's transport on the loopback
        # device, without resolving the host's name
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{master}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout),
                            **kw)
    collective.reset()
    return env.ParallelEnv()


class GradSync:
    """At the end of each ``backward()`` that reaches ``params``: their
    grads summed over ``sum_group`` (the ``sp`` ranks, which each saw
    part of every sequence), then averaged over ``avg_group`` (the
    ``dp`` ranks, which each saw part of the batch), in one flat buffer
    per dtype and device, in parameter order. A group of one rank is
    skipped; ``enabled`` False (``no_sync``) skips both."""

    def __init__(self, params, avg_group=None, sum_group=None):
        self.params = [p for p in params if p.requires_grad]
        self.groups = [(g, "sum") for g in (sum_group,)
                       if g is not None and g.nranks > 1] + \
            [(g, "avg") for g in (avg_group,)
             if g is not None and g.nranks > 1]
        self.enabled = True
        self._queued = False
        self._handles = []
        if self.groups:
            for p in self.params:
                self._handles.append(
                    p.register_post_accumulate_grad_hook(self._hook))

    def _hook(self, _param):
        if self.enabled and not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._sync)

    def _sync(self):
        self._queued = False
        self.sync()

    @torch.no_grad()
    def sync(self):
        """All-reduce the grads now."""
        by_kind = {}
        for p in self.params:
            if p.grad is not None:
                by_kind.setdefault((p.grad.dtype, p.grad.device),
                                   []).append(p.grad)
        for grads in by_kind.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            for g, op in self.groups:
                collective.all_reduce(flat, op=op, group=g)
            at = 0
            for g in grads:
                n = g.numel()
                g.copy_(flat[at:at + n].view_as(g))
                at += n

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []


def _hybrid_groups(group):
    """(dp group, sp group): the hybrid topology's when there is one,
    else ``group`` or the whole world as dp."""
    hcg = topology.get_hybrid_communicate_group()
    if group is None and hcg is not None:
        return (hcg.get_data_parallel_group(),
                hcg.get_sequence_parallel_group())
    return group or collective._default_group(), None


def sync_params(params, src_of_group):
    """Broadcast each parameter from the first rank of each
    ``(group, src global rank)``."""
    with torch.no_grad():
        for g, src in src_of_group:
            if g is None or g.nranks == 1:
                continue
            for p in params:
                collective.broadcast(p.data, src=src, group=g)


def torch_leaves(layers):
    """The torch leaves of ``layers``' parameters: a torch module's
    own, or the values of a Paddle-surface ``Layer``'s (which torch's
    autograd accumulates into)."""
    return [getattr(p, "_value", p) for p in layers.parameters()]


class Wrapper(nn.Module):
    """A parallel wrapper of a torch module or a Paddle-surface
    ``Layer``: calls, parameters, state and mode go to the layers."""

    def __init__(self, layers):
        super().__init__()
        self._layers = layers

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, *args, **kwargs):
        return self._layers.parameters(*args, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        load = getattr(self._layers, "load_state_dict", None) \
            or self._layers.set_state_dict
        return load(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def train(self, mode=True):
        self._layers.train() if mode else self._layers.eval()
        self.training = mode
        return self

    def eval(self):
        return self.train(False)


class DataParallel(Wrapper):
    """``paddle.DataParallel`` (reference fluid/dygraph/parallel.py:382)
    of a torch module or a Paddle-surface ``Layer``: the parameters
    broadcast from the group's first rank, and the grads averaged over
    the group after each backward (see :class:`GradSync`). Each rank
    feeds its own part of the batch."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__(layers)
        dp, sp = _hybrid_groups(group)
        params = torch_leaves(layers)
        sync_params(params, [(dp, dp.ranks[0]),
                             (sp, sp.ranks[0] if sp is not None else 0)])
        self._grad_sync = GradSync(params, avg_group=dp, sum_group=sp)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """Averages the grads now (the hook does it at each backward)."""
        self._grad_sync.sync()

    def no_sync(self):
        """Grads accumulate across the backwards inside without an
        all-reduce; the first backward after it averages them."""
        import contextlib

        @contextlib.contextmanager
        def off():
            self._grad_sync.enabled = False
            try:
                yield
            finally:
                self._grad_sync.enabled = True
        return off()


def get_rank():
    return env.get_rank()


def get_world_size():
    return env.get_world_size()
