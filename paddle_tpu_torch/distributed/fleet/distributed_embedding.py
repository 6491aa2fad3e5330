"""Distributed and host embedding tables (a port of
``paddle_tpu/distributed/fleet/distributed_embedding.py``).

Reference: the brpc parameter server's sparse tables
(paddle/fluid/distributed/table/common_sparse_table.h) and the
distributed_lookup_table op serve embeddings larger than one device.

* ``DistributedEmbedding``: the table's rows split over the ranks of a
  group (the hybrid topology's ``axis`` group, ``mp`` by default): rank
  ``r`` holds rows ``[r * n / R, (r + 1) * n / R)``; a lookup is a masked
  local gather plus an all-reduce over the group (:func:`c_embedding`,
  the reference's c_embedding op, as ``VocabParallelEmbedding``), whose
  backward leaves each rank the grads of its own rows.
* ``HostEmbeddingTable``: the table in host numpy (the CPU parameter
  server's role on one host): ``pull`` gathers rows into a torch tensor,
  ``push`` applies sparse SGD or Adagrad on the host, ``save``/``load``
  the table and its optimizer state (the reference's ``.npz``).
* ``HostEmbedding``: a module over a ``HostEmbeddingTable`` whose lookup
  is a ``torch.autograd.Function``: the forward pulls the rows, the
  backward keeps their grads, and ``apply_push(lr)`` pushes them.
"""
import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from .. import collective, topology


def c_embedding(ids, local_weight, group, start_index, sparse=False):
    """The rows of ``ids`` from a table whose rows ``[start_index,
    start_index + local rows)`` this rank holds: each rank gathers the ids
    in its range (zeros elsewhere) and the all-reduce over ``group``
    assembles the whole rows; the grad of each rank's rows stays with
    it."""
    rows = local_weight.shape[0]
    local = ids - start_index
    out_of_range = (local < 0) | (local >= rows)
    out = torch.nn.functional.embedding(local.masked_fill(out_of_range, 0),
                                        local_weight, sparse=sparse)
    out = out.masked_fill(out_of_range[..., None], 0.0)
    return collective._mp_allreduce(out, group=group)


class DistributedEmbedding(nn.Module):
    """Rows split over the ``axis`` group; weights N(0, 0.01), the whole
    table drawn from ``generator`` and each rank keeping its rows, so
    every group size starts from the same table."""

    def __init__(self, num_embeddings, embedding_dim, axis="mp",
                 weight_attr=None, sparse=False, name=None, device=None,
                 generator=None, group=None):
        super().__init__()
        g = self.group = topology.axis_group(axis, group)
        if num_embeddings % g.nranks:
            raise ValueError(f"num_embeddings {num_embeddings} is not a "
                             f"multiple of the {axis} group's {g.nranks}")
        self.per_rank = num_embeddings // g.nranks
        self.start = max(g.rank, 0) * self.per_rank
        full = torch.randn(num_embeddings, embedding_dim,
                           generator=generator) * 0.01
        self.weight = nn.Parameter(
            full[self.start:self.start + self.per_rank].clone().to(
                resolve_device(device)))
        self.weight.is_distributed = g.nranks > 1
        self.sparse = bool(sparse)

    def forward(self, ids):
        return c_embedding(ids, self.weight, self.group, self.start,
                           self.sparse)


def _np(x):
    v = getattr(x, "_value", x)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class HostEmbeddingTable:
    """A host-RAM table with the PS worker's pull/push (the reference's
    DownpourWorker cycle, framework/fleet/fleet_wrapper.h:69)."""

    def __init__(self, num_embeddings, embedding_dim, init_std=0.01,
                 optimizer="sgd", seed=0, device=None):
        rs = np.random.RandomState(seed)
        self.table = (rs.randn(num_embeddings, embedding_dim)
                      .astype(np.float32) * init_std)
        self.embedding_dim = embedding_dim
        self.optimizer = optimizer
        self.device = device
        self._adagrad_acc = None
        if optimizer == "adagrad":
            self._adagrad_acc = np.zeros(num_embeddings, np.float32)

    def pull(self, ids):
        ids_np = _np(ids)
        rows = self.table[ids_np.reshape(-1)].reshape(
            ids_np.shape + (self.embedding_dim,))
        return torch.from_numpy(rows).to(resolve_device(self.device))

    def push(self, ids, grads, lr=0.01):
        ids_np = _np(ids).reshape(-1)
        g = _np(grads).reshape(-1, self.embedding_dim).astype(np.float32)
        if self.optimizer == "adagrad":
            sq = (g * g).mean(axis=1)
            np.add.at(self._adagrad_acc, ids_np, sq)
            scale = lr / (np.sqrt(self._adagrad_acc[ids_np]) + 1e-6)
            np.subtract.at(self.table, ids_np, g * scale[:, None])
        else:
            np.subtract.at(self.table, ids_np, lr * g)

    def push_sparse(self, slices, lr=0.01):
        """A sparse grad (a sparse COO tensor, or anything with
        ``indices`` and ``values``; duplicate rows allowed) merged per row
        first (reference scatter::MergeAdd), then pushed: the
        SelectedRows push of the reference's Communicator."""
        if isinstance(slices, torch.Tensor) and slices.is_sparse:
            slices = slices.coalesce()
            ids, vals = slices.indices()[0], slices.values()
        else:
            ids, vals = slices.indices, slices.values
        ids = _np(ids).reshape(-1)
        vals = _np(vals).reshape(-1, self.embedding_dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        merged = np.zeros((len(uniq), self.embedding_dim), np.float32)
        np.add.at(merged, inv, vals)
        self.push(uniq, merged, lr)

    def save(self, path):
        """The table and its optimizer state (reference sparse table
        Save/Load)."""
        state = {"table": self.table, "optimizer": self.optimizer}
        if self._adagrad_acc is not None:
            state["adagrad_acc"] = self._adagrad_acc
        np.savez(path, **state)

    def load(self, path):
        import os
        if not os.path.exists(path) and not str(path).endswith(".npz"):
            path = str(path) + ".npz"
        data = np.load(path, allow_pickle=False)
        if hasattr(data, "files"):
            self.table = data["table"]
            if "optimizer" in data.files:
                self.optimizer = str(data["optimizer"])
            if "adagrad_acc" in data.files:
                self._adagrad_acc = data["adagrad_acc"]
            elif self.optimizer == "adagrad":
                self._adagrad_acc = np.zeros(self.table.shape[0],
                                             np.float32)
            else:
                self._adagrad_acc = None
        else:   # a single .npy array
            self.table = data


class _HostLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, ids, layer):
        ctx.layer, ctx.ids = layer, ids
        return layer.table.pull(ids)

    @staticmethod
    def backward(ctx, grad):
        ctx.layer._pending.append((_np(ctx.ids), _np(grad)))
        return None, None, None


class HostEmbedding(nn.Module):
    """The lookup pulls rows from the host table; the grads of the pulled
    rows are pushed by ``apply_push(lr)``, one pull/push round a step
    (the reference's async PS worker loop)."""

    def __init__(self, num_embeddings, embedding_dim, **kwargs):
        super().__init__()
        self.table = HostEmbeddingTable(num_embeddings, embedding_dim,
                                        **kwargs)
        self._anchor = torch.zeros(0, requires_grad=True)
        self._pending = []

    def forward(self, ids):
        return _HostLookup.apply(self._anchor, getattr(ids, "_value", ids),
                                 self)

    def apply_push(self, lr=0.01):
        for ids, grads in self._pending:
            self.table.push(ids, grads, lr)
        self._pending = []
