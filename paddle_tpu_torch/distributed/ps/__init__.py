"""The parameter server (a port of ``paddle_tpu/distributed/ps/``).

Reference parity: paddle/fluid/distributed/service/brpc_ps_server.h /
brpc_ps_client.h (pull/push of dense and sparse tables over RPC),
service/communicator.h:197 (Communicator, AsyncCommunicator :348,
GeoCommunicator :497), distributed/table/. The server, the client and the
communicators are numpy over length-prefixed pickle on TCP sockets, kept
here as a copy of the reference's, wire included: a trainer of either
package talks to a server of either. The trainer's side takes torch
tensors (or the eager core's Tensors) and turns them into numpy at the
client.
"""
import numpy as np
import torch

from .server import PSServer, DenseTable, SparseTable  # noqa: F401
from .client import PSClient  # noqa: F401
from .communicator import (  # noqa: F401
    Communicator, AsyncCommunicator, GeoCommunicator)


def _np(x):
    v = getattr(x, "_value", x)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class PSEmbedding:
    """A trainer's embedding over a remote sparse table: the forward
    pulls the rows (a leaf that takes grads: the graph is cut at the
    pull, as the reference's DownpourWorker pull), ``apply_push`` sends
    the grads of the pulled rows through the communicator (reference
    distributed_lookup_table_op + fleet_wrapper.h:69). The rows go to
    ``device`` (the current device by default)."""

    def __init__(self, client, table_id, dim, communicator=None,
                 device=None):
        self.client = client
        self.table_id = table_id
        self.dim = int(dim)
        self.comm = communicator or Communicator(client)
        self.device = device
        self._last = None

    def __call__(self, ids):
        ids_np = _np(ids)
        rows = self.client.pull_sparse(self.table_id, ids_np)
        rows = rows.reshape(tuple(ids_np.shape) + (self.dim,))
        from ...core.device import resolve_device
        pulled = torch.from_numpy(rows).to(
            resolve_device(self.device)).requires_grad_()
        self._last = (ids_np, pulled)
        return pulled

    def apply_push(self):
        if self._last is None:
            return
        ids_np, pulled = self._last
        if pulled.grad is not None:
            self.comm.send_sparse(self.table_id, ids_np.reshape(-1),
                                  _np(pulled.grad).reshape(-1, self.dim))
        self._last = None
