"""Mixture of experts with expert parallelism (a port of
``paddle_tpu/incubate/moe.py``).

``_moe_forward`` is the reference's function: a top-k softmax gate (the
chosen gates renormalised), a capacity-bounded dense dispatch
(``capacity = int(max(1, capacity_factor * T * k / E))`` slots an expert;
for each choice ``k`` a token takes the next slot of its expert in token
order, and tokens past the capacity are dropped), the experts' FFNs (GELU
in its tanh form, ``jax.nn.gelu``'s default, or ReLU), the gate-weighted combine, and the Switch load-balancing aux
loss ``E * sum(mean probs * share of first choices)``.

Expert parallelism over the ``ep_axis`` group (``mp`` by default): rank
``r`` holds experts ``[r E/ep, (r+1) E/ep)``; the tokens and the gate are
the same on every rank of the group, each rank computes its experts' part
of the combine, and the parts are summed over the group
(``_mp_allreduce``); the token and gate paths into the experts go through
``_c_identity``, whose backward sums their grads over the group. That is
the reference's function exactly.

Under data parallelism the reference's token axis is global: the capacity
comes from all the ``dp`` ranks' tokens, and the slot positions count
over the ``dp`` axis too. So a ``dp`` rank offsets its positions, for each
choice, by the per-expert counts of the ``dp`` ranks before it (an
exclusive scan over an ``all_gather`` of ``[k, E]`` counts), and its
capacity comes from the global token count. The reference's slots of the
``k`` choices are counted apart and share the slot indices, so one slot
may hold the sum of tokens of different ranks: the experts' inputs are
summed over the ``dp`` group (an all-reduce whose backward is an
all-reduce too), which is also the exchange an all-to-all dispatch
makes. The aux loss's means are over the global tokens (all-reduced),
with the grad of each rank's own tokens scaled by ``dp``, so that
``DataParallel``'s average of the ranks' grads is the reference's.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..distributed import collective, topology


def _dp_offsets(counts, dp_group):
    """The exclusive scan over the ``dp`` ranks of ``counts`` ``[k, E]``
    (this rank's per-choice tokens an expert), and the ranks' total."""
    if dp_group is None or dp_group.nranks == 1:
        return torch.zeros_like(counts), 1
    parts = []
    collective.all_gather(parts, counts.contiguous(), group=dp_group)
    before = parts[:dp_group.rank]
    off = sum(before) if before else torch.zeros_like(counts)
    return off, dp_group.nranks


def _moe_forward(x, gate_w, w1, b1, w2, b2, *, top_k, capacity_factor,
                 activation, ep_group=None, dp_group=None):
    """``x`` ``[T, d]``; ``gate_w`` ``[d, E]``; this rank's experts
    ``w1`` ``[E_local, d, h]``, ``b1`` ``[E_local, h]``, ``w2``
    ``[E_local, h, d]``, ``b2`` ``[E_local, d]``. Returns the output
    ``[T, d]`` and the aux loss."""
    tokens, d = x.shape
    e = gate_w.shape[1]
    n_ep = 1 if ep_group is None else ep_group.nranks
    e_local = w1.shape[0]
    lo = (0 if ep_group is None else max(ep_group.rank, 0)) * e_local
    logits = x @ gate_w
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehots = [F.one_hot(gate_idx[:, k], e) for k in range(top_k)]
    counts = torch.stack([oh.sum(0) for oh in onehots])
    offsets, n_dp = _dp_offsets(counts, dp_group)
    capacity = int(max(1, capacity_factor * (tokens * n_dp) * top_k / e))
    x_e, gv_e = x, gate_vals
    if n_ep > 1:
        x_e = collective._c_identity(x, ep_group)
        gv_e = collective._c_identity(gate_vals, ep_group)
    dispatch = x.new_zeros((tokens, e_local, capacity))
    combine = x.new_zeros((tokens, e_local, capacity))
    for k in range(top_k):
        onehot = onehots[k]
        pos = (torch.cumsum(onehot, 0) + offsets[k]) * onehot - 1
        pos_tok = (pos * onehot).sum(1)
        keep = (pos_tok >= 0) & (pos_tok < capacity)
        sel = F.one_hot(pos_tok.clamp(0, capacity - 1), capacity).to(
            x.dtype) * keep[:, None].to(x.dtype)
        d_k = onehot[:, lo:lo + e_local].to(x.dtype)[:, :, None] \
            * sel[:, None, :]
        dispatch = dispatch + d_k
        combine = combine + d_k * gv_e[:, k][:, None, None]
    expert_in = torch.einsum("tec,td->ecd", dispatch, x_e)
    if n_dp > 1:
        # an expert's slots hold the global tokens' sum (the reference's
        # one dispatch over every dp rank's tokens); the grad of each
        # rank's share is the sum of the ranks' grads
        expert_in = collective._mp_allreduce(
            collective._c_identity(expert_in, dp_group), group=dp_group)
    h = torch.einsum("ecd,edh->ech", expert_in, w1) + b1[:, None, :]
    h = F.gelu(h, approximate="tanh") if activation == "gelu" \
        else F.relu(h)
    expert_out = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
    out = torch.einsum("tec,ecd->td", combine, expert_out)
    if n_ep > 1:
        out = collective._mp_allreduce(out, group=ep_group)
    # the Switch aux loss over the global tokens
    first = onehots[0].to(x.dtype)
    me_sum, ce_sum = probs.sum(0), first.sum(0).detach()
    if n_dp > 1:
        g_me = me_sum.detach().clone()
        g_ce = ce_sum.clone()
        collective.all_reduce(g_me, group=dp_group)
        collective.all_reduce(g_ce, group=dp_group)
        # the global value; this rank's grad scaled by dp (see above)
        me_sum = g_me + n_dp * (me_sum - me_sum.detach())
        ce_sum = g_ce
    me = me_sum / (tokens * n_dp)
    ce = ce_sum / (tokens * n_dp)
    aux = e * (me * ce).sum()
    return out, aux


class MoELayer(nn.Module):
    """An expert-parallel FFN block, in place of a transformer's MLP; add
    ``layer.aux_loss`` to the training loss. The whole layer's weights are
    drawn from ``generator`` (the gate and the experts' matrices Xavier
    normal, the biases 0) and each rank keeps its experts, so every group
    size starts from the same weights."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, activation="gelu", ep_axis="mp",
                 gate_attr=None, name=None, device=None, generator=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        g = topology.axis_group(ep_axis)
        self.ep_group = g if g.nranks > 1 and num_experts % g.nranks == 0 \
            else None
        hcg = topology.get_hybrid_communicate_group()
        dp = hcg.get_data_parallel_group() if hcg is not None else None
        self.dp_group = dp if dp is not None and dp.nranks > 1 else None
        n = 1 if self.ep_group is None else self.ep_group.nranks
        self.local_experts = num_experts // n
        lo = (0 if self.ep_group is None else self.ep_group.rank) \
            * self.local_experts
        dev = resolve_device(device)

        def xavier(*shape):
            fan_in, fan_out = shape[-2], shape[-1]
            std = math.sqrt(2.0 / (fan_in + fan_out))
            return torch.randn(*shape, generator=generator) * std

        def mine(t):
            return nn.Parameter(
                t[lo:lo + self.local_experts].contiguous().to(dev))

        self.gate = nn.Parameter(xavier(d_model, num_experts).to(dev))
        self.w1 = mine(xavier(num_experts, d_model, d_hidden))
        self.b1 = mine(torch.zeros(num_experts, d_hidden))
        self.w2 = mine(xavier(num_experts, d_hidden, d_model))
        self.b2 = mine(torch.zeros(num_experts, d_model))
        for p in (self.w1, self.b1, self.w2, self.b2):
            p.is_distributed = self.ep_group is not None
        self.aux_loss = None

    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        out, aux = _moe_forward(
            flat, self.gate, self.w1, self.b1, self.w2, self.b2,
            top_k=self.top_k, capacity_factor=float(self.capacity_factor),
            activation=self.activation, ep_group=self.ep_group,
            dp_group=self.dp_group)
        self.aux_loss = aux
        return out.reshape(shape)
