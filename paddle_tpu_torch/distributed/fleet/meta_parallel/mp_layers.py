"""Megatron-style tensor-parallel layers (a port of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``).

The reference holds the full logical weight and lets GSPMD shard it over
the ``mp`` mesh axis. The port holds each rank's shard of the weight and
writes the collectives out (``_c_identity``/``_mp_allreduce``, Paddle's
own scheme):

* ``VocabParallelEmbedding`` holds rows ``[r·V/n, (r+1)·V/n)`` of the
  table; a rank looks up the ids in its range, zeros the rest, and the
  ranks' outputs are all-reduced.
* ``ColumnParallelLinear`` holds ``out/n`` of the output features: its
  input goes through ``_c_identity`` (the grad all-reduced backward), its
  output stays split unless ``gather_output``. With ``chunks=k`` the
  output features are ``k`` blocks (a fused QKV: ``k = 3``) and each
  rank holds its ``1/n`` of every block, so a ``[.., k, heads, hd]``
  view of the local output gives this rank's heads of each block.
* ``RowParallelLinear`` holds ``in/n`` of the input features; the
  partial products are all-reduced (``_mp_allreduce``) and the bias,
  whole on every rank, added after.
* ``ParallelCrossEntropy`` takes vocab-split logits and combines the
  ranks' max, sum of exponentials and label logit by all-reduces (the
  ``c_softmax_with_cross_entropy`` scheme).

Weights are stored in torch's ``Linear`` layout (``[out, in]``), as the
port's dense layers are. Each split parameter carries ``tp_split``, a
:class:`Split` (its ``axis``, ``chunks``, ``full_shape`` and ``group``;
Paddle's ``is_distributed`` is a method of torch's tensors);
``state_dict()`` gathers it whole and ``load_state_dict``
(``set_state_dict``) takes a whole weight and keeps this rank's shard,
so checkpoints stay independent of the topology, as the reference's
docstring promises (:14-17). :func:`full_tensors` gathers a module's
parameters or grads whole.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from ... import collective, topology


def resolve_mp_group(group=None):
    return topology.axis_group("mp", group)


def shard(full, axis, chunks, rank, n):
    """Rank ``rank``'s shard of ``full`` split ``n`` ways along ``axis``:
    the axis is ``chunks`` blocks and the rank takes its ``1/n`` of each,
    in block order."""
    v = full.unflatten(axis, (chunks, n, full.shape[axis] // (chunks * n)))
    return v.select(axis + 1, rank).flatten(axis, axis + 1).contiguous()


def unshard(parts, axis, chunks):
    """The inverse of :func:`shard` over every rank's shard, rank
    order."""
    st = torch.stack([p.unflatten(axis, (chunks, p.shape[axis] // chunks))
                      for p in parts], dim=axis + 1)
    return st.flatten(axis, axis + 2)


class Split:
    """How a parameter is split over its ``mp`` group: ``axis`` of the
    whole ``full_shape``, ``chunks`` blocks each split (see
    :func:`shard`)."""
    __slots__ = ("axis", "chunks", "full_shape", "group")

    def __init__(self, axis, chunks, full_shape, group):
        self.axis, self.chunks = axis, chunks
        self.full_shape, self.group = tuple(full_shape), group


def _mark(p, axis, chunks, full_shape, group):
    p.tp_split = Split(axis, chunks, full_shape, group)
    return p


def split_of(p):
    """``p``'s :class:`Split`, None when ``p`` is whole on every rank."""
    return getattr(p, "tp_split", None)


def gather_param(p, t=None):
    """The whole tensor of split parameter ``p`` (or of ``t``, a tensor of
    ``p``'s shard shape such as its grad), gathered over its group; ``p``
    itself (or ``t``) when it is not split."""
    t = p if t is None else t
    sp = split_of(p)
    if sp is None or sp.group.nranks == 1:
        return t
    parts = []
    collective.all_gather(parts, t.detach().contiguous(), group=sp.group)
    return unshard(parts, sp.axis, sp.chunks)


def shard_of(p, full):
    """This rank's shard of ``full`` for split parameter ``p``."""
    sp = split_of(p)
    return shard(full, sp.axis, sp.chunks, sp.group.rank, sp.group.nranks)


def full_tensors(module, grads=False):
    """``{name: whole tensor}`` of ``module``'s parameters (or, with
    ``grads``, of their grads; None where a grad is None), split ones
    gathered. Every rank of each ``mp`` group must call it."""
    out = {}
    for name, p in module.named_parameters():
        t = p.grad if grads else p
        out[name] = None if t is None else gather_param(p, t).detach()
    return out


class _SplitState(nn.Module):
    """``state_dict`` gathers the split parameters whole;
    ``load_state_dict`` takes whole ones and keeps this rank's shard."""

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for name, p in self._parameters.items():
            if p is not None and split_of(p) is not None:
                destination[prefix + name] = gather_param(p).detach()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name, p in self._parameters.items():
            key = prefix + name
            if p is not None and split_of(p) is not None \
                    and key in state_dict \
                    and tuple(state_dict[key].shape) \
                    == split_of(p).full_shape:
                state_dict[key] = shard_of(p, state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def set_state_dict(self, state_dict, strict=True):
        return self.load_state_dict(state_dict, strict=strict)


def _divide(total, n, what):
    if total % n:
        raise ValueError(f"{what} {total} is not a multiple of the mp "
                         f"degree {n}")
    return total // n


class VocabParallelEmbedding(_SplitState):
    """Reference mp_layers.py:96 — the vocab rows split over ``mp``.
    Weights are N(0, 1), as the dense ``nn.Embedding``'s."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__()
        g = self.mp_group = resolve_mp_group(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.per_rank = _divide(num_embeddings, g.nranks, "num_embeddings")
        self.start = g.rank * self.per_rank
        full = torch.randn(num_embeddings, embedding_dim, dtype=dtype)
        self.weight = nn.Parameter(shard(full, 0, 1, g.rank, g.nranks)
                                   .to(device))
        _mark(self.weight, 0, 1, full.shape, g)

    def forward(self, x):
        out_of_range = (x < self.start) | (x >= self.start + self.per_rank)
        local = (x - self.start).masked_fill(out_of_range, 0)
        out = F.embedding(local, self.weight)
        out = out.masked_fill(out_of_range[..., None], 0.0)
        return collective._mp_allreduce(out, group=self.mp_group)


class ColumnParallelLinear(_SplitState):
    """Reference mp_layers.py:116 — the output features split over
    ``mp``; ``gather_output=False`` keeps the output split for the
    following ``RowParallelLinear`` (the Megatron pattern). ``chunks``:
    the output is that many blocks, each split (a fused QKV's 3)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, chunks=1, device=None,
                 dtype=None):
        super().__init__()
        g = self.mp_group = resolve_mp_group(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.chunks = chunks
        self.out_per_rank = _divide(out_features, g.nranks * chunks,
                                    "out_features / chunks") * chunks
        bound = 1.0 / math.sqrt(in_features)
        full = torch.empty(out_features, in_features,
                           dtype=dtype).uniform_(-bound, bound)
        self.weight = nn.Parameter(
            shard(full, 0, chunks, g.rank, g.nranks).to(device))
        _mark(self.weight, 0, chunks, full.shape, g)
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(self.out_per_rank,
                                                 dtype=dtype, device=device))
            _mark(self.bias, 0, chunks, (out_features,), g)
        else:
            self.bias = None

    def forward(self, x):
        x = collective._c_identity(x, group=self.mp_group)
        y = F.linear(x, self.weight, self.bias)
        if not self.gather_output or self.mp_group.nranks == 1:
            return y
        y = collective._c_concat(y, group=self.mp_group)
        if self.chunks > 1:     # rank-major blocks -> chunk-major
            n = self.mp_group.nranks
            y = y.unflatten(-1, (n, self.chunks, -1)).transpose(-3, -2) \
                .flatten(-3)
        return y


class RowParallelLinear(_SplitState):
    """Reference mp_layers.py:150 — the input features split over
    ``mp``; the partial products all-reduced, the bias added after."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__()
        g = self.mp_group = resolve_mp_group(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        bound = 1.0 / math.sqrt(in_features)
        full = torch.empty(out_features, in_features,
                           dtype=dtype).uniform_(-bound, bound)
        _divide(in_features, g.nranks, "in_features")
        self.weight = nn.Parameter(
            shard(full, 1, 1, g.rank, g.nranks).to(device))
        _mark(self.weight, 1, 1, full.shape, g)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                             device=device)) \
            if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = collective._c_split(x, group=self.mp_group)
        y = collective._mp_allreduce(F.linear(x, self.weight),
                                     group=self.mp_group)
        return y if self.bias is None else y + self.bias


class _ParallelSoftmaxCE(torch.autograd.Function):
    """Per-token loss of vocab-split logits: the ranks' max, sum of
    exponentials and label logit combined by all-reduces; the grad is
    this rank's slice of ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, logits, label, start, ignore_index, g):
        lf = logits.float()
        m = lf.max(dim=-1).values
        collective.all_reduce(m, op="max", group=g)
        e = torch.exp(lf - m[..., None])
        s = e.sum(dim=-1)
        local = label - start
        hit = (local >= 0) & (local < lf.shape[-1])
        ll = torch.where(hit, lf.gather(
            -1, local.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0],
            torch.zeros_like(m))
        sl = torch.stack([s, ll])
        collective.all_reduce(sl, group=g)
        valid = label != ignore_index
        loss = torch.where(valid, torch.log(sl[0]) + m - sl[1],
                           torch.zeros_like(m))
        ctx.save_for_backward(e, sl[0], local, hit, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, grad):
        e, s, local, hit, valid = ctx.saved_tensors
        d = e / s[..., None]
        onehot = torch.zeros_like(d).scatter_(
            -1, local.clamp(0, d.shape[-1] - 1)[..., None],
            hit[..., None].to(d.dtype))
        d = (d - onehot) * (grad * valid)[..., None]
        return d.to(ctx.dtype), None, None, None, None


class ParallelCrossEntropy(nn.Module):
    """Reference mp_layers.py:177 — cross entropy of vocab-split logits
    ``[..., V/n]`` against labels ``[..., 1]`` (or ``[...]``): the loss
    ``[..., 1]``, 0 at ``ignore_index``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = resolve_mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        g = self.mp_group
        lab = label[..., 0] if label.dim() == input.dim() else label
        start = g.rank * input.shape[-1]
        loss = _ParallelSoftmaxCE.apply(input, lab.long(), start,
                                        int(self.ignore_index), g)
        return loss[..., None]
