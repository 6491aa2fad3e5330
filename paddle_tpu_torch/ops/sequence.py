"""Sequence ops (a port of ``paddle_tpu/ops/sequence.py``): ragged
sequences carried as ``(padded [N, L, ...], lengths [N])``, every op a
masked dense computation. ``sequence_pad`` and ``sequence_unpad`` are
the host boundary; ``sequence_expand`` and ``sequence_reverse`` build new
tensors (not differentiable), as the reference's do.

The linear-chain CRF: ``linear_chain_crf`` is the negative
log-likelihood of a label path (the forward algorithm in log space, a
loop over time), ``crf_decoding`` its Viterbi path. ``transition`` is
``[C + 2, C]``: row 0 the start weights, row 1 the end weights, the rest
from -> to. Steps past a sequence's length keep alpha and delta, with
the identity as their backpointer; ``argmax`` takes the first maximum.
"""
import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.tensor import Tensor


def _host(a):
    return np.asarray(a.numpy() if isinstance(a, Tensor) else a)


def sequence_pad(x, pad_value=0.0, maxlen=None, dtype="float32"):
    """A list of ``[len_i, ...]`` arrays -> ``(padded [N, L, ...],
    lengths [N])``; a ``maxlen`` below the longest truncates, and the
    lengths with it."""
    arrs = [_host(a) for a in x]
    lens = np.asarray([len(a) for a in arrs], "int64")
    L = int(maxlen) if maxlen is not None else int(lens.max())
    lens = np.minimum(lens, L)
    out = np.full((len(arrs), L) + arrs[0].shape[1:], pad_value,
                  arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, :min(len(a), L)] = a[:L]
    return Tensor(out), Tensor(lens)


def sequence_unpad(x, length):
    """``padded [N, L, ...]`` + lengths -> a list of ``[len_i, ...]``
    Tensors."""
    arr = _host(x)
    lens = _host(length).astype("int64")
    return [Tensor(arr[i, :lens[i]].copy()) for i in range(len(lens))]


def _mask(lengths, L):
    return torch.arange(L, device=lengths.device)[None, :] \
        < lengths[:, None]


@register_op("sequence_pool")
def _sequence_pool(x, lengths, *, pool_type):
    n, L = x.shape[0], x.shape[1]
    m = _mask(lengths, L)
    shape = (n, L) + (1,) * (x.dim() - 2)
    mf = m.reshape(shape).to(x.dtype)
    per_seq = (n,) + (1,) * (x.dim() - 2)
    pt = pool_type.upper()
    if pt == "SUM":
        return (x * mf).sum(1)
    if pt == "AVERAGE":
        return (x * mf).sum(1) / torch.clamp(
            lengths.reshape(per_seq).to(x.dtype), min=1)
    if pt == "SQRT":
        return (x * mf).sum(1) / torch.sqrt(torch.clamp(
            lengths.reshape(per_seq).to(x.dtype), min=1))
    if pt == "MAX":
        return torch.where(m.reshape(shape), x, torch.full_like(
            x, -float("inf"))).amax(1)
    if pt == "LAST":
        idx = torch.clamp(lengths - 1, min=0).long()
        return torch.take_along_dim(
            x, idx.reshape((n, 1) + (1,) * (x.dim() - 2)), dim=1)[:, 0]
    if pt == "FIRST":
        return x[:, 0]
    raise ValueError(pool_type)


def sequence_pool(x, lengths, pool_type="SUM"):
    """Masked pooling over the time axis: SUM, AVERAGE, SQRT, MAX, LAST,
    FIRST."""
    return _sequence_pool(x, lengths, pool_type=pool_type)


@register_op("sequence_softmax")
def _sequence_softmax(x, lengths):
    m = _mask(lengths, x.shape[1])
    while m.dim() < x.dim():
        m = m[..., None]
    z = torch.where(m, x, torch.full_like(x, -float("inf")))
    z = z - z.amax(1, keepdim=True)
    e = torch.exp(z) * m.to(x.dtype)
    return e / torch.clamp(e.sum(1, keepdim=True), min=1e-9)


def sequence_softmax(x, lengths):
    """Softmax over each sequence's valid steps; 0 past its length."""
    return _sequence_softmax(x, lengths)


def sequence_expand(x, y_lengths):
    """Row i of ``x`` repeated ``y_lengths[i]`` times (host counts)."""
    reps = _host(y_lengths).astype("int64")
    arr = x.value if isinstance(x, Tensor) else torch.as_tensor(
        np.asarray(x))
    out = torch.repeat_interleave(
        arr.detach(), torch.as_tensor(reps, device=arr.device), dim=0)
    return Tensor._wrap(out)


def sequence_reverse(x, lengths):
    """Each sequence reversed within its valid prefix."""
    arr = (x.value if isinstance(x, Tensor)
           else torch.as_tensor(np.asarray(x))).detach()
    lens = lengths.value if isinstance(lengths, Tensor) else \
        torch.as_tensor(np.asarray(lengths))
    lens = lens.to(arr.device)[:, None]
    pos = torch.arange(arr.shape[1], device=arr.device)[None, :]
    src = torch.where(pos < lens, lens - 1 - pos, pos).long()
    return Tensor._wrap(torch.take_along_dim(
        arr, src.reshape(tuple(src.shape) + (1,) * (arr.dim() - 2)), dim=1))


@register_op("linear_chain_crf")
def _linear_chain_crf(emission, transition, label, lengths):
    """Per-sequence NLL ``[B, 1]`` of ``label [B, T]`` under the CRF over
    ``emission [B, T, C]`` with ``lengths [B]`` valid steps."""
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    b, t_max, c = emission.shape
    valid = torch.arange(t_max, device=emission.device)[None, :] \
        < lengths[:, None]
    alpha = start_w[None, :] + emission[:, 0]
    for t in range(1, t_max):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, t]
        alpha = torch.where(valid[:, t][:, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + end_w[None], dim=-1)
    label = label.long()
    zero = torch.zeros((), dtype=emission.dtype, device=emission.device)
    unary = torch.gather(emission, 2, label[..., None])[..., 0]
    unary = torch.where(valid, unary, zero).sum(-1)
    pair = trans[label[:, :-1], label[:, 1:]]
    pair = torch.where(valid[:, 1:], pair, zero).sum(-1)
    last_idx = torch.clamp(lengths - 1, 0, t_max - 1).long()
    last_lab = torch.gather(label, 1, last_idx[:, None])[:, 0]
    score = unary + pair + start_w[label[:, 0]] + end_w[last_lab]
    return (log_z - score)[:, None]


@register_op("crf_decoding", differentiable=False)
def _crf_decoding(emission, transition, lengths):
    """The Viterbi path ``[B, T]``, 0 past each length."""
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    b, t_max, c = emission.shape
    dev = emission.device
    valid = torch.arange(t_max, device=dev)[None, :] < lengths[:, None]
    ident = torch.arange(c, device=dev)[None, :]
    delta = start_w[None, :] + emission[:, 0]
    backs = []
    for t in range(1, t_max):
        cand = delta[:, :, None] + trans[None]           # [B, from, to]
        best = cand.amax(1) + emission[:, t]
        arg = cand.argmax(1)                             # the first max
        keep = valid[:, t][:, None]
        delta = torch.where(keep, best, delta)
        backs.append(torch.where(keep, arg, ident))
    lab = torch.argmax(delta + end_w[None], dim=-1)
    path = [None] * t_max
    for t in range(t_max - 1, 0, -1):
        path[t] = lab
        lab = torch.gather(backs[t - 1], 1, lab[:, None])[:, 0]
    path[0] = lab
    path = torch.stack(path, dim=1)
    return torch.where(valid, path, torch.zeros_like(path))


def linear_chain_crf(emission, transition, label, length):
    return _linear_chain_crf(emission, transition, label, length)


def crf_decoding(emission, transition, length):
    return _crf_decoding(emission, transition, length)
