"""Sequence (context) parallelism: ring attention and Ulysses (a port of
``paddle_tpu/ops/ring_attention.py``).

Each rank of the ``sp`` group holds one block of the sequence: rank
``r`` holds positions ``[r·S/sp, (r+1)·S/sp)`` of q, k and v
``[B, H, S/sp, D]``, which is block ``r`` of the reference's global
arrays.

* ``ring_attention``: the reference's online-softmax block (:28-71) in
  plain torch ops, as the reference computes it outside Pallas: each
  rank accumulates its queries against the K/V block it holds, then
  passes K and V to the next rank (``collective._ring_shift``, the
  reference's ``ppermute``), ``sp`` blocks in all. Autograd runs the
  shifts backward. The score block is f32, ``[B, H, S/sp, S/sp]``.
* ``ulysses_attention``: an all-to-all from sequence to heads (each rank
  gets every position of ``H/sp`` heads), the port's
  ``scaled_dot_product_attention`` on each head group at the full
  sequence (on the card the flash kernels: K1 forward, K2/K3 backward),
  and an all-to-all back.

``sp == 1`` goes straight to ``scaled_dot_product_attention``, as the
reference goes to its flash core (:98-100, :138-140).
"""
import math

import torch

from ..distributed import collective
from . import attention as attn_ops


def _online_block(q, k, v, acc, m_prev, l_prev, mask=None):
    """One online-softmax step (reference :28): q ``[B,H,Sq,D]`` f32 and
    scaled, k/v ``[B,H,Sk,D]``; acc ``[B,H,Sq,D]`` the unnormalized
    output, m/l ``[B,H,Sq]`` the running max and sum."""
    s = torch.matmul(q, k.float().transpose(-1, -2))
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.matmul(p, v.float())
    return acc_new, m_new, l_new


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def ring_attention(q, k, v, group, causal=True, scale=None):
    """Attention of this rank's sequence block against every block of
    the ``sp`` ``group``, the K/V blocks passed around the ring."""
    sc = _scale(q, scale)
    sp = group.nranks
    if sp == 1:
        return attn_ops.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                     scale=sc)
    my = group.rank
    qf = q.float() * sc
    b, h, sq, d = q.shape
    acc = torch.zeros(b, h, sq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    rows = torch.arange(sq, device=q.device)
    for step in range(sp):
        src = (my - step) % sp    # the rank whose block this is
        mask = None
        if causal:
            mask = ((my * sq + rows)[:, None] >= (src * sq + rows)[None, :])
        acc, m, l = _online_block(qf, kb, vb, acc, m, l, mask)
        if step < sp - 1:
            kb = collective._ring_shift(kb, group)
            vb = collective._ring_shift(vb, group)
    return (acc / l[..., None]).to(v.dtype)


def ulysses_attention(q, k, v, group, causal=True, scale=None):
    """All-to-all sequence parallelism: heads must divide by ``sp``."""
    sc = _scale(q, scale)
    sp = group.nranks
    if sp == 1:
        return attn_ops.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                     scale=sc)
    if q.shape[1] % sp:
        raise ValueError(f"Ulysses needs the heads ({q.shape[1]}) to divide "
                         f"by sp ({sp})")
    qh, kh, vh = (collective._all_to_all(t, group, 1, 2) for t in (q, k, v))
    out = attn_ops.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                                scale=sc)
    return collective._all_to_all(out, group, 2, 1)
