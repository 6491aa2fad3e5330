"""Attention: the flash-attention forward kernel (K1) and the plain
PyTorch compositions the decode paths and the tests use.

Ports ``paddle_tpu/ops/attention.py``. Layout ``[batch, heads, seq,
head_dim]`` as there. Two details are contract, because they give stale
or masked positions exactly zero weight: scores accumulate in f32, and
masked scores are ``-1e30`` (never ``-inf``, so a fully masked row stays
finite).

``scaled_dot_product_attention`` is what the model calls. On a CUDA
tensor it launches the hand-written kernel ``csrc/flash_fwd.cu`` for
every shape the kernel takes and raises on any other; on a CPU tensor it
computes the kernel's plain version ``flash_attention_plain``.
"""
import ctypes
import math

import torch

from . import _build

_NEG = -1e30


def reference_attention(q, k, v, mask, scale, causal):
    """The XLA composition the reference falls back to
    (``_reference_attention``): f32 softmax, weights cast back to the
    input dtype before the product with V."""
    qk = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    if causal:
        s, t = qk.shape[-2], qk.shape[-1]
        keep = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        qk = qk.masked_fill(~keep, _NEG)
    if mask is not None:
        qk = qk + mask
    w = torch.softmax(qk.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhst,bhtd->bhsd", w, v)


def flash_attention_plain(q, k, v, scale, causal):
    """Plain version of K1: ``(O, LSE)`` with O in q's dtype and LSE
    ``[b, h, 1, s]`` f32, every score and sum in f32."""
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), lse[:, :, None, :]


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_flash_operands(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash kernel: {name} is on {t.device}, "
                             "expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel: {name} is not contiguous")
        if t.dtype != q.dtype or t.shape != q.shape \
                or t.device != q.device:
            raise ValueError("flash kernel: q, k, v must share shape, "
                             "dtype and device")
    if q.dim() != 4:
        raise ValueError(f"flash kernel: expected [b, h, s, d], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes float32/bfloat16, got "
                        f"{q.dtype}")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got "
                         f"{q.shape[-1]}")


def flash_attention_forward(q, k, v, scale, causal):
    """K1 on CUDA tensors, its plain version on CPU tensors:
    ``(O, LSE)``. Counts each kernel launch in
    ``flash_attention_forward.launches``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    _check_flash_operands(q, k, v)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, 1, s), dtype=torch.float32, device=q.device)
    if s == 0 or b * h == 0:
        return o, lse
    fn = _build.function(
        "flash_fwd", "flash_attention_forward",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b * h, s, d, float(scale), int(bool(causal)),
             _KERNEL_DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_forward launch failed: CUDA "
                           f"error {err}")
    flash_attention_forward.launches += 1
    return o, lse


flash_attention_forward.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 under autograd. The backward kernels (K2, K3) come with the
    training slice; until then a backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        return flash_attention_forward(q, k, v, scale, causal)[0]

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("flash backward: training slice")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal=False, scale=None):
    """``[b, h, s, d]`` attention (reference ``ops/attention.py:366``).
    CUDA tensors go through K1 (and raise on what it cannot take, a mask
    included); CPU tensors take the plain versions."""
    sc = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    if attn_mask is not None:
        if query.is_cuda:
            raise NotImplementedError(
                "attn_mask: the flash kernel takes no additive mask")
        return reference_attention(query, key, value, attn_mask, float(sc),
                                   bool(is_causal))
    if query.is_cuda:
        return _FlashAttention.apply(query, key, value, float(sc),
                                     bool(is_causal))
    return flash_attention_plain(query, key, value, float(sc),
                                 bool(is_causal))[0]


def cached_slot_attention(q, k_cache, v_cache, lengths):
    """Single-token decode attention over each slot's contiguous cache
    (reference ``ops/attention.py:377``). q ``[S, nh, hd]``; caches
    ``[S, nh, C, hd]``; lengths ``[S]`` live rows including this step's.
    Positions ``>= lengths[s]`` get -1e30 before the f32 softmax. The
    result is f32, as the reference's ``preferred_element_type``."""
    hd = q.shape[-1]
    cache_len = k_cache.shape[2]
    s = torch.einsum("shd,shkd->shk", q.float(), k_cache.float()) \
        / math.sqrt(hd)
    kpos = torch.arange(cache_len, device=q.device)[None, None, :]
    s = torch.where(kpos < lengths[:, None, None], s,
                    torch.full((), _NEG, device=q.device))
    return torch.einsum("shk,shkd->shd", torch.softmax(s, dim=-1),
                        v_cache.float())


def cached_paged_attention(q, k_cache, v_cache, block_tables, lengths):
    """Decode attention over a paged cache (reference
    ``ops/attention.py:407``): gather each slot's blocks into a
    position-ordered view ``[S, nh, MB*BS, hd]`` and defer to
    ``cached_slot_attention``. Caches ``[num_blocks, nh, BS, hd]``,
    block_tables ``[S, MB]``."""
    S, nh, hd = q.shape
    k = k_cache[block_tables.long()]             # [S, MB, nh, BS, hd]
    v = v_cache[block_tables.long()]
    k = k.permute(0, 2, 1, 3, 4).reshape(S, nh, -1, hd)
    v = v.permute(0, 2, 1, 3, 4).reshape(S, nh, -1, hd)
    return cached_slot_attention(q, k, v, lengths)
