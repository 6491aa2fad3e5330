"""Attention: the flash-attention forward kernel (K1), the two backward
kernels (K2 dQ, K3 dK/dV) and the plain PyTorch compositions the decode
paths and the tests use.

Ports ``paddle_tpu/ops/attention.py``. Layout ``[batch, heads, seq,
head_dim]`` as there. Two details are contract, because they give stale
or masked positions exactly zero weight: scores accumulate in f32, and
masked scores are ``-1e30`` (never ``-inf``, so a fully masked row stays
finite).

``scaled_dot_product_attention`` is what the model calls. Without a mask
it goes through ``_FlashAttention``, whose forward is K1 and whose
backward is K2 and K3: on CUDA tensors the hand-written kernels
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` for every shape they
take (and a raise on any other), on CPU tensors their plain versions
``flash_attention_plain`` and ``flash_attention_backward_plain``.
``_FlashAttention``'s forward calls K1 through a ``torch.library``
operator (``torch.ops.paddle_tpu_torch.flash_attention_forward``, with a
fake implementation), registered when this module is imported, so that
``torch.export`` keeps the attention as one node that launches K1.
"""
import ctypes
import math

import torch

from ..amp.auto_cast import cast_inputs, op_body
from ..core.dispatch import register_op
from ..core.tensor import Tensor
from . import _build

# devices whose tensors take the plain forward: the CPU, and "meta",
# where a static program infers an op's output shapes (no data, no
# launch)
_PLAIN_DEVICES = ("cpu", "meta")

_NEG = -1e30
_P_BLOCK = 64     # keys of a K/V tile in the bf16 K1 kernel


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


def flash_attention_plain(q, k, v, scale, causal, p_dtype=None):
    """Plain version of K1: ``(O, LSE)`` with O in q's dtype and LSE
    ``[b, h, 1, s]`` f32, every score and sum in f32.

    ``p_dtype=None`` keeps the weights P in f32. ``torch.bfloat16`` rounds
    P = exp(S - m) to bf16 before the product with V, as the Pallas kernel
    does (attention.py:105) and the bf16 kernel with it: m is the running
    row max of an online softmax over the kernel's 64-key tiles (the
    Pallas kernel's blocks are 128-512 keys, so its m, and with it the
    rounding of P, can differ), and the row sum l adds the unrounded P,
    as both kernels add it."""
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG)
    if p_dtype is None:
        lse = torch.logsumexp(s, dim=-1)
        o = torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, dim=-1),
                         v.float())
        return o.to(q.dtype), lse[:, :, None, :]
    vf = v.float()
    m = torch.full(s.shape[:-1], _NEG, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(vf)
    for j in range(0, s.shape[-1], _P_BLOCK):
        blk = slice(j, j + _P_BLOCK)
        m_new = torch.maximum(m, s[..., blk].amax(-1))
        p = torch.exp(s[..., blk] - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", p.to(p_dtype).float(), vf[:, :, blk])
        m = m_new
    return (acc / l[..., None]).to(q.dtype), (m + torch.log(l))[:, :, None, :]


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
    if q.device.type in _PLAIN_DEVICES:
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


@torch.library.custom_op("paddle_tpu_torch::flash_attention_forward",
                         mutates_args=())
def flash_forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, causal: bool
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 as an operator of torch's dispatcher
    (``torch.ops.paddle_tpu_torch.flash_attention_forward``): the node an
    exported program (``torch.export``) keeps for the attention. It runs
    ``flash_attention_forward``: the kernel on CUDA tensors (or a raise on
    operands it does not take), the plain version on CPU tensors."""
    return flash_attention_forward(q, k, v, scale, causal)


@flash_forward_op.register_fake
def _flash_forward_fake(q, k, v, scale, causal):
    b, h, s, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, 1, s), dtype=torch.float32))


def flash_attention_backward_plain(q, k, v, lse, do, delta, scale, causal,
                                   p_dtype=None):
    """Plain version of K2 and K3: ``(dq, dk, dv)`` from the forward's
    LSE ``[b, h, 1, s]`` and ``delta = rowsum(dO * O)`` (same shape; the
    caller computes it, as the reference does outside its kernels,
    attention.py:286-288), every product summed in f32, the grads cast
    back to the input dtype (reference ``_pallas_flash_bwd_32``,
    attention.py:281-325)::

        P  = exp(S * scale [masked to -1e30] - LSE)
        dS = P * (dO V^T - delta)
        dQ = dS K scale,  dK = dS^T Q scale,  dV = P^T dO

    ``p_dtype=None`` (or ``torch.float32``, the same bits) keeps P and dS
    in f32. ``torch.bfloat16`` rounds P to bf16 before ``P^T dO`` and dS,
    made from the unrounded P, before ``dS K`` and ``dS^T Q``, as the
    Pallas kernels do (attention.py:227, :264, :267) and the bf16 kernels
    with them. P uses the forward's global LSE, so this rounding does not
    depend on the kernels' tiles."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG)
    p = torch.exp(s - lse.transpose(-1, -2))
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    ds = p * (dp - delta.transpose(-1, -2))
    if p_dtype is not None:
        p, ds = p.to(p_dtype).float(), ds.to(p_dtype).float()
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_backward_operands(q, k, v, lse, do, delta):
    _check_flash_operands(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError("flash backward kernel: dO must be a contiguous "
                         "tensor of q's shape, dtype and device")
    want = (*q.shape[:2], 1, q.shape[2])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != want or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash backward kernel: {name} must be a "
                             f"contiguous float32 tensor of shape {want} "
                             "on q's device")


def flash_bwd_dq(q, k, v, lse, do, delta, scale, causal):
    """K2 on CUDA tensors, the dQ of its plain version on CPU tensors
    (P and dS in f32, as in the reference's CPU path, the XLA
    composition; the bf16 kernel rounds them as the Pallas kernels do).
    Counts each kernel launch in ``flash_bwd_dq.launches``."""
    if q.device.type in _PLAIN_DEVICES:
        return flash_attention_backward_plain(q, k, v, lse, do, delta,
                                              scale, causal)[0]
    _check_backward_operands(q, k, v, lse, do, delta)
    b, h, s, d = q.shape
    dq = torch.empty_like(q)
    if s == 0 or b * h == 0:
        return dq
    fn = _build.function(
        "flash_bwd", "flash_attention_backward_dq",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, s, d,
             float(scale), int(bool(causal)), _KERNEL_DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_bwd_dq launch failed: CUDA error {err}")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, lse, do, delta, scale, causal):
    """K3 on CUDA tensors, the ``(dk, dv)`` of its plain version on CPU
    tensors (P and dS in f32, as for ``flash_bwd_dq``). Counts each
    kernel launch in ``flash_bwd_dkv.launches``."""
    if q.device.type in _PLAIN_DEVICES:
        return flash_attention_backward_plain(q, k, v, lse, do, delta,
                                              scale, causal)[1:]
    _check_backward_operands(q, k, v, lse, do, delta)
    b, h, s, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if s == 0 or b * h == 0:
        return dk, dv
    fn = _build.function(
        "flash_bwd", "flash_attention_backward_dkv",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b * h, s, d, float(scale), int(bool(causal)),
             _KERNEL_DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_bwd_dkv launch failed: CUDA error {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_backward(q, k, v, o, lse, do, scale, causal):
    """``(dq, dk, dv)`` of the flash forward (reference
    ``_pallas_flash_bwd``): ``delta = rowsum(dO * O)`` in f32 outside
    the kernels, as the reference computes it (attention.py:286), then
    K2 and K3 (their plain versions on CPU tensors)."""
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    dq = flash_bwd_dq(q, k, v, lse, do, delta, scale, causal)
    dk, dv = flash_bwd_dkv(q, k, v, lse, do, delta, scale, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 under autograd, with K2 and K3 as its backward (the
    reference's ``custom_vjp``, attention.py:330-356). CPU tensors take
    the plain versions of all three."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        with op_body():
            o, lse = flash_forward_op(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, o, lse = ctx.saved_tensors
        if torch.is_grad_enabled():
            # create_graph: the grads must themselves be differentiable
            return _FlashAttentionGrad.apply(
                q, k, v, o.detach(), lse.detach(), grad, ctx.scale,
                ctx.causal) + (None, None)
        # the model's transpose/reshape hands a strided grad
        with op_body():
            dq, dk, dv = flash_attention_backward(q, k, v, o, lse, grad,
                                                  ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


class _FlashAttentionGrad(torch.autograd.Function):
    """The first-order backward as a function of (q, k, v, dO), for a
    double grad (``create_graph=True``) through the attention: its
    forward is K2 and K3 as above; its backward, the second-order terms,
    differentiates the plain composition (``reference_attention``)
    twice with torch's autograd. The reference gives the same value on
    its CPU path, where its custom_vjp's backward is the composition's
    vjp and JAX differentiates that; on its Pallas path JAX fails inside
    the JVP of a ``pallas_call`` (tests/test_torch_autograd.py holds
    both)."""

    @staticmethod
    def forward(ctx, q, k, v, o, lse, do, scale, causal):
        with op_body():
            dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                                  scale, causal)
        ctx.save_for_backward(q, k, v, do)
        ctx.scale, ctx.causal = scale, causal
        return dq, dk, dv

    @staticmethod
    def backward(ctx, gdq, gdk, gdv):
        higher = torch.is_grad_enabled()
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t if higher and t.requires_grad
                   else t.detach().requires_grad_() for t in saved]
            with op_body():
                out = reference_attention(*ins[:3], None, ctx.scale,
                                          ctx.causal)
            first = torch.autograd.grad(out, ins[:3], ins[3],
                                        create_graph=True)
            pairs = [(f, g) for f, g in zip(first, (gdq, gdk, gdv))
                     if g is not None]
            second = torch.autograd.grad(
                [f for f, _ in pairs], ins, [g for _, g in pairs],
                create_graph=higher, allow_unused=True)
        dq2, dk2, dv2, ddo = second
        return dq2, dk2, dv2, None, None, ddo, None, None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
    """``[b, h, s, d]`` attention (reference ``ops/attention.py:366``,
    whose signature this is; ``dropout_p`` and ``training`` are taken
    and, as there, not read). The route follows the reference's
    ``_flash_op`` (attention.py:360-363) and is chosen from the
    arguments alone, before any launch: with an ``attn_mask`` (additive
    float, or bool as torch's own mask is added) the plain composition
    ``reference_attention`` on any device, under torch's autograd;
    without one, CUDA tensors go through K1 and, under autograd, K2/K3
    (and raise on what they cannot take: head_dim other than 64/128,
    f16, q/k/v of unequal shapes), CPU tensors take the plain versions
    through the same autograd function. Under ``amp.auto_cast`` q, k and
    v are cast as the reference casts its ``flash_attention`` op (white
    list: bf16 under O1 and O2). Tensors of the eager core
    (``paddle_tpu_torch.Tensor``) go through the core's
    ``flash_attention`` op, which runs this same function on their
    values."""
    sc = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    if isinstance(query, Tensor):
        return _flash_op(query, key, value, attn_mask, scale=float(sc),
                         causal=bool(is_causal))
    query, key, value = cast_inputs("flash_attention", query, key, value)
    if attn_mask is not None:
        with op_body():
            return reference_attention(query, key, value, attn_mask,
                                       float(sc), bool(is_causal))
    return _FlashAttention.apply(query, key, value, float(sc),
                                 bool(is_causal))


@register_op("flash_attention")
def _flash_op(q, k, v, mask, *, scale, causal):
    """The core's attention op. With a mask it is the reference's
    composition (``_flash_op``, attention.py:360-362), on any device.
    Without one, the Paddle surface's q, k and v are views
    (``transpose`` then ``unbind`` of the fused QKV), so they are made
    contiguous here, a copy, before K1; the grad that reaches K2/K3 is
    made contiguous by ``flash_attention_backward``. An operand the
    kernels cannot take (head_dim 32, f16) still raises on the card."""
    if mask is not None:
        return reference_attention(q, k, v, mask, scale, causal)
    return scaled_dot_product_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), None,
        is_causal=causal, scale=scale)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, name=None):
    """Reference ``ops/attention.py:489``: causal or full attention over
    ``[b, h, s, d]``; ``dropout`` is taken and not read; with
    ``return_softmax`` the weights are ``None``, as there."""
    out = scaled_dot_product_attention(query, key, value, is_causal=causal)
    if return_softmax:
        return out, None
    return out


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


def cached_slot_block_attention(q, k_cache, v_cache, qpos):
    """Multi-query decode attention over each slot's contiguous cache
    (reference ``ops/attention.py:439``), the t-token form of
    ``cached_slot_attention`` the speculative verify programs run. q
    ``[S, nh, t, hd]``; caches ``[S, nh, C, hd]`` holding the t rows this
    dispatch wrote; qpos ``[S, t]`` each query's cache position. Query i
    sees keys at ``kpos <= qpos[s, i]`` only: the live prefix and
    candidates 0..i; the rest get -1e30 before the f32 softmax."""
    hd = q.shape[-1]
    cache_len = k_cache.shape[2]
    s = torch.einsum("shtd,shkd->shtk", q.float(), k_cache.float()) \
        / math.sqrt(hd)
    kpos = torch.arange(cache_len, device=q.device)[None, None, None, :]
    s = torch.where(kpos <= qpos[:, None, :, None], s,
                    torch.full((), _NEG, device=q.device))
    return torch.einsum("shtk,shkd->shtd", torch.softmax(s, dim=-1),
                        v_cache.float())


def cached_paged_block_attention(q, k_cache, v_cache, block_tables, qpos):
    """``cached_slot_block_attention`` over a paged cache (reference
    ``ops/attention.py:472``): each slot's blocks gathered into a
    position-ordered ``[S, nh, MB*BS, hd]`` view, then the per-query
    causal mask. Caches ``[num_blocks, nh, BS, hd]``, block_tables
    ``[S, MB]``."""
    S, nh, _, hd = q.shape
    k = k_cache[block_tables.long()]             # [S, MB, nh, BS, hd]
    v = v_cache[block_tables.long()]
    k = k.permute(0, 2, 1, 3, 4).reshape(S, nh, -1, hd)
    v = v.permute(0, 2, 1, 3, 4).reshape(S, nh, -1, hd)
    return cached_slot_block_attention(q, k, v, qpos)
