"""Fused linear + softmax cross-entropy: the tied LM head (K5, K6, K7).

Ports the single-device part of ``paddle_tpu/ops/fused_ce.py``. The head
computes ``logits = x @ W.T`` over the whole vocab and reduces them at
once to one loss per token; the kernels stream vocab tiles with an
online logsumexp, so the ``[T, V]`` logits never reach device memory in
either direction. The weight is ``[V, H]``, the embedding's layout, so
a tied head passes ``word_embeddings.weight`` with no transpose.

``fused_linear_cross_entropy`` is what the model calls. It goes through
``_FusedLinearCrossEntropy``, whose forward is K5 and whose backward is
K6 (dx) and K7 (dW), from the forward's saved LSE as the reference's
``custom_vjp`` does: on CUDA tensors the hand-written kernels of
``csrc/fused_ce.cu`` (and a raise on what they cannot take), on CPU
tensors their plain versions. The reference's gates (``_use_pallas``,
``PADDLE_FUSED_CE*``) have no counterpart: on the card the op always
launches the kernels. The vocab-split variant for tensor parallelism
(``fused_linear_cross_entropy_tp``) runs the same kernels on each
rank's shard, combined by all-reduces (see its section below).

A label outside ``[0, V)`` that is not ``ignore_index`` is undefined:
the reference's composition clips it into range, its kernels give it a
label logit of 0, and so do the port's plain version and kernel
respectively.
"""
import ctypes

import torch

from ..amp.auto_cast import cast_inputs, op_body
from . import _build

# devices whose tensors take the plain forward: the CPU, and "meta",
# where a static program infers an op's output shapes (no data, no
# launch)
_PLAIN_DEVICES = ("cpu", "meta")

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_DTYPES = {torch.int32: 0, torch.int64: 1}
# K5's (rows of a token or vocab tile, blocks per SM the vocab split aims
# at), by dtype: both kernels run 128 x 128 tiles, the f32 one (CUDA
# cores) one block an SM at a time, the bf16 one (tensor cores) two, so at
# T = 8192 the split (33 splits of 12 tiles) runs 16 waves of blocks in
# f32 and 8 in bf16
_FWD_SPLIT = {torch.float32: (128, 16), torch.bfloat16: (128, 16)}


def fused_linear_cross_entropy_plain(x, w_vh, labels, ignore_index=-100):
    """Plain version of K5 (the reference ``_reference``, :262):
    ``(loss [T], lse [T])``, both f32, every product and sum in f32;
    ``ignore_index`` rows lose 0."""
    logits = x.float() @ w_vh.float().t()
    lse = torch.logsumexp(logits, dim=-1)
    pick = labels.long().clamp(0, w_vh.shape[0] - 1)[:, None]
    ll = logits.gather(1, pick)[:, 0]
    loss = torch.where(labels != ignore_index, lse - ll, torch.zeros_like(lse))
    return loss, lse


def fused_linear_cross_entropy_backward_plain(x, w_vh, labels, lse, g,
                                              ignore_index=-100,
                                              d_dtype=None):
    """Plain version of K6 and K7: ``(dx, dW)`` in x's and W's dtypes
    from the forward's LSE and the per-token cotangent ``g`` (the
    reference ``_dtile`` :172 with the two products of K6/K7)::

        d  = (exp(x W^T - lse) - onehot(labels)) * g * valid
        dx = d W,   dW = d^T x

    Every product and sum is f32. ``d_dtype=None`` keeps d f32 through
    both products, as ``_xla_bwd`` does (:301-308); ``torch.bfloat16``
    rounds d to bf16 first, as the Pallas kernels do (:195, :211) and
    the bf16 K6/K7 kernels with them."""
    xf, wf = x.float(), w_vh.float()
    p = torch.exp(xf @ wf.t() - lse[:, None])
    col = torch.arange(w_vh.shape[0], device=x.device)
    onehot = (col[None, :] == labels.long()[:, None]).float()
    valid = (labels != ignore_index).float()
    d = (p - onehot) * (g.float() * valid)[:, None]
    if d_dtype is not None:
        d = d.to(d_dtype).float()
    return (d @ wf).to(x.dtype), (d.t() @ xf).to(w_vh.dtype)


def _check_operands(x, w_vh, labels, *stats):
    """What the kernels take: CUDA, contiguous, x [T, H] and W [V, H] of
    one float dtype (f32 or bf16), int32/int64 labels [T] and f32 [T]
    statistics, all on one device."""
    if x.dim() != 2 or w_vh.dim() != 2 or x.shape[1] != w_vh.shape[1]:
        raise ValueError(f"fused CE kernel: expected x [T, H] and W [V, H], "
                         f"got {tuple(x.shape)} and {tuple(w_vh.shape)}")
    if x.dtype != w_vh.dtype or x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused CE kernel takes x and W both float32 or both "
                        f"bfloat16, got {x.dtype} and {w_vh.dtype}")
    if labels.dtype not in _LABEL_DTYPES:
        raise TypeError(f"fused CE kernel takes int32/int64 labels, got "
                        f"{labels.dtype}")
    if tuple(labels.shape) != (x.shape[0],):
        raise ValueError(f"fused CE kernel: labels must be [{x.shape[0]}], "
                         f"got {tuple(labels.shape)}")
    if w_vh.shape[0] == 0:
        raise ValueError("fused CE kernel: the vocab is empty")
    for name, t in (("x", x), ("W", w_vh), ("labels", labels)) + stats:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"fused CE kernel: {name} is on {t.device}, "
                             "expected x's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"fused CE kernel: {name} is not contiguous")
    for name, t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (x.shape[0],):
            raise ValueError(f"fused CE kernel: {name} must be float32 "
                             f"[{x.shape[0]}]")


def vocab_split(t, v, tile, per_sm, sms):
    """(nsplit, tiles_per_split) for K5 at T = ``t``, V = ``v`` on a card
    of ``sms`` SMs: split the ``tile``-row vocab tiles until the grid of
    ``tile``-row token tiles by splits has about ``per_sm`` blocks per SM,
    with no empty split."""
    n_vt = -(-v // tile)
    row_tiles = -(-t // tile)
    want = max(1, min(n_vt, -(-per_sm * sms // row_tiles)))
    per = -(-n_vt // want)
    return -(-n_vt // per), per


def _vocab_split(t, v, dtype, device):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return vocab_split(t, v, *_FWD_SPLIT[dtype], sms)


def fused_ce_forward(x, w_vh, labels, ignore_index=-100):
    """K5 on CUDA tensors, its plain version on CPU tensors:
    ``(loss, lse)``. Counts each kernel launch in
    ``fused_ce_forward.launches``."""
    if x.device.type in _PLAIN_DEVICES:
        return fused_linear_cross_entropy_plain(x, w_vh, labels, ignore_index)
    _check_operands(x, w_vh, labels)
    t, h = x.shape
    v = w_vh.shape[0]
    loss = torch.empty(t, dtype=torch.float32, device=x.device)
    lse = torch.empty(t, dtype=torch.float32, device=x.device)
    if t == 0:
        return loss, lse
    nsplit, per = _vocab_split(t, v, x.dtype, x.device)
    part = torch.empty((3, nsplit, t), dtype=torch.float32, device=x.device)
    fn = _build.function(
        "fused_ce", "fused_ce_forward",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), w_vh.data_ptr(), labels.data_ptr(),
             part.data_ptr(), loss.data_ptr(), lse.data_ptr(), t, v, h,
             nsplit, per, int(ignore_index), _KERNEL_DTYPES[x.dtype],
             _LABEL_DTYPES[labels.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_ce_forward launch failed: CUDA error {err}")
    fused_ce_forward.launches += 1
    return loss, lse


fused_ce_forward.launches = 0


def _backward_kernel(symbol, x, w_vh, labels, lse, g, ignore_index, out):
    _check_operands(x, w_vh, labels, ("lse", lse), ("g", g))
    t, h = x.shape
    if out.numel() == 0:
        return False
    if t == 0:          # no token: dW is zero
        out.zero_()
        return False
    fn = _build.function(
        "fused_ce", symbol,
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), w_vh.data_ptr(), labels.data_ptr(),
             lse.data_ptr(), g.data_ptr(), out.data_ptr(), t,
             w_vh.shape[0], h, int(ignore_index), _KERNEL_DTYPES[x.dtype],
             _LABEL_DTYPES[labels.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    return True


def fused_ce_bwd_dx(x, w_vh, labels, lse, g, ignore_index=-100):
    """K6 on CUDA tensors, the dx of the plain backward on CPU tensors.
    Counts each kernel launch in ``fused_ce_bwd_dx.launches``."""
    if x.device.type in _PLAIN_DEVICES:
        return fused_linear_cross_entropy_backward_plain(
            x, w_vh, labels, lse, g, ignore_index)[0]
    dx = torch.empty_like(x)
    if _backward_kernel("fused_ce_backward_dx", x, w_vh, labels, lse, g,
                        ignore_index, dx):
        fused_ce_bwd_dx.launches += 1
    return dx


fused_ce_bwd_dx.launches = 0


def fused_ce_bwd_dw(x, w_vh, labels, lse, g, ignore_index=-100):
    """K7 on CUDA tensors, the dW of the plain backward on CPU tensors.
    Counts each kernel launch in ``fused_ce_bwd_dw.launches``."""
    if x.device.type in _PLAIN_DEVICES:
        return fused_linear_cross_entropy_backward_plain(
            x, w_vh, labels, lse, g, ignore_index)[1]
    dw = torch.empty_like(w_vh)
    if _backward_kernel("fused_ce_backward_dw", x, w_vh, labels, lse, g,
                        ignore_index, dw):
        fused_ce_bwd_dw.launches += 1
    return dw


fused_ce_bwd_dw.launches = 0


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """K5 under autograd, with K6 and K7 as its backward from the saved
    LSE (the reference's ``custom_vjp``, :279-324). CPU tensors take the
    plain versions of all three."""

    @staticmethod
    def forward(ctx, x, w_vh, labels, ignore_index):
        with op_body():
            loss, lse = fused_ce_forward(x, w_vh, labels, ignore_index)
        ctx.save_for_backward(x, w_vh, labels, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w_vh, labels, lse = ctx.saved_tensors
        with op_body():
            # the mean over tokens hands an expanded (stride-0) grad
            g = g.float().contiguous()
            dx = dw = None
            if ctx.needs_input_grad[0]:
                dx = fused_ce_bwd_dx(x, w_vh, labels, lse, g,
                                     ctx.ignore_index)
            if ctx.needs_input_grad[1]:
                dw = fused_ce_bwd_dw(x, w_vh, labels, lse, g,
                                     ctx.ignore_index)
        return dx, dw, None, None


def fused_linear_cross_entropy(x, weight_vh, labels, ignore_index=-100):
    """Per-token loss ``[T]`` f32 for ``logits = x @ weight_vh.T``
    (reference ``fused_linear_cross_entropy``, :337): x ``[T, H]``,
    weight ``[V, H]``, labels ``[T]`` int. ``ignore_index`` rows lose 0
    and get zero gradient; reduce outside. Under ``amp.auto_cast`` x and
    the weight are cast as the reference's dispatcher casts this op (it
    is on the white list: bf16 under O1 and O2)."""
    x, weight_vh = cast_inputs("fused_linear_cross_entropy", x,
                                   weight_vh)
    return _FusedLinearCrossEntropy.apply(x.contiguous(),
                                          weight_vh.contiguous(),
                                          labels.contiguous(),
                                          int(ignore_index))



# ---- tensor-parallel (vocab-split) variant -----------------------------------
#
# Reference fused_ce.py:361-519, after Paddle's
# c_softmax_with_cross_entropy_op.cu: each ``mp`` rank holds the rows
# ``[r·V/n, (r+1)·V/n)`` of the weight, runs K5 on its shard with the
# labels shifted into it, and the ranks combine their logsumexp and label
# log-likelihood by an all-reduce max and an all-reduce sum. The backward
# runs K6/K7 on the shard with the *global* LSE (so each shard's
# recomputed tile exponentiates to its slice of the global softmax) and
# the cotangent zeroed on ignored rows; dx is summed over the ranks, dW is
# the rank's own shard. Over ``dp`` the grads are averaged by the model's
# wrapper (``DataParallel``/``TensorParallel``) with every other grad,
# where the reference's single program sums dW over its ``dp`` axis here.

# out-of-vocab sentinel of ignored rows (the reference's): the kernels
# take it as ignore_index, so every other row is "valid" to them and
# validity is applied outside (ignore_index must be global: a shifted
# ignore label could land on a real local id). The shift is int64, so
# the sentinel minus a rank's offset stays far below 0, a miss.
_NEVER = -(2 ** 31 - 123)


def tp_local_forward_plain(x, w_local, shifted):
    """The plain per-shard forward (reference ``_local_fwd``, :379-395):
    ``(loss_l, lse_l)`` f32 with a label outside ``[0, V/n)`` a miss (a
    label logit of 0, never clipped into range), as K5 treats it."""
    logits = x.float() @ w_local.float().t()
    lse = torch.logsumexp(logits, dim=-1)
    v_l = w_local.shape[0]
    hit = (shifted >= 0) & (shifted < v_l)
    ll = torch.where(hit, logits.gather(
        1, shifted.clamp(0, v_l - 1)[:, None])[:, 0], torch.zeros_like(lse))
    return lse - ll, lse


def _tp_shift(labels, ignore_index, rank, v_local):
    lab = labels.long()
    valid = lab != int(ignore_index)
    shifted = torch.where(valid, lab, torch.full_like(lab, _NEVER)) \
        - rank * v_local
    return shifted.contiguous(), valid


def tp_forward(x, w_local, labels, group, ignore_index=-100):
    """``(loss, lse_g)``: the shard's K5 (its plain version on the CPU)
    and the combine over ``group``."""
    from ..distributed import collective
    shifted, valid = _tp_shift(labels, ignore_index, group.rank,
                               w_local.shape[0])
    if x.device.type in _PLAIN_DEVICES:
        loss_l, lse_l = tp_local_forward_plain(x, w_local, shifted)
    else:
        loss_l, lse_l = fused_ce_forward(x, w_local, shifted, _NEVER)
    m = lse_l.clone()
    collective.all_reduce(m, op="max", group=group)
    stats = torch.stack([torch.exp(lse_l - m), lse_l - loss_l])
    collective.all_reduce(stats, group=group)
    lse_g = m + torch.log(stats[0])
    loss = torch.where(valid, lse_g - stats[1], torch.zeros_like(lse_g))
    return loss, lse_g


def tp_backward(x, w_local, labels, lse_g, g, group, ignore_index=-100,
                need_dx=True, need_dw=True):
    """``(dx, dW_local)``: K6/K7 on the shard (their plain version on the
    CPU) with the global LSE and ``g`` zeroed on ignored rows; dx summed
    over ``group``."""
    from ..distributed import collective
    shifted, valid = _tp_shift(labels, ignore_index, group.rank,
                               w_local.shape[0])
    g_eff = (g.float() * valid.float()).contiguous()
    lse_g = lse_g.contiguous()
    dx = dw = None
    if need_dx:
        dx = fused_ce_bwd_dx(x, w_local, shifted, lse_g, g_eff, _NEVER)
        collective.all_reduce(dx, group=group)
    if need_dw:
        dw = fused_ce_bwd_dw(x, w_local, shifted, lse_g, g_eff, _NEVER)
    return dx, dw


class _FusedLinearCrossEntropyTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_local, labels, group, ignore_index):
        with op_body():
            loss, lse_g = tp_forward(x, w_local, labels, group, ignore_index)
        ctx.save_for_backward(x, w_local, labels, lse_g)
        ctx.group, ctx.ignore_index = group, ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w_local, labels, lse_g = ctx.saved_tensors
        with op_body():
            dx, dw = tp_backward(x, w_local, labels, lse_g, g, ctx.group,
                                 ctx.ignore_index, ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1])
        return dx, dw, None, None, None


def tp_fused_applicable(mesh, t, h, v):
    """Reference :497: a mesh with an ``mp`` axis above 1 that divides
    the vocab, no pipeline stages (they slice the program before the
    head), and tokens that divide over ``dp``."""
    if mesh is None or "mp" not in mesh.axis_names:
        return False
    mp = int(mesh.shape["mp"])
    if mp <= 1 or v % mp != 0:
        return False
    if int(mesh.shape.get("pp", 1)) != 1:
        return False
    dp = int(mesh.shape.get("dp", 1))
    return t % max(dp, 1) == 0


def fused_linear_cross_entropy_tp(x, weight_local, labels, group,
                                  ignore_index=-100):
    """Per-token loss ``[T]`` f32 of the vocab-split head (reference
    ``fused_linear_cross_entropy_tp``, :505): x ``[T, H]`` (whole on
    every rank of ``group``), ``weight_local`` this rank's ``[V/n, H]``
    rows of the weight, labels ``[T]`` global ids. Cast under
    ``amp.auto_cast`` as the single-device op."""
    x, weight_local = cast_inputs("fused_linear_cross_entropy", x,
                                  weight_local)
    return _FusedLinearCrossEntropyTP.apply(
        x.contiguous(), weight_local.contiguous(), labels.contiguous(),
        group, int(ignore_index))
