"""Transformer layers (a port of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention``, ``TransformerEncoderLayer`` /
``TransformerEncoder``, ``TransformerDecoderLayer`` /
``TransformerDecoder`` and ``Transformer``.

``MultiHeadAttention`` attends by one of two routes, chosen from the
call's shapes and flags alone (never by catching an error):

* the core's ``flash_attention`` op (``nn.functional.
  scaled_dot_product_attention``), so K1 forward and K2/K3 backward on
  the card, whenever it computes the reference's composition
  (transformer.py:57-77): no ``cache``, ``need_weights=False``, no
  active attention dropout (``dropout == 0`` or eval), query and key /
  value of one length, head_dim 64 or 128 in f32 or bf16. A mask goes
  to the op as it is, and the op computes the reference's composition
  for it;
* otherwise the reference's composition itself: ``scale(q) @ k^T``,
  the mask added, softmax, dropout on the weights, ``@ v``.

The two routes differ in how they compute, not in what: the flash route
sums the scores in f32 in 64-key tiles where the composition takes one
softmax over the row.
"""
import copy

import torch

from ...core.device import resolve_device
from ...core.tensor import Tensor
from ...ops import attention as attn_ops
from ...ops import manipulation, nn_ops
from ...ops import math as math_ops
from ..layer_base import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

_FLASH_HEAD_DIMS = (64, 128)
_FLASH_DTYPES = (torch.float32, torch.bfloat16)


def _convert_attn_mask(attn_mask, dtype):
    """A bool mask (True = attend) as an additive one, 0 / -1e9 in
    ``dtype``; an additive mask as it is."""
    if attn_mask is None:
        return None
    v = attn_mask.value
    if v.dtype == torch.bool:
        neg = torch.full((), -1e9, dtype=dtype, device=v.device)
        return Tensor._wrap(
            torch.where(v, torch.zeros((), dtype=dtype, device=v.device),
                        neg))
    return attn_mask


class MultiHeadAttention(Layer):
    """Reference ``nn.MultiHeadAttention``: q/k/v/out projections and
    scaled dot-product attention, with a K/V ``cache`` for decoding."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        b, s, _ = x.shape
        x = manipulation.reshape(x, (b, s, self.num_heads, self.head_dim))
        return manipulation.transpose(x, (0, 2, 1, 3))

    def flash_route(self, q, k, v, cache=None):
        """True when this call attends through the core's flash op: the
        conditions of the module docstring, read from q, k, v (already
        split into heads) and the flags."""
        return (cache is None and not self.need_weights
                and not (self.dropout and self.training)
                and q.shape == k.shape == v.shape
                and self.head_dim in _FLASH_HEAD_DIMS
                and q._v.dtype in _FLASH_DTYPES)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        if cache is not None:
            k = manipulation.concat([cache[0], k], axis=2)
            v = manipulation.concat([cache[1], v], axis=2)
            new_cache = (k, v)
        scale = self.head_dim ** -0.5
        attn_mask = _convert_attn_mask(attn_mask, q._v.dtype)
        weights = None
        if self.flash_route(q, k, v, cache):
            out = attn_ops.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, scale=scale)
        else:
            qk = math_ops.matmul(math_ops.scale(q, scale), k,
                                 transpose_y=True)
            if attn_mask is not None:
                qk = math_ops.add(qk, attn_mask)
            weights = nn_ops.softmax(qk, axis=-1)
            if self.dropout:
                weights = nn_ops.dropout(weights, p=self.dropout,
                                         training=self.training)
            out = math_ops.matmul(weights, v)
        out = manipulation.transpose(out, (0, 2, 1, 3))
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(manipulation.reshape(out, (b, s,
                                                       self.embed_dim)))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None:
            outs.append(new_cache)
        return out if len(outs) == 1 else tuple(outs)

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """An empty cache ``(k, v)``, each ``[b, heads, 0, head_dim]``,
        on key's device."""
        shape = (key.shape[0], self.num_heads, 0, self.head_dim)
        dev = key._v.device
        return (Tensor._wrap(torch.zeros(shape, device=dev)),
                Tensor._wrap(torch.zeros(shape, device=dev)))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(nn_ops, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        src = math_ops.add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = math_ops.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, incremental_cache)


class TransformerEncoder(Layer):
    """``num_layers`` deep copies of ``encoder_layer`` (the copies keep
    its Parameter names, as the reference's deepcopy does: give an
    optimizer ``named_parameters()`` to key its state by path)."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, cache[i] = mod(output, src_mask, cache[i])
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, cache)


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(nn_ops, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        tgt = math_ops.add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = math_ops.add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = math_ops.add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        for mod in self.layers:
            output = mod(output, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.encoder = TransformerEncoder(
                enc_layer, num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.decoder = TransformerDecoder(
                dec_layer, num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """``[length, length]`` f32: 0 on and below the diagonal, -1e9
        above it, on the current device."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=resolve_device()).tril()
        return Tensor._wrap(torch.zeros(keep.shape, device=keep.device)
                            .masked_fill(~keep, -1e9))
