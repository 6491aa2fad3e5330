"""Quantization: QAT fake-quant layers, post-training calibration and
W8A8 int8 inference (a port of ``paddle_tpu/quantization/__init__.py``).

Reference parity: python/paddle/fluid/contrib/slim/quantization/ —
ImperativeQuantAware (imperative/qat.py:42), the fake_quantize ops
(paddle/fluid/operators/fake_quantize_op.cc: abs_max,
moving_average_abs_max, channel_wise_abs_max) and
PostTrainingQuantization (post_training_quantization.py).

The fake quant-dequant ops are registered under the reference's names,
so they record into a static ``Program`` (``jit.save``). Their numerics
are the reference's order of operations: ``round(x / s * qmax)`` (round
half to even), clipped to ``[-qmax, qmax]``, then ``q * s / qmax`` as
XLA computes it (times the f32 reciprocal of the constant qmax), with
``s = max(scale, 1e-8)``; the gradient is the straight-through estimator
(``_QDQSTE``: the incoming grad to ``x``, none to the scale).

``Int8Linear`` is W8A8: its weight int8 ``[in, out]`` with one scale an
output channel, computed in numpy from the float weight as the
reference's (so both packages hold the same bytes); the activation is
quantized per tensor from its own abs-max, on the device (no host read,
so the product captures); the product accumulates in int32. On the CPU
that product is ``a.int() @ b.int()`` (exact); on the card it is
``torch._int_mm`` (cuBLAS's int8 GEMM, as the reference runs XLA's
``dot_general`` with an int32 result outside any Pallas kernel), whose
rules (more than 16 rows; inner and output sizes multiples of 8) are
checked first: an operand it cannot take raises, naming the rule.
``Int8Conv2D`` is weight-only: dequantize, then the normal conv.
"""
import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.tensor import Tensor
from ..nn.layer.common import Linear
from ..nn.layer.conv import Conv2D
from ..nn.layer_base import Layer
from ..ops import nn_ops


# ---------------------------------------------------------------------------
# fake quant-dequant primitives (STE gradient)
# ---------------------------------------------------------------------------

def _qdq(x, scale, qmax):
    s = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    # the reference writes q * s / qmax; XLA turns the division by the
    # constant into a product with its f32 reciprocal, and so does this,
    # for the reference's bits
    return q * s * float(np.float32(1.0) / np.float32(qmax))


class _QDQSTE(torch.autograd.Function):
    """Quantize-dequantize with the straight-through estimator: the
    grad passes to ``x`` unchanged, none to the scale."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        return _qdq(x, scale, qmax)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _qdq_ste(x, scale, qmax):
    return _QDQSTE.apply(x, scale.detach(), qmax)


@register_op("fake_quantize_dequantize_abs_max")
def _fake_qdq_abs_max(x, *, bits):
    """Reference: fake_quantize_dequantize_abs_max op — per-tensor scale
    from the current batch's abs-max."""
    qmax = float(2 ** (bits - 1) - 1)
    return _qdq_ste(x, torch.amax(x.abs()), qmax)


@register_op("fake_channel_wise_quantize_dequantize_abs_max")
def _fake_qdq_channel(x, *, bits, axis):
    """Reference: fake_channel_wise_quantize_dequantize_abs_max — one
    scale per output channel (weights)."""
    qmax = float(2 ** (bits - 1) - 1)
    red = tuple(i for i in range(x.dim()) if i != axis)
    return _qdq_ste(x, torch.amax(x.abs(), dim=red, keepdim=True), qmax)


@register_op("fake_quantize_dequantize_moving_average_abs_max")
def _fake_qdq_moving(x, in_scale, *, bits):
    qmax = float(2 ** (bits - 1) - 1)
    return _qdq_ste(x, in_scale, qmax)


@register_op("moving_average_scale_update", differentiable=False)
def _ma_update(x, scale, accum, state, *, rate, algo):
    """Reference: moving_average_abs_max_scale op (EMA of batch abs-max);
    algo="abs_max" keeps the running max instead — the PTQ calibration
    rule (post_training_quantization.py abs_max algo)."""
    cur = torch.amax(x.abs()).to(torch.float32)
    state_n = rate * state + 1.0
    if algo == "abs_max":
        scale_n = torch.maximum(scale, cur)
        accum_n = scale_n
    else:
        accum_n = rate * accum + cur
        scale_n = accum_n / state_n
    return scale_n, accum_n, state_n


def quant_dequant_abs_max(x, bits=8):
    return _fake_qdq_abs_max(x, bits=bits)


def quant_dequant_channel_wise(x, bits=8, axis=0):
    return _fake_qdq_channel(x, bits=bits, axis=axis)


# ---------------------------------------------------------------------------
# QAT layers (reference: python/paddle/nn/quant/quant_layers.py)
# ---------------------------------------------------------------------------

def _zero_scalar():
    from ..core import device as device_mod
    return Tensor._wrap(torch.zeros((), dtype=torch.float32,
                                    device=device_mod.resolve_device()))


class FakeQuantMovingAverageAbsMax(Layer):
    """Activation quantizer: EMA abs-max scale updated in training,
    frozen in eval (reference: quant_layers.FakeQuantMovingAverageAbsMax)."""

    def __init__(self, bits=8, moving_rate=0.9, algo="ema", name=None):
        super().__init__()
        self._bits = bits
        self._rate = float(moving_rate)
        self._algo = algo
        # a Python flag, not a device read: the eval forward stays
        # recordable (jit.save) and capturable, with no host sync a layer
        self._calibrated = False
        self.register_buffer("scale", _zero_scalar())
        self.register_buffer("accum", _zero_scalar())
        self.register_buffer("state", _zero_scalar())

    def forward(self, x):
        if self.training:
            s, a, st = _ma_update(x, self.scale, self.accum, self.state,
                                  rate=self._rate, algo=self._algo)
            self.scale.value = s.value
            self.accum.value = a.value
            self.state.value = st.value
            self._calibrated = True
        elif not self._calibrated:
            # never calibrated: dynamic per-batch scale instead of the
            # uninitialized observer (which would collapse activations)
            return _fake_qdq_abs_max(x, bits=self._bits)
        return _fake_qdq_moving(x, self.scale, bits=self._bits)

    def _after_load_state_dict(self):
        # calibration is derivable from the loaded buffers: any training
        # step leaves scale > 0 (abs_max) or state > 0 (ema); an all-zero
        # checkpoint clears the flag, or eval would quantize through a
        # scale of 0 and collapse the activations
        self._calibrated = bool(float(self.scale.numpy()) > 0
                                or float(self.state.numpy()) > 0)


class QuantizedLinear(Layer):
    """Linear with fake-quantized weight (channel-wise abs-max) and
    activation (moving-average abs-max)."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="channel_wise_abs_max",
                 act_algo="ema"):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self._wbits = weight_bits
        self._wtype = weight_quantize_type
        self._act_quant = FakeQuantMovingAverageAbsMax(activation_bits,
                                                       moving_rate, act_algo)

    def forward(self, x):
        x = self._act_quant(x)
        if self._wtype == "abs_max":
            w = _fake_qdq_abs_max(self.weight, bits=self._wbits)
        else:
            w = _fake_qdq_channel(self.weight, bits=self._wbits, axis=1)
        return nn_ops.linear(x, w, self.bias)


class QuantizedConv2D(Layer):
    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="channel_wise_abs_max",
                 act_algo="ema"):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self._stride = layer._stride
        self._padding = layer._padding
        self._dilation = layer._dilation
        self._groups = layer._groups
        self._data_format = layer._data_format
        self._wbits = weight_bits
        self._wtype = weight_quantize_type
        self._act_quant = FakeQuantMovingAverageAbsMax(activation_bits,
                                                       moving_rate, act_algo)

    def forward(self, x):
        x = self._act_quant(x)
        if self._wtype == "abs_max":
            w = _fake_qdq_abs_max(self.weight, bits=self._wbits)
        else:
            w = _fake_qdq_channel(self.weight, bits=self._wbits, axis=0)
        return nn_ops.conv2d(x, w, self.bias, self._stride, self._padding,
                             self._dilation, self._groups, self._data_format)


_QUANT_WRAPPERS = {"Linear": (Linear, QuantizedLinear),
                   "Conv2D": (Conv2D, QuantizedConv2D)}


class ImperativeQuantAware:
    """Dygraph QAT (reference: imperative/qat.py:42): walks the
    model, swaps quantizable layers for quantized wrappers in place."""

    def __init__(self, quantizable_layer_type=("Conv2D", "Linear"),
                 weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 weight_bits=8, activation_bits=8, moving_rate=0.9):
        unsupported = [t for t in quantizable_layer_type
                       if t not in _QUANT_WRAPPERS]
        if unsupported:
            raise ValueError(
                f"unsupported quantizable_layer_type {unsupported}; "
                f"supported: {sorted(_QUANT_WRAPPERS)}")
        self._types = tuple(quantizable_layer_type)
        self._wtype = weight_quantize_type
        self._wbits = weight_bits
        self._abits = activation_bits
        self._rate = moving_rate
        self._act_algo = ("abs_max"
                          if activation_quantize_type == "abs_max" else "ema")

    def quantize(self, model):
        self._quantize_sublayers(model)
        return model

    def _quantize_sublayers(self, layer):
        for name, sub in list(layer._sub_layers.items()):
            replaced = False
            for tname in self._types:
                base, wrapper = _QUANT_WRAPPERS[tname]
                if isinstance(sub, base):
                    layer._sub_layers[name] = wrapper(
                        sub, self._wbits, self._abits, self._rate,
                        self._wtype, self._act_algo)
                    replaced = True
                    break
            if not replaced:
                self._quantize_sublayers(sub)

    def save_quantized_model(self, model, path, input_spec=None):
        from .. import jit
        model.eval()
        jit.save(model, path, input_spec=input_spec)


class PostTrainingQuantization:
    """PTQ calibration (reference: post_training_quantization.py, abs-max
    algo): feed calibration batches, collect per-layer activation scales,
    then freeze them into quantized wrappers."""

    def __init__(self, model, quantizable_layer_type=("Conv2D", "Linear"),
                 weight_bits=8, activation_bits=8, algo="abs_max"):
        self._model = model
        self._types = tuple(quantizable_layer_type)
        self._wbits = weight_bits
        self._abits = activation_bits
        self._algo = algo
        self._qat = ImperativeQuantAware(
            quantizable_layer_type=quantizable_layer_type,
            activation_quantize_type=("abs_max" if algo == "abs_max"
                                      else "moving_average_abs_max"),
            weight_bits=weight_bits, activation_bits=activation_bits)

    def sample(self, *batches):
        """Run calibration forwards with the MODEL in inference mode
        (dropout off, batch-norm frozen — reference PTQ runs inference
        passes) while only the quant observers update."""
        if not getattr(self, "_quantized", False):
            self._qat.quantize(self._model)
            self._quantized = True
        self._model.eval()
        for obs in self._observers(self._model):
            obs.training = True
        try:
            outs = [self._model(b) for b in batches]
        finally:
            for obs in self._observers(self._model):
                obs.training = False
        return outs

    @staticmethod
    def _observers(layer):
        found = []
        for sub in layer._sub_layers.values():
            if isinstance(sub, FakeQuantMovingAverageAbsMax):
                found.append(sub)
            found.extend(PostTrainingQuantization._observers(sub))
        return found

    def convert(self):
        """Freeze observers: eval mode stops scale updates."""
        self._model.eval()
        return self._model


# ---------------------------------------------------------------------------
# int8 inference execution
# ---------------------------------------------------------------------------

def int8_matmul_plain(a, b):
    """int8 ``a [M, K]`` x int8 ``b [K, N]``, exact int32 sums (an f32
    product would round past 2^24: 127^2 x 3072 is more)."""
    return a.to(torch.int32) @ b.to(torch.int32)


def check_int_mm(m, k, n):
    """Raise naming the rule of ``torch._int_mm`` that an ``[m, k] x
    [k, n]`` product on the card breaks."""
    if m <= 16:
        raise ValueError(
            f"int8 product on CUDA: torch._int_mm needs more than 16 rows; "
            f"this activation has {m} (batch x sequence)")
    if k % 8 or n % 8:
        raise ValueError(
            f"int8 product on CUDA: torch._int_mm needs the inner and output "
            f"sizes to be multiples of 8; got K = {k}, N = {n}")


def int8_matmul(a, b):
    """int8 x int8 -> int32. On the CPU the plain product; on the card
    ``torch._int_mm``, after checking its rules (raises naming the one
    an operand breaks; nothing falls back)."""
    if not a.is_cuda:
        return int8_matmul_plain(a, b)
    check_int_mm(a.shape[0], a.shape[1], b.shape[1])
    return torch._int_mm(a.contiguous(), b)


@register_op("int8_linear", differentiable=False)
def _int8_linear_op(x, w_q, w_scale, bias):
    """x fp -> dynamic per-tensor int8; w_q int8 [in, out] with
    per-out-channel scales; accumulate in int32, rescale to fp32."""
    sx = torch.clamp_min(torch.amax(x.abs()) / 127.0, 1e-8)
    x_q = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    k, n = w_q.shape
    acc = int8_matmul(x_q.reshape(-1, k), w_q).reshape(*x.shape[:-1], n)
    out = acc.to(torch.float32) * (sx * w_scale)
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)  # keep the pipeline's compute dtype


@register_op("int8_dequant_weight_oihw", differentiable=False)
def _int8_dequant_w(w_q, w_scale):
    """Weight-only dequant (per-out-channel, OIHW)."""
    return w_q.to(torch.float32) * w_scale[:, None, None, None]


def _int8_buffers(layer, w, scale):
    dev = layer.weight._v.device
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    w_q = Tensor._wrap(torch.from_numpy(q).to(dev))
    w_scale = Tensor._wrap(torch.from_numpy(
        np.ascontiguousarray(scale.reshape(-1).astype(np.float32))).to(dev))
    return w_q, w_scale


class Int8Linear(Layer):
    """W8A8 linear for inference (int32 accumulation)."""

    def __init__(self, layer):
        super().__init__()
        w = np.asarray(layer.weight.numpy())        # [in, out]
        scale = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
        w_q, w_scale = _int8_buffers(layer, w, scale[None, :])
        self.register_buffer("w_q", w_q, persistable=True)
        self.register_buffer("w_scale", w_scale, persistable=True)
        self.bias = layer.bias

    def forward(self, x):
        v, (k, n) = x._v, self.w_q.shape
        if v.device.type == "cuda":
            # at the call, not when a lazy graph runs the product
            check_int_mm(v.numel() // k, k, n)
        return _int8_linear_op(x, self.w_q, self.w_scale, self.bias)


class Int8Conv2D(Layer):
    """Weight-only-int8 conv for inference: dequant op + the normal
    conv2d path (padding/data_format semantics stay in ONE place)."""

    def __init__(self, layer):
        super().__init__()
        w = np.asarray(layer.weight.numpy())        # [out, in, kh, kw]
        scale = np.maximum(np.abs(w).reshape(w.shape[0], -1)
                           .max(axis=1), 1e-8) / 127.0
        w_q, w_scale = _int8_buffers(layer, w, scale[:, None, None, None])
        self.register_buffer("w_q", w_q, persistable=True)
        self.register_buffer("w_scale", w_scale, persistable=True)
        self.bias = layer.bias
        self._cfg = dict(stride=layer._stride, padding=layer._padding,
                         dilation=layer._dilation, groups=layer._groups,
                         data_format=layer._data_format)

    def forward(self, x):
        w = _int8_dequant_w(self.w_q, self.w_scale)
        return nn_ops.conv2d(x, w, self.bias, **self._cfg)


def convert_to_int8(model, layer_types=("Linear", "Conv2D")):
    """Swap Linear->Int8Linear (W8A8) and Conv2D->Int8Conv2D
    (weight-only) in place for inference; returns the model. Run AFTER
    training/PTQ."""
    for name, sub in list(model._sub_layers.items()):
        if "Linear" in layer_types and isinstance(
                sub, (Linear, QuantizedLinear)):
            if isinstance(sub, QuantizedLinear):
                # QAT/PTQ wrapper: reuse its (fake-quant-trained) weight
                lin = Linear.__new__(Linear)
                Layer.__init__(lin)
                lin.weight, lin.bias = sub.weight, sub.bias
                sub = lin
            model._sub_layers[name] = Int8Linear(sub)
        elif "Conv2D" in layer_types and isinstance(
                sub, (Conv2D, QuantizedConv2D)):
            if isinstance(sub, QuantizedConv2D):
                conv = Conv2D.__new__(Conv2D)
                Layer.__init__(conv)
                conv.weight, conv.bias = sub.weight, sub.bias
                for a in ("_stride", "_padding", "_dilation", "_groups",
                          "_data_format"):
                    setattr(conv, a, getattr(sub, a))
                sub = conv
            model._sub_layers[name] = Int8Conv2D(sub)
        else:
            convert_to_int8(sub, layer_types)
    return model
