"""``Layer``, the module base class (a port of
``paddle_tpu/nn/layer_base.py``).

Parameter, buffer and sublayer registries through ``__setattr__``,
``state_dict``/``set_state_dict`` under the reference's structured
names, train/eval, forward pre/post hooks, ``apply``, ``to``. Parameters
are the eager core's ``Parameter``s over torch leaves on the current
device; ``to(device=..., dtype=...)`` moves and casts them in place
(their torch tensors keep their identity, so an optimizer built before
still updates them).
"""
import collections

import numpy as np
import torch

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from ..core.tensor import Parameter, Tensor, as_torch
from . import initializer as init_mod

_layer_name_counters = collections.defaultdict(int)


class HookRemoveHelper:
    def __init__(self, hooks, hid):
        self._hooks = hooks
        self._hid = hid

    def remove(self):
        self._hooks.pop(self._hid, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        cls = type(self).__name__.lower()
        _layer_name_counters[cls] += 1
        self._full_name = \
            f"{name_scope or cls}_{_layer_name_counters[cls] - 1}"
        self._dtype = dtype
        self.training = True
        self._parameters = collections.OrderedDict()
        self._buffers = collections.OrderedDict()
        self._sub_layers = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0

    # ---- attribute routing ----------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ first")
            params[name] = value
            self.__dict__.pop(name, None)
            return
        layers = self.__dict__.get("_sub_layers")
        if isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ first")
            layers[name] = value
            self.__dict__.pop(name, None)
            return
        if params is not None and name in params:
            if value is None:
                del params[name]
            else:
                params[name] = value
                return
        if layers is not None and name in layers:
            if value is None:
                del layers[name]
            else:
                layers[name] = value
                return
        buffers = self.__dict__.get("_buffers")
        if buffers is not None and name in buffers:
            if value is None or isinstance(value, Tensor):
                buffers[name] = value
                return
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def __delattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        return list(super().__dir__()) + list(self._parameters) + \
            list(self._buffers) + list(self._sub_layers)

    # ---- construction helpers -------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A Parameter on the current device. The initializer is, first
        to last: ``attr``'s, the global one (``set_global_initializer``,
        which beats a layer's default, reference
        layer_helper_base.py:324), ``default_initializer``, then zeros
        for a bias and ``XavierNormal`` for a weight."""
        dtype = dtype or self._dtype or "float32"
        g = init_mod.get_global_initializer(is_bias)
        if g is not None:
            default_initializer = g
        if default_initializer is None:
            default_initializer = init_mod.Constant(0.0) if is_bias \
                else init_mod.XavierNormal()
        initializer = default_initializer
        learning_rate = 1.0
        trainable = True
        regularizer = None
        name = None
        need_clip = True
        if attr is False:
            return None
        if isinstance(attr, init_mod.ParamAttr):
            if attr.initializer is not None:
                initializer = attr.initializer
            learning_rate = attr.learning_rate
            trainable = attr.trainable
            regularizer = attr.regularizer
            name = attr.name
            need_clip = attr.need_clip
        elif isinstance(attr, init_mod.Initializer):
            initializer = attr
        value = initializer(tuple(int(s) for s in shape), dtype)
        p = Parameter._own(value, name=name, trainable=trainable)
        p.optimize_attr["learning_rate"] = learning_rate
        p.regularizer = regularizer
        p.need_clip = need_clip
        return p

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        elif tensor is not None:
            tensor.persistable = True
        return tensor

    # ---- traversal -------------------------------------------------------
    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            for pname, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{name}.{pname}" if name else pname), p
            if not include_sublayers:
                break

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            for bname, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{name}.{bname}" if name else bname), b
            if not include_sublayers:
                break

    def children(self):
        for _, layer in self.named_children():
            yield layer

    def named_children(self):
        for name, layer in self._sub_layers.items():
            if layer is not None:
                yield name, layer

    def sublayers(self, include_self=False):
        return [layer for _, layer in
                self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None:
                continue
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield from layer.named_sublayers(prefix=sub_prefix,
                                             include_self=True)

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def full_name(self):
        return self._full_name

    # ---- modes -----------------------------------------------------------
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    # ---- state dict ------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None \
            else collections.OrderedDict()
        for name, p in self.named_parameters(prefix=structured_name_prefix):
            dest[name] = p
        for name, layer in self.named_sublayers(
                prefix=structured_name_prefix, include_self=True):
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistable_buffer_names:
                    continue
                dest[f"{name}.{bname}" if name else bname] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (Tensors, torch tensors or numpy
        arrays, such as the reference's ``state_dict()`` as arrays) into
        this layer's parameters and buffers of the same structured
        names, in place, cast to each one's dtype and device, then calls
        each sublayer's ``_after_load_state_dict`` where it has one.
        Returns the names it had no value for."""
        missing = []
        for name, tgt in self.state_dict().items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            if not isinstance(src, (Tensor, torch.Tensor)):
                src = np.asarray(src)
            arr = as_torch(src, tgt._v.dtype, tgt._v.device)
            if tuple(arr.shape) != tuple(tgt._v.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{tuple(arr.shape)} vs {tgt.shape}")
            tgt.set_value(arr)
        # let layers re-derive their Python state from the loaded buffers
        # (a quantization observer marks itself calibrated), as the
        # reference's set_state_dict does
        for _, layer in self.named_sublayers(include_self=True):
            hook = getattr(layer, "_after_load_state_dict", None)
            if hook is not None:
                hook()
        return missing

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ---- dtype / device --------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Move (``device``: a Place, ``'gpu'``, ``'cpu'``, a torch
        device) and cast (``dtype``; floating buffers only) the
        parameters and buffers in place: each keeps its torch tensor,
        and a parameter its grad, moved with it."""
        dev = None
        if device is not None:
            spec = device if isinstance(device, device_mod.Place) \
                else str(device).replace("gpu", "cuda")
            dev = device_mod.resolve_device(spec)
        tdt = dtype_mod.to_torch_dtype(dtype) if dtype is not None else None
        for t, is_param in ([(p, True) for p in self.parameters()]
                            + [(b, False) for b in self.buffers()]):
            v = t._value
            cast = tdt if tdt is not None and (
                is_param or v.is_floating_point()) else v.dtype
            target = dev if dev is not None else v.device
            if v.dtype == cast and v.device == target:
                continue
            with torch.no_grad():
                v.data = v.data.to(device=target, dtype=cast)
                if v.grad is not None:
                    v.grad = v.grad.to(device=target, dtype=cast)
        if dtype is not None:
            self._dtype = dtype_mod.to_paddle_dtype(dtype).name
        return self

    def float(self):
        return self.to(dtype="float32")

    def half(self):
        return self.to(dtype="float16")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    astype = to

    # ---- hooks -----------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # ---- call ------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    def extra_repr(self):
        return ""

    def __repr__(self):
        lines = []
        for name, child in self._sub_layers.items():
            child_repr = "\n  ".join(repr(child).split("\n"))
            lines.append(f"({name}): {child_repr}")
        main = type(self).__name__ + "(" + self.extra_repr()
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()
