"""Eager Tensor (a port of ``paddle_tpu/core/tensor.py``).

A ``Tensor`` wraps one ``torch.Tensor`` (``.value``), as the reference's
wraps a ``jax.Array``; it is not a subclass, so the port's GPT, engine
and optimizers keep taking plain torch tensors at their own speed. The
autograd state lives in torch alone, with no second bookkeeping copy:

* ``stop_gradient`` is ``not value.requires_grad``: True for a new
  tensor, False for a ``Parameter``; an op's output has False when any
  input has and grad is enabled (torch's own rule);
* ``grad`` is the wrapped ``value.grad`` of a leaf, accumulated across
  ``backward`` calls until ``clear_grad``;
* ``backward`` and hooks run on torch's autograd (``core/engine.py``).

Setting ``stop_gradient = True`` on an op's output cuts the graph there
(the value is detached), as the reference's engine skips such tensors.
``set_value`` (and assigning ``.value``) writes in place, without
autograd, so the Tensor keeps its identity and its ``grad``; a backward
through a graph that saved the old value raises torch's in-place error,
where the reference would still see the value the forward saw.

Under a trace, a Tensor's birth is registered with it, and, while
``analysis.birth`` tracking is on, stamped with its birth site.
"""
import numpy as np
import torch

from . import dtype as dtype_mod
from . import device as device_mod
from . import trace as _trace

_name_counter = [0]


def _auto_name(prefix="tensor"):
    _name_counter[0] += 1
    return f"{prefix}_{_name_counter[0]}"


def as_torch(value, dtype=None, device=None):
    """``value`` (a Tensor, torch tensor, numpy array, python scalar or
    nested list) as a torch tensor of ``dtype`` (a torch dtype or None)
    on ``device`` (None: a torch tensor's own device, else the current
    device). Host data is copied, never shared."""
    if isinstance(value, Tensor):
        value = value._value
    if isinstance(value, torch.Tensor):
        if dtype is not None and value.dtype != dtype:
            value = value.to(dtype)
        if device is not None and value.device != device:
            value = value.to(device)
        return value
    dev = device if device is not None else device_mod.resolve_device()
    if isinstance(value, np.ndarray):
        return torch.tensor(value, dtype=dtype, device=dev)
    return torch.tensor(np.asarray(value), dtype=dtype, device=dev)


class Tensor:
    __slots__ = ("_value", "name", "persistable", "trainable",
                 "__weakref__")
    _symbolic = False   # True on static.program's Variable

    def __init__(self, value, dtype=None, place=None, stop_gradient=True,
                 name=None, persistable=False):
        dev = device_mod.resolve_device(place) if place is not None \
            else None
        tdt = dtype_mod.to_torch_dtype(dtype) if dtype is not None else None
        v = as_torch(value, tdt, dev)
        if isinstance(value, (Tensor, torch.Tensor)):
            v = v.detach().clone()      # a new tensor owns its data
        self._value = v
        self.name = name or _auto_name()
        self.persistable = persistable
        self.trainable = True
        if _trace._active is not None:
            _trace._active.register_created(self)
            if _trace._birth_hook is not None:
                _trace._birth_hook(self)
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, value, name=None):
        """A Tensor over ``value`` as it is (its graph kept): how the
        dispatcher hands back an op's output."""
        t = object.__new__(cls)
        t._value = value
        t.name = name or _auto_name()
        t.persistable = False
        t.trainable = True
        if _trace._active is not None:
            _trace._active.register_created(t)
            if _trace._birth_hook is not None:
                _trace._birth_hook(t)
        return t

    # ---- value -----------------------------------------------------------
    @property
    def value(self):
        """The wrapped ``torch.Tensor``."""
        return self._value

    @value.setter
    def value(self, v):
        if isinstance(v, Tensor) and v._symbolic:
            # building a static program: the op that made ``v`` writes
            # this Tensor at the end of each run
            v.program.mark_writeback(v, self)
            return
        self._assign(as_torch(v, self._value.dtype, self._value.device))

    def _assign(self, v):
        if tuple(v.shape) != tuple(self._value.shape):
            from .errors import InvalidArgumentError
            raise InvalidArgumentError(
                f"set_value shape mismatch {tuple(v.shape)} vs "
                f"{tuple(self._value.shape)}")
        if _trace._active is not None:
            _trace._active.write(self)
        with torch.no_grad():
            self._value.copy_(v)

    def _rebind(self, v):
        """Replace the wrapped torch tensor (not a write into it): a
        captured step refuses it (``core/trace.py``)."""
        if _trace._active is not None:
            _trace._active.rebind(self)
        self._value = v

    def set_value(self, value):
        """In-place assignment (reference: paddle.Tensor.set_value)."""
        self._assign(as_torch(value, self._value.dtype, self._value.device))
        return self

    # ---- autograd state --------------------------------------------------
    @property
    def stop_gradient(self):
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, stop):
        v = self._value
        if stop:
            if v.requires_grad:
                if v.grad_fn is None:
                    v.requires_grad_(False)
                else:
                    self._rebind(v.detach())
        elif not v.requires_grad:
            if not (v.is_floating_point() or v.is_complex()):
                raise TypeError(
                    f"stop_gradient=False needs a floating tensor, got "
                    f"{self.dtype.name}")
            if v.grad_fn is not None:
                v = v.detach()
                self._rebind(v)
            v.requires_grad_(True)

    @property
    def grad(self):
        """The leaf's grad; a sparse one (``Embedding(sparse=True)``'s)
        as a ``SparseGradTensor`` over its rows."""
        v = self._value
        if not v.is_leaf or v.grad is None:
            return None
        if v.grad.is_sparse:
            from .sparse_grad import IndexedSlices, SparseGradTensor
            return SparseGradTensor(IndexedSlices.from_torch(v.grad),
                                    name=self.name + "@GRAD")
        return Tensor._wrap(v.grad, name=self.name + "@GRAD")

    @grad.setter
    def grad(self, g):
        from .sparse_grad import sparse_slices
        if _trace._active is not None:
            _trace._active.write(self)
        sl = sparse_slices(g)
        if sl is not None:
            self._value.grad = sl.to_torch()
            return
        self._value.grad = None if g is None else as_torch(
            g, self._value.dtype, self._value.device)

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    def clear_grad(self):
        self._value.grad = None

    clear_gradient = clear_grad

    def backward(self, grad_tensor=None, retain_graph=False):
        from .engine import run_backward
        run_backward(self, grad_tensor, retain_graph)

    def register_hook(self, hook):
        from .engine import register_tensor_hook
        return register_tensor_hook(self, hook)

    def detach(self):
        return Tensor._wrap(self._value.detach(), name=self.name + ".detach")

    def detach_(self):
        self.stop_gradient = True
        return self

    def clone(self):
        from ..ops import math
        return math.clone(self)

    # ---- metadata --------------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def dtype(self):
        return dtype_mod.to_paddle_dtype(self._value.dtype)

    @property
    def place(self):
        return device_mod.place_of(self._value.device)

    @property
    def size(self):
        return self._value.numel()

    def numel(self):
        return self.size

    def dim(self):
        return self.ndim

    ndimension = dim

    def element_size(self):
        return self._value.element_size()

    # ---- host interop ----------------------------------------------------
    def numpy(self):
        """The values as a numpy array (a copy on the host); bfloat16
        comes back as float32, numpy having no bfloat16."""
        if _trace._active is not None:
            _trace._active.host_read(self, "numpy")
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        out = v.cpu().numpy()
        return out.copy() if v.device.type == "cpu" else out

    def item(self, *args):
        if _trace._active is not None:
            _trace._active.host_read(self, "item")
        return self.numpy().item(*args)

    def tolist(self):
        if _trace._active is not None:
            _trace._active.host_read(self, "tolist")
        return self.numpy().tolist()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        if _trace._active is not None:
            _trace._active.host_read(self, "bool")
        if self.size != 1:
            raise ValueError(
                "truth value of multi-element Tensor is ambiguous")
        return bool(self.item())

    def __len__(self):
        if not self.ndim:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __iter__(self):
        if not self.ndim:
            raise TypeError("iteration over a 0-d tensor")
        return (self[i] for i in range(self._value.shape[0]))

    def __repr__(self):
        body = np.array2string(self.numpy(), precision=6, threshold=64)
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {body})")

    def __hash__(self):
        return id(self)

    # ---- conversion ------------------------------------------------------
    def astype(self, dtype):
        from ..ops import math
        return math.cast(self, dtype)

    cast = astype

    def cpu(self):
        """This tensor on the CPU (differentiable, as torch's move)."""
        return self._moved(torch.device("cpu"))

    def cuda(self, device_id=None):
        """This tensor on the card (``device_id``: which one)."""
        return self._moved(device_mod.resolve_device(
            "cuda" if device_id is None else f"cuda:{int(device_id)}"))

    def _moved(self, dev):
        if self._value.device == dev:
            return self
        return Tensor._wrap(self._value.to(dev))

    def to(self, *args, **kwargs):
        """``to(dtype)``, ``to(device)`` or both, Paddle's spellings
        (``'gpu'``, ``'cpu'``, a Place) or torch's."""
        out = self
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, device_mod.Place):
                out = out._moved(a.torch_device())
            elif isinstance(a, (dtype_mod.DType, torch.dtype)):
                out = out.astype(a)
            elif isinstance(a, (str, torch.device)):
                try:
                    out = out.astype(a)
                except (ValueError, TypeError):
                    spec = str(a).replace("gpu", "cuda")
                    out = out._moved(device_mod.resolve_device(spec))
        return out

    # ---- operators: patched in ops/__init__.py ---------------------------


class Parameter(Tensor):
    """Trainable tensor (reference: python/paddle/fluid/framework.py
    Parameter): ``stop_gradient=False`` and ``persistable=True`` by
    default."""
    __slots__ = ("optimize_attr", "regularizer", "need_clip",
                 "is_distributed")

    def __init__(self, value, dtype=None, name=None, trainable=True):
        super().__init__(value, dtype=dtype, stop_gradient=not trainable,
                         name=name or _auto_name("param"), persistable=True)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False

    @classmethod
    def _own(cls, value, name=None, trainable=True):
        """A Parameter over the torch tensor ``value`` itself, not a
        copy: how ``create_parameter`` hands over an initializer's fresh
        tensor."""
        p = Tensor._wrap.__func__(cls, value.detach(),
                                  name=name or _auto_name("param"))
        p.persistable = True
        p.trainable = trainable
        if trainable:
            p.stop_gradient = False
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.need_clip = True
        p.is_distributed = False
        return p

    def __repr__(self):
        return "Parameter " + super().__repr__()
