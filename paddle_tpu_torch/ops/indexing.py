"""Tensor ``__getitem__`` / ``__setitem__`` (a port of
``paddle_tpu/ops/indexing.py``).

Ints, slices, None, Ellipsis and integer or bool arrays (Tensors, lists,
numpy arrays) index as in numpy; reading is an op (differentiable).
Writing is in place and untracked, as the reference's, whose
``set_value`` op swaps the tensor's value without recording the
overwritten slots: the Tensor keeps its identity (and a leaf its grad).
Under lazy eager a write runs the pending graph first, so an op deferred
before it reads the value it would have read eagerly.
"""
import numpy as np
import torch

from ..core import lazy as _lazy
from ..core.dispatch import register_op
from ..core.tensor import Tensor, as_torch


def _split_index(index, device):
    """(static spec, dynamic index tensors): the spec mirrors the index
    with placeholders where the tensors go."""
    if not isinstance(index, tuple):
        index = (index,)
    spec, dyn = [], []
    for it in index:
        if isinstance(it, Tensor):
            spec.append(("dyn", len(dyn)))
            dyn.append(it)
        elif isinstance(it, slice):
            spec.append(("slice", it.start, it.stop, it.step))
        elif it is None:
            spec.append(("none",))
        elif it is Ellipsis:
            spec.append(("ellipsis",))
        elif isinstance(it, (int, np.integer)):
            spec.append(("int", int(it)))
        elif isinstance(it, (list, np.ndarray)):
            spec.append(("dyn", len(dyn)))
            dyn.append(Tensor._wrap(as_torch(np.asarray(it), device=device)))
        else:
            raise TypeError(f"unsupported index component {it!r}")
    return tuple(spec), dyn


def _rebuild_index(spec, dyn):
    idx = []
    for s in spec:
        kind = s[0]
        if kind == "dyn":
            idx.append(dyn[s[1]])
        elif kind == "slice":
            idx.append(slice(s[1], s[2], s[3]))
        elif kind == "none":
            idx.append(None)
        elif kind == "ellipsis":
            idx.append(Ellipsis)
        else:
            idx.append(s[1])
    return tuple(idx)


@register_op("getitem")
def _getitem(x, *dyn, spec):
    return x[_rebuild_index(spec, dyn)]


def getitem(x, index):
    spec, dyn = _split_index(index, x._v.device)
    return _getitem(x, *dyn, spec=spec)


def setitem(x, index, value):
    spec, dyn = _split_index(index, x._v.device)
    v = as_torch(value, x._v.dtype, x._v.device)
    idx = _rebuild_index(spec, [d._value for d in dyn])
    _lazy.flush()
    with torch.no_grad():
        x._value[idx] = v
    return x
