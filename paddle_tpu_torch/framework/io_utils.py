"""``paddle.save`` / ``paddle.load`` (a port of
``paddle_tpu/framework/io_utils.py``; Paddle's framework/io.py:550,
:766).

A pickle over numpy, in the reference's format, so that a file written
by either package loads in the other: Tensors and torch tensors become
numpy arrays; nested dicts, lists and tuples keep their shape; other
values are pickled as they are. numpy has no bfloat16, so a bf16 tensor
is stored under the reference's marker, ``{"__bf16__": its values as
f32}``.

``load`` returns numpy arrays where the reference returns them, and a
CPU ``torch.bfloat16`` tensor for the marker (the reference returns a
bf16 jnp array). ``Layer.set_state_dict`` and
``Optimizer.set_state_dict`` take what it returns.
"""
import os
import pickle

import torch

from ..core.tensor import Tensor

_BF16_TAG = "__bf16__"


def _to_picklable(obj):
    if isinstance(obj, Tensor):
        obj = obj.value
    if isinstance(obj, torch.Tensor):
        v = obj.detach().cpu()
        if v.dtype == torch.bfloat16:
            return {_BF16_TAG: v.float().numpy()}
        return v.numpy()
    if isinstance(obj, dict):
        return {k: _to_picklable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_picklable(v) for v in obj)
    return obj


def _from_picklable(obj):
    if isinstance(obj, dict):
        if set(obj.keys()) == {_BF16_TAG}:
            return torch.as_tensor(obj[_BF16_TAG]).to(torch.bfloat16)
        return {k: _from_picklable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_picklable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_picklable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_picklable(obj)
