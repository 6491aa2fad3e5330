"""Weights carried across from the JAX reference.

A ``paddle_tpu`` ``state_dict()`` (as numpy arrays) uses the same names
as the port's modules. Paddle's ``Linear.weight`` is ``[in, out]`` and
torch's is ``[out, in]``, so linear weights are transposed; embeddings
and LayerNorm parameters are copied as they are.
"""
import numpy as np
import torch


def _is_linear_weight(name, ndim):
    return name.endswith(".weight") and ndim == 2 \
        and "embeddings" not in name


def state_dict_from_paddle_tpu(np_params):
    """``{name: np.ndarray}`` of a reference model -> a torch state
    dict for the port's module of the same config."""
    out = {}
    for name, arr in np_params.items():
        a = np.array(arr)   # a writable copy the tensor can own
        t = torch.from_numpy(a)
        if _is_linear_weight(name, a.ndim):
            t = t.t().contiguous()
        out[name] = t
    return out


def state_dict_to_paddle_tpu(state_dict):
    """The inverse: a port state dict -> ``{name: np.ndarray}`` in the
    reference's layout."""
    out = {}
    for name, t in state_dict.items():
        t = t.detach().cpu()
        if _is_linear_weight(name, t.dim()):
            t = t.t()
        out[name] = np.ascontiguousarray(t.numpy())
    return out
