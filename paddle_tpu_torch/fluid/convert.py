"""Weights carried across from the JAX reference's ``fluid.layers``
(beside ``text/convert.py``).

``fluid.layers`` keeps the parameters its layer functions make in
``_layer_cache``, keyed by the call site or the ``name=`` of the call.
Call sites differ between two programs, so a state names each entry by
its ``name=`` (a str) or, without one, by its position in the order the
entries were made (an int). An entry's values are
``{param_name: ndarray}``: a layer's ``state_dict()`` (the Paddle-surface
layers of both packages share names and layout), ``{"value": array}`` for
a lone parameter or tensor, ``{"0": .., "1": ..}`` for a tuple of them.
"""
import numpy as np
import torch


def _key_of(key, index):
    if isinstance(key, tuple) and len(key) >= 2 and key[0] == "name":
        return key[1]
    return index


def _arrays(entry):
    if hasattr(entry, "state_dict"):
        return {k: np.asarray(v.numpy()) for k, v in
                entry.state_dict().items()}
    if isinstance(entry, tuple):
        return {str(i): np.asarray(t.numpy()) for i, t in enumerate(entry)}
    return {"value": np.asarray(entry.numpy())}


def layer_cache_state(cache):
    """``{key: {param_name: ndarray}}`` of a ``fluid.layers._layer_cache``
    of either package (duck-typed: layers, tensors and tuples of them)."""
    return {_key_of(k, i): _arrays(v)
            for i, (k, v) in enumerate(cache.items())}


def _set(t, arr):
    with torch.no_grad():
        t._value.copy_(torch.as_tensor(np.asarray(arr)).to(t._value.dtype))


def load_layer_cache(state, cache=None):
    """Load ``state`` (the reference's, from ``layer_cache_state``) into
    the port's ``fluid.layers._layer_cache`` (or ``cache``), whose entries
    the same fluid code made; in place. Raises KeyError for a key with no
    entry."""
    if cache is None:
        from .layers import _layer_cache as cache
    entries = list(cache.items())
    by_name = {}
    for i, (k, v) in enumerate(entries):
        by_name.setdefault(_key_of(k, i), v)
    for key, arrays in state.items():
        if key not in by_name:
            raise KeyError(f"fluid layer cache: no entry {key!r} (made "
                           f"{len(entries)} entries)")
        entry = by_name[key]
        if hasattr(entry, "set_state_dict"):
            missing = entry.set_state_dict(dict(arrays))
            if missing:
                raise KeyError(f"fluid layer cache {key!r}: {missing}")
        elif isinstance(entry, tuple):
            for i, t in enumerate(entry):
                _set(t, arrays[str(i)])
        else:
            _set(entry, arrays["value"])
