"""Weights and optimizer state carried across from the JAX reference.

A ``paddle_tpu`` ``state_dict()`` (as numpy arrays) of a GPT or a
``BertForPretraining`` uses the same names as the port's modules (for
BERT also the token-type table, the pooler, the MLM transform and its
LayerNorm and the NSP head; its MLM head is the word embedding). Paddle's ``Linear.weight`` is ``[in, out]`` and
torch's is ``[out, in]``, so linear weights are transposed; embeddings
and LayerNorm parameters are copied as they are. An optimizer's state
is keyed ``f"{param name}_{kind}"``, with the reference's
``Parameter.name`` there and the port's ``named_parameters()`` name
here; the moments of a linear weight are transposed like the weight.
"""
import numpy as np
import torch


def _is_linear_weight(name, ndim):
    return name.endswith(".weight") and ndim == 2 \
        and "embeddings" not in name


def is_transposed(name, ndim):
    """True for a parameter of the port's torch GPT or BERT (by its
    ``named_parameters()`` name and rank) that is stored transposed
    against the reference's layout: a linear weight, ``[out, in]`` here
    and ``[in, out]`` there (``incubate.asp`` computes its masks in the
    reference's layout through this)."""
    return _is_linear_weight(name, ndim)


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


def _rename_state(state, names, to_array, port_is_dst, same_layout=False):
    """``state`` with each key's parameter name mapped through
    ``names`` (longest name first), linear weights' moments transposed
    by ``to_array(value, transpose)`` (never with ``same_layout``), and
    the ``"LR_Scheduler"`` entry copied with its ``param_order`` mapped.
    The port's name (the destination's when ``port_is_dst``) tells a
    linear weight."""
    by_len = sorted(names, key=len, reverse=True)
    out = {}
    for key, val in state.items():
        if key == "LR_Scheduler":
            meta = dict(val)
            if "param_order" in meta:
                meta["param_order"] = [names.get(n, n)
                                       for n in meta["param_order"]]
            out[key] = meta
            continue
        src = next((n for n in by_len if key.startswith(n + "_")), None)
        if src is None:
            raise KeyError(f"optimizer state {key!r}: no parameter name "
                           "in names prefixes it")
        dst = names[src]
        lin = not same_layout and _is_linear_weight(
            dst if port_is_dst else src, len(val.shape))
        out[f"{dst}_{key[len(src) + 1:]}"] = to_array(val, lin)
    return out


def _to_torch(val, transpose):
    t = torch.from_numpy(np.array(val))
    return t.t().contiguous() if transpose else t


def _to_numpy(val, transpose):
    t = val.detach().cpu()
    return np.ascontiguousarray((t.t() if transpose else t).numpy())


def optimizer_state_from_paddle_tpu(np_state, names, same_layout=False):
    """A reference optimizer's ``state_dict()`` (numpy arrays, and the
    ``"LR_Scheduler"`` dict) -> the port's, for ``set_state_dict``.
    ``names`` maps each reference ``Parameter.name`` to the port's name
    of the same parameter: ``{p.name: n for n, p in
    ref_model.named_parameters()}`` when the port's optimizer was given
    ``model.named_parameters()``. The GPT's linear weights are
    ``[out, in]`` in the port and ``[in, out]`` in the reference, so their
    moments are transposed; a model written in the Paddle ``nn`` surface
    (``nn.Linear``'s ``[in, out]`` in both) passes ``same_layout=True``
    and nothing is."""
    return _rename_state(np_state, names, _to_torch, True, same_layout)


def optimizer_state_to_paddle_tpu(state, names, same_layout=False):
    """The inverse: a port optimizer's ``state_dict()`` -> numpy arrays
    under the reference's names. ``names`` is the same map, reference
    name -> port name."""
    return _rename_state(state, {v: k for k, v in names.items()},
                         _to_numpy, False, same_layout)


# the GPT's tensor-parallel splits, in the port's (torch) layout, by the
# end of a parameter's name: (axis, chunks) as
# distributed.fleet.meta_parallel.mp_layers.shard takes them. The fused
# QKV is 3 blocks (q, k, v), each split by heads.
GPT_TP_SPLITS = (
    ("word_embeddings.weight", (0, 1)),
    ("attn.qkv.weight", (0, 3)),
    ("attn.qkv.bias", (0, 3)),
    ("attn.out.weight", (1, 1)),
    ("mlp.fc1.weight", (0, 1)),
    ("mlp.fc1.bias", (0, 1)),
    ("mlp.fc2.weight", (1, 1)),
)


def tp_split_of(name):
    """``(axis, chunks)`` of the GPT parameter ``name`` under tensor
    parallelism, None for one every ``mp`` rank holds whole."""
    return next((sp for end, sp in GPT_TP_SPLITS
                 if name == end or name.endswith("." + end)), None)


def tp_state_dict_from_paddle_tpu(np_params, mp_rank, mp_degree):
    """The reference's whole ``{name: np.ndarray}`` of a GPT -> the torch
    state dict of the rank at ``mp_rank`` of ``mp_degree`` (its
    coordinate in the ``HybridCommunicateGroup``'s ``mp`` axis): the
    split parameters' shards (the QKV's rows permuted so the rank holds
    q, k and v of its own heads), the rest whole. ``load_state_dict`` of
    a ``use_mp`` GPTForCausalLM takes it as it is."""
    from ..distributed.fleet.meta_parallel.mp_layers import shard
    out = {}
    for name, t in state_dict_from_paddle_tpu(np_params).items():
        sp = tp_split_of(name)
        out[name] = t if sp is None or mp_degree == 1 \
            else shard(t, sp[0], sp[1], mp_rank, mp_degree)
    return out


def tp_state_dict_to_paddle_tpu(rank_states):
    """The inverse: the state dicts of every ``mp`` rank, in rank order
    (each rank's shards) -> the reference's whole ``{name: np.ndarray}``
    layout."""
    from ..distributed.fleet.meta_parallel.mp_layers import unshard
    whole = {}
    for name, t in rank_states[0].items():
        sp = tp_split_of(name)
        whole[name] = t if sp is None or len(rank_states) == 1 else unshard(
            [s[name].detach().cpu() for s in rank_states], sp[0], sp[1])
    return state_dict_to_paddle_tpu(whole)
