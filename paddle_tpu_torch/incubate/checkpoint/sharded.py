"""Sharded checkpoints (a port of
``paddle_tpu/incubate/checkpoint/sharded.py``).

The reference's engine is orbax: every host writes the array shards it
owns, and a restore places each shard onto the mesh it is restored to.
The port's is PyTorch's own, ``torch.distributed.checkpoint`` (DCP), with
the same functions and arguments. Each rank writes its own shards: a
tensor-parallel parameter (``tp_split``) as its rank's piece under
``"{name}@tp{r}/{n}"``, a ZeRO partition's optimizer state under its own
names (only its owner holds it), and what every rank holds alike once
(DCP's deduplication). ``checkpoint_layout.json`` in the checkpoint
records how each split tensor was cut. A load reads the pieces it needs,
puts each split tensor back together and cuts it for the topology it is
loaded into (a target's ``tp_split``), so a checkpoint saved at
``sharding = 2`` or ``mp = 2`` loads at world 1 and the other way round.
A save runs the pending lazy graph first (the reference's ``_to_arrays``).
The files are DCP's, not orbax's: the two packages share values, not
checkpoint files.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

__all__ = ["save_sharded", "load_sharded", "save_sharded_train_state",
           "load_sharded_train_state", "AsyncShardedSaver"]

_LAYOUT = "checkpoint_layout.json"


def _dist():
    return dist.is_available() and dist.is_initialized()


def _rank():
    return dist.get_rank() if _dist() else 0


def _tensor(v):
    from ...core.tensor import Tensor
    if isinstance(v, Tensor):
        v = v._value
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.as_tensor(np.asarray(v))


def _flatten(state_dict, prefix=""):
    """``{key: tensor}`` to write (each rank's pieces of split tensors
    under their own keys) and the layout of the split ones."""
    from ...core import lazy
    from ...distributed.fleet.meta_parallel.mp_layers import split_of
    lazy.flush()
    flat, layout = {}, {}
    for k, v in state_dict.items():
        leaf = getattr(v, "_value", v)
        sp = split_of(leaf) if isinstance(leaf, torch.Tensor) else None
        t = _tensor(v)
        if sp is not None and sp.group.nranks > 1:
            n, r = sp.group.nranks, sp.group.rank
            flat[f"{prefix}{k}@tp{r}/{n}"] = t.contiguous()
            layout[prefix + k] = {"axis": sp.axis, "chunks": sp.chunks,
                                  "n": n}
        else:
            flat[prefix + k] = t.contiguous()
    return flat, layout


def _write_layout(path, layout):
    """Every rank's split tensors (the same on all ranks of a group, each
    group's on its own ranks) merged into the checkpoint's layout."""
    if _dist():
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, layout)
        merged = {}
        for p in parts:
            merged.update(p)
    else:
        merged = layout
    if _rank() == 0:
        tmp = os.path.join(path, _LAYOUT + ".tmp")
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, os.path.join(path, _LAYOUT))
    if _dist():
        dist.barrier()


def _save(flat, layout, path):
    path = os.path.abspath(str(path))
    os.makedirs(path, exist_ok=True)
    dcp.save(flat, checkpoint_id=path, no_dist=not _dist())
    _write_layout(path, layout)


def save_sharded(state_dict, path):
    """Write a state dict (name -> tensor, a split parameter as this
    rank's shard); every rank of the job calls it and writes its own
    pieces. Overwrites a checkpoint at ``path``."""
    flat, layout = _flatten(state_dict)
    _save(flat, layout, path)


def _metadata(path):
    from torch.distributed.checkpoint import FileSystemReader
    md = FileSystemReader(path).read_metadata().state_dict_metadata
    lp = os.path.join(path, _LAYOUT)
    layout = {}
    if os.path.exists(lp):
        with open(lp) as f:
            layout = json.load(f)
    return md, layout


def _entries(md, layout, prefix=""):
    """``{name: (full shape, dtype)}`` of the checkpoint's tensors under
    ``prefix``, the split ones whole."""
    out = {}
    for key, m in md.items():
        if not key.startswith(prefix) or not hasattr(m, "size"):
            continue
        name = key[len(prefix):]
        dtype = m.properties.dtype
        if "@tp" in name:
            base = name[:name.index("@tp")]
            lay = layout[prefix + base]
            shape = list(m.size)
            shape[lay["axis"]] *= lay["n"]
            out[base] = (tuple(shape), dtype)
        else:
            out[name] = (tuple(m.size), dtype)
    return out


def _read(path, md, layout, names, prefix=""):
    """The whole tensors of ``names`` (under ``prefix``), split ones put
    back together."""
    from ...distributed.fleet.meta_parallel.mp_layers import unshard
    want = {}
    for name in names:
        lay = layout.get(prefix + name)
        keys = [prefix + name] if lay is None else [
            f"{prefix}{name}@tp{r}/{lay['n']}" for r in range(lay["n"])]
        for k in keys:
            m = md[k]
            want[k] = torch.empty(tuple(m.size), dtype=m.properties.dtype)
    if want:
        dcp.load(want, checkpoint_id=path, no_dist=True)
    out = {}
    for name in names:
        lay = layout.get(prefix + name)
        if lay is None:
            out[name] = want[prefix + name]
        else:
            out[name] = unshard(
                [want[f"{prefix}{name}@tp{r}/{lay['n']}"]
                 for r in range(lay["n"])], lay["axis"], lay["chunks"])
    return out


def _target_shape(t):
    from ...distributed.fleet.meta_parallel.mp_layers import split_of
    leaf = getattr(t, "_value", t)
    sp = split_of(leaf)
    return tuple(sp.full_shape) if sp is not None else tuple(leaf.shape)


def _check(path, entries, target, what="checkpoint"):
    """Validate a target against the checkpoint before anything is read
    (a half-restored model would run with its init for what is
    missing)."""
    missing = [k for k in target if k not in entries]
    if missing:
        raise KeyError(f"{what} at {path} has no entries for target keys "
                       f"{sorted(missing)}")
    for k, t in target.items():
        shape, dtype = entries[k]
        leaf = getattr(t, "_value", t)
        if shape != _target_shape(t):
            raise ValueError(f"checkpoint parameter {k!r} has shape "
                             f"{shape} but the target expects "
                             f"{_target_shape(t)}")
        if dtype != leaf.dtype:
            raise ValueError(f"checkpoint parameter {k!r} has dtype "
                             f"{dtype} but the target expects {leaf.dtype}")


@torch.no_grad()
def _assign(target, values):
    """Each target tensor takes its value (this rank's shard of a split
    one), in place."""
    from ...distributed.fleet.meta_parallel.mp_layers import (shard_of,
                                                              split_of)
    for k, t in target.items():
        leaf = getattr(t, "_value", t)
        v = values[k]
        if split_of(leaf) is not None:
            v = shard_of(leaf, v)
        leaf.copy_(v.to(leaf.device))


def load_sharded(path, target=None, shardings=None):
    """A state dict saved by :func:`save_sharded`, each tensor whole
    (name -> tensor on the CPU). ``target`` (name -> tensor, a split
    parameter as this rank's shard) is validated first, then filled in
    place, each split parameter with its shard at the current topology.
    ``shardings`` is the reference's placement argument; the target's own
    split decides the placement here."""
    path = os.path.abspath(str(path))
    md, layout = _metadata(path)
    entries = _entries(md, layout)
    if target is not None:
        _check(path, entries, target)
    values = _read(path, md, layout, list(entries))
    if target is not None:
        _assign(target, values)
    return values


def save_sharded_train_state(model_state, optimizer, path):
    """The whole training state: the model's parameters, the optimizer's
    state (each ZeRO rank its partition's) and, in ``{path}_meta.json``
    (rank 0's, renamed into place), the learning rate and scheduler
    state (reference fleet_base.py:732, dist_sharding_save.py)."""
    from ...distributed.sharding import _unwrap
    opt_sd = dict(_unwrap(optimizer).state_dict())
    meta = opt_sd.pop("LR_Scheduler", {})
    flat, layout = _flatten(model_state, "model/")
    oflat, olayout = _flatten(opt_sd, "opt/")
    flat.update(oflat)
    layout.update(olayout)
    apath = os.path.abspath(str(path))
    _save(flat, layout, apath)
    if _rank() == 0:
        tmp = apath + "_meta.json.tmp"
        with open(tmp, "w") as f:
            json.dump({"LR_Scheduler": meta}, f)
        os.replace(tmp, apath + "_meta.json")
    if _dist():
        dist.barrier()


def load_sharded_train_state(path, model_target, optimizer, sharding=None):
    """Restore :func:`save_sharded_train_state`'s checkpoint: the
    parameters into ``model_target`` (validated first, each split one cut
    for the current topology) and the state and learning rate into
    ``optimizer`` through ``set_state_dict`` (a ZeRO rank takes its
    partition's). A checkpoint without its ``_meta.json`` is incomplete
    (killed between the two writes) and raises. Returns ``{"model": ...,
    "opt": ...}`` of whole tensors."""
    from ...distributed.sharding import _unwrap
    apath = os.path.abspath(str(path))
    md, layout = _metadata(apath)
    model_e = _entries(md, layout, "model/")
    opt_e = _entries(md, layout, "opt/")
    if model_target is not None:
        _check(path, model_e, model_target, "train-state checkpoint")
    mpath = apath + "_meta.json"
    if optimizer is not None and not os.path.exists(mpath):
        raise FileNotFoundError(
            f"train-state checkpoint at {path} has no {mpath} sidecar "
            "(killed between the array save and the metadata write?): "
            "resume from the previous checkpoint")
    restored = {"model": _read(apath, md, layout, list(model_e), "model/"),
                "opt": _read(apath, md, layout, list(opt_e), "opt/")}
    if model_target is not None:
        _assign(model_target, restored["model"])
    if optimizer is not None:
        with open(mpath) as f:
            meta = json.load(f)
        opt = _unwrap(optimizer)
        sd = dict(restored["opt"])
        sd["LR_Scheduler"] = meta.get("LR_Scheduler",
                                      {"last_lr": opt.get_lr()})
        opt.set_state_dict(sd)
    return restored


class AsyncShardedSaver:
    """``save()`` returns at once: the tensors are staged to the host and
    written in the background (DCP's ``async_save``), overlapping the
    next steps; ``wait()`` (or the next ``save``) joins it."""

    def __init__(self):
        self._pending = None
        self._path = None
        self._layout = None

    def save(self, state_dict, path):
        self.wait()
        flat, layout = _flatten(state_dict)
        self._path = os.path.abspath(str(path))
        os.makedirs(self._path, exist_ok=True)
        self._layout = layout
        self._pending = dcp.async_save(flat, checkpoint_id=self._path,
                                       no_dist=not _dist())

    def wait(self):
        if self._pending is not None:
            fut = getattr(self._pending, "upload_completion",
                          self._pending)
            fut.result()
            _write_layout(self._path, self._layout)
            self._pending = None

    def close(self):
        self.wait()
