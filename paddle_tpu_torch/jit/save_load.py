"""``jit.save`` / ``jit.load``: inference model export (a port of
``paddle_tpu/jit/save_load.py``; reference python/paddle/fluid/dygraph/
jit.py:515 and :876).

The reference serializes the forward with ``jax.export`` (StableHLO);
the port records it into its own static ``Program``
(``static/program.py``), the op list Paddle's ``jit.save`` writes.
``layer.forward`` runs once under a ``program_guard`` with one
``static.data`` a spec (a ``None`` or ``-1`` dim stays ``-1``, so the
program takes any size there, as the reference's symbolic dims do) and
every entry of ``layer.state_dict()`` bound to a persistable
``Variable``, as the reference's ``pure_fn`` binds them to tracers: an
op that reads only parameters (a position-embedding lookup) records
instead of running, so a loaded model reads every value from its
``.pdiparams``. Tensors the forward makes without any input or
parameter (an ``arange``) are the program's constants.

Three files:

* ``<path>.pdmodel``: the pickled program blob of
  ``static.save_inference_model`` without the persistables' values
  (their names, shapes and dtypes only), with the feed and fetch names;
* ``<path>.pdiparams``: ``paddle.save(layer.state_dict())``, keyed by
  structured names, in the reference's format (either package loads
  it);
* ``<path>.pdmeta``: the reference's keys (``num_inputs``,
  ``param_names``) and ``program_names``, each structured name's
  persistable in the program.

So parameters cross between the packages and programs do not: the
reference's ``.pdmodel`` is StableHLO, which the port cannot run, and
``jit.load`` of one raises naming that. ``TranslatedLayer`` runs the
program through an ``Executor`` on its persistables' device (the card
unless the caller asks for the CPU), where each feed signature becomes
one CUDA graph. Runs that may record or capture (a signature's first
three) take ``CAPTURE_LOCK`` alone, replays share it: a capture is
process-wide, so predictors serving from threads must not launch work,
copy or synchronize during another's; each run holds the lock from its
feeds' copies to its outputs' copies to the host.

A ``torch.nn.Module`` (the port's ``text.models.GPTForCausalLM``) calls
torch directly, so it records nothing; ``save`` takes it through
``torch.export`` instead (``export_module``): the forward in eval mode
at the specs' shapes, each ``None`` or ``-1`` dim a ``torch.export.Dim``
(the reference's export bakes batch 1 there; the port's program takes
any size). The attention stays one node,
``torch.ops.paddle_tpu_torch.flash_attention_forward`` (K1 on the card,
its plain version on the CPU; ``ops/attention.py`` registers it at
import). The ``.pdmodel`` is then the ``torch.export.save`` archive
without the values (each a zero broadcast to its shape), the
``.pdiparams`` the module's state dict under the reference's structured
names and layout (``text.convert.state_dict_to_paddle_tpu``: a linear
weight ``[in, out]``), so the values still cross between the packages
both ways, and the ``.pdmeta`` says ``"format": "torch.export"``.
``load`` returns a ``TranslatedModule``: the exported module with the
``.pdiparams`` values on their device, each input signature one CUDA
graph on the card (``jit.to_static``), under the same lock.
"""
import contextlib
import os
import pickle
import threading
import warnings

import numpy as np
import torch

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from ..core.tensor import Tensor

__all__ = ["save", "load", "TranslatedLayer", "TranslatedModule"]

# the pickle protocol marker the port's program files start with
_PICKLE_MAGIC = b"\x80"
# runs of one feed signature before its Executor replays a graph (to_static:
# call 1 eager, call 2 recorded, call 3 captured)
_CAPTURE_RUNS = 3


class _SharedExclusiveLock:
    """Many holders in ``shared``, one in ``exclusive``; a waiting
    exclusive holder goes before new shared ones."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._exclusive or self._waiting:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            while self._exclusive or self._shared:
                self._cond.wait()
            self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


CAPTURE_LOCK = _SharedExclusiveLock()


def _check_layer(layer, what):
    from ..nn.layer_base import Layer
    if not isinstance(layer, Layer):
        raise TypeError(
            f"{what} takes a Paddle-surface nn.Layer, whose forward records "
            f"into a static Program, or a torch.nn.Module, which goes "
            f"through torch.export; got {type(layer).__name__}")


_MODULE_FORMAT = "torch.export"


def export_module(module, input_spec, concrete=False):
    """``torch.export.export`` of ``module`` in eval mode, without grad, on
    zero inputs of the specs' shapes and dtypes on the module's device.
    A -1 dim of a spec is a ``torch.export.Dim`` of at least 1 (traced at
    2, so that it is not specialised), or 1 with ``concrete``."""
    from torch.export import Dim, export
    specs = _feed_specs(input_spec, concrete)
    dev = next(iter(module.parameters()), torch.empty(0)).device
    examples, dynamic = [], []
    for i, (shape, dtype) in enumerate(specs):
        examples.append(torch.zeros([2 if d == -1 else d for d in shape],
                                    dtype=dtype, device=dev))
        dims = {j: Dim(f"x{i}_d{j}", min=1)
                for j, d in enumerate(shape) if d == -1}
        dynamic.append(dims or None)
    module.eval()
    with torch.no_grad():
        return export(module, tuple(examples),
                      dynamic_shapes=tuple(dynamic)
                      if any(dynamic) else None)


def _broadcast_zeros(ep, device):
    """Each state entry of ``ep`` as a zero on ``device`` broadcast to its
    shape (one element of storage)."""
    for k, v in list(ep.state_dict.items()):
        z = torch.zeros((), dtype=v.dtype, device=device).expand(v.shape)
        ep.state_dict[k] = torch.nn.Parameter(
            z, requires_grad=v.requires_grad) \
            if isinstance(v, torch.nn.Parameter) else z


def _save_module(module, path, input_spec):
    from ..framework.io_utils import save as psave
    from ..text.convert import state_dict_to_paddle_tpu
    ep = export_module(module, input_spec)
    # the program without the values: each state entry a zero broadcast
    # to its shape (one element of storage, on the CPU, so that no copy
    # to the host fills it out), which load replaces by the .pdiparams
    # values
    device = next(iter(ep.state_dict.values()), torch.empty(0)).device
    _broadcast_zeros(ep, torch.device("cpu"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pdmodel", "wb") as f, warnings.catch_warnings():
        # torch warns that a broadcast zero is no "complete tensor"
        warnings.filterwarnings("ignore", "No complete tensor")
        torch.export.save(ep, f)
    params = state_dict_to_paddle_tpu(module.state_dict())
    psave(params, path + ".pdiparams")
    specs = _feed_specs(input_spec, False)
    meta = {"num_inputs": len(specs), "param_names": list(params),
            "format": _MODULE_FORMAT, "device": str(device),
            "specs": [(shape, str(dt).replace("torch.", ""))
                      for shape, dt in specs]}
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f, protocol=4)


def _feed_specs(input_spec, concrete):
    """[(shape, dtype)] of each spec: an InputSpec's dims (None or a
    negative dim -1, or 1 when ``concrete``), an example Tensor's or
    array's own shape and dtype."""
    from ..static.input_spec import InputSpec
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (example inputs or "
                         "an InputSpec list)")
    out = []
    for spec in input_spec:
        if isinstance(spec, InputSpec):
            dims = [-1 if (s is None or int(s) < 0) else int(s)
                    for s in spec.shape]
            if concrete:
                dims = [1 if d == -1 else d for d in dims]
            out.append((dims, dtype_mod.to_torch_dtype(spec.dtype)))
        elif isinstance(spec, Tensor):
            out.append((list(spec.shape), spec._v.dtype))
        elif isinstance(spec, torch.Tensor):
            out.append((list(spec.shape), spec.dtype))
        else:
            arr = np.asarray(spec)
            out.append((list(arr.shape), dtype_mod.to_torch_dtype(arr.dtype)))
    return out


def record(layer, input_spec, concrete=False, what="jit.save"):
    """Record ``layer.forward`` (in eval mode) into a new Program: one feed
    ``x<i>`` a spec, every ``state_dict`` entry bound to a persistable
    Variable. Returns ``(program, feed_names, fetch_names, params,
    program_names)``: ``params`` the state dict (structured name ->
    Tensor), ``program_names`` each structured name's persistable.
    ``concrete``: a -1 dim of a spec is recorded as 1 (onnx.export's
    example shapes)."""
    from ..static.program import Program, Variable, program_guard
    _check_layer(layer, what)
    # a to_static forward records through its function (the capture
    # machinery takes no Variables); a plain one through the Layer's call
    fwd = layer.forward
    fwd = fwd._fn if hasattr(fwd, "_fn") and hasattr(fwd, "graphs") \
        else layer
    layer.eval()
    params = layer.state_dict()
    prog = Program()
    prog.dynamic_dims = not concrete
    bound, program_names, taken = {}, {}, set()
    for sname, t in params.items():
        var = bound.get(id(t))
        if var is None:
            pname = t.name if t.name and t.name not in taken else sname
            while pname in taken:
                pname += "_"
            taken.add(pname)
            var = Variable(pname, t.shape, t._v.dtype, prog)
            var.persistable = True
            var.trainable = bool(getattr(t, "trainable", True))
            prog.vars[pname] = var
            prog.persist[pname] = t
            bound[id(t)] = var
        program_names[sname] = var.name
    swapped = []
    for sub in layer.sublayers(include_self=True):
        for store in (sub._parameters, sub._buffers):
            for key, t in store.items():
                if t is not None and id(t) in bound:
                    swapped.append((store, key, t))
                    store[key] = bound[id(t)]
    try:
        with program_guard(prog), torch.no_grad():
            feeds = [prog.data(f"x{i}", shape, dtype)
                     for i, (shape, dtype) in enumerate(
                         _feed_specs(input_spec, concrete))]
            out = fwd(*feeds)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            fetch = []
            for o in outs:
                if not isinstance(o, Tensor):
                    raise TypeError(
                        f"jit.save: the forward returned a "
                        f"{type(o).__name__}; it must return Tensors")
                fetch.append(o.name if o._symbolic
                             else prog.register_persist(o))
    finally:
        for store, key, t in swapped:
            store[key] = t
    return prog, [f.name for f in feeds], fetch, params, program_names


def save(layer, path, input_spec=None, **configs):
    """Write ``path + '.pdmodel'`` (the recorded program, no values; for a
    ``torch.nn.Module`` its ``torch.export`` archive), ``'.pdiparams'``
    (the state dict) and ``'.pdmeta'``."""
    from ..framework.io_utils import save as psave
    from ..static.program import _serialize_program
    if isinstance(layer, torch.nn.Module):
        if input_spec is None:
            raise ValueError("jit.save requires input_spec (example "
                             "inputs or an InputSpec list)")
        return _save_module(layer, path, input_spec)
    prog, feeds, fetch, params, program_names = record(layer, input_spec)
    blob = _serialize_program(prog, without_values=set(program_names.values()))
    blob["feed_targets"] = feeds
    blob["fetch_targets"] = fetch
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(blob, f, protocol=4)
    psave(params, path + ".pdiparams")
    meta = {"num_inputs": len(feeds), "param_names": list(params),
            "program_names": program_names}
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f, protocol=4)


def _meta(path):
    """``path``'s ``.pdmeta`` dict, None without one."""
    if not os.path.exists(path + ".pdmeta"):
        return None
    with open(path + ".pdmeta", "rb") as f:
        return pickle.load(f)


def _is_module_save(meta):
    return meta is not None and meta.get("format") == _MODULE_FORMAT


def read_program_blob(path):
    """The program blob of ``path + '.pdmodel'``; a file the reference's
    ``jit.save`` wrote (serialized StableHLO) raises ValueError naming
    that, and so does a ``torch.nn.Module``'s exported program."""
    if _is_module_save(_meta(path)):
        raise ValueError(
            f"{path}.pdmodel is a torch.nn.Module's torch.export program, "
            "not a static Program: load it with jit.load or "
            "inference.create_predictor")
    with open(path + ".pdmodel", "rb") as f:
        data = f.read()
    blob = None
    if data[:1] == _PICKLE_MAGIC:
        try:
            blob = pickle.loads(data)
        except Exception:  # noqa: BLE001 - named below
            blob = None
    if not isinstance(blob, dict) or "records" not in blob:
        raise ValueError(
            f"{path}.pdmodel is not a program of this package: the JAX "
            "reference's jit.save writes a jax.export StableHLO program, "
            "which needs JAX to run. Its parameters cross: load "
            f"{path}.pdiparams with paddle_tpu_torch.load into the same "
            "Layer written in this package, then jit.save it here")
    return blob


def persist_values(path):
    """Program persistable name -> value from ``path``'s ``.pdiparams``
    through its ``.pdmeta`` map (None without a ``.pdmeta``)."""
    from ..framework.io_utils import load as pload
    if not os.path.exists(path + ".pdmeta"):
        return None
    with open(path + ".pdmeta", "rb") as f:
        meta = pickle.load(f)
    names = meta["program_names"]
    return {names[s]: v for s, v in pload(path + ".pdiparams").items()
            if s in names}


class TranslatedLayer:
    """A loaded inference model (reference: jit.py:876 TranslatedLayer):
    the program run by an ``Executor`` on the device of its
    persistables."""

    def __init__(self, program, feed_names, fetch_names, params, device):
        from ..static.program import Executor
        self._program = program
        self._feeds = [program.vars[n] for n in feed_names]
        self._fetch = list(fetch_names)
        self._params = params
        self._device = device
        self._exe = Executor(device_mod.place_of(device))
        self._runs = {}

    def _host(self, var, x):
        """``x`` as a torch tensor where it lies, checked against the feed
        ``var``: its rank, each fixed dim, its dtype."""
        if isinstance(x, Tensor):
            v = x._value
        elif isinstance(x, torch.Tensor):
            v = x
        else:
            v = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        want = var._shape
        if v.dim() != len(want):
            raise ValueError(
                f"input {var.name!r}: rank {v.dim()} (shape "
                f"{list(v.shape)}), the program takes {list(want)}")
        for i, (got, d) in enumerate(zip(v.shape, want)):
            if d != -1 and got != d:
                raise ValueError(
                    f"input {var.name!r}: dim {i} is {got}, the program "
                    f"fixes it at {d} (shape {list(want)})")
        if v.dtype != var._v.dtype:
            raise ValueError(
                f"input {var.name!r}: dtype {v.dtype}, the program takes "
                f"{var._v.dtype}")
        return v

    def __call__(self, *inputs):
        outs = self.run(inputs)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def run(self, inputs, to_numpy=False):
        """The program's outputs for ``inputs`` (Tensors, torch tensors or
        arrays), as Tensors or, with ``to_numpy``, as numpy arrays. On the
        card every device step of the call (the feeds' copies, the run,
        the outputs' copies to the host) holds ``CAPTURE_LOCK``: alone
        while the feed signature may still record or capture, shared
        after."""
        if len(inputs) != len(self._feeds):
            raise ValueError(f"the program takes {len(self._feeds)} inputs, "
                             f"got {len(inputs)}")
        host = [self._host(var, x) for var, x in zip(self._feeds, inputs)]
        sig = tuple((tuple(v.shape), v.dtype) for v in host)
        runs = self._runs.get(sig, 0)
        self._runs[sig] = runs + 1
        hold = contextlib.nullcontext()
        if self._device.type == "cuda":
            hold = CAPTURE_LOCK.exclusive() if runs < _CAPTURE_RUNS \
                else CAPTURE_LOCK.shared()
        with hold:
            outs = self._call(host)
            if to_numpy:
                outs = [o.numpy() for o in outs]
        return outs

    def _call(self, host):
        feed = {var.name: v.to(self._device)
                for var, v in zip(self._feeds, host)}
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch, return_numpy=False)

    forward = __call__

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only")

    def state_dict(self):
        return self._params

    def graphs(self):
        """The CUDA graphs the Executor captured (one a feed signature)."""
        return [g for fn in self._exe._cache.values()
                if hasattr(fn, "graphs") for g in fn.graphs()]

    def pool_bytes(self):
        """Bytes the card holds in the graph pools of this model."""
        return sum(fn.pool_bytes() for fn in self._exe._cache.values()
                   if hasattr(fn, "pool_bytes"))


class TranslatedModule(TranslatedLayer):
    """A loaded ``torch.nn.Module`` (``jit.save``'s ``torch.export``
    path): the exported module over the ``.pdiparams`` values on
    ``device``. On the card each input signature is one CUDA graph
    (``jit.to_static``: eager, recorded, captured, then replayed), so the
    K1 node's launches read captured x replays; on the CPU the module runs
    eagerly."""

    def __init__(self, loaded, device):
        from ..static.program import Variable
        self._gm, self._params, specs = loaded
        # the feeds' shapes and dtypes, checked as a program's are
        self._feeds = [Variable(f"x{i}", shape, dtype, None)
                       for i, (shape, dtype) in enumerate(specs)]
        self._device = device
        self._runs = {}
        self._fn = self._forward
        if device.type == "cuda":
            from .to_static import TracedFunction
            self._fn = TracedFunction(self._forward, enable_ast=False)

    def _forward(self, *xs):
        with torch.no_grad():
            out = self._gm(*xs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def _call(self, host):
        return [Tensor._wrap(o) for o in self._fn(
            *[v.to(self._device) for v in host])]

    def graphs(self):
        return self._fn.graphs() if hasattr(self._fn, "graphs") else []

    def pool_bytes(self):
        return self._fn.pool_bytes() if hasattr(self._fn, "pool_bytes") \
            else 0


def _load_module(path, meta, device):
    """``(module, params, specs)`` of a ``torch.export`` save: the
    program's module on ``device`` with the ``.pdiparams`` values (the
    reference's names and layout, turned back by ``text.convert``)."""
    from ..framework.io_utils import load as pload
    from ..text.convert import state_dict_from_paddle_tpu
    with open(path + ".pdmodel", "rb") as f:
        ep = torch.export.load(f)
    _broadcast_zeros(ep, device)
    if torch.device(meta["device"]) != device:
        # the program's own device arguments (an arange's)
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, device)
    gm = ep.module()
    sd = {k: v.to(device) for k, v in state_dict_from_paddle_tpu(
        pload(path + ".pdiparams")).items()}
    gm.load_state_dict(sd, assign=True)
    specs = [(shape, dtype_mod.to_torch_dtype(dt))
             for shape, dt in meta["specs"]]
    params = dict(gm.state_dict())
    return gm, params, specs


def translated(loaded, device):
    """The layer that runs what ``load_program`` read: a
    ``TranslatedModule`` for a module's exported program, else a
    ``TranslatedLayer``."""
    if isinstance(loaded, _LoadedModule):
        return TranslatedModule(loaded, device)
    return TranslatedLayer(*loaded, device)


class _LoadedModule(tuple):
    """``load_program``'s result for a ``torch.export`` save."""


def load_program(path, device=None):
    """``(program, feed_names, fetch_names, params)`` of ``path``'s files
    with the persistables on ``device`` (default: the current device).
    Reads a ``jit.save`` model, or a ``static.save_inference_model``
    program (which holds its values; ``params`` then by program name).
    A ``torch.nn.Module``'s save gives ``(module, params, specs)``
    instead; ``translated`` makes either one's layer."""
    from ..static.program import _deserialize_program
    dev = device_mod.resolve_device(device)
    meta = _meta(path)
    if _is_module_save(meta):
        return _LoadedModule(_load_module(path, meta, dev))
    blob = read_program_blob(path)
    values = persist_values(path)
    prog = _deserialize_program(blob, dev, values)
    params = {}
    if os.path.exists(path + ".pdmeta"):
        with open(path + ".pdmeta", "rb") as f:
            meta = pickle.load(f)
        for sname in meta["param_names"]:
            params[sname] = prog.persist[meta["program_names"][sname]]
    else:
        params = dict(prog.persist)
    feeds = list(blob.get("feed_targets") or prog.feed_names)
    return prog, feeds, list(blob.get("fetch_targets", [])), params


def load(path, device=None, **configs):
    """The TranslatedLayer of ``path``'s files, on ``device`` (a Place,
    ``'cpu'``, ``'gpu'``, a torch device; default the current device, the
    card unless ``set_device('cpu')``)."""
    dev = device_mod.resolve_device(
        device if not isinstance(device, str)
        else device.replace("gpu", "cuda"))
    return translated(load_program(path, dev), dev)
