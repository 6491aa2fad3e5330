"""Optimizer base (reference ``paddle_tpu/optimizer/optimizer.py``).

The training loop is the reference's, in user code::

    loss = model(ids, labels=labels)
    loss.backward()
    opt.step()          # or opt.minimize(loss) for the two lines above
    opt.clear_grad()

``step()`` runs under ``torch.no_grad()`` in the reference's order: the
grad clip first (it returns new grads and leaves ``p.grad`` as it is),
then an ``L1Decay`` regularizer's ``coeff * sign(param)`` added to the
clipped grads, then one update per parameter, which writes the
parameter and its f32 state in place (the reference returned new
arrays).

The learning rate is a 0-d f32 tensor on the parameters' device that
every update reads, as the reference's persistable learning-rate tensor
is (``paddle_tpu/optimizer/optimizer.py:59-62``): ``set_lr`` and an
``LRScheduler`` fill it in place, so a step captured as a CUDA graph
(``jit.to_static``) reads the rate of the moment it is replayed.
``get_lr()`` returns a host mirror, the value rounded to f32, without a
sync. Setting the rate or making a parameter's state inside a captured
step raises ``ToStaticError``: either would happen once, at capture.
Inside an ``amp.auto_cast`` the update runs uncast, like the body of a
port op.

A sparse grad (``nn.Embedding(sparse=True)``'s, a sparse COO tensor on
the leaf) is coalesced and goes to the optimizer's ``_apply_sparse``:
SGD and Adam/AdamW update the looked-up rows (Adam's default
``lazy_mode=False`` is dense-equivalent), and the other optimizers
densify it (reference ``optimizer.py:114-125``).

The parameters are torch tensors (the GPT's) or the eager core's
``Parameter``s (``nn.Layer.parameters()``): a ``Parameter``'s torch
leaf is updated in place, so the ``Parameter`` keeps its identity and
its ``grad``; the grad clip sees the ``Parameter`` itself (its
``need_clip``).

``minimize`` of a static program's Variable loss (under
``enable_static``) appends the gradient boundary and one update record
to the program (``static/program.py``): at each ``Executor.run`` the
record runs this optimizer's clip, L1 decay and per-parameter updates on
the program's grads, as ``step()`` does on ``.grad``. The reference
records each update through its op hooks; the port's updates are
torch-level, so the record runs them (the op list differs, the values do
not). In static mode ``parameters`` may be None: the update covers the
program's trainable persistables.

Under lazy eager (``core/lazy.py``) ``step()`` of an optimizer over the
eager core's ``Parameter``s is one deferred node of the step's graph,
which runs this body when the graph runs (as the static update record
does); ``clear_grad()`` runs the pending graph and then clears, so an
eager step with no annotation is flushed there and, on the card, replayed
as one CUDA graph from its third step. ``set_lr`` (an ``LRScheduler``'s
step) runs a pending graph first, so a rate set between steps reaches the
next replay through the 0-d rate tensor. An optimizer over plain torch
tensors steps at once. ``step()`` runs inside
``profiler.record_scope("optimizer/step")``.

``state_dict()`` keys each state tensor ``f"{name}_{kind}"`` (``name``
as given with the parameters, a ``Parameter``'s own ``.name``, as the
reference's; ``kind`` the reference's: ``moment1``, ``beta1_pow``,
``velocity``, ...) beside an ``"LR_Scheduler"`` entry;
``text.convert.optimizer_state_from_paddle_tpu`` carries a reference
optimizer's state across.
"""
import itertools

import torch

from ..amp.auto_cast import op_body
from ..core import lazy as _lazy
from ..core import trace as _trace
from ..core.sparse_grad import sparse_slices
from ..core.tensor import Tensor
from .lr import LRScheduler

# each optimizer's step node key: a serial never given to another
# optimizer (an id() is reused once its object is freed, and a replay
# entry keyed on it would replay a dead optimizer's captured step)
_step_serials = itertools.count()


def _f32(x):
    return float(torch.tensor(float(x), dtype=torch.float32))


def _dense(grad):
    """A grad as a dense torch tensor (a sparse one summed into its
    rows)."""
    return grad.to_dense() if grad.is_sparse else grad


def _leaf(entry):
    """The torch tensor of a parameter: a ``Parameter``'s leaf, or the
    tensor itself."""
    return entry._value if isinstance(entry, Tensor) else entry


def _named(parameters):
    """``[(name, parameter)]`` of ``parameters``: tensors or
    ``Parameter``s, ``(name, tensor)`` pairs or param-group dicts
    (``{"params": [...]}``), flattened as the reference flattens them; a
    ``Parameter`` without a given name goes by its ``.name``, a torch
    tensor by ``param_<i>``, its place in the flat list."""
    flat = []
    for entry in parameters:
        if isinstance(entry, dict):
            flat.extend(entry["params"])
        else:
            flat.append(entry)
    out = []
    for i, entry in enumerate(flat):
        if isinstance(entry, tuple):
            out.append(entry)
        elif isinstance(entry, Tensor):
            out.append((entry.name, entry))
        else:
            out.append((f"param_{i}", entry))
    return out


class Optimizer:
    """``parameters``: tensors or ``Parameter``s (``model.parameters()``),
    ``(name, tensor)`` pairs (``model.named_parameters()``) or
    param-group dicts of either; as in the reference, a group's own
    options are not read. Only parameters with ``requires_grad`` (not
    ``stop_gradient``) and a grad are updated.
    ``weight_decay``: a float or ``regularizer.L2Decay`` is L2 decay
    coupled into the update; ``regularizer.L1Decay`` adds
    ``coeff * sign(param)`` to the clipped grad."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            from ..static.program import building_program
            if building_program() is None:
                raise ValueError(
                    "parameters must be given (pass model.parameters() or "
                    "model.named_parameters())")
            parameters = []    # static: minimize takes the program's
        self._params = _named(parameters)
        self._grad_clip = grad_clip
        self._accumulators = {}
        self._step_key = ("optimizer.step", next(_step_serials))
        self._l1_coeff = 0.0
        if isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)  # grad += wd * param
        elif weight_decay is None:
            self._weight_decay = 0.0
        else:
            coeff = getattr(weight_decay, "_coeff",
                            getattr(weight_decay, "coeff", None))
            if coeff is None:
                raise TypeError(f"weight_decay must be a float, L1Decay or "
                                f"L2Decay, got {weight_decay!r}")
            self._weight_decay = float(coeff)
            if getattr(weight_decay, "_mode", "l2") == "l1":
                self._l1_coeff, self._weight_decay = self._weight_decay, 0.0
        self._lr = 0.0
        # device -> the rate as a 0-d f32 tensor there
        self._lr_dev = {d: torch.zeros((), dtype=torch.float32, device=d)
                        for d in {_leaf(p).device for _, p in self._params}}
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            learning_rate._bind(self)
        else:
            self._lr_scheduler = None
            self.set_lr(learning_rate)

    def get_lr(self):
        return self._lr

    def set_lr(self, value):
        _trace.refuse_in_capture(
            "set_lr (an LRScheduler's step included): step the scheduler "
            "between replays")
        _lazy.flush()
        self._lr = _f32(value)
        for t in self._lr_dev.values():
            t.fill_(self._lr)

    def _lr_of(self, param):
        """The rate tensor on ``param``'s device."""
        t = self._lr_dev.get(param.device)
        if t is None:
            _trace.refuse_in_capture("a learning-rate tensor made")
            t = self._lr_dev[param.device] = torch.full(
                (), self._lr, dtype=torch.float32, device=param.device)
        return t

    def _parameter_list(self):
        """The parameters' torch tensors, in order."""
        return [_leaf(p) for _, p in self._params]

    def _given(self, leaf):
        """The parameter as it was given (a ``Parameter`` or the torch
        tensor) for its torch tensor."""
        for _, p in self._params:
            if _leaf(p) is leaf:
                return p
        return leaf

    def clear_grad(self, set_to_zero=False):
        _lazy.flush()
        for p in self._parameter_list():
            p.grad = None

    clear_gradients = clear_grad

    def step(self):
        from ..profiler import record_scope
        with record_scope("optimizer/step"):
            if not self._defer_step():
                self._step_now()

    def _defer_step(self):
        """Defer this step as one node of the lazy graph (an optimizer
        over the eager core's Parameters, under lazy eager)."""
        if not (self._params and isinstance(self._params[0][1], Tensor)
                and _lazy.enabled()):
            return False
        _lazy.dispatch(self._run_step, self._step_key, [], writer=True,
                       device=self._params[0][1]._v.device, holder=self)
        return True

    def _run_step(self):
        self._step_now()

    def _step_now(self):
        self._apply_grads([(p, _leaf(p).grad) for _, p in self._params
                           if _leaf(p).grad is not None
                           and _leaf(p).requires_grad])

    @torch.no_grad()
    def _apply_grads(self, params_grads):
        """The clip, the L1 decay and one update a parameter over
        ``[(parameter as given, grad)]`` (``step()``'s body; a static
        program's update record calls it with the program's grads)."""
        with op_body():
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            if self._l1_coeff:
                c = self._l1_coeff
                params_grads = [(p, _dense(g) + c * torch.sign(
                    _leaf(p).to(g.dtype))) for p, g in params_grads]
            names = {id(p): n for n, p in self._params}
            for p, g in params_grads:
                rows = sparse_slices(g)
                if rows is not None:
                    # the rows the grad touches (reference
                    # optimizer.py:114-125: coalesced, then the
                    # optimizer's sparse update)
                    self._apply_sparse(names[id(p)], _leaf(p),
                                       rows.coalesce())
                else:
                    self._apply_one(names[id(p)], _leaf(p), g)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()`` for a torch tensor or a
        core Tensor loss, returning ``(None, None)`` as the reference's
        dygraph branch does; for a static Variable, the gradient
        boundary and the update record, returning ``(None,
        [(param, grad_var)])``."""
        if isinstance(loss, Tensor) and loss._symbolic:
            return self._minimize_static(loss, parameters)
        if not isinstance(loss, (torch.Tensor, Tensor)):
            raise NotImplementedError(
                f"minimize takes a torch tensor, a Tensor or a static "
                f"program's Variable, got {type(loss).__name__}")
        loss.backward()
        self.step()
        return None, None

    def _minimize_static(self, loss, parameters=None):
        """Reference ``_minimize_static`` (optimizer.py:127-154): the
        grads of ``parameters`` (else this optimizer's, else the
        program's trainable persistables), then one record that updates
        them at each run."""
        from ..static.program import UpdateRecord
        prog = loss.program
        params = parameters
        if params is None:
            params = [p for _, p in self._params
                      if isinstance(p, Tensor)] or None
        params_grads = prog.append_backward(loss, params)
        have = {id(p) for _, p in self._params}
        for p, _ in params_grads:
            if id(p) not in have:
                self._params.append((p.name, p))
        prog.ops.append(UpdateRecord(self, [(p, g.name)
                                            for p, g in params_grads]))
        return None, params_grads

    def _acc(self, kind, param, init=0.0, shape=None):
        """The f32 state ``kind`` of ``param`` on its device, made on
        first use and filled with ``init``."""
        store = self._accumulators.setdefault(kind, {})
        key = id(param)
        if key not in store:
            _trace.refuse_in_capture(
                f"the optimizer's {kind!r} state made (its first step): run "
                "a step eagerly first (to_static's warm-up)")
            store[key] = torch.full(param.shape if shape is None else shape,
                                    init, dtype=torch.float32,
                                    device=param.device)
        return store[key]

    def state_dict(self):
        """The live state tensors by ``f"{name}_{kind}"``, and under
        ``"LR_Scheduler"`` the learning rate, the scheduler's own state
        and the parameters' names in order."""
        names = {id(_leaf(p)): n for n, p in self._params}
        sd = {f"{names.get(pid, str(pid))}_{kind}": t
              for kind, store in self._accumulators.items()
              for pid, t in store.items()}
        meta = {"last_lr": self.get_lr()}
        if self._lr_scheduler is not None:
            meta.update(self._lr_scheduler.state_dict())
        meta["param_order"] = [n for n, _ in self._params]
        sd["LR_Scheduler"] = meta
        return sd

    def set_state_dict(self, state_dict):
        """Load a ``state_dict()``: each key goes to the parameter whose
        name prefixes it, longest name first (so a name that prefixes
        another's cannot take its state); where no key matches a current
        name, or the saved ``param_order`` names parameters this
        optimizer does not have (auto names of another process or package
        that overlap the current ones by chance), by that order. Values
        are copied into existing state, or made f32 on the parameter's
        device."""
        meta = state_dict.get("LR_Scheduler")
        keys = [k for k in state_dict if k != "LR_Scheduler"]
        hits = sum(1 for k in keys
                   if any(k.startswith(n + "_") for n, _ in self._params))
        order = meta.get("param_order") if isinstance(meta, dict) else None
        if order is not None and len(order) == len(self._params) and (
                hits == 0 or not set(order) <= {n for n, _ in self._params}):
            pairs = [(saved, _leaf(p))
                     for saved, (_, p) in zip(order, self._params)]
        else:
            pairs = [(n, _leaf(p)) for n, p in self._params]
        pairs.sort(key=lambda kv: -len(kv[0]))
        for key in keys:
            for name, p in pairs:
                if key.startswith(name + "_"):
                    store = self._accumulators.setdefault(
                        key[len(name) + 1:], {})
                    val = torch.as_tensor(state_dict[key])
                    if id(p) in store:
                        store[id(p)].copy_(val)
                    else:
                        store[id(p)] = val.detach().to(
                            device=p.device, dtype=torch.float32).clone()
                    break
        if isinstance(meta, dict):
            if self._lr_scheduler is not None and "last_epoch" in meta:
                self._lr_scheduler.last_epoch = meta["last_epoch"]
            if "last_lr" in meta:
                self.set_lr(meta["last_lr"])

    def _apply_one(self, name, param, grad):
        raise NotImplementedError

    def _apply_sparse(self, name, param, rows):
        """An optimizer without a sparse update densifies (reference
        ``Optimizer._apply_sparse``)."""
        self._apply_one(name, param, rows.to_dense())


class WrappedOptimizer:
    """Base of the optimizer-wrapping transforms (reference
    ``optimizer.py:246``: the meta-optimizers, ``incubate.LookAhead``,
    ASP's sparsity guarantee): everything goes to the inner optimizer
    through ``__getattr__``; a subclass overrides ``step``. A subclass
    that writes the parameters after the inner step runs the pending
    lazy graph first and writes their torch leaves at once, so a lazy
    step's graph is the same at every step whatever the wrapper does."""

    def __init__(self, inner_opt):
        self._inner_opt = inner_opt

    def __getattr__(self, item):
        if item == "_inner_opt":    # not set yet (copy, unpickling)
            raise AttributeError(item)
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad
