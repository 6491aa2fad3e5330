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

The learning rate is a Python float rounded to f32, as the reference's
f32 learning-rate tensor holds it; an ``LRScheduler`` writes into it.
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

``state_dict()`` keys each state tensor ``f"{name}_{kind}"`` (``name``
as given with the parameters, a ``Parameter``'s own ``.name``, as the
reference's; ``kind`` the reference's: ``moment1``, ``beta1_pow``,
``velocity``, ...) beside an ``"LR_Scheduler"`` entry;
``text.convert.optimizer_state_from_paddle_tpu`` carries a reference
optimizer's state across.
"""
import torch

from ..amp.auto_cast import op_body
from ..core.sparse_grad import sparse_slices
from ..core.tensor import Tensor
from .lr import LRScheduler


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
            raise ValueError("parameters must be given (pass "
                             "model.parameters() or model.named_parameters())")
        self._params = _named(parameters)
        self._grad_clip = grad_clip
        self._accumulators = {}
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
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            learning_rate._bind(self)
        else:
            self._lr_scheduler = None
            self.set_lr(learning_rate)

    def get_lr(self):
        return self._lr

    def set_lr(self, value):
        self._lr = _f32(value)

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
        for p in self._parameter_list():
            p.grad = None

    clear_gradients = clear_grad

    @torch.no_grad()
    def step(self):
        params_grads = [(p, _leaf(p).grad) for _, p in self._params
                        if _leaf(p).grad is not None
                        and _leaf(p).requires_grad]
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
        core Tensor loss; returns ``(None, None)`` as the reference's
        dygraph branch does."""
        if not isinstance(loss, (torch.Tensor, Tensor)):
            raise NotImplementedError(
                "minimize of a static-program variable is not ported")
        loss.backward()
        self.step()
        return None, None

    def _acc(self, kind, param, init=0.0, shape=None):
        """The f32 state ``kind`` of ``param`` on its device, made on
        first use and filled with ``init``."""
        store = self._accumulators.setdefault(kind, {})
        key = id(param)
        if key not in store:
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
        name, by the saved ``param_order``. Values are copied into
        existing state, or made f32 on the parameter's device."""
        meta = state_dict.get("LR_Scheduler")
        keys = [k for k in state_dict if k != "LR_Scheduler"]
        hits = sum(1 for k in keys
                   if any(k.startswith(n + "_") for n, _ in self._params))
        order = meta.get("param_order") if isinstance(meta, dict) else None
        if hits == 0 and order is not None \
                and len(order) == len(self._params):
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
