"""Dynamic loss scaling (reference ``paddle_tpu/amp/grad_scaler.py``).

``scaler.scale(loss).backward()``, then ``scaler.step(opt)`` unscales
the grads, checks them for inf/nan and skips the update when it finds
any, and ``update()`` moves the scale: times ``incr_ratio`` after
``incr_every_n_steps`` good steps in a row, times ``decr_ratio`` (never
below 1) after ``decr_every_n_nan_or_inf`` bad ones. The scale and the
counters are f32 / int32 scalars on the CPU, updated by the reference's
rule (``_update_loss_scaling``, :37-52). The reference masks a skipped
step branch-free so that it traces; eager PyTorch reads the flag and
does not call ``optimizer.step()``, which leaves the parameters and the
optimizer's state as they were, as the reference's masking does. That
read is a host sync and the state lives on the host, so an enabled
scaler inside a step captured by ``jit.to_static`` raises
``ToStaticError``. Inside
an ``auto_cast`` the unscaling runs uncast, like the body of a port op:
a grad keeps its parameter's dtype, and is divided in place. Under lazy
eager the inf check's read ends the step's first graph (forward and
backward); the update after it is a second.
"""
import torch

from ..core import trace as _trace
from ..core.tensor import Tensor
from .auto_cast import op_body

_HOST_STATE = ("GradScaler (its scale and counters live on the host and "
               "it reads the inf flag there)")


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n = int(decr_every_n_nan_or_inf)
        self._scale = torch.tensor(float(init_loss_scaling),
                                   dtype=torch.float32)
        self._good_steps = torch.tensor(0, dtype=torch.int32)
        self._bad_steps = torch.tensor(0, dtype=torch.int32)
        self._found_inf = None

    def is_enable(self):
        return self._enable

    def scale(self, loss):
        if not self._enable:
            return loss
        _trace.refuse_in_capture(_HOST_STATE)
        if isinstance(loss, Tensor):
            # an eager core loss: the product is an op (deferred under
            # lazy eager), the scale joining it on its device and dtype
            v = loss._v
            return loss * Tensor._wrap(self._scale.to(v.device, v.dtype))
        return loss * self._scale.to(loss.device, loss.dtype)

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every grad by the scale (reference
        ``check_finite_and_unscale``) and note whether any was not
        finite."""
        if not self._enable:
            return
        _trace.refuse_in_capture(_HOST_STATE)
        params = [p for p in optimizer._parameter_list() if p.grad is not None]
        if not params:
            return
        with op_body():
            finite = torch.stack([torch.isfinite(p.grad).all().cpu()
                                  for p in params]).all()
            inv = 1.0 / self._scale
            for p in params:
                # in place: the grads keep the storage a lazy step's
                # graph replays into
                p.grad.mul_(inv.to(p.grad.device, p.grad.dtype))
        self._found_inf = not bool(finite)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._found_inf is None:
            self.unscale_(optimizer)
        if self._found_inf is None:      # no grads at all
            optimizer.step()
            self.update()
            return
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._use_dynamic):
            self._found_inf = None
            return
        if self._found_inf is None:
            return
        if self._found_inf:
            bad, good = self._bad_steps + 1, torch.zeros_like(self._good_steps)
        else:
            bad, good = torch.zeros_like(self._bad_steps), self._good_steps + 1
        shrink = bool(bad >= self._decr_every_n)
        grow = bool(good >= self._incr_every_n_steps)
        if shrink:
            new_scale = torch.clamp(self._scale * self._decr_ratio, min=1.0)
            bad = torch.zeros_like(bad)
        elif grow:
            new_scale = self._scale * self._incr_ratio
        else:
            new_scale = self._scale
        if grow:
            good = torch.zeros_like(good)
        if bool(torch.isfinite(new_scale)):
            self._scale = new_scale
        self._good_steps, self._bad_steps = good, bad
        self._found_inf = None

    def state_dict(self):
        return {"scale": self._scale.clone(),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": self._good_steps.clone(),
                "use_dynamic_loss_scaling": self._use_dynamic}

    def load_state_dict(self, state):
        self._scale = torch.as_tensor(state["scale"], dtype=torch.float32)
        self._good_steps = torch.as_tensor(state["good_steps"],
                                           dtype=torch.int32)

    def get_loss_scaling(self):
        return self._scale.clone()


AmpScaler = GradScaler
