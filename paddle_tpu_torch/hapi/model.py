"""The high-level ``Model`` API (a port of ``paddle_tpu/hapi/model.py``):
``prepare``, ``train_batch``, ``eval_batch``, ``predict_batch``, ``fit``
(with gradient accumulation), ``evaluate``, ``predict``, ``save`` and
``load``.

Both of the reference's branches: in dygraph mode each step runs
eagerly; after ``enable_static()`` the train, eval and predict steps run
through ``jit.to_static`` (``_static_step``), one ``TracedFunction`` a
mode, captured as CUDA graphs on the card, and ``fit`` with
``accumulate_grad_batches=k`` runs each window of k batches as one step
(``_run_static_window``). Metrics stay eager over the step's returned
outputs. ``prepare`` drops the compiled steps, which close over the
loss and the optimizer. Each batch runs inside an
``observability.tracing.span_timer``
named ``hapi/train_batch``, ``hapi/eval_batch`` or
``hapi/predict_batch``, the reference's ``record_scope`` names. As in the
reference, a batch's last element is its only label (``_split_batch``),
and ``Model(inputs=, labels=)`` are taken and not read.
"""
import os

import numpy as np

from ..core.dispatch import no_grad
from ..core.tensor import Tensor
from ..io import DataLoader
from ..observability.tracing import span_timer
from ..ops import math as math_ops
from . import callbacks as cb_mod


def _as_tensors(xs, allow_none=False):
    return [x if isinstance(x, Tensor) or (allow_none and x is None)
            else Tensor(np.asarray(x)) for x in xs]


def _listed(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _in_static_mode():
    from ..static import _static_mode
    return bool(_static_mode[0])


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        # the static branch's steps, one TracedFunction a mode
        self._static_steps = {}

    # ---- the static branch (reference hapi/model.py:43-115) --------------
    def _total(self, outs, labs):
        loss_list = self._losses(outs, labs)
        total = loss_list[0]
        for extra in loss_list[1:]:
            total = math_ops.add(total, extra)
        return loss_list, total

    def _static_step(self, mode):
        step = self._static_steps.get(mode)
        if step is not None:
            return step
        from ..jit import to_static
        model = self

        if mode == "train":
            def raw(ins, labs, update):
                outs = _listed(model.network(*ins))
                loss_list, total = model._total(outs, labs)
                total.backward()
                if update:
                    model._optimizer.step()
                    model._optimizer.clear_grad()
                return loss_list, outs
        elif mode == "train_window":
            # gradient accumulation: the window of k batches is one step,
            # k backwards into the grads, then one update
            def raw(ins_seq, labs_seq):
                per = []
                for ins, labs in zip(ins_seq, labs_seq):
                    outs = _listed(model.network(*ins))
                    loss_list, total = model._total(outs, labs)
                    total.backward()
                    per.append((loss_list, outs))
                model._optimizer.step()
                model._optimizer.clear_grad()
                return per
        elif mode == "eval":
            def raw(ins, labs):
                outs = _listed(model.network(*ins))
                if model._loss is None:
                    return [], outs
                return model._losses(outs, labs), outs
        else:
            def raw(ins):
                return _listed(model.network(*ins))
        step = self._static_steps[mode] = to_static(raw)
        return step

    def _run_static_window(self, window, cbks, batch_size):
        """One accumulation window as one static step, then each batch's
        callbacks, metrics and logs in order."""
        self.network.train()
        ins_seq = [_as_tensors(ins) for _, ins, _ in window]
        labs_seq = [_as_tensors(labs, allow_none=True)
                    for _, _, labs in window]
        with span_timer("hapi/train_window"):
            results = self._static_step("train_window")(ins_seq, labs_seq)
        logs = {}
        for (step, _, _), labs, (loss_list, outs) in zip(window, labs_seq,
                                                         results):
            cbks.on_batch_begin("train", step, {})
            metrics = self._update_metrics(outs, labs)
            vals = [float(v.numpy()) for v in loss_list]
            logs = self._pack_logs((vals, metrics) if metrics else vals,
                                   batch_size)
            cbks.on_batch_end("train", step, logs)
        return logs

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """``amp_configs`` is taken and not read, as in the reference."""
        self._optimizer = optimizer
        self._loss = loss
        self._static_steps = {}
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]

    # ---- single-batch ops ------------------------------------------------
    def _losses(self, outs, labs):
        return _listed(self._loss(*(outs + [y for y in labs
                                             if y is not None])))

    def _update_metrics(self, outs, labs):
        return [m.update(m.compute(*(outs + [y for y in labs
                                             if y is not None])))
                for m in self._metrics]

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        ins = _as_tensors(_listed(inputs))
        labs = _as_tensors(_listed(labels), allow_none=True)
        with span_timer("hapi/train_batch"):
            if _in_static_mode():
                loss_list, outs = self._static_step("train")(
                    ins, labs, bool(update))
            else:
                outs = _listed(self.network(*ins))
                loss_list, total = self._total(outs, labs)
                total.backward()
                if update:
                    self._optimizer.step()
                    self._optimizer.clear_grad()
        metrics = self._update_metrics(outs, labs)
        vals = [float(v.numpy()) for v in loss_list]
        return (vals, metrics) if metrics else vals

    @no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        ins = _as_tensors(_listed(inputs))
        labs = _as_tensors(_listed(labels), allow_none=True)
        with span_timer("hapi/eval_batch"):
            if _in_static_mode():
                loss_list, outs = self._static_step("eval")(ins, labs)
                loss_list = loss_list if self._loss is not None else None
            else:
                outs = _listed(self.network(*ins))
                loss_list = self._losses(outs, labs) \
                    if self._loss is not None else None
        metrics = self._update_metrics(outs, labs)
        if loss_list is not None:
            vals = [float(v.numpy()) for v in loss_list]
            return (vals, metrics) if metrics else vals
        return ([], metrics)

    @no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        ins = _as_tensors(_listed(inputs))
        with span_timer("hapi/predict_batch"):
            if _in_static_mode():
                outs = self._static_step("predict")(ins)
            else:
                outs = _listed(self.network(*ins))
        return [o.numpy() for o in outs]

    # ---- loops -----------------------------------------------------------
    def _to_loader(self, data, batch_size, shuffle):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        """``drop_last`` and ``num_workers`` are taken and not read (a
        dataset goes through ``DataLoader(batch_size, shuffle)``), as in
        the reference. The optimizer steps every
        ``accumulate_grad_batches`` batches and on an epoch's last."""
        train_loader = self._to_loader(train_data, batch_size, shuffle)
        eval_loader = self._to_loader(eval_data, batch_size, False)
        cbks = cb_mod.config_callbacks(callbacks, model=self,
                                       epochs=epochs,
                                       steps=_safe_len(train_loader),
                                       log_freq=log_freq,
                                       save_freq=save_freq,
                                       save_dir=save_dir,
                                       verbose=verbose,
                                       metrics=self._metrics_names())
        cbks.on_begin("train")
        self.stop_training = False
        it_count = 0
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            train_logs = {}
            n_steps = _safe_len(train_loader)
            k = max(1, int(accumulate_grad_batches))
            # the static branch runs each window of k batches as one step
            use_window = _in_static_mode() and k > 1
            window = []
            pending = False
            for step, batch in enumerate(train_loader):
                ins, labs = _split_batch(batch)
                if use_window:
                    window.append((step, ins, labs))
                    if len(window) == k or (n_steps is not None
                                            and step + 1 == n_steps):
                        train_logs = self._run_static_window(
                            window, cbks, batch_size)
                        window = []
                    it_count += 1
                    if (num_iters is not None and it_count >= num_iters) \
                            or self.stop_training:
                        break
                    continue
                cbks.on_batch_begin("train", step, {})
                # grads sum over the backwards between updates, since
                # clear_grad runs only with one
                update = ((step + 1) % k == 0
                          or (n_steps is not None and step + 1 == n_steps))
                res = self.train_batch(ins, labs, update=update)
                pending = not update
                train_logs = self._pack_logs(res, batch_size)
                cbks.on_batch_end("train", step, train_logs)
                it_count += 1
                if (num_iters is not None and it_count >= num_iters) or \
                        self.stop_training:
                    break
            if window:
                # the tail of a loader of unknown length, or a break
                train_logs = self._run_static_window(window, cbks,
                                                     batch_size)
            if pending:
                # a loader of unknown length ended between updates: step
                # on what the last batches accumulated
                self._optimizer.step()
                self._optimizer.clear_grad()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_res = self.evaluate(eval_loader, verbose=0)
                for name, v in eval_res.items():
                    train_logs["eval_" + name] = v
            cbks.on_epoch_end(epoch, train_logs)
            if self.stop_training or (num_iters is not None
                                      and it_count >= num_iters):
                break
        cbks.on_end("train", {})

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """The mean of the batches' losses and each metric's
        accumulation (``log_freq``, ``verbose``, ``num_workers``,
        ``callbacks`` and ``num_samples`` taken and not read)."""
        loader = self._to_loader(eval_data, batch_size, False)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            ins, labs = _split_batch(batch)
            res = self.eval_batch(ins, labs)
            losses.extend(res[0] if isinstance(res, tuple) else res)
        out = {}
        if losses:
            out["loss"] = float(np.mean(losses))
        for m in self._metrics:
            name = m.name()
            acc = m.accumulate()
            if isinstance(name, list):
                out.update(zip(name, acc))
            else:
                out[name] = acc
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """Each batch's outputs as numpy; a batch's last element is taken
        for its label and dropped when a loss is prepared."""
        loader = self._to_loader(test_data, batch_size, False)
        outputs = []
        for batch in loader:
            ins, _ = _split_batch(batch, has_label=self._loss is not None)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            return [np.concatenate([o[i] for o in outputs], axis=0)
                    for i in range(len(outputs[0]))]
        return outputs

    # ---- persistence -----------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (and with ``training`` the optimizer's
        ``path.pdopt``) through ``framework.io_utils.save``, files the
        reference's ``Model.load`` reads."""
        from ..framework.io_utils import save as psave
        psave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            psave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io_utils import load as pload
        self.network.set_state_dict(pload(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(pload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)

    # ---- helpers ---------------------------------------------------------
    def _metrics_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _pack_logs(self, res, batch_size):
        logs = {"batch_size": batch_size}
        losses, metrics = res if isinstance(res, tuple) else (res, [])
        if losses:
            logs["loss"] = losses[0] if len(losses) == 1 else losses
        for m, val in zip(self._metrics, metrics):
            n = m.name()
            if isinstance(n, list):
                logs.update(zip(n, val))
            else:
                logs[n] = val
        return logs


def _split_batch(batch, has_label=True):
    """``(inputs, [label])``: the last element of a list or tuple batch is
    the only label."""
    if isinstance(batch, (list, tuple)):
        if len(batch) >= 2 and has_label:
            return list(batch[:-1]), [batch[-1]]
        return list(batch), [None]
    return [batch], [None]


def _safe_len(loader):
    try:
        return len(loader)
    except TypeError:
        return None
