"""Training callbacks (a port of ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``ProgBarLogger``, ``ModelCheckpoint``, ``VisualDL``,
``LRScheduler``, ``EarlyStopping`` and ``config_callbacks``.
``EarlyStopping``'s ``verbose``, ``baseline`` and ``save_best_model`` are
taken and not read, as in the reference."""
import numbers
import time

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            c.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            c.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_begin")(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_end")(step, logs)


class ProgBarLogger(Callback):
    """Prints the logs and samples/s every ``log_freq`` steps."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._t0 = time.perf_counter()
        self._samples = 0

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        self.steps += 1
        self._samples += logs.get("batch_size", 0)
        if self.verbose and step % self.log_freq == 0:
            dt = time.perf_counter() - self._t0
            ips = self._samples / dt if dt > 0 else 0.0
            items = []
            for k, v in logs.items():
                if k == "batch_size":
                    continue
                if isinstance(v, numbers.Number):
                    items.append(f"{k}: {v:.4f}")
                elif isinstance(v, (list, np.ndarray)):
                    items.append(f"{k}: {np.asarray(v).mean():.4f}")
            print(f"Epoch {self.epoch} step {step}: " + ", ".join(items) +
                  f" - {ips:.1f} samples/sec")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.perf_counter() - self._t0
            print(f"Epoch {epoch} done in {dt:.2f}s: {logs}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_end(self, mode, logs=None):
        if mode == "train" and self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class VisualDL(Callback):
    """Scalars of the training into a TensorBoard events file
    (``utils/tbwriter.py``'s ``SummaryWriter``), tagged
    ``train/{loss,metric}``, ``train_epoch/...`` and ``eval/...``."""

    def __init__(self, log_dir, log_freq=1):
        super().__init__()
        self.log_dir = log_dir
        self.log_freq = int(log_freq)
        self.writer = None
        self._global_step = 0

    def _w(self):
        if self.writer is None:
            from ..utils.tbwriter import SummaryWriter
            self.writer = SummaryWriter(self.log_dir)
        return self.writer

    def _write_logs(self, prefix, logs, step):
        for k, v in (logs or {}).items():
            if k == "batch_size":
                continue
            if isinstance(v, numbers.Number):
                self._w().add_scalar(f"{prefix}/{k}", v, step)
            elif isinstance(v, (list, tuple, np.ndarray)):
                arr = np.asarray(v, dtype=np.float64).reshape(-1)
                if arr.size:
                    self._w().add_scalar(f"{prefix}/{k}",
                                         float(arr.mean()), step)

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        if self._global_step % self.log_freq == 0:
            self._write_logs("train", logs, self._global_step)

    def on_epoch_end(self, epoch, logs=None):
        self._write_logs("train_epoch", logs, epoch)
        self._w().flush()

    def on_eval_end(self, logs=None):
        self._write_logs("eval", logs, self._global_step)
        self._w().flush()

    def on_end(self, mode, logs=None):
        if mode == "eval":
            self.on_eval_end(logs)
        if self.writer is not None:
            self.writer.flush()
            if mode == "train":
                self.writer.close()
                self.writer = None  # a later fit() reopens cleanly


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, np.ndarray)):
            cur = float(np.asarray(cur).mean())
        improved = (self.best is None or
                    (self.mode == "min" and cur < self.best - self.min_delta) or
                    (self.mode == "max" and cur > self.best + self.min_delta))
        if improved:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks) if callbacks else []
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                   "metrics": metrics or []})
    return cl
