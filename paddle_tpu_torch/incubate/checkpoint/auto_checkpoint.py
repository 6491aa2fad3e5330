"""Auto checkpoint for a resumable training loop (a port of
``paddle_tpu/incubate/checkpoint/auto_checkpoint.py``; Paddle's
``fluid/incubate/checkpoint/auto_checkpoint.py:265`` ``TrainEpochRange``).

An epoch range snapshots the registered objects' state after every
completed epoch, under ``PADDLE_CHECKPOINT_DIR/PADDLE_JOB_ID/name``, so
that a relaunched job resumes after the last completed epoch with the
states put back. Files go through the port's ``framework`` save and
load (the reference's pickle format). The default directory is
``paddle_tpu_auto_ckpt`` under the process's temporary directory
(``tempfile.gettempdir()``, which ``TMPDIR`` sets; the reference's is
``/tmp/paddle_tpu_auto_ckpt``).
"""
import json
import os
import shutil
import tempfile
import time

import torch

from ...framework.io_utils import load as pload
from ...framework.io_utils import save as psave

_job_id = os.environ.get("PADDLE_JOB_ID", "default_job")
_root = os.environ.get("PADDLE_CHECKPOINT_DIR") or os.path.join(
    tempfile.gettempdir(), "paddle_tpu_auto_ckpt")


def set_checkpoint_dir(path):
    global _root
    _root = path


def _set_state(obj, state):
    """Put ``state`` (as ``load`` returns it) into ``obj``: through its
    ``set_state_dict`` (a Layer, an optimizer), or a torch module's
    ``load_state_dict`` with the arrays as tensors."""
    setter = getattr(obj, "set_state_dict", None)
    if setter is not None:
        setter(state)
    else:
        obj.load_state_dict({k: torch.as_tensor(v)
                             for k, v in state.items()})


class TrainEpochRange:
    """``for epoch in TrainEpochRange(n, name).get(): train(...)``.

    Register a model or optimizer with ``add()``; each completed epoch
    snapshots their state; on restart the iteration resumes after the
    last completed epoch with the states restored."""

    def __init__(self, max_epoch_num, name, checkpoint_inter=None,
                 save_checkpoint=True):
        self.max_epoch_num = max_epoch_num
        self.name = name
        self.save_checkpoint = save_checkpoint
        self._dir = os.path.join(_root, _job_id, name)
        os.makedirs(self._dir, exist_ok=True)
        self._saveables = {}
        self._meta_path = os.path.join(self._dir, "meta.json")
        self._start_epoch = 0
        if os.path.exists(self._meta_path):
            try:
                with open(self._meta_path) as f:
                    meta = json.load(f)
                self._start_epoch = meta.get("last_completed", -1) + 1
            except (OSError, ValueError):
                self._start_epoch = 0

    def add(self, name, obj):
        """Register anything with ``state_dict()`` and
        ``set_state_dict()`` (or a torch module's
        ``load_state_dict()``)."""
        self._saveables[name] = obj
        state_path = os.path.join(self._dir, f"{name}.pdparams")
        if self._start_epoch > 0 and os.path.exists(state_path):
            _set_state(obj, pload(state_path))
        return self

    @property
    def restored_from(self):
        return self._start_epoch

    def get(self):
        for epoch in range(self._start_epoch, self.max_epoch_num):
            yield epoch
            if self.save_checkpoint:
                self._snapshot(epoch)

    def _snapshot(self, epoch):
        for name, obj in self._saveables.items():
            psave(obj.state_dict(),
                  os.path.join(self._dir, f"{name}.pdparams"))
        with open(self._meta_path, "w") as f:
            json.dump({"last_completed": epoch, "ts": time.time()}, f)

    def clean(self):
        shutil.rmtree(self._dir, ignore_errors=True)
