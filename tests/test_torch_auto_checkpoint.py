"""``incubate.checkpoint.auto_checkpoint`` of the port on the CPU.

* The reference's scenario (``tests/test_aux_systems.py:89-100``) on the
  port and the reference side by side: an epoch range stopped in epoch 2
  resumes after its last snapshot with the Linear's weights restored,
  in both packages alike.
* Resume across processes: a child process trains the port's tiny GPT
  (AdamW, one step an epoch) through 2 of 3 epochs of a
  ``TrainEpochRange`` and exits; a second child, under the same
  ``PADDLE_JOB_ID`` and ``PADDLE_CHECKPOINT_DIR``, starts at epoch 2 with
  the model's and the optimizer's state and finishes. Its final loss and
  weights equal, bit for bit, those of an uninterrupted child's run (the
  same f32 CPU arithmetic in the same order).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu.incubate.checkpoint import auto_checkpoint as ref_ac
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as ac

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys
import numpy as np
import torch
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as ac
from paddle_tpu_torch.text.models import GPTForCausalLM, TransformerLMConfig

stop_at = int(sys.argv[1])
torch.set_num_threads(1)
cfg = TransformerLMConfig(vocab_size=97, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=64, dropout=0.0)
model = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0)).train()
opt = optimizer.AdamW(1e-2, parameters=model.named_parameters(),
                      weight_decay=0.01)
r = ac.TrainEpochRange(3, "gpt")
r.add("model", model).add("opt", opt)
out = {"start": r.restored_from, "epochs": []}
for epoch in r.get():
    if epoch == stop_at:
        break
    ids = torch.from_numpy(np.random.RandomState(epoch).randint(
        0, 97, (2, 16)).astype(np.int64))
    loss = model(ids, labels=ids)
    loss.backward()
    opt.step()
    opt.clear_grad()
    out["epochs"].append(epoch)
    out["loss"] = float(loss.detach())
out["weights"] = {k: v.detach().numpy().tolist()
                  for k, v in model.state_dict().items()}
print(json.dumps(out))
"""


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None


def test_resume_skips_completed_epochs_like_reference(tmp_path):
    seen, weights, resumed = {}, {}, {}
    for P, mod in ((ref, ref_ac), (paddle, ac)):
        mod.set_checkpoint_dir(str(tmp_path / P.__name__))
        net = P.nn.Linear(2, 2)
        r = mod.TrainEpochRange(5, "job_a")
        r.add("model", net)
        seen[P] = []
        for epoch in r.get():
            seen[P].append(epoch)
            net.weight.set_value(np.full((2, 2), epoch, np.float32))
            if epoch == 2:
                break   # a crash after epochs 0 and 1 completed
        net2 = P.nn.Linear(2, 2)
        r2 = mod.TrainEpochRange(5, "job_a")
        r2.add("model", net2)
        resumed[P] = list(r2.get())
        weights[P] = np.asarray(net2.weight.numpy())
    assert seen[paddle] == seen[ref] == [0, 1, 2]
    assert resumed[paddle] == resumed[ref] == [2, 3, 4]
    np.testing.assert_array_equal(weights[paddle], weights[ref])
    assert weights[paddle][0, 0] == 1.0


def _child(stop_at, ckpt, job):
    env = dict(os.environ, PADDLE_JOB_ID=job, PADDLE_CHECKPOINT_DIR=ckpt,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    res = subprocess.run([sys.executable, "-c", CHILD, str(stop_at)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_resume_in_a_new_process_equals_an_uninterrupted_run(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _child(2, ckpt, "job_resume")
    assert first["start"] == 0 and first["epochs"] == [0, 1]
    second = _child(-1, ckpt, "job_resume")
    assert second["start"] == 2 and second["epochs"] == [2]
    whole = _child(-1, str(tmp_path / "other"), "job_whole")
    assert whole["start"] == 0 and whole["epochs"] == [0, 1, 2]
    assert second["loss"] == whole["loss"]
    for name, w in whole["weights"].items():
        np.testing.assert_array_equal(np.asarray(second["weights"][name]),
                                      np.asarray(w), err_msg=name)
    # a finished range resumes past its end: nothing left to run
    assert _child(-1, ckpt, "job_resume")["epochs"] == []
