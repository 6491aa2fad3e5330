"""The port's profiler (``paddle_tpu_torch/profiler``) on the CPU: the
reference's ``tests/test_profiler.py`` cases with a chrome trace
(``torch.profiler``) where the reference writes an XPlane capture, and
``record_scope``'s three sinks.

* A ``Profiler`` started and stopped around steps writes a non-empty
  chrome trace under ``log_dir`` and summarises the steps.
* A ``RecordEvent`` / ``record_scope`` range reaches the trace by name
  (the counterpart of the reference's named scope in the lowered XLA).
* A scheduler's record window writes a trace and calls
  ``on_trace_ready``; ``step_info`` honours its unit; the legacy
  ``profiler()`` context writes a trace; ``timer_only`` writes nothing;
  ``export_chrome_tracing`` sends the trace to its directory.
* ``record_scope`` feeds the host-span ring, the registry's seconds and
  calls by name (as the reference's, whose counters it is held to),
  and a sink; ``optimizer/step`` and hapi's batch scopes move them.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import profiler as prof_mod
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.observability import registry, tracing


@pytest.fixture(autouse=True)
def _on_the_cpu():
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None


def _traces(log_dir):
    return glob.glob(os.path.join(log_dir, "*.pt.trace.json"))


def _names(path):
    with open(path) as fh:
        return {e.get("name") for e in json.load(fh)["traceEvents"]}


def _calls(name):
    fam = registry.default_registry().counter(
        "host_span_calls_total", labelnames=("span",))
    return fam.labels(name).value


def test_profiler_produces_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    p = prof_mod.Profiler(log_dir=log_dir)
    p.start()
    x = paddle.to_tensor(np.random.randn(64, 64).astype("float32"))
    for _ in range(3):
        y = paddle.matmul(x, x)
        p.step()
    float(y.numpy().sum())
    p.stop()
    files = _traces(log_dir)
    assert files == p.traces and os.path.getsize(files[0]) > 0
    assert "aten::mm" in _names(files[0])
    assert "avg step" in p.step_info()


def test_record_event_scopes_reach_the_trace(tmp_path):
    p = prof_mod.Profiler(log_dir=str(tmp_path / "scopes"))
    p.start()
    with prof_mod.RecordEvent("my_hot_block"):
        (paddle.to_tensor(np.ones(4, np.float32)).sin() * 2.0).numpy()
    with prof_mod.record_scope("my_scope"):
        torch.ones(3).cos()
    p.stop()
    names = _names(p.traces[0])
    assert {"my_hot_block", "my_scope"} <= names


def test_profiler_scheduler_windows(tmp_path):
    log_dir = str(tmp_path / "sched")
    traces = []
    p = prof_mod.Profiler(
        log_dir=log_dir,
        scheduler=prof_mod.make_scheduler(closed=1, ready=0, record=2,
                                          repeat=1),
        on_trace_ready=lambda prof: traces.append(prof._step_num))
    p.start()
    x = paddle.to_tensor(np.ones((8, 8), np.float32))
    for _ in range(5):
        x = x + 1.0
        p.step()
    p.stop()
    assert traces == [3]
    assert len(_traces(log_dir)) == 1


def test_scheduler_states():
    sched = prof_mod.make_scheduler(closed=1, ready=1, record=2, repeat=2,
                                    skip_first=1)
    S = prof_mod.ProfilerState
    assert [sched(i) for i in range(10)] == [
        S.CLOSED, S.CLOSED, S.READY, S.RECORD, S.RECORD_AND_RETURN,
        S.CLOSED, S.READY, S.RECORD, S.RECORD_AND_RETURN, S.CLOSED]


def test_step_info_honors_unit():
    p = prof_mod.Profiler(timer_only=True)
    p._step_times = [0.25, 0.5]
    ms = p.step_info(unit="ms")
    s = p.step_info(unit="s")
    assert "avg step 500.000 ms" in ms and ms == p.step_info()
    assert "avg step 0.500 s" in s
    assert "min 0.500 s" in s and "max 0.500 s" in s
    with pytest.raises(ValueError):
        p.step_info(unit="fortnights")
    assert prof_mod.Profiler(timer_only=True).step_info(unit="s") \
        == "no steps recorded"


def test_legacy_fluid_profiler_context(tmp_path):
    log_dir = str(tmp_path / "legacy")
    with prof_mod.profiler(profile_path=log_dir):
        x = paddle.to_tensor(np.ones((4, 4), np.float32))
        (x * 2).numpy()
    assert _traces(log_dir)


def test_timer_only_mode_writes_nothing(tmp_path):
    log_dir = str(tmp_path / "timeronly")
    p = prof_mod.Profiler(log_dir=log_dir, timer_only=True)
    p.start()
    p.step()
    p.stop()
    assert not os.path.exists(log_dir)


def test_export_chrome_tracing_redirects_capture(tmp_path):
    target = str(tmp_path / "chrome_out")
    p = prof_mod.Profiler(
        log_dir=str(tmp_path / "ignored"),
        on_trace_ready=prof_mod.export_chrome_tracing(target, "w0"))
    p.start()
    x = paddle.to_tensor(np.ones((4, 4), np.float32))
    (x + 1).numpy()
    p.stop()
    assert [os.path.basename(f) for f in _traces(target)] \
        == ["w0.0.pt.trace.json"]
    assert not os.path.exists(str(tmp_path / "ignored"))


def test_record_scope_feeds_its_sinks():
    seen = []
    before = _calls("test/scope")
    with prof_mod.record_scope("test/scope",
                               sink=lambda n, dt: seen.append((n, dt))):
        pass
    assert _calls("test/scope") == before + 1
    assert seen and seen[0][0] == "test/scope" and seen[0][1] >= 0
    assert tracing.default_recorder().spans()[-1].name == "test/scope"


def test_optimizer_and_hapi_scopes():
    net = paddle.nn.Linear(4, 2)
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
    before = _calls("optimizer/step")
    net(paddle.to_tensor(np.ones((2, 4), np.float32))).sum().backward()
    opt.step()
    opt.clear_grad()
    assert _calls("optimizer/step") == before + 1
    model = paddle.Model(paddle.nn.Linear(4, 2))
    model.prepare(paddle.optimizer.SGD(
        0.1, parameters=model.network.parameters()),
        paddle.nn.MSELoss())
    b_train, b_eval = _calls("hapi/train_batch"), _calls("hapi/eval_batch")
    x = np.ones((2, 4), np.float32)
    y = np.zeros((2, 2), np.float32)
    model.train_batch([x], [y])
    model.eval_batch([x], [y])
    assert _calls("hapi/train_batch") == b_train + 1
    assert _calls("hapi/eval_batch") == b_eval + 1
