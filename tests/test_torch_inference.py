"""paddle_tpu_torch's ``inference`` against the JAX package's on the CPU:
every case of ``tests/test_extension_inference.py`` but its custom-op
ones (they need ``utils/cpp_extension.py``, not ported yet), each model
saved by both packages from the same weights and served by both
packages' Predictors on the same inputs (outputs within 1e-5: f32 sums
in another order).

The Config knobs are the port's: ``enable_use_gpu`` selects the card
and does not warn; ``enable_tensorrt_engine`` and
``switch_ir_optim(False)`` warn once each, naming what runs instead (the
program replayed as a CUDA graph with the port's kernels; quantization
for int8). Also: ``DataType`` and its byte sizes, ``PrecisionType``,
``PlaceType``, ``get_version``, ``run()``'s two call styles and
``memory_optim``, ``PredictorPool`` under 4 threads, and
``create_serving_engine`` on a tiny GPT against the reference's engine
(token for token) with the knob the port refuses.
"""
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.inference as rinf
import paddle_tpu_torch as paddle
import paddle_tpu_torch.inference as pinf
from paddle_tpu_torch.core import device as device_mod
from test_torch_jit_save_load import carry

PACKAGES = ((ref, rinf), (paddle, pinf))


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _saved(tmp_path, build, spec, seed=0):
    """``build(P)`` in both packages (the reference's weights carried),
    each saved with jit.save; returns {P: (layer, path)}."""
    ref.seed(seed)
    r = build(ref)
    p = build(paddle)
    carry(r, p)
    out = {}
    for P, layer in ((ref, r), (paddle, p)):
        layer.eval()
        path = str(tmp_path / f"m_{P.__name__}")
        P.jit.save(layer, path, input_spec=[P.static.InputSpec(*spec)])
        out[P] = (layer, path)
    return out


def test_inference_predictor_api(tmp_path):
    saved = _saved(tmp_path, lambda P: P.nn.Sequential(P.nn.Linear(4, 3),
                                                       P.nn.Softmax()),
                   ([1, 4], "float32"))
    x = np.random.RandomState(0).randn(1, 4).astype("float32")
    results = []
    for P, inf in PACKAGES:
        layer, path = saved[P]
        predictor = inf.create_predictor(inf.Config(path + ".pdmodel"))
        names = predictor.get_input_names()
        assert names == ["x0"]
        predictor.get_input_handle(names[0]).copy_from_cpu(x)
        assert predictor.run()
        out_name = predictor.get_output_names()[0]
        assert out_name == "out0"
        result = predictor.get_output_handle(out_name).copy_to_cpu()
        np.testing.assert_allclose(result, layer(P.to_tensor(x)).numpy(),
                                   atol=1e-5)
        assert result.sum() == pytest.approx(1.0, rel=1e-4)
        results.append(result)
    np.testing.assert_allclose(results[1], results[0], rtol=1e-5, atol=1e-6)


def test_run_call_styles_and_memory_optim(tmp_path):
    saved = _saved(tmp_path, lambda P: P.nn.Sequential(P.nn.Linear(4, 2)),
                   ([None, 4], "float32"))
    layer, path = saved[paddle]
    xs = [np.random.RandomState(i).randn(b, 4).astype("float32")
          for i, b in enumerate((1, 3))]
    cfg = pinf.Config(path + ".pdmodel")
    pred = pinf.create_predictor(cfg)
    rpred = rinf.create_predictor(rinf.Config(saved[ref][1] + ".pdmodel"))
    for x in xs:
        got, = pred.run([x])                    # direct style
        np.testing.assert_allclose(got, layer(paddle.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, rpred.run([x])[0], rtol=1e-5,
                                   atol=1e-6)
    h = pred.get_input_handle("x0")
    h.reshape([2, 4])
    h.share_external_data(xs[1][:2])
    assert pred.run() is True                   # handle style
    first = pred.get_output_handle("out0").copy_to_cpu()
    assert pred.run() is True                   # inputs stay staged
    np.testing.assert_array_equal(
        pred.get_output_handle("out0").copy_to_cpu(), first)
    # memory_optim (default on) drops the previous outputs at the next run
    before = pred._outputs
    pred.run()
    assert pred._outputs is not before
    cfg2 = pinf.Config(path + ".pdmodel")
    cfg2.enable_memory_optim(False)
    assert pinf.create_predictor(cfg2)._memory_optim is False


def test_config_knobs_warn_once_naming_what_runs():
    """enable_use_gpu does what it says (the card, no warning); the knobs
    that do nothing warn once each, naming what runs instead."""
    pinf._warned_knobs.clear()
    cfg = pinf.Config()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg.enable_use_gpu(100, 0)
        cfg.enable_use_gpu(100, 0)
        cfg.enable_tensorrt_engine(max_batch_size=4)
        cfg.enable_tensorrt_engine(max_batch_size=4)
        cfg.switch_ir_optim(True)   # the supported direction: no warning
        cfg.switch_ir_optim(False)
        cfg.switch_ir_optim(False)
        cfg.disable_glog_info()
    msgs = [str(x.message) for x in w]
    assert len(msgs) == 2, msgs
    assert sum("enable_use_gpu" in m for m in msgs) == 0
    trt, = [m for m in msgs if "enable_tensorrt_engine" in m]
    ir, = [m for m in msgs if "switch_ir_optim" in m]
    for m in (trt, ir):
        assert "CUDA graph" in m and "kernels" in m
    assert "quantization" in trt and "int8" in trt
    assert cfg._device == torch.device("cuda", 0)


def test_predictor_pool_concurrent(tmp_path):
    """PredictorPool: 4 predictors over one config (one copy of the
    parameters) serve from 4 threads with their staged inputs kept
    apart, in both packages."""
    saved = _saved(tmp_path, lambda P: P.nn.Sequential(P.nn.Linear(4, 3)),
                   ([1, 4], "float32"))
    xs = [np.random.RandomState(10 + i).randn(1, 4).astype("float32")
          for i in range(4)]
    results = {}
    for P, inf in PACKAGES:
        layer, path = saved[P]
        pool = inf.PredictorPool(inf.Config(path + ".pdmodel"), size=4)
        want = [layer(P.to_tensor(x)).numpy() for x in xs]
        got = [None] * 4
        errs = []

        def serve(i):
            try:
                pred = pool.retrieve(i)
                name = pred.get_input_names()[0]
                for _ in range(5):  # repeat to give interleaving a chance
                    pred.get_input_handle(name).copy_from_cpu(xs[i])
                    assert pred.run()
                    out = pred.get_output_handle(
                        pred.get_output_names()[0]).copy_to_cpu()
                got[i] = out
            except Exception as e:  # noqa: BLE001
                errs.append((i, e))

        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(4)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        assert not errs, errs
        for i in range(4):
            np.testing.assert_allclose(got[i], want[i], atol=1e-5)
        assert pool.retrive(0) is pool.retrieve(0)
        results[P] = got
        if P is paddle:
            shared = [pool.retrieve(i).layer.state_dict()["0.weight"]
                      for i in range(4)]
            assert all(s is shared[0] for s in shared)
    for a, b in zip(results[paddle], results[ref]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_data_types_precisions_places_and_version():
    for name in ("FLOAT32", "INT64", "INT32", "UINT8", "INT8", "FLOAT16",
                 "BFLOAT16"):
        code = getattr(pinf.DataType, name)
        assert code == getattr(rinf.DataType, name)
        assert pinf.get_num_bytes_of_data_type(code) == \
            rinf.get_num_bytes_of_data_type(code)
    assert pinf.get_num_bytes_of_data_type(pinf.DataType.INT64) == 8
    for cls in ("PrecisionType", "PlaceType"):
        a, b = getattr(pinf, cls), getattr(rinf, cls)
        keys = [k for k in vars(b) if not k.startswith("_")]
        assert keys and all(getattr(a, k) == getattr(b, k) for k in keys)
    assert paddle.__version__ in pinf.get_version()
    assert paddle.__version__ == ref.__version__
    assert paddle.version.full_version == ref.version.full_version
    assert (paddle.version.major, paddle.version.minor, paddle.version.patch,
            paddle.version.rc, paddle.version.istaged) == \
        (ref.version.major, ref.version.minor, ref.version.patch,
         ref.version.rc, ref.version.istaged)
    assert paddle.version.commit != ref.version.commit


def test_create_serving_engine_on_a_tiny_gpt():
    """create_serving_engine builds the port's ServingEngine with the
    reference's knobs; greedy streams token for token against the
    reference's engine on the same weights. donate_buffers, which the
    port's ServingConfig does not take, raises as it does there."""
    from _torch_port import jax_gpt, torch_twin
    jm = jax_gpt()
    tm = torch_twin(jm)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 97, (n,)).astype(np.int64) for n in (5, 9, 3)]
    streams = []
    for inf, model, extra in ((rinf, jm, {}), (pinf, tm, {"device": "cpu"})):
        eng = inf.create_serving_engine(model, num_slots=2, paged=False,
                                        bucket_min=8, **extra)
        reqs = [eng.add_request(p, max_new_tokens=5) for p in prompts]
        eng.run()
        streams.append([list(r.output_ids) for r in reqs])
    assert streams[1] == streams[0]
    with pytest.raises(TypeError, match="donate_buffers"):
        pinf.create_serving_engine(tm, device="cpu", donate_buffers=True)


def test_capture_lock_under_many_threads():
    """The lock a predictor holds on the card: many threads, a short
    switch interval; an exclusive holder is never beside another holder,
    and every thread finishes."""
    import sys
    from paddle_tpu_torch.jit.save_load import _SharedExclusiveLock
    lock = _SharedExclusiveLock()
    state = {"shared": 0, "exclusive": 0, "bad": 0, "done": 0}
    guard = threading.Lock()

    def worker(i):
        for k in range(200):
            exclusive = (i + k) % 7 == 0
            with (lock.exclusive() if exclusive else lock.shared()):
                with guard:
                    key = "exclusive" if exclusive else "shared"
                    state[key] += 1
                    if state["exclusive"] > 1 or (
                            state["exclusive"] and state["shared"]):
                        state["bad"] += 1
                with guard:
                    state[key] -= 1
        with guard:
            state["done"] += 1

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        [t.start() for t in threads]
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert state["done"] == 16 and state["bad"] == 0
