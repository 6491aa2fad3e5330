"""The port's small modules and names against the reference's, on the
CPU: ``utils.unique_name`` (``tests/test_transforms.py:55``), ``compat``,
``sysconfig``, ``hub`` (``tests/test_compat_datasets.py:100``: the same
entry list from one ``hubconf.py``), ``utils.cpp_extension`` (a host op
built with ``g++``: the reference's ``test_cpp_host_extension`` case,
equal to the reference's output; a registered device op and its grad),
``utils`` and ``utils.download``, the top-level names of the reference
that the port had not bound (``batch``, ``check_shape``, ``rank``, the
dygraph toggles, ``set_printoptions``, the Places, the CUDA generator
state), and the names inside ported modules: ``fc_flatten``,
``softplus_``, the clip aliases, ``PyLayerMeta``, ``RecomputeFunction``,
the serving exports, ``device_memory_stats``. Values compare exactly
(the same computation in f32) unless a tolerance is stated.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import rng


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None


def test_unique_name_matches_reference():
    from paddle_tpu.utils import unique_name as ref_un
    from paddle_tpu_torch.utils import unique_name
    for un in (ref_un, unique_name):
        with un.guard():
            assert un.generate("w") == "w_0"
            assert un.generate("w") == "w_1"
            with un.guard():
                assert un.generate("w") == "w_0"
            assert un.generate("w") == "w_2"
            assert un.generate_with_ignorable_key("b") == "b_0"
            old = un.switch()
            assert un.generate("w") == "w_0"
            un.switch(old)
            assert un.generate("w") == "w_3"


def test_compat_matches_reference():
    from paddle_tpu import compat as ref_compat
    from paddle_tpu_torch import compat
    assert paddle.compat is compat
    cases = [("to_text", (b"ab",)), ("to_text", ([b"a", "b"],)),
             ("to_bytes", ("ab",)), ("to_bytes", ({"a"},)),
             ("round", (2.5,)), ("round", (-2.5,)), ("round", (1.25, 1)),
             ("round", (0.0,)), ("floor_division", (7, 2)),
             ("get_exception_message", (ValueError("x"),))]
    for fn, args in cases:
        assert getattr(compat, fn)(*args) == getattr(ref_compat, fn)(*args)
    lst = [b"x", b"y"]
    assert compat.to_text(lst, inplace=True) is lst and lst == ["x", "y"]
    assert compat.int_type is int and compat.long_type is int


def test_sysconfig_points_into_the_port():
    from paddle_tpu_torch import sysconfig
    pkg = os.path.dirname(os.path.abspath(paddle.__file__))
    assert paddle.sysconfig is sysconfig
    assert sysconfig.get_include() == os.path.join(pkg, "include")
    assert sysconfig.get_lib() == os.path.join(pkg, "_build")
    assert sysconfig.__all__ == ref.sysconfig.__all__


def test_hub_matches_reference(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "import math\n"
        "class Skipped:\n    pass\n"
        "def toy(width=2):\n"
        "    'docstring here'\n"
        "    return {'width': width}\n"
        "def other():\n    return 1\n")
    d = str(tmp_path)
    assert paddle.hub.list(d) == ref.hub.list(d) == ["other", "toy"]
    assert paddle.hub.help(d, "toy") == ref.hub.help(d, "toy")
    assert paddle.hub.load(d, "toy", width=5) == {"width": 5}
    models = paddle.hub.list("paddle_tpu_torch.vision.models")
    assert "resnet18" in models and "resnet50" in models
    assert set(models) == set(ref.hub.list("paddle_tpu.vision.models"))
    with pytest.raises(RuntimeError):
        paddle.hub.load("user/repo", "x", source="github")
    with pytest.raises(ValueError):
        paddle.hub.load(d, "missing")


HOST_OP = r"""
#include <cstdint>
extern "C" void scaled_sum(const float** ins, const int64_t* sizes,
                           int n_in, float* out, int64_t out_size) {
  for (int64_t i = 0; i < out_size; ++i) {
    float acc = 0;
    for (int j = 0; j < n_in; ++j) acc += ins[j][i];
    out[i] = acc * 2.0f;
  }
}
"""


def test_cpp_host_extension_matches_reference(tmp_path, monkeypatch):
    from paddle_tpu.utils import cpp_extension as ref_ext
    from paddle_tpu_torch.utils import cpp_extension
    src = tmp_path / "myop.cc"
    src.write_text(HOST_OP)
    monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(tmp_path / "build"))
    assert cpp_extension.get_build_directory() == str(tmp_path / "build")
    a = np.array([[1.0, 2.0], [5.5, -1.0]], np.float32)
    b = np.array([[3.0, 4.0], [0.25, 7.0]], np.float32)
    mod = cpp_extension.load("testext", [str(src)])
    out = mod.scaled_sum(paddle.to_tensor(a), paddle.to_tensor(b))
    assert out.shape == [2, 2]
    want = ref_ext.load("testext", [str(src)],
                        build_directory=str(tmp_path / "refbuild")
                        ).scaled_sum(ref.to_tensor(a), ref.to_tensor(b))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want.numpy()))
    np.testing.assert_array_equal(out.numpy(), (a + b) * 2)
    # built once for the sources' contents: a second load reuses it
    assert len(os.listdir(tmp_path / "build")) == 1
    cpp_extension.load("testext", [str(src)])
    assert len(os.listdir(tmp_path / "build")) == 1
    built = cpp_extension.setup(
        name="testext", ext_modules=cpp_extension.CppExtension([str(src)]))
    np.testing.assert_array_equal(
        built[0].scaled_sum(paddle.to_tensor(a)).numpy(), a * 2)
    with pytest.raises(RuntimeError, match="register_custom_op"):
        cpp_extension.CUDAExtension(sources=[str(src)])


def test_register_custom_device_op():
    from paddle_tpu_torch.utils.cpp_extension import register_custom_op
    op = register_custom_op("my_gelu_like_port", lambda x: x * torch.tanh(x))
    x = paddle.to_tensor(np.array([1.0, -1.0], np.float32),
                         stop_gradient=False)
    out = op(x)
    np.testing.assert_allclose(out.numpy(), [np.tanh(1), np.tanh(1)],
                               rtol=1e-6)
    out.sum().backward()
    assert x.grad is not None


def test_utils_and_download(tmp_path):
    from paddle_tpu_torch import utils
    from paddle_tpu_torch.utils import download
    assert utils.try_import("math").sqrt(4) == 2
    with pytest.raises(ImportError):
        utils.try_import("no_such_module_here")
    assert utils.deprecated(since="2.0")(len) is len
    utils.require_version("0.0.1")
    with pytest.raises(Exception):
        utils.require_version("999.0.0")
    f = tmp_path / "w.bin"
    f.write_bytes(b"weights" * 1000)
    from paddle_tpu.utils import download as ref_download
    assert download.md5file(str(f)) == ref_download.md5file(str(f))
    with pytest.raises(RuntimeError):
        download.get_weights_path_from_url("http://example.invalid/x.pd")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            utils.run_check()


def test_top_level_names():
    assert paddle.VarBase is paddle.Tensor
    assert paddle.dtype is type(paddle.float32)
    assert paddle.elementwise_mul is paddle.multiply
    x = paddle.to_tensor(np.array([[0.5, -1.0]], np.float32))
    assert paddle.tanh_(x) is x
    np.testing.assert_allclose(x.numpy(), np.tanh([[0.5, -1.0]]), rtol=1e-6)
    assert int(paddle.rank(x).numpy()) == int(ref.rank(ref.to_tensor(
        np.zeros((1, 2)))).numpy()) == 2
    assert int(paddle.rank(np.zeros((2, 3, 4))).numpy()) == 3
    paddle.check_shape([2, -1, 3])
    with pytest.raises(ValueError):
        paddle.check_shape([2, -2])

    def reader():
        return iter(range(7))
    assert list(paddle.batch(reader, 3)()) == \
        list(ref.batch(reader, 3)()) == [[0, 1, 2], [3, 4, 5], [6]]
    assert list(paddle.batch(reader, 3, drop_last=True)()) == \
        [[0, 1, 2], [3, 4, 5]]
    assert paddle.in_dygraph_mode() and paddle.is_grad_enabled_()
    paddle.disable_dygraph()
    try:
        assert not paddle.in_dygraph_mode()
    finally:
        paddle.enable_dygraph()
    assert paddle.in_dygraph_mode()
    with paddle.set_grad_enabled(False):
        assert not paddle.is_grad_enabled_()
    assert paddle.is_grad_enabled_()
    assert paddle.monkey_patch_math_varbase() is None
    assert paddle.monkey_patch_variable() is None
    old = np.get_printoptions()
    try:
        paddle.set_printoptions(precision=3, threshold=50)
        assert paddle._print_options["precision"] == 3
        assert np.get_printoptions()["precision"] == 3
    finally:
        np.set_printoptions(**old)
        paddle._print_options.update(precision=8, threshold=1000)
    for name in ("hub", "compat", "sysconfig"):
        assert getattr(paddle, name).__name__ == f"paddle_tpu_torch.{name}"


def test_places_name_the_card():
    """The reference's accelerator Places fall back to the CPU without an
    accelerator; the port's name the card and raise without one."""
    for cls in (paddle.TPUPlace, paddle.XPUPlace, paddle.NPUPlace,
                paddle.device.TPUPlace, paddle.device.XPUPlace):
        if torch.cuda.is_available():
            p = cls(0)
            assert p.is_gpu_place() and p.torch_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                cls()
    assert ref.TPUPlace().device_type == "cpu"


def test_rng_state_replays_draws():
    """``core.rng.get_state``/``set_state`` of the CPU default generator
    replay the same ``paddle.rand`` draws; the CUDA state functions
    raise without a card."""
    paddle.seed(11)
    state = rng.get_state("cpu")
    a = paddle.rand([5]).numpy()
    b = paddle.rand([5]).numpy()
    rng.set_state(state, "cpu")
    np.testing.assert_array_equal(paddle.rand([5]).numpy(), a)
    assert not np.array_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            paddle.get_cuda_rng_state()
        with pytest.raises(RuntimeError):
            paddle.set_cuda_rng_state([state])


def test_fc_flatten_and_softplus_():
    from paddle_tpu.ops import nn_ops as ref_nn
    from paddle_tpu_torch.ops import nn_ops
    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
    for k in (1, 2, 3):
        got, n = nn_ops.fc_flatten(paddle.to_tensor(x), k)
        want, m = ref_nn.fc_flatten(ref.to_tensor(x), k)
        assert n == m and got.shape == list(want.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    with pytest.raises(ValueError):
        nn_ops.fc_flatten(paddle.to_tensor(x), 4)
    v = np.linspace(-30, 30, 13).astype(np.float32)
    np.testing.assert_allclose(
        nn_ops.softplus_(paddle.to_tensor(v)).numpy(),
        np.asarray(ref_nn.softplus_(ref.to_tensor(v)).numpy()),
        rtol=1e-6, atol=1e-7)


def test_clip_base_and_aliases():
    from paddle_tpu_torch import nn
    assert nn.clip.GradientClipByValue is nn.ClipGradByValue
    assert nn.clip.GradientClipByNorm is nn.ClipGradByNorm
    assert nn.clip.GradientClipByGlobalNorm is nn.ClipGradByGlobalNorm
    for cls in (nn.ClipGradByValue, nn.ClipGradByNorm,
                nn.ClipGradByGlobalNorm):
        assert issubclass(cls, nn.clip.ClipGradBase)
    with pytest.raises(NotImplementedError):
        nn.clip.ClipGradBase()([])


def test_pylayer_meta():
    from paddle_tpu_torch.autograd import PyLayerMeta

    class Layer(metaclass=PyLayerMeta):
        pass
    with pytest.raises(RuntimeError, match="apply"):
        Layer()


def test_recompute_function_matches_direct_grads():
    """``RecomputeFunction`` (a PyLayer) gives the direct run's output
    and grads, and with dropout inside replays the forward's mask."""
    from paddle_tpu_torch.distributed.utils_recompute import \
        RecomputeFunction
    from paddle_tpu_torch.nn import functional as F
    w = np.random.RandomState(2).randn(6, 6).astype(np.float32)
    xv = np.random.RandomState(3).randn(4, 6).astype(np.float32)

    def block(x, wt):
        return F.dropout(paddle.tanh(paddle.matmul(x, wt)), p=0.3)

    outs, grads = [], []
    for rec in (False, True):
        paddle.seed(5)
        x = paddle.to_tensor(xv, stop_gradient=False)
        wt = paddle.to_tensor(w, stop_gradient=False)
        y = RecomputeFunction.apply(block, True, x, wt) if rec \
            else block(x, wt)
        (y * y).sum().backward()
        outs.append(y.numpy())
        grads.append((x.grad.numpy(), wt.grad.numpy()))
    np.testing.assert_array_equal(outs[1], outs[0])
    for a, b in zip(grads[1], grads[0]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_serving_exports_and_memory_stats():
    from paddle_tpu import serving as ref_serving
    from paddle_tpu_torch import observability, serving
    names = ["ChunkPlan", "FIFOPolicy", "NGramDrafter", "PagedKVPool",
             "RadixPrefixIndex", "Request", "SLOFeedbackPolicy",
             "SchedulingPolicy", "ServingMetrics", "SlotSampler",
             "SpecDecoder", "plan_chunks"]
    for n in names:
        assert hasattr(ref_serving, n) and n in serving.__all__
        assert getattr(serving, n).__name__ == n
    stats = observability.device_memory_stats("cpu")
    assert stats is None
    if torch.cuda.is_available():
        stats = observability.device_memory_stats()
        assert set(stats) == {"bytes_in_use", "bytes_limit",
                              "peak_bytes_in_use", "bytes_free"}
    else:
        assert observability.device_memory_stats() is None
