"""The slice's pieces that need the card: the CUDA generator state round
trip, a ``cpp_extension`` host op on CUDA tensors, ASP's masks computed
on the card, the accelerator Places, ``device_memory_stats`` and the
``softmax_mask_fuse`` ops in bf16. Marked ``cuda``: without a CUDA
device every test skips. The file imports no JAX; on the card run it
without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_incubate_cuda.py

Masks and host-op outputs compare exactly with their numpy versions;
the bf16 softmaxes within 1e-2 of the f32 composition (an output
rounded to bf16 is within half an ulp, 4e-3 of a value below 1).
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.incubate import asp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    paddle.set_device("gpu")
    yield torch.device("cuda", torch.cuda.current_device())
    device_mod._current_place = None


def test_cuda_rng_state_replays_draws(dev):
    paddle.seed(3)
    state = paddle.get_cuda_rng_state()
    assert len(state) == torch.cuda.device_count()
    a = paddle.rand([1000]).numpy()
    b = paddle.rand([1000]).numpy()
    paddle.set_cuda_rng_state(state)
    np.testing.assert_array_equal(paddle.rand([1000]).numpy(), a)
    np.testing.assert_array_equal(paddle.rand([1000]).numpy(), b)


def test_host_op_on_cuda_tensors(dev, tmp_path, monkeypatch):
    from paddle_tpu_torch.utils import cpp_extension
    src = tmp_path / "myop.cc"
    src.write_text(r"""
#include <cstdint>
extern "C" void scaled_sum(const float** ins, const int64_t* sizes,
                           int n_in, float* out, int64_t out_size) {
  for (int64_t i = 0; i < out_size; ++i) {
    float acc = 0;
    for (int j = 0; j < n_in; ++j) acc += ins[j][i];
    out[i] = acc * 2.0f;
  }
}
""")
    monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(tmp_path / "build"))
    mod = cpp_extension.load("cudaext", [str(src)])
    a = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    b = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    out = mod.scaled_sum(paddle.to_tensor(a), paddle.to_tensor(b))
    assert out._value.device == dev
    np.testing.assert_array_equal(out.numpy(), (a + b) * 2)


@pytest.mark.parametrize("case", ["random", "ties", "ragged"])
def test_masks_on_the_card_equal_numpy(dev, case):
    rs = np.random.RandomState(2)
    mat = {"random": rs.randn(256, 512).astype(np.float32),
           "ties": rs.randint(-2, 3, (64, 48)).astype(np.float32),
           "ragged": rs.randn(32, 30).astype(np.float32)}[case]
    got = asp.get_mask_1d(torch.from_numpy(mat).to(dev), 2, 4)
    assert got.device == dev and got.dtype == torch.bool
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  asp.get_mask_1d_plain(mat, 2, 4) > 0)
    masked = torch.from_numpy(mat).to(dev) * got
    assert asp.check_mask_1d(masked, 2, 4)
    assert asp.check_mask_1d(masked, 2, 4) == \
        asp.check_mask_1d_plain(masked.cpu().numpy(), 2, 4)
    rows = torch.tensor(list(itertools.product(range(4), repeat=4)),
                        dtype=torch.float32, device=dev)
    np.testing.assert_array_equal(
        asp.get_mask_1d(rows, 2, 4).cpu().numpy(),
        asp.get_mask_1d_plain(rows.cpu().numpy(), 2, 4) > 0)


def test_places_and_memory_stats(dev):
    for cls in (paddle.TPUPlace, paddle.XPUPlace, paddle.NPUPlace):
        assert cls(0).torch_device() == torch.device("cuda", 0)
    from paddle_tpu_torch import observability
    stats = observability.device_memory_stats()
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(
        dev).total_memory
    assert stats["bytes_free"] == stats["bytes_limit"] - stats[
        "bytes_in_use"]
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"] >= 0


def test_softmax_mask_fuse_bf16(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, 4, 128, 128, generator=g, device=dev) * 3
    mask = torch.where(torch.rand(2, 1, 128, 128, generator=g, device=dev)
                       < 0.3, -1e4, 0.0)
    xb = x.to(torch.bfloat16)
    got = paddle.incubate.softmax_mask_fuse(
        paddle.Tensor(xb), paddle.Tensor(mask))._value
    want = torch.softmax(xb.float() + mask.to(torch.bfloat16).float(), -1)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() <= 1e-2
    got = paddle.incubate.softmax_mask_fuse_upper_triangle(
        paddle.Tensor(xb))._value
    causal = torch.ones(128, 128, dtype=torch.bool, device=dev).tril()
    want = torch.softmax(torch.where(causal, xb.float(), -1e9), -1)
    assert (got.float() - want).abs().max().item() <= 1e-2
