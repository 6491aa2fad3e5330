"""The fluid slice and the exported torch GPT on the card (skipped
without one): the exported program's attention node launches K1 and
never the plain composition or SDPA, one CUDA graph a batch size in the
Predictor with the eager model's bits; the custom operator raises on an
operand K1 does not take; a fluid ``While`` under ``Executor.run`` is one
graph whose trip count follows the feed; ``fluid.layers.fc`` made inside
the lazy executor's segments keeps one layer, whose segments capture
and replay (``lazy.forms_since`` says which forms ran; none node by
node).

Run on the card without tests/conftest.py (it imports JAX):
``python -m pytest --noconftest -m cuda tests/test_torch_fluid_cuda.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
import paddle_tpu_torch.inference  # noqa: F401
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.ops import attention as attn
from paddle_tpu_torch.text.models import GPTForCausalLM, TransformerLMConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    yield
    device_mod._current_place = None


def _gpt():
    cfg = TransformerLMConfig(vocab_size=512, hidden_size=128, num_layers=2,
                              num_heads=2, max_seq_len=64, dropout=0.0,
                              tie_embeddings=False)
    return GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(3),
                          device="cuda").eval()


def test_exported_gpt_predictor_launches_k1(dev, tmp_path, monkeypatch):
    m = _gpt()
    path = str(tmp_path / "gpt")
    paddle.fluid.io.save_inference_model(
        path, model=m, input_spec=[paddle.static.InputSpec([None, 64],
                                                           "int64")])
    plain = []
    monkeypatch.setattr(attn, "flash_attention_plain",
                        lambda *a, **k: plain.append(1))
    sdpa = []
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        lambda *a, **k: sdpa.append(1))
    pred = paddle.inference.create_predictor(paddle.inference.Config(path))
    for b in (1, 3):
        ids = np.random.RandomState(b).randint(0, 512, (b, 64))
        with torch.no_grad():
            want = m(torch.from_numpy(ids).cuda()).cpu().numpy()
        for _ in range(5):
            attn.flash_attention_forward.launches = 0
            got, = pred.run([ids])
            assert attn.flash_attention_forward.launches == 2
            np.testing.assert_array_equal(got, want)
    assert len(pred.layer.graphs()) == 2
    assert not plain and not sdpa


def test_flash_operator_raises_on_what_k1_cannot_take(dev):
    q = torch.randn(1, 2, 8, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        torch.ops.paddle_tpu_torch.flash_attention_forward(q, q, q, 0.1,
                                                           True)
    q = torch.randn(1, 2, 8, 64, device="cuda")
    before = attn.flash_attention_forward.launches
    o, lse = torch.ops.paddle_tpu_torch.flash_attention_forward(
        q, q, q, 0.125, True)
    assert attn.flash_attention_forward.launches == before + 1
    ro, rl = attn.flash_attention_plain(q, q, q, 0.125, True)
    torch.testing.assert_close(o, ro, rtol=0, atol=1e-5)


def test_while_is_one_graph_following_the_feed(dev):
    L = paddle.fluid.layers
    paddle.enable_static()
    try:
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            n = paddle.static.data("n", [1], "int64")
            i = L.fill_constant([1], "int64", 0)
            s = L.fill_constant([1], "float32", 0.0)
            cond = L.less_than(i, n)
            w = L.While(cond)
            with w.block():
                L.assign(s + 2.0, output=s)
                i = L.increment(i, in_place=True)
                L.less_than(i, n, cond=cond)
    finally:
        paddle.disable_static()
    exe = paddle.fluid.Executor(paddle.fluid.CUDAPlace(0))
    for bound in (3, 7, 2, 9, 5):
        res, = exe.run(main, feed={"n": np.array([bound], np.int64)},
                       fetch_list=[s])
        np.testing.assert_allclose(res, [2.0 * bound])
    fns = list(exe._cache.values())
    assert len(fns) == 1 and len(fns[0].graphs()) == 1


def test_fluid_fc_in_lazy_segments_on_the_card(dev):
    L = paddle.fluid.layers
    L.clear_layer_cache()
    x = paddle.to_tensor(np.random.RandomState(1).randn(8, 16)
                         .astype("float32"))
    lbl = paddle.to_tensor(np.zeros((8, 4), "float32"))
    before = lazy.flushes[0]
    opt, losses = None, []
    for _ in range(6):
        loss = ((L.fc(x, 4) - lbl) ** 2).mean()
        loss.backward()
        if opt is None:
            layer, = L._layer_cache.values()
            opt = paddle.optimizer.SGD(0.1, parameters=layer.parameters())
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    forms = lazy.forms_since(before)
    assert len(L._layer_cache) == 1
    assert losses[-1] < losses[0]
    # the layer's parameters are persistable, bound by address, so no
    # fresh leaf disqualifies a segment: the step that made the layer is
    # its own key's warm-up, then the loop's key warms, records,
    # captures and replays (on an H100: warmup x3, record, capture,
    # replay x2), and nothing runs node by node
    assert "eager" not in forms, forms
    assert forms[-3:] == ["capture", "replay", "replay"], forms
