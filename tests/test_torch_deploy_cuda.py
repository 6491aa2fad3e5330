"""The deployment path on the card (skipped without one): a Predictor on
CUDA launches K1 and never the plain attention, replaying one graph for
each batch size, with the eager model's bits; ``Int8Linear`` on CUDA
runs ``torch._int_mm`` and raises on an operand it cannot take; a
``PredictorPool``'s threads capture and replay with their own batches.
``surface_gpt`` (the reference's GPT written in a package's Paddle
surface) is here, in a file without JAX, for the CPU tests to import.

Run on the card without tests/conftest.py (it imports JAX):
``python -m pytest --noconftest -m cuda tests/test_torch_deploy_cuda.py``.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import inference, quantization
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.ops import attention as attn

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


def surface_gpt(P, cfg):
    """The reference's ``paddle_tpu/text/models.py`` GPT (``SelfAttention``
    :58 to ``GPTForCausalLM`` :288: fused QKV, pre-norm blocks, tanh
    GELU, the head tied to the word embedding unless
    ``cfg.tie_embeddings`` is False) written in package ``P``'s Paddle
    surface, under the same structured names. ``forward(ids,
    labels=None)`` returns the logits, or with labels the mean
    cross-entropy."""
    nn, F = P.nn, P.nn.functional
    h, nh = cfg.hidden_size, cfg.num_heads

    class SelfAttention(nn.Layer):
        def __init__(self):
            super().__init__()
            self.qkv = nn.Linear(h, 3 * h)
            self.out = nn.Linear(h, h)

        def forward(self, x):
            b, s, _ = x.shape
            qkv = P.reshape(self.qkv(x), [b, s, 3, nh, h // nh])
            q, k, v = P.unbind(P.transpose(qkv, [2, 0, 3, 1, 4]), axis=0)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return self.out(P.reshape(P.transpose(o, [0, 2, 1, 3]),
                                      [b, s, h]))

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(h, cfg.intermediate_size)
            self.fc2 = nn.Linear(cfg.intermediate_size, h)

        def forward(self, x):
            return self.fc2(F.gelu(self.fc1(x), approximate=True))

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(h)
            self.attn = SelfAttention()
            self.ln2 = nn.LayerNorm(h)
            self.mlp = MLP()

        def forward(self, x):
            x = P.add(x, self.attn(self.ln1(x)))
            return P.add(x, self.mlp(self.ln2(x)))

    class GPTModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
            self.position_embeddings = nn.Embedding(cfg.max_seq_len, h)
            self.blocks = nn.LayerList([Block()
                                        for _ in range(cfg.num_layers)])
            self.ln_f = nn.LayerNorm(h)

        def forward(self, ids):
            pos = P.arange(0, ids.shape[1], dtype="int64")
            x = P.add(self.word_embeddings(ids),
                      self.position_embeddings(pos))
            for blk in self.blocks:
                x = blk(x)
            return self.ln_f(x)

    class GPTForCausalLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.gpt = GPTModel()
            if not cfg.tie_embeddings:
                self.lm_head = nn.Linear(h, cfg.vocab_size, bias_attr=False)

        def forward(self, ids, labels=None):
            x = self.gpt(ids)
            if cfg.tie_embeddings:
                logits = P.matmul(x, self.gpt.word_embeddings.weight,
                                  transpose_y=True)
            else:
                logits = self.lm_head(x)
            if labels is None:
                return logits
            return F.cross_entropy(P.reshape(logits, [-1, cfg.vocab_size]),
                                   P.reshape(labels, [-1]))

    return GPTForCausalLM()


class _Cfg:
    vocab_size, hidden_size, num_layers, num_heads = 96, 128, 2, 2
    max_seq_len, intermediate_size, tie_embeddings = 64, 512, False


def _gpt():
    paddle.seed(0)
    return surface_gpt(paddle, _Cfg).eval()


def _ids(b, seed):
    return np.random.RandomState(seed).randint(0, 96, (b, 64)).astype(
        np.int64)


def test_predictor_launches_k1_never_the_plain_attention(dev, tmp_path,
                                                         monkeypatch):
    model = _gpt()
    path = str(tmp_path / "gpt")
    paddle.jit.save(model, path, input_spec=[paddle.static.InputSpec(
        [None, 64], "int64")])
    want = {b: model(paddle.to_tensor(_ids(b, b))).numpy() for b in (1, 3)}

    def refuse(*a, **k):
        raise AssertionError("the plain attention ran on the card")
    monkeypatch.setattr(attn, "flash_attention_plain", refuse)
    monkeypatch.setattr(attn, "reference_attention", refuse)
    pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
    for b in (1, 3):
        for _ in range(5):     # eager, recorded, captured, 2 replays
            attn.flash_attention_forward.launches = 0
            got, = pred.run([_ids(b, b)])
            assert attn.flash_attention_forward.launches == 2
            np.testing.assert_array_equal(got, want[b])
    assert len(pred.layer.graphs()) == 2
    assert pred.layer.pool_bytes() > 0


def test_int8_linear_runs_int_mm_and_refuses_what_it_cannot_take(
        dev, monkeypatch):
    paddle.seed(1)
    lin = paddle.nn.Linear(64, 32)
    q = quantization.Int8Linear(lin)
    assert q.w_q.value.is_cuda and q.w_q.value.dtype == torch.int8
    calls = []
    real = torch._int_mm

    def counted(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)
    monkeypatch.setattr(torch, "_int_mm", counted)
    x = paddle.to_tensor(np.random.RandomState(1).randn(2, 16, 64)
                         .astype("float32"))
    out = q(x).numpy()
    assert calls == [((32, 64), (64, 32))]
    # the same op's plain product on the CPU (exact int32 sums)
    want = quantization._int8_linear_op.fn(
        x.value.cpu(), q.w_q.value.cpu(), q.w_scale.value.cpu(),
        lin.bias.value.detach().cpu()).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="more than 16 rows"):
        q(paddle.to_tensor(np.ones((2, 4, 64), "float32")))
    odd = quantization.Int8Linear(paddle.nn.Linear(60, 32))
    with pytest.raises(ValueError, match="multiples of 8"):
        odd(paddle.to_tensor(np.ones((32, 60), "float32")))


def test_predictor_pool_threads_on_the_card(dev, tmp_path):
    model = _gpt()
    path = str(tmp_path / "gpt")
    paddle.jit.save(model, path, input_spec=[paddle.static.InputSpec(
        [None, 64], "int64")])
    pool = inference.PredictorPool(inference.Config(path + ".pdmodel"),
                                   size=4)
    xs = [_ids(1 + i % 2, 10 + i) for i in range(4)]
    want = [model(paddle.to_tensor(x)).numpy() for x in xs]
    got, errs = [None] * 4, []

    def serve(i):
        try:
            p = pool.retrieve(i)
            for _ in range(6):
                got[i], = p.run([xs[i]])
                np.testing.assert_array_equal(got[i], want[i])
        except Exception as e:  # noqa: BLE001
            errs.append((i, repr(e)))
    threads = [threading.Thread(target=serve, args=(i,)) for i in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert not errs, errs
    assert all(len(pool.retrieve(i).layer.graphs()) == 1 for i in range(4))
