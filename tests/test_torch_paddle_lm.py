"""The whole slice on the CPU: one GPT language model written once
against a package argument ``P`` in the Paddle surface (``P.nn.Layer``,
``P.nn.Embedding``, ``P.nn.LayerList``, ``P.nn.LayerNorm``,
``P.nn.Linear``, ``P.arange``, ``P.reshape``, ``P.transpose``,
``P.unbind``, ``P.add``, ``P.nn.functional.scaled_dot_product_attention``,
``gelu(approximate=True)`` and ``cross_entropy``), the structure of the
reference's ``paddle_tpu/text/models.py:58-215``, instantiated with
``paddle_tpu`` and with ``paddle_tpu_torch`` at 2 layers, hidden 64, 4
heads of 16, vocab 97, batch 2 x seq 16.

The same numpy weights go into both through ``set_state_dict``; the
loss matches at rtol 1e-5 and each grad within 1e-4 of its parameter's
largest grad; over 3 AdamW steps (with the global-norm clip) every loss
at rtol 1e-5 and each parameter's move within chip_smoke.py phase 12's
L2 rule at 1e-3. The reference's own ``GPTForCausalLM(tie_embeddings=False)``
takes the same weights under the same names and gives the same loss:
the card's phase 20 model is the reference's model.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig
from paddle_tpu_torch.core import device as device_mod

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
MOVE_TOL = 1e-3   # phase 12's L2 rule, at its tighter tolerance
VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 97, 64, 2, 4, 16, 2


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def paddle_lm(P):
    """The LM a user writes in the Paddle surface of package ``P``."""
    nn, F = P.nn, P.nn.functional

    class SelfAttention(nn.Layer):
        def __init__(self, hidden, heads):
            super().__init__()
            self.num_heads, self.head_dim = heads, hidden // heads
            self.qkv = nn.Linear(hidden, 3 * hidden)
            self.out = nn.Linear(hidden, hidden)

        def forward(self, x):
            b, s, h = x.shape
            qkv = P.reshape(self.qkv(x), [b, s, 3, self.num_heads,
                                          self.head_dim])
            q, k, v = P.unbind(P.transpose(qkv, [2, 0, 3, 1, 4]), axis=0)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            o = P.reshape(P.transpose(o, [0, 2, 1, 3]), [b, s, h])
            return self.out(o)

    class MLP(nn.Layer):
        def __init__(self, hidden):
            super().__init__()
            self.fc1 = nn.Linear(hidden, 4 * hidden)
            self.fc2 = nn.Linear(4 * hidden, hidden)

        def forward(self, x):
            return self.fc2(F.gelu(self.fc1(x), approximate=True))

    class Block(nn.Layer):
        def __init__(self, hidden, heads):
            super().__init__()
            self.ln1 = nn.LayerNorm(hidden)
            self.attn = SelfAttention(hidden, heads)
            self.ln2 = nn.LayerNorm(hidden)
            self.mlp = MLP(hidden)

        def forward(self, x):
            x = P.add(x, self.attn(self.ln1(x)))
            return P.add(x, self.mlp(self.ln2(x)))

    class GPTModel(nn.Layer):
        def __init__(self, vocab, hidden, layers, heads, max_seq):
            super().__init__()
            self.word_embeddings = nn.Embedding(vocab, hidden)
            self.position_embeddings = nn.Embedding(max_seq, hidden)
            self.blocks = nn.LayerList([Block(hidden, heads)
                                        for _ in range(layers)])
            self.ln_f = nn.LayerNorm(hidden)

        def forward(self, ids):
            pos = P.arange(0, ids.shape[1], dtype="int64")
            x = P.add(self.word_embeddings(ids), self.position_embeddings(pos))
            for blk in self.blocks:
                x = blk(x)
            return self.ln_f(x)

    class LM(nn.Layer):
        def __init__(self, vocab, hidden, layers, heads, max_seq):
            super().__init__()
            self.vocab = vocab
            self.gpt = GPTModel(vocab, hidden, layers, heads, max_seq)
            self.lm_head = nn.Linear(hidden, vocab, bias_attr=False)

        def forward(self, ids, labels):
            logits = self.lm_head(self.gpt(ids))
            return F.cross_entropy(P.reshape(logits, [-1, self.vocab]),
                                   P.reshape(labels, [-1]))

    return LM(VOCAB, HIDDEN, LAYERS, HEADS, SEQ)


def _weights(model):
    """Seeded numpy weights for every parameter: matrices N(0, 0.05),
    biases and LayerNorm parameters around their defaults."""
    rs = np.random.RandomState(42)
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) == 2:
            out[name] = (rs.randn(*shape) * 0.05).astype(np.float32)
        elif "ln" in name and name.endswith("weight"):
            out[name] = (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
        else:
            out[name] = (0.02 * rs.randn(*shape)).astype(np.float32)
    return out


def _data():
    rs = np.random.RandomState(7)
    ids = rs.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return ids, labels


def _models():
    rm, pm = paddle_lm(ref), paddle_lm(paddle)
    assert list(rm.state_dict()) == list(pm.state_dict())
    w = _weights(rm)
    assert rm.set_state_dict(w) == [] and pm.set_state_dict(w) == []
    return rm, pm, w


def _grads(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _close_grads(got, want):
    assert list(got) == list(want)
    for n in want:
        top = np.abs(want[n]).max()
        err = np.abs(got[n] - want[n]).max()
        assert err <= GRAD_TOL * max(top, 1e-30), (n, err, top)


def test_forward_and_grads_match_the_reference():
    rm, pm, _ = _models()
    ids, labels = _data()
    losses = []
    for P, m in ((ref, rm), (paddle, pm)):
        loss = m(P.to_tensor(ids), P.to_tensor(labels))
        assert loss.shape == []
        loss.backward()
        losses.append(float(loss))
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL)
    _close_grads(_grads(pm), _grads(rm))


def test_three_adamw_steps_match_the_reference():
    rm, pm, _ = _models()
    ids, labels = _data()
    runs = []
    for P, m in ((ref, rm), (paddle, pm)):
        opt = P.optimizer.AdamW(1e-3, parameters=m.parameters(),
                                weight_decay=0.01,
                                grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
        losses = []
        for _ in range(3):
            loss = m(P.to_tensor(ids), P.to_tensor(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        runs.append((losses, {n: p.numpy()
                              for n, p in m.named_parameters()}))
    (rl, rp), (pl, pp) = runs
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    assert pl[-1] < pl[0]
    # each parameter's move within chip_smoke.py phase 12's rule: Adam
    # divides a grad by its own size, so an element whose grad is near 0
    # takes a step of full size on either side; the L2 norm of the
    # difference is held to a share of the move, every element to twice
    # the largest move, and the key third of each QKV bias (true grad 0,
    # all noise) to that alone (ROADMAP.md queue 3)
    w = _weights(rm)
    largest = max(np.abs(rp[n] - w[n]).max() for n in rp)
    worst = 0.0
    for n in rp:
        got, want, init = pp[n].ravel(), rp[n].ravel(), w[n].ravel()
        assert np.abs(got - want).max() <= 2 * largest, n
        if n.endswith("attn.qkv.bias"):
            keep = np.ones(got.size, bool)
            keep[HIDDEN:2 * HIDDEN] = False
            got, want, init = got[keep], want[keep], init[keep]
        move = np.linalg.norm(want - init)
        worst = max(worst, np.linalg.norm(got - want) / move)
    assert worst <= MOVE_TOL, worst


def test_the_references_gpt_takes_the_same_weights():
    """GPTForCausalLM(tie_embeddings=False) of the reference has the
    same structured names and, on the same weights, the same loss as
    the LM written in the Paddle surface of either package."""
    _, pm, w = _models()
    cfg = TransformerLMConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                              num_layers=LAYERS, num_heads=HEADS,
                              max_seq_len=SEQ, dropout=0.0,
                              tie_embeddings=False)
    gpt = GPTForCausalLM(cfg)
    assert list(gpt.state_dict()) == list(w)
    assert gpt.set_state_dict(w) == []
    ids, labels = _data()
    want = float(gpt(ref.to_tensor(ids), labels=ref.to_tensor(labels)))
    got = float(pm(paddle.to_tensor(ids), paddle.to_tensor(labels)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_the_surface_reaches_the_cores_attention_op():
    """The LM's q, k, v are views of the fused QKV (transpose, then
    unbind), non-contiguous, and go through the core's flash_attention
    op, whose body makes them contiguous before K1 (its plain version
    on the CPU). Under lazy eager the op's body runs when the step's
    graph does (the flush below), besides once on meta tensors for its
    output shapes, which the spy leaves out."""
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.ops import attention
    seen = []
    orig = attention.scaled_dot_product_attention

    def spy(q, k, v, *a, **kw):
        if isinstance(q, torch.Tensor) and q.device.type != "meta":
            seen.append((q.is_contiguous(), k.is_contiguous()))
        return orig(q, k, v, *a, **kw)

    attention.scaled_dot_product_attention = spy
    try:
        _, pm, _ = _models()
        ids, labels = _data()
        qkv = paddle.reshape(paddle.randn([BATCH, SEQ, 3 * HIDDEN]),
                             [BATCH, SEQ, 3, HEADS, HIDDEN // HEADS])
        q, _, _ = paddle.unbind(paddle.transpose(qkv, [2, 0, 3, 1, 4]))
        assert not q.value.is_contiguous()
        pm(paddle.to_tensor(ids), paddle.to_tensor(labels)).backward()
        lazy.flush()
    finally:
        attention.scaled_dot_product_attention = orig
    assert seen == [(True, True)] * LAYERS
