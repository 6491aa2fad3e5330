"""The lazy eager executor on the card (chip_smoke.py phase 27's rules at
small sizes): a plain eager training loop of the surface GPT of
``test_torch_paddle_lm.py`` at 2 layers (hidden 256, 4 heads, 2 x 128,
f32, AdamW + ClipGradByGlobalNorm) lazily against immediately: every
loss and weight bit for bit, K1 = K2 = K3 = 2 a step (captured x
replays), one replay-cache entry and the flush forms warm-up, record,
capture, then a replay every step; dropout masks new at every replay and
the immediate masks of the seed; a ``float(loss)`` before
``backward()`` replayed node by node and counted; a write through a
view; an index write after a deferred read in every flush form; a
``set_value`` between steps and a StepDecay stepped between
replays giving immediate's weights; the GradScaler's skipped inf step;
``paddle.grad(create_graph=True)`` at once; a fresh optimizer (over the
same or a fresh model) starting at a warm-up; captures after a
``lazy.clear()`` or in a new ``to_static`` function on the thread's one
stream, leaving no new allocation; a capture that fails raises
``ToStaticError``; ``_C_ops`` on the card; a Profiler's chrome trace
with the kernels and ``optimizer/step``.
Marked ``cuda``: without a CUDA device every test skips. On a machine
with a card and no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_lazy_cuda.py

f32 with TF32 off: every comparison is exact (the same kernels on the
same operands).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

LAYERS, HIDDEN, HEADS, SEQ, BATCH, VOCAB = 2, 256, 4, 128, 2, 512
STEPS = 6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    lazy.clear()
    yield
    lazy.flush()
    lazy.clear()
    paddle.set_flags({"FLAGS_lazy_eager": True})
    device_mod._current_place = None


def _lm():
    nn, F = paddle.nn, paddle.nn.functional

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(HIDDEN)
            self.qkv = nn.Linear(HIDDEN, 3 * HIDDEN)
            self.out = nn.Linear(HIDDEN, HIDDEN)
            self.ln2 = nn.LayerNorm(HIDDEN)
            self.fc1 = nn.Linear(HIDDEN, 4 * HIDDEN)
            self.fc2 = nn.Linear(4 * HIDDEN, HIDDEN)

        def forward(self, x):
            b, s, h = x.shape
            qkv = paddle.reshape(self.qkv(self.ln1(x)),
                                 [b, s, 3, HEADS, h // HEADS])
            q, k, v = paddle.unbind(paddle.transpose(qkv, [2, 0, 3, 1, 4]))
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + self.out(paddle.reshape(
                paddle.transpose(o, [0, 2, 1, 3]), [b, s, h]))
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x)),
                                       approximate=True))

    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(VOCAB, HIDDEN)
            self.pos = nn.Embedding(SEQ, HIDDEN)
            self.blocks = nn.LayerList([Block() for _ in range(LAYERS)])
            self.head = nn.Linear(HIDDEN, VOCAB, bias_attr=False)

        def forward(self, ids):
            x = self.emb(ids) + self.pos(paddle.arange(0, ids.shape[1],
                                                       dtype="int64"))
            for blk in self.blocks:
                x = blk(x)
            logits = self.head(x)
            return F.cross_entropy(paddle.reshape(logits, [-1, VOCAB]),
                                   paddle.reshape(ids, [-1]))

    return LM()


def _train(flag, state, steps=STEPS):
    paddle.set_flags({"FLAGS_lazy_eager": flag})
    try:
        model = _lm()
        assert model.set_state_dict(state) == []
        opt = paddle.optimizer.AdamW(
            1e-3, parameters=model.parameters(), weight_decay=0.01,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        ids = paddle.to_tensor(np.random.RandomState(1).randint(
            0, VOCAB, (BATCH, SEQ)).astype(np.int64))
        losses, forms, counts = [], [], []
        wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                    attn.flash_bwd_dkv)
        for _ in range(steps):
            for w in wrappers:
                w.launches = 0
            seen = lazy.flushes[0]
            loss = model(ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            forms.append(lazy.forms_since(seen))
            counts.append(tuple(w.launches for w in wrappers))
        weights = {n: p.value.detach().clone()
                   for n, p in model.named_parameters()}
        return losses, weights, forms, counts
    finally:
        paddle.set_flags({"FLAGS_lazy_eager": True})


def _state():
    paddle.seed(0)
    return {k: v.numpy() for k, v in _lm().state_dict().items()}


def test_plain_loop_is_immediates_bits_as_one_graph(dev):
    state = _state()
    got, w_lazy, forms, counts = _train(True, state)
    want, w_imm, _, imm_counts = _train(False, state)
    assert got == want
    for n in w_imm:
        assert torch.equal(w_lazy[n], w_imm[n]), n
    assert forms == [["warmup"], ["record"], ["capture"]] \
        + [["replay"]] * (STEPS - 3)
    assert counts == [(LAYERS,) * 3] * STEPS == imm_counts
    assert len(lazy._replay_cache) == 1
    assert lazy.pool_bytes() > 0


def _mlp(state=None):
    nn = paddle.nn
    net = nn.Sequential(nn.Linear(64, 128), nn.ReLU(), nn.Linear(128, 8))
    if state is not None:
        assert net.set_state_dict(state) == []
    return net


def _both(fn):
    out = {}
    for flag in (True, False):
        paddle.set_flags({"FLAGS_lazy_eager": flag})
        try:
            out[flag] = fn()
        finally:
            paddle.set_flags({"FLAGS_lazy_eager": True})
    return out[True], out[False]


def test_dropout_masks_follow_the_seed(dev):
    state = {k: v.numpy() for k, v in _mlp().state_dict().items()}
    x_np = np.random.RandomState(2).randn(16, 64).astype(np.float32)

    def masks():
        net = _mlp(state)
        opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
        x = paddle.to_tensor(x_np)
        paddle.seed(5)
        out = []
        for _ in range(STEPS):
            h = paddle.nn.functional.dropout(paddle.ones([16, 8]), 0.5)
            (net(x) * h).sum().backward()
            opt.step()
            opt.clear_grad()
            out.append(h.value != 0)
        return out

    seen = lazy.flushes[0]
    got, want = _both(masks)
    assert "replay" in lazy.forms_since(seen)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(not torch.equal(got[i], got[i + 1])
               for i in range(STEPS - 1))


def test_float_before_backward_runs_node_by_node(dev):
    state = {k: v.numpy() for k, v in _mlp().state_dict().items()}
    x_np = np.random.RandomState(3).randn(16, 64).astype(np.float32)

    def run():
        net = _mlp(state)
        opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
        x = paddle.to_tensor(x_np)
        out = []
        for _ in range(4):
            loss = net(x).square().mean()
            out.append(float(loss))
            loss.backward()
            opt.step()
            opt.clear_grad()
        return out

    before = lazy.stats["eager"]
    got, want = _both(run)
    assert got == want and lazy.stats["eager"] - before == 8


def test_writes_between_steps_and_schedulers(dev):
    state = {k: v.numpy() for k, v in _mlp().state_dict().items()}
    x_np = np.random.RandomState(4).randn(16, 64).astype(np.float32)

    def run():
        net = _mlp(state)
        sched = paddle.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        opt = paddle.optimizer.Momentum(sched, parameters=net.parameters())
        x = paddle.to_tensor(x_np)
        for i in range(STEPS):
            net(x).square().mean().backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            if i == 3:
                net[2].bias.set_value(np.full(8, 0.25, np.float32))
        return {k: v.numpy() for k, v in net.state_dict().items()}

    got, want = _both(run)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_views_scaler_and_create_graph(dev):
    base = paddle.zeros([4, 8])
    view = base.reshape([32])
    view[5] = 7.0
    assert base.numpy()[0, 5] == 7.0
    net = _mlp()
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=8.0)
    w0 = net[0].weight.numpy().copy()
    big = paddle.to_tensor(np.full((2, 64), 3e38, np.float32))
    scaler.scale((net(big) * 1e30).sum()).backward()
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    np.testing.assert_array_equal(net[0].weight.numpy(), w0)
    assert float(scaler._scale) < 8.0
    x = paddle.to_tensor(np.asarray([3.0], np.float32), stop_gradient=False)
    (g,) = paddle.grad(x * x * x, x, create_graph=True)
    assert not lazy.pending() and float(g) == 27.0


def test_setitem_after_a_deferred_read(dev):
    """An index write runs the pending graph first, in every flush form
    (warm-up, record, capture, replay): the reads deferred before it keep
    the value before the write."""
    def run():
        x = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
        out = []
        for i in range(STEPS):
            y = x * 2.0
            x[i % 3] = float(-i)
            out.append((y.numpy(), x.numpy()))
        return out

    start = lazy.flushes[0]
    got, want = _both(run)
    assert {"warmup", "record", "capture", "replay"} <= set(
        lazy.forms_since(start))
    for (gy, gx), (wy, wx) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx, wx)


def test_captures_keep_the_threads_stream(dev):
    """Every capture of a thread runs on its one capture stream: a
    ``lazy.clear()`` or a new ``to_static`` function carves no new cuBLAS
    workspace, so what stays allocated after each round is flat."""
    import gc
    from paddle_tpu_torch.core import trace
    net = _mlp()
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
    x = paddle.to_tensor(np.ones((16, 64), np.float32))

    def lazy_steps():
        for _ in range(4):
            net(x).square().mean().backward()
            opt.step()
            opt.clear_grad()
        lazy.flush()

    def static_steps():
        def train(t):
            loss = net(t).square().mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        step = paddle.jit.to_static(train)
        for _ in range(3):
            step(x)
        assert step._shared["stream"] is trace.capture_stream()

    def settled():
        torch.cuda.synchronize()
        lazy.clear()
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated()

    lazy_steps()
    static_steps()
    base = settled()
    for _ in range(3):
        lazy_steps()
        static_steps()
        assert settled() - base < 2 ** 20
    assert trace.capture_stream() is trace.capture_stream()


def test_a_new_optimizer_steps_anew(dev):
    """A freed optimizer's id() and addresses go to the next one: two
    AdamW steps (warm-up, record), then a fresh AdamW over the same
    parameters, then a fresh model and AdamW after replays. Each fresh
    optimizer's steps start at a warm-up (its state is made eagerly, not
    inside a capture), and the losses and weights are immediate's."""
    import gc
    state = _state()
    ids = paddle.to_tensor(np.random.RandomState(1).randint(
        0, VOCAB, (BATCH, SEQ)).astype(np.int64))

    def run(flag):
        paddle.set_flags({"FLAGS_lazy_eager": flag})
        try:
            losses, forms = [], []
            model = None
            for new_model, steps in ((True, 2), (False, 4), (True, 4)):
                if new_model:
                    model = _lm()
                    assert model.set_state_dict(state) == []
                opt = paddle.optimizer.AdamW(
                    1e-3, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
                run_forms = []
                for _ in range(steps):
                    seen = lazy.flushes[0]
                    loss = model(ids)
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                    losses.append(float(loss))
                    run_forms += lazy.forms_since(seen)
                forms.append(run_forms)
                del opt, loss
                gc.collect()
            weights = {n: p.value.detach().clone()
                       for n, p in model.named_parameters()}
            return losses, weights, forms
        finally:
            paddle.set_flags({"FLAGS_lazy_eager": True})

    got, w_lazy, forms = run(True)
    want, w_imm, _ = run(False)
    assert got == want
    for n in w_imm:
        assert torch.equal(w_lazy[n], w_imm[n]), n
    assert forms == [["warmup", "record"],
                     ["warmup", "record", "capture", "replay"],
                     ["warmup", "record", "capture", "replay"]]


def test_a_failed_capture_raises(dev):
    """A qualifying segment whose capture fails raises with its cause
    (here a host copy inside a deferred write of the graph); nothing
    runs eagerly in its place."""
    from paddle_tpu_torch.core.trace import ToStaticError
    acc = paddle.zeros([4])

    def bump(t):
        return t + torch.tensor([1.0, 2.0, 3.0, 4.0]).to(t.device)

    from paddle_tpu_torch.core.dispatch import _REGISTRY, register_op
    op = _REGISTRY.get("test_lazy_host_copy") or register_op(
        "test_lazy_host_copy")(bump)
    with pytest.raises(ToStaticError):
        for _ in range(3):
            acc.set_value(op(acc))
            lazy.flush()


def test_c_ops_and_the_profiler(dev, tmp_path):
    from paddle_tpu_torch import _C_ops, profiler
    a = paddle.randn([32, 64])
    b = paddle.randn([48, 64])
    mm = _C_ops.matmul_v2(a, b, "trans_x", False, "trans_y", True)
    assert mm.value.is_cuda and torch.equal(
        mm.value, paddle.matmul(a, b, transpose_y=True).value)
    state = _state()
    model = _lm()
    assert model.set_state_dict(state) == []
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    ids = paddle.to_tensor(np.random.RandomState(1).randint(
        0, VOCAB, (BATCH, SEQ)).astype(np.int64))
    prof = profiler.Profiler(
        scheduler=profiler.make_scheduler(closed=1, ready=0, record=3,
                                          repeat=1),
        on_trace_ready=profiler.export_chrome_tracing(str(tmp_path), "w"))
    prof.start()
    for _ in range(5):
        model(ids).backward()
        opt.step()
        opt.clear_grad()
        prof.step()
    prof.stop()
    with open(prof.traces[0]) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert "optimizer/step" in names
    assert any("flash_fwd_f32_kernel" in n for n in names)
