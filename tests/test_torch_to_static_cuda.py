"""paddle_tpu_torch's ``jit.to_static`` on the card (chip_smoke.py phase
24's rules at small sizes): a captured forward and backward of a
2-layer GPT through the flash kernels K1-K3 gives the eager run's loss
and grads bit for bit, with the launches counted captured x replays; an
``LRScheduler`` stepped between replays gives the eager trajectory;
dropout draws new masks on every replay; a host read inside the step
raises ``ToStaticError``; dy2static's Tensor ``if`` and ``while`` captured
as CUDA conditional nodes (one graph, the branch and the trip count
following the data on every replay, an untaken branch that would index
out of range never run; a hand-written kernel inside a branch or a loop
body counted once for each time that body ran; an optimizer's first
state in a branch the record call did not take refused; a Tensor ``cond``
in a capture that ``to_static`` did not start refused); a static program
through ``Executor.run``, captured, against the same program on the CPU.
Marked ``cuda``: without a CUDA device every test skips. On a machine with a card and no JAX, run them without the
suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_to_static_cuda.py

f32 with TF32 off: every comparison is exact (the same kernels on the
same operands).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.jit import ToStaticError, to_static

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    yield torch.device("cuda")
    device_mod._current_place = None


def test_captured_flash_step_is_eager_bits(dev):
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              TransformerLMConfig)
    cfg = TransformerLMConfig(vocab_size=512, hidden_size=128, num_layers=2,
                              num_heads=2, max_seq_len=128, dropout=0.0,
                              use_flash_attention=True)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 128)).astype(np.int64)).cuda()
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)
    runs = []
    for captured in (False, True):
        model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
            1)).train()
        opt = paddle.optimizer.AdamW(1e-3,
                                     parameters=model.named_parameters())

        def fwd_bwd(ids, model=model):
            loss = model(ids, labels=ids)
            loss.backward()
            return loss
        fn = to_static(fwd_bwd) if captured else fwd_bwd
        for w in wrappers:
            w.launches = 0
        losses, grads = [], []
        for _ in range(5):
            loss = fn(ids)
            grads.append([p.grad.clone() for p in model.parameters()])
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        runs.append((losses, grads, [w.launches for w in wrappers]))
    (el, eg, ec), (cl, cg, cc) = runs
    assert el == cl
    assert all(torch.equal(a, b) for ga, gb in zip(eg, cg)
               for a, b in zip(ga, gb))
    assert ec == cc == [10, 10, 10]


def test_lr_schedule_across_replays(dev):
    runs = []
    for captured in (False, True):
        paddle.seed(3)
        lin = paddle.nn.Linear(16, 16)
        sched = paddle.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
        opt = paddle.optimizer.SGD(sched, parameters=lin.parameters())
        x = paddle.to_tensor(np.ones((4, 16), "float32"))

        def step(x):
            loss = (lin(x) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        fn = to_static(step) if captured else step
        out = []
        for _ in range(6):
            out.append(float(fn(x).numpy()))
            sched.step()
        runs.append((out, lin.weight.numpy()))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_dropout_masks_differ_across_replays(dev):
    paddle.seed(11)
    f = to_static(lambda x: paddle.nn.functional.dropout(x, p=0.5,
                                                         training=True))
    x = paddle.ones([4096])
    masks = [f(x).numpy() for _ in range(6)]
    for i in range(6):
        for j in range(i):
            assert not np.array_equal(masks[i], masks[j])


def test_host_read_inside_capture_raises(dev):
    f = to_static(lambda x: x * float((x * 2).sum()), warmup=0)
    x = paddle.ones([8])
    f(x)                        # record, eager
    with pytest.raises(ToStaticError, match="host read"):
        f(x)
    assert float((x + 1).sum()) == 16.0


def test_tensor_if_captured_once_both_branches(dev):
    @to_static
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y

    outs = [f(paddle.to_tensor(np.full(4, v, np.float32))).numpy()
            for v in (1.0, -1.0, 1.0, -1.0, 2.0, -3.0)]
    np.testing.assert_array_equal(outs[4], np.full(4, 4.0))
    np.testing.assert_array_equal(outs[5], np.full(4, -4.0))
    (g,) = f.graphs()
    assert g.replays == 4


def test_untaken_branch_out_of_range_never_runs(dev):
    @to_static
    def f(x, idx):
        if idx < 4:
            out = paddle.gather(x, idx)
        else:
            out = x[:1] * 0.0 - 7.0
        return out

    x = paddle.to_tensor(np.arange(4, dtype=np.float32) + 1)
    got = [float(f(x, paddle.to_tensor(np.array([i], np.int64))).numpy()[0])
           for i in (0, 9, 2, 11, 3, 100)]
    assert got == [1.0, -7.0, 3.0, -7.0, 4.0, -7.0]
    assert len(f.graphs()) == 1
    assert float((x + 1).sum()) == 14.0


def test_tensor_while_trip_count_changes_across_replays(dev):
    @to_static
    def f(x, n):
        s = x * 0.0
        i = paddle.zeros([], dtype="int64")
        while i < n:
            s = s + x
            i = i + 1
        return s

    x = paddle.to_tensor(np.arange(3, dtype=np.float32))
    for k in (3, 0, 7, 1, 5, 2):
        got = f(x, paddle.to_tensor(np.int64(k))).numpy()
        np.testing.assert_array_equal(got, np.arange(3) * k)
    (g,) = f.graphs()
    assert g.replays == 4


def test_executor_captures_a_program(dev):
    runs = []
    for place in ("cpu", "gpu"):
        paddle.set_device(place)
        paddle.enable_static()
        try:
            main = paddle.static.Program()
            with paddle.static.program_guard(main):
                x = paddle.static.data("x", [16, 8], "float32")
                y = paddle.static.data("y", [16, 1], "float32")
                loss = paddle.mean(paddle.square(
                    paddle.static.nn.fc(x, 1, name="fc") - y))
                paddle.optimizer.SGD(0.05).minimize(loss)
            for k, t in enumerate(main.persist.values()):
                t.set_value(np.random.RandomState(k).randn(
                    *t.shape).astype(np.float32) * 0.1)
            exe = paddle.static.Executor()
            rs = np.random.RandomState(0)
            xb = rs.randn(16, 8).astype(np.float32)
            yb = rs.randn(16, 1).astype(np.float32)
            runs.append([float(exe.run(main, feed={"x": xb, "y": yb},
                                       fetch_list=[loss])[0])
                         for _ in range(6)])
        finally:
            paddle.disable_static()
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)
    (fn,) = exe._cache.values()
    assert len(fn.graphs()) == 1 and fn.graphs()[0].replays == 4


def test_optimizer_state_in_branch_untaken_at_record_refused(dev):
    lin = paddle.nn.Linear(4, 4)
    opt = paddle.optimizer.Adam(1e-3, parameters=lin.parameters())

    @to_static
    def f(x, pred):
        loss = lin(x).mean()
        loss.backward()
        return paddle.static.nn.cond(
            pred, lambda: (opt.step(), loss * 1.0)[1], lambda: loss * 2.0)

    x = paddle.to_tensor(np.ones((2, 4), np.float32))
    no = paddle.to_tensor(np.array(False))
    f(x, no)
    with pytest.raises(ToStaticError, match="did not take"):
        f(x, no)
    assert not any(opt._accumulators.values())
    assert not f.graphs()
    assert float((x + 1).sum()) == 16.0


def test_tensor_cond_in_a_foreign_capture_raises(dev):
    x = torch.ones(4, device=dev)
    pred = torch.tensor(False, device=dev)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(ToStaticError, match="did not start"):
        with torch.cuda.graph(graph):
            y = x * 3.0
            paddle.static.nn.cond(pred, lambda: y[100], lambda: y - 1.0)
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 8.0


def test_kernel_in_branch_and_body_counted_when_it_runs(dev):
    from paddle_tpu_torch.ops import attention as attn
    q = torch.randn(1, 2, 128, 64, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    ref = attn.flash_attention_forward(q, q, q, 0.125, True)[0]

    @to_static
    def branch(q, pred):
        return paddle.static.nn.cond(
            pred, lambda: attn.flash_attention_forward(q, q, q, 0.125,
                                                       True)[0],
            lambda: q * 1.0)

    @to_static
    def loop(q, n):
        def body(i, acc):
            return [i + 1,
                    acc + attn.flash_attention_forward(q, q, q, 0.125,
                                                       True)[0]]
        i0 = torch.zeros((), dtype=torch.int64, device=q.device)
        return paddle.static.nn.while_loop(lambda i, acc: i < n, body,
                                           [i0, q * 0.0])[1]

    attn.flash_attention_forward.launches = 0
    preds = (True, False, True, True, False, False, True)
    for p in preds:
        out = branch(q, torch.tensor(p, device=dev))
        assert torch.equal(out.value, ref if p else q)
    assert attn.flash_attention_forward.launches == sum(preds)
    (g,) = branch.graphs()
    assert g.launches[0] == 0 and g.cond_launches is not None

    attn.flash_attention_forward.launches = 0
    trips = (2, 0, 3, 1, 0, 4)
    for n in trips:
        out = loop(q, torch.tensor(n, device=dev))
        torch.testing.assert_close(out.value, ref * n, rtol=1e-6,
                                   atol=1e-6)
    assert attn.flash_attention_forward.launches == sum(trips)
    (g,) = loop.graphs()
    assert g.replays == 4
