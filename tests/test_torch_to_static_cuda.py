"""paddle_tpu_torch's ``jit.to_static`` on the card (chip_smoke.py phase
24's rules at small sizes): a captured forward and backward of a
2-layer GPT through the flash kernels K1-K3 gives the eager run's loss
and grads bit for bit, with the launches counted captured x replays; an
``LRScheduler`` stepped between replays gives the eager trajectory;
dropout draws new masks on every replay; a host read inside the step
raises ``ToStaticError``. Marked ``cuda``: without a CUDA device every
test skips. On a machine with a card and no JAX, run them without the
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
