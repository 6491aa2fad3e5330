"""AMP, loss scaling and dropout in paddle_tpu_torch against the JAX
reference on the CPU.

- ``auto_cast``: the cast rule of every listed op name at O0/O1/O2 with
  custom lists equals the reference's ``_cast_dtype_for``; the tied tiny
  GPT under O1 and O2 bf16 runs each op of its path in the reference's
  dtype (the output dtype of every embedding, add, LayerNorm, linear,
  attention, GELU, fused cross-entropy and loss reduction, in order);
  its loss and grads match the JAX model's under the JAX ``auto_cast``;
  the flash and fused cross-entropy kernels' wrappers get bf16 inputs.
- ``GradScaler``: the scale, the good-step counter, the skipped updates
  and ``state_dict`` over seven steps with infs injected into a grad,
  against the JAX scaler driving the JAX Adam.
- ``decorate(level="O2")`` casts every parameter, as the reference does.
- dropout: explicit generators only, determinism per seed, eval, the
  kept fraction (the reference's bits come from ``jax.random`` and
  cannot be matched).

Tolerances under AMP: both packages round to bf16, but not at the same
places (the port's CPU attention keeps its weights f32 where the
reference's composition rounds them to bf16 before the product with V;
LayerNorm statistics are f32 in the port at O2 and bf16 in the
reference), so the two differ by as much as each differs from f32 (the
reference's own O1 grads differ from its f32 grads by up to 1.6e-2 of
the largest grad here). Grads are held within 5e-2 of each parameter's
largest |grad|; the loss to rtol 1e-3 at O1 (f32) and 1e-2 at O2, where
it is bf16 (one ulp is 7e-3 of it).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp.auto_cast import BLACK_LIST as J_BLACK
from paddle_tpu.amp.auto_cast import WHITE_LIST as J_WHITE
from paddle_tpu.amp.auto_cast import _cast_dtype_for as j_cast_dtype_for
from paddle_tpu.amp.auto_cast import amp_enabled as j_amp_enabled
from paddle_tpu.core import dispatch
from paddle_tpu.core.tensor import Parameter, Tensor
from torch.overrides import TorchFunctionMode

import paddle_tpu_torch as ptt
from _torch_port import TINY, jax_gpt, torch_twin
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp.auto_cast import (BLACK_LIST, WHITE_LIST,
                                            _OP_NAMES, _cast_dtype_for,
                                            _state)
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import fused_ce as tce
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.text import models as tmodels
from paddle_tpu_torch.text.convert import state_dict_to_paddle_tpu

V = TINY["vocab_size"]
GRAD_TOL = 5e-2
LOSS_RTOL = {"O1": 1e-3, "O2": 1e-2}


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (2, 16)).astype(np.int64)
    labels = rs.randint(0, V, (2, 16)).astype(np.int64)
    labels[rs.rand(2, 16) < 0.3] = -100
    return ids, labels


STATES = [dict(level="O1"), dict(level="O2"), dict(level="O0"),
          dict(level="O1", enable=False),
          dict(level="O1", custom_white_list=["gelu", "softmax"]),
          dict(level="O2", custom_black_list=["linear", "gelu"]),
          dict(level="O1", dtype="float16")]


@pytest.mark.parametrize("state", STATES, ids=str)
def test_cast_rule_matches_reference(state):
    """For every op name of either list and a few of neither, the port
    casts (and to which dtype) exactly when the reference does."""
    names = sorted(WHITE_LIST | BLACK_LIST | {"gelu", "elementwise_add",
                                              "reshape", "lookup_table_v2"})
    assert WHITE_LIST == J_WHITE and BLACK_LIST == J_BLACK
    with paddle.amp.auto_cast(**state), tamp.auto_cast(**state):
        assert tamp.amp_enabled() == j_amp_enabled()
        for name in names:
            j, t = j_cast_dtype_for(name), _cast_dtype_for(name)
            assert (j is None) == (t is None), name
            if t is not None:
                assert str(t).split(".")[-1] == np.dtype(j).name, name
    assert not tamp.amp_enabled() and _state.amp is None
    with pytest.raises(ValueError):
        with tamp.auto_cast(level="O3"):
            pass


def _jax_amp(jm, ids, labels, level):
    with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
        loss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    return loss, grads


def _torch_amp(tm, ids, labels, level):
    with tamp.auto_cast(level=level, dtype="bfloat16"):
        loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    grads = state_dict_to_paddle_tpu(
        {n: p.grad for n, p in tm.named_parameters()})
    return loss, grads


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_loss_and_grads_match_reference(level):
    """The tied tiny GPT under ``auto_cast(level, "bfloat16")``: the
    loss (f32 at O1, bf16 at O2 in both) and every parameter's f32
    grad against the JAX model's under its own ``auto_cast``."""
    ids, labels = _batch()
    jm = jax_gpt(tie_embeddings=True)
    tm = torch_twin(jm)
    jl, jg = _jax_amp(jm, ids, labels, level)
    tl, tg = _torch_amp(tm, ids, labels, level)
    assert str(tl.dtype).split(".")[-1] == np.dtype(jl.value.dtype).name
    np.testing.assert_allclose(float(tl.detach().float()),
                               float(np.asarray(jl.numpy(), np.float32)),
                               rtol=LOSS_RTOL[level])
    assert set(tg) == set(jg)
    for name, g in jg.items():
        assert tg[name].dtype == np.float32
        err = np.abs(tg[name] - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (name, err)


# the ops whose output dtype the two packages are held to, by the
# reference's op names; the reshapes, transposes and splits around them
# are written differently in the two models
COMPUTE_OPS = {"lookup_table_v2", "elementwise_add", "layer_norm", "linear",
               "flash_attention", "gelu", "fused_linear_cross_entropy",
               "reduce_sum", "clip", "elementwise_div"}


class _Recorder(TorchFunctionMode):
    """(reference op name, output dtype) of each named torch function the
    model calls outside the port's own op bodies."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _OP_NAMES.get(func) if not _state.depth else None
        if name in COMPUTE_OPS:
            self.log.append((name, str(out.dtype).split(".")[-1]))
        return out


def _port_op_spy(monkeypatch, log, module, attr, name):
    real = getattr(module, attr)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        log.append((name, str(out.dtype).split(".")[-1]))
        return out

    monkeypatch.setattr(module, attr, spy)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_op_dtypes_match_reference(monkeypatch, level):
    """Every compute op of the tied GPT's loss path outputs the dtype
    the reference's op outputs, in the same order: e.g. at O1 the
    linears, attention and GELU in bf16 while the embeddings, the
    residual adds, LayerNorm and the fused cross-entropy stay f32; at O2
    the embeddings and adds in bf16, LayerNorm f32 (its f32 weights), the
    loss bf16."""
    ids, labels = _batch()
    jm = jax_gpt(tie_embeddings=True)
    tm = torch_twin(jm)
    jlog, tlog = [], []
    real_call = dispatch.Op.__call__

    def record(op, *args, **attrs):
        out = real_call(op, *args, **attrs)
        if op.name in COMPUTE_OPS:
            jlog.append((op.name, np.dtype(out.value.dtype).name))
        return out

    monkeypatch.setattr(dispatch.Op, "__call__", record)
    with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
        jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    monkeypatch.setattr(dispatch.Op, "__call__", real_call)

    _port_op_spy(monkeypatch, tlog, tattn, "scaled_dot_product_attention",
                 "flash_attention")
    _port_op_spy(monkeypatch, tlog, tce, "fused_linear_cross_entropy",
                 "fused_linear_cross_entropy")
    with tamp.auto_cast(level=level, dtype="bfloat16"), _Recorder(tlog):
        tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    n_layers = TINY["num_layers"]
    # two embeddings and their add; per layer two LayerNorms, four
    # linears, attention, GELU, two adds; ln_f; the head; the reduction
    assert len(jlog) == 2 + 1 + n_layers * 10 + 1 + 1 + 4, jlog
    assert tlog == jlog


@pytest.mark.parametrize("level", ["O1", "O2", None])
def test_kernel_wrappers_get_the_cast_inputs(monkeypatch, level):
    """Inside the model the flash forward (K1) and the fused
    cross-entropy (K5) wrappers receive bf16 q/k/v and x/W under O1 and
    O2, f32 without ``auto_cast``; their backward kernels the same."""
    seen = []
    for mod, attr in ((tattn, "flash_attention_forward"),
                      (tattn, "flash_bwd_dq"), (tce, "fused_ce_forward"),
                      (tce, "fused_ce_bwd_dx"), (tce, "fused_ce_bwd_dw")):
        real = getattr(mod, attr)

        def spy(*args, _real=real, _attr=attr, **kwargs):
            seen.append((_attr, args[0].dtype, args[1].dtype))
            return _real(*args, **kwargs)

        monkeypatch.setattr(mod, attr, spy)
    ids, labels = _batch()
    tm = torch_twin(jax_gpt(tie_embeddings=True))
    want = torch.float32 if level is None else torch.bfloat16
    with tamp.auto_cast(enable=level is not None, level=level or "O1"):
        loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.float().backward()
    kinds = {a for a, _, _ in seen}
    assert kinds == {"flash_attention_forward", "flash_bwd_dq",
                     "fused_ce_forward", "fused_ce_bwd_dx",
                     "fused_ce_bwd_dw"}
    assert all(a == b == want for _, a, b in seen), seen


SCALER_KW = dict(init_loss_scaling=1024.0, incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
# per step, whether a grad holds an inf (then the update is skipped)
INF_AT = [False, False, True, False, False, True, True]


def test_grad_scaler_matches_reference():
    """Seven steps of ``scaler.step(opt)`` over scaled grads with infs
    injected at steps 3, 6 and 7: the loss scale (1024 -> 2048 after two
    good steps, halved on each bad one), the good-step counter, the
    skipped updates (parameters unchanged) and ``state_dict`` follow the
    JAX scaler with the JAX Adam step for step."""
    rs = np.random.RandomState(5)
    shapes = [(4, 3), (3,)]
    values = [rs.randn(*s).astype(np.float32) for s in shapes]
    jp = [Parameter(v.copy()) for v in values]
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    jo = paddle.optimizer.Adam(1e-2, parameters=jp)
    to = topt.Adam(1e-2, parameters=tp)
    js = paddle.amp.GradScaler(**SCALER_KW)
    ts = tamp.GradScaler(**SCALER_KW)
    loss = np.float32(3.0)
    np.testing.assert_allclose(
        ts.scale(torch.tensor(loss)).numpy(),
        js.scale(paddle.to_tensor(loss)).numpy(), rtol=0)
    scales = []
    for step, bad in enumerate(INF_AT):
        before = [p.detach().clone() for p in tp]
        scale = float(ts.get_loss_scaling())
        grads = [(rs.randn(*s) * scale).astype(np.float32) for s in shapes]
        if bad:
            grads[1][1] = np.inf
        for p, g in zip(jp, grads):
            p._grad = Tensor(g)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g.copy())
        js.step(jo)
        ts.step(to)
        jo.clear_grad()
        to.clear_grad()
        scales.append(float(ts.get_loss_scaling()))
        assert scales[-1] == float(js.get_loss_scaling().numpy()), step
        for a, b, old in zip(tp, jp, before):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       atol=1e-6, rtol=0)
            assert torch.equal(a.detach(), old) == bad, step
        jsd, tsd = js.state_dict(), ts.state_dict()
        assert set(jsd) == set(tsd)
        for k, v in jsd.items():
            assert float(np.asarray(v)) == float(tsd[k]), (step, k)
    assert scales == [1024.0, 2048.0, 1024.0, 1024.0, 2048.0, 1024.0, 512.0]
    fresh = tamp.GradScaler(**SCALER_KW)
    fresh.load_state_dict(ts.state_dict())
    assert float(fresh.get_loss_scaling()) == 512.0
    off = tamp.AmpScaler(enable=False)
    assert not off.is_enable() and off.scale(torch.tensor(2.0)) == 2.0


def test_scaler_and_optimizer_run_uncast_inside_auto_cast():
    """A whole step inside ``auto_cast`` O2 (forward, scaled backward,
    ``scaler.step``): the unscaled grads keep their f32 and the update
    equals the same step with only the forward inside."""
    ids, labels = _batch()
    jm = jax_gpt(tie_embeddings=True)
    runs = []
    for inside in (True, False):
        tm = torch_twin(jm)
        opt = topt.AdamW(1e-3, parameters=tm.named_parameters(),
                         weight_decay=0.01)
        scaler = tamp.GradScaler(init_loss_scaling=256.0)
        with tamp.auto_cast(level="O2"):
            loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
            if inside:
                scaler.scale(loss).backward()
                scaler.step(opt)
        if not inside:
            scaler.scale(loss).backward()
            scaler.step(opt)
        assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
        runs.append([p.detach().clone() for p in tm.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_decorate_o2_casts_parameters_as_the_reference_does():
    """``decorate(model, opt, level="O2")`` returns both and leaves every
    parameter bf16 in both packages; O1 changes nothing; the decorated
    model trains a step under O2 with a finite bf16 loss."""
    jm = jax_gpt(tie_embeddings=True)
    tm = torch_twin(jm)
    opt = topt.AdamW(1e-3, parameters=tm.named_parameters())
    assert tamp.decorate(tm, level="O1") is tm
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    jout = paddle.amp.decorate(jm, level="O2")
    out = tamp.decorate(tm, opt, level="O2")
    assert out[0] is tm and out[1] is opt and jout is jm
    jd = {n: np.dtype(p.value.dtype).name for n, p in jm.named_parameters()}
    td = {n: str(p.dtype).split(".")[-1] for n, p in tm.named_parameters()}
    assert set(td.values()) == {"bfloat16"} and set(jd.values()) == {
        "bfloat16"} and len(td) == len(jd)
    ids, labels = _batch()
    with tamp.auto_cast(level="O2"):
        loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    opt.step()
    assert loss.dtype == torch.bfloat16 and torch.isfinite(loss)


def _dropout_losses(seed, p=0.1, steps=3, generator=None):
    ptt.seed(seed)
    cfg = tmodels.TransformerLMConfig(**{**TINY, "dropout": p})
    m = tmodels.GPTForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0),
                               dropout_generator=generator).train()
    opt = topt.AdamW(1e-3, parameters=m.named_parameters())
    ids, labels = _batch(1)
    losses = []
    state = torch.random.get_rng_state()
    for _ in range(steps):
        loss = m(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    # the masks never came from torch's global generator
    assert torch.equal(torch.random.get_rng_state(), state)
    return losses, m


def test_dropout_is_deterministic_per_seed():
    """Three training steps at p = 0.1: the same seed gives the same
    losses (and leaves torch's global generator untouched), a different
    seed other losses, and a caller's generator overrides the seed;
    ``eval()`` drops nothing."""
    a, m = _dropout_losses(11)
    b, _ = _dropout_losses(11)
    c, _ = _dropout_losses(12)
    assert a == b and a != c
    d, _ = _dropout_losses(12, generator=torch.Generator().manual_seed(5))
    e, _ = _dropout_losses(13, generator=torch.Generator().manual_seed(5))
    assert d == e and d != c
    ids, labels = _batch(1)
    m.eval()
    with torch.no_grad():
        x = torch.from_numpy(ids)
        assert torch.equal(m(x, labels=torch.from_numpy(labels)),
                           m(x, labels=torch.from_numpy(labels)))
        nodrop = tmodels.GPTForCausalLM(
            tmodels.TransformerLMConfig(**TINY), device="cpu")
        nodrop.load_state_dict(m.state_dict())
        torch.testing.assert_close(m(x), nodrop.eval()(x), rtol=0, atol=0)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_a_binomial_share(p):
    """The kept fraction of 100,000 elements lies within 5 binomial
    standard deviations of 1 - p; kept elements are scaled by 1/(1-p)
    (``downscale_in_infer``: kept as they are, and ``x (1 - p)`` out of
    training)."""
    n = 100_000
    x = torch.ones(n)
    gen = torch.Generator().manual_seed(3)
    y = nn_ops.dropout(x, p, training=True, generator=gen)
    kept = int((y != 0).sum())
    sd = (n * p * (1 - p)) ** 0.5
    assert abs(kept - n * (1 - p)) <= 5 * sd
    torch.testing.assert_close(y[y != 0], torch.full((kept,), 1 / (1 - p)))
    z = nn_ops.dropout(x, p, training=True, mode="downscale_in_infer",
                       generator=gen)
    assert set(z.unique().tolist()) <= {0.0, 1.0}
    torch.testing.assert_close(
        nn_ops.dropout(x, p, training=False, mode="downscale_in_infer"),
        x * (1 - p))
    assert nn_ops.dropout(x, p, training=False) is x
    with pytest.raises(ValueError):
        nn_ops.dropout(x, p, mode="scale")
