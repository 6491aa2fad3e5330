"""Training in paddle_tpu_torch against the JAX reference on the CPU:
the untied and the tied (default) GPT's loss and every parameter's
gradient, the Adam/AdamW update rule, the gradient clips, every
learning-rate scheduler, and 5-step AdamW loops (untied and tied) with
a global-norm clip and a warmed-up cosine schedule. Inputs are numpy
arrays from a seed, handed to both packages. The tied head goes through
the fused linear cross-entropy on both sides (on the CPU the reference
runs its composition ``_reference``, the port K5-K7's plain versions),
and the word embedding's grad sums the lookup's and the head's.

Tolerances, all f32 without TF32:
- loss atol/rtol 1e-5 and grads atol 2e-6, rtol 1e-4: the same model
  summed in another order (grads of the tiny GPT are O(1e-2..1));
- the update rule fed identical grads: atol 1e-6;
- clips and schedulers: 1e-7 relative, and the schedules exactly (pure
  Python on both sides);
- the 5-step loop: losses rtol 1e-5; parameters atol 1e-3 * lr_max,
  except the key third of each QKV bias: its true grad is 0, both sides
  hold rounding noise there, and Adam's m_hat/sqrt(v_hat), about sign(g)
  after a step, moves it by up to lr a step in either direction, so it
  is held to twice the sum of the learning rates.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter, Tensor
from paddle_tpu.optimizer import lr as jlr

from _torch_port import TINY, jax_gpt, torch_twin
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text.convert import state_dict_to_paddle_tpu

V = TINY["vocab_size"]


def _ids_labels(kind, seed=0, shape=(2, 16)):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, shape).astype(np.int64)
    labels = rs.randint(0, V, shape).astype(np.int64)
    if kind == "some_ignored":
        labels[rs.rand(*shape) < 0.3] = -100
    elif kind == "all_ignored":
        labels[:] = -100
    return ids, labels


def _jax_loss_grads(jm, ids, labels):
    loss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    jm.clear_gradients()
    return float(loss.numpy()), grads


def _torch_loss_grads(tm, ids, labels):
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    grads = state_dict_to_paddle_tpu(
        {n: p.grad for n, p in tm.named_parameters()})
    tm.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _check_loss_and_grads(kind, tie):
    jm = jax_gpt(tie_embeddings=tie)
    tm = torch_twin(jm)
    assert tm.cfg.tie_embeddings == tie and hasattr(tm, "lm_head") != tie
    ids, labels = _ids_labels(kind)
    jl, jg = _jax_loss_grads(jm, ids, labels)
    tl, tg = _torch_loss_grads(tm, ids, labels)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    assert set(tg) == set(jg)
    assert len(tg) == 4 + 12 * TINY["num_layers"] + (not tie)
    for name, g in jg.items():
        assert tg[name].shape == g.shape, name
        np.testing.assert_allclose(tg[name], g, atol=2e-6, rtol=1e-4,
                                   err_msg=name)
    if kind == "all_ignored":
        assert tl == 0.0
        assert all(not g.any() for g in tg.values())


@pytest.mark.parametrize("kind", ["all_valid", "some_ignored",
                                  "all_ignored"])
def test_untied_loss_and_grads_match_reference(kind):
    """Loss and the grad of every parameter (embeddings, LayerNorms, the
    QKV/out/MLP linears through the flash backward, the separate head);
    an all-ignored batch gives loss 0 and zero grads on both sides."""
    _check_loss_and_grads(kind, tie=False)


@pytest.mark.parametrize("kind", ["all_valid", "some_ignored",
                                  "all_ignored"])
def test_tied_loss_and_grads_match_reference(kind):
    """The default GPT (head tied to the word embedding): the loss through
    the fused cross-entropy and the grad of every parameter, the word
    embedding's included (lookup plus K7's dW); all-ignored gives loss 0
    and zero grads."""
    _check_loss_and_grads(kind, tie=True)


def test_cross_entropy_reductions():
    rs = np.random.RandomState(4)
    logits = torch.from_numpy(rs.randn(6, 5).astype(np.float32))
    label = torch.tensor([0, -100, 4, 2, -100, 1])
    none = nn_ops.cross_entropy(logits, label, reduction="none")
    assert none[1] == 0 and none[4] == 0
    torch.testing.assert_close(nn_ops.cross_entropy(logits, label,
                                                    reduction="sum"),
                               none.sum())
    torch.testing.assert_close(nn_ops.cross_entropy(logits, label),
                               none.sum() / 4)
    with pytest.raises(ValueError):
        nn_ops.cross_entropy(logits, label, reduction="max")


SHAPES = [(7, 5), (5,), (3, 4, 2)]


def _param_sets(seed=0):
    rs = np.random.RandomState(seed)
    values = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(rs.randn(*s) * 10.0 ** rs.randint(-3, 2)).astype(np.float32)
              for s in SHAPES] for _ in range(3)]
    return values, grads


def _no_decay_on_bias(name):
    return not name.endswith("bias")


@pytest.mark.parametrize("which,kw", [
    ("Adam", dict()),
    ("Adam", dict(weight_decay=0.1)),
    ("AdamW", dict(weight_decay=0.1)),
    ("AdamW", dict(weight_decay=0.1,
                   apply_decay_param_fun=_no_decay_on_bias)),
    ("AdamW", dict(weight_decay=0.0, beta1=0.8, beta2=0.99, epsilon=1e-6)),
])
def test_adam_updates_match_reference(which, kw):
    """Three steps of Adam/AdamW on the same grads: parameters (and the
    f32 moments behind them) follow the reference's ``_adam`` within
    1e-6; with ``apply_decay_param_fun`` the bias is not decayed."""
    values, grads = _param_sets()
    names = ["w", "bias", "v"]
    jp = [Parameter(v.copy(), name=n) for v, n in zip(values, names)]
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    jo = getattr(paddle.optimizer, which)(3e-2, parameters=jp, **kw)
    to = getattr(topt, which)(3e-2, parameters=list(zip(names, tp)), **kw)
    for step in grads:
        for p, g in zip(jp, step):
            p._grad = Tensor(g)
        for p, g in zip(tp, step):
            p.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        assert all(p.grad is None for p in tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       atol=1e-6, rtol=0)
    if kw.get("apply_decay_param_fun"):
        # the same run with decay everywhere moves the bias differently
        tp2 = [torch.nn.Parameter(torch.from_numpy(v.copy()))
               for v in values]
        to2 = topt.AdamW(3e-2, parameters=list(zip(names, tp2)),
                         weight_decay=0.1)
        for step in grads:
            for p, g in zip(tp2, step):
                p.grad = torch.from_numpy(g.copy())
            to2.step()
        assert torch.equal(tp2[0], tp[0]) and torch.equal(tp2[2], tp[2])
        assert not torch.equal(tp2[1], tp[1])


def test_optimizer_rejects_what_is_not_ported():
    """A weight_decay that is neither a float nor a regularizer and a
    missing parameter list raise. ``lr_ratio`` and ``multi_precision``
    are taken (and, as in the reference, not read:
    tests/test_torch_optimizers.py). A sparse grad takes the sparse
    update (tests/test_torch_sparse_grad.py), here the dense one's
    bits."""
    p = torch.nn.Parameter(torch.ones(3))
    topt.AdamW(1e-3, parameters=[p], lr_ratio=lambda n: 1.0)
    topt.Adam(1e-3, parameters=[p], multi_precision=True)
    with pytest.raises(TypeError):
        topt.Adam(1e-3, parameters=[p], weight_decay=object())
    with pytest.raises(ValueError):
        topt.Adam(1e-3)
    opt = topt.Adam(1e-3, parameters=[p])
    p.grad = torch.ones(3).to_sparse()
    opt.step()
    q = torch.nn.Parameter(torch.ones(3))
    dense = topt.Adam(1e-3, parameters=[q])
    q.grad = torch.ones(3)
    dense.step()
    assert torch.equal(p, q) and not torch.equal(p, torch.ones(3))


def _clip_inputs(seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * 3).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("clip,norm", [("ClipGradByGlobalNorm", 1.0),
                                       ("ClipGradByGlobalNorm", 1e3),
                                       ("ClipGradByNorm", 2.0)])
def test_clips_match_reference(clip, norm):
    """New grads equal the reference's; a ``need_clip = False``
    parameter keeps its grad and stays out of the global norm;
    ``p.grad`` is not touched."""
    grads = _clip_inputs()
    jp = [Parameter(np.zeros_like(g)) for g in grads]
    jp[1].need_clip = False
    tp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    tp[1].need_clip = False
    for p, g in zip(tp, grads):
        p.grad = torch.from_numpy(g.copy())
    ref = getattr(paddle.nn, clip)(norm)([(p, Tensor(g))
                                          for p, g in zip(jp, grads)])
    got = getattr(tnn, clip)(norm)([(p, p.grad) for p in tp])
    for (_, a), (_, b), g, p in zip(got, ref, grads, tp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7,
                                   atol=1e-7)
        np.testing.assert_array_equal(p.grad.numpy(), g)
    np.testing.assert_array_equal(got[1][1].numpy(), grads[1])


SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 4, learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, 0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, 5, end_lr=0.01,
                                                   power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(0.5, 4, cycle=True),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, 0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [2, 5], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, 3, 0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.9 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.5, 10,
                                                             eta_min=0.01),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.5, 8), 3, 0.0, 0.5),
    "LinearWarmup_float": lambda m: m.LinearWarmup(0.5, 3, 0.1, 0.5),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.5, factor=0.5,
                                                   patience=1, cooldown=1),
}
PLATEAU_METRICS = [5.0, 4.0, 4.0, 4.0, 4.5, 3.0, 3.0, 3.0, 3.0, 2.9, 2.9,
                   2.9]


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_sequences_match_reference(name):
    """Twelve steps of each scheduler give the reference's sequence
    exactly, and a bound optimizer reads the same f32 learning rate."""
    js, ts = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    jo = paddle.optimizer.AdamW(js, parameters=[Parameter(np.zeros(2))])
    to = topt.AdamW(ts, parameters=[torch.nn.Parameter(torch.zeros(2))])
    for i in range(12):
        assert ts() == js(), (name, i)
        assert to.get_lr() == jo.get_lr(), (name, i)
        if name == "ReduceOnPlateau":
            js.step(PLATEAU_METRICS[i])
            ts.step(torch.tensor(PLATEAU_METRICS[i]))
        else:
            js.step()
            ts.step()
    assert ts.state_dict() == js.state_dict()


def _adamw_loop(tie):
    lr_max = 1e-2
    jm = jax_gpt(tie_embeddings=tie)
    tm = torch_twin(jm).train()
    jm.train()
    runs = []
    for is_jax, model, opt_mod, sched_mod, clip_mod in (
            (True, jm, paddle.optimizer, jlr, paddle.nn),
            (False, tm, topt, tlr, tnn)):
        sched = sched_mod.LinearWarmup(
            sched_mod.CosineAnnealingDecay(lr_max, 5), 2, 0.0, lr_max)
        opt = opt_mod.AdamW(
            sched, weight_decay=0.01,
            parameters=model.parameters() if is_jax
            else model.named_parameters(),
            grad_clip=clip_mod.ClipGradByGlobalNorm(1.0))
        losses, lrs = [], []
        for step in range(5):
            lrs.append(opt.get_lr())
            ids, labels = _ids_labels("some_ignored", seed=10 + step)
            wrap = paddle.to_tensor if is_jax else torch.from_numpy
            loss = model(wrap(ids), labels=wrap(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(float(loss.numpy() if is_jax else loss.detach()))
        runs.append(losses)
    assert np.isfinite(runs[1]).all()
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)
    jsd = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    tsd = state_dict_to_paddle_tpu(dict(tm.named_parameters()))
    h = TINY["hidden_size"]
    for name, v in jsd.items():
        t = tsd[name]
        if name.endswith("attn.qkv.bias"):
            # the key bias adds q.b_k to a whole score row, which softmax
            # ignores: its true grad is 0 and both packages hold rounding
            # noise there, which Adam turns into steps of +-lr
            np.testing.assert_allclose(t[h:2 * h], v[h:2 * h], rtol=0,
                                       atol=2 * sum(lrs), err_msg=name)
            t, v = np.delete(t, np.s_[h:2 * h]), np.delete(v, np.s_[h:2 * h])
        np.testing.assert_allclose(t, v, atol=1e-3 * lr_max, rtol=0,
                                   err_msg=name)
    # the schedule really trained: the same batch scores lower than at init
    ids, labels = _ids_labels("all_valid", seed=10)
    fresh = torch_twin(jax_gpt(tie_embeddings=tie))
    with torch.no_grad():
        before = float(fresh(torch.from_numpy(ids),
                             labels=torch.from_numpy(labels)))
        after = float(tm(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels)))
    assert after < before


def test_adamw_loop_with_clip_and_schedule_matches_reference():
    """Five steps of the reference's training loop on the untied tiny
    GPT (``loss = model(ids, labels)``, backward, ``step``, ``clear_grad``,
    scheduler step) with AdamW, ``ClipGradByGlobalNorm(1.0)`` and
    ``LinearWarmup(CosineAnnealingDecay)``: the loss trajectories agree
    and the loss falls."""
    _adamw_loop(tie=False)


def test_tied_adamw_loop_matches_reference():
    """The same five-step loop on the default, tied GPT: the loss
    trajectories and the parameters (the shared word embedding
    included) agree, and the loss falls."""
    _adamw_loop(tie=True)
