"""The port's optimizers against the JAX reference on the CPU: the update
rule of every optimizer (SGD, Momentum, Adam, AdamW, Adamax, Adagrad,
RMSProp, Lamb, LarsMomentum, Adadelta, Ftrl) fed identical grads, 5-step
training loops of the tiny GPT with each of them, regularizer objects,
ClipGradByValue, param-group dicts, ``minimize``, ``clear_gradients``
and ``state_dict`` / ``set_state_dict``, within the port and carried
across from the reference. Inputs are numpy arrays from a seed, handed to
both packages.

Tolerances, all f32:
- an update rule fed identical grads: parameters atol 1e-6 (the same
  f32 operations, in the reference's order), every state tensor atol
  1e-6 and rtol 1e-6: XLA fuses ``mu * v + g`` into one rounding where
  the port rounds twice, an ulp of a velocity of 20 is 1.9e-6;
- the 5-step loops: losses rtol 1e-5 (``tests/test_torch_training.py``'s
  loop tolerance). Parameters: every element within twice the largest
  move any element made in the reference's run, and for each tensor the
  L2 norm of the difference within 1e-3 of the L2 norm of the
  reference's move. The sign-like updates (Adam, Adamax, Adagrad, Lamb,
  Ftrl) divide a grad by its own size, so an element whose grad is near
  0 turns both sides' rounding noise into a step of up to the largest
  move, in either direction; a few such elements of a tensor stay far
  inside its norm. The key third of each QKV bias is all such elements
  (its true grad is 0), so it is held to the elementwise bound alone;
- a state saved and loaded within the port: the same bits as the run
  that never stopped.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter, Tensor

from _torch_port import TINY, jax_gpt, torch_twin
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text.convert import (optimizer_state_from_paddle_tpu,
                                           optimizer_state_to_paddle_tpu,
                                           state_dict_to_paddle_tpu)

V = TINY["vocab_size"]
SHAPES = [(7, 5), (5,), (3, 4, 2)]
NAMES = ["w", "bias", "v"]

UPDATE_CASES = [
    ("SGD", dict()),
    ("SGD", dict(weight_decay=0.1)),
    ("Momentum", dict()),
    ("Momentum", dict(use_nesterov=True, weight_decay=0.05)),
    ("Adam", dict(multi_precision=True)),
    ("AdamW", dict(weight_decay=0.1, lr_ratio=lambda p: 0.5)),
    ("Adamax", dict()),
    ("Adamax", dict(weight_decay=0.1, beta2=0.9)),
    ("Adagrad", dict()),
    ("Adagrad", dict(initial_accumulator_value=0.1, weight_decay=0.1)),
    ("RMSProp", dict()),
    ("RMSProp", dict(centered=True, momentum=0.9, weight_decay=0.01)),
    ("Lamb", dict()),
    ("Lamb", dict(exclude_from_weight_decay_fn=lambda p: p.ndim == 1)),
    ("LarsMomentum", dict()),
    ("LarsMomentum", dict(exclude_from_weight_decay=["bias"])),
    ("Adadelta", dict()),
    ("Adadelta", dict(weight_decay=0.1, rho=0.9)),
    ("Ftrl", dict(lr_power=-0.5)),
    ("Ftrl", dict(lr_power=-1.0, l1=0.01, l2=0.01)),
]


def _case_id(case):
    which, kw = case
    return which + "".join(f"-{k}" for k in kw)


def _param_sets(kind, seed=0):
    """Three parameters and four steps of grads. ``zeros``: the first
    step's grads are all zero (zero state meets zero grads), one
    parameter starts at 0 (Lamb's and LARS's norms are 0 there) and
    one grad stays zero throughout."""
    rs = np.random.RandomState(seed)
    values = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(rs.randn(*s) * 10.0 ** rs.randint(-3, 2)).astype(np.float32)
              for s in SHAPES] for _ in range(4)]
    if kind == "zeros":
        values[1][:] = 0.0
        grads[0] = [np.zeros(s, np.float32) for s in SHAPES]
        for step in grads:
            step[2][:] = 0.0
    return values, grads


@pytest.mark.parametrize("kind", ["random", "zeros"])
@pytest.mark.parametrize("case", UPDATE_CASES, ids=_case_id)
def test_updates_match_reference(case, kind):
    """Four steps of each optimizer on the same grads: every parameter
    and every state tensor (``state_dict()`` on both sides, the
    reference's key names) follow the reference's update function."""
    which, kw = case
    values, grads = _param_sets(kind)
    jp = [Parameter(v.copy(), name=n) for v, n in zip(values, NAMES)]
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    jo = getattr(paddle.optimizer, which)(3e-2, parameters=jp, **kw)
    to = getattr(topt, which)(3e-2, parameters=list(zip(NAMES, tp)), **kw)
    for step in grads:
        for p, g in zip(jp, step):
            p._grad = Tensor(g)
        for p, g in zip(tp, step):
            p.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        for a, b, n in zip(tp, jp, NAMES):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       atol=1e-6, rtol=0, err_msg=n)
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert set(tsd) == set(jsd)
    for k, v in jsd.items():
        if k == "LR_Scheduler":
            assert tsd[k] == v
            continue
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v.numpy()),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


def _ids_labels(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (2, 16)).astype(np.int64)
    labels = rs.randint(0, V, (2, 16)).astype(np.int64)
    labels[rs.rand(2, 16) < 0.3] = -100
    return ids, labels


def _named_jax_params(jm):
    """The reference model's parameters, renamed to their structured
    names (the port's), so a name-keyed option (LarsMomentum's tags)
    means the same parameters on both sides."""
    out = []
    for n, p in jm.named_parameters():
        p.name = n
        out.append(p)
    return out


def _step(model, opt, ids, labels, is_jax, minimize=False):
    wrap = paddle.to_tensor if is_jax else torch.from_numpy
    loss = model(wrap(ids), labels=wrap(labels))
    if minimize:
        opt.minimize(loss)
        opt.clear_gradients()
    else:
        loss.backward()
        opt.step()
        opt.clear_grad()
    return float(loss.numpy() if is_jax else loss.detach())


def _check_params(jm, tm, init):
    """The port's parameters against the reference's, moved from
    ``init``: every element within twice the largest move, each tensor's
    difference within 1e-3 of its move in L2 norm (the key third of each
    QKV bias left out of the norm)."""
    jsd = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    tsd = state_dict_to_paddle_tpu(dict(tm.named_parameters()))
    scale = max(np.abs(v - init[n]).max() for n, v in jsd.items())
    assert scale > 0
    h = TINY["hidden_size"]
    for name, v in jsd.items():
        t, v0 = tsd[name], init[name]
        np.testing.assert_allclose(t, v, atol=2 * scale, rtol=0,
                                   err_msg=name)
        if name.endswith("attn.qkv.bias"):
            t, v, v0 = (np.delete(a, np.s_[h:2 * h]) for a in (t, v, v0))
        err = np.linalg.norm(t - v)
        assert err <= 1e-3 * np.linalg.norm(v - v0), (name, err)


def _loop(make_opt, steps=5, tie=True, need_clip_off=None, minimize=False):
    """``steps`` steps of the tiny GPT in both packages with the
    optimizer ``make_opt(optimizer module, nn module, regularizer
    module, [(name, param)])`` builds: the losses agree, and the
    parameters within the loop tolerance. Returns both models."""
    jm = jax_gpt(tie_embeddings=tie)
    tm = torch_twin(jm).train()
    jm.train()
    jparams = _named_jax_params(jm)
    init = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    if need_clip_off:
        for p in jparams:
            if p.name == need_clip_off:
                p.need_clip = False
        dict(tm.named_parameters())[need_clip_off].need_clip = False
    jo = make_opt(paddle.optimizer, paddle.nn, paddle.regularizer,
                  [(p.name, p) for p in jparams])
    to = make_opt(topt, tnn, treg, list(tm.named_parameters()))
    runs = []
    for is_jax, model, opt in ((True, jm, jo), (False, tm, to)):
        runs.append([_step(model, opt, *_ids_labels(10 + i), is_jax,
                           minimize) for i in range(steps)])
    assert np.isfinite(runs[1]).all()
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)
    _check_params(jm, tm, init)
    return jm, tm


# the optimizer each loop trains with, by the name of its class; the
# reference takes its parameters as a list, the port as named pairs
LOOP_OPTS = {
    "SGD": lambda o, nn, r, ps: o.SGD(0.1, parameters=_pick(o, ps)),
    "Momentum": lambda o, nn, r, ps: o.Momentum(
        0.05, parameters=_pick(o, ps), use_nesterov=True, weight_decay=0.01),
    "Adam": lambda o, nn, r, ps: o.Adam(1e-2, parameters=_pick(o, ps),
                                        multi_precision=True),
    "AdamW": lambda o, nn, r, ps: o.AdamW(1e-2, parameters=_pick(o, ps),
                                          lr_ratio=lambda p: 1.0),
    "Adamax": lambda o, nn, r, ps: o.Adamax(1e-2, parameters=_pick(o, ps)),
    "Adagrad": lambda o, nn, r, ps: o.Adagrad(1e-2, parameters=_pick(o, ps)),
    "RMSProp": lambda o, nn, r, ps: o.RMSProp(
        1e-3, parameters=_pick(o, ps), centered=True, momentum=0.5),
    "Lamb": lambda o, nn, r, ps: o.Lamb(
        1e-2, parameters=_pick(o, ps),
        exclude_from_weight_decay_fn=lambda p: p.ndim == 1),
    "LarsMomentum": lambda o, nn, r, ps: o.LarsMomentum(
        0.1, parameters=_pick(o, ps), exclude_from_weight_decay=["bias"]),
    "Adadelta": lambda o, nn, r, ps: o.Adadelta(1.0, parameters=_pick(o, ps),
                                                weight_decay=0.01),
    "Ftrl": lambda o, nn, r, ps: o.Ftrl(1e-2, parameters=_pick(o, ps)),
    "Ftrl-lr_power-1": lambda o, nn, r, ps: o.Ftrl(
        1e-2, parameters=_pick(o, ps), lr_power=-1.0, l1=1e-4, l2=1e-3),
    "Adam-L1Decay": lambda o, nn, r, ps: o.Adam(
        1e-2, parameters=_pick(o, ps), weight_decay=r.L1Decay(1e-3)),
    "Momentum-L2Decay": lambda o, nn, r, ps: o.Momentum(
        0.05, parameters=_pick(o, ps), weight_decay=r.L2Decay(1e-2)),
    "SGD-ClipGradByValue": lambda o, nn, r, ps: o.SGD(
        0.1, parameters=_pick(o, ps), grad_clip=nn.ClipGradByValue(1e-2)),
    "AdamW-param_groups": lambda o, nn, r, ps: o.AdamW(
        1e-2, weight_decay=0.05,
        parameters=[{"params": _pick(o, ps[:7])},
                    {"params": _pick(o, ps[7:]), "weight_decay": 0.5}]),
}


def _pick(opt_module, named):
    return named if opt_module is topt else [p for _, p in named]


@pytest.mark.parametrize("which", sorted(LOOP_OPTS))
def test_training_loop_matches_reference(which):
    """Five steps of the tied tiny GPT with each optimizer (and with an
    L1Decay, an L2Decay, a ClipGradByValue that skips the word
    embedding (``need_clip = False``) and two param groups, whose own
    options neither package reads): the loss trajectories and the
    parameters agree."""
    off = "gpt.word_embeddings.weight" if "ClipGradByValue" in which \
        else None
    _loop(LOOP_OPTS[which], need_clip_off=off)


def test_clip_by_value_matches_reference():
    """New grads equal the reference's; ``min`` defaults to ``-max``; a
    ``need_clip = False`` parameter keeps its grad; ``p.grad`` is not
    touched."""
    rs = np.random.RandomState(1)
    grads = [(rs.randn(*s) * 3).astype(np.float32) for s in SHAPES]
    for args in ((1.0,), (2.0, -0.5)):
        jp = [Parameter(np.zeros_like(g)) for g in grads]
        tp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        jp[1].need_clip = tp[1].need_clip = False
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g.copy())
        ref = paddle.nn.ClipGradByValue(*args)(
            [(p, Tensor(g)) for p, g in zip(jp, grads)])
        got = tnn.ClipGradByValue(*args)([(p, p.grad) for p in tp])
        for (_, a), (_, b), g, p in zip(got, ref, grads, tp):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(p.grad.numpy(), g)
        np.testing.assert_array_equal(got[1][1].numpy(), grads[1])
        lo = args[1] if len(args) > 1 else -args[0]
        assert got[0][1].min() == lo and got[0][1].max() == args[0]


def test_regularizers():
    for cls, mode in ((treg.L1Decay, "l1"), (treg.L2Decay, "l2")):
        r = cls(0.25)
        assert (r._coeff, r._mode) == (0.25, mode)
        assert repr(r) == f"{cls.__name__}(coeff=0.25)"
        assert repr(r) == repr(getattr(paddle.regularizer, cls.__name__)(
            0.25))
    p = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(TypeError):
        topt.SGD(0.1, parameters=[p], weight_decay="l2")


def test_l2decay_equals_float_decay():
    """L2Decay(c) is the float weight_decay c, bit for bit."""
    values, grads = _param_sets("random")
    out = []
    for wd in (0.1, treg.L2Decay(0.1)):
        tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
        opt = topt.Adam(3e-2, parameters=tp, weight_decay=wd)
        for step in grads:
            for p, g in zip(tp, step):
                p.grad = torch.from_numpy(g.copy())
            opt.step()
        out.append(tp)
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_minimize_and_clear_gradients_match_reference():
    """``minimize(loss)`` (backward, then step) with ``clear_gradients``
    follows the reference's loop, returns ``(None, None)`` and leaves no
    grad; a loss that is not a tensor raises."""
    jm, tm = _loop(LOOP_OPTS["AdamW"], steps=3, minimize=True)
    assert all(p.grad is None for p in tm.parameters())
    opt = topt.SGD(0.1, parameters=tm.parameters())
    ids, labels = _ids_labels(3)
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert opt.minimize(loss) == (None, None)
    with pytest.raises(NotImplementedError):
        opt.minimize(1.0)


def test_ignored_options_leave_the_trajectory_unchanged():
    """``Adam(multi_precision=True)`` and ``AdamW(lr_ratio=...)`` give
    the same bits as without, as in the reference, which reads
    neither."""
    values, grads = _param_sets("random")
    for cls, kw in ((topt.Adam, dict(multi_precision=True)),
                    (topt.AdamW, dict(lr_ratio=lambda p: 0.1))):
        out = []
        for extra in ({}, kw):
            tp = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                  for v in values]
            opt = cls(3e-2, parameters=tp, **extra)
            for step in grads:
                for p, g in zip(tp, step):
                    p.grad = torch.from_numpy(g.copy())
                opt.step()
            out.append(tp)
        assert all(torch.equal(a, b) for a, b in zip(*out))


def _sched(mod):
    # a schedule of last_epoch alone: set_state_dict restores last_epoch,
    # as the reference's does, and not the state of a scheduler nested in
    # a LinearWarmup
    return mod.CosineAnnealingDecay(1e-2, 5)


# state_dict round trips: the optimizer, and whether its learning rate is
# a scheduler
SD_CASES = [("Adam", True), ("AdamW-param_groups", False),
            ("Momentum", True), ("Adamax", False), ("Adagrad", False),
            ("RMSProp", False), ("Lamb", True), ("LarsMomentum", False),
            ("Adadelta", False), ("Ftrl", False), ("SGD", True)]


def _make(which, sched, params):
    if not sched:
        return LOOP_OPTS[which](topt, tnn, treg, params), None
    s = _sched(tlr)
    cls = getattr(topt, which)
    return cls(s, parameters=params), s


@pytest.mark.parametrize("which,sched", SD_CASES)
def test_state_dict_resume_gives_the_same_bits(which, sched):
    """3 steps, ``state_dict()``, a fresh model with the weights and a
    fresh optimizer loaded with ``set_state_dict``, 2 more steps: the
    same bits as 5 steps without a stop, on the CPU. Keys are
    ``f"{name}_{kind}"`` plus ``"LR_Scheduler"``."""
    base = torch_twin(jax_gpt()).train()
    straight = copy.deepcopy(base)
    opt, s = _make(which, sched, list(straight.named_parameters()))
    for i in range(5):
        _step(straight, opt, *_ids_labels(10 + i), False)
        if s is not None:
            s.step()

    first = copy.deepcopy(base)
    opt, s = _make(which, sched, list(first.named_parameters()))
    for i in range(3):
        _step(first, opt, *_ids_labels(10 + i), False)
        if s is not None:
            s.step()
    sd = opt.state_dict()
    meta = sd["LR_Scheduler"]
    assert meta["param_order"] == [n for n, _ in first.named_parameters()]
    # the scheduler's own last_lr (unrounded) overwrites the optimizer's
    assert meta["last_lr"] == (s.last_lr if sched else opt.get_lr())
    assert ("last_epoch" in meta) == sched
    names = {n for n, _ in first.named_parameters()}
    assert all(any(k.startswith(n + "_") for n in names)
               for k in sd if k != "LR_Scheduler")
    resumed = copy.deepcopy(base)
    resumed.load_state_dict(first.state_dict())
    opt2, s2 = _make(which, sched, list(resumed.named_parameters()))
    opt2.set_state_dict(sd)
    assert opt2.get_lr() == opt.get_lr()
    for i in range(3, 5):
        _step(resumed, opt2, *_ids_labels(10 + i), False)
        if s2 is not None:
            s2.step()
    for (n, a), (_, b) in zip(resumed.named_parameters(),
                              straight.named_parameters()):
        assert torch.equal(a, b), n


def test_state_dict_by_saved_order_and_longest_name():
    """Where no key names a current parameter (tensors given without
    names, renumbered), the saved ``param_order`` maps the state; a name
    that prefixes another's does not take its state."""
    values, grads = _param_sets("random")
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    opt = topt.Adam(3e-2, parameters=list(zip(["w", "w_1", "b"], tp)))
    for p, g in zip(tp, grads[0]):
        p.grad = torch.from_numpy(g.copy())
    opt.step()
    sd = opt.state_dict()
    assert sd["w_1_moment1"].shape == tp[1].shape
    again = topt.Adam(3e-2, parameters=list(zip(["w", "w_1", "b"], tp)))
    again.set_state_dict(sd)
    for kind in ("moment1", "moment2", "beta1_pow"):
        for p in tp:
            assert torch.equal(again._acc(kind, p), opt._acc(kind, p))
    renamed = topt.Adam(3e-2, parameters=tp)   # param_0, param_1, ...
    renamed.set_state_dict(sd)
    for p in tp:
        assert torch.equal(renamed._acc("moment2", p), opt._acc("moment2", p))


@pytest.mark.parametrize("which", ["Adam", "Momentum", "Lamb", "RMSProp",
                                   "Ftrl"])
def test_reference_state_carried_across_continues_its_trajectory(which):
    """The reference trains 3 steps; its weights and its optimizer's
    ``state_dict()`` (through ``optimizer_state_from_paddle_tpu``, with
    the parameters' reference names) go to the port, and both take 2 more
    steps: the losses and parameters within the loop tolerance. The
    state carried back (``optimizer_state_to_paddle_tpu``) gives the
    reference's arrays."""
    make = LOOP_OPTS[which]
    jm = jax_gpt()
    jm.train()
    ref_names = {p.name: n for n, p in jm.named_parameters()}
    init = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    jo = make(paddle.optimizer, paddle.nn, paddle.regularizer,
              [(p.name, p) for p in jm.parameters()])
    for i in range(3):
        _step(jm, jo, *_ids_labels(10 + i), True)
    jsd = {k: (v if k == "LR_Scheduler" else np.asarray(v.numpy()))
           for k, v in jo.state_dict().items()}
    tm = torch_twin(jm).train()
    to = make(topt, tnn, treg, list(tm.named_parameters()))
    tsd = optimizer_state_from_paddle_tpu(jsd, ref_names)
    assert tsd["LR_Scheduler"]["param_order"] == [
        n for n, _ in tm.named_parameters()]
    to.set_state_dict(tsd)
    back = optimizer_state_to_paddle_tpu(to.state_dict(), ref_names)
    assert set(back) == set(jsd)
    for k, v in jsd.items():
        if k != "LR_Scheduler":
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    losses = [[_step(m, o, *_ids_labels(10 + i), is_jax)
               for i in range(3, 5)]
              for is_jax, m, o in ((True, jm, jo), (False, tm, to))]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    _check_params(jm, tm, init)


def test_optimizer_state_moments_are_transposed_like_the_weights():
    jm = jax_gpt()
    names = {p.name: n for n, p in jm.named_parameters()}
    ref = {p.name + "_moment1": np.asarray(p.numpy())
           for p in jm.parameters()}
    got = optimizer_state_from_paddle_tpu(ref, names)
    tm = torch_twin(jm)
    for n, p in tm.named_parameters():
        assert torch.equal(got[n + "_moment1"], p.detach()), n
    with pytest.raises(KeyError):
        optimizer_state_from_paddle_tpu({"nobody_moment1": np.zeros(2)},
                                        names)
