"""Per-block activation recompute in the port (``TransformerLMConfig(
recompute=True)``) on the CPU: against the same model without recompute,
with dropout on, in f32 and under ``amp.auto_cast`` O1, and against the
JAX reference's recompute at dropout 0. Inputs are numpy arrays from a
seed.

Tolerances:
- recompute against no recompute, the same port model on the CPU: the
  loss and every grad with the same bits, over two steps, and the
  dropout generator left in the same state (the recomputed block draws
  the masks of its forward, and the draws after it go on as without
  recompute);
- against the reference at dropout 0: ``tests/test_torch_training.py``'s
  loss atol/rtol 1e-5 and grads atol 2e-6, rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

from _torch_port import TINY, jax_gpt, torch_twin
import paddle_tpu_torch
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.text import models as tmodels
from paddle_tpu_torch.text.convert import state_dict_to_paddle_tpu

V = TINY["vocab_size"]


def _batch(seed):
    rs = np.random.RandomState(seed)
    ids = torch.from_numpy(rs.randint(0, V, (2, 16)).astype(np.int64))
    labels = torch.from_numpy(rs.randint(0, V, (2, 16)).astype(np.int64))
    return ids, labels


def _model(recompute, tie, gen):
    cfg = tmodels.TransformerLMConfig(**{**TINY, "dropout": 0.1},
                                      tie_embeddings=tie,
                                      recompute=recompute)
    return tmodels.GPTForCausalLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3),
        dropout_generator=gen).train()


def _two_steps(model, amp, gen, seed_default):
    """Two SGD steps; (losses, grads of each step, the generator's state
    after each backward)."""
    if seed_default:
        paddle_tpu_torch.seed(11)
    opt = topt.SGD(0.5, parameters=model.named_parameters())
    out = []
    for step in range(2):
        ids, labels = _batch(step)
        if amp:
            with auto_cast(level="O1", dtype="bfloat16"):
                loss = model(ids, labels=labels)
        else:
            loss = model(ids, labels=labels)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        state = (gen if gen is not None
                 else rng.default_generator("cpu")).get_state()
        out.append((loss.detach(), grads, state))
        opt.step()
        opt.clear_grad()
    return out


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "O1"])
@pytest.mark.parametrize("gen_kind", ["explicit", "default"])
def test_recompute_gives_the_same_bits_with_dropout(amp, tie, gen_kind):
    """Dropout 0.1 from one seeded generator (the model's
    ``dropout_generator``, or the port's default one, seeded): the loss
    and every grad of two steps equal the run without recompute bit for
    bit, in f32 and under auto_cast O1 bf16 (the recomputation casts as
    its forward did), and the generator ends each step in the same
    state."""
    runs = []
    for recompute in (False, True):
        gen = torch.Generator().manual_seed(5) if gen_kind == "explicit" \
            else None
        runs.append(_two_steps(_model(recompute, tie, gen), amp, gen,
                               gen_kind == "default"))
    for (l0, g0, s0), (l1, g1, s1) in zip(*runs):
        assert torch.equal(l0, l1)
        assert set(g0) == set(g1)
        for name in g0:
            assert torch.equal(g0[name], g1[name]), name
        assert torch.equal(s0, s1)


def test_recompute_runs_only_in_training_with_grad(monkeypatch):
    """Each block goes through the recompute function once a forward when
    the model trains and grad is on; not in eval, not under no_grad."""
    calls = []
    real = tmodels._BlockRecompute.apply

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tmodels._BlockRecompute, "apply", counting)
    m = _model(True, True, torch.Generator().manual_seed(5))
    ids, labels = _batch(0)
    m(ids, labels=labels).backward()
    assert len(calls) == TINY["num_layers"]
    with torch.no_grad():
        m(ids, labels=labels)
    m.eval()
    m(ids, labels=labels)
    assert len(calls) == TINY["num_layers"]


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_recompute_matches_reference_recompute(tie):
    """At dropout 0, the loss and every parameter's grad of the port with
    recompute against the reference with recompute (its
    ``utils_recompute.recompute`` over each block)."""
    jm = jax_gpt(tie_embeddings=tie, recompute=True)
    jm.train()
    tm = torch_twin(jm).train()
    assert tm.cfg.recompute
    rs = np.random.RandomState(0)
    ids = rs.randint(0, V, (2, 16)).astype(np.int64)
    labels = rs.randint(0, V, (2, 16)).astype(np.int64)
    jl = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jl.backward()
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tl = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tl.backward()
    tg = state_dict_to_paddle_tpu({n: p.grad
                                   for n, p in tm.named_parameters()})
    np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                               atol=1e-5, rtol=1e-5)
    assert set(tg) == set(jg)
    for name, g in jg.items():
        np.testing.assert_allclose(tg[name], g, atol=2e-6, rtol=1e-4,
                                   err_msg=name)
