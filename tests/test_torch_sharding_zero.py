"""ZeRO in the port (distributed/sharding: group_sharded_parallel at os,
os_g and p_g_os, and fleet's sharding_degree route through
ShardingParallel and HybridParallelOptimizer) against the reference's
tiny GPT, over two gloo rank processes on the CPU
(tests/torch_dist_worker.py, suite ``zero``, about 20 s).

Each rank takes half of a batch without ignored labels, so the mean of
the ranks' losses is the whole batch's, which the reference trains in
one program. AdamW with decay off for the biases (the partition keeps
each parameter whole, so the exclusion keeps its meaning) and a
global-norm clip (summed over the partitions). Tolerances, f32: the mean
loss rtol 1e-5; weights after 3 steps atol 1e-2 x lr, the QKV biases'
key thirds (true grad 0) 2 x 3 x lr. Each rank's optimizer state is at
most 0.6 of one process's; at os_g and p_g_os a rank holds the grads of
its own partition only once the backward is done (each grad averaged
onto its owner as it is ready); at p_g_os the parameters outside a
rank's partition hold no storage between steps.

With a GradScaler (each level, and fleet's route): an MLP by SGD over
three batches, the second overflowing on rank 1's half only, against
the reference's one-process AMP steps on the whole batches: every rank
skips the overflowing step (no rank waits in a reduction the others
left), the scale halves, and the other steps unscale every grad the
update reduces. f32, weights rtol 1e-5, atol 1e-6 (SGD: the update is
the grad, summed in another order), the skipped step bit for bit.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig

from _torch_dist import run_ranks
from torch_dist_worker import (SCALED_LR, TINY_GPT, ZERO_LR,
                               scaled_batches, zero_batch)

TAGS = ("os", "os_g", "p_g_os", "fleet")


def _np(t):
    return np.asarray(t.numpy())


def _mlp_inputs():
    rs = np.random.RandomState(23)
    return {"mlp.w0": (rs.randn(8, 16) * 0.3).astype(np.float32),
            "mlp.b0": (rs.randn(16) * 0.1).astype(np.float32),
            "mlp.w1": (rs.randn(16, 4) * 0.3).astype(np.float32),
            "mlp.b1": (rs.randn(4) * 0.1).astype(np.float32)}


def _ref_scaled(inputs):
    """The reference's MLP on the whole batches through its GradScaler:
    the losses, the weights after each step and the scale after."""
    nn = paddle.nn
    m = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    for i, lin in enumerate((m[0], m[2])):
        lin.weight.set_value(inputs[f"mlp.w{i}"])
        lin.bias.set_value(inputs[f"mlp.b{i}"])
    opt = paddle.optimizer.SGD(SCALED_LR, parameters=m.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0)
    losses, after = [], []
    for x, y in zip(*scaled_batches()):
        loss = ((m(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        after.append({f"{k}{i}": _np(getattr(lin, name))
                      for i, lin in enumerate((m[0], m[2]))
                      for k, name in (("w", "weight"), ("b", "bias"))})
    return losses, after, float(scaler.get_loss_scaling().numpy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    paddle.seed(31)
    m = GPTForCausalLM(TransformerLMConfig(**TINY_GPT))
    m.train()
    weights = {k: _np(v) for k, v in m.state_dict().items()}
    nodecay = {p.name for n, p in m.named_parameters() if n.endswith("bias")}
    opt = paddle.optimizer.AdamW(
        ZERO_LR, parameters=m.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.1),
        apply_decay_param_fun=lambda name: name not in nodecay)
    ids, labels = (paddle.to_tensor(a) for a in zero_batch())
    losses = []
    for _ in range(3):
        loss = m(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    after = {k: _np(v) for k, v in m.state_dict().items()}
    one = sum(2 * v.size * 4 + 2 * 4 for v in weights.values())
    inputs = {f"zero.{k}": v for k, v in weights.items()}
    inputs.update(_mlp_inputs())
    lines, arrays = run_ranks("zero", 2, tmp_path_factory.mktemp("zero"),
                              inputs)
    return losses, after, one, lines, arrays


@pytest.mark.parametrize("tag", TAGS)
def test_zero_matches_one_process(runs, tag):
    losses, after, _, lines, arrays = runs
    mean = np.mean([line[f"{tag}_losses"] for line in lines], axis=0)
    np.testing.assert_allclose(mean, losses, rtol=1e-5)
    h = TINY_GPT["hidden_size"]
    for r, a in enumerate(arrays):
        for k, v in after.items():
            t = a[f"{tag}.param.{k}"]
            if k.endswith("attn.qkv.bias"):
                np.testing.assert_allclose(t[h:2 * h], v[h:2 * h], rtol=0,
                                           atol=2 * 3 * ZERO_LR, err_msg=k)
                t, v = np.delete(t, np.s_[h:2 * h]), \
                    np.delete(v, np.s_[h:2 * h])
            np.testing.assert_allclose(t, v, rtol=0, atol=1e-2 * ZERO_LR,
                                       err_msg=f"{tag} rank {r} {k}")


@pytest.mark.parametrize("tag", TAGS)
def test_zero_partitions_optimizer_state(runs, tag):
    """Each rank keeps the state of its partition: at most 0.6 of one
    process's bytes, the two together all of it."""
    _, _, one, lines, _ = runs
    got = [line[f"{tag}_state_bytes"] for line in lines]
    assert max(got) <= 0.6 * one, (got, one)
    assert sum(got) == one


def test_zero_partition_balance_and_p_g_os_storage(runs):
    """Paddle's greedy partition by size covers every element once, and
    at p_g_os only a rank's own partition holds storage between steps."""
    _, after, _, lines, _ = runs
    total = sum(v.size for v in after.values())
    for line in lines:
        assert sum(line["os_sizes"]) == total
        assert line["os_freed"] == line["os_g_freed"] == 0
        assert line["p_g_os_freed"] > 0
    assert lines[0]["fleet_kinds"] == ["ShardingParallel", "os_g"]


@pytest.mark.parametrize("tag", TAGS)
def test_zero_holds_its_partitions_grads(runs, tag):
    """After the backward, before the step: at os every rank holds every
    grad (the step all-reduces them); at os_g and p_g_os (fleet's stage
    2 too) each grad has gone to its owner, so a rank holds the grads of
    its partition and no others."""
    _, after, _, lines, _ = runs
    total = sum(v.size for v in after.values())
    for line in lines:
        want = total if tag == "os" else line[f"{tag}_mine"]
        assert line[f"{tag}_grad_elems"] == want, (tag, line)
    if tag != "os":
        assert sum(line[f"{tag}_mine"] for line in lines) == total


@pytest.mark.parametrize("tag", TAGS)
def test_zero_with_a_grad_scaler(runs, tag):
    """ZeRO with a GradScaler against the reference's one-process AMP
    steps (the module's docstring): the scale halves once, the
    overflowing step is skipped on both ranks, the others match."""
    _, _, _, lines, arrays = runs
    ref_losses, ref_after, ref_scale = _ref_scaled(_mlp_inputs())
    assert not np.isfinite(ref_losses[1])
    assert ref_scale == 512.0
    for r, (line, a) in enumerate(zip(lines, arrays)):
        got = line[f"scaled_{tag}_losses"]
        assert np.isfinite(got[1]) == (r == 0), got
        assert line[f"scaled_{tag}_scale"] == ref_scale
        for k in ref_after[0]:
            np.testing.assert_array_equal(a[f"scaled.{tag}.1.{k}"],
                                          a[f"scaled.{tag}.0.{k}"])
        for step in range(3):
            for k, v in ref_after[step].items():
                np.testing.assert_allclose(
                    a[f"scaled.{tag}.{step}.{k}"], v, rtol=1e-5, atol=1e-6,
                    err_msg=f"{tag} rank {r} step {step} {k}")
    mean = np.mean([line[f"scaled_{tag}_losses"] for line in lines], axis=0)
    np.testing.assert_allclose(mean[[0, 2]], np.asarray(ref_losses)[[0, 2]],
                               rtol=1e-5)
