"""Tensor parallelism in the port (distributed.fleet.meta_parallel,
the vocab-split fused cross-entropy, the GPT's ``use_mp``) against the
reference, over gloo processes on the CPU.

The reference runs here on a mesh over ``jax.devices()[:n]`` (its
HybridCommunicateGroup with ``mp = n``) and holds whole weights; the
port's ranks (tests/torch_dist_worker.py, suite ``tp``) hold shards,
loaded from the reference's weights through
``text.convert.tp_state_dict_from_paddle_tpu``, and gather their grads
and weights whole to be compared. Two spawns: ``mp = 2`` (the layers,
the fused CE, the tiny GPT tied and untied) and ``mp = 4`` (the fused
CE), about 15 s and 10 s.

Tolerances, f32 without TF32:
- the layers and the TP fused CE through the reference's composition:
  rtol 1e-5, atol 1e-6 (the same sums split over the ranks);
- the TP fused CE against the reference's Pallas kernels in interpret
  mode: rtol 1e-4, atol 1e-6 (the kernel sums 128-wide vocab tiles
  online, the plain version in one logsumexp);
- the GPT: loss and every gathered grad rtol 1e-5, atol 1e-6; 3 AdamW
  steps: losses rtol 1e-5, weights atol 1e-2 x lr (Adam's step is
  lr x m / sqrt(v), normalised: a grad summed over the ranks in another
  order moves a weight by lr times its relative change, up to about
  1e-3 on the grads of small magnitude, in each of 3 steps), except the
  key third of each QKV bias (true grad 0, rounding noise on both sides
  that the normalised step turns into up to lr a step: 2 x 3 x lr).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import topology as ref_topology
from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as ref_mp
from paddle_tpu.ops import fused_ce as ref_ce
from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig

from _torch_dist import run_ranks
from torch_dist_worker import TINY_GPT, gpt_batch, tp_ce_inputs
from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
from paddle_tpu_torch.text import convert

LR = 1e-3
CLIP = 0.1      # below the tiny GPT's grad norm: the clip acts every step
CE_SHAPES = {"comp": (64, 32, 64), "pallas": (128, 128, 1024)}


def _ref_hcg(mp):
    mesh = ref_topology.build_mesh(mp=mp, devices=jax.devices()[:mp])
    return ref_topology.HybridCommunicateGroup(mesh=mesh, mp=mp)


def _np(t):
    return np.asarray(t.numpy())


def _ce_mesh(n):
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]).reshape(1, n), ("dp", "mp"))


def _ref_tp_ce(n, tag):
    """The reference's _tp_fwd_impl / _tp_bwd_impl on an mp = n mesh."""
    t, h, v_local = CE_SHAPES[tag]
    x, w, lab, g = tp_ce_inputs(t, h, v_local * n, seed=n)
    key = ref_ce._register_mesh(_ce_mesh(n))
    ref_ce._FORCE_INTERPRET[0] = tag == "pallas"
    try:
        if tag == "pallas":
            assert ref_ce._use_pallas(np.zeros((t, h), np.float32),
                                      np.zeros((v_local, h), np.float32),
                                      tp=True)
        loss, lse = ref_ce._tp_fwd_impl(x, w, lab, key, -100)
        dx, dw = ref_ce._tp_bwd_impl(x, w, lab, lse, g, key, -100)
    finally:
        ref_ce._FORCE_INTERPRET[0] = False
    return (x, w, lab, g), {k: np.asarray(a) for k, a in
                            zip(("loss", "lse", "dx", "dw"),
                                (loss, lse, dx, dw))}


def _ref_layers():
    """The reference's column/row pair, vocab-split embedding and
    parallel CE under its mp = 2 mesh, run eagerly with cotangents."""
    hcg = _ref_hcg(2)
    try:
        paddle.seed(3)
        rs = np.random.RandomState(4)
        col = ref_mp.ColumnParallelLinear(8, 16, gather_output=False)
        row = ref_mp.RowParallelLinear(16, 4, input_is_parallel=True)
        col.bias.set_value(rs.randn(16).astype(np.float32))
        row.bias.set_value(rs.randn(4).astype(np.float32))
        x_np = rs.randn(4, 8).astype(np.float32)
        cot = rs.randn(4, 4).astype(np.float32)
        x = paddle.to_tensor(x_np, stop_gradient=False)
        y = row(col(x))
        (y * paddle.to_tensor(cot)).sum().backward()
        emb = ref_mp.VocabParallelEmbedding(16, 8)
        ids = np.array([[0, 3, 8, 15], [9, 7, 1, 12]], np.int64)
        ecot = rs.randn(2, 4, 8).astype(np.float32)
        e = emb(paddle.to_tensor(ids))
        (e * paddle.to_tensor(ecot)).sum().backward()
        logits_np = rs.randn(6, 16).astype(np.float32)
        labels = np.array([[0], [9], [-100], [15], [4], [8]], np.int64)
        logits = paddle.to_tensor(logits_np, stop_gradient=False)
        loss = ref_mp.ParallelCrossEntropy()(logits, paddle.to_tensor(labels))
        loss.sum().backward()
        inputs = {"mlp.x": x_np, "mlp.cot": cot,
                  "mlp.w1": _np(col.weight), "mlp.b1": _np(col.bias),
                  "mlp.w2": _np(row.weight), "mlp.b2": _np(row.bias),
                  "emb.w": _np(emb.weight), "emb.ids": ids, "emb.cot": ecot,
                  "pce.logits": logits_np, "pce.labels": labels}
        want = {"mlp.y": _np(y), "mlp.dx": _np(x.grad),
                "mlp.dw1": _np(col.weight.grad),
                "mlp.db1": _np(col.bias.grad),
                "mlp.dw2": _np(row.weight.grad),
                "mlp.db2": _np(row.bias.grad), "emb.y": _np(e),
                "emb.dw": _np(emb.weight.grad), "pce.loss": _np(loss),
                "pce.dlogits": _np(logits.grad)}
    finally:
        ref_topology._HYBRID = None
    return inputs, want


def _ref_gpt(tie):
    """The reference GPT with use_mp on its mp = 2 mesh: its weights,
    step-1 loss and grads, 3 AdamW steps' losses and the weights after."""
    hcg = _ref_hcg(2)
    try:
        paddle.seed(11)
        m = GPTForCausalLM(TransformerLMConfig(use_mp=True,
                                               tie_embeddings=tie,
                                               **TINY_GPT))
        m.train()
        weights = {k: _np(v) for k, v in m.state_dict().items()}
        opt = paddle.optimizer.AdamW(
            LR, parameters=m.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
        ids, labels = gpt_batch()
        losses, grads = [], None
        for step in range(3):
            loss = m(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
            loss.backward()
            if step == 0:
                grads = {n: _np(p.grad) for n, p in m.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        after = {k: _np(v) for k, v in m.state_dict().items()}
    finally:
        ref_topology._HYBRID = None
    return weights, grads, losses, after


@pytest.fixture(scope="module")
def ref_cases():
    layers_in, layers_want = _ref_layers()
    gpts = {tie: _ref_gpt(tie) for tie in (False, True)}
    ces = {(n, tag): _ref_tp_ce(n, tag) for n in (2, 4)
           for tag in ("comp", "pallas")}
    return layers_in, layers_want, gpts, ces


def _inputs(n, ref_cases):
    layers_in, _, gpts, ces = ref_cases
    inputs = {}
    for tag in ("comp", "pallas"):
        for k, a in zip("xwlg", ces[(n, tag)][0]):
            inputs[f"ce{n}.{tag}.{k}"] = a
    if n == 2:
        inputs.update(layers_in)
        for tie, (weights, *_rest) in gpts.items():
            label = "tied" if tie else "untied"
            inputs.update({f"{label}.{k}": v for k, v in weights.items()})
    return inputs


@pytest.fixture(scope="module")
def spawns(ref_cases, tmp_path_factory):
    done = {}

    def get(n):
        if n not in done:
            done[n] = run_ranks("tp", n, tmp_path_factory.mktemp(f"tp{n}"),
                                _inputs(n, ref_cases))
        return done[n]
    return get


def test_topology_of_the_ranks(spawns):
    lines, _ = spawns(2)
    for r, line in enumerate(lines):
        assert (line["mp_rank"], line["mp_size"], line["dp_size"]) \
            == (r, 2, 1)


def test_rng_tracker_shares_the_model_parallel_stream(spawns):
    """RNGStatesTracker: under its model-parallel stream both mp ranks
    draw the same dropout mask; outside it each rank's own default
    generator is back and their masks differ."""
    _, arrays = spawns(2)
    a, b = arrays
    np.testing.assert_array_equal(a["rng.shared"], b["rng.shared"])
    assert (a["rng.own"] != b["rng.own"]).any()
    assert bool(a["rng.restored"]) and bool(b["rng.restored"])


def test_mp_layers_match_reference(spawns, ref_cases):
    """Column + Row parallel (the Megatron pair), the gathered-output and
    split-input forms, VocabParallelEmbedding and ParallelCrossEntropy:
    outputs and gathered grads against the reference's layers
    (test_distributed.py's test_tp_layers_match_dense /
    test_tp_training_grads_match_dense, here with the grads of every
    weight)."""
    _, arrays = spawns(2)
    _, want, _, _ = ref_cases
    for r, a in enumerate(arrays):
        for k in ("mlp.y", "mlp.dx", "mlp.dw1", "mlp.db1", "mlp.dw2",
                  "mlp.db2", "emb.y", "emb.dw", "pce.loss"):
            np.testing.assert_allclose(a[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(a["mlp.y_gathered"], want["mlp.y"],
                                   rtol=1e-5, atol=1e-6)
        per = want["pce.dlogits"].shape[1] // 2
        np.testing.assert_allclose(
            a["pce.dlogits"], want["pce.dlogits"][:, r * per:(r + 1) * per],
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("tag", ["comp", "pallas"])
def test_tp_fused_ce_matches_reference(spawns, ref_cases, n, tag):
    """The TP fused CE's plain path (per-shard forward with shifted labels
    and the hit mask, the max/sum combine; the per-shard backward with the
    global LSE) against the reference's _tp_fwd_impl/_tp_bwd_impl, through
    its composition and through its Pallas kernels in interpret mode;
    labels in every shard and ignored rows. Also the autograd op's grads
    of sum(loss * g)."""
    _, arrays = spawns(n)
    (_, _, lab, _), want = ref_cases[3][(n, tag)]
    per = want["dw"].shape[0] // n
    assert (lab == -100).any()
    assert len({int(v) // per for v in lab if v >= 0}) == n
    tol = dict(rtol=1e-5, atol=1e-6) if tag == "comp" \
        else dict(rtol=1e-4, atol=1e-6)
    for r, a in enumerate(arrays):
        for k in ("loss", "lse", "dx"):
            np.testing.assert_allclose(a[f"ce.{tag}.{k}"], want[k],
                                       err_msg=f"rank {r} {k}", **tol)
        np.testing.assert_allclose(a[f"ce.{tag}.autograd_dx"], want["dx"],
                                   **tol)
        mine = want["dw"][r * per:(r + 1) * per]
        np.testing.assert_allclose(a[f"ce.{tag}.dw"], mine, **tol)
        np.testing.assert_allclose(a[f"ce.{tag}.autograd_dw"], mine, **tol)
        assert (a[f"ce.{tag}.loss"][lab == -100] == 0).all()


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_gpt_mp2_matches_reference(spawns, ref_cases, tie):
    """The tiny GPT with use_mp=True at mp = 2 (the tied head through the
    vocab-split fused CE): both ranks' loss and every gathered grad
    against the reference's at its mp = 2 mesh, then 3 AdamW steps with
    a global-norm clip (HybridParallelOptimizer: the norm over the whole
    model across the mp ranks) against the reference's."""
    lines, arrays = spawns(2)
    _, ref_grads, ref_losses, ref_after = ref_cases[2][tie]
    label = "tied" if tie else "untied"
    h = TINY_GPT["hidden_size"]
    for r, (line, a) in enumerate(zip(lines, arrays)):
        np.testing.assert_allclose(line[f"{label}_losses"], ref_losses,
                                   rtol=1e-5)
        assert line[f"{label}_clip"] == "HybridParallelClipGrad"
        assert line[f"{label}_shard_is_mine"]
        grads = {k[len(label) + 6:]: v for k, v in a.items()
                 if k.startswith(f"{label}.grad.")}
        assert set(grads) == set(ref_grads)
        for k, g in ref_grads.items():
            np.testing.assert_allclose(grads[k], g, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        for k, v in ref_after.items():
            t = a[f"{label}.param.{k}"]
            if k.endswith("attn.qkv.bias"):
                np.testing.assert_allclose(t[h:2 * h], v[h:2 * h], rtol=0,
                                           atol=2 * 3 * LR, err_msg=k)
                t, v = np.delete(t, np.s_[h:2 * h]), \
                    np.delete(v, np.s_[h:2 * h])
            np.testing.assert_allclose(t, v, rtol=0, atol=1e-2 * LR,
                                       err_msg=f"rank {r} {k}")


def test_gpt_runs_on_the_groups_it_was_built_under(spawns, ref_cases):
    """A use_mp model keeps the mp group its shards were cut for: built
    under mp = 2 and run after topology.reset() it still gives the
    reference's first loss (not the dense fused CE over its shard), and
    one built with no topology and run under a later mp = 2 fleet.init
    stays dense (not the TP route over the whole table)."""
    lines, _ = spawns(2)
    ref_loss = ref_cases[2][True][2][0]
    for line in lines:
        assert line["dense_is_dense"]
        np.testing.assert_allclose(line["split_loss_after_reset"], ref_loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(line["dense_loss_under_mp2"], ref_loss,
                                   rtol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_qkv_permutation_round_trip(n):
    """tp_state_dict_from_paddle_tpu gives rank r q, k and v of its own
    heads; tp_state_dict_to_paddle_tpu takes the ranks' shards back to the
    reference's layout, bit for bit."""
    paddle.seed(5)
    m = GPTForCausalLM(TransformerLMConfig(**TINY_GPT))
    ref = {k: _np(v) for k, v in m.state_dict().items()}
    shards = [convert.tp_state_dict_from_paddle_tpu(ref, r, n)
              for r in range(n)]
    back = convert.tp_state_dict_to_paddle_tpu(shards)
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    h, nh = TINY_GPT["hidden_size"], TINY_GPT["num_heads"]
    hd = h // nh
    qkv = ref["gpt.blocks.0.attn.qkv.weight"]      # [in, 3h], paddle
    for r, s in enumerate(shards):
        local = s["gpt.blocks.0.attn.qkv.weight"].numpy()   # [3h/n, in]
        heads = slice(r * (nh // n) * hd, (r + 1) * (nh // n) * hd)
        for c in range(3):      # q, k, v of this rank's heads
            blk = local[c * h // n:(c + 1) * h // n]
            np.testing.assert_array_equal(
                blk, qkv[:, c * h:(c + 1) * h][:, heads].T)


def test_mp_layers_state_dict_is_whole_in_one_process():
    """With no mp group the layers hold the whole weight; state_dict /
    load_state_dict are the dense layers' (a whole checkpoint loads into
    any topology)."""
    col = mp_layers.ColumnParallelLinear(8, 12, chunks=3)
    dense = torch.nn.Linear(8, 12)
    col.load_state_dict(dense.state_dict())
    x = torch.randn(2, 8)
    torch.testing.assert_close(col(x), dense(x))
    assert mp_layers.split_of(col.weight).full_shape == (12, 8)
    assert col.state_dict().keys() == dense.state_dict().keys()


@pytest.mark.parametrize("degrees,t,v", [
    (dict(mp=2), 64, 256), (dict(mp=2), 64, 255), (dict(dp=2, mp=2), 63, 256),
    (dict(dp=2, mp=2), 64, 256), (dict(pp=2, mp=2), 64, 256),
    (dict(dp=4), 64, 256), (dict(mp=4, sp=2), 64, 256)])
def test_tp_fused_applicable_decides_as_the_reference(degrees, t, v):
    """tp_fused_applicable on the port's mesh of ranks gives the
    reference's answer on its device mesh of the same degrees."""
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.ops import fused_ce
    n = int(np.prod(list(degrees.values())))
    mine = topology.build_mesh(world_size=n, **degrees)
    ref = ref_topology.build_mesh(devices=jax.devices()[:n], **degrees)
    assert fused_ce.tp_fused_applicable(mine, t, 32, v) \
        == ref_ce.tp_fused_applicable(ref, t, 32, v)
    assert fused_ce.tp_fused_applicable(None, t, 32, v) is False
