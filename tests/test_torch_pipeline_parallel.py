"""Pipeline parallelism in the port (fleet PipelineParallel,
meta_parallel.pp_layers, the GPT's pp_segments) against the reference,
over gloo processes on the CPU.

The reference runs each model in this process, one program over the
whole batch (its PipelineParallel computes that function on its mesh:
its own tests hold it to the plain model); the port's ranks
(tests/torch_dist_worker.py, suites ``pp`` at pp = 2 and ``pp4`` at pp =
4 and at pp = 2 x mp = 2) each run one stage, 1F1B over the microbatches,
on the reference's weights. Cases: the tiny GPT with 4 blocks, 4
microbatches and ignored labels in the first microbatch only (so each
microbatch's loss must be weighted by its share of the kept tokens), by
SGD with a global-norm clip that acts every step (SGD's update is the
clipped grad, so the clip's norm across the stages shows in the
weights); the same with a GradScaler; 5 blocks (uneven stages) by AdamW;
8 blocks over 4 stages; pp x mp; PipelineLayers of surface layers, one
with an int buffer in its blocks, one recomputed block by block; and the
segmentation of PipelineLayer itself. About 25 s and 20 s for the two spawns.

Tolerances, f32: losses rtol 1e-5; the first step's grads and the SGD
weights rtol 1e-5, atol 1e-6 (the microbatches' grads summed in another
order); AdamW weights atol 1e-2 x lr, the QKV biases' key thirds (true
grad 0) 2 x 3 x lr; the tied embedding's two copies bit-equal.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.meta_parallel import pp_layers as ref_pp
from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig

from _torch_dist import run_ranks
from torch_dist_worker import PP_CLIP, PP_LR, TINY_GPT, pp_batch
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    pp_layers as port_pp)

ADAM_LR = 1e-3


def _np(t):
    return np.asarray(t.numpy())


def _ref_gpt(seed, num_layers, adam=False, steps=3):
    """The reference's tiny GPT: its weights, loss at init, the first
    step's grads, the losses of ``steps`` steps and the weights after."""
    paddle.seed(seed)
    m = GPTForCausalLM(TransformerLMConfig(**dict(TINY_GPT,
                                                  num_layers=num_layers)))
    m.train()
    weights = {k: _np(v) for k, v in m.state_dict().items()}
    clip = paddle.nn.ClipGradByGlobalNorm(PP_CLIP)
    opt = paddle.optimizer.AdamW(ADAM_LR, parameters=m.parameters(),
                                 grad_clip=clip) if adam else \
        paddle.optimizer.SGD(PP_LR, parameters=m.parameters(),
                             grad_clip=clip)
    ids, labels = (paddle.to_tensor(a) for a in pp_batch())
    init_loss = float(m(ids, labels=labels).numpy())
    losses, grads = [], None
    for step in range(steps):
        loss = m(ids, labels=labels)
        loss.backward()
        if step == 0:
            grads = {n: _np(p.grad) for n, p in m.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    after = {k: _np(v) for k, v in m.state_dict().items()}
    return weights, init_loss, grads, losses, after


def _masked_linear_cls():
    class MaskedLinear(paddle.nn.Layer):
        def __init__(self, d):
            super().__init__()
            self.fc = paddle.nn.Linear(d, d)
            self.register_buffer("keep", paddle.to_tensor(
                np.ones((d,), dtype="int32")))

        def forward(self, x):
            from paddle_tpu.ops import math as m
            return self.fc(x) * m.cast(self.keep, "float32")
    return MaskedLinear


def _ref_layer(kind, steps):
    """The reference's PipelineLayer of its own tests, trained in one
    program by SGD 0.1; its parameters in order, data and losses."""
    nn = paddle.nn
    LD = ref_pp.LayerDesc
    paddle.seed(0)
    if kind == "layer":
        descs = [LD(nn.Linear, 8, 16)] + [LD(nn.Linear, 16, 16)] * 4 \
            + [LD(nn.Linear, 16, 4)]
    else:
        ml = _masked_linear_cls()
        descs = [LD(nn.Linear, 8, 16), LD(ml, 16), LD(ml, 16),
                 LD(nn.Linear, 16, 4)]
    pipe = ref_pp.PipelineLayer(layers=descs, num_stages=2,
                                loss_fn=nn.CrossEntropyLoss())
    inputs = {f"{kind}.p{i}": _np(p) for i, p in enumerate(pipe.parameters())}
    x = np.random.RandomState(2).randn(8, 8).astype("float32")
    y = np.random.RandomState(3).randint(0, 4, (8,)).astype("int64")
    inputs.update({f"{kind}.x": x, f"{kind}.y": y})
    opt = paddle.optimizer.SGD(0.1, parameters=pipe.parameters())
    losses = []
    for _ in range(steps):
        loss = pipe.loss(pipe(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return inputs, losses


@pytest.fixture(scope="module")
def ref_cases():
    return {"pp4l": _ref_gpt(21, 4), "pp5l": _ref_gpt(22, 5, adam=True),
            "deep": _ref_gpt(23, 8), "layer": _ref_layer("layer", 5),
            "intbuf": _ref_layer("intbuf", 4)}


def _inputs(ref_cases, tags):
    ids, labels = pp_batch()
    inputs = {"pp.ids": ids, "pp.labels": labels}
    for tag in tags:
        case = ref_cases[tag]
        if tag in ("layer", "intbuf"):
            inputs.update(case[0])
        else:
            inputs.update({f"{tag}.{k}": v for k, v in case[0].items()})
    return inputs


@pytest.fixture(scope="module")
def spawns(ref_cases, tmp_path_factory):
    done = {}

    def get(suite):
        if suite not in done:
            tags = ("pp4l", "pp5l", "layer", "intbuf") if suite == "pp" \
                else ("deep", "pp4l")
            done[suite] = run_ranks(suite, 2 if suite == "pp" else 4,
                                    tmp_path_factory.mktemp(suite),
                                    _inputs(ref_cases, tags))
        return done[suite]
    return get


def _check_weights(a, after, tag, adam=False):
    h = TINY_GPT["hidden_size"]
    for k, v in after.items():
        t = a[f"{tag}.param.{k}"]
        if adam:
            if k.endswith("attn.qkv.bias"):
                np.testing.assert_allclose(t[h:2 * h], v[h:2 * h], rtol=0,
                                           atol=2 * 3 * ADAM_LR, err_msg=k)
                t, v = np.delete(t, np.s_[h:2 * h]), \
                    np.delete(v, np.s_[h:2 * h])
            np.testing.assert_allclose(t, v, rtol=0, atol=1e-2 * ADAM_LR,
                                       err_msg=f"{tag} {k}")
        else:
            np.testing.assert_allclose(t, v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{tag} {k}")


def _stage_grads(a, tag):
    return {k[len(tag) + 6:]: v for k, v in a.items()
            if k.startswith(f"{tag}.grad.")}


def test_labels_ignored_in_one_microbatch_weight_the_loss(spawns, ref_cases):
    """pp = 2, 4 microbatches, -100 in the first only: the loss on both
    ranks, the eval loss, each stage's first grads (the tied embedding's
    after its two copies' grads are summed) and the weights after 3
    clipped SGD steps against the reference's whole-batch program."""
    lines, arrays = spawns("pp")
    _, init_loss, grads, losses, after = ref_cases["pp4l"]
    ids, labels = pp_batch()
    kept = [(labels[i:i + 2] != -100).sum() for i in range(0, 8, 2)]
    assert len(set(kept)) == 2      # the microbatches' shares differ
    seen = set()
    for r, (line, a) in enumerate(zip(lines, arrays)):
        assert line["stage"] == r
        assert line["pp4l_blocks"] == [[0, 1], [2, 3]][r]
        assert line["pp4l_clip"] == "HybridParallelClipGrad"
        np.testing.assert_allclose(line["pp4l_losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(line["pp4l_eval"], init_loss, rtol=1e-5)
        g = _stage_grads(a, "pp4l")
        for k, v in g.items():
            np.testing.assert_allclose(v, grads[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"stage {r} {k}")
        seen |= set(g)
        _check_weights(a, after, "pp4l")
    assert seen == set(grads)
    assert "gpt.word_embeddings.weight" in _stage_grads(arrays[1], "pp4l")


def test_tied_embedding_copies_stay_bit_equal(spawns):
    """The first stage's copy of the tied embedding (its lookup) and the
    last stage's (its head) after 3 steps: the same bits."""
    _, arrays = spawns("pp")
    np.testing.assert_array_equal(arrays[0]["pp4l.wemb"],
                                  arrays[1]["pp4l.wemb"])
    np.testing.assert_array_equal(arrays[0]["pp5l.wemb"],
                                  arrays[1]["pp5l.wemb"])


def _check_held(line, tag, stage, n):
    """A stage holds storage for what it runs and nothing else: its
    blocks (all 12 parameters of each), the embeddings on the first
    stage, the final norm and the tied embedding's copy on the last."""
    held = line[f"{tag}_held"]
    blocks = [k for k in held if k.startswith("gpt.blocks.")]
    assert {int(k.split(".")[2]) for k in blocks} == \
        set(line[f"{tag}_blocks"])
    assert len(blocks) == 12 * len(line[f"{tag}_blocks"])
    ends = set()
    if stage == 0:
        ends |= {"gpt.word_embeddings.weight",
                 "gpt.position_embeddings.weight"}
    if stage == n - 1:
        ends |= {"gpt.word_embeddings.weight", "gpt.ln_f.weight",
                 "gpt.ln_f.bias"}
    assert set(held) - set(blocks) == ends, (stage, held)


def test_each_stage_holds_its_share_of_the_weights(spawns):
    """After construction every stage frees the parameters it does not
    run (pp = 2 with 4 and 5 blocks, pp = 4 with 8: the middle stages
    hold their blocks alone), and the steps, the full state dict and the
    tied embedding's sync run on what is left."""
    lines, _ = spawns("pp")
    for s, line in enumerate(lines):
        for tag in ("pp4l", "pp5l"):
            _check_held(line, tag, s, 2)
    lines, _ = spawns("pp4")
    for s, line in enumerate(lines):
        _check_held(line, "deep", s, 4)


def test_grad_scaler_gives_the_unscaled_steps(spawns):
    """train_batch(scaler=GradScaler(1024)): the grads of the scaled loss
    (a power of two: exact), unscaled and inf-checked over both stages,
    give the plain steps' losses."""
    lines, _ = spawns("pp")
    for line in lines:
        assert line["scaled_losses"] == line["pp4l_losses"][:2]


def test_uneven_blocks_adamw(spawns, ref_cases):
    """5 blocks over 2 stages (3 and 2, the reference's array_split) by
    AdamW with the clip."""
    lines, arrays = spawns("pp")
    _, init_loss, grads, losses, after = ref_cases["pp5l"]
    for r, (line, a) in enumerate(zip(lines, arrays)):
        assert line["pp5l_blocks"] == [[0, 1, 2], [3, 4]][r]
        np.testing.assert_allclose(line["pp5l_losses"], losses, rtol=1e-5)
        _check_weights(a, after, "pp5l", adam=True)


def test_deep_gpt_four_stages(spawns, ref_cases):
    """8 blocks over pp = 4 (2 a stage), 4 microbatches."""
    lines, arrays = spawns("pp4")
    _, init_loss, grads, losses, after = ref_cases["deep"]
    for r, (line, a) in enumerate(zip(lines, arrays)):
        assert line["deep_blocks"] == [2 * r, 2 * r + 1]
        np.testing.assert_allclose(line["deep_losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(line["deep_eval"], init_loss, rtol=1e-5)
        _check_weights(a, after, "deep")
    np.testing.assert_array_equal(arrays[0]["deep.wemb"],
                                  arrays[3]["deep.wemb"])


def test_pipeline_with_tensor_parallel_stages(spawns, ref_cases):
    """pp = 2 x mp = 2: each stage's blocks split over its mp pair, the
    last stage's tied head through the vocab-split fused CE."""
    lines, _ = spawns("pp4")
    _, init_loss, _, losses, _ = ref_cases["pp4l"]
    for line in lines:
        np.testing.assert_allclose(line["ppmp_losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(line["ppmp_eval"], init_loss, rtol=1e-5)


@pytest.mark.parametrize("kind,blocks", [("layer", 4), ("intbuf", 2)])
def test_pipeline_layer_of_surface_layers(spawns, ref_cases, kind, blocks):
    """A PipelineLayer of the Paddle surface's layers, cut as the
    reference cuts it (the longest run of alike blocks; the int buffer
    rides along), trained by SGD through train_batch: the reference's
    losses."""
    lines, _ = spawns("pp")
    _, losses = ref_cases[kind]
    for r, line in enumerate(lines):
        assert line[f"{kind}_blocks"] == blocks
        assert len(line[f"{kind}_stage_blocks"]) == blocks // 2
        np.testing.assert_allclose(line[f"{kind}_losses"], losses,
                                   rtol=1e-5, atol=1e-6)


def test_pipeline_layer_recompute_interval(spawns):
    """recompute_interval = 1: each block recomputed in the backward
    (utils_recompute) gives the same losses, bit for bit."""
    lines, _ = spawns("pp")
    for line in lines:
        assert line["recompute_losses"] == line["layer_losses"]


@pytest.fixture
def on_cpu():
    """The port's current place is the CPU for the test, unset after (a
    place left set would reach later tests in the same worker)."""
    import paddle_tpu_torch as port
    from paddle_tpu_torch.core import device as device_mod
    port.set_device("cpu")
    yield
    device_mod._current_place = None


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("method", ["uniform", "layer:param"])
def test_segment_bounds_match_reference(stages, method, on_cpu):
    """PipelineLayer._segment, uniform and by parameter count, gives the
    reference's bounds over layers of unequal sizes."""
    import paddle_tpu_torch as port
    sizes = [(8, 64), (64, 64), (64, 8), (8, 8), (8, 128), (128, 4)]
    ref = ref_pp.PipelineLayer(
        [ref_pp.LayerDesc(paddle.nn.Linear, a, b) for a, b in sizes],
        num_stages=stages, seg_method=method)
    mine = port_pp.PipelineLayer(
        [port_pp.LayerDesc(port.nn.Linear, a, b) for a, b in sizes],
        num_stages=stages, seg_method=method)
    assert mine.stage_segments() == ref.stage_segments()
