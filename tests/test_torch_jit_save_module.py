"""``jit.save`` / ``jit.load`` / ``inference.create_predictor`` and
``onnx.export`` of a ``torch.nn.Module``: the port's
``text.models.GPTForCausalLM`` through ``torch.export``, on the CPU,
against its own eager logits and the JAX reference's GPT on the same
weights (carried by ``text.convert``).

- The exported program keeps one node a layer for the attention,
  ``paddle_tpu_torch.flash_attention_forward`` (K1 on the card, its plain
  version here), and no softmax or SDPA node.
- Loaded (``jit.load``, the Predictor, ``fluid.io``) it gives the eager
  model's logits bit for bit at batch 1 and 3 (the spec's ``None`` is a
  ``torch.export.Dim``; the reference bakes batch 1 there).
- Its ``.pdiparams`` hold the reference's names and layout: the
  reference's GPT loads them, and the port's saved model runs a
  ``.pdiparams`` the reference wrote.
- ``onnx.export`` of the module, run by ``tests/test_torch_onnx.py``'s
  numpy evaluator, matches the reference's export of its GPT and the
  port's export of the same GPT written in the Paddle surface, whose
  node types it has; a linear weight's initializer is the reference's
  ``[in, out]`` weight under its structured name.

Tolerances (f32): the loaded model against eager, 0 (the same torch
ops on the same values); against the reference, rtol 2e-4 / atol 2e-4
on logits of a few units (the reference test's bound for its GPT
export).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
import paddle_tpu_torch.inference  # noqa: F401
from paddle_tpu.text.models import GPTForCausalLM as RefGPT
from paddle_tpu.text.models import TransformerLMConfig as RefCfg
from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.text import models as tmodels
from paddle_tpu_torch.text.convert import state_dict_from_paddle_tpu

from _torch_port import numpy_state_dict
from test_torch_deploy_cuda import surface_gpt
from test_torch_jit_save_load import carry
from test_torch_onnx import _load, _run_onnx

RTOL = ATOL = 2e-4
CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=16, dropout=0.0)
SPEC = [paddle.static.InputSpec([None, 16], "int64")]


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def gpts(request):
    ref.seed(3)
    r = RefGPT(RefCfg(tie_embeddings=request.param, **CFG))
    r.eval()
    m = tmodels.GPTForCausalLM(tmodels.TransformerLMConfig(
        tie_embeddings=request.param, **CFG), device="cpu").eval()
    m.load_state_dict(state_dict_from_paddle_tpu(numpy_state_dict(r)))
    return r, m


def _ids(b, seed=0):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (b, 16)).astype(np.int64)


def _eager(m, ids):
    with torch.no_grad():
        return m(torch.from_numpy(ids)).numpy()


def test_exported_graph_keeps_one_k1_node_a_layer(gpts):
    from paddle_tpu_torch.jit.save_load import export_module
    _, m = gpts
    ep = export_module(m, SPEC)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert sum("flash_attention_forward" in t for t in targets) \
        == CFG["num_layers"]
    assert not any("softmax" in t or "scaled_dot_product" in t
                   for t in targets), targets


@pytest.mark.parametrize("b", [1, 3])
def test_jit_load_and_predictor_give_the_eager_logits(gpts, tmp_path, b):
    _, m = gpts
    path = str(tmp_path / "gpt")
    paddle.jit.save(m, path, input_spec=SPEC)
    ids = _ids(b, seed=b)
    want = _eager(m, ids)
    loaded = paddle.jit.load(path, device="cpu")
    assert isinstance(loaded, paddle.jit.save_load.TranslatedModule)
    np.testing.assert_array_equal(loaded(paddle.to_tensor(ids)).numpy(),
                                  want)
    pred = paddle.inference.create_predictor(paddle.inference.Config(path))
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(ids)
    pred.run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(got, want)


def test_feed_checks_the_spec(gpts, tmp_path):
    _, m = gpts
    path = str(tmp_path / "gpt")
    paddle.jit.save(m, path, input_spec=SPEC)
    loaded = paddle.jit.load(path, device="cpu")
    with pytest.raises(ValueError, match="dim 1 is 8"):
        loaded(paddle.to_tensor(np.zeros((2, 8), np.int64)))
    with pytest.raises(ValueError, match="dtype"):
        loaded(paddle.to_tensor(np.zeros((2, 16), np.int32)))


def test_pdiparams_cross_with_the_reference(gpts, tmp_path):
    r, m = gpts
    path = str(tmp_path / "gpt")
    paddle.jit.save(m, path, input_spec=SPEC)
    ids = _ids(2, seed=5)
    # the port's file into the reference's GPT
    r2 = RefGPT(r.cfg)
    r2.eval()
    assert r2.set_state_dict(ref.load(path + ".pdiparams")) == []
    np.testing.assert_allclose(
        np.asarray(r2(ref.to_tensor(ids)).numpy()), _eager(m, ids),
        rtol=RTOL, atol=ATOL)
    # the reference's weights (other values) under the port's program
    ref.seed(11)
    r3 = RefGPT(r.cfg)
    r3.eval()
    ref.save(r3.state_dict(), path + ".pdiparams")
    got = paddle.jit.load(path, device="cpu")(paddle.to_tensor(ids))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(r3(ref.to_tensor(ids)).numpy()),
                               rtol=RTOL, atol=ATOL)


def test_fluid_io_takes_the_module(gpts, tmp_path):
    _, m = gpts
    path = str(tmp_path / "fluid_gpt")
    paddle.fluid.io.save_inference_model(path, model=m, input_spec=SPEC)
    ids = _ids(2, seed=7)
    got = paddle.fluid.io.load_inference_model(path)(paddle.to_tensor(ids))
    np.testing.assert_array_equal(got.numpy(), _eager(m, ids))
    with pytest.raises(ValueError, match="torch.export program"):
        paddle.static.load_inference_model(path)


def test_onnx_export_matches_reference_and_surface(gpts, tmp_path):
    r, m = gpts
    ids = _ids(1, seed=9)
    port = _load(paddle.onnx.export(m, str(tmp_path / "port"),
                                    input_spec=SPEC))
    theirs = _load(ref.onnx.export(
        r, str(tmp_path / "ref"),
        input_spec=[ref.static.InputSpec([None, 16], "int64")]), ref)
    got, = _run_onnx(port, [ids])
    np.testing.assert_allclose(got, _eager(m, ids), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _run_onnx(theirs, [ids])[0],
                               rtol=RTOL, atol=ATOL)
    surf = surface_gpt(paddle, RefCfg(tie_embeddings=r.cfg.tie_embeddings,
                                      **CFG))
    carry(r, surf)
    surf.eval()
    s_model = _load(paddle.onnx.export(surf, str(tmp_path / "surf"),
                                       input_spec=SPEC))
    assert {n.op_type for n in port.graph.node} \
        == {n.op_type for n in s_model.graph.node}
    ops = [n.op_type for n in port.graph.node]
    assert ops.count("Softmax") == ops.count("Where") == CFG["num_layers"]
    inits = {t.name: t for t in port.graph.initializer}
    w = inits["gpt.blocks.0.attn.qkv.weight"]
    np.testing.assert_array_equal(
        np.frombuffer(w.raw_data, np.float32).reshape(list(w.dims)),
        np.asarray(r.gpt.blocks[0].attn.qkv.weight.numpy()))
    assert "gpt.position_embeddings.weight" not in inits   # folded


def test_unmapped_aten_op_raises_naming_it(tmp_path):
    class Cum(torch.nn.Module):
        def forward(self, x):
            return torch.cumsum(x, 1)
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        paddle.onnx.export(Cum(), str(tmp_path / "c"), input_spec=[
            paddle.static.InputSpec([1, 4], "float32")])
