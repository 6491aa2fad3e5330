"""paddle_tpu_torch GPT against the JAX reference on the CPU, with the
same weights carried across by text.convert: forward logits (atol 1e-4,
f32 matmuls summed in another order), the exported decode parameters
and the KV-cache decode math over one prefill and three decode steps,
the conversion round trip, the import boundary of the package, and the
rule that entry points run on the card unless told otherwise."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.ops import attention as jattn
from paddle_tpu.text.models import _decode_forward_builder

from _torch_port import TINY, jax_gpt, numpy_state_dict, torch_twin
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.serving import ServingEngine, SlotKVPool
from paddle_tpu_torch.serving.paged import PagedKVPool
from paddle_tpu_torch.text import models as tmodels
from paddle_tpu_torch.text.convert import (state_dict_from_paddle_tpu,
                                           state_dict_to_paddle_tpu)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def interpret_flash():
    jattn._FORCE_INTERPRET[0] = True
    yield
    jattn._FORCE_INTERPRET[0] = False


def _logits_pair(seq):
    jm = jax_gpt(max_seq_len=max(64, seq))
    tm = torch_twin(jm)
    ids = np.random.RandomState(3).randint(0, 97, (2, seq)).astype(np.int64)
    jl = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids)).numpy()
    return jl, tl


def test_forward_logits_match_reference():
    jl, tl = _logits_pair(16)
    assert tl.shape == (2, 16, 97)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


def test_forward_logits_match_reference_flash_kernel(interpret_flash):
    """At s = 128 the reference forward runs its Pallas flash kernel
    (interpret mode); the port's logits still agree."""
    jl, tl = _logits_pair(128)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


def test_export_decode_params_match_reference():
    jm = jax_gpt()
    tm = torch_twin(jm)
    jp = jm.export_decode_params()
    tp = tm.export_decode_params()
    for k, v in jp["stacked"].items():
        np.testing.assert_array_equal(tp["stacked"][k].numpy(),
                                      np.asarray(v))
    for k in ("wemb", "pemb", "lnf_w", "lnf_b", "head"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # per-layer views alias the stacked tensors
    assert tp["layers"][1]["qkv_w"].data_ptr() == \
        tp["stacked"]["qkv_w"][1].data_ptr()


def test_decode_math_matches_reference_prefill_and_three_steps():
    """One prompt prefill plus three greedy decode steps through the
    decode math (hidden states times the head): logits (atol 1e-4),
    greedy tokens and the written caches agree with the reference's
    _decode_forward_builder."""
    jm = jax_gpt()
    tm = torch_twin(jm)
    c = jm.cfg
    nh, hd, L = c.num_heads, c.hidden_size // c.num_heads, c.num_layers
    total = 24
    prompt = np.random.RandomState(8).randint(0, 97, (1, 9)).astype(np.int32)

    _, jf = _decode_forward_builder(nh, hd, c.hidden_size)
    jparams = jm.export_decode_params()
    jkc = jnp.zeros((L, 1, nh, total, hd), jnp.float32)
    jvc = jnp.zeros_like(jkc)
    _, tf = tmodels.decode_forward_builder(nh, hd, c.hidden_size)
    tparams = tm.export_decode_params()
    tkc = torch.zeros(L, 1, nh, total, hd)
    tvc = torch.zeros_like(tkc)

    tok, pos = prompt, 0
    with torch.no_grad():
        for _ in range(4):
            jl, jkc, jvc = jf(jparams, jnp.asarray(tok), jnp.int32(pos),
                              jkc, jvc)
            tl = tf(tparams, torch.from_numpy(tok.astype(np.int64)), pos,
                    tkc, tvc) @ tparams["head"]
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=1e-4)
            nxt = int(np.asarray(jl)[0, -1].argmax())
            assert int(tl[0, -1].argmax()) == nxt
            pos += tok.shape[1]
            tok = np.array([[nxt]], np.int32)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), atol=1e-5)
    np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), atol=1e-5)


def test_convert_round_trip():
    jm = jax_gpt()
    sd = numpy_state_dict(jm)
    tsd = state_dict_from_paddle_tpu(sd)
    back = state_dict_to_paddle_tpu(tsd)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)
    # paddle Linear [in, out] -> torch [out, in]; embeddings as they are
    assert tuple(tsd["gpt.blocks.0.attn.qkv.weight"].shape) == (96, 32)
    assert tuple(tsd["gpt.word_embeddings.weight"].shape) == (97, 32)
    tm = tmodels.GPTForCausalLM(tmodels.TransformerLMConfig(**TINY),
                                device="cpu")
    assert set(tm.state_dict()) == set(sd)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for module in ("regularizer.py", "optimizer/optimizers.py",
                   "nn/clip.py", "text/models.py", "text/convert.py",
                   "serving/kv_pool.py", "serving/kv_wire.py",
                   "serving/sched/sampling.py", "serving/sched/chunker.py",
                   "serving/sched/policy.py", "serving/sched/programs.py",
                   "serving/spec/drafter.py", "serving/spec/decoder.py",
                   "serving/spec/programs.py", "observability/slo.py",
                   "observability/flight.py",
                   "observability/tenant/ledger.py",
                   "observability/trace/assembler.py",
                   "observability/perf/roofline.py",
                   "observability/perf/attribution.py",
                   "observability/perf/ledger.py",
                   "observability/cache/mrc.py",
                   "observability/cache/heat.py",
                   "observability/cache/observatory.py",
                   "observability/fleet/rollup.py",
                   "observability/fleet/detectors.py",
                   "observability/fleet/poller.py",
                   "observability/fleet/server.py",
                   "analysis/lint.py", "analysis/threads.py",
                   "analysis/concurrency.py", "tools/replica_worker.py",
                   "tools/router_drill.py", "tools/chaos_sweep.py",
                   "tools/fleet_top.py", "core/errors.py", "core/dtype.py",
                   "core/flags.py", "core/device.py", "core/tensor.py",
                   "core/dispatch.py", "core/engine.py",
                   "autograd/__init__.py", "ops/math.py",
                   "ops/reduction.py", "ops/logic.py", "ops/indexing.py",
                   "ops/creation.py", "ops/manipulation.py",
                   "ops/search.py", "ops/nn_ops.py", "nn/initializer.py",
                   "nn/layer_base.py", "nn/layer/__init__.py",
                   "nn/layer/common.py", "nn/layer/activation.py",
                   "nn/layer/container.py", "nn/layer/loss.py",
                   "nn/layer/norm.py", "nn/functional/__init__.py",
                   "nn/__init__.py", "tensor/__init__.py",
                   "tensor/random.py", "tensor/array.py",
                   "tensor/attribute.py", "tensor/to_string.py",
                   "static/__init__.py", "static/program.py",
                   "static/nn.py", "jit/__init__.py", "jit/to_static.py",
                   "jit/dy2static.py", "analysis/birth.py",
                   "core/trace.py", "core/graph_cond.py"):
        assert REPO / "paddle_tpu_torch" / module in files, module
    bad = []
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "paddle_tpu", "ml_dtypes"):
                bad.append((str(f.relative_to(REPO)), name))
    assert not bad, bad


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """With no CUDA and no device argument, the entry points raise
    rather than carry on on the CPU; device='cpu' is the way in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmodels.TransformerLMConfig(**TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.GPTForCausalLM(cfg)
    m = tmodels.GPTForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(m)
    assert ServingEngine(m, device="cpu").device == torch.device("cpu")


def test_pools_need_a_device_without_cuda(monkeypatch):
    """The exported KV pools default to the card as every entry point
    does: without CUDA and without a device they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, kw in ((SlotKVPool, {}), (PagedKVPool, {"block_size": 4})):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(2, 1, 2, 16, 4, **kw)
        assert cls(2, 1, 2, 16, 4, device="cpu", **kw).kc.device \
            == torch.device("cpu")


def test_unported_paths_raise():
    """Tensor and sequence parallelism still raise. The serving knobs
    the port once refused now serve; the reference's invalid
    combinations of them raise its ValueErrors."""
    cfg = tmodels.TransformerLMConfig(**TINY)
    m = tmodels.GPTForCausalLM(cfg, device="cpu")
    for knob in (dict(paged=False), dict(sampling=True),
                 dict(speculative=True), dict(prefill_chunk=8),
                 dict(role="prefill"), dict(role="decode")):
        eng = ServingEngine(m, device="cpu", **knob)
        r = eng.add_request(np.arange(1, 12), max_new_tokens=3)
        eng.run()
        assert r.done and len(r.generated) == 3, knob
    for knob in (dict(speculative=True, sampling=True),
                 dict(role="prefill", paged=False), dict(role="x")):
        with pytest.raises(ValueError):
            ServingEngine(m, device="cpu", **knob)
    with pytest.raises(NotImplementedError):
        tmodels.TransformerLMConfig(use_mp=True)
    with pytest.raises(NotImplementedError):
        tmodels.TransformerLMConfig(use_sp=True)


def test_config_takes_the_reference_keywords():
    """The reference bench's config (``use_flash_attention=True``) is
    written as it is; ``sp_mode`` is stored and checked, both unused."""
    cfg = tmodels.TransformerLMConfig(**TINY, use_flash_attention=True,
                                      sp_mode="ulysses",
                                      tie_embeddings=False)
    assert cfg.use_flash_attention and cfg.sp_mode == "ulysses"
    assert tmodels.TransformerLMConfig().sp_mode == "ring"
    with pytest.raises(ValueError):
        tmodels.TransformerLMConfig(sp_mode="zigzag")


def test_seeded_init_is_reproducible():
    cfg = tmodels.TransformerLMConfig(**TINY)
    a = tmodels.GPTForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(3))
    b = tmodels.GPTForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb)
    w = a.gpt.word_embeddings.weight.detach()
    assert abs(float(w.std()) - cfg.initializer_range) < 0.005
