"""GPT-3 1.3B in the port (``text.models.gpt3_1p3b``, the reference's
BASELINE config 5) against the reference's, on the CPU, without 1.3 B
weights in either package.

* The config: ``gpt3_1p3b()`` of both packages builds the same
  ``TransformerLMConfig`` (each package's model class swapped for one
  that returns its config, so nothing is allocated): 24 layers, hidden
  2048, 16 heads of 128, vocab 50304, 1024 positions, tied head.
* The parameter count: the port's full model built on torch's ``meta``
  device (shapes, no storage) against the reference's count of a
  1-layer model at full width, with the embeddings and the other 23
  blocks added up from its own shapes: 1,313,722,368 both.
* One block at gpt3_1p3b's widths (hidden 2048, 16 heads of 128; vocab
  256, 32 positions, so a config of its own), the reference's weights
  carried in through ``text.convert``: the loss at atol/rtol 1e-5 and
  every grad at atol 2e-6, rtol 1e-4 (``tests/test_torch_training.py``'s
  f32 tolerances: the same model summed in another order).
* Without CUDA, ``gpt3_1p3b()`` raises unless ``device="cpu"`` is
  given, as every entry point of the port does.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.text import models as ref_models

from _torch_port import numpy_state_dict
from paddle_tpu_torch.text import models as tmodels
from paddle_tpu_torch.text.convert import (state_dict_from_paddle_tpu,
                                           state_dict_to_paddle_tpu)

KEYS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
        "intermediate_size", "max_seq_len", "dropout", "tie_embeddings",
        "use_flash_attention", "initializer_range", "recompute", "use_mp")
N_PARAMS = 1_313_722_368
WIDTHS = dict(hidden_size=2048, num_heads=16)     # gpt3_1p3b's


def _configs(monkeypatch):
    monkeypatch.setattr(ref_models, "GPTForCausalLM", lambda cfg: cfg)
    monkeypatch.setattr(tmodels, "GPTForCausalLM", lambda cfg, *a: cfg)
    return ref_models.gpt3_1p3b(), tmodels.gpt3_1p3b()


def test_config_matches_reference(monkeypatch):
    rc, tc = _configs(monkeypatch)
    for k in KEYS:
        assert getattr(tc, k) == getattr(rc, k), k
    assert (tc.num_layers, tc.hidden_size, tc.num_heads) == (24, 2048, 16)
    assert tc.hidden_size // tc.num_heads == 128
    assert tc.vocab_size == 50304 and tc.tie_embeddings


def test_parameter_count_matches_reference(monkeypatch):
    ref.seed(0)
    one = ref_models.GPTForCausalLM(ref_models.TransformerLMConfig(
        **{**WIDTHS, "num_layers": 1, "vocab_size": 8, "max_seq_len": 8}))
    shapes = {n: tuple(p.shape) for n, p in one.named_parameters()}
    block = sum(int(np.prod(s)) for n, s in shapes.items()
                if n.startswith("gpt.blocks.0."))
    rest = sum(int(np.prod(s)) for n, s in shapes.items()
               if not n.startswith("gpt.blocks.") and "embeddings" not in n)
    h = 2048
    ref_count = 50304 * h + 1024 * h + 24 * block + rest
    del one
    # the port's whole model on the meta device: shapes, no storage
    monkeypatch.setattr(tmodels, "resolve_device",
                        lambda device=None: torch.device("meta"))
    monkeypatch.setattr(tmodels.GPTForCausalLM, "init_weights",
                        lambda self, generator=None: None)
    model = tmodels.gpt3_1p3b()
    assert all(p.device.type == "meta" for p in model.parameters())
    count = sum(p.numel() for p in model.parameters())
    assert count == ref_count == N_PARAMS


def test_one_block_at_full_width_loss_and_grads():
    ref.seed(4)
    small = {**WIDTHS, "num_layers": 1, "vocab_size": 256,
             "max_seq_len": 32, "dropout": 0.0}
    jm = ref_models.GPTForCausalLM(ref_models.TransformerLMConfig(**small))
    tm = tmodels.GPTForCausalLM(tmodels.TransformerLMConfig(**small),
                                device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(numpy_state_dict(jm)))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (2, 16)).astype(np.int64)
    labels = rs.randint(0, 256, (2, 16)).astype(np.int64)
    labels[rs.rand(2, 16) < 0.3] = -100
    jloss = jm(ref.to_tensor(ids), labels=ref.to_tensor(labels))
    jloss.backward()
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tloss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tloss.backward()
    tg = state_dict_to_paddle_tpu({n: p.grad
                                   for n, p in tm.named_parameters()})
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               atol=1e-5, rtol=1e-5)
    assert set(tg) == set(jg)
    for name, g in jg.items():
        np.testing.assert_allclose(tg[name], g, atol=2e-6, rtol=1e-4,
                                   err_msg=name)


def test_raises_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.gpt3_1p3b()     # raises before any weight is made
