"""Shared fixtures of the paddle_tpu_torch parity tests: the tiny GPT of
tests/test_paged_serving.py built in the JAX reference, and its twin in
the port carrying the same weights through text.convert."""
import numpy as np

import paddle_tpu as paddle
from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig
from paddle_tpu_torch.text import models as tmodels
from paddle_tpu_torch.text.convert import state_dict_from_paddle_tpu

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.0)


def jax_gpt(seed=7, **overrides):
    paddle.seed(seed)
    m = GPTForCausalLM(TransformerLMConfig(**{**TINY, **overrides}))
    m.eval()
    return m


def numpy_state_dict(jax_model):
    return {k: np.asarray(v.numpy())
            for k, v in jax_model.state_dict().items()}


def torch_twin(jax_model):
    """The port's GPT on the CPU with the reference model's weights."""
    c = jax_model.cfg
    cfg = tmodels.TransformerLMConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        num_layers=c.num_layers, num_heads=c.num_heads,
        max_seq_len=c.max_seq_len, dropout=c.dropout,
        tie_embeddings=c.tie_embeddings, recompute=c.recompute)
    tm = tmodels.GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(
        numpy_state_dict(jax_model)))
    return tm.eval()
