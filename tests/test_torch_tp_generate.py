"""Decoding a GPT built for tensor parallelism (``use_mp``): two gloo
ranks on the CPU (tests/torch_dist_worker.py, suite ``tpgen``) each hold
their shards of the reference's weights, split by
``text.convert.tp_state_dict_from_paddle_tpu``, and decode greedily.
``export_decode_params`` gathers the split weights whole, so every rank
gives the reference ``GPTForCausalLM.generate``'s tokens, token for
token, through ``generate()`` and through the ``ServingEngine``'s
stream. About 10 s.

Tolerance: none, the tokens are equal (both packages decode in f32 from
the same weights).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig

from _torch_dist import run_ranks
from torch_dist_worker import TPGEN_GPT, TPGEN_NEW


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    paddle.seed(11)
    ref = GPTForCausalLM(TransformerLMConfig(**TPGEN_GPT))
    ref.eval()
    prompts = np.random.RandomState(3).randint(
        0, TPGEN_GPT["vocab_size"], (3, 6)).astype(np.int64)
    want = np.asarray(ref.generate(paddle.to_tensor(prompts),
                                   max_new_tokens=TPGEN_NEW,
                                   temperature=0.0).numpy())
    inputs = {f"gen.{k}": np.asarray(v.numpy())
              for k, v in ref.state_dict().items()}
    inputs["prompts"] = prompts
    lines, arrays = run_ranks("tpgen", 2, tmp_path_factory.mktemp("tpgen"),
                              inputs)
    return prompts, want, lines, arrays


def test_each_rank_holds_shards(decoded):
    _, _, lines, _ = decoded
    assert [ln["mp_rank"] for ln in lines] == [0, 1]
    assert all(ln["split"] for ln in lines)


@pytest.mark.parametrize("rank", [0, 1])
def test_generate_gives_the_reference_tokens(decoded, rank):
    _, want, _, arrays = decoded
    np.testing.assert_array_equal(arrays[rank]["generate"], want)


@pytest.mark.parametrize("rank", [0, 1])
def test_engine_stream_gives_the_reference_tokens(decoded, rank):
    prompts, want, _, arrays = decoded
    np.testing.assert_array_equal(arrays[rank]["engine"],
                                  want[:, prompts.shape[1]:])
