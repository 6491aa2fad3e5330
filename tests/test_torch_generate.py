"""``GPTForCausalLM.generate()`` of the port against the JAX reference's
on the CPU, over the same weights: greedy and beam search token for
token, sampling by its distribution and its determinism per seed, the
reference's argument errors, and greedy against the port's own
``ServingEngine``. Prompts are numpy arrays from a seed.

Tolerances:
- greedy and beam search: the same tokens as the reference (both decode
  in f32 from the same weights; no top-2 margin here is near the 1e-6
  the two packages' sums differ by);
- sampling draws from a ``torch.Generator``, not ``jax.random``, so it
  is held to determinism per seed, not to the reference's tokens: every
  token's teacher-forced logit at or above the k-th largest less 1e-5
  (the forward and the decode math sum in another order), and over 2000
  draws of the first token a chi-square statistic below its 0.999
  quantile against ``softmax(logits / T)`` (bins of expected count
  below 5 pooled).
"""
import numpy as np
import pytest
import torch
from scipy.stats import chi2

import paddle_tpu as paddle

from _torch_port import TINY, jax_gpt, torch_twin
from paddle_tpu_torch.serving import ServingEngine

V = TINY["vocab_size"]
MAX = TINY["max_seq_len"]


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


@pytest.fixture(scope="module")
def peaked():
    """The tiny GPT with weights N(0, 0.3): its logits spread over a few
    units, so a draw at the wrong temperature fails the chi-square test
    (at 0.02 the softmax is near uniform and would not)."""
    jm = jax_gpt(initializer_range=0.3)
    return jm, torch_twin(jm)


def _prompt(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, V, (b, s)).astype(np.int64)


def _jax_generate(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


@pytest.mark.parametrize("n_new", [1, 8, MAX - 5])
@pytest.mark.parametrize("b", [1, 2])
def test_greedy_matches_reference(models, b, n_new):
    """Greedy (``temperature=0``, and ``top_k=1``) gives the reference's
    tokens, up to a sequence of max_seq_len; int64 on the model's
    device, the prompt first."""
    jm, tm = models
    ids = _prompt(b, 5, seed=b)
    want = _jax_generate(jm, ids, max_new_tokens=n_new, temperature=0.0)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=n_new,
                      temperature=0.0)
    assert got.dtype == torch.int64 and got.device == tm.device
    assert got.shape == (b, 5 + n_new)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tm.generate(ids, max_new_tokens=n_new, top_k=1, seed=4).numpy(),
        want)


@pytest.mark.parametrize("weights", ["models", "peaked"])
@pytest.mark.parametrize("beams", [2, 3])
def test_beam_search_matches_reference(request, weights, beams):
    """Beam search gives the reference's best beam, over near-uniform
    logits (init 0.02) and spread ones (0.3)."""
    jm, tm = request.getfixturevalue(weights)
    ids = _prompt(2, 6, seed=3)
    want = _jax_generate(jm, ids, max_new_tokens=10, num_beams=beams)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=10,
                      num_beams=beams)
    np.testing.assert_array_equal(got.numpy(), want)
    # a one-token search is the top log-prob
    one = tm.generate(ids, max_new_tokens=1, num_beams=beams)
    np.testing.assert_array_equal(
        one.numpy(), _jax_generate(jm, ids, max_new_tokens=1,
                                   num_beams=beams))


def test_sampling_is_deterministic_per_seed_and_within_top_k(peaked):
    """The same seed gives the same tokens, another seed others; every
    sampled token lies within the top-k of the teacher-forced logits
    (ties at the k-th value kept)."""
    _, tm = peaked
    ids = torch.from_numpy(_prompt(2, 4, seed=5))
    kw = dict(max_new_tokens=20, temperature=0.8, top_k=5)
    a = tm.generate(ids, seed=1, **kw)
    np.testing.assert_array_equal(a.numpy(),
                                  tm.generate(ids, seed=1, **kw).numpy())
    assert not torch.equal(a, tm.generate(ids, seed=2, **kw))
    with torch.no_grad():
        logits = tm(a[:, :-1])[:, 3:]            # the logits of each draw
    kth = logits.topk(5, dim=-1).values[..., -1]
    drawn = logits.gather(-1, a[:, 4:, None])[..., 0]
    assert bool((drawn >= kth - 1e-5).all())
    # top_k larger than the vocab is the full vocab
    full = tm.generate(ids, seed=1, max_new_tokens=20, temperature=0.8,
                       top_k=V + 50)
    np.testing.assert_array_equal(
        full.numpy(), tm.generate(ids, seed=1, max_new_tokens=20,
                                  temperature=0.8).numpy())


@pytest.mark.parametrize("top_k", [0, 7])
def test_first_token_frequencies_follow_the_softmax(peaked, top_k):
    """2000 rows of one prompt, one new token each: the counts against
    ``softmax(logits / 0.8)`` over the top-k (all 97 for 0), by a
    chi-square test at the 0.999 quantile; no draw outside the top-k."""
    _, tm = peaked
    n, temp = 2000, 0.8
    prompt = _prompt(1, 6, seed=9)
    ids = torch.from_numpy(np.repeat(prompt, n, axis=0))
    out = tm.generate(ids, max_new_tokens=1, temperature=temp, top_k=top_k,
                      seed=3)
    counts = np.bincount(out[:, -1].numpy(), minlength=V)
    with torch.no_grad():
        lg = tm(torch.from_numpy(prompt))[0, -1].double() / temp
    keep = np.ones(V, bool)
    if top_k:
        keep[:] = False
        keep[lg.topk(top_k).indices.numpy()] = True
        assert counts[~keep].sum() == 0
    p = torch.softmax(lg.masked_fill(torch.from_numpy(~keep), -np.inf),
                      0).numpy()
    expected = n * p
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    stat = float(((obs - exp) ** 2 / exp).sum())
    assert stat < chi2.ppf(0.999, len(exp) - 1), stat


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=MAX),                         # past max_seq_len
    dict(max_new_tokens=4, num_beams=0),
    dict(max_new_tokens=4, num_beams=V + 1),
    dict(max_new_tokens=4, num_beams=2, temperature=0.5),
    dict(max_new_tokens=4, num_beams=2, top_k=3),
    dict(max_new_tokens=4, num_beams=2, seed=1),
], ids=["too_long", "no_beams", "beams_past_vocab", "beams_temperature",
        "beams_top_k", "beams_seed"])
def test_argument_errors_match_reference(models, kw):
    jm, tm = models
    ids = _prompt(1, 5)
    with pytest.raises(ValueError):
        _jax_generate(jm, ids, **kw)
    with pytest.raises(ValueError):
        tm.generate(torch.from_numpy(ids), **kw)


@pytest.mark.parametrize("n_new", [0, -1])
def test_no_new_tokens_returns_the_prompt(models, n_new):
    jm, tm = models
    ids = _prompt(2, 5)
    got = tm.generate(ids, max_new_tokens=n_new, num_beams=0)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ids)
    np.testing.assert_array_equal(
        _jax_generate(jm, ids, max_new_tokens=n_new, num_beams=0), ids)


def test_greedy_equals_the_serving_engine(models):
    """The port's ServingEngine (paged pool, the same decode math) gives
    each prompt the tokens greedy ``generate()`` gives it."""
    _, tm = models
    prompts = [_prompt(1, n, seed=20 + n)[0] for n in (3, 9, 17)]
    eng = ServingEngine(tm, device="cpu", num_slots=2, block_size=4)
    reqs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
    eng.run()
    for p, r in zip(prompts, reqs):
        want = tm.generate(p[None], max_new_tokens=12, temperature=0.0)
        np.testing.assert_array_equal(np.asarray(r.generated),
                                      want[0, len(p):].numpy())
