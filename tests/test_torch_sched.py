"""paddle_tpu_torch's scheduling layer against the JAX reference on the
CPU (tests/test_sched.py's scenarios): chunk plans; chunked prefill on
both pools and both pipeline depths, whose greedy streams equal the
unchunked ones and the JAX engine's; the token budget's pacing; a
failed chunk that leaks nothing; SLO-feedback decisions equal to the
reference policy's on the same queue and clock; and per-slot sampling:
the top-k/top-p masks admit exactly the tokens the reference head
draws, greedy rows are the argmax, draws pass a chi-square test against
the masked softmax, and a seed gives the same stream across slots,
pools, chunking and pipeline depths."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.sched import SLOFeedbackPolicy as JaxSLO
from paddle_tpu.serving.sched import build_sampling_head as jax_head
from paddle_tpu.serving.sched import plan_chunks as jax_plan_chunks
from paddle_tpu.serving.scheduler import Request as JaxRequest

from _torch_port import jax_gpt, torch_twin
from test_torch_slot_serving import one_torch_thread  # noqa: F401
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.scheduler import Request
from paddle_tpu_torch.serving.sched import (FIFOPolicy, SLOFeedbackPolicy,
                                            build_sampling_head,
                                            plan_chunks, resolve_policy)
from paddle_tpu_torch.serving.sched.sampling import MASKED, masked_logits


def _prompts(rs, lengths):
    return [rs.randint(0, 97, (n,)).astype(np.int64) for n in lengths]


def _mixed():
    """Short and long prompts (chunk 8), staggered arrivals."""
    rs = np.random.RandomState(0)
    specs = [(5, 6), (40, 5), (11, 4), (56, 7), (23, 5), (7, 6), (33, 4),
             (3, 8)]
    return _prompts(rs, [n for n, _ in specs]), [k for _, k in specs]


def _drive(eng, prompts, specs, staggered=True, **kw):
    reqs = []
    for i, (p, k) in enumerate(zip(prompts, specs)):
        reqs.append(eng.add_request(p, max_new_tokens=k, **kw))
        if staggered and i % 3 == 2:
            eng.step()
            eng.step()
    eng.run()
    return reqs


KNOBS = dict(num_slots=3, bucket_min=8, block_size=4)


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


@pytest.fixture(scope="module")
def jax_chunked(models):
    """The JAX engine's chunked streams on each pool."""
    return {paged: [r.output_ids for r in _drive(
        JaxEngine(models[0], paged=paged, prefill_chunk=8, **KNOBS),
        *_mixed())] for paged in (False, True)}


# ------------------------------------------------------------ chunk plans

@pytest.mark.parametrize("start0,n,c", [(0, 50, 16), (0, 17, 16),
                                        (0, 129, 32), (24, 44, 8),
                                        (8, 63, 8), (16, 33, 16)])
def test_plan_chunks_coverage_and_end_alignment(start0, n, c):
    starts = plan_chunks(start0, n, c)
    assert starts == jax_plan_chunks(start0, n, c)
    assert starts[0] == start0 and starts[-1] == n - c
    assert all(b > a for a, b in zip(starts, starts[1:]))
    covered = set()
    for s in starts:
        assert s + c <= n
        covered.update(range(s, s + c))
    assert covered == set(range(start0, n))


def test_plan_chunks_rejects_short_tails():
    for args in ((0, 8, 8), (16, 20, 8)):
        with pytest.raises(ValueError):
            plan_chunks(*args)


# -------------------------------------------------------- chunked prefill

@pytest.mark.parametrize("async_depth", [0, 1])
@pytest.mark.parametrize("paged", [False, True])
def test_chunked_streams_match_unchunked_and_reference(models, jax_chunked,
                                                       paged, async_depth):
    runs = {}
    for chunk in (None, 8):
        eng = ServingEngine(models[1], device="cpu", paged=paged,
                            prefill_chunk=chunk, async_depth=async_depth,
                            **KNOBS)
        runs[chunk] = (eng, _drive(eng, *_mixed()))
    eng, reqs = runs[8]
    for r, plain, ref in zip(reqs, runs[None][1], jax_chunked[paged]):
        np.testing.assert_array_equal(r.output_ids, plain.output_ids)
        np.testing.assert_array_equal(r.output_ids, ref)
    sched = eng.metrics.snapshot()["scheduler"]
    assert sched["chunked_requests"] == sum(
        1 for p in _mixed()[0] if len(p) > 8)
    assert sched["prefill_chunks"] > sched["chunked_requests"]
    assert sched["prefill_chunk"] == 8 and sched["policy"] == "fifo"
    assert not eng._chunk_q and not eng._prefilling
    if paged:
        eng.pool.check_conservation()
        assert eng.pool.live_blocks == 0
    else:
        assert eng.pool.free_count == 3


def test_chunked_prefill_reuses_the_cached_prefix(models):
    """A second request sharing a 24-token stem chunk-prefills only its
    uncached tail, with the reference's streams."""
    rs = np.random.RandomState(3)
    stem = rs.randint(0, 97, (24,)).astype(np.int64)
    p1 = np.concatenate([stem, rs.randint(0, 97, (20,))])
    p2 = np.concatenate([stem, rs.randint(0, 97, (17,))])
    outs = []
    for pkg, m in (("jax", models[0]), ("torch", models[1])):
        kw = dict(num_slots=2, bucket_min=8, paged=True, block_size=4,
                  prefill_chunk=8)
        eng = JaxEngine(m, **kw) if pkg == "jax" else \
            ServingEngine(m, device="cpu", **kw)
        rr = []
        for p in (p1, p2):
            rr.append(eng.add_request(p, max_new_tokens=5))
            eng.run()
        outs.append([r.output_ids for r in rr])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    pc = eng.metrics.snapshot()["prefix_cache"]
    assert pc["hits"] == 1 and pc["cached_tokens"] == 24
    # 44 tokens: 6 chunks; 41 - 24 = 17 uncached: 3 chunks from 24
    assert eng.metrics.prefill_chunks == 6 + 3
    eng.pool.check_conservation()


def test_chunked_token_budget_paces_dispatches(models):
    """budget == chunk: a 5-chunk prompt takes 5 steps of chunks; budget
    2 x chunk takes 3."""
    rs = np.random.RandomState(9)
    long_p = rs.randint(0, 97, (40,)).astype(np.int64)
    outs = []
    for budget, want in ((8, 5), (16, 3)):
        eng = ServingEngine(models[1], device="cpu", paged=False,
                            num_slots=2, bucket_min=8, prefill_chunk=8,
                            prefill_token_budget=budget)
        r = eng.add_request(long_p, max_new_tokens=2)
        steps = 0
        while eng._chunk_q or not eng.scheduler.active:
            eng.step()
            steps += 1
            assert steps < 50
        assert steps == want
        eng.run()
        outs.append(r.output_ids)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("paged", [False, True])
def test_failed_chunk_dispatch_leaks_nothing(models, paged):
    """A failure at the third chunk (earlier chunks already wrote K/V)
    releases the slot and blocks, empties the chunk queue, requeues the
    request uncounted; the retry serves the unchunked stream."""
    rs = np.random.RandomState(19)
    prompt = rs.randint(0, 97, (44,)).astype(np.int64)
    plain = ServingEngine(models[1], device="cpu", paged=paged,
                          num_slots=2, bucket_min=8, block_size=4)
    want = plain.add_request(prompt, max_new_tokens=4)
    plain.run()
    eng = ServingEngine(models[1], device="cpu", paged=paged, num_slots=2,
                        bucket_min=8, block_size=4, prefill_chunk=8)
    good, calls = eng._chunk_fn, []

    def failing(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected chunk failure")
        return good(*args)

    eng._chunk_fn = failing
    r = eng.add_request(prompt, max_new_tokens=4)
    with pytest.raises(RuntimeError, match="injected"):
        eng.run()
    assert eng.pool.free_count == 2 and not eng.scheduler.active
    assert not eng._chunk_q and not eng._prefilling
    assert r.slot is None and r.inflight == 0
    assert eng.metrics.requests_admitted == 0
    if paged:
        eng.pool.check_conservation()
        assert eng.pool.live_blocks == 0
    eng._chunk_fn = good
    eng.run()
    np.testing.assert_array_equal(r.output_ids, want.output_ids)
    assert eng.metrics.requests_admitted == 1


def test_prefill_token_budget_validation():
    with pytest.raises(ValueError):
        ServingConfig(prefill_token_budget=16)
    for budget in (7.9, -8):
        with pytest.raises(ValueError):
            ServingConfig(prefill_chunk=8, prefill_token_budget=budget)
    cfg = ServingConfig(prefill_chunk=8, prefill_token_budget=16.0)
    assert cfg.prefill_token_budget == 16
    assert ServingConfig(prefill_chunk=8).prefill_token_budget == 8
    assert ServingConfig().prefill_token_budget is None
    with pytest.raises(ValueError):
        ServingConfig(prefill_chunk=0)


# --------------------------------------------------------------- policies

def _queues(ages, now):
    """The same queue in both packages: requests of the given ages."""
    ours, ref = [], []
    for age in ages:
        for cls, out in ((Request, ours), (JaxRequest, ref)):
            r = cls(np.zeros(4, np.int64), 4)
            r.t_arrival = now - age
            out.append(r)
    return ours, ref


@pytest.mark.parametrize("mode", ["shed", "defer"])
def test_slo_feedback_decisions_match_reference(mode):
    """The same queue, clock and service feedback give the reference's
    decisions and headrooms, as the feedback tightens the estimate."""
    now = time.perf_counter()
    ages = [0.01, 0.5, 0.06, 0.03, 0.2, 0.09]
    ours_q, ref_q = _queues(ages, now)
    ours = SLOFeedbackPolicy(slo_ttft_ms=100.0, mode=mode, margin_ms=2.0)
    ref = JaxSLO(slo_ttft_ms=100.0, mode=mode, margin_ms=2.0)

    def same():
        a, b = ours.triage(ours_q, now), ref.triage(ref_q, now)
        for x, y in ((a.shed, b.shed), (a.deprioritized, b.deprioritized)):
            assert [ours_q.index(r) for r, _ in x] == \
                [ref_q.index(r) for r, _ in y]
            np.testing.assert_allclose([h for _, h in x],
                                       [h for _, h in y], rtol=1e-12)
        return a

    first = same()
    assert (first.shed if mode == "shed" else first.deprioritized)
    for ms in (80.0, 20.0, 35.0, 60.0):
        ours.observe_service(ms)
        ref.observe_service(ms)
        assert ours.service_est_ms == ref.service_est_ms
        same()
    if mode == "defer":
        for r in ours_q + ref_q:
            r.deprioritized = True      # what the scheduler stamps
        assert same().empty


def test_resolve_policy_knob():
    assert isinstance(resolve_policy(None), FIFOPolicy)
    assert isinstance(resolve_policy("fifo"), FIFOPolicy)
    p = resolve_policy("slo_feedback", 123.0)
    assert isinstance(p, SLOFeedbackPolicy) and p.slo_ttft_ms == 123.0
    assert resolve_policy(p) is p
    assert resolve_policy("slo_feedback", None).triage(
        _queues([9.0], time.perf_counter())[0], time.perf_counter()).empty
    with pytest.raises(ValueError):
        resolve_policy("round_robin")
    with pytest.raises(ValueError):
        SLOFeedbackPolicy(slo_ttft_ms=1.0, mode="nope")


@pytest.mark.parametrize("mode", ["shed", "defer"])
def test_engine_applies_the_policy(models, mode):
    """Requests whose TTFT target is lost before they are admitted are
    shed (done, no tokens, counted) or deferred once behind the rest and
    served; every served stream is the plain engine's."""
    rs = np.random.RandomState(4)
    prompts = _prompts(rs, [6] * 6)
    plain = ServingEngine(models[1], device="cpu", num_slots=1,
                          bucket_min=8)
    want = [plain.add_request(p, max_new_tokens=4) for p in prompts]
    plain.run()
    eng = ServingEngine(models[1], device="cpu", num_slots=1, bucket_min=8,
                        policy=SLOFeedbackPolicy(slo_ttft_ms=60_000.0,
                                                 mode=mode))
    reqs = [eng.add_request(p, max_new_tokens=4) for p in prompts]
    for r in reqs[1::2]:
        r.t_arrival -= 120.0            # two minutes late already
    eng.run()
    lost = reqs[1::2]
    sched = eng.metrics.snapshot()["scheduler"]
    assert sched["policy"] == "slo_feedback"
    if mode == "shed":
        assert all(r.done and not r.generated and r.shed_reason == "slo_lost"
                   for r in lost)
        assert sched["shed"] == {"slo_lost": 3}
        assert sched["shed_total"] == 3 and sched["deprioritized"] == 0
        served = reqs[0::2]
    else:
        assert all(r.deprioritized for r in lost)
        assert sched["deprioritized"] == 3 and sched["shed_total"] == 0
        served = reqs
        # the deferred ones are admitted after the viable ones
        assert max(r.t_admitted for r in reqs[0::2]) \
            < min(r.t_admitted for r in lost)
    for r in served:
        np.testing.assert_array_equal(r.output_ids,
                                      want[reqs.index(r)].output_ids)
    assert eng._policy.service_est_ms > 0.0   # fed by the engine


# --------------------------------------------------------------- sampling

def _logit_rows(V=32, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(V) * 2.0).astype(np.float32)


# (temperature, top_k, top_p)
SAMPLING = [(1.2, 5, 1.0), (1.0, 0, 0.8), (0.7, 12, 0.9), (2.0, 0, 1.0),
            (1.0, 3, 0.5)]


@pytest.mark.parametrize("temp,topk,topp", SAMPLING)
def test_masks_admit_exactly_the_reference_draws(temp, topk, topp):
    """Over 4096 seeds, the reference head's draws cover the port's
    eligible set exactly, and the port's own draws stay inside it."""
    V, N = 32, 4096
    row = _logit_rows(V)
    eligible = set(np.nonzero(masked_logits(
        torch.from_numpy(row)[None], torch.tensor([temp]),
        torch.tensor([topk]), torch.tensor([topp]))[0].numpy()
        > MASKED / 2)[0].tolist())
    rep = np.repeat(row[None], N, 0)
    jdraws = np.asarray(jax_head(V)(
        jnp.asarray(rep), jnp.arange(N, dtype=jnp.int32),
        jnp.zeros(N, jnp.int32), jnp.full(N, temp, jnp.float32),
        jnp.full(N, topk, jnp.int32), jnp.full(N, topp, jnp.float32)))
    assert set(jdraws.tolist()) == eligible
    tdraws = build_sampling_head(V)(
        torch.from_numpy(rep), torch.arange(N), torch.zeros(N, dtype=int),
        torch.full((N,), temp), torch.full((N,), topk),
        torch.full((N,), topp)).numpy()
    assert set(tdraws.tolist()) <= eligible
    assert len(eligible) > 1


def test_greedy_rows_are_the_argmax():
    V = 32
    rows = np.stack([_logit_rows(V, s) for s in range(4)])
    head = build_sampling_head(V)
    got = head(torch.from_numpy(rows), torch.arange(4), torch.arange(4),
               torch.tensor([0.0, 0.7, 0.0, 1.3]), torch.tensor([0, 1, 5, 1]),
               torch.tensor([1.0, 1.0, 0.5, 0.9]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), rows.argmax(-1))


@pytest.mark.parametrize("temp,topk,topp", [(1.0, 0, 1.0), (0.8, 5, 1.0),
                                            (1.5, 0, 0.7)])
def test_draws_follow_the_masked_softmax(temp, topk, topp):
    """8000 draws of one row (key indices 0..7999 of one seed): a
    chi-square statistic below its 0.999 quantile against
    softmax(masked logits)."""
    V, N = 8, 8000
    row = _logit_rows(V, 5)
    lg = masked_logits(torch.from_numpy(row)[None], torch.tensor([temp]),
                       torch.tensor([topk]), torch.tensor([topp]))[0]
    p = torch.softmax(lg.double(), -1).numpy()
    draws = build_sampling_head(V)(
        torch.from_numpy(np.repeat(row[None], N, 0)), torch.full((N,), 3),
        torch.arange(N), torch.full((N,), temp), torch.full((N,), topk),
        torch.full((N,), topp)).numpy()
    counts = np.bincount(draws, minlength=V)
    keep = p > 0
    assert counts[~keep].sum() == 0
    exp = p[keep] * N
    stat = ((counts[keep] - exp) ** 2 / exp).sum()
    assert stat < chi2.ppf(0.999, keep.sum() - 1), stat


def _sampled_traffic():
    rs = np.random.RandomState(2)
    prompts = _prompts(rs, [5, 9, 12, 7, 30, 44])
    kws = [dict(), dict(temperature=0.8, top_k=12, seed=11),
           dict(temperature=1.1, top_p=0.9, seed=12), dict(),
           dict(temperature=0.9, top_k=20, top_p=0.95, seed=13),
           dict(temperature=0.7, top_k=10, seed=42)]
    return prompts, kws


def _sampled_run(model, order, **knobs):
    """The sampled traffic submitted in ``order``; streams by index."""
    prompts, kws = _sampled_traffic()
    eng = ServingEngine(model, device="cpu", num_slots=4, bucket_min=8,
                        block_size=4, sampling=True, **knobs)
    reqs = {i: eng.add_request(prompts[i], 8, **kws[i]) for i in order}
    eng.run()
    return {i: r.output_ids for i, r in reqs.items()}, eng


def test_sampled_streams_are_per_seed(models):
    """A seed gives the same stream whichever slot, pool, chunking and
    pipeline depth serve it; greedy rows in a sampling engine equal the
    JAX greedy engine's; sampled rows differ from greedy."""
    base, eng = _sampled_run(models[1], range(6))
    assert eng.metrics.prefill_group_hist   # grouped slot-pool prefills
    for order, knobs in (
            (range(6), dict(paged=False)),
            (reversed(range(6)), dict(paged=False)),
            (range(6), dict(paged=True)),
            ([5, 1, 3, 0, 4, 2], dict(paged=True, prefill_chunk=8)),
            (range(6), dict(paged=False, prefill_chunk=8, async_depth=0)),
            ([2, 4, 0], dict(paged=True, async_depth=0))):
        got, _ = _sampled_run(models[1], order, **knobs)
        for i, out in got.items():
            np.testing.assert_array_equal(out, base[i], err_msg=str(knobs))
    prompts, kws = _sampled_traffic()
    jeng = JaxEngine(models[0], num_slots=4, bucket_min=8)
    jr = [jeng.add_request(prompts[i], 8) for i in range(6)]
    jeng.run()
    for i in (0, 3):
        np.testing.assert_array_equal(base[i], jr[i].output_ids)
    assert sum(not np.array_equal(base[i], jr[i].output_ids)
               for i in (1, 2, 4, 5)) >= 3
    assert all(0 <= t < 97 for out in base.values() for t in out)


def test_greedy_engine_rejects_sampled_requests(models):
    eng = ServingEngine(models[1], device="cpu", num_slots=2, bucket_min=8)
    with pytest.raises(ValueError, match="sampling=True"):
        eng.add_request(np.zeros(4, np.int64), 4, temperature=0.5)
    eng.add_request(np.zeros(4, np.int64), 2, temperature=0.9, top_k=1)
    eng.add_request(np.zeros(4, np.int64), 2, temperature=0.0)
    assert len(eng.run()) == 2


@pytest.mark.parametrize("kw", [dict(temperature=-0.1), dict(top_k=-1),
                                dict(top_p=0.0), dict(top_p=1.5)])
def test_request_sampling_validation(kw):
    with pytest.raises(ValueError):
        Request(np.zeros(4, np.int64), 2, **kw)
    with pytest.raises(ValueError):
        JaxRequest(np.zeros(4, np.int64), 2, **kw)
    r = Request(np.zeros(4, np.int64), 2, temperature=0.5)
    assert r.seed == r.rid and r.sampled
