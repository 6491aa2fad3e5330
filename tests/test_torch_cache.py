"""paddle_tpu_torch's cache observatory against the JAX reference on
the CPU (tests/test_cache.py's scenarios): the reuse-distance sampler
and the exact LRU oracle on the same seeded traces, the fleet merges of
MRC curves and heat digests, the observatory attached to the port's and
the reference's paged pools driven in lockstep through the same
admissions, releases and evictions under one injected clock, and the
engines' ``/debug/cache`` sections on the same shared-prefix traffic.

Every comparison is exact: the modules are stdlib and the clock is
injected. In the engine comparison the fields that ride the wall clock
(block lifetimes, the per-token prefill cost and the TTFT it saves) are
dropped.
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.observability import CacheObservatory as JaxObservatory
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import cache as jcache
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.paged import PagedKVPool as JaxPool
from paddle_tpu.serving.paged import RadixPrefixIndex as JaxRadix

from _torch_port import jax_gpt, torch_twin
from paddle_tpu_torch.observability import CacheObservatory, MetricsRegistry
from paddle_tpu_torch.observability import cache as tcache
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.paged import PagedKVPool
from paddle_tpu_torch.serving.paged.radix import RadixPrefixIndex

CAPS = (1, 2, 4, 8, 16, 32, 64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _zipf_trace(seed, n_access=3000, n_obj=300, a=1.3):
    rs = np.random.RandomState(seed)
    ranks = np.minimum(rs.zipf(a, size=n_access), n_obj) - 1
    return [int(r) * 7919 + 13 for r in ranks]


# ------------------------------------------------- sampler and oracle

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rate", [1.0, 0.5, 0.125])
def test_sampler_matches_reference(rate, seed):
    ours = tcache.ReuseDistanceSampler(rate=rate, max_tracked=256)
    ref = jcache.ReuseDistanceSampler(rate=rate, max_tracked=256)
    for obj in _zipf_trace(seed):
        ours.record(obj)
        ref.record(obj)
    assert ours.report() == ref.report()
    assert ours.mrc(CAPS) == ref.mrc(CAPS)
    assert (ours.sampled_accesses, ours.tracked) == \
        (ref.sampled_accesses, ref.tracked)


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_exact_mrc_matches_reference(seed):
    trace = _zipf_trace(seed, n_access=800, n_obj=90)
    assert tcache.exact_mrc(trace, CAPS) == jcache.exact_mrc(trace, CAPS)


def test_sampler_edges_match_reference():
    for mod in (tcache, jcache):
        with pytest.raises(ValueError):
            mod.ReuseDistanceSampler(rate=0.0)
        with pytest.raises(ValueError):
            mod.ReuseDistanceSampler(rate=1.5)
    assert tcache.ReuseDistanceSampler().mrc(CAPS) == \
        jcache.ReuseDistanceSampler().mrc(CAPS)


def _digest(rs, n):
    return [{"fp": f"{rs.randint(0, 6):08x}", "depth": int(rs.randint(1, 4)),
             "hits": int(rs.randint(0, 20)),
             "last_tick": int(rs.randint(0, 50)),
             "tokens_saved": 16 * int(rs.randint(0, 20))} for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_merges_match_reference(seed):
    rs = np.random.RandomState(seed)
    lists = [[{"blocks": 8 * f, "est_hit_rate": float(rs.rand()),
               "factor": float(f)} for f in (1, 2, 4)] for _ in range(3)]
    weights = [int(rs.randint(0, 500)) for _ in range(3)]
    assert tcache.merge_mrc_points(lists, weights) == \
        jcache.merge_mrc_points(lists, weights)
    digests = [_digest(rs, 5) for _ in range(3)]
    for k in (2, 8):
        assert tcache.merge_heat_digests(digests, k=k) == \
            jcache.merge_heat_digests(digests, k=k)
        assert tcache.top_prefix_digest(digests[0], k=k) == \
            jcache.top_prefix_digest(digests[0], k=k)


def test_schema_and_disabled_shape_are_the_references():
    assert tcache.CACHE_KEYS == jcache.CACHE_KEYS
    assert tcache.MRC_CAPACITY_FACTORS == jcache.MRC_CAPACITY_FACTORS
    assert tcache.disabled_cache_report() == jcache.disabled_cache_report()
    obs = CacheObservatory(MetricsRegistry(), enabled=False)
    obs.attach_pool(PagedKVPool(2, 1, 1, 16, 2, block_size=4,
                                device="cpu"))
    assert obs.report() == tcache.disabled_cache_report()


def test_radix_thrash_matches_reference():
    counts = []
    for cls in (RadixPrefixIndex, JaxRadix):
        idx = cls(2)
        idx.insert([1, 2, 3, 4], [1, 2])
        idx.evict_lru({2}.__contains__)
        idx.insert([1, 2, 3, 4], [1, 5])
        idx.evict_lru({5}.__contains__)
        idx.insert([1, 2, 3, 4], [1, 6])
        idx.insert([1, 2, 9, 9], [7])
        counts.append((idx.thrash_count, idx.heat_entries(),
                       idx.access_fingerprints([1, 2, 3, 4, 5])))
    assert counts[0] == counts[1]
    assert counts[0][0] == 2


# ------------------------------------ observatory over lockstep pools

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _lockstep(seed, num_slots=3, max_len=24, block_size=4, num_blocks=12,
              steps=60):
    """The same random admissions and releases on both pools, each with
    an observatory at rate 1 on one clock; returns both reports."""
    clock = _Clock()
    obs = [CacheObservatory(MetricsRegistry(), sample_rate=1.0, clock=clock),
           JaxObservatory(JaxRegistry(), sample_rate=1.0, clock=clock)]
    pools = [PagedKVPool(num_slots, 1, 1, max_len, 2, block_size=block_size,
                         num_blocks=num_blocks, device="cpu"),
             JaxPool(num_slots, 1, 1, max_len, 2, block_size=block_size,
                     num_blocks=num_blocks)]
    for o, p in zip(obs, pools):
        o.attach_pool(p)
    rs = np.random.RandomState(seed)
    stems = [list(rs.randint(0, 50, 8)) for _ in range(3)]
    live = {}
    for rid in range(steps):
        clock.t = float(rid)
        if live and (rs.rand() < 0.4 or len(live) == num_slots):
            slot = sorted(live)[rs.randint(len(live))]
            for p in pools:
                p.release(slot)
            del live[slot]
            continue
        prompt = np.asarray(stems[rs.randint(3)]
                            + list(rs.randint(0, 50, rs.randint(1, 9))))
        got = []
        for p in pools:
            cached = p.match_prefix(prompt)
            start = min(cached, len(prompt) - 1) // block_size * block_size
            alloc = p.acquire(rid, prompt, len(prompt) + 2, start)
            if alloc is not None:
                p.commit_prefix(alloc.slot, prompt)
            got.append(None if alloc is None else alloc.slot)
        assert got[0] == got[1]
        if got[0] is not None:
            live[got[0]] = rid
    return [o.report() for o in obs], pools


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_observatory_over_lockstep_pools_matches_reference(seed):
    (ours, ref), pools = _lockstep(seed)
    assert ours == ref
    assert tuple(ours) == tcache.CACHE_KEYS
    assert ours["accesses"] > 0
    assert pools[0].evictions == pools[1].evictions
    json.dumps(ours)


def test_observatory_survives_pool_swap():
    obs = CacheObservatory(MetricsRegistry(), sample_rate=1.0)
    pool1 = PagedKVPool(2, 1, 1, 16, 2, block_size=4, device="cpu")
    obs.attach_pool(pool1)
    for rid, tail in ((0, 5), (1, 6)):
        prompt = np.asarray([1, 2, 3, 4, tail])
        start = pool1.match_prefix(prompt)
        alloc = pool1.acquire(rid, prompt, 7, min(start, 4))
        pool1.commit_prefix(alloc.slot, prompt)
    assert (obs.accesses, obs.hits) == (2, 1)
    pool2 = PagedKVPool(2, 1, 1, 16, 2, block_size=4, device="cpu")
    obs.attach_pool(pool2)
    assert pool2.observer is obs and obs.accesses == 2
    assert obs.report()["capacity_blocks"] == pool2.num_blocks - 1


def test_savings_join_matches_reference():
    class _Perf:
        def prefill_seconds(self):
            return 2.0
    out = []
    for obs in (CacheObservatory(MetricsRegistry(), sample_rate=1.0),
                JaxObservatory(JaxRegistry(), sample_rate=1.0)):
        obs.attach_pool(PagedKVPool(2, 1, 1, 16, 2, block_size=4,
                                    device="cpu"))
        first = obs.note_reuse(8)
        obs.bind_cost_source(_Perf(), lambda: 1000)
        out.append((first, obs.estimate_saved_ms(100), obs.note_reuse(100),
                    obs.report()["savings"]))
    assert out[0] == out[1]
    assert out[0][2] == pytest.approx(200.0)


# ---------------------------------------------------------- engines

VOLATILE = ("block_lifetime_ms", "saved_ttft_ms", "per_token_prefill_ms")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    return obj


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt()
    return jm, torch_twin(jm)


def _shared_prefix_traffic(eng, seed):
    rs = np.random.RandomState(seed)
    stem = rs.randint(0, 97, (20,)).astype(np.int64)
    reqs = []
    for i in range(8):
        tail = rs.randint(0, 97, (int(rs.randint(1, 6)),)).astype(np.int64)
        reqs.append(eng.add_request(np.concatenate([stem, tail]), 4))
        if i % 3 == 2:
            eng.run()
    eng.run()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("rate", [1.0, 0.125])
def test_engine_cache_section_matches_reference(models, rate):
    """Shared-prefix traffic on both paged engines: the same streams and
    the same cache section (accesses, hits, MRC, heat, savings tokens,
    churn), served at ``/debug/cache`` with the reference's keys."""
    jm, tm = models
    kw = dict(num_slots=3, bucket_min=8, paged=True, block_size=4,
              cache_sample_rate=rate)
    ours = ServingEngine(tm, device="cpu", **kw)
    ref = JaxEngine(jm, **kw)
    assert _shared_prefix_traffic(ours, 0) == \
        _shared_prefix_traffic(ref, 0)
    a, b = ours.metrics.cache_report(), ref.metrics.cache_report()
    assert _strip(a) == _strip(b)
    assert a["hits"] > 0 and a["mrc"]
    assert set(ours.debug_state()["cache"]) == set(tcache.CACHE_KEYS)
    ours.close()
    ref.close()


def test_slot_pool_engine_reports_the_disabled_cache(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", num_slots=2, bucket_min=8,
                        paged=False)
    _shared_prefix_traffic(eng, 1)
    assert eng.metrics.cache_report() == tcache.disabled_cache_report()
    eng.close()
