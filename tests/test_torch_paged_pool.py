"""paddle_tpu_torch's paged KV pool against the JAX reference's on the
CPU: tests/test_paged_kv.py's random-traffic fuzz (an undersized pool,
evictions firing) run in lockstep with the reference pool, the radix
lookups held to a mirror trie after every operation, the refcounts to a
recount of the live rows, heat and thrash counts to mirror bookkeeping,
and conservation checked after every operation, now with held slots
(exported, then released) and imported ones (fresh blocks bound from
tiles, then shared through the index); plus the pool's unit cases."""
import numpy as np
import pytest
import torch

from paddle_tpu.serving.paged import PagedKVPool as JaxPool

from test_torch_slot_serving import one_torch_thread  # noqa: F401
from paddle_tpu_torch.serving.paged import TRASH_BLOCK, PagedKVPool

DIMS = (2, 2, 3)   # layers, heads, head_dim


def _pools(num_slots=4, max_len=32, block_size=4, num_blocks=None):
    L, H, D = DIMS
    return (PagedKVPool(num_slots, L, H, max_len, D, block_size=block_size,
                        num_blocks=num_blocks),
            JaxPool(num_slots, L, H, max_len, D, block_size=block_size,
                    num_blocks=num_blocks))


class _MirrorTrie:
    """Pure-Python oracle for longest-cached-prefix lookups."""

    def __init__(self, bs):
        self.bs = bs
        self.root = {}

    def keys(self, toks):
        n = (len(toks) // self.bs) * self.bs
        return [tuple(int(t) for t in toks[i:i + self.bs])
                for i in range(0, n, self.bs)]

    def insert(self, toks, blocks):
        node = self.root
        for key, b in zip(self.keys(toks), blocks):
            node = node.setdefault(key, {"block": int(b),
                                         "kids": {}})["kids"]

    def match(self, toks):
        out, node = [], self.root
        for key in self.keys(toks):
            child = node.get(key)
            if child is None:
                break
            out.append(child["block"])
            node = child["kids"]
        return out

    def blocks(self, node=None):
        for child in (self.root if node is None else node).values():
            yield child["block"]
            yield from self.blocks(child["kids"])

    def leaf(self, block, node=None):
        for child in (self.root if node is None else node).values():
            if child["block"] == block:
                return not child["kids"]
            found = self.leaf(block, child["kids"])
            if found is not None:
                return found
        return None

    def remove(self, block, node=None):
        node = self.root if node is None else node
        for key, child in list(node.items()):
            if child["block"] == block:
                assert not child["kids"], "oracle: evicted interior"
                del node[key]
                return True
            if self.remove(block, child["kids"]):
                return True
        return False


def test_fuzz_lookup_refs_heat_and_conservation_with_handoffs():
    rs = np.random.RandomState(42)
    BS = 4
    pool, ref = _pools(num_slots=3, max_len=24, block_size=BS,
                       num_blocks=13)
    mirror = _MirrorTrie(BS)
    bases = [rs.randint(0, 9, (8,)) for _ in range(3)]
    live = {}            # slot -> prompt
    tiles = {}           # slot -> (blocks, k) bound by an import
    rid = 0
    hits, path_of, evicted, thrash = {}, {}, set(), [0]
    ops = {"admit": 0, "import": 0, "export": 0, "release": 0}

    def audit():
        pool.check_conservation()
        counts = {}
        for slot in live:
            for b in pool._slot_blocks[slot]:
                counts[b] = counts.get(b, 0) + 1
        for b, r in pool._ref.items():
            assert counts.get(b, 0) == r, (b, r, counts)
        assert pool.stats() == {k: v for k, v in ref.stats().items()
                                if k in pool.stats()}
        np.testing.assert_array_equal(pool.block_tables, ref.block_tables)
        assert pool.index.thrash_count == thrash[0]
        root = pool.index._root
        for b, node in pool.index._by_block.items():
            assert node.hits == hits.get(b, 0), (b, node.hits)
            if node.parent is not root:
                assert node.tick <= node.parent.tick

    def follow_evictions(before):
        if pool.evictions == before:
            return
        stale = set(mirror.blocks()) - set(pool.index._by_block)
        while stale:
            n = len(stale)
            for b in list(stale):
                if mirror.leaf(b):
                    mirror.remove(b)
                    evicted.add(path_of.pop(b))
                    hits.pop(b, None)
                    stale.discard(b)
            assert len(stale) < n, "stale interior block"

    def commit(slot, prompt):
        created = pool.commit_prefix(slot, prompt)
        assert created == ref.commit_prefix(slot, prompt)
        keys = mirror.keys(prompt)
        row = pool._slot_blocks[slot]
        for b in created:
            path = tuple(keys[:row.index(b) + 1])
            if path in evicted:
                evicted.discard(path)
                thrash[0] += 1
            path_of[b] = path
            hits.setdefault(b, 0)
        mirror.insert(prompt, row[:len(prompt) // BS])
        live[slot] = prompt

    for step in range(500):
        if live and (rs.rand() < 0.4 or pool.free_count == 0):
            slot = int(rs.choice(sorted(live)))
            prompt = live.pop(slot)
            if rs.rand() < 0.5:
                # a held slot exported: its prompt blocks read in row
                # order (imported tiles come back as bound), then freed
                n = -(-len(prompt) // BS)
                blocks = pool.row_blocks(slot, n)
                k, v = pool.read_blocks(blocks)
                assert k.shape == (DIMS[0], n, DIMS[1], BS, DIMS[2])
                if slot in tiles and tiles[slot][0] == blocks:
                    assert torch.equal(k, tiles[slot][1])
                ops["export"] += 1
            else:
                ops["release"] += 1
            tiles.pop(slot, None)
            pool.release(slot)
            ref.release(slot)
        else:
            base = bases[rs.randint(len(bases))]
            prompt = np.concatenate([base[:rs.randint(0, 9)],
                                     rs.randint(0, 9, (rs.randint(1, 9),))])
            cached = pool.match_prefix(prompt)
            assert cached == ref.match_prefix(prompt) \
                == len(mirror.match(prompt)) * BS
            imported = rs.rand() < 0.3
            start = 0 if imported else \
                min(cached, len(prompt) - 1) // BS * BS
            total = len(prompt) + int(rs.randint(1, 5))
            if total > pool.slot_capacity:
                continue
            before = pool.evictions
            alloc = pool.acquire(rid, prompt, total, start)
            ralloc = ref.acquire(rid, prompt, total, start)
            rid += 1
            # a refused acquire may have evicted before it rolled back
            follow_evictions(before)
            if alloc is None:
                assert ralloc is None
                audit()
                continue
            assert (alloc.slot, alloc.prefix_blocks, alloc.new_blocks) == \
                (ralloc.slot, ralloc.prefix_blocks, ralloc.new_blocks)
            for b in alloc.prefix_blocks:
                hits[b] = hits.get(b, 0) + 1
            if imported:
                # bind received tiles into the fresh blocks, then share
                n = -(-len(prompt) // BS)
                blocks = pool.row_blocks(alloc.slot, n)
                assert blocks == alloc.new_blocks[:n]
                k = torch.randn(DIMS[0], n, DIMS[1], BS, DIMS[2])
                pool.write_blocks(blocks, k, -k)
                tiles[alloc.slot] = (blocks, k)
                ops["import"] += 1
            else:
                ops["admit"] += 1
            commit(alloc.slot, prompt)
        audit()
        for base in bases:
            probe = np.concatenate([base, [99]])
            assert pool.match_prefix(probe) == ref.match_prefix(probe) \
                == len(mirror.match(probe)) * BS
    assert pool.evictions > 0 and min(ops.values()) > 20, ops
    for slot in list(live):
        pool.release(slot)
    assert pool.live_blocks == 0
    pool.check_conservation()


def test_acquire_pins_prefix_and_allocates_tail():
    pool, _ = _pools()
    p1 = np.arange(10)
    a1 = pool.acquire(0, p1, total_tokens=14, prefix_tokens=0)
    assert a1.slot == 0 and a1.prefix_blocks == [] \
        and len(a1.new_blocks) == 4
    pool.commit_prefix(a1.slot, p1)
    assert pool.match_prefix(p1) == 8
    p2 = np.concatenate([p1[:8], [77, 78, 79, 80]])
    a2 = pool.acquire(1, p2, total_tokens=16, prefix_tokens=8)
    assert a2.prefix_blocks == a1.new_blocks[:2]
    assert all(pool._ref[b] == 2 for b in a2.prefix_blocks)
    row = pool.block_tables[a2.slot]
    assert list(row[:2]) == a2.prefix_blocks
    assert all(b == TRASH_BLOCK for b in row[4:])
    pool.release(a1.slot)
    pool.release(a2.slot)
    assert pool.live_blocks == 0
    pool.check_conservation()


def test_capacity_refusal_and_trash_reset():
    pool, _ = _pools(num_slots=2, max_len=16, num_blocks=5)
    a = pool.acquire(0, np.arange(8), total_tokens=16, prefix_tokens=0)
    assert a is not None and pool.free_blocks == 0
    assert pool.acquire(1, np.arange(4) + 50, 4, 0) is None
    pool.release(a.slot)
    assert all(b == TRASH_BLOCK for b in pool.block_tables[a.slot])
    assert pool.free_blocks == 4
    with pytest.raises(ValueError):
        pool.row_blocks(a.slot, 1)
    pool.check_conservation()


def test_eviction_reclaims_lru_cached_blocks():
    pool, _ = _pools(num_slots=4, max_len=16, num_blocks=7)
    pa = np.arange(8)
    a = pool.acquire(0, pa, 8, 0)
    pool.commit_prefix(a.slot, pa)
    pool.release(a.slot)
    pb = np.arange(8) + 100
    b = pool.acquire(1, pb, 9, 0)
    pool.commit_prefix(b.slot, pb)
    c = pool.acquire(2, np.arange(12) + 200, 12, 0)
    assert c is not None and pool.evictions == 2
    assert pool.match_prefix(pa) == 0 and pool.match_prefix(pb) == 8
    pool.check_conservation()
