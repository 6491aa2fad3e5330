"""Radix/trie prefix index over prompt token IDs, block granularity.

Each edge covers exactly ``block_size`` token IDs (one KV block), so a
node at depth d caches the block holding positions
``[(d-1)*block_size, d*block_size)`` of every prompt that starts with
the node's token path. Fixed-width edges keep lookup a plain dict walk
(no SGLang-style edge splitting needed: a prefix is shareable only at
block granularity anyway, because a physical KV block is the unit the
block table can point at).

The index stores WHICH physical block caches a token path; it owns no
refcounts — liveness is the pool's job (pool.PagedKVPool pins/derefs).
Eviction is therefore a cooperation: ``evict_lru(evictable)`` removes
the least-recently-used LEAF whose block the pool says is refcount
zero, and returns its block for reuse. Leaves-only keeps every cached
path contiguous from the root (evicting an interior node would orphan
descendants whose prefix K/V no longer exists).

LRU time is a deterministic monotone tick (bumped on every match that
touches a node and every insert), not wall-clock — reproducible runs,
reproducible tests.

Cache-observatory instrumentation: every node carries a hit
counter and a STABLE path fingerprint (crc32 chained root-to-node over
the edge key tokens — deterministic across processes, so fleet views
can merge heat digests without shipping raw tokens). ``evict_lru``
remembers evicted fingerprints in a bounded ring; ``insert`` counts a
THRASH when it re-creates a path that was evicted — eviction-then-
reinsert is the "cache too small for the working set" smell the
``cache_thrash`` detector watches. All additions are O(1) dict/int
ops on paths the caller already walks.
"""
import collections
import zlib


def path_fingerprint(parent_fp, key):
    """Stable 32-bit fingerprint of a root->node token path: crc32 of
    the edge's token ids chained from the parent's fingerprint (root
    is 0). Deterministic across processes and runs — the heat digest
    and the reuse-distance sampler identify prefixes by this, never by
    raw tokens."""
    return zlib.crc32(",".join(map(str, key)).encode(),
                      parent_fp) & 0xFFFFFFFF


class _Node:
    __slots__ = ("key", "block", "children", "parent", "tick", "hits",
                 "fp")

    def __init__(self, key, block, parent, tick, fp=0):
        self.key = key          # tuple of block_size token ids (root: None)
        self.block = block      # physical block id (root: None)
        self.children = {}      # key tuple -> _Node
        self.parent = parent
        self.tick = tick
        self.hits = 0           # match() walks through this node
        self.fp = fp            # stable root->node path fingerprint


class RadixPrefixIndex:
    """Longest-cached-prefix lookup + insert + LRU-leaf eviction."""

    def __init__(self, block_size):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self._root = _Node(None, None, None, 0)
        self._by_block = {}     # physical block id -> _Node
        self._tick = 0
        # thrash accounting: fingerprints of evicted paths, bounded
        # FIFO — re-creating one of these in insert() means the cache
        # gave a block up and then had to recompute it
        self.thrash_count = 0
        self._evicted_fps = collections.OrderedDict()
        self._evicted_fp_cap = 4096

    def __len__(self):
        """Number of indexed blocks (nodes excluding the root)."""
        return len(self._by_block)

    def __contains__(self, block):
        return block in self._by_block

    def _keys(self, tokens):
        bs = self.block_size
        n = (len(tokens) // bs) * bs
        return [tuple(int(t) for t in tokens[i:i + bs])
                for i in range(0, n, bs)]

    # ------------------------------------------------------------ lookup
    def match(self, tokens):
        """Longest cached prefix of ``tokens``: the list of physical
        blocks caching it, walked full-block by full-block from the
        root. Touches every matched node's LRU tick (a lookup is a
        use: admission follows immediately and pins these blocks)."""
        self._tick += 1
        blocks = []
        node = self._root
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.tick = self._tick
            blocks.append(child.block)
            node = child
        return blocks

    def note_hits(self, blocks):
        """Count one admission's heat on the nodes caching ``blocks``.
        A separate entry point (not match()) on purpose: the scheduler
        probes match() repeatedly while a request waits for a slot, so
        counting hits there would inflate heat — acquire() calls this
        exactly once per successful admission, for the blocks it
        actually pinned."""
        by_block = self._by_block
        for b in blocks:
            by_block[b].hits += 1

    def access_fingerprints(self, tokens):
        """Stable path fingerprints of ``tokens``' full blocks, in
        path order — the reuse-distance sampler's access trace (every
        full prompt block is one cache reference, cached or not)."""
        fps = []
        fp = 0
        for key in self._keys(tokens):
            fp = path_fingerprint(fp, key)
            fps.append(fp)
        return fps

    # ------------------------------------------------------------ insert
    def insert(self, tokens, blocks):
        """Index ``blocks[i]`` as the cache of ``tokens``' i-th full
        block. Where a node already exists the EXISTING block wins (the
        first writer's K/V is the shared copy; a caller holding its own
        private block for that span just doesn't get it indexed) —
        returns the block ids actually newly indexed, so the pool can
        mark exactly those as radix-owned."""
        self._tick += 1
        created = []
        node = self._root
        for key, block in zip(self._keys(tokens), blocks):
            child = node.children.get(key)
            if child is None:
                block = int(block)
                if block in self._by_block:
                    raise ValueError(
                        f"block {block} is already indexed elsewhere")
                fp = path_fingerprint(node.fp, key)
                child = _Node(key, block, node, self._tick, fp)
                node.children[key] = child
                self._by_block[block] = child
                created.append(block)
                if self._evicted_fps.pop(fp, None) is not None:
                    self.thrash_count += 1
            else:
                child.tick = self._tick
            node = child
        return created

    # ---------------------------------------------------------- eviction
    def evict_lru(self, evictable):
        """Remove the least-recently-used LEAF whose block satisfies
        ``evictable(block)`` (the pool passes refcount == 0) and return
        its block id; None when nothing qualifies. Oldest tick first,
        block id as the deterministic tie-break."""
        best = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.children:
                continue
            if not evictable(node.block):
                continue
            if best is None or (node.tick, node.block) < (best.tick,
                                                          best.block):
                best = node
        if best is None:
            return None
        del best.parent.children[best.key]
        del self._by_block[best.block]
        fps = self._evicted_fps
        fps[best.fp] = best.tick
        fps.move_to_end(best.fp)
        if len(fps) > self._evicted_fp_cap:
            fps.popitem(last=False)
        return best.block

    # ------------------------------------------------------------- stats
    def heat_entries(self):
        """One dict per indexed node — fingerprint, depth, hit count,
        last-access tick, and tokens saved (hits x block_size: every
        match through the node served one block of prompt from cache).
        O(indexed nodes); called at report time, never on the
        admission path."""
        out = []
        bs = self.block_size
        stack = [(c, 1) for c in self._root.children.values()]
        while stack:
            node, depth = stack.pop()
            stack.extend((c, depth + 1)
                         for c in node.children.values())
            out.append({
                "fp": f"{node.fp:08x}",
                "depth": depth,
                "hits": node.hits,
                "last_tick": node.tick,
                "tokens_saved": node.hits * bs,
            })
        return out

    def stats(self):
        depth = 0
        stack = [(self._root, 0)]
        while stack:
            node, d = stack.pop()
            depth = max(depth, d)
            stack.extend((c, d + 1) for c in node.children.values())
        return {"indexed_blocks": len(self._by_block), "depth": depth}
