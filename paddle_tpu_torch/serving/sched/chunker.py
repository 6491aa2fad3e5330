"""Chunked-prefill planning (the port's own copy of
``paddle_tpu/serving/sched/chunker.py``).

A long prompt splits into fixed-width chunks that interleave with decode
steps under a per-step token budget. Interior chunks tile from the
start; the FINAL chunk is end-aligned at ``[n - chunk, n)``: it may
re-cover a suffix of the previous chunk (those K/V rows recompute to the
same values, each row being a function of the rows below it), but no
dispatch writes a K/V row at a position >= n.
"""


class ChunkPlan:
    """One request's remaining chunked-prefill schedule over
    ``req.prefill_ids``, snapshotted when the plan is made."""

    __slots__ = ("req", "slot", "ids", "starts", "next", "chunk",
                 "start0")

    def __init__(self, req, slot, start0, chunk):
        self.req = req
        self.slot = slot
        self.ids = req.prefill_ids
        self.chunk = int(chunk)
        self.start0 = int(start0)       # cached-prefix end (paged)
        self.starts = plan_chunks(self.start0, len(self.ids), self.chunk)
        self.next = 0                   # index of the next chunk

    @property
    def final_is_next(self):
        return self.next == len(self.starts) - 1

    def peek(self):
        """(start, length, final) of the next chunk to dispatch."""
        start = self.starts[self.next]
        return start, min(self.chunk, len(self.ids) - start), \
            self.final_is_next

    def advance(self):
        self.next += 1


def plan_chunks(start0, prompt_len, chunk):
    """Chunk starts covering ``[start0, prompt_len)`` with full-width
    dispatches: interior chunks tile from ``start0``, the final one is
    end-aligned at ``prompt_len - chunk``. Requires ``prompt_len -
    start0 > chunk`` (shorter tails take the unchunked prefill)."""
    tail = prompt_len - start0
    if tail <= chunk:
        raise ValueError(
            f"tail {tail} does not need chunking at chunk={chunk}")
    m = -(-tail // chunk)
    starts = [start0 + i * chunk for i in range(m - 1)]
    starts.append(prompt_len - chunk)
    return starts
