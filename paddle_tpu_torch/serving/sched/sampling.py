"""Per-slot sampling inside the pooled decode and prefill programs
(a port of ``paddle_tpu/serving/sched/sampling.py``).

Semantics are the reference's: ``logits / max(temperature, 1e-6)``;
top-k keeps ties (``lg < kth`` is masked); top-p keeps, in sorted order,
each token whose PRECEDING cumulative probability is below p (the first
always stays); both masks compose; a row with ``temperature <= 0`` or
``top_k == 1`` takes the argmax of the raw logits. Sampling parameters
are ``[num_slots]`` tensors, so a greedy and a sampled request share one
dispatch.

The draw differs from the reference's ``fold_in(PRNGKey(seed),
position)`` keys: it is a stateless counter-based one. An integer hash
of ``(seed, key index, vocab index)`` in int64 torch ops (every value
below 2^32 and every product below 2^63, so nothing overflows) gives 24
uniform bits, ``u = (bits + 0.5) / 2^24`` in (0, 1), and the token is
the Gumbel-max ``argmax(masked_logits - log(-log(u)))``. The noise so
depends only on the request's seed and the token's position: not on the
slot, the batch, chunking or the device, and the card and the CPU draw
the same bits. A sampled stream follows the reference's distribution,
not its tokens. No ``torch.Generator`` and no host sync are involved.
"""
import numpy as np
import torch

MASKED = -1e30
_M32 = 0xFFFFFFFF
# odd multipliers below 2^31: a product with a 32-bit value stays below
# 2^63
_C1 = 0x7FEB352D
_C2 = 0x5BD1E995
_C3 = 0x2545F491


def _mix32(x):
    """A 32-bit integer finalizer on int64 values in ``[0, 2^32)``."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds, key_idx, vocab_size):
    """``[N, V]`` float32 Gumbel noise for rows ``(seeds[n],
    key_idx[n])``: a function of those two integers and the vocab index
    only."""
    h = _mix32(_mix32(seeds.long() & _M32) ^ (key_idx.long() & _M32))
    v = torch.arange(int(vocab_size), device=seeds.device)
    x = _mix32(_mix32(h[:, None] ^ ((v * _C3) & _M32)))
    u = ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def masked_logits(logits, temps, topks, topps):
    """``logits / max(temps, 1e-6)`` with the top-k and top-p masks
    applied (masked entries ``MASKED``); ``topks <= 0`` disables top-k,
    ``topps >= 1`` top-p."""
    V = logits.shape[-1]
    lg = logits.float() / temps.float().clamp(min=1e-6)[:, None]
    srt = torch.sort(lg, dim=-1, descending=True).values
    k = topks.long().clamp(1, V)
    kth = srt.gather(1, (k - 1)[:, None])
    mask_k = (topks > 0)[:, None] & (lg < kth)
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < topps.float()[:, None]
    pthresh = torch.where(keep, srt, torch.full((), float("inf"),
                                                device=lg.device)).amin(-1)
    mask_p = (topps < 1.0)[:, None] & (lg < pthresh[:, None])
    return lg.masked_fill(mask_k | mask_p, MASKED)


def build_sampling_head(vocab_size):
    """``sample(logits [N, V], seeds, key_idx, temps, topks, topps) ->
    [N] int32`` with every parameter an ``[N]`` tensor on the logits'
    device (seeds/key_idx/topks integer, temps/topps float)."""
    V = int(vocab_size)

    def sample(logits, seeds, key_idx, temps, topks, topps):
        greedy = (temps <= 0.0) | (topks == 1)
        drawn = (masked_logits(logits, temps, topks, topps)
                 + gumbel_noise(seeds, key_idx, V)).argmax(-1)
        return torch.where(greedy, logits.argmax(-1), drawn).to(
            torch.int32)

    return sample


def request_sampling_params(req):
    """``(seed, temperature, top_k, top_p)`` of one request; a greedy
    request takes the all-disabled tuple, so a slot recycled from a
    sampled occupant never inherits its noise."""
    if getattr(req, "sampled", False):
        return (int(req.seed), float(req.temperature), int(req.top_k),
                float(req.top_p))
    return (0, 0.0, 0, 1.0)


class SlotSampler:
    """Per-slot sampling parameters, authored on the host and uploaded
    by ``device_arrays()`` only when an admission changed them."""

    def __init__(self, num_slots, device):
        S = int(num_slots)
        self.device = torch.device(device)
        self.seeds = np.zeros((S,), np.int64)
        self.temps = np.zeros((S,), np.float32)
        self.topks = np.zeros((S,), np.int32)
        self.topps = np.ones((S,), np.float32)
        self._dev = None
        self._dirty = True

    def set_slot(self, slot, req):
        (self.seeds[slot], self.temps[slot], self.topks[slot],
         self.topps[slot]) = request_sampling_params(req)
        self._dirty = True

    def device_arrays(self):
        """(seeds, temps, topks, topps) on the device."""
        if self._dev is None or self._dirty:
            self._dev = upload_params(
                (self.seeds, self.temps, self.topks, self.topps),
                self.device)
            self._dirty = False
        return self._dev

    @staticmethod
    def gather(requests):
        """``[G]`` host arrays of a grouped prefill's members."""
        rows = [request_sampling_params(r) for r in requests]
        return (np.array([r[0] for r in rows], np.int64),
                np.array([r[1] for r in rows], np.float32),
                np.array([r[2] for r in rows], np.int32),
                np.array([r[3] for r in rows], np.float32))


def upload_params(arrays, device):
    """Host arrays as device tensors, queued without waiting for the
    card (pageable memory is staged before the call returns)."""
    return tuple(torch.from_numpy(np.array(a)).to(device, non_blocking=True)
                 for a in arrays)
