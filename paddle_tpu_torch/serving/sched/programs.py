"""The chunked-prefill program over the slot-contiguous pool (a port of
``paddle_tpu/serving/sched/programs.py``).

``chunk_prefill(params, tokens [1, C], chunk_len, start, slot, final,
                toks [S], pos [S], kc, vc[, seed, temp, topk, topp])
                -> (first [1], toks', pos')``

One chunk of one request's prompt in one call: the model's
``hidden_t`` runs over the slot's own view of the pool ``kc[:, slot]``
(written in place at ``start..start+C``, attending causally over the
earlier chunks below). ``start``, ``chunk_len``, ``slot`` and ``final``
are ints, or tensors read with ``int()`` (a device tensor costs a
sync). Only the FINAL chunk (``final != 0``) sets the slot's first token
(the argmax, or with ``sampling=True`` the sampling head with key index
``start + chunk_len - 1``, the prompt's last position, as the unchunked
prefill keys it) and ``pos[slot] = start + chunk_len``; an interior chunk
PARKS the slot at ``pos[slot] = cache_len - 1``, so the pooled decode
steps between chunks write their ignored row at the cache's last
position, never inside rows a chunk filled. ``toks``/``pos`` come back
as new tensors; the sampling parameters are ``[1]`` tensors.
"""
import torch

from ...text.models import decode_forward_builder
from .sampling import build_sampling_head


def build_chunk_fns(cfg, cache_len, sampling=False):
    """The chunk_prefill program for a GPT config over a ``[L,
    num_slots, nh, cache_len, hd]`` slot pool."""
    nh = cfg.num_heads
    _, hidden_t = decode_forward_builder(nh, cfg.hidden_size // nh,
                                         cfg.hidden_size)
    head = build_sampling_head(cfg.vocab_size) if sampling else None
    parked = int(cache_len) - 1

    def chunk_prefill(params, tokens, chunk_len, start, slot, final, toks,
                      pos, kc, vc, *samp):
        chunk_len, start, slot = int(chunk_len), int(start), int(slot)
        h = hidden_t(params, tokens, start, kc[:, slot:slot + 1],
                     vc[:, slot:slot + 1])
        last = h[0, chunk_len - 1] @ params["head"]          # [vocab]
        if head is None:
            first = last.argmax(-1).to(torch.int32).reshape(1)
        else:
            seed, temp, topk, topp = samp
            key = torch.full((1,), start + chunk_len - 1, dtype=torch.int64,
                             device=last.device)
            first = head(last[None], seed, key, temp, topk, topp)
        toks = toks.clone()
        pos = pos.clone()
        if int(final):
            toks[slot] = first[0]
            pos[slot] = start + chunk_len
        else:
            pos[slot] = parked
        return first, toks, pos

    return chunk_prefill
