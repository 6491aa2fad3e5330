"""The k-token verify programs of speculative decoding (a port of
``paddle_tpu/serving/spec/programs.py``): the decode forward over
``[S, k+1]`` positions in one call, each slot's last accepted token and
its k drafts.

  ``spec_verify(params, toks [S], pos [S], drafts [S, k], dlen [S],
                kc, vc) -> (out [S, k+1], accepted [S], toks', pos')``

  ``paged_spec_verify(params, toks, pos, drafts, dlen, tables [S, MB],
                      kc, vc) -> (out, accepted, toks', pos')``

``dlen`` is each slot's real draft length (0: the slot decodes one
token, as the plain decode would). ``out[s, i]`` is the argmax after
input position i; query i attends over ``kpos <= pos + i`` only
(``ops.attention.cached_*_block_attention``), so its logits depend only
on drafts that are accepted whenever ``out[s, i]`` is read. Draft i is
accepted iff it is real, equals ``out[s, i]`` and every earlier draft
was accepted; ``accepted`` is that longest prefix, the next token is the
bonus ``out[s, accepted]`` and positions advance by ``accepted + 1``, all
on the device. Rejected rows stay in the cache beyond the length every
later query sees, and are overwritten before they are read.

The cache is written in place. Slot pool: a windowed read-merge-write,
the t-row window at ``min(pos, C - t)`` keeping rows below ``pos`` and
taking the new rows from ``pos`` on (a parked slot, ``pos >= C``, writes
nothing). Paged pool: each candidate row's whole position clamped to
``C - 1`` and rows past the slot's range routed to the trash block.
"""
import torch

from ...ops.attention import (cached_paged_block_attention,
                              cached_slot_block_attention)
from ...text.models import decode_forward_builder


def _verify_core(cfg, t):
    """``run(params, toks, pos, drafts, dlen, attend) -> (out, accepted,
    toks', pos')`` for ``layers_t`` and the acceptance rule."""
    nh = cfg.num_heads
    layers_t, _ = decode_forward_builder(nh, cfg.hidden_size // nh,
                                         cfg.hidden_size)

    def run(params, toks, pos, drafts, dlen, attend):
        tok_blk = torch.cat([toks[:, None], drafts], 1).long()
        qpos = pos[:, None] + torch.arange(t, device=pos.device)[None, :]
        x = params["wemb"][tok_blk] + params["pemb"][
            qpos.clamp(max=params["pemb"].shape[0] - 1).long()]
        h = layers_t(params, x, lambda i, q, k, v: attend(i, q, k, v, qpos))
        out = (h @ params["head"]).argmax(-1).to(torch.int32)   # [S, t]
        return _accept(out, drafts, dlen, pos)

    return run


def build_spec_verify_fn(cfg, num_slots, cache_len, k):
    """The slot-pool verify program (caches ``[L, S, nh, C, hd]``)."""
    C = int(cache_len)
    t = int(k) + 1
    if not 1 <= t <= C:
        raise ValueError(f"spec_k+1 ({t}) must fit the cache ({C})")
    run = _verify_core(cfg, t)

    def spec_verify(params, toks, pos, drafts, dlen, kc, vc):
        S = toks.shape[0]
        dev = toks.device
        rows = torch.arange(t, device=dev)[None, :]
        wstart = pos.long().clamp(max=C - t)
        d = pos.long()[:, None] - wstart[:, None]   # >= t when parked
        take = rows >= d                                      # [S, t]
        src = (rows - d).clamp(min=0)
        sidx = torch.arange(S, device=dev)[:, None]
        widx = wstart[:, None] + rows                         # [S, t]

        def merge(cache, new):
            # new [S, nh, t, hd] -> rows shifted so window row r takes
            # candidate r - d; the window [S, t, nh, hd] keeps its rows
            # below d
            shifted = new.gather(2, src[:, None, :, None].expand_as(new))
            win = cache[sidx, :, widx]
            cache[sidx, :, widx] = torch.where(
                take[:, :, None, None], shifted.permute(0, 2, 1, 3), win)

        def attend(i, q, k_, v, qpos):
            merge(kc[i], k_)
            merge(vc[i], v)
            return cached_slot_block_attention(q, kc[i], vc[i], qpos)

        return run(params, toks, pos, drafts, dlen, attend)

    return spec_verify


def build_paged_spec_verify_fn(cfg, num_slots, block_size, num_blocks,
                               blocks_per_slot, k):
    """The paged-pool verify program (caches ``[L, NB, nh, BS, hd]``)."""
    BS = int(block_size)
    C = int(blocks_per_slot) * BS
    t = int(k) + 1
    if not 1 <= t <= C:
        raise ValueError(f"spec_k+1 ({t}) must fit the slot row ({C})")
    run = _verify_core(cfg, t)

    def paged_spec_verify(params, toks, pos, drafts, dlen, tables, kc, vc):
        qpos = pos.long()[:, None] + torch.arange(t, device=pos.device)
        wpos = qpos.clamp(max=C - 1)
        bidx = tables.long().gather(1, wpos // BS)
        bidx = torch.where(qpos <= C - 1, bidx, torch.zeros_like(bidx))
        off = wpos % BS

        def attend(i, q, k_, v, qpos):
            # advanced-index scatter: [S, t] blocks x offsets take
            # [S, t, nh, hd]
            kc[i][bidx, :, off] = k_.permute(0, 2, 1, 3)
            vc[i][bidx, :, off] = v.permute(0, 2, 1, 3)
            return cached_paged_block_attention(q, kc[i], vc[i], tables,
                                                qpos)

        return run(params, toks, pos, drafts, dlen, attend)

    return paged_spec_verify


def _accept(out, drafts, dlen, pos):
    """Longest accepted prefix on the device: draft i counts iff it is
    real (``i < dlen``), equals ``out[s, i]`` and every earlier draft
    counted; the next token is ``out[s, accepted]``."""
    k = drafts.shape[1]
    m = (out[:, :k] == drafts) & (
        torch.arange(k, device=out.device)[None, :] < dlen[:, None])
    accepted = torch.cumprod(m.to(torch.int32), 1).sum(1).to(torch.int32)
    nxt = out.gather(1, accepted[:, None].long())[:, 0]
    return out, accepted, nxt, (pos + accepted + 1).to(torch.int32)
