"""Prefill and decode programs over the paged cache.

Ports ``paddle_tpu/serving/paged/programs.py``. Same decode math as the
model's ``decode_forward_builder``; the cache is addressed through the
fixed-shape block table. The programs run eagerly and update ``kc``/
``vc`` in place; the per-slot token and position vectors ``toks``/``pos``
stay on the device and are returned as new tensors, so a value already
handed to the host read-back is never overwritten.

  ``paged_prefill(params, tokens [1, B], tail_len, start, slot, final,
                  bt_row, toks, pos, kc, vc[, seed, temp, topk, topp])
                  -> (first [1], toks', pos')``
      One request's uncached tail, or one chunk of it, in one call: the
      slot's MB blocks gather into a position-ordered view ``[L, 1, nh,
      MB*BS, hd]`` (view index == cache position, so attention sees the
      cached prefix below ``start`` as if this slot had computed it), the
      tail's K/V land at ``start..start+B``, and the view scatters back.
      Only a ``final != 0`` call sets the slot's first token (the argmax
      of the logits at ``tail_len - 1``, or with ``sampling=True`` the
      sampling head with key index ``start + tail_len - 1``) and
      ``pos[slot] = start + tail_len``; an interior chunk parks the slot
      at ``pos[slot] = MB*BS - 1``, the row's last entry, so the decode
      steps between chunks never write inside rows a chunk filled.

  ``paged_decode(params, toks [S], pos [S], tables [S, MB], kc, vc[,
                 seeds, temps, topks, topps]) -> (next [S], pos + 1)``
      Every slot advances a token: each writes its new K/V row into
      block ``tables[s, wpos // BS]`` at offset ``wpos % BS`` and attends
      through the paged decode kernel with ``lengths = pos + 1``. The
      write position is clamped as a whole to the row's last entry
      (``wpos = min(pos, MB*BS - 1)``): parked and released slots keep
      incrementing ``pos``, and the clamp pins their stray write to that
      one always-private (or trash) entry. The position-embedding index
      is clamped the same way. With ``sampling=True`` the next token
      comes from the sampling head with key index ``pos``.

Table padding and released rows point at the trash block, so stray
writes land in garbage and the length mask keeps garbage at exactly
zero weight.
"""
import torch

from ...ops.paged_attention import paged_decode_attention
from ...text.models import decode_forward_builder
from ..sched.sampling import build_sampling_head


def build_paged_fns(cfg, num_slots, block_size, num_blocks,
                    blocks_per_slot, sampling=False):
    """``(paged_prefill, paged_decode)`` for a GPT config."""
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    layers_t, hidden_t = decode_forward_builder(nh, hd, cfg.hidden_size)
    head = build_sampling_head(cfg.vocab_size) if sampling else None
    L = cfg.num_layers
    BS = int(block_size)
    MB = int(blocks_per_slot)
    C = MB * BS   # one slot's gathered contiguous context length

    def gather_slot(cache, bt_row):
        # [L, NB, nh, BS, hd] + row [MB] -> [L, 1, nh, MB*BS, hd]
        g = cache.index_select(1, bt_row)            # [L, MB, nh, BS, hd]
        return g.permute(0, 2, 1, 3, 4).reshape(L, nh, C, hd)[:, None]

    def scatter_slot(cache, bt_row, view):
        # inverse of gather_slot; padding entries all name the trash
        # block, so their duplicate writes land in garbage
        blocks = view[:, 0].reshape(L, nh, MB, BS, hd).permute(0, 2, 1, 3, 4)
        cache[:, bt_row] = blocks

    def paged_prefill(params, tokens, tail_len, start, slot, final, bt_row,
                      toks, pos, kc, vc, *samp):
        kctx = gather_slot(kc, bt_row)
        vctx = gather_slot(vc, bt_row)
        h = hidden_t(params, tokens, start, kctx, vctx)
        scatter_slot(kc, bt_row, kctx)
        scatter_slot(vc, bt_row, vctx)
        # only the last prompt position's logits are needed
        last = h[0, tail_len - 1] @ params["head"]
        if head is None:
            first = last.argmax(-1).to(torch.int32).reshape(1)
        else:
            key = torch.full((1,), start + tail_len - 1, dtype=torch.int64,
                             device=last.device)
            first = head(last[None], samp[0], key, *samp[1:])
        toks = toks.clone()
        pos = pos.clone()
        if final:
            toks[slot] = first[0]
            pos[slot] = start + tail_len
        else:
            pos[slot] = C - 1
        return first, toks, pos

    def paged_decode(params, toks, pos, tables, kc, vc, *samp):
        x = params["wemb"][toks.long()] + params["pemb"][
            pos.clamp(max=params["pemb"].shape[0] - 1).long()]
        wpos = pos.clamp(max=C - 1).long()
        bidx = tables.long().gather(1, (wpos // BS)[:, None])[:, 0]
        off = wpos % BS
        lengths = pos + 1

        def attend(i, q, k, v):
            # q/k/v [S, nh, 1, hd]: each slot's row into its current
            # block (advanced indexing [S], :, [S] scatters [S, nh, hd])
            kc[i][bidx, :, off] = k[:, :, 0]
            vc[i][bidx, :, off] = v[:, :, 0]
            return paged_decode_attention(q[:, :, 0].contiguous(), kc[i],
                                          vc[i], tables, lengths)[:, :, None]

        logits = layers_t(params, x[:, None], attend)[:, 0] @ params["head"]
        if head is None:
            nxt = logits.argmax(-1).to(torch.int32)
        else:
            nxt = head(logits, samp[0], pos, *samp[1:])
        return nxt, pos + 1

    return paged_prefill, paged_decode
