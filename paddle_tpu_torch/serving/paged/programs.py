"""Prefill and decode programs over the paged cache.

Ports ``paddle_tpu/serving/paged/programs.py`` (greedy, unchunked). Same
decode math as the model's ``decode_forward_builder``; the cache is
addressed through the fixed-shape block table. The programs run eagerly
and update ``kc``/``vc`` in place; the per-slot token and position
vectors ``toks``/``pos`` stay on the device and are returned as new
tensors, so a value already handed to the host read-back is never
overwritten.

  ``paged_prefill(params, tokens [1, B], tail_len, start, slot, bt_row,
                  toks, pos, kc, vc) -> (first [1], toks', pos')``
      One request's uncached tail prefills in one call: the slot's MB
      blocks gather into a position-ordered view ``[L, 1, nh, MB*BS,
      hd]`` (view index == cache position, so attention sees the cached
      prefix below ``start`` as if this slot had computed it), the tail's
      K/V land at ``start..start+B``, and the view scatters back. The
      first token is the argmax of the last prompt position's logits
      (the only row the head multiplies);
      ``pos[slot] = start + tail_len``.

  ``paged_decode(params, toks [S], pos [S], tables [S, MB], kc, vc)
                 -> (next [S], pos + 1)``
      Every slot advances a token: each writes its new K/V row into
      block ``tables[s, wpos // BS]`` at offset ``wpos % BS`` and attends
      through the paged decode kernel with ``lengths = pos + 1``. The
      write position is clamped as a whole to the row's last entry
      (``wpos = min(pos, MB*BS - 1)``): parked and released slots keep
      incrementing ``pos``, and the clamp pins their stray write to that
      one always-private (or trash) entry. The position-embedding index
      is clamped the same way.

Table padding and released rows point at the trash block, so stray
writes land in garbage and the length mask keeps garbage at exactly
zero weight.
"""
import torch

from ...ops.paged_attention import paged_decode_attention
from ...text.models import decode_forward_builder


def build_paged_fns(cfg, num_slots, block_size, num_blocks,
                    blocks_per_slot, sampling=False):
    """``(paged_prefill, paged_decode)`` for a GPT config."""
    if sampling:
        raise NotImplementedError(
            "sampling: the per-slot sampling head comes with the "
            "serving.sched slice; this slice serves greedy requests")
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    hidden = cfg.hidden_size
    ln, hidden_t = decode_forward_builder(nh, hd, hidden)
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

    def paged_prefill(params, tokens, tail_len, start, slot, bt_row, toks,
                      pos, kc, vc):
        kctx = gather_slot(kc, bt_row)
        vctx = gather_slot(vc, bt_row)
        h = hidden_t(params, tokens, start, kctx, vctx)
        scatter_slot(kc, bt_row, kctx)
        scatter_slot(vc, bt_row, vctx)
        # only the last prompt position's logits are needed
        first = (h[0, tail_len - 1] @ params["head"]).argmax(-1).to(
            torch.int32)
        toks = toks.clone()
        toks[slot] = first
        pos = pos.clone()
        pos[slot] = start + tail_len
        return first.reshape(1), toks, pos

    def paged_decode(params, toks, pos, tables, kc, vc):
        S = toks.shape[0]
        x = params["wemb"][toks.long()] + params["pemb"][
            pos.clamp(max=params["pemb"].shape[0] - 1).long()]
        wpos = pos.clamp(max=C - 1).long()
        bidx = tables.long().gather(1, (wpos // BS)[:, None])[:, 0]
        off = wpos % BS
        lengths = pos + 1
        for i, p in enumerate(params["layers"]):
            h_ = ln(x, p["ln1_w"], p["ln1_b"])
            qkv = (h_ @ p["qkv_w"] + p["qkv_b"]).reshape(S, 3, nh, hd)
            q = qkv[:, 0].contiguous()
            kcl, vcl = kc[i], vc[i]
            # per-slot row write into its current block: advanced
            # indexing [S], :, [S] scatters [S, nh, hd]
            kcl[bidx, :, off] = qkv[:, 1]
            vcl[bidx, :, off] = qkv[:, 2]
            o = paged_decode_attention(q, kcl, vcl, tables, lengths)
            x = x + (o.reshape(S, hidden) @ p["out_w"] + p["out_b"])
            h2 = ln(x, p["ln2_w"], p["ln2_b"])
            m = torch.nn.functional.gelu(h2 @ p["fc1_w"] + p["fc1_b"],
                                         approximate="tanh")
            x = x + (m @ p["fc2_w"] + p["fc2_b"])
        logits = ln(x, params["lnf_w"], params["lnf_b"]) @ params["head"]
        return logits.argmax(-1).to(torch.int32), pos + 1

    return paged_prefill, paged_decode
