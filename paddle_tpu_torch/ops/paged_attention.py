"""Paged decode attention: the hand-written kernel K4 and its plain
version.

Ports ``paddle_tpu/ops/paged_attention.py``. One new-token query per
slot attends over that slot's live cache rows, read in place from the
paged pool ``[num_blocks, nh, BS, hd]`` through the slot's block-table
row; the ``[S, nh, MB*BS, hd]`` gathered view of the plain version is
never built.

On a CUDA tensor ``paged_decode_attention`` always launches
``csrc/paged_decode.cu`` (there is no opt-in gate as the reference had)
and raises on operands the kernel does not take. On a CPU tensor it
computes ``paged_decode_plain``, which is
``ops.attention.cached_paged_attention`` in the query's dtype.

The kernel splits each slot's rows into chunks of whole pages
(``decode_chunks``), one block a (chunk, head, slot), and merges the
chunks' partials in a second launch; the workspace for them comes from
PyTorch's caching allocator. The chunking depends only on the static
shapes, so ``lengths`` never goes to the host.
"""
import ctypes
import threading

import torch

from . import _build
from .attention import cached_paged_attention

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bytes of K a chunk of the kernel reads for one head (and as many of V):
# one round of loads of its 128 threads, 16 bytes x 8 rows a lane
CHUNK_BYTES = 16 << 10


def decode_chunks(block_size, max_blocks, head_dim, itemsize):
    """``(pages, chunks)``: whole pages a chunk of K4 reads, at least one
    and at most ``max_blocks``, so that a chunk holds about
    ``CHUNK_BYTES`` of K a head; and the chunks a slot has, which fix the
    kernel's grid and the workspace whatever the lengths are."""
    rows = max(1, CHUNK_BYTES // (head_dim * itemsize))
    pages = max(1, min(max_blocks, rows // block_size))
    return pages, -(-max_blocks // pages)


def paged_decode_plain(q, k_cache, v_cache, block_tables, lengths):
    """Plain version of K4: the gather-to-contiguous composition, cast
    to q's dtype as the kernel writes it."""
    return cached_paged_attention(q, k_cache, v_cache, block_tables,
                                  lengths).to(q.dtype)


def _check_operands(q, k_cache, v_cache, block_tables, lengths):
    if q.dim() != 3:
        raise ValueError(f"paged kernel: q must be [S, nh, hd], got "
                         f"{tuple(q.shape)}")
    S, nh, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[1] != nh or k_cache.shape[3] != hd:
        raise ValueError(
            f"paged kernel: caches must be [NB, {nh}, BS, {hd}], got "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(f"paged kernel: block_tables must be [{S}, MB], "
                         f"got {tuple(block_tables.shape)}")
    if tuple(lengths.shape) != (S,):
        raise ValueError(f"paged kernel: lengths must be [{S}], got "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"paged kernel takes float32/bfloat16, got "
                        f"{q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("paged kernel: q and the caches must share a dtype")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged kernel: block_tables and lengths must be "
                        "int32")
    if hd not in (32, 64, 128):
        raise ValueError(f"paged kernel takes head_dim 32, 64 or 128, got "
                         f"{hd}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged kernel: {name} is on {t.device}, q "
                             f"on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged kernel: {name} is not contiguous")


def paged_decode_attention(q, k_cache, v_cache, block_tables, lengths):
    """Same signature and semantics as ``cached_paged_attention``; the
    output has q's dtype. Counts each call's launch (the chunks and the
    merge of their partials) in ``paged_decode_attention.launches``."""
    if q.device.type in ("cpu", "meta"):
        return paged_decode_plain(q, k_cache, v_cache, block_tables,
                                  lengths)
    if not q.is_cuda:
        raise ValueError(f"paged kernel: unsupported device {q.device}")
    _check_operands(q, k_cache, v_cache, block_tables, lengths)
    S, nh, hd = q.shape
    out = torch.empty_like(q)
    if S == 0 or nh == 0:
        return out
    bs, mb = k_cache.shape[2], block_tables.shape[1]
    pages, chunks = decode_chunks(bs, mb, hd, q.element_size())
    ws = torch.empty(S * nh * chunks * (hd + 2), dtype=torch.float32,
                     device=q.device)
    fn = _build.function(
        "paged_decode", "paged_decode_attention",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             ws.data_ptr(), S, nh, hd, bs, mb, pages,
             _KERNEL_DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    with _count_lock:   # engines on several threads launch it at once
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
_count_lock = threading.Lock()
