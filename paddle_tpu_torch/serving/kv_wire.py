"""KV wire format for prefill/decode disaggregation, byte-compatible
with ``paddle_tpu/serving/kv_wire.py`` (``WIRE_VERSION`` 1).

The wire unit is the paged block: one frame per block, carrying its K
and V tiles ``[layers, heads, block_size, head_dim]`` base64-encoded and
a crc32 over K then V. A payload bundles the frames covering a
request's prompt (``ceil(prompt_len / block_size)`` blocks; the partial
last block ships whole, its tail rows scratch the decode side never
reads) with the prompt tokens and the first generated token, so the
decode side binds the blocks into its own pool and resumes at the first
decode step.

Everything here runs on the host: serialization never touches a pool,
and ``deserialize_handoff`` checks every frame's digest before it builds
a tensor, so a corrupted payload raises :class:`KVWireError` before the
importer changes anything. Tiles are CPU ``torch`` tensors (numpy
arrays are taken too). ``"bfloat16"`` tiles travel as their raw 16-bit
words and decode as ``uint16`` reinterpreted as ``torch.bfloat16``, so
no ``ml_dtypes`` is needed.
"""
import base64
import binascii
import zlib

import numpy as np
import torch

WIRE_VERSION = 1

# the wire's dtype names (numpy's) and the tensors they decode to; the
# bit pattern of each element is what travels
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


class KVWireError(RuntimeError):
    """A handoff payload failed validation (bad structure, shape or
    dtype drift against the importing pool, or a frame whose digest does
    not match its tiles). Raised before any pool change."""


class KVHandoff:
    """A decoded handoff: ``k``/``v`` ``[layers, n_blocks, heads,
    block_size, head_dim]`` CPU tensors in block-table row order, the
    prompt, the first token, ``wire_bytes`` (both caches' raw tile
    bytes, before base64) and ``trace``, the request's trace context in
    its dict form (None from an exporter that sent none; never
    validated here: the importer coerces it)."""

    __slots__ = ("prompt", "first_token", "block_size", "k", "v",
                 "wire_bytes", "trace")

    def __init__(self, prompt, first_token, block_size, k, v, wire_bytes,
                 trace=None):
        self.prompt = prompt
        self.first_token = int(first_token)
        self.block_size = int(block_size)
        self.k = k
        self.v = v
        self.wire_bytes = int(wire_bytes)
        self.trace = trace

    @property
    def n_blocks(self):
        return self.k.shape[1]


def blocks_for_prompt(prompt_len, block_size):
    """Leading row blocks a prompt's K/V occupies (the partial last
    block counts whole)."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    return -(-int(prompt_len) // int(block_size))


def _as_tensor(tiles):
    if isinstance(tiles, torch.Tensor):
        return tiles.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(tiles))


def _raw(t):
    """The bytes of a contiguous CPU tensor, element bits as they are."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def serialize_handoff(k_tiles, v_tiles, prompt, first_token,
                      trace=None):
    """Pack prompt-covering block tiles ``[layers, n_blocks, heads,
    block_size, head_dim]`` (in block-table row order) into a JSON-safe
    handoff dict. ``trace`` (a TraceContext or its dict form) rides
    along, so the decode tier's import joins the same trace and keeps
    the tenant in its baggage."""
    k_tiles, v_tiles = _as_tensor(k_tiles), _as_tensor(v_tiles)
    if k_tiles.dim() != 5 or k_tiles.shape != v_tiles.shape:
        raise ValueError(
            f"k/v tiles must be identical 5-D [layers, n_blocks, heads, "
            f"block_size, head_dim] tensors, got {tuple(k_tiles.shape)} / "
            f"{tuple(v_tiles.shape)}")
    if k_tiles.dtype != v_tiles.dtype:
        raise ValueError(f"k/v tile dtype mismatch: {k_tiles.dtype} vs "
                         f"{v_tiles.dtype}")
    if k_tiles.dtype not in _NAMES:
        raise ValueError(f"no wire name for tile dtype {k_tiles.dtype}")
    layers, n_blocks, heads, block_size, head_dim = k_tiles.shape
    prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
    if not prompt:
        raise ValueError("empty prompt")
    need = blocks_for_prompt(len(prompt), block_size)
    if n_blocks != need:
        raise ValueError(
            f"{len(prompt)} prompt tokens need {need} blocks of "
            f"{block_size}, got {n_blocks} tiles")
    frames = []
    for i in range(n_blocks):
        kb = _raw(k_tiles[:, i].contiguous())
        vb = _raw(v_tiles[:, i].contiguous())
        frames.append({
            "k": base64.b64encode(kb).decode("ascii"),
            "v": base64.b64encode(vb).decode("ascii"),
            "digest": zlib.crc32(vb, zlib.crc32(kb)) & 0xFFFFFFFF,
        })
    payload = {
        "version": WIRE_VERSION,
        "dtype": _NAMES[k_tiles.dtype],
        "tile_shape": [int(layers), int(heads), int(block_size),
                       int(head_dim)],
        "tile_bytes": int(k_tiles[:, 0].numel() * k_tiles.element_size()),
        "prompt": prompt,
        "first_token": int(first_token),
        "frames": frames,
    }
    if trace is not None:
        payload["trace"] = trace if isinstance(trace, dict) \
            else trace.as_dict()
    return payload


def payload_wire_bytes(payload):
    """Raw K+V tile bytes a payload carries (before base64)."""
    try:
        return 2 * int(payload["tile_bytes"]) * len(payload["frames"])
    except (KeyError, TypeError) as e:
        raise KVWireError(f"malformed handoff payload: {e!r}") from None


def _decode(raw, dtype, shape):
    if dtype == torch.bfloat16:
        arr = np.frombuffer(raw, np.int16)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).reshape(
            shape)
    arr = np.frombuffer(raw, np.dtype(_NAMES[dtype]))
    return torch.from_numpy(arr.copy()).reshape(shape)


def deserialize_handoff(payload):
    """Decode and verify a handoff payload into a :class:`KVHandoff`.
    Every frame's crc32 is checked before any tensor is built;
    structural faults and digest mismatches raise :class:`KVWireError`."""
    if not isinstance(payload, dict):
        raise KVWireError(f"handoff payload must be a dict, got "
                          f"{type(payload).__name__}")
    if payload.get("version") != WIRE_VERSION:
        raise KVWireError(
            f"unsupported wire version {payload.get('version')!r} (this "
            f"importer speaks {WIRE_VERSION})")
    try:
        name = str(payload["dtype"])
        layers, heads, block_size, head_dim = (
            int(d) for d in payload["tile_shape"])
        prompt = [int(t) for t in payload["prompt"]]
        first_token = int(payload["first_token"])
        frames = payload["frames"]
    except (KeyError, TypeError, ValueError) as e:
        raise KVWireError(f"malformed handoff payload: {e!r}") from None
    if name not in _DTYPES:
        raise KVWireError(f"unknown tile dtype {name!r}")
    dtype = _DTYPES[name]
    if not prompt:
        raise KVWireError("handoff payload has an empty prompt")
    need = blocks_for_prompt(len(prompt), block_size)
    if not isinstance(frames, list) or len(frames) != need:
        raise KVWireError(
            f"{len(prompt)} prompt tokens need {need} frames of "
            f"block_size {block_size}, payload has "
            f"{len(frames) if isinstance(frames, list) else frames!r}")
    tile_shape = (layers, heads, block_size, head_dim)
    tile_bytes = int(np.prod(tile_shape)) * torch.finfo(dtype).bits // 8
    raws = []
    for i, frame in enumerate(frames):
        try:
            kb = base64.b64decode(frame["k"], validate=True)
            vb = base64.b64decode(frame["v"], validate=True)
            digest = int(frame["digest"])
        except (KeyError, TypeError, ValueError, binascii.Error) as e:
            raise KVWireError(f"malformed frame {i}: {e!r}") from None
        if len(kb) != tile_bytes or len(vb) != tile_bytes:
            raise KVWireError(
                f"frame {i} tile size {len(kb)}/{len(vb)} != expected "
                f"{tile_bytes} for shape {tile_shape} {name}")
        got = zlib.crc32(vb, zlib.crc32(kb)) & 0xFFFFFFFF
        if got != digest & 0xFFFFFFFF:
            raise KVWireError(
                f"frame {i} digest mismatch: payload says "
                f"{digest & 0xFFFFFFFF:#010x}, tiles hash {got:#010x}; "
                f"import refused")
        raws.append((kb, vb))
    k = torch.stack([_decode(kb, dtype, tile_shape) for kb, _ in raws], 1)
    v = torch.stack([_decode(vb, dtype, tile_shape) for _, vb in raws], 1)
    return KVHandoff(prompt, first_token, block_size, k, v,
                     2 * tile_bytes * len(raws), trace=payload.get("trace"))
