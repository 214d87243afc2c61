"""K5 / K2 / K3 / K12: decode attention against a KV cache (CUDA: K5 in
``csrc/decode_attention.cu``, K2, K3 and K12 in
``csrc/decode_block_attention.cu``); K10: against a quantized cache
(``csrc/decode_attention_quant.cu``). All five run one split-key body,
``csrc/decode_split.cuh``.

Port of ``decode_attention``, ``decode_attention_layer``,
``decode_block_attention_layer``, ``decode_block_attention`` and
``decode_attention_quant`` from
``tpu_voice_agent/ops/decode_attention.py``, with the JAX signatures (the
Pallas tile size ``block_k`` and ``interpret`` dropped).

- K5 (T = 1, flat ``(B, S, nkv, hd)`` cache, bf16 or fp32): query b attends
  slots ``[0, kv_len[b])``; the Whisper decoder's self- and cross-attention.
  S needs no padding to a tile multiple; a row with kv_len 0 gets zeros.
  K2's split body on the flat cache; at a group of at most 2 (Whisper's
  is 1) warp sets take key tiles side by side (``key_sets``).
- K2 (T = 1) on the stacked ``(L, B, S, nkv, hd)`` bf16 cache: the same on
  layer plane ``layer``, a Python int (``k_cache[layer]`` is a free
  contiguous view, so the kernel gets that plane's pointer). K3's split body
  at T = 1, reading ``kv_len`` itself: one launch a layer.
- K3 (T <= 16, the grammar fast-forward block): query i of row b attends
  slots ``[0, q_positions[b, i]]``; positions may be unordered or repeat.
  The kernel splits the key range into chunks of ``key_chunk(B, S, nkv)``
  keys, one block each; the last block of each group of 8 splits to finish
  merges the group, and the last group merger merges the groups, each in
  a fixed order: one launch, the same bits run to run. The wrapper hands
  it the device's fp32 scratch (``_lib.scratch``, grown on demand) and
  ticket counters (``_lib.tickets``, which the kernel leaves at 0), so a
  call allocates nothing beyond its output.
- K12 (T <= 16) on a flat ``(B, S, nkv, hd)`` bf16 cache: K3's function and
  body on one cache, as the JAX package's ``decode_block_attention`` (which
  only its tests call; no engine here calls it either).
- K10 (T = 1, a flat ``(B, S, nkv, hdp)`` int8 cache with ``(B, S, nkv)``
  bf16 scales, int8 or packed int4 as ``ops.kvquant`` stores them): K5 over
  the quantized cache. No engine calls it (none in the JAX package either);
  K5's split body with K8's quantized tile loader.

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors, and only then.
"""

from __future__ import annotations

import functools

import torch

from ._lib import (
    HEAD_DIMS,
    QUANT_HEAD_DIMS,
    check,
    dtype_code,
    library,
    require,
    require_cuda,
    scratch,
    stream_of,
    tickets,
)
from .kvquant import dequantize_kv, kv_quant_of_bits

_NEG_INF = -1e30
MAX_BLOCK_T = 16
MAX_GROUP = 16
# The split body (K2, K3, K5, K10, K12) splits the key range into chunks of
# whole 32-key tiles: about two blocks per SM of the H100's 132 when every
# key of the cache is live. The merge runs in groups of 8 splits, at most 8
# groups; scratch entries and ticket counters per (row, kv head) follow
# (csrc/split_merge.cuh GROUP, MAX_SPLITS, TICKETS_PER_SLOT).
SPLIT_BLOCKS = 264
MERGE_GROUP = 8
MAX_SPLITS = MERGE_GROUP * MERGE_GROUP
TICKETS_PER_SLOT = 1 + MERGE_GROUP
# K5 / K10's warps-on-keys instantiation (csrc/decode_split.cuh KEY_SETS,
# KEY_SET_WARPS, KEY_SETS_MAX_HD): a block of 8 warps in 4 sets of 2, each
# set taking every 4th tile of a split, for at most 2 query rows and a head
# dim of at most 64
KEY_SETS = 4
KEY_SET_WARPS = 8
KEY_SETS_MAX_HD = 64


def key_chunk(B: int, S: int, nkv: int) -> int:
    """Keys per split of the split body, from the shapes alone (no device
    read): 32 at one tinyllama-1.1b row (S 2048, 4 kv heads: 64 splits), 64
    at mixtral-8x7b's 8 kv heads and at whisper-large-v3's 20 heads over 500
    encoder frames, 256 at 8 rows."""
    splits = max(1, min(MAX_SPLITS, SPLIT_BLOCKS // (B * nkv)))
    chunk = -(-S // splits)
    return -(-chunk // 32) * 32


# The paged tensor-core body of K7 / K9 with bf16 queries
# (csrc/paged_split.cuh TILE, MAX_ROWS): 64-key tiles, at most 128 query rows
# a launch; its picker aims at PAGED_LIVE_BLOCKS live blocks, two an SM, when
# every row's tables are half full.
PAGED_TILE = 64
PAGED_MAX_ROWS = 128
PAGED_LIVE_BLOCKS = 264
# Its T = 1 body (K6 / K8 with bf16 queries; paged_split.cuh KEY_SETS,
# T1_TILE): a block of PAGED_KEY_SETS warps, each taking every 4th 32-key
# tile of a split. The picker aims at as many live blocks as fit the H100's
# 132 SMs at once (``paged_t1_blocks_per_sm``).
PAGED_KEY_SETS = 4
PAGED_T1_TILE = 32
H100_SMS = 132


def paged_key_chunk(B: int, S: int, nkv: int) -> int:
    """Keys per split of the paged split body, from the shapes alone (no
    device read): whole 64-key tiles, at most ``MAX_SPLITS`` splits, and
    short enough that rows whose frontiers sit halfway into their tables
    (S / 2, the batched engines' ~1,000 of 2,048) leave at least
    ``PAGED_LIVE_BLOCKS`` live blocks: splits past a row's frontier return at
    once. 320 at the 32-slot batch (7 splits, 3-4 live), 192 at the 15-slot
    spec engine and at mixtral-8x7b's 8-slot drain."""
    per_row = -(-PAGED_LIVE_BLOCKS // (B * nkv))  # live splits a (row, kv head) needs
    chunk = (S // 2) // per_row // PAGED_TILE * PAGED_TILE
    fewest = -(-S // MAX_SPLITS)  # the widest splits MAX_SPLITS allow
    return max(chunk, -(-fewest // PAGED_TILE) * PAGED_TILE, PAGED_TILE)


def paged_t1_blocks_per_sm(hd: int) -> int:
    """T = 1 blocks that fit an SM: three at hd <= 64 (held to 128 registers,
    room for four; their shared memory, 76 KB at hd 64, fits three), two at
    hd 128 (229-247 registers a thread, ptxas: two 128-thread blocks fill the
    SM's 64K registers)."""
    return 3 if hd <= 64 else 2


def paged_t1_chunk(B: int, S: int, nkv: int, hd: int) -> int:
    """Keys per split of the paged T = 1 body (K6 / K8 with bf16 queries),
    from the shapes alone: whole steps of the block (one 32-key tile a warp),
    at most ``MAX_SPLITS`` splits, and as short as leaves rows whose kv_len
    sits halfway into their tables (S / 2) with no more live blocks than fit
    the card at once: a step's blocks run in one wave. 384 at the 32-slot
    batch (S 2048, 4 kv heads, hd 64: 3 live splits a (row, kv head), 384
    blocks of the 396 that fit), 256 at the 15-slot spec engine and at
    mixtral-8x7b's 8-slot drain (hd 128: 256 of 264), 128 at one row."""
    unit = PAGED_KEY_SETS * PAGED_T1_TILE  # a multiple of PAGED_TILE
    blocks = paged_t1_blocks_per_sm(hd) * H100_SMS
    per_row = max(1, blocks // (B * nkv))  # live splits a (row, kv head) may have
    chunk = -(-(S // 2) // (per_row * unit)) * unit
    fewest = -(-S // MAX_SPLITS)  # the widest splits MAX_SPLITS allow
    return max(chunk, -(-fewest // unit) * unit)


def key_sets(group: int, chunk: int, hd: int) -> int:
    """Warp sets of a T = 1 launch of K5 / K10: ``KEY_SETS`` where a split
    holds more than one tile and a kv head has at most KEY_SET_WARPS /
    KEY_SETS query rows (Whisper's group of 1 leaves 15 of K2's 16 warps
    without a row), else 1, the one-row-per-warp body K2 runs."""
    if group * KEY_SETS <= KEY_SET_WARPS and chunk > 32 and hd <= KEY_SETS_MAX_HD:
        return KEY_SETS
    return 1


@functools.lru_cache(maxsize=None)
def _split_plan(B: int, T: int, S: int, nq: int, nkv: int, hd: int) -> tuple[int, int, int]:
    """The chunk, the fp32 scratch floats and the ticket counters of one
    launch of the split body."""
    chunk = key_chunk(B, S, nkv)
    splits = -(-S // chunk)
    entries = splits + -(-splits // MERGE_GROUP)
    return chunk, B * nkv * entries * T * (nq // nkv) * (hd + 2), B * nkv * TICKETS_PER_SLOT


def _split_scratch(name, q, k_plane, v_plane, B, T, S, nq, nkv, hd):
    """The split body's chunk, fp32 scratch and ticket counters for a
    (B, T) block of queries over one (B, S, nkv, hd) plane: the device's
    shared buffers, no allocation per call."""
    require(all(t.data_ptr() % 16 == 0 for t in (q, k_plane, v_plane)), name,
            "q and the cache must be 16-byte aligned")
    chunk, floats, counters = _split_plan(B, T, S, nq, nkv, hd)
    return chunk, scratch(q.device, floats), tickets(q.device, counters)


def _block_attention(name, entry, q, k_plane, v_plane, q_positions, S, nkv, scale):
    """Launch K3 or K12 on one (B, S, nkv, hd) bf16 plane."""
    B, T, nq, hd = q.shape
    require_cuda(name, q_positions)
    require(1 <= T <= MAX_BLOCK_T, name, f"block of {T} queries (max {MAX_BLOCK_T})")
    require(q_positions.dtype == torch.int32 and q_positions.shape == (B, T), name,
            "q_positions must be (B, T) int32")
    chunk, part, counters = _split_scratch(name, q, k_plane, v_plane, B, T, S, nq, nkv, hd)
    out = torch.empty_like(q)
    err = entry(q.data_ptr(), k_plane.data_ptr(), v_plane.data_ptr(), q_positions.data_ptr(),
                out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, T, S, nq, nkv, hd, chunk,
                float(scale), dtype_code(name, q), stream_of(q))
    check(err, name)
    return out


def _check_common(name, q, k_cache, v_cache, layer, nq, hd):
    require_cuda(name, q, k_cache, v_cache)
    require(k_cache.dtype == v_cache.dtype == torch.bfloat16, name,
            "the cache must be bfloat16")
    require(k_cache.dim() == 5 and k_cache.shape == v_cache.shape, name,
            f"cache must be (L, B, S, nkv, hd), got {tuple(k_cache.shape)}")
    L, B, S, nkv, khd = k_cache.shape
    require(khd == hd and q.shape[0] == B, name, "q and cache disagree on B or hd")
    require(0 <= layer < L, name, f"layer {layer} outside [0, {L})")
    require(nq % nkv == 0 and nq // nkv <= MAX_GROUP, name,
            f"need nq % nkv == 0 and a group of at most {MAX_GROUP}")
    require(hd in HEAD_DIMS, name, f"head dim {hd} not in {HEAD_DIMS}")
    return B, S, nkv


def decode_attention(
    q: torch.Tensor,  # (B, nq, hd) — one query token per row
    k_cache: torch.Tensor,  # (B, S, nkv, hd)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) int32 valid keys per row
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, nq, hd) in q.dtype. q and the cache are all bfloat16 or
    all float32."""
    B, nq, hd = q.shape
    scale = scale if scale is not None else hd**-0.5
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, kv_len, scale=scale)
    name = "decode_attention"
    require_cuda(name, q, k_cache, v_cache, kv_len)
    require(k_cache.dim() == 4 and k_cache.shape == v_cache.shape, name,
            f"cache must be (B, S, nkv, hd), got {tuple(k_cache.shape)}")
    _, S, nkv, khd = k_cache.shape
    require(khd == hd and k_cache.shape[0] == B, name, "q and cache disagree on B or hd")
    require(nq % nkv == 0 and nq // nkv <= MAX_GROUP, name,
            f"need nq % nkv == 0 and a group of at most {MAX_GROUP}")
    require(hd in HEAD_DIMS, name, f"head dim {hd} not in {HEAD_DIMS}")
    require(q.dtype == k_cache.dtype == v_cache.dtype, name, "q, k and v must share one dtype")
    require(kv_len.dtype == torch.int32 and kv_len.shape == (B,), name,
            "kv_len must be (B,) int32")
    chunk, part, counters = _split_scratch(name, q, k_cache, v_cache, B, 1, S, nq, nkv, hd)
    out = torch.empty_like(q)
    err = library().tva_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, S, nq, nkv, hd, chunk,
        key_sets(nq // nkv, chunk, hd), float(scale), dtype_code(name, q), stream_of(q))
    check(err, name)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_layer(
    q: torch.Tensor,  # (B, nq, hd) — one query token per row
    k_cache: torch.Tensor,  # (L, B, S, nkv, hd) — the full stacked cache
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) int32 valid keys per row (frontier + 1)
    layer: int,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, nq, hd) in q.dtype."""
    B, nq, hd = q.shape
    scale = scale if scale is not None else hd**-0.5
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache[layer], v_cache[layer], kv_len,
                                          scale=scale)
    name = "decode_attention_layer"
    _, S, nkv = _check_common(name, q, k_cache, v_cache, layer, nq, hd)
    require_cuda(name, q, kv_len)
    require(kv_len.dtype == torch.int32 and kv_len.shape == (B,), name,
            "kv_len must be (B,) int32")
    kp, vp = k_cache[layer], v_cache[layer]
    chunk, part, counters = _split_scratch(name, q, kp, vp, B, 1, S, nq, nkv, hd)
    out = torch.empty_like(q)
    err = library().tva_decode_attention_layer(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), B, S, nq, nkv, hd, chunk, float(scale),
        dtype_code(name, q), stream_of(q))
    check(err, name)
    decode_attention_layer.launches += 1
    return out


decode_attention_layer.launches = 0


def decode_block_attention_layer(
    q: torch.Tensor,  # (B, T, nq, hd)
    k_cache: torch.Tensor,  # (L, B, S, nkv, hd)
    v_cache: torch.Tensor,
    q_positions: torch.Tensor,  # (B, T) int32
    layer: int,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, T, nq, hd) in q.dtype. The caller has already written
    the block's k/v at ``q_positions`` (forward's write-then-attend)."""
    B, T, nq, hd = q.shape
    scale = scale if scale is not None else hd**-0.5
    if q.device.type == "cpu":
        return decode_block_attention_reference(q, k_cache[layer], v_cache[layer],
                                                q_positions, scale=scale)
    name = "decode_block_attention_layer"
    _, S, nkv = _check_common(name, q, k_cache, v_cache, layer, nq, hd)
    out = _block_attention(name, library().tva_decode_block_attention_layer, q, k_cache[layer],
                           v_cache[layer], q_positions, S, nkv, scale)
    decode_block_attention_layer.launches += 1
    return out


decode_block_attention_layer.launches = 0


def decode_block_attention(
    q: torch.Tensor,  # (B, T, nq, hd)
    k_cache: torch.Tensor,  # (B, S, nkv, hd)
    v_cache: torch.Tensor,
    q_positions: torch.Tensor,  # (B, T) int32
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, T, nq, hd) in q.dtype: query i of row b attends slots
    ``[0, q_positions[b, i]]``, the block's own k/v already written there."""
    B, T, nq, hd = q.shape
    scale = scale if scale is not None else hd**-0.5
    if q.device.type == "cpu":
        return decode_block_attention_reference(q, k_cache, v_cache, q_positions, scale=scale)
    name = "decode_block_attention"
    require(k_cache.dim() == 4, name, f"cache must be (B, S, nkv, hd), got {tuple(k_cache.shape)}")
    _, S, nkv = _check_common(name, q, k_cache[None], v_cache[None], 0, nq, hd)
    out = _block_attention(name, library().tva_decode_block_attention, q, k_cache, v_cache,
                           q_positions, S, nkv, scale)
    decode_block_attention.launches += 1
    return out


decode_block_attention.launches = 0


def check_quant_cache(name, k, v, k_scale, v_scale, hd: int, bits: int) -> None:
    """A quantized cache or pool: int8 values of width ``hd`` (bits 8) or
    ``hd / 2`` (bits 4) and bf16 scales shaped like the values minus their
    last axis, at a head dim the kernels are built for."""
    require(bits in (8, 4), name, f"bits must be 8 or 4, got {bits}")
    require(k.dtype == v.dtype == torch.int8, name, "quantized values must be int8")
    require(k_scale.dtype == v_scale.dtype == torch.bfloat16, name, "scales must be bfloat16")
    require(k.shape == v.shape and k_scale.shape == v_scale.shape == k.shape[:-1], name,
            f"values {tuple(k.shape)} and scales {tuple(k_scale.shape)} disagree")
    require(k.shape[-1] == (hd if bits == 8 else hd // 2), name,
            f"stored width {k.shape[-1]} does not fit hd {hd} at {bits} bits")
    require(hd in QUANT_HEAD_DIMS, name, f"head dim {hd} not in {QUANT_HEAD_DIMS}")


def decode_attention_quant(
    q: torch.Tensor,  # (B, nq, hd)
    k_cache: torch.Tensor,  # (B, S, nkv, hdp) int8 stored values
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # (B, S, nkv) bf16
    v_scale: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) int32
    *,
    bits: int = 8,
    scale: float | None = None,
) -> torch.Tensor:
    """K5 against a quantized dense cache; any S. Returns (B, nq, hd) in
    q.dtype."""
    B, nq, hd = q.shape
    scale = scale if scale is not None else hd**-0.5
    if q.device.type == "cpu":
        return decode_attention_quant_reference(q, k_cache, v_cache, k_scale, v_scale, kv_len,
                                                bits=bits, scale=scale)
    name = "decode_attention_quant"
    require_cuda(name, q, k_cache, v_cache, k_scale, v_scale, kv_len)
    require(k_cache.dim() == 4, name, f"cache must be (B, S, nkv, hdp), got {tuple(k_cache.shape)}")
    check_quant_cache(name, k_cache, v_cache, k_scale, v_scale, hd, bits)
    _, S, nkv, _ = k_cache.shape
    require(k_cache.shape[0] == B, name, "q and cache disagree on B")
    require(nq % nkv == 0 and nq // nkv <= MAX_GROUP, name,
            f"need nq % nkv == 0 and a group of at most {MAX_GROUP}")
    require(kv_len.dtype == torch.int32 and kv_len.shape == (B,), name,
            "kv_len must be (B,) int32")
    chunk, part, counters = _split_scratch(name, q, k_cache, v_cache, B, 1, S, nq, nkv, hd)
    out = torch.empty_like(q)
    err = library().tva_decode_attention_quant(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kv_len.data_ptr(), out.data_ptr(), part.data_ptr(),
        counters.data_ptr(), B, S, nq, nkv, hd, chunk, key_sets(nq // nkv, chunk, hd),
        float(scale), bits, dtype_code(name, q), stream_of(q))
    check(err, name)
    decode_attention_quant.launches += 1
    return out


decode_attention_quant.launches = 0


def _softmax_pv(scores, valid, v, eq: str):
    """-1e30 mask -> softmax -> fp32 probabilities times fp32 values."""
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    return torch.einsum(eq, torch.softmax(scores, dim=-1), v.float())


def decode_attention_reference(q, k_cache, v_cache, kv_len, *, scale=None) -> torch.Tensor:
    """Plain PyTorch version of K5, and of K2 on one layer plane: the
    kernels' arithmetic on a flat (B, S, nkv, hd) cache (fp32 throughout,
    -1e30 masking, a row with kv_len 0 gets zeros as the kernels'
    ``acc / (l or 1)`` gives). Keys and values past a row's kv_len never
    reach the sum, whatever they hold: their scores are masked and their
    values zeroed (a NaN there stays out, as the kernels load such keys as
    zeros); with finite ones the bits are those of the masked softmax."""
    B, nq, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else hd**-0.5
    qg = q.float().reshape(B, nkv, nq // nkv, hd)
    live = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]  # (B, S)
    v_cache = torch.where(live[:, :, None, None], v_cache,
                          torch.zeros((), dtype=v_cache.dtype, device=q.device))
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) * scale
    valid = live[:, None, None, :]
    out = _softmax_pv(scores, valid, v_cache, "bkgs,bskh->bkgh")
    out = torch.where((kv_len > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(B, nq, hd).to(q.dtype)


def decode_block_attention_reference(q, k_cache, v_cache, q_positions, *,
                                     scale=None) -> torch.Tensor:
    """Plain PyTorch version of K12, and of K3 on one layer plane: a flat
    (B, S, nkv, hd) cache."""
    B, T, nq, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else hd**-0.5
    qg = q.float().reshape(B, T, nkv, nq // nkv, hd)
    scores = torch.einsum("btkgh,bskh->btkgs", qg, k_cache.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, None, :]
             <= q_positions[:, :, None])[:, :, None, None, :]
    out = _softmax_pv(scores, valid, v_cache, "btkgs,bskh->btkgh")
    return out.reshape(B, T, nq, hd).to(q.dtype)


def decode_attention_quant_reference(q, k_cache, v_cache, k_scale, v_scale, kv_len, *, bits=8,
                                     scale=None) -> torch.Tensor:
    """Plain PyTorch version of K10: the cache dequantized to fp32, then
    K5's plain version."""
    tier = kv_quant_of_bits(bits)
    return decode_attention_reference(q, dequantize_kv(k_cache, k_scale, tier, torch.float32),
                                      dequantize_kv(v_cache, v_scale, tier, torch.float32),
                                      kv_len, scale=scale)
