"""K6 / K7: decode attention through block tables into a paged KV pool (CUDA,
``csrc/paged_attention.cu``); K8 / K9: the same over the quantized pool
(``csrc/paged_attention_quant.cu``).

Port of ``paged_attention``, ``paged_block_attention``,
``paged_attention_quant`` and ``paged_block_attention_quant`` from
``tpu_voice_agent/ops/paged_attention.py``, with the JAX signatures. The pool
is layer-stacked, ``(L, N, bs, nkv, hd)``; row b's key position p lives at
pool block ``block_tables[b, p // bs]``, offset ``p % bs``, of layer plane
``layer`` (a Python int). Unused table entries must hold a valid block id
(0, the trash block, is fine): they are never read past the row's frontier.

- K6 (T = 1): query b attends positions ``[0, kv_len[b])``; a row with
  kv_len 0 gets zeros, as the Pallas kernel's ``l == 0`` guard gives.
- K7 (T <= 16): query i of row b attends positions ``[0, q_positions[b, i]]``;
  tiles past the row's largest position are skipped, and a row whose every
  position is negative gets zeros.
- K8 / K9 (``KV_QUANT=int8|int4``): K6 / K7 over an int8 pool
  ``(L, N, bs, nkv, hdp)`` (``hdp = hd`` at ``bits=8``, ``hd / 2`` packed
  int4 at ``bits=4``, ``ops.kvquant``) with bf16 scale planes
  ``(L, N, bs, nkv)`` indexed like the pool.

Two bodies, picked by the query dtype alone:

- bf16 queries (every bf16 engine's steps) run the tensor-core split body
  (``csrc/paged_split.cuh``): the key range split into chunks across the
  card (K7 / K9: ``paged_key_chunk(B, S, nkv)`` keys; K6 / K8:
  ``paged_t1_chunk``, a split's tiles spread over the four warps of a
  block), merged in a fixed order through the device's scratch and ticket
  counters (the same bits run to run), Q.K^T and P.V on bf16 tensor cores
  with fp32 sums and P in three bf16 parts. K8 / K9 keep the TPU kernel's
  fold: the stored integers in the products, each key's scale
  on its score after Q.K^T and on its probability before P.V.
- fp32 queries (the distilled checkpoint) run the fp32 body
  (``csrc/decode_attention.cuh``); its loader widens ``int * scale`` into
  fp32 tiles, which is exact.

Either way the kernels equal the plain versions' fp32 arithmetic up to the
order of fp32 sums (and the bf16 output rounding).

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors, and only then. The plain versions gather each row's
blocks into a contiguous cache and run the dense plain versions of K2 / K3
(``decode_attention_reference``, ``decode_block_attention_reference``).
Not ported: the ``sharded_*`` wrappers (on one card they are the kernel).
"""

from __future__ import annotations

import functools

import torch

from ._lib import (
    HEAD_DIMS,
    check,
    dtype_code,
    library,
    require,
    require_cuda,
    scratch,
    stream_of,
    tickets,
)
from .decode_attention import (
    MAX_BLOCK_T,
    MAX_GROUP,
    MERGE_GROUP,
    PAGED_MAX_ROWS,
    TICKETS_PER_SLOT,
    check_quant_cache,
    decode_attention_reference,
    decode_block_attention_reference,
    paged_key_chunk,
    paged_t1_chunk,
)
from .kvquant import dequantize_kv, kv_quant_of_bits


def _check_pool(name, q, k_pool, v_pool, block_tables, layer, nq, hd, *,
                dtype=torch.bfloat16, width=None):
    """The pool's layout; ``dtype`` and ``width`` are what it stores per
    (position, kv head): bf16 rows of ``hd``, or the quantized pool's int8
    rows of ``hdp``."""
    width = hd if width is None else width
    require_cuda(name, q, k_pool, v_pool, block_tables)
    require(k_pool.dtype == v_pool.dtype == dtype, name, f"the pool must be {dtype}")
    require(k_pool.dim() == 5 and k_pool.shape == v_pool.shape, name,
            f"pool must be (L, N, bs, nkv, {width}), got {tuple(k_pool.shape)}")
    L, _N, bs, nkv, khd = k_pool.shape
    B = q.shape[0]
    require(khd == width, name, f"pool rows of {khd} do not fit hd {hd}")
    require(0 <= layer < L, name, f"layer {layer} outside [0, {L})")
    require(nq % nkv == 0 and nq // nkv <= MAX_GROUP, name,
            f"need nq % nkv == 0 and a group of at most {MAX_GROUP}")
    require(hd in HEAD_DIMS, name, f"head dim {hd} not in {HEAD_DIMS}")
    require(block_tables.dtype == torch.int32 and block_tables.dim() == 2
            and block_tables.shape[0] == B, name, "block_tables must be (B, max_blocks) int32")
    return B, bs, nkv, block_tables.shape[1]


@functools.lru_cache(maxsize=None)
def _paged_plan(B: int, T: int, S: int, nq: int, nkv: int, hd: int,
                t1: bool = False) -> tuple[int, int, int]:
    """The chunk, the fp32 scratch floats and the ticket counters of a
    launch of the paged split body (K7 / K9, or ``t1`` the T = 1 body of
    K6 / K8); a block of more than PAGED_MAX_ROWS query rows runs in parts
    of whole queries, one after another, that share them."""
    chunk = paged_t1_chunk(B, S, nkv, hd) if t1 else paged_key_chunk(B, S, nkv)
    splits = -(-S // chunk)
    entries = splits + -(-splits // MERGE_GROUP)
    group = nq // nkv
    rows = min(T, max(1, PAGED_MAX_ROWS // group)) * group
    return chunk, B * nkv * entries * rows * (hd + 2), B * nkv * TICKETS_PER_SLOT


def _split_operands(name, q, planes, B, T, S, nq, nkv, hd, scale_planes=(), t1=False):
    """(chunk, scratch pointer, counters pointer) of a bf16-query launch,
    zeros for fp32 queries (the fp32 body takes none). The split body copies
    q and the pool planes in 16-byte units and a scale plane's 4-byte words."""
    if q.dtype != torch.bfloat16:
        return 0, 0, 0
    require(all(t.data_ptr() % 16 == 0 for t in (q, *planes)), name,
            "q and the pool must be 16-byte aligned")
    require(all(t.data_ptr() % 4 == 0 for t in scale_planes), name,
            "the scale planes must be 4-byte aligned")
    chunk, floats, counters = _paged_plan(B, T, S, nq, nkv, hd, t1)
    return (chunk, scratch(q.device, floats).data_ptr(),
            tickets(q.device, counters).data_ptr())


def paged_attention(
    q: torch.Tensor,  # (B, nq, hd) — one query token per row
    k_pool: torch.Tensor,  # (L, N, bs, nkv, hd) bf16 — the global block pool
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int32 pool-block ids
    kv_len: torch.Tensor,  # (B,) int32 valid keys per row
    layer: int,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, nq, hd) in q.dtype."""
    B, nq, hd = q.shape
    scale = scale if scale is not None else hd**-0.5
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables, kv_len, layer,
                                         scale=scale)
    name = "paged_attention"
    B, bs, nkv, max_blocks = _check_pool(name, q, k_pool, v_pool, block_tables, layer, nq, hd)
    require_cuda(name, q, kv_len)
    require(kv_len.dtype == torch.int32 and kv_len.shape == (B,), name,
            "kv_len must be (B,) int32")
    code = dtype_code(name, q)
    kp, vp = k_pool[layer], v_pool[layer]
    chunk, part, counters = _split_operands(name, q, (kp, vp), B, 1, max_blocks * bs, nq, nkv,
                                            hd, t1=True)
    out = torch.empty_like(q)
    err = library().tva_paged_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), block_tables.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part, counters, B, max_blocks, bs, nq, nkv, hd, chunk, float(scale),
        code, stream_of(q))
    check(err, name)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_block_attention(
    q: torch.Tensor,  # (B, T, nq, hd) — a small block of queries per row
    k_pool: torch.Tensor,  # (L, N, bs, nkv, hd) bf16
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    q_positions: torch.Tensor,  # (B, T) int32 — each query's sequence position
    layer: int,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, T, nq, hd) in q.dtype. The caller has already scattered
    the block's k/v at ``q_positions`` (forward_paged's write-then-attend)."""
    B, T, nq, hd = q.shape
    scale = scale if scale is not None else hd**-0.5
    if q.device.type == "cpu":
        return paged_block_attention_reference(q, k_pool, v_pool, block_tables, q_positions,
                                               layer, scale=scale)
    name = "paged_block_attention"
    B, bs, nkv, max_blocks = _check_pool(name, q, k_pool, v_pool, block_tables, layer, nq, hd)
    require_cuda(name, q, q_positions)
    require(1 <= T <= MAX_BLOCK_T, name, f"block of {T} queries (max {MAX_BLOCK_T})")
    require(q_positions.dtype == torch.int32 and q_positions.shape == (B, T), name,
            "q_positions must be (B, T) int32")
    code = dtype_code(name, q)
    kp, vp = k_pool[layer], v_pool[layer]
    chunk, part, counters = _split_operands(name, q, (kp, vp), B, T, max_blocks * bs, nq, nkv,
                                            hd)
    out = torch.empty_like(q)
    err = library().tva_paged_block_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), block_tables.data_ptr(),
        q_positions.data_ptr(), out.data_ptr(), part, counters, B, T, max_blocks, bs, nq, nkv,
        hd, chunk, float(scale), code, stream_of(q))
    check(err, name)
    paged_block_attention.launches += 1
    return out


paged_block_attention.launches = 0


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor, layer: int) -> torch.Tensor:
    """Each row's blocks of one layer plane as a contiguous cache:
    (B, max_blocks * bs, ...) of a (L, N, bs, ...) pool or scale plane."""
    blocks = pool[layer][block_tables.long()]  # (B, max_blocks, bs, ...)
    B, M, bs = blocks.shape[:3]
    return blocks.reshape(B, M * bs, *blocks.shape[3:])


def paged_attention_reference(q, k_pool, v_pool, block_tables, kv_len, layer, *,
                              scale=None) -> torch.Tensor:
    """Plain PyTorch version of K6: the row's blocks gathered, then K2's
    plain version (fp32 throughout, zeros for a row with kv_len 0)."""
    return decode_attention_reference(q, gather_pages(k_pool, block_tables, layer),
                                      gather_pages(v_pool, block_tables, layer), kv_len,
                                      scale=scale)


def paged_block_attention_reference(q, k_pool, v_pool, block_tables, q_positions, layer, *,
                                    scale=None) -> torch.Tensor:
    """Plain PyTorch version of K7: the row's blocks gathered, then K3's
    plain version; a row whose every position is negative reads no key and
    gets zeros, as the kernel skips all its tiles."""
    return _zero_keyless_rows(
        decode_block_attention_reference(q, gather_pages(k_pool, block_tables, layer),
                                         gather_pages(v_pool, block_tables, layer),
                                         q_positions, scale=scale), q_positions)


def _zero_keyless_rows(out, q_positions):
    """Zeros for a row whose every position is negative: the kernels skip
    all its tiles."""
    none = (q_positions.amax(dim=1) < 0)[:, None, None, None]
    return torch.where(none, torch.zeros_like(out), out)


# ---------------------------------------------------------------- quantized pool


def _check_quant_pool(name, q, k_pool, v_pool, k_scale, v_scale, block_tables, layer, nq, hd,
                      bits):
    require_cuda(name, k_scale, v_scale)
    check_quant_cache(name, k_pool, v_pool, k_scale, v_scale, hd, bits)
    return _check_pool(name, q, k_pool, v_pool, block_tables, layer, nq, hd, dtype=torch.int8,
                       width=hd * bits // 8)


def paged_attention_quant(
    q: torch.Tensor,  # (B, nq, hd) — one query token per row
    k_pool: torch.Tensor,  # (L, N, bs, nkv, hdp) int8 stored values
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (L, N, bs, nkv) bf16 per-(position, head) scales
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int32 pool-block ids
    kv_len: torch.Tensor,  # (B,) int32 valid keys per row
    layer: int,
    *,
    bits: int = 8,  # 8 | 4 (ops.kvquant storage contract)
    scale: float | None = None,
) -> torch.Tensor:
    """K6 over the quantized pool. Returns (B, nq, hd) in q.dtype."""
    B, nq, hd = q.shape
    scale = scale if scale is not None else hd**-0.5
    if q.device.type == "cpu":
        return paged_attention_quant_reference(q, k_pool, v_pool, k_scale, v_scale,
                                               block_tables, kv_len, layer, bits=bits,
                                               scale=scale)
    name = "paged_attention_quant"
    B, bs, nkv, max_blocks = _check_quant_pool(name, q, k_pool, v_pool, k_scale, v_scale,
                                               block_tables, layer, nq, hd, bits)
    require_cuda(name, q, kv_len)
    require(kv_len.dtype == torch.int32 and kv_len.shape == (B,), name,
            "kv_len must be (B,) int32")
    code = dtype_code(name, q)
    kp, vp, ks, vs = k_pool[layer], v_pool[layer], k_scale[layer], v_scale[layer]
    chunk, part, counters = _split_operands(name, q, (kp, vp), B, 1, max_blocks * bs, nq, nkv,
                                            hd, (ks, vs), t1=True)
    out = torch.empty_like(q)
    err = library().tva_paged_attention_quant(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(), part, counters, B,
        max_blocks, bs, nq, nkv, hd, chunk, float(scale), bits, code, stream_of(q))
    check(err, name)
    paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0


def paged_block_attention_quant(
    q: torch.Tensor,  # (B, T, nq, hd)
    k_pool: torch.Tensor,  # (L, N, bs, nkv, hdp) int8
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (L, N, bs, nkv) bf16
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    q_positions: torch.Tensor,  # (B, T) int32
    layer: int,
    *,
    bits: int = 8,
    scale: float | None = None,
) -> torch.Tensor:
    """K7 over the quantized pool (the fast-forward chain steps): per-query
    frontiers. Returns (B, T, nq, hd) in q.dtype."""
    B, T, nq, hd = q.shape
    scale = scale if scale is not None else hd**-0.5
    if q.device.type == "cpu":
        return paged_block_attention_quant_reference(q, k_pool, v_pool, k_scale, v_scale,
                                                     block_tables, q_positions, layer,
                                                     bits=bits, scale=scale)
    name = "paged_block_attention_quant"
    B, bs, nkv, max_blocks = _check_quant_pool(name, q, k_pool, v_pool, k_scale, v_scale,
                                               block_tables, layer, nq, hd, bits)
    require_cuda(name, q, q_positions)
    require(1 <= T <= MAX_BLOCK_T, name, f"block of {T} queries (max {MAX_BLOCK_T})")
    require(q_positions.dtype == torch.int32 and q_positions.shape == (B, T), name,
            "q_positions must be (B, T) int32")
    code = dtype_code(name, q)
    kp, vp, ks, vs = k_pool[layer], v_pool[layer], k_scale[layer], v_scale[layer]
    chunk, part, counters = _split_operands(name, q, (kp, vp), B, T, max_blocks * bs, nq, nkv,
                                            hd, (ks, vs))
    out = torch.empty_like(q)
    err = library().tva_paged_block_attention_quant(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        block_tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(), part, counters, B, T,
        max_blocks, bs, nq, nkv, hd, chunk, float(scale), bits, code, stream_of(q))
    check(err, name)
    paged_block_attention_quant.launches += 1
    return out


paged_block_attention_quant.launches = 0


def gather_pages_dequant(pool, scales, block_tables, layer: int, bits: int) -> torch.Tensor:
    """Each row's blocks of one quantized layer plane, dequantized to fp32:
    (B, max_blocks * bs, nkv, hd)."""
    return dequantize_kv(gather_pages(pool, block_tables, layer),
                         gather_pages(scales, block_tables, layer), kv_quant_of_bits(bits),
                         torch.float32)


def paged_attention_quant_reference(q, k_pool, v_pool, k_scale, v_scale, block_tables, kv_len,
                                    layer, *, bits=8, scale=None) -> torch.Tensor:
    """Plain PyTorch version of K8: the row's blocks gathered and
    dequantized to fp32, then K2's plain version."""
    return decode_attention_reference(
        q, gather_pages_dequant(k_pool, k_scale, block_tables, layer, bits),
        gather_pages_dequant(v_pool, v_scale, block_tables, layer, bits), kv_len, scale=scale)


def paged_block_attention_quant_reference(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                                          q_positions, layer, *, bits=8,
                                          scale=None) -> torch.Tensor:
    """Plain PyTorch version of K9: the row's blocks gathered and
    dequantized to fp32, then K3's plain version; a row whose every
    position is negative gets zeros, as the kernel gives."""
    return _zero_keyless_rows(decode_block_attention_reference(
        q, gather_pages_dequant(k_pool, k_scale, block_tables, layer, bits),
        gather_pages_dequant(v_pool, v_scale, block_tables, layer, bits), q_positions,
        scale=scale), q_positions)
