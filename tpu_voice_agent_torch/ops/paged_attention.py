"""K6 / K7: decode attention through block tables into a paged KV pool (CUDA,
``csrc/paged_attention.cu`` over the template body in
``csrc/decode_attention.cuh``); K8 / K9: the same over the quantized pool
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
  ``(L, N, bs, nkv)`` indexed like the pool. The kernels widen
  ``int * scale`` into their fp32 tiles, which is exact, so they equal the
  plain versions' fp32 dequantization up to fp32 summation order.

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors, and only then. The plain versions gather each row's
blocks into a contiguous cache and run the dense plain versions of K2 / K3
(``decode_attention_reference``, ``decode_block_attention_reference``).
Not ported: the ``sharded_*`` wrappers (on one card they are the kernel).
"""

from __future__ import annotations

import torch

from ._lib import (
    HEAD_DIMS,
    check,
    dtype_code,
    library,
    require,
    require_cuda,
    stream_of,
)
from .decode_attention import (
    MAX_BLOCK_T,
    MAX_GROUP,
    check_quant_cache,
    decode_attention_reference,
    decode_block_attention_reference,
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
    out = torch.empty_like(q)
    err = library().tva_paged_attention(
        q.data_ptr(), k_pool[layer].data_ptr(), v_pool[layer].data_ptr(),
        block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(), B, max_blocks, bs, nq,
        nkv, hd, float(scale), dtype_code(name, q), stream_of(q))
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
    out = torch.empty_like(q)
    err = library().tva_paged_block_attention(
        q.data_ptr(), k_pool[layer].data_ptr(), v_pool[layer].data_ptr(),
        block_tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(), B, T, max_blocks, bs,
        nq, nkv, hd, float(scale), dtype_code(name, q), stream_of(q))
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
    out = torch.empty_like(q)
    err = library().tva_paged_attention_quant(
        q.data_ptr(), k_pool[layer].data_ptr(), v_pool[layer].data_ptr(),
        k_scale[layer].data_ptr(), v_scale[layer].data_ptr(), block_tables.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), B, max_blocks, bs, nq, nkv, hd, float(scale), bits,
        dtype_code(name, q), stream_of(q))
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
    out = torch.empty_like(q)
    err = library().tva_paged_block_attention_quant(
        q.data_ptr(), k_pool[layer].data_ptr(), v_pool[layer].data_ptr(),
        k_scale[layer].data_ptr(), v_scale[layer].data_ptr(), block_tables.data_ptr(),
        q_positions.data_ptr(), out.data_ptr(), B, T, max_blocks, bs, nq, nkv, hd,
        float(scale), bits, dtype_code(name, q), stream_of(q))
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
