"""K6 / K7: decode attention through block tables into a paged KV pool (CUDA,
``csrc/paged_attention.cu`` over the template body in
``csrc/decode_attention.cuh``).

Port of ``paged_attention`` and ``paged_block_attention`` from
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

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors, and only then. The plain versions gather each row's
blocks into a contiguous cache and run the dense plain versions of K2 / K3
(``decode_attention_reference``, ``decode_block_attention_reference``).
Not ported: the ``sharded_*`` wrappers (on one card they are the kernel).
"""

from __future__ import annotations

import torch

from ._lib import HEAD_DIMS, check, dtype_code, library, require, require_cuda, stream_of
from .decode_attention import (
    MAX_BLOCK_T,
    MAX_GROUP,
    decode_attention_reference,
    decode_block_attention_reference,
)


def _check_pool(name, q, k_pool, v_pool, block_tables, layer, nq, hd):
    require_cuda(name, q, k_pool, v_pool, block_tables)
    require(k_pool.dtype == v_pool.dtype == torch.bfloat16, name, "the pool must be bfloat16")
    require(k_pool.dim() == 5 and k_pool.shape == v_pool.shape, name,
            f"pool must be (L, N, bs, nkv, hd), got {tuple(k_pool.shape)}")
    L, _N, bs, nkv, khd = k_pool.shape
    B = q.shape[0]
    require(khd == hd, name, "q and pool disagree on hd")
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
    (B, max_blocks * bs, nkv, hd)."""
    blocks = pool[layer][block_tables.long()]  # (B, max_blocks, bs, nkv, hd)
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
    out = decode_block_attention_reference(q, gather_pages(k_pool, block_tables, layer),
                                           gather_pages(v_pool, block_tables, layer),
                                           q_positions, scale=scale)
    none = (q_positions.amax(dim=1) < 0)[:, None, None, None]
    return torch.where(none, torch.zeros_like(out), out)
