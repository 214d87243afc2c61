"""K5 / K2 / K3 / K12: decode attention against a KV cache (CUDA,
``csrc/decode_attention.cu``); K10: against a quantized cache
(``csrc/decode_attention_quant.cu``).

Port of ``decode_attention``, ``decode_attention_layer``,
``decode_block_attention_layer``, ``decode_block_attention`` and
``decode_attention_quant`` from
``tpu_voice_agent/ops/decode_attention.py``, with the JAX signatures (the
Pallas tile size ``block_k`` and ``interpret`` dropped).

- K5 (T = 1, flat ``(B, S, nkv, hd)`` cache, bf16 or fp32): query b attends
  slots ``[0, kv_len[b])``; the Whisper decoder's self- and cross-attention.
  S needs no padding to a tile multiple; a row with kv_len 0 gets zeros.
- K2 (T = 1) on the stacked ``(L, B, S, nkv, hd)`` bf16 cache: the same on
  layer plane ``layer``, a Python int (``k_cache[layer]`` is a free
  contiguous view, so the kernel gets that plane's pointer).
- K3 (T <= 16, the grammar fast-forward block): query i of row b attends
  slots ``[0, q_positions[b, i]]``; positions may be unordered or repeat.
- K12 (T <= 16) on a flat ``(B, S, nkv, hd)`` bf16 cache: K3's function and
  body on one cache, as the JAX package's ``decode_block_attention`` (which
  only its tests call; no engine here calls it either).
- K10 (T = 1, a flat ``(B, S, nkv, hdp)`` int8 cache with ``(B, S, nkv)``
  bf16 scales, int8 or packed int4 as ``ops.kvquant`` stores them): K5 over
  the quantized cache. No engine calls it (none in the JAX package either);
  it is the dense instantiation of K8's tile loader.

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors, and only then.
"""

from __future__ import annotations

import torch

from ._lib import (
    HEAD_DIMS,
    QUANT_HEAD_DIMS,
    check,
    dtype_code,
    library,
    require,
    require_cuda,
    stream_of,
)
from .kvquant import dequantize_kv, kv_quant_of_bits

_NEG_INF = -1e30
MAX_BLOCK_T = 16
MAX_GROUP = 16


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
    out = torch.empty_like(q)
    err = library().tva_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), B, S, nq, nkv, hd, float(scale), dtype_code(name, q), stream_of(q))
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
    out = torch.empty_like(q)
    err = library().tva_decode_attention_layer(
        q.data_ptr(), k_cache[layer].data_ptr(), v_cache[layer].data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), B, S, nq, nkv, hd, float(scale), dtype_code(name, q), stream_of(q))
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
    require_cuda(name, q, q_positions)
    require(1 <= T <= MAX_BLOCK_T, name, f"block of {T} queries (max {MAX_BLOCK_T})")
    require(q_positions.dtype == torch.int32 and q_positions.shape == (B, T), name,
            "q_positions must be (B, T) int32")
    out = torch.empty_like(q)
    err = library().tva_decode_block_attention_layer(
        q.data_ptr(), k_cache[layer].data_ptr(), v_cache[layer].data_ptr(),
        q_positions.data_ptr(), out.data_ptr(), B, T, S, nq, nkv, hd, float(scale),
        dtype_code(name, q), stream_of(q))
    check(err, name)
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
    require_cuda(name, q_positions)
    require(1 <= T <= MAX_BLOCK_T, name, f"block of {T} queries (max {MAX_BLOCK_T})")
    require(q_positions.dtype == torch.int32 and q_positions.shape == (B, T), name,
            "q_positions must be (B, T) int32")
    out = torch.empty_like(q)
    err = library().tva_decode_block_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), q_positions.data_ptr(),
        out.data_ptr(), B, T, S, nq, nkv, hd, float(scale), dtype_code(name, q), stream_of(q))
    check(err, name)
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
    out = torch.empty_like(q)
    err = library().tva_decode_attention_quant(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kv_len.data_ptr(), out.data_ptr(), B, S, nq, nkv, hd, float(scale),
        bits, dtype_code(name, q), stream_of(q))
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
    ``acc / (l or 1)`` gives)."""
    B, nq, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else hd**-0.5
    qg = q.float().reshape(B, nkv, nq // nkv, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :] < kv_len[:, None])[:, None, None, :]
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
