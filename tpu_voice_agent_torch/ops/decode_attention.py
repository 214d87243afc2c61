"""K5 / K2 / K3: decode attention against a KV cache (CUDA,
``csrc/decode_attention.cu``).

Port of ``decode_attention``, ``decode_attention_layer`` and
``decode_block_attention_layer`` from ``tpu_voice_agent/ops/decode_attention.py``,
with the JAX signatures.

- K5 (T = 1, flat ``(B, S, nkv, hd)`` cache, bf16 or fp32): query b attends
  slots ``[0, kv_len[b])``; the Whisper decoder's self- and cross-attention.
  S needs no padding to a tile multiple; a row with kv_len 0 gets zeros.
- K2 (T = 1) on the stacked ``(L, B, S, nkv, hd)`` bf16 cache: the same on
  layer plane ``layer``, a Python int (``k_cache[layer]`` is a free
  contiguous view, so the kernel gets that plane's pointer).
- K3 (T <= 16, the grammar fast-forward block): query i of row b attends
  slots ``[0, q_positions[b, i]]``; positions may be unordered or repeat.

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors, and only then.
"""

from __future__ import annotations

import torch

from ._lib import HEAD_DIMS, check, dtype_code, library, require, require_cuda, stream_of

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
    """Plain PyTorch version of K3 on one flat (B, S, nkv, hd) plane."""
    B, T, nq, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else hd**-0.5
    qg = q.float().reshape(B, T, nkv, nq // nkv, hd)
    scores = torch.einsum("btkgh,bskh->btkgs", qg, k_cache.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, None, :]
             <= q_positions[:, :, None])[:, :, None, None, :]
    out = _softmax_pv(scores, valid, v_cache, "btkgs,bskh->btkgh")
    return out.reshape(B, T, nq, hd).to(q.dtype)
