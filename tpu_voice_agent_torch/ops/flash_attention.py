"""K1: blockwise flash attention (CUDA, ``csrc/flash_attention.cu``).

Port of ``tpu_voice_agent/ops/flash_attention.py``. Online-softmax GQA
attention, causal or non-causal with a static ``kv_len``; scores never reach
device memory. Used for the Llama fresh-block prefill (the cached prompt
prefix and full-prompt prefill) and the Whisper encoder (non-causal). bf16
operands run both products on the tensor cores (they must be 16-byte
aligned, as every fresh tensor is); fp32 ones on the CUDA cores.

``flash_attention`` launches the kernel for CUDA tensors and runs
``attention_reference`` (the plain PyTorch version) for CPU tensors, and only
then.
"""

from __future__ import annotations

import torch

from ._lib import HEAD_DIMS, check, dtype_code, library, require, require_cuda, stream_of

_NEG_INF = -1e30


def flash_attention(
    q: torch.Tensor,  # (B, T, nq, hd)
    k: torch.Tensor,  # (B, S, nkv, hd)
    v: torch.Tensor,  # (B, S, nkv, hd)
    *,
    causal: bool = True,
    kv_len: int | None = None,  # static true key count (<= S); None => S
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, T, nq, hd) in q.dtype. ``kv_len`` masks keys at positions
    >= kv_len; with ``causal`` queries and keys sit at their array index."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd**-0.5
    kv_len = kv_len if kv_len is not None else S
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, kv_len=kv_len, scale=scale)
    name = "flash_attention"
    require_cuda(name, q, k, v)
    require(k.shape == v.shape and k.shape[0] == B and k.shape[3] == hd, name,
            f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    require(nq % nkv == 0, name, f"GQA needs nq % nkv == 0, got {nq} % {nkv}")
    require(hd in HEAD_DIMS, name, f"head dim {hd} not in {HEAD_DIMS}")
    require(0 <= kv_len <= S, name, f"kv_len {kv_len} outside [0, {S}]")
    require(q.dtype == k.dtype == v.dtype, name, "q, k and v must share one dtype")
    require(q.dtype != torch.bfloat16 or all(t.data_ptr() % 16 == 0 for t in (q, k, v)), name,
            "bfloat16 operands must be 16-byte aligned")
    out = torch.empty_like(q)
    err = library().tva_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, nq, nkv, hd,
        int(kv_len), int(bool(causal)), float(scale), dtype_code(name, q), stream_of(q))
    check(err, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention_reference(q, k, v, *, causal: bool = True, kv_len: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention``: the kernel's arithmetic
    (fp32 scores, -1e30 masking, fp32 probabilities times fp32 values),
    all at once instead of tile by tile."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    scale = scale if scale is not None else hd**-0.5
    kv_len = kv_len if kv_len is not None else S
    qg = q.float().reshape(B, T, nkv, group, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * scale
    s_idx = torch.arange(S, device=q.device)
    mask = (s_idx < kv_len)[None, :].expand(T, S)
    if causal:
        mask = mask & (torch.arange(T, device=q.device)[:, None] >= s_idx[None, :])
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(B, T, nq, hd).to(q.dtype)
