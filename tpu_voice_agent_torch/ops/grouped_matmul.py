"""K13: grouped matmul, expert-sorted rows x per-tile expert weight (CUDA,
``csrc/grouped_matmul.cu``).

Port of ``tpu_voice_agent/ops/grouped_matmul.py``: ``out[i] = x[i] @
w[tile_expert[i // tm]]``, (M, d) x (E, d, f) -> (M, f), products and sums in
fp32, the result in x's dtype. The MoE feed-forward's grouped dispatch
(``models.llama._moe_ffn_grouped``) sorts token-expert assignments by expert
and pads each expert's run to a multiple of ``tm``, so every row tile belongs
to one expert.

``w`` is a dense (E, d, f) tensor or an int8 leaf ``{"q", "s"}``; the int8
leaf computes exactly ``grouped_matmul(x, dequantize_leaf(leaf), ...)`` (the
JAX module materializes that bf16 copy with ``_w`` on every call; the kernel
forms each element as it loads a tile). The wrapper launches its kernel for
CUDA tensors and runs ``grouped_matmul_reference`` for CPU tensors, and only
then.
"""

from __future__ import annotations

import torch

from ._lib import check, dtype_code, library, require, require_cuda, stream_of

_W_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def dequantize_leaf(leaf):
    """A weight leaf as a dense tensor: a raw tensor as it is, an int8
    ``{"q", "s"}`` leaf as ``bf16(q) * bf16(s)`` (each product rounded to
    bf16 once), the JAX module's ``_w``."""
    if isinstance(leaf, dict):
        return leaf["q"].to(torch.bfloat16) * leaf["s"].to(torch.bfloat16)
    return leaf


def grouped_matmul(
    x: torch.Tensor,  # (M, d) rows, expert-sorted and tile-padded
    w,  # (E, d, f) tensor, or an int8 {"q": (E, d, f), "s": (E, 1, f) f32} leaf
    tile_expert: torch.Tensor,  # (M // tm,) int32 expert id per row tile
    tm: int,
) -> torch.Tensor:
    """Returns (M, f) in x.dtype. ``tm`` is a power of two in [8, 128] and
    divides M; every ``tile_expert`` entry lies in [0, E)."""
    q = w["q"] if isinstance(w, dict) else w
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, dequantize_leaf(w), tile_expert, tm)
    name = "grouped_matmul"
    M, d = x.shape
    E, d2, f = q.shape
    require(d == d2, name, f"x is (M, {d}) but w is ({E}, {d2}, {f})")
    require(8 <= tm <= 128 and tm & (tm - 1) == 0 and M % tm == 0, name,
            f"tm must be a power of two in [8, 128] dividing M, got tm {tm}, M {M}")
    require(tile_expert.dtype == torch.int32 and tuple(tile_expert.shape) == (M // tm,), name,
            f"tile_expert must be ({M // tm},) int32")
    require(q.dtype in _W_CODES, name, f"w must be bf16, fp32 or int8, got {q.dtype}")
    scale = None
    if isinstance(w, dict):
        scale = w["s"]
        require(q.dtype == torch.int8 and scale.dtype == torch.float32
                and tuple(scale.shape) == (E, 1, f), name,
                f"an int8 leaf needs q int8 and s ({E}, 1, {f}) float32")
        require_cuda(name, x, q, scale, tile_expert)
    else:
        require(q.dtype != torch.int8, name, "int8 weights come as a {'q', 's'} leaf")
        require_cuda(name, x, q, tile_expert)
    out = torch.empty((M, f), dtype=x.dtype, device=x.device)
    err = library().tva_grouped_matmul(
        x.data_ptr(), q.data_ptr(), 0 if scale is None else scale.data_ptr(),
        tile_expert.data_ptr(), out.data_ptr(), M, d, f, int(tm), dtype_code(name, x),
        _W_CODES[q.dtype], stream_of(x))
    check(err, name)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def grouped_matmul_reference(x, w, tile_expert, tm: int) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_matmul`` on a dense ``w``: each row
    tile times its expert's plane, an fp32 product, cast to x's dtype. (The
    JAX twin gathers a plane per ROW, which at mixtral-8x7b's prefill would
    be 3072 fp32 copies of a 235 MB plane; a tile's rows share one.)"""
    M, f = x.shape[0], w.shape[-1]
    out = torch.empty((M, f), dtype=x.dtype, device=x.device)
    for i, e in enumerate(tile_expert.tolist()):
        rows = slice(i * tm, (i + 1) * tm)
        out[rows] = (x[rows].float() @ w[e].float()).to(x.dtype)
    return out
