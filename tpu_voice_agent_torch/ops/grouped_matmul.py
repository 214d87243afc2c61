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
forms each element from the staged tile). ``live_rows`` (a (1,) int32 tensor
beside x, from ``models.llama.grouped_layout``) marks the rows at and past
it as the layout's zero tail: their tiles come out as zeros and the kernel
reads no weight for them. The wrapper launches its kernel for CUDA tensors
and runs ``grouped_matmul_reference`` for CPU tensors, and only then.
"""

from __future__ import annotations

import torch

from ._lib import check, dtype_code, library, require, require_cuda, stream_of, tickets

_W_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
# The tensor-core body (bf16 x with bf16 or int8 w): 128 output columns a
# block, 64-deep stages. At the decode step (tm 8) the live row tiles are
# few (the layout gives at least M / tm - E of them: each expert's run padded
# to a tile plus E tail tiles), so the depth is split across blocks until
# about two blocks per SM of the H100's 132 hold live tiles, at most 8 splits
# (csrc/grouped_matmul.cu tc::BM, tc::BK).
BLOCK_COLS, STAGE_DEPTH = 128, 64
SPLIT_BLOCKS, MAX_SPLITK = 264, 8


def split_depth(M: int, d: int, f: int, tm: int, E: int) -> int:
    """The depth a split of the tensor-core body covers, from the shapes
    alone (no device read): d rounded up to whole 64-deep stages (one
    split) unless tm is 8; at tm 8 the depth is cut into up to 8 ranges of
    whole stages so that the column tiles times the fewest live row tiles
    times the splits reach about 264 blocks. mixtral-8x7b's decode: 8 splits
    of 1792 for the down projection (32 column tiles), 2 of 2048 for gate
    and up (112)."""
    stages = -(-d // STAGE_DEPTH)
    splits = 1
    if tm == 8:
        live = max(1, M // tm - E)
        splits = max(1, min(MAX_SPLITK, stages, SPLIT_BLOCKS // (-(-f // BLOCK_COLS) * live)))
    return -(-stages // splits) * STAGE_DEPTH


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
    *,
    live_rows: torch.Tensor | None = None,  # (1,) int32: rows past it are the zero tail
) -> torch.Tensor:
    """Returns (M, f) in x.dtype. ``tm`` is a power of two in [8, 128] and
    divides M; every ``tile_expert`` entry lies in [0, E). The row tiles
    that start at or past ``live_rows`` come out as zeros (None: every tile
    is live, the JAX signature)."""
    q = w["q"] if isinstance(w, dict) else w
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, dequantize_leaf(w), tile_expert, tm,
                                        live_rows=live_rows)
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
    operands = [x, q, tile_expert]
    if isinstance(w, dict):
        scale = w["s"]
        require(q.dtype == torch.int8 and scale.dtype == torch.float32
                and tuple(scale.shape) == (E, 1, f), name,
                f"an int8 leaf needs q int8 and s ({E}, 1, {f}) float32")
        operands.append(scale)
    else:
        require(q.dtype != torch.int8, name, "int8 weights come as a {'q', 's'} leaf")
    if live_rows is not None:
        require(live_rows.dtype == torch.int32 and tuple(live_rows.shape) == (1,), name,
                "live_rows must be (1,) int32")
        operands.append(live_rows)
    require_cuda(name, *operands)
    x_code, w_code = dtype_code(name, x), _W_CODES[q.dtype]
    chunk = -(-d // STAGE_DEPTH) * STAGE_DEPTH
    part = counters = None
    if x_code == 0 and w_code != 1:  # the tensor-core body
        chunk = split_depth(M, d, f, tm, E)
        if chunk < d:
            col_tiles = -(-f // BLOCK_COLS)
            part = torch.empty(M * col_tiles * BLOCK_COLS * -(-d // chunk), dtype=torch.float32,
                               device=x.device)
            counters = tickets(x.device, M // tm * col_tiles)
    out = torch.empty((M, f), dtype=x.dtype, device=x.device)
    err = library().tva_grouped_matmul(
        x.data_ptr(), q.data_ptr(), 0 if scale is None else scale.data_ptr(),
        tile_expert.data_ptr(), 0 if live_rows is None else live_rows.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), 0 if counters is None else counters.data_ptr(),
        M, d, f, int(tm), chunk, x_code, w_code, stream_of(x))
    check(err, name)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def grouped_matmul_reference(x, w, tile_expert, tm: int, *, live_rows=None) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_matmul`` on a dense ``w``: each row
    tile times its expert's plane, an fp32 product, cast to x's dtype; the
    tiles at or past ``live_rows`` are zeros. (The JAX twin gathers a plane
    per ROW, which at mixtral-8x7b's prefill would be 3072 fp32 copies of a
    235 MB plane; a tile's rows share one.)"""
    M, f = x.shape[0], w.shape[-1]
    live = M if live_rows is None else int(live_rows[0])
    out = torch.zeros((M, f), dtype=x.dtype, device=x.device)
    for i, e in enumerate(tile_expert.tolist()):
        if i * tm >= live:
            break
        rows = slice(i * tm, (i + 1) * tm)
        out[rows] = (x[rows].float() @ w[e].float()).to(x.dtype)
    return out
