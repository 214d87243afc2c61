"""Quantized paged-KV value layout: the one copy of the scale/pack math.

Port of ``tpu_voice_agent/ops/kvquant.py`` (plain PyTorch there and here;
the JAX module is jnp, not Pallas). With ``KV_QUANT=int8|int4`` the paged
pool stores symmetric signed integers in ``int8`` storage:

- values: int8 uses the full signed byte, int4 packs two 4-bit values per
  byte along head_dim — the low nibble holds dims ``[0, hd/2)``, the high
  nibble dims ``[hd/2, hd)`` — so a kernel reads half the bytes and
  sign-extends each half with arithmetic shifts;
- scales: one bf16 scale per (position, kv head), in a ``(L, N, bs, nkv)``
  plane indexed exactly like the pool, so radix chains share a block's
  scales with its values ("scales travel with the block");
- quantization is deterministic and elementwise:
  ``s = bf16(amax(|x|, head_dim) / Q)`` (1 where that rounds to 0),
  ``q = clip(round_half_even(x / s), -Q, Q)``. Stored values and scales are
  byte-identical to the JAX module's on the same input.

Bytes per pool block: ``2 * L * bs * nkv * (hd * vbytes + scale bytes)``
(``kv_block_bytes``), with ``vbytes`` 2 / 1 / 0.5 and 2 bytes of bf16 scale
per (position, head) per tensor when quantized.
"""

from __future__ import annotations

import torch

# value grids per tier: int8 the full signed byte, int4 the symmetric nibble
# range (-8 is never stored, so the grid is sign-symmetric)
KV_QUANT_Q = {"int8": 127, "int4": 7}
# stored value bytes per head_dim element
KV_QUANT_VBYTES = {None: 2.0, "int8": 1.0, "int4": 0.5}
# bf16 scale bytes per (position, kv head) per tensor (0 when off)
KV_SCALE_BYTES = {None: 0, "int8": 2, "int4": 2}


def kv_quant_bits(kv_quant: str | None) -> int:
    """Stored bits per KV value element (16 = unquantized bf16)."""
    return {None: 16, "int8": 8, "int4": 4}[kv_quant]


def kv_quant_of_bits(bits: int) -> str:
    """The quantized tier a kernel's ``bits`` argument names: 8 -> "int8",
    4 -> "int4"."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    return "int8" if bits == 8 else "int4"


def kv_store_dim(head_dim: int, kv_quant: str | None) -> int:
    """Last-axis width of the stored pool: hd, or hd/2 packed for int4."""
    if kv_quant == "int4":
        if head_dim % 2:
            raise ValueError(f"int4 KV packing needs an even head_dim, got {head_dim}")
        return head_dim // 2
    return head_dim


def kv_store_dtype(kv_quant: str | None) -> torch.dtype:
    return torch.bfloat16 if kv_quant is None else torch.int8


def kv_block_bytes(n_layers: int, block_size: int, n_kv_heads: int, head_dim: int,
                   kv_quant: str | None) -> int:
    """Device bytes ONE pool block occupies (k + v + their scale planes)."""
    per_pos_head = head_dim * KV_QUANT_VBYTES[kv_quant] + KV_SCALE_BYTES[kv_quant]
    return int(2 * n_layers * block_size * n_kv_heads * per_pos_head)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., hd) int8 values in [-7, 7] -> (..., hd/2) packed bytes: low
    nibble = dims [0, hd/2), high nibble = dims [hd/2, hd)."""
    hd = q.shape[-1]
    lo, hi = q[..., : hd // 2], q[..., hd // 2:]
    return torch.bitwise_or(torch.bitwise_and(lo, 15), torch.bitwise_left_shift(hi, 4))


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: each nibble sign-extended, as the JAX
    module's int8 ``(p << 4) >> 4`` and ``p >> 4`` give."""
    lo = torch.bitwise_xor(torch.bitwise_and(p, 15), 8) - 8
    hi = torch.bitwise_right_shift(p, 4)
    return torch.cat([lo.to(torch.int8), hi], dim=-1)


def quantize_kv(x: torch.Tensor, kv_quant: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) float -> (stored int8 values (..., hd or hd/2), bf16 scales
    (...,)). One scale per trailing row: called with (..., nkv, hd), scales
    land per (position, kv head)."""
    Q = KV_QUANT_Q[kv_quant]
    xf = x.float()
    s = (torch.amax(torch.abs(xf), dim=-1) / Q).to(torch.bfloat16)
    # the guard comes AFTER the bf16 cast: an amax that rounds to 0 there
    # still gets a usable scale
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xf / s.float()[..., None]), -Q, Q).to(torch.int8)
    if kv_quant == "int4":
        q = pack_int4(q)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, kv_quant: str,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Stored values + scales -> (..., hd) in ``dtype``. The plain read
    paths (suffix gather, fresh-block attention) use this; the kernels K8,
    K9 and K10 widen ``int * scale`` in fp32 inside their tile loader."""
    if kv_quant == "int4":
        q = unpack_int4(q)
    return (q.float() * s.float()[..., None]).to(dtype)
