"""Long-context prefill: ring attention feeding the cached decode.

Port of ``tpu_voice_agent/parallel/longctx.py``: the long-session planner's
cold-start and re-anchor prefill (``serve.planner.LongSessionPlanner``).
Per layer the attention is ``parallel.ring.ring_attention`` over the ``sp``
mesh, exact by online-softmax merging; the rest of the layer (norms,
projections, SwiGLU) is pointwise over the sequence and runs where the
weights live, ``tokens``' device (the mesh's first). The per-layer k/v are
assembled into the standard dense cache (L, B, T, nkv, hd) on that device,
the layout ``models.llama.forward`` decodes against: JAX replicates the
cache over the mesh for decode, the port keeps one copy (the same values).
Only each row's ``last_index`` hidden state meets the lm_head: at session
lengths the (B, T, V) logits would be the prefill's largest waste.

``llama_sp_prefill`` matches ``models.llama.forward`` on a fresh cache to
numerical tolerance; at sp = 1 its attention is one K1 call a layer, the
dense fresh-block forward's own.
"""

from __future__ import annotations

import torch

from ..models.llama import (
    LlamaConfig,
    _layer_out,
    _layer_qkv,
    _qe,
    rms_norm,
    rope_tables,
    unstack_layers,
)
from ..utils.compilewatch import watch_compiles
from .ring import ring_attention


def sp_pad_len(n: int, sp: int, multiple: int = 1) -> int:
    """Smallest padded length >= n divisible by sp (and ``multiple``)."""
    q = sp * multiple
    return -(-max(n, 1) // q) * q


@torch.no_grad()
@watch_compiles("longctx.llama_sp_prefill")
def llama_sp_prefill(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # (B, T) int32, positions 0..T-1; T % sp == 0
    mesh: list,
    last_index: torch.Tensor,  # (B,) int — index of each row's last real token
) -> tuple[torch.Tensor, dict]:
    """Fresh-sequence prefill with attention split over the ``sp`` mesh.

    Returns (last_logits (B, V) f32 at each row's ``last_index``, the dense
    KV cache {"k", "v"} (L, B, T, nkv, hd) on ``tokens``' device). Trailing
    padding past ``last_index`` writes k/v that decode later overwrites slot
    by slot, as the engine's bucketed prefill does."""
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    x = params["embed"][tokens.long()]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    ks, vs = [], []
    for p in layers:
        q, k, v = _layer_qkv(p, x, cfg, cos, sin)
        attn = ring_attention(q, k, v, mesh, causal=True)
        x = _layer_out(p, x, attn.reshape(B, T, cfg.n_heads * cfg.head_dim), cfg)
        ks.append(k)
        vs.append(v)
    rows = torch.arange(B, device=dev)
    last_h = rms_norm(x[rows, torch.as_tensor(last_index, device=dev).long()],
                      params["final_norm"], cfg.norm_eps)
    return _qe(last_h, params["lm_head"]), {"k": torch.stack(ks), "v": torch.stack(vs)}
