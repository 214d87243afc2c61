"""Top-k MoE routing math of the served decoder, in PyTorch.

Port of ``tpu_voice_agent/models/moe.py`` (``moe_capacity``, ``_select_topk``,
``route_topk_flat``, ``route_topk``): the dense (token, expert, slot) one-hot
dispatch/combine layout and the flat assignment list of the grouped-matmul
dispatch, both derived from one selection rule. Capacity semantics are
Switch/GShard's: each expert owns C slots; overflow tokens lose that expert's
contribution and the combine weights renormalize over the survivors.
"""

from __future__ import annotations

import math

import torch


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    return max(1, int(math.ceil(n_tokens * top_k / n_experts * capacity_factor)))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _select_topk(router_w: torch.Tensor, x: torch.Tensor, n_experts: int,
                 top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """THE expert-selection rule: x (T, d), router_w (d, E) -> (probs (T, E)
    f32 softmax, eids (T, K) int32). K rounds of argmax, each pick masked out
    by ``probs * (1 - one_hot)``; ``torch.argmax`` returns the first maximum,
    as ``jnp.argmax`` does, so ties pick the same expert.

    The router logits are a true fp32 product: a router near-tie flipped by
    TF32 changes the chosen expert, and with it the token, so a card that
    allows TF32 matmuls is refused rather than routed differently."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("MoE routing needs fp32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 must be False")
    E, K = n_experts, top_k
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    ids = []
    masked = probs
    for _ in range(K):
        idx = torch.argmax(masked, dim=-1)  # (T,)
        ids.append(idx.to(torch.int32))
        masked = masked * (1.0 - _one_hot(idx, E, probs.dtype))
    return probs, torch.stack(ids, dim=1)


def route_topk_flat(router_w: torch.Tensor, x: torch.Tensor, n_experts: int,
                    top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d), router_w (d, E) -> (eids (T, K) int32, gates (T, K) f32
    renormalized over the K chosen experts): the grouped dispatch's flat
    layout, from ``_select_topk``."""
    probs, eids = _select_topk(router_w, x, n_experts, top_k)
    gates = torch.gather(probs, 1, eids.long())  # (T, K)
    denom = gates.sum(dim=1, keepdim=True)
    return eids, gates / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def route_topk(router_w: torch.Tensor, x: torch.Tensor, n_experts: int, top_k: int,
               capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d), router_w (d, E) -> (dispatch (T, E, C) one-hot, combine
    (T, E, C) gate-weighted)."""
    E, C = n_experts, capacity
    probs, eids = _select_topk(router_w, x, E, top_k)
    # (T, E) gate matrix from the selected ids
    gates = (_one_hot(eids, E, probs.dtype) * probs[:, None, :]).sum(dim=1)
    chosen = gates > 0.0
    # slot position of each token within its expert's queue, in token order
    pos = torch.cumsum(chosen.to(torch.int32), dim=0) - 1  # (T, E)
    keep = chosen & (pos < C)
    kept_gate = torch.where(keep, gates, torch.zeros_like(gates))
    denom = kept_gate.sum(dim=-1, keepdim=True)
    kept_gate = kept_gate / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    slot = _one_hot(torch.where(keep, pos, torch.full_like(pos, C)), C, probs.dtype)
    dispatch = slot * keep[..., None]
    combine = dispatch * kept_gate[..., None]
    return dispatch, combine


def route_expert_block(router_w: torch.Tensor, x: torch.Tensor, n_experts: int, top_k: int,
                       capacity: int, e0: int, n_local: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``route_topk``'s (dispatch, combine) restricted to experts e0 ..
    e0 + n_local (T, n_local, C): the block an expert-parallel shard
    multiplies. Every shard routes all the tokens, so the blocks' combines
    sum to the whole's."""
    dispatch, combine = route_topk(router_w, x, n_experts, top_k, capacity)
    return dispatch[:, e0:e0 + n_local], combine[:, e0:e0 + n_local]
