"""Expert parallelism: the top-k routed MoE FFN over an ``ep`` mesh axis.

Port of ``tpu_voice_agent/parallel/expert.py``. Routing and dispatch are the
dense one-hot (token, expert, slot) layout of ``models.moe.route_topk``,
the one copy of the routing math, shared with the served MoE decoder.
``moe_ffn`` is the single-device reference; ``moe_ffn_ep`` splits the
stacked expert weights over ``ep``: every device routes all the tokens
(router weights and activations replicated), takes its own expert block of
the dispatch and combine tensors, runs its experts' SwiGLU, and one sum of
the devices' outputs, in device order, completes the combine. Capacity C
bounds each expert's slots; overflow tokens lose that expert's
contribution and the combine weights renormalize over the survivors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models.llama import tp_sum
from ..models.moe import moe_capacity, route_expert_block, route_topk
from .mesh import Mesh, as_sharded, on_device


@dataclass(frozen=True)
class MoEConfig:
    dim: int
    ffn_dim: int
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25

    def capacity(self, n_tokens: int) -> int:
        return moe_capacity(n_tokens, self.n_experts, self.top_k, self.capacity_factor)


def ep_mesh(ep: int, devices: list | None = None) -> Mesh:
    return Mesh.from_devices((ep,), ("ep",), devices)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, dtype=torch.bfloat16,
                    device=None) -> dict:
    """The router (d, E) and the expert weights stacked on a leading E
    axis, normal draws scaled by fan-in ** -0.5 (``jax.random``'s numbers
    differ: tests share weights through numpy)."""
    device = device if device is not None else generator.device
    d, f, E = cfg.dim, cfg.ffn_dim, cfg.n_experts

    def w(*shape):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * shape[-2] ** -0.5).to(dtype)

    return {"router": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f), "w_down": w(E, f, d)}


def moe_param_shardings(mesh: Mesh) -> dict:
    return {"router": (None, None), "w_gate": ("ep", None, None), "w_up": ("ep", None, None),
            "w_down": ("ep", None, None)}


def _route(router_w, x, cfg: MoEConfig, n_tokens: int):
    """(dispatch (T, E, C) one-hot, combine (T, E, C)) by ``route_topk``."""
    return route_topk(router_w, x, cfg.n_experts, cfg.top_k, cfg.capacity(n_tokens))


def _expert_ffn(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d): each expert's SwiGLU, products in fp32 as
    JAX's ``parallel/expert.py`` has them (the served decoder's MoE,
    ``models.llama._moe_ffn``, multiplies through ``_qe`` as JAX's
    ``models/llama.py`` does; each is held to its own JAX function)."""
    gate = torch.einsum("ecd,edf->ecf", xe.float(), p["w_gate"].float())
    up = torch.einsum("ecd,edf->ecf", xe.float(), p["w_up"].float())
    h = (F.silu(gate) * up).to(xe.dtype)
    return torch.einsum("ecf,efd->ecd", h.float(), p["w_down"].float()).to(xe.dtype)


def _expert_block(p: dict, cfg: MoEConfig, x: torch.Tensor, e0: int, n_local: int):
    """x (T, d) through experts e0 .. e0 + n_local (``p``'s expert leaves
    hold exactly those): their block of the routing tensors, their SwiGLU,
    their part of the combine."""
    dispatch, combine = route_expert_block(p["router"], x, cfg.n_experts, cfg.top_k,
                                           cfg.capacity(x.shape[0]), e0, n_local)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    return torch.einsum("tec,ecd->td", combine.to(x.dtype), _expert_ffn(p, xe))


@torch.no_grad()
def moe_ffn(params: dict, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """Single-device reference. x (T, d) -> (T, d)."""
    return _expert_block(params, cfg, x, 0, cfg.n_experts)


@torch.no_grad()
def moe_ffn_ep(params: dict, cfg: MoEConfig, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Experts split over ``ep`` (``params`` tensors, laid out here, or
    ``Sharded`` by ``moe_param_shardings``), activations replicated, one sum
    completes the combine. Returns (T, d) on x's device; matches
    ``moe_ffn`` up to the sum's order."""
    ep = mesh.shape["ep"]
    if cfg.n_experts % ep:
        raise ValueError(f"n_experts {cfg.n_experts} must divide ep={ep}")
    specs = moe_param_shardings(mesh)
    placed = {k: as_sharded(params[k], mesh, specs[k]) for k in specs}
    n_local = cfg.n_experts // ep
    parts = []
    for r in range(ep):
        dev = mesh.device((r,))
        with on_device(dev):
            p = {k: v.local((r,)) for k, v in placed.items()}
            parts.append(_expert_block(p, cfg, x.to(dev), r * n_local, n_local))
    return tp_sum(parts).to(x.device)
