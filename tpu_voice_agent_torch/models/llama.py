"""Llama-family decoder in PyTorch (dense and MoE feed-forward).

Port of ``tpu_voice_agent/models/llama.py``: the same parameter tree (layers
stacked on a leading axis), the same int8 weight-only scheme, the same
``forward`` branch split between the attention kernels and the plain cache
attention. Plain functions on tensors; the caller picks the device.

Differences from the JAX module, all deliberate:
- ``forward`` writes the new k/v into the stacked cache IN PLACE and returns
  the same dict (JAX returns an updated copy); the layer loop is a Python
  loop over per-layer views, not a ``lax.scan``.
- a bf16 product rounds its output to bf16 before the int8 scale multiplies
  it (XLA kept that output in f32). fp32 weights have no such step.
- ``forward_paged`` scatters into the paged pool (and, under KV_QUANT, its
  scale planes) IN PLACE (JAX donates them and returns new ones) and
  returns only the logits.
- ``init_params(quant="int8")`` quantizes each leaf as it is drawn, and
  draws the stacked expert leaves one layer at a time, so a mixtral-8x7b
  engine never holds its bf16 tree (about 93 GB).
The MoE feed-forward (``n_experts > 0``) has both dispatch layouts: the
dense one-hot ``_moe_ffn`` through ``_qe``, and ``_moe_ffn_grouped``
(``moe_impl="grouped"``) through K13 (``ops.grouped_matmul``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops import (
    decode_attention_layer,
    decode_block_attention_layer,
    flash_attention,
    grouped_matmul,
    paged_attention,
    paged_attention_quant,
    paged_block_attention,
    paged_block_attention_quant,
    sharded_decode_attention_layer,
    sharded_decode_block_attention_layer,
    sharded_flash_attention,
)
from ..ops.kvquant import dequantize_kv, kv_quant_bits, quantize_kv
from ..parallel.mesh import Sharded, local_tree, on_device
from ..utils.compilewatch import watch_compiles
from .moe import moe_capacity, route_expert_block, route_topk_flat

# ---------------------------------------------------------------- config


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 4096
    dim: int = 2048
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    ffn_dim: int = 5632
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    n_experts: int = 0  # > 0: the MoE feed-forward replaces the dense SwiGLU
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_impl: str = "dense"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


# widest mid-sequence block the block-decode kernel (K3) serves; wider
# blocks (suffix prefill buckets) take the plain cache attention
MAX_BLOCK_DECODE_T = 16

PRESETS: dict[str, LlamaConfig] = {
    "test-tiny": LlamaConfig(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
                             max_seq_len=256),
    "draft-tiny": LlamaConfig(dim=64, n_layers=1, n_heads=2, n_kv_heads=1, ffn_dim=128,
                              max_seq_len=256),
    "tinyllama-1.1b": LlamaConfig(dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
                                  ffn_dim=5632),
    "llama3-8b": LlamaConfig(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, ffn_dim=14336,
                             rope_theta=500_000.0, max_seq_len=8192),
    "llama3-70b": LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, ffn_dim=28672,
                              rope_theta=500_000.0, max_seq_len=8192),
    # capacity_factor = E / K keeps the dense dispatch drop-free (capacity ==
    # token count), so chunked prefill equals per-token decode
    "mixtral-test": LlamaConfig(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
                                max_seq_len=256, n_experts=4, top_k=2, capacity_factor=2.0),
    "mixtral-8x7b": LlamaConfig(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, ffn_dim=14336,
                                rope_theta=1_000_000.0, max_seq_len=8192, n_experts=8, top_k=2,
                                capacity_factor=4.0),
}


# ---------------------------------------------------------------- params


def init_params(cfg: LlamaConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device: str | torch.device | None = None, quant: str | None = None) -> dict:
    """Random init with the JAX module's shapes and scales (normal draws in
    fp32, scaled by fan-in ** -0.5, cast to ``dtype``). The numbers differ
    from ``jax.random``'s; tests share weights through ``bridge`` instead.
    ``device`` defaults to the generator's.

    The stacked expert leaves (L, E, ...) are drawn one layer at a time;
    every other leaf whole, in the dense presets' order. With
    ``quant="int8"`` each matmul weight is quantized as soon as it is drawn
    (an expert layer straight into a preallocated stacked int8 leaf), so the
    tree at ``dtype`` is never held whole; the result equals
    ``quantize_params(init_params(...))`` bit for bit, since a leaf's
    per-out-channel max lies inside one layer's plane."""
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quant {quant!r}")
    device = device if device is not None else generator.device
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    nq, nkv, L, E = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.n_experts

    def draw(shape, scale):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    def w(*shape, scale=None, raw=False):
        x = draw(shape, scale if scale is not None else shape[-2] ** -0.5)
        return x if raw or quant is None else quantize_leaf(x)

    def stacked(*shape):
        """An (L, *shape) leaf drawn layer by layer, quantized per layer."""
        scale = shape[-2] ** -0.5
        if quant is None:
            out = torch.empty((L, *shape), device=device, dtype=dtype)
            for i in range(L):
                out[i] = draw(shape, scale)
            return out
        out = {"q": torch.empty((L, *shape), device=device, dtype=torch.int8),
               "s": torch.empty((L, *shape[:-2], 1, shape[-1]), device=device,
                                dtype=torch.float32)}
        for i in range(L):
            leaf = quantize_leaf(draw(shape, scale))
            out["q"][i], out["s"][i] = leaf["q"], leaf["s"]
        return out

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    embed = w(cfg.vocab_size, d, scale=d**-0.5, raw=True)
    layers = {
        "attn_norm": ones(L, d),
        "wq": w(L, d, nq * hd),
        "wk": w(L, d, nkv * hd),
        "wv": w(L, d, nkv * hd),
        "wo": w(L, nq * hd, d),
        "mlp_norm": ones(L, d),
    }
    if E > 0:
        layers.update({
            # the router stays small and in full precision
            "router": w(L, d, E, raw=True),
            "moe_gate": stacked(E, d, f),
            "moe_up": stacked(E, d, f),
            "moe_down": stacked(E, f, d),
        })
    else:
        layers.update({"w_gate": w(L, d, f), "w_up": w(L, d, f), "w_down": w(L, f, d)})
    return {"embed": embed, "layers": layers, "final_norm": ones(d),
            "lm_head": w(d, cfg.vocab_size)}


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device: str | torch.device = "cpu") -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def unstack_layers(layers: dict) -> list[dict]:
    """Per-layer views of a stacked layer dict (no copies): the layer loop
    indexes these instead of re-slicing every leaf on every forward."""
    L = next(iter(layers.values()))
    L = (L["q"] if isinstance(L, dict) else L).shape[0]

    def pick(leaf, i):
        return {k: v[i] for k, v in leaf.items()} if isinstance(leaf, dict) else leaf[i]

    return [{k: pick(v, i) for k, v in layers.items()} for i in range(L)]


def stack_layers(layers) -> dict:
    """The stacked (L, ...) layer dict of per-layer dicts (a copy); a
    stacked dict passes through."""
    if isinstance(layers, dict):
        return layers

    def stack(vals):
        if isinstance(vals[0], dict):
            return {k: stack([v[k] for v in vals]) for k in vals[0]}
        return torch.stack(vals)

    return {k: stack([layer[k] for layer in layers]) for k in layers[0]}


# ---------------------------------------------------------------- quantization


def _qe(x: torch.Tensor, leaf) -> torch.Tensor:
    """``x @ W`` as float32, where W may be an int8 ``{"q", "s"}`` leaf.
    The per-out-channel scale multiplies the OUTPUT, ``(x @ q) * s``
    (llama.py:169-182): ``s`` is constant along the contraction axis. The
    int8 weight is converted to x's dtype on every call (about 5 bytes of
    traffic per weight against the 1-byte floor; a fused int8 GEMV is later
    work)."""
    if isinstance(leaf, dict):
        return torch.matmul(x, leaf["q"].to(x.dtype)).float() * leaf["s"].float()
    return torch.matmul(x, leaf).float()


def quantize_leaf(w: torch.Tensor) -> dict:
    """One weight -> {"q": int8, "s": f32 per-out-channel}: the same
    float32 arithmetic as llama.py:185-196 (round half to even), so the
    result is bit-identical to the JAX package's."""
    wf = w.float()
    s = torch.amax(torch.abs(wf), dim=-2, keepdim=True) / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_params(params: dict) -> dict:
    """Weight-only symmetric int8, per-output-channel scales. Norms, the
    embedding table and the MoE router keep their dtype; every matmul weight
    (dense ``w*`` and stacked-expert ``moe_*``) becomes {"q": int8, "s": f32}."""
    layers = params["layers"]
    return {
        "embed": params["embed"],
        "layers": {k: (quantize_leaf(v) if k.startswith(("w", "moe_"))
                       and not isinstance(v, dict) else v)
                   for k, v in layers.items()},
        "final_norm": params["final_norm"],
        "lm_head": (params["lm_head"] if isinstance(params["lm_head"], dict)
                    else quantize_leaf(params["lm_head"])),
    }


# ---------------------------------------------------------------- ops


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin for rotary embedding; positions (B, T) -> (B, T, hd//2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, hd); rotate pairs (split-half convention)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attend(q, k_cache, v_cache, q_positions, kv_len_mask):
    """GQA attention of q (B,T,nq,hd) against the full cache (B,S,nkv,hd),
    plain torch as XLA had it: bf16 operands with f32 scores, probabilities
    rounded to the cache dtype before the value product. kv_len_mask
    (B, S) marks valid slots; slot i holds the token at position i."""
    B, T, nq, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, T, nkv, nq // nkv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k_cache.float()) * (hd**-0.5)
    causal = torch.arange(S, device=q.device)[None, None, :] <= q_positions[:, :, None]
    mask = (causal & kv_len_mask[:, None, :])[:, None, None, :, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs.float(), v_cache.float())
    return out.reshape(B, T, nq * hd).to(q.dtype)


def _layer_proj(p, x, cfg: LlamaConfig):
    """attn-norm -> the q / k / v projections, (B, T, heads * head_dim)
    each (a tensor-parallel shard's own columns of them)."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    return tuple(_qe(h, p[n]).to(x.dtype) for n in ("wq", "wk", "wv"))


def _rope_heads(q, k, v, head_dim: int, cos, sin):
    """Projections -> (B, T, heads, head_dim), q and k rotated."""
    B, T = q.shape[:2]
    q, k, v = (t.reshape(B, T, -1, head_dim) for t in (q, k, v))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _layer_qkv(p, x, cfg: LlamaConfig, cos, sin):
    """attn-norm -> q/k/v projections -> head reshape -> RoPE."""
    return _rope_heads(*_layer_proj(p, x, cfg), cfg.head_dim, cos, sin)


def grouped_layout(flat_e: torch.Tensor, n_experts: int):
    """The grouped dispatch's row layout (llama.py:311-341) for the
    expert ids of N assignments: ``order`` sorts them expert-major and
    token-stable; sorted assignment i lands on row ``pos[i]`` of an
    (``M_pad``, .) buffer where each expert's run is zero-padded to a
    multiple of the row tile ``tm``; ``tile_expert`` (M_pad // tm,) int32
    names each tile's expert. ``tm`` and ``M_pad`` are the JAX module's
    exactly (``tile_expert``'s meaning depends on them) and follow from N
    alone, so nothing is read back from the device. ``live_rows`` (1,)
    int32, on the device: ``sum(padded)``, the rows of the padded runs; the
    tiles from there on are the zero tail, which K13 skips."""
    E, N, dev = n_experts, flat_e.shape[0], flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    tm = min(128, max(8, 1 << (max(N, 1) - 1).bit_length()))
    counts = (flat_e[:, None] == torch.arange(E, device=dev)).sum(0)  # bincount would sync
    padded = (counts + tm - 1) // tm * tm
    ends = torch.cumsum(padded, 0)
    starts = torch.cumsum(counts, 0) - counts
    # its expert's padded offset plus its rank within the expert's run
    pos = (ends - padded)[sorted_e] + torch.arange(N, device=dev) - starts[sorted_e]
    M_pad = -(-N // tm) * tm + E * tm
    # tail tiles past sum(padded) clip to expert E-1: their rows stay zero
    # and are never gathered back
    tile_expert = torch.clamp(
        torch.searchsorted(ends, torch.arange(M_pad // tm, device=dev) * tm, right=True),
        0, E - 1).to(torch.int32)
    return order, pos, tm, M_pad, tile_expert, ends[-1:].to(torch.int32)


def _moe_ffn_grouped(p, h, cfg: LlamaConfig):
    """The grouped MoE dispatch (llama.py:296-350): assignments sorted by
    expert into tile-padded runs (``grouped_layout``), and K13 multiplies
    each row tile by its expert's plane (gate, up, down: three launches), so
    FFN work goes with T * K, not T * E; the tail tiles past the padded runs
    (``live_rows``) are zeros that it skips. The int8 expert leaves go to the
    kernel as they are: it forms the JAX module's ``_w`` values
    (``ops.dequantize_leaf``) per tile instead of a bf16 copy."""
    B, T, d = h.shape
    Tt = B * T
    x2 = h.reshape(Tt, d)
    eids, gates = route_topk_flat(p["router"], x2, cfg.n_experts, cfg.top_k)  # (Tt, K)
    order, pos, tm, M_pad, tile_expert, live = grouped_layout(eids.reshape(-1).long(),
                                                              cfg.n_experts)
    tok = order // cfg.top_k  # assignment j = t * K + k belongs to token t
    xs = torch.zeros((M_pad, d), dtype=h.dtype, device=h.device)
    xs[pos] = x2[tok]
    gate_s = grouped_matmul(xs, p["moe_gate"], tile_expert, tm, live_rows=live)
    up_s = grouped_matmul(xs, p["moe_up"], tile_expert, tm, live_rows=live)
    act = (F.silu(gate_s.float()) * up_s.float()).to(h.dtype)
    down = grouped_matmul(act, p["moe_down"], tile_expert, tm, live_rows=live)  # (M_pad, d)
    # the combine in fp32, gates unrounded: each row receives K addends onto
    # zero, exact in any order for K = 2 (CUDA's index_add_ adds by atomics,
    # so K > 2 would make the sum's order, and its last bit, vary)
    out = torch.zeros((Tt, d), dtype=torch.float32, device=h.device)
    out.index_add_(0, tok, gates.reshape(-1)[order][:, None] * down[pos].float())
    return out.to(h.dtype).reshape(B, T, d)


def _moe_ffn(p, h, cfg: LlamaConfig):
    """Top-k routed expert FFN over (B, T, d) hidden states
    (llama.py:353-393): the dense one-hot dispatch through ``_qe``, or with
    ``moe_impl="grouped"`` the grouped one. Serving is drop-free: a
    capacity factor below E / K is clamped up to it, with a warning, so pad
    tokens of a bucketed prefill never crowd out real ones."""
    if cfg.moe_impl == "grouped":
        return _moe_ffn_grouped(p, h, cfg)
    cf = max(cfg.capacity_factor, cfg.n_experts / cfg.top_k)
    if cf != cfg.capacity_factor:
        warnings.warn(
            f"MoE serving path clamped capacity_factor {cfg.capacity_factor} -> "
            f"{cf} (= E/K) to stay drop-free; set capacity_factor >= "
            f"{cfg.n_experts}/{cfg.top_k} in the config to silence this",
            stacklevel=2,
        )
    return _moe_ffn_shard(p, h, cfg, 0, cfg.n_experts)


def _moe_ffn_shard(p, h, cfg: LlamaConfig, e0: int, n_local: int):
    """The dense-dispatch MoE FFN over experts e0 .. e0 + n_local (all of
    them for ``_moe_ffn``; one tp shard's block on a mesh whose tp axis
    splits the experts, ``parallel.mesh.param_shardings``): the full
    drop-free routing, that block of the dispatch and combine tensors, its
    experts' SwiGLU; the shards' outputs sum to ``_moe_ffn``'s."""
    B, T, d = h.shape
    x2 = h.reshape(B * T, d)
    cf = max(cfg.capacity_factor, cfg.n_experts / cfg.top_k)
    C = moe_capacity(B * T, cfg.n_experts, cfg.top_k, cf)
    dispatch, combine = route_expert_block(p["router"], x2, cfg.n_experts, cfg.top_k, C,
                                           e0, n_local)
    xe = torch.einsum("tec,td->ecd", dispatch.to(h.dtype), x2)  # (n_local, C, d)
    a = (F.silu(_qe(xe, p["moe_gate"])) * _qe(xe, p["moe_up"])).to(h.dtype)
    down = _qe(a, p["moe_down"]).to(h.dtype)
    return torch.einsum("tec,ecd->td", combine.to(h.dtype), down).reshape(B, T, d)


def _layer_out(p, x, attn, cfg: LlamaConfig):
    """Output projection + residual, then the MLP (dense SwiGLU, or the
    routed MoE when ``cfg.n_experts > 0``) + residual. ``attn`` is
    (B, T, n_heads * head_dim)."""
    x = x + _qe(attn, p["wo"]).to(x.dtype)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts > 0:
        return x + _moe_ffn(p, h, cfg)
    act = (F.silu(_qe(h, p["w_gate"])) * _qe(h, p["w_up"])).to(x.dtype)
    return x + _qe(act, p["w_down"]).to(x.dtype)


# ---------------------------------------------------------------- forward


@torch.no_grad()
@watch_compiles("llama.forward")
def forward(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # (B, T) int32
    positions: torch.Tensor,  # (B, T) int32 — absolute positions of `tokens`
    kv_cache: dict,  # (L, B, S, nkv, hd), updated in place
    attn_impl: str = "kernels",  # "kernels" | "torch"
    fresh_block: bool = False,  # caller asserts this T>1 block starts a sequence at pos 0
    rules=None,  # parallel.mesh.ShardingRules: the tensor-parallel forward on its mesh
) -> tuple[torch.Tensor, dict]:
    """Unified prefill/decode forward; returns logits (B, T, V) f32 and the
    cache dict (the same tensors, written in place).

    With ``rules`` the params and the cache are ``parallel.mesh.Sharded``
    trees laid out by ``param_shardings`` / ``kv_cache_shardings`` on
    ``rules.mesh`` and ``_forward_mesh`` runs the tensor-parallel forward.

    Writes k/v for ``tokens`` into cache slots ``positions``, then attends.
    ``attn_impl="kernels"`` takes the branch split of llama.py:475-511:
    T == 1 -> K2 against the cache with per-row frontiers; a mid-sequence
    block of T <= 16 -> K3; a fresh block (``fresh_block=True``, the
    caller's promise that it starts at position 0) -> K1 over the block's own
    k/v; anything else (a suffix block after a cached prefix) -> the plain
    cache attention ``_attend``. ``attn_impl="torch"`` takes ``_attend``
    everywhere. Each kernel wrapper runs its plain version on CPU tensors.
    """
    if rules is not None:
        return _forward_mesh(params, cfg, tokens, positions, kv_cache, rules,
                             attn_impl == "kernels", fresh_block), kv_cache
    B, T = tokens.shape
    S = kv_cache["k"].shape[2]
    layers = params["layers"]
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    x = params["embed"][tokens.long()]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    # slot s is valid if s <= the max written position of its row
    frontier = torch.amax(positions, dim=1)  # (B,)
    kv_len_mask = torch.arange(S, device=tokens.device)[None, :] <= frontier[:, None]
    kv_len = (frontier + 1).to(torch.int32)
    rows = torch.arange(B, device=tokens.device)[:, None]
    pos_l = positions.long()
    kc, vc = kv_cache["k"], kv_cache["v"]
    kernels = attn_impl == "kernels"
    for li, p in enumerate(layers):
        q, k, v = _layer_qkv(p, x, cfg, cos, sin)
        # write-then-attend, in place: duplicate (row, position) writes in a
        # padded fast-forward block carry identical values
        kc[li][rows, pos_l] = k.to(kc.dtype)
        vc[li][rows, pos_l] = v.to(vc.dtype)
        if kernels and T == 1:
            attn = decode_attention_layer(q[:, 0], kc, vc, kv_len, li)
        elif kernels and not fresh_block and T <= MAX_BLOCK_DECODE_T:
            attn = decode_block_attention_layer(q, kc, vc, positions, li)
        elif kernels and fresh_block:
            attn = flash_attention(q, k, v, causal=True)
        else:
            attn = _attend(q, kc[li], vc[li], positions, kv_len_mask)
        x = _layer_out(p, x, attn.reshape(B, T, -1), cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _qe(x, params["lm_head"]), kv_cache


def tp_sum(parts: list) -> torch.Tensor:
    """The all-reduce of a tensor-parallel group: its shards' partials summed
    in shard order on the first shard's device, so every shard that takes a
    copy holds the same bits."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc


def _group_add(x: dict, part: dict, groups, dev: dict) -> dict:
    """``x`` plus its tp group's partials summed in shard order (``tp_sum``),
    on every shard of the group."""
    out = {}
    for g in groups:
        total = tp_sum([part[c] for c in g])
        for c in g:
            out[c] = x[c] + total.to(dev[c]).to(x[c].dtype)
    return out


def tp_block(x: dict, p: dict, cfg: LlamaConfig, groups, dev: dict, rope: dict, cache: dict,
             slots: dict, attend, gather_q: bool = False, moe_split: bool = False) -> dict:
    """One Megatron decoder block over tensor-parallel shards, every
    argument a dict keyed by shard: ``x`` the residual stream (each shard's
    copy), ``p`` its layer weights, ``dev`` its device, ``rope`` its
    (cos, sin), ``cache`` its (k, v) layer blocks, written in place at
    ``slots`` (the (row, position) index pair); ``groups`` lists the tp
    groups' shards in shard order. Each shard projects its heads' q / k / v
    (with ``gather_q``, tp does not divide the heads: wq's column slices are
    gathered over the group before RoPE, every shard attends over all the
    heads and keeps its rows of wo's input) and writes its cache block;
    ``attend(q, k, v)`` maps the (B, T, heads, hd) dicts to each shard's
    attention. The row-parallel wo and w_down partials are summed over the
    group (``_group_add``: the two all-reduces). The FFN is the SwiGLU
    slice, or the MoE: with ``moe_split`` the shard's expert block (partials
    summed), else the whole on every shard. Each shard's work runs with its
    card current; at tp 1 this is ``_layer_qkv`` + ``_layer_out``."""
    keys = [c for g in groups for c in g]
    q, k, v = {}, {}, {}
    for c in keys:
        with on_device(dev[c]):
            q[c], k[c], v[c] = _layer_proj(p[c], x[c], cfg)
    if gather_q:
        q = {c: torch.cat([q[s].to(dev[c]) for s in g], dim=-1) for g in groups for c in g}
    for c in keys:
        with on_device(dev[c]):
            q[c], k[c], v[c] = _rope_heads(q[c], k[c], v[c], cfg.head_dim, *rope[c])
            kc, vc = cache[c]
            kc[slots[c]] = k[c].to(kc.dtype)
            vc[slots[c]] = v[c].to(vc.dtype)
    attn = attend(q, k, v)
    part = {}
    for g in groups:
        for j, c in enumerate(g):
            with on_device(dev[c]):
                a = attn[c].reshape(*x[c].shape[:2], -1)
                if gather_q:
                    w = a.shape[-1] // len(g)
                    a = a[..., j * w:(j + 1) * w]
                part[c] = _qe(a, p[c]["wo"])
    x = _group_add(x, part, groups, dev)
    for g in groups:
        for j, c in enumerate(g):
            with on_device(dev[c]):
                h = rms_norm(x[c], p[c]["mlp_norm"], cfg.norm_eps)
                if cfg.n_experts > 0 and moe_split:
                    n = cfg.n_experts // len(g)
                    part[c] = _moe_ffn_shard(p[c], h, cfg, j * n, n).float()
                elif cfg.n_experts > 0:
                    part[c] = _moe_ffn(p[c], h, cfg)
                else:
                    act = (F.silu(_qe(h, p[c]["w_gate"])) * _qe(h, p[c]["w_up"]))
                    part[c] = _qe(act.to(x[c].dtype), p[c]["w_down"])
    if cfg.n_experts > 0 and not moe_split:  # replicated experts: the whole FFN
        return {c: x[c] + part[c].to(x[c].dtype) for c in keys}
    return _group_add(x, part, groups, dev)


def _forward_mesh(params, cfg: LlamaConfig, tokens, positions, kv_cache, rules,
                  kernels: bool, fresh_block: bool) -> torch.Tensor:
    """The tensor-parallel forward on a (dp, tp) mesh (llama.py:418-530 under
    ``rules``). Batch rows split over dp; each layer is ``tp_block`` over
    the dp groups (all heads, q gathered over the shards, when tp does not
    divide the kv heads: the cache is then replicated), attending through
    the sharded kernel wrappers (one launch per shard); the vocab-split
    logits are gathered onto ``tokens``' device. Nothing is copied out of
    the cache."""
    mesh = rules.mesh
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    kc, vc = kv_cache["k"], kv_cache["v"]
    B, T = tokens.shape
    hd = cfg.head_dim
    heads = tp == 1 or kc.spec[3] == "tp"
    if heads != (cfg.n_kv_heads % tp == 0) or (dp > 1 and kc.spec[1] != "dp"):
        raise ValueError(f"cache laid out as {kc.spec}; the meshed forward takes "
                         "parallel.mesh.kv_cache_shardings' layout")
    if kc.shape[1] != B:
        raise ValueError(f"{B} token rows for a cache of {kc.shape[1]}")
    Bl = B // dp
    coords = mesh.coords()
    dev = {c: mesh.device(c) for c in coords}
    groups = [[(i, j) for j in range(tp)] for i in range(dp)]

    def rows(t, c):
        return t[c[0] * Bl:(c[0] + 1) * Bl].to(dev[c])

    frontier = torch.amax(positions, dim=1)
    kv_len = (frontier + 1).to(torch.int32)
    pos = {c: rows(positions, c) for c in coords}
    slots = {c: (torch.arange(Bl, device=dev[c])[:, None], pos[c].long()) for c in coords}
    mask = {c: torch.arange(kc.shape[2], device=dev[c])[None, :] <= rows(frontier, c)[:, None]
            for c in coords}
    rope = {c: rope_tables(pos[c], hd, cfg.rope_theta) for c in coords}
    x = {c: params["embed"].local(c)[rows(tokens, c).long()] for c in coords}
    layers = params["layers"]
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    gate = layers[0].get("moe_gate")
    gate = gate["q"] if isinstance(gate, dict) else gate
    moe_split = gate is not None and tp > 1 and gate.spec[0] == "tp"  # experts over tp
    qs = ("dp", None, "tp" if heads else None, None)

    def attend(q, k, v, li):
        if kernels and T == 1:
            a = sharded_decode_attention_layer(
                mesh, Sharded.from_locals(mesh, (qs[0], qs[2], None), {c: q[c][:, 0] for c in q}),
                kc, vc, kv_len, li)
        elif kernels and not fresh_block and T <= MAX_BLOCK_DECODE_T:
            a = sharded_decode_block_attention_layer(mesh, Sharded.from_locals(mesh, qs, q),
                                                     kc, vc, positions, li)
        elif kernels and fresh_block:
            a = sharded_flash_attention(mesh, Sharded.from_locals(mesh, qs, q),
                                        Sharded.from_locals(mesh, qs, k),
                                        Sharded.from_locals(mesh, qs, v), causal=True)
        else:
            out = {}
            for c in coords:
                with on_device(dev[c]):
                    out[c] = _attend(q[c], kc.local(c)[li], vc.local(c)[li], pos[c], mask[c])
            return out
        return {c: a.local(c) for c in coords}

    for li, lp in enumerate(layers):
        x = tp_block(x, {c: local_tree(lp, c) for c in coords}, cfg, groups, dev, rope,
                     {c: (kc.local(c)[li], vc.local(c)[li]) for c in coords}, slots,
                     lambda q, k, v, li=li: attend(q, k, v, li),
                     gather_q=not heads, moe_split=moe_split)
    out = []
    for g in groups:
        parts = []
        for c in g:
            with on_device(dev[c]):
                hf = rms_norm(x[c], params["final_norm"].local(c), cfg.norm_eps)
                parts.append(_qe(hf, local_tree(params["lm_head"], c)).to(tokens.device))
        out.append(torch.cat(parts, dim=-1))
    return torch.cat(out, dim=0)


@watch_compiles("llama.forward_paged", static=("gather_blocks",))
@torch.no_grad()
def forward_paged(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # (B, T) int32
    positions: torch.Tensor,  # (B, T) int32 — absolute positions of `tokens`
    k_pool: torch.Tensor,  # (L, N, bs, nkv, hdp) — the global paged pool, updated in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int32 pool-block ids
    attn_impl: str = "kernels",  # "kernels" | "torch"
    write_mask: torch.Tensor | None = None,  # (B,) bool; False rows park their writes
    trash_idx: torch.Tensor | None = None,  # (B,) int32 flat pool index for parked writes
    fresh_block: bool = False,  # caller asserts this T>1 block starts a sequence at pos 0
    gather_blocks: int | None = None,  # T>1 suffix path: gather only the first N entries
    k_scale: torch.Tensor | None = None,  # (L, N, bs, nkv) bf16 under KV_QUANT, in place
    v_scale: torch.Tensor | None = None,
    kv_quant: str | None = None,  # None | "int8" | "int4"
) -> torch.Tensor:
    """The paged twin of ``forward`` (llama.py:533-726); returns logits
    (B, T, V) f32.

    Writes k/v for ``tokens`` into the flat pool IN PLACE at
    ``table[b, pos // bs] * bs + pos % bs``; rows with ``write_mask`` False
    park every write at ``trash_idx`` (default 0: block 0, which the
    allocator never hands out), so an idle row never scribbles on another
    sequence's blocks or the shared prefix's. Then attends, with
    ``attn_impl="kernels"``: T == 1 -> K6 with ``kv_len = frontier + 1``; a
    mid-sequence block of T <= 16 -> K7; a fresh T > 1 block -> K1 over the
    block's own k/v rounded to the pool's dtype (what the scatter persisted);
    any other suffix block -> the row's first ``gather_blocks`` table
    entries gathered to a contiguous cache and the plain ``_attend``.
    ``attn_impl="torch"`` takes the last two branches only, as the JAX
    engine's suffix prefill does under ``attn_impl="xla"``.

    With ``kv_quant`` ("int8" | "int4") the pool holds ``ops.kvquant``'s
    stored values and ``k_scale`` / ``v_scale`` their bf16 scales: writes
    quantize, values and scales landing at the same flat index (parked rows
    too), and each read takes the stored values: T == 1 -> K8, a
    mid-sequence block -> K9 (each widens int * scale exactly in fp32); a
    fresh block -> K1 over ``dequantize_kv`` of what was stored, rounded to
    bf16 as the JAX module's ``dequantize_kv`` default gives; a gathered
    suffix -> ``dequantize_kv`` (bf16) and the plain ``_attend``."""
    B, T = tokens.shape
    L, N, bs, nkv, hdp = k_pool.shape
    nb = gather_blocks if gather_blocks is not None else block_tables.shape[1]
    S = nb * bs
    if kv_quant is not None and (k_scale is None or v_scale is None):
        raise ValueError(f"kv_quant={kv_quant!r} needs the k_scale / v_scale planes")
    bits = kv_quant_bits(kv_quant)
    layers = params["layers"]
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    dev = tokens.device
    x = params["embed"][tokens.long()]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    frontier = torch.amax(positions, dim=1)  # (B,)
    kv_len = (frontier + 1).to(torch.int32)
    pos_l = positions.long()
    blk = torch.gather(block_tables.long(), 1, pos_l // bs)
    flat_idx = blk * bs + pos_l % bs  # (B, T) into the (N * bs,) flat pool
    if write_mask is not None:
        park = (torch.zeros((B,), dtype=torch.long, device=dev) if trash_idx is None
                else trash_idx.long())
        flat_idx = torch.where(write_mask[:, None], flat_idx, park[:, None])
    kflat = k_pool.view(L, N * bs, nkv, hdp)
    vflat = v_pool.view(L, N * bs, nkv, hdp)
    if kv_quant is not None:
        ksflat = k_scale.view(L, N * bs, nkv)
        vsflat = v_scale.view(L, N * bs, nkv)
    kernels = attn_impl == "kernels"
    tbl = block_tables[:, :nb].long()  # the gather branch's covered blocks
    kv_len_mask = torch.arange(S, device=dev)[None, :] <= frontier[:, None]
    for li, p in enumerate(layers):
        q, k, v = _layer_qkv(p, x, cfg, cos, sin)
        if kv_quant is None:
            kflat[li][flat_idx] = k.to(k_pool.dtype)
            vflat[li][flat_idx] = v.to(v_pool.dtype)
        else:
            # quantize-on-write: one rowwise quantization at the scatter,
            # values and their scales at the same flat index
            qk, sk = quantize_kv(k, kv_quant)
            qv, sv = quantize_kv(v, kv_quant)
            kflat[li][flat_idx] = qk
            vflat[li][flat_idx] = qv
            ksflat[li][flat_idx] = sk
            vsflat[li][flat_idx] = sv
        if kernels and T == 1:
            if kv_quant is None:
                attn = paged_attention(q[:, 0], k_pool, v_pool, block_tables, kv_len, li)
            else:
                attn = paged_attention_quant(q[:, 0], k_pool, v_pool, k_scale, v_scale,
                                             block_tables, kv_len, li, bits=bits)
        elif kernels and not fresh_block and T <= MAX_BLOCK_DECODE_T:
            if kv_quant is None:
                attn = paged_block_attention(q, k_pool, v_pool, block_tables, positions, li)
            else:
                attn = paged_block_attention_quant(q, k_pool, v_pool, k_scale, v_scale,
                                                   block_tables, positions, li, bits=bits)
        elif fresh_block and T > 1:
            if kv_quant is None:
                k_at, v_at = k.to(k_pool.dtype), v.to(v_pool.dtype)
            else:  # what the pool stores, as a later read dequantizes it
                k_at, v_at = dequantize_kv(qk, sk, kv_quant), dequantize_kv(qv, sv, kv_quant)
            if kernels:
                # the kernel takes one dtype: the stored values, widened
                attn = flash_attention(q, k_at.to(q.dtype), v_at.to(q.dtype), causal=True)
            else:
                attn = _attend(q, k_at, v_at, positions,
                               torch.ones((B, T), dtype=torch.bool, device=dev))
        else:
            kl = k_pool[li][tbl].reshape(B, S, nkv, hdp)
            vl = v_pool[li][tbl].reshape(B, S, nkv, hdp)
            if kv_quant is not None:
                kl = dequantize_kv(kl, k_scale[li][tbl].reshape(B, S, nkv), kv_quant)
                vl = dequantize_kv(vl, v_scale[li][tbl].reshape(B, S, nkv), kv_quant)
            attn = _attend(q, kl, vl, positions, kv_len_mask)
        x = _layer_out(p, x, attn.reshape(B, T, -1), cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _qe(x, params["lm_head"])


def param_count(cfg: LlamaConfig) -> int:
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    per_layer = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) + (cfg.n_heads * hd) * d
    if cfg.n_experts > 0:
        per_layer += cfg.n_experts * 3 * d * f + d * cfg.n_experts + 2 * d
    else:
        per_layer += 3 * d * f + 2 * d
    return cfg.vocab_size * d * 2 + cfg.n_layers * per_layer + d
