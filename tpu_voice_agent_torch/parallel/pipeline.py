"""Pipeline parallelism over a ``pp`` mesh axis, alone or with tp inside.

Port of ``tpu_voice_agent/parallel/pipeline.py``. The stacked layer axis
splits into S stages, stage s on the devices of mesh row s, each holding
only its own layers' weights and KV cache. JAX runs the schedule SPMD:
every stage computes on every tick, one ``ppermute`` hop a tick, and only
the stage whose turn it is keeps its writes (bubble ticks compute on
garbage that is never read). The port is single-controller: stage s runs
its layers once per microbatch, in the schedule's order, and the
activation hops to the next stage's devices with ``.to``. The results are
JAX's, since JAX discards what the bubble ticks compute.

Inside a stage the block follows JAX: attention is the full-mask plain
``_attend`` over the staged cache (JAX runs XLA there; no frontier kernel
serves the staged layout, ``serve/pp_engine.py`` says why), and with tp
each shard computes its heads and its slice of the FFN, the row-parallel
wo / w_down partials summed in shard order (``models.llama.tp_sum``: the
two all-reduces of a Megatron block). A shard's work runs with its card
current. Caches are written in place (JAX donates and returns them).
"""

from __future__ import annotations

import torch

from ..models.llama import (
    LlamaConfig,
    _attend,
    _layer_out,
    _layer_qkv,
    _qe,
    rms_norm,
    rope_tables,
    tp_block,
    unstack_layers,
)
from ..utils.compilewatch import watch_compiles
from .mesh import Mesh, Sharded, on_device


def pp_mesh(pp: int, devices: list | None = None) -> Mesh:
    """1-D pipeline mesh."""
    return Mesh.from_devices((pp,), ("pp",), devices)


def pp_tp_mesh(pp: int, tp: int, devices: list | None = None) -> Mesh:
    """2-D (pp, tp) mesh: pipeline stages outer, tensor parallel inner."""
    return Mesh.from_devices((pp, tp), ("pp", "tp"), devices)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stage_params(layer_params: dict, n_stages: int) -> dict:
    """Reshape stacked layer params (L, ...) -> (S, L/S, ...) (views)."""
    first = next(iter(layer_params.values()))
    L = (first["q"] if isinstance(first, dict) else first).shape[0]
    if L % n_stages:
        raise ValueError(f"n_layers ({L}) must divide into {n_stages} stages")
    return _tree_map(lambda a: a.reshape(n_stages, L // n_stages, *a.shape[1:]), layer_params)


def stage_param_shardings(mesh: Mesh, layer_params: dict) -> dict:
    """Spec tree for ``stage_params``' output: the stage axis on pp."""
    return _tree_map(lambda a: ("pp",) + (None,) * a.dim(), layer_params)


def staged_tp_shardings(mesh: Mesh, staged: dict | None = None) -> dict:
    """Spec tree for ``stage_params``' output on a (pp, tp) mesh: stages over
    pp, Megatron column / row parallel over tp, norms replicated within the
    stage. With ``staged`` given, an int8 ``{"q", "s"}`` leaf gets a pair: q
    the weight's spec, s (S, L/S, 1, out) split over tp only for a column
    parallel weight (a row-parallel one keeps its whole output per shard)."""
    col, row = ("pp", None, None, "tp"), ("pp", None, "tp", None)
    specs = {"attn_norm": ("pp", None, None), "wq": col, "wk": col, "wv": col, "wo": row,
             "mlp_norm": ("pp", None, None), "w_gate": col, "w_up": col, "w_down": row}
    out = {}
    for name, spec in specs.items():
        if staged is not None and isinstance(staged.get(name), dict):
            out[name] = {"q": spec, "s": ("pp", None, None, "tp" if spec == col else None)}
        else:
            out[name] = spec
    return out


def pipeline_apply(staged_params, x_micro: torch.Tensor, stage_fn, mesh: Mesh) -> torch.Tensor:
    """Run microbatches (n_micro, mb, ...) through the S stages (GPipe):
    ``staged_params`` has a leading stage axis S; ``stage_fn(local_params,
    x) -> y`` applies one stage's layers. Returns (n_micro, mb, ...) with
    the last stage's outputs, on ``x_micro``'s device."""
    S = mesh.shape["pp"]
    n_micro = x_micro.shape[0]
    devs = [mesh.device((s,)) for s in range(S)]
    local = [_tree_map(lambda a, s=s: a[s].to(devs[s]), staged_params) for s in range(S)]
    held: list = [None] * S  # each stage's output of the previous tick
    outs: list = [None] * n_micro
    for t in range(n_micro + S - 1):
        new: list = [None] * S
        for s in range(S):
            m = t - s  # the microbatch stage s works on at tick t
            if not 0 <= m < n_micro:
                continue  # a bubble tick: JAX's output there is never read
            x = (x_micro[m] if s == 0 else held[s - 1]).to(devs[s])
            with on_device(devs[s]):
                new[s] = stage_fn(local[s], x)
            if s == S - 1:
                outs[m] = new[s].to(x_micro.device)
        held = new
    return torch.stack(outs)


def _decoder_block(x, p, cfg: LlamaConfig, cos, sin):
    """One no-cache decoder block: the cached block over a fresh T-slot
    cache with positions 0..T-1, i.e. full-mask attention over the block's
    own k / v."""
    B, T, _ = x.shape
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    q, k, v = _layer_qkv(p, x, cfg, cos, sin)
    attn = _attend(q, k, v, positions, torch.ones((B, T), dtype=torch.bool, device=x.device))
    return _layer_out(p, x, attn, cfg)


@watch_compiles("pipeline.llama_pp_forward")
@torch.no_grad()
def llama_pp_forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, mesh: Mesh,
                     n_micro: int = 2) -> torch.Tensor:
    """Full-sequence logits with the layer stack pipelined over "pp";
    embedding, final norm and lm_head run on ``tokens``' device. Matches
    ``models.llama.forward`` on a fresh cache."""
    B, T = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} must divide into {n_micro} microbatches")
    S = mesh.shape["pp"]
    x = params["embed"][tokens.long()]
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)[None]

    def stage_fn(local_layers, x):
        cos, sin = rope_tables(positions.to(x.device), cfg.head_dim, cfg.rope_theta)
        for p in unstack_layers(local_layers):
            x = _decoder_block(x, p, cfg, cos, sin)
        return x

    staged = stage_params(params["layers"], S)
    x_micro = x.reshape(n_micro, B // n_micro, T, cfg.dim)
    y = pipeline_apply(staged, x_micro, stage_fn, mesh).reshape(B, T, cfg.dim)
    y = rms_norm(y, params["final_norm"], cfg.norm_eps)
    return _qe(y, params["lm_head"])


# ---------------------------------------------------------------- cached


def _cache_zeros(cfg: LlamaConfig, mesh: Mesh, batch: int, max_len: int, dtype,
                 spec) -> dict:
    S = mesh.shape["pp"]
    if cfg.n_layers % S:
        raise ValueError(f"n_layers ({cfg.n_layers}) must divide into {S} stages")
    shape = (S, cfg.n_layers // S, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {n: Sharded.zeros(mesh, shape, spec, dtype) for n in ("k", "v")}


def init_pp_cache(cfg: LlamaConfig, mesh: Mesh, batch: int, max_len: int,
                  dtype=torch.bfloat16) -> dict:
    """Staged KV cache (S, L/S, B, max_len, nkv, hd), stage axis on pp:
    each stage holds exactly its own layers' cache on its device."""
    return _cache_zeros(cfg, mesh, batch, max_len, dtype, ("pp",))


def init_pp_tp_cache(cfg: LlamaConfig, mesh: Mesh, batch: int, max_len: int,
                     dtype=torch.bfloat16) -> dict:
    """Staged KV cache of the pp x tp engine: stages on pp, kv heads on tp."""
    return _cache_zeros(cfg, mesh, batch, max_len, dtype, ("pp", None, None, None, "tp"))


def _staged_forward(embed, final_norm, lm_head, stages, cache: dict, cfg: LlamaConfig,
                    tokens, positions, mesh: Mesh) -> torch.Tensor:
    """The fill-drain schedule of one block of tokens: stage s runs its
    layers (``stages[s][j]``: shard j's per-layer weights) over its cache
    blocks, each layer ``models.llama.tp_block`` over the stage's tp group
    with the full-mask ``_attend``, then the activation hops to stage s + 1.
    Returns the logits (B, T, V) f32 on ``tokens``' device."""
    S, tp = mesh.shape["pp"], mesh.shape.get("tp", 1)
    coord = (lambda s, j: (s, j)) if "tp" in mesh.shape else (lambda s, j: (s,))
    B, max_len = tokens.shape[0], cache["k"].shape[3]
    frontier = torch.amax(positions, dim=1)
    x = embed[tokens.long()]
    for s in range(S):
        group = [coord(s, j) for j in range(tp)]
        dev = {c: mesh.device(c) for c in group}
        pos = {c: positions.to(dev[c]) for c in group}
        masks = {c: torch.arange(max_len, device=dev[c])[None, :] <= frontier.to(dev[c])[:, None]
                 for c in group}
        rope = {c: rope_tables(pos[c], cfg.head_dim, cfg.rope_theta) for c in group}
        slots = {c: (torch.arange(B, device=dev[c])[:, None], pos[c].long()) for c in group}
        kcs = {c: cache["k"].local(c)[0] for c in group}
        vcs = {c: cache["v"].local(c)[0] for c in group}
        xs = {c: x.to(dev[c]) for c in group}  # the hop onto this stage's devices

        def attend(q, k, v, li):
            out = {}
            for c in group:
                with on_device(dev[c]):
                    out[c] = _attend(q[c], kcs[c][li], vcs[c][li], pos[c], masks[c])
            return out

        for li in range(len(stages[s][0])):
            xs = tp_block(xs, {c: stages[s][j][li] for j, c in enumerate(group)}, cfg, [group],
                          dev, rope, {c: (kcs[c][li], vcs[c][li]) for c in group}, slots,
                          lambda q, k, v, li=li: attend(q, k, v, li))
        x = xs[group[0]]
    y = rms_norm(x.to(tokens.device), final_norm, cfg.norm_eps)
    return _qe(y, lm_head)


@watch_compiles("pipeline.llama_pp_forward_cached")
@torch.no_grad()
def llama_pp_forward_cached(params: dict, staged_cache: dict, cfg: LlamaConfig,
                            tokens: torch.Tensor, positions: torch.Tensor,
                            mesh: Mesh) -> tuple[torch.Tensor, dict]:
    """KV-cache-aware pipelined forward (prefill block or T = 1 step) over a
    1-D pp mesh; ``staged_cache`` is ``init_pp_cache``'s, written in place.
    Returns (logits (B, T, V), the cache)."""
    S = mesh.shape["pp"]
    staged = stage_params(params["layers"], S)
    stages = [[unstack_layers(_tree_map(lambda a, s=s: a[s].to(mesh.device((s,))), staged))]
              for s in range(S)]
    logits = _staged_forward(params["embed"], params["final_norm"], params["lm_head"], stages,
                             staged_cache, cfg, tokens, positions, mesh)
    return logits, staged_cache


def staged_layers(staged: dict, mesh: Mesh) -> list:
    """``stages[s][j]``: shard (s, j)'s per-layer weights, from a tree of
    ``Sharded`` leaves laid out by ``staged_tp_shardings``."""
    S, tp = mesh.shape["pp"], mesh.shape["tp"]
    return [[unstack_layers(_tree_map(lambda a, c=(s, j): a.local(c)[0], staged))
             for j in range(tp)] for s in range(S)]


@torch.no_grad()
def pp_tp_forward_cached(params: dict, staged_cache: dict, cfg: LlamaConfig,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         mesh: Mesh) -> tuple[torch.Tensor, dict]:
    """The pp x tp cached forward, the servable layout of
    ``serve.pp_engine``: ``params`` = {"embed", "staged" (``Sharded`` leaves
    by ``staged_tp_shardings``, or ``staged_layers``' lists), "final_norm",
    "lm_head"}, the head tensors on the mesh's first device; ``staged_cache``
    ``init_pp_tp_cache``'s, written in place. Dense models only."""
    if cfg.n_experts:
        raise ValueError("pp×tp serving path is dense-model only (70B planner)")
    stages = params["staged"]
    if isinstance(stages, dict):
        stages = staged_layers(stages, mesh)
    logits = _staged_forward(params["embed"], params["final_norm"], params["lm_head"], stages,
                             staged_cache, cfg, tokens, positions, mesh)
    return logits, staged_cache
