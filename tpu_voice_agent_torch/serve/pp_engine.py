"""The pp x tp decode engine: the layer stack pipelined over ``pp``, each
stage tensor-parallel over ``tp``.

Port of ``tpu_voice_agent/serve/pp_engine.py``. It speaks the surface the
continuous batcher drives (``prefill_slot`` / ``decode_chunk`` /
``release_slot``), so the scheduler and the brain service run unchanged on
top, through ``parallel.pipeline.pp_tp_forward_cached``:

- the staged KV cache (S, L/S, B, max_len, nkv, hd) lives as per-device
  blocks, stages over pp and kv heads over tp: each device holds its
  stage's layers x its heads;
- an admission prefills ONE batch row, through views of that row in every
  block; with a cached prefix its staged KV is copied in first and only the
  suffix runs (``pp_prefill_row_with_prefix``);
- ``decode_chunk`` is ``DecodeEngine``'s: the shared ``decode_loop`` with
  this layout's ``_decode_step`` (the pipeline forward) injected, so the
  grammar FSM, byte budgets, fast-forward and stop logic are the same code.
  The greedy constrained tail launches K4 on the mesh's first card, where
  the logits are, as JAX runs its tail unsharded on this layout;
- embed, final norm and lm_head live on the mesh's first device (JAX
  replicates them).

Attention inside a stage is the full-mask plain attention over the staged
cache, as JAX runs XLA there: no frontier-read kernel serves the staged
layout, so a (B, 1 + W) fast-forward step reads the same cache as a
(B, 1) one. JAX defaults ff to 0 on this backend
(``services/brain.py``).
"""

from __future__ import annotations

import torch

from ..models.llama import PRESETS, LlamaConfig, init_params, quantize_leaf, stack_layers
from ..parallel.mesh import Sharded, place, place_tree
from ..parallel.pipeline import (
    init_pp_tp_cache,
    pp_tp_forward_cached,
    stage_params,
    staged_layers,
    staged_tp_shardings,
)
from ..utils.compilewatch import watch_compiles
from .engine import DecodeEngine


_decode_forward = watch_compiles("pipeline.llama_pp_tp_forward_cached")(pp_tp_forward_cached)


def _row(cache: dict, slot: int) -> dict:
    """Views of batch row ``slot`` in every block of a staged cache."""
    return {n: Sharded(c.mesh, c.spec, c.shape[:2] + (1,) + c.shape[3:],
                       {co: t[:, :, slot:slot + 1] for co, t in c.shards.items()})
            for n, c in cache.items()}


@watch_compiles("pp_engine.pp_prefill_row")
def pp_prefill_row(params, cache, cfg: LlamaConfig, tokens, positions, slot: int, mesh):
    """Admission prefill for ONE batch row of the staged cache (axis 2),
    written in place. Returns (logits, cache)."""
    logits, _ = pp_tp_forward_cached(params, _row(cache, slot), cfg, tokens, positions, mesh)
    return logits, cache


@watch_compiles("pp_engine.pp_prefill_row_with_prefix")
def pp_prefill_row_with_prefix(params, cache, cfg: LlamaConfig, prefix_k, prefix_v, tokens,
                               positions, slot: int, mesh):
    """Admission prefill reusing the staged shared-prefix KV ((S, L/S, 1, P,
    nkv, hd)): copy it into the slot's row, then run the forward over ONLY
    the user suffix. Returns (logits, cache)."""
    row = _row(cache, slot)
    for name, pre in (("k", prefix_k), ("v", prefix_v)):
        for co, t in row[name].shards.items():
            t[:, :, :, :pre.shape[3]] = pre.local(co)
    logits, _ = pp_tp_forward_cached(params, row, cfg, tokens, positions, mesh)
    return logits, cache


class PPDecodeEngine(DecodeEngine):
    """Grammar-constrained decode over a (pp, tp) mesh
    (``parallel.pipeline.pp_tp_mesh``), served through the continuous
    batcher."""

    def __init__(
        self,
        preset: str = "test-tiny",
        cfg: LlamaConfig | None = None,
        mesh=None,  # REQUIRED: a Mesh with ("pp", "tp") axes
        seed: int = 0,
        max_len: int = 2048,
        batch_slots: int = 1,
        prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048),
        tokenizer=None,
        fsm=None,
        init_weights: bool = True,
        quant: str | None = None,  # None | "int8"
        fast_forward: int = 0,
        spec=None,  # refused: the staged cache has no rollback
        quality_lanes: bool | None = None,
    ):
        if spec is not None and getattr(spec, "k", 0):
            raise ValueError(
                "speculative decoding is not supported on the pp layout: "
                "the staged pipeline cache has no per-position rollback "
                "story; unset SPEC_ENABLE or serve speculation on the "
                "dense or paged engines")
        if mesh is None or "pp" not in mesh.shape:
            raise ValueError("PPDecodeEngine needs a mesh with a 'pp' axis "
                             "(parallel.pipeline.pp_tp_mesh)")
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.pmesh = mesh
        self.pp = mesh.shape["pp"]
        self.tp = mesh.shape.get("tp", 1)
        c = cfg or PRESETS[preset]
        if c.n_layers % self.pp:
            raise ValueError(f"n_layers ({c.n_layers}) must divide pp ({self.pp})")
        for name, n in (("n_heads", c.n_heads), ("n_kv_heads", c.n_kv_heads),
                        ("ffn_dim", c.ffn_dim)):
            if n % self.tp:
                raise ValueError(f"{name} ({n}) must divide tp ({self.tp})")
        if c.n_experts:
            raise ValueError("PPDecodeEngine is dense-model only (70B planner)")
        # the parent builds the tokenizer, FSM, tables and byte accounting
        # on the mesh's first device; this layout owns its sharding (and
        # quantizes per leaf in load_params)
        super().__init__(preset=preset, cfg=cfg, seed=seed, max_len=max_len,
                         batch_slots=batch_slots, prefill_buckets=prefill_buckets,
                         tokenizer=tokenizer, fsm=fsm, init_weights=False,
                         fast_forward=fast_forward, device=mesh.devices.flat[0],
                         quality_lanes=quality_lanes)
        self.quant = quant
        if init_weights:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.load_params(init_params(self.cfg, gen, device=self.device))

    def _init_kv_cache(self):
        return init_pp_tp_cache(self.cfg, self.pmesh, self.batch_slots, self.max_len)

    # ------------------------------------------------------------ weights

    def load_params(self, params) -> None:
        """Install a stacked llama param tree: the layers staged onto pp and
        split over tp (``staged_tp_shardings``), the head tensors on the
        mesh's first device. With ``quant="int8"`` each weight leaf is
        quantized whole and its q / s placed at once, so the largest
        transient is one leaf and its int8 copy."""
        if "staged" in params:  # already staged
            self.params = params
        else:
            mesh, dev = self.pmesh, self.device
            already_q = isinstance(params.get("lm_head"), dict)
            quantizing = self.quant == "int8" and not already_q
            staged_host = stage_params(stack_layers(params["layers"]), self.pp)
            if quantizing:
                skeleton = {k: ({"q": 0, "s": 0} if k.startswith("w") else 0)
                            for k in staged_host}
                plan = staged_tp_shardings(mesh, skeleton)
                staged = {}
                for name, leaf in staged_host.items():
                    if name.startswith("w"):
                        q = quantize_leaf(leaf.to(dev))
                        staged[name] = {k: place(q[k], mesh, plan[name][k]) for k in q}
                    else:
                        staged[name] = place(leaf, mesh, plan[name])
                lm_head = quantize_leaf(params["lm_head"].to(dev))
            else:
                staged = place_tree(staged_host, mesh, staged_tp_shardings(mesh, staged_host))
                lm_head = params["lm_head"]
            self.params = {
                "embed": params["embed"].to(dev),
                "staged": staged,
                "final_norm": params["final_norm"].to(dev),
                "lm_head": ({k: v.to(dev) for k, v in lm_head.items()}
                            if isinstance(lm_head, dict) else lm_head.to(dev)),
            }
        # the forward's per-shard per-layer views, built once
        self._fwd_params = {**self.params, "staged": staged_layers(self.params["staged"],
                                                                   self.pmesh)}

    @classmethod
    def from_hf(cls, model_dir: str, mesh=None, max_len: int = 2048, batch_slots: int = 1,
                prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048),
                dtype=torch.bfloat16, quant: str | None = None, fast_forward: int = 0,
                spec=None) -> "PPDecodeEngine":
        """Serve an HF checkpoint directory through the pp x tp pipeline
        (``DecodeEngine.from_hf``'s reader; the weights are read at
        ``dtype`` onto the mesh's first device and staged leaf by leaf)."""
        import os
        from dataclasses import replace

        from ..ckpt.hf_import import (
            llama_config_from_hf,
            llama_from_hf_state,
            llama_hf_check,
            safetensors_shapes,
        )
        from .engine import checkpoint_tokenizer

        cfg = replace(llama_config_from_hf(os.path.join(model_dir, "config.json")),
                      max_seq_len=max_len)
        llama_hf_check(safetensors_shapes(model_dir), cfg)
        eng = cls(cfg=cfg, mesh=mesh, max_len=max_len, batch_slots=batch_slots,
                  prefill_buckets=prefill_buckets, tokenizer=checkpoint_tokenizer(model_dir),
                  init_weights=False, quant=quant, fast_forward=fast_forward, spec=spec)
        eng.load_params(llama_from_hf_state(model_dir, cfg, dtype=dtype, device=eng.device))
        return eng

    # ------------------------------------------------------------ prefix

    def _compute_prefix_kv(self, tokens, positions, P: int, bucket: int) -> dict:
        """Prefix KV in the staged layout (S, L/S, 1, P, nkv, hd): one
        pipeline prefill into a scratch one-row staged cache."""
        scratch = init_pp_tp_cache(self.cfg, self.pmesh, 1, bucket)
        pp_tp_forward_cached(self._fwd_params, scratch, self.cfg, tokens, positions, self.pmesh)
        return {n: Sharded(c.mesh, c.spec, c.shape[:3] + (P,) + c.shape[4:],
                           {co: t[:, :, :, :P].clone() for co, t in c.shards.items()})
                for n, c in scratch.items()}

    # ------------------------------------------------------------ engine surface

    def _prefill_suffix(self, tokens, positions, slot: int, P: int, bucket: int, n: int):
        logits, _ = pp_prefill_row_with_prefix(
            self._fwd_params, self.cache, self.cfg, self.prefix_kv["k"], self.prefix_kv["v"],
            tokens, positions, slot, self.pmesh)
        return logits

    def _prefill_full(self, tokens, positions, slot: int, bucket: int, n: int):
        logits, _ = pp_prefill_row(self._fwd_params, self.cache, self.cfg, tokens, positions,
                                   slot, self.pmesh)
        return logits

    def _decode_step(self, tokens, positions, active):
        """One pipelined decode forward (idle rows write slot 0 of their own
        line). Returns logits (B, T, V)."""
        self._fence()
        return _decode_forward(self._fwd_params, self.cache, self.cfg, tokens, positions,
                               self.pmesh)[0]

    def generate(self, *a, **kw):
        raise ValueError(
            "PPDecodeEngine serves through the continuous batcher "
            "(serve.scheduler.ContinuousBatcher); use generate_many")

    def generate_stepwise(self, *a, **kw):
        raise ValueError("see generate(): pp engines serve via the batcher")
