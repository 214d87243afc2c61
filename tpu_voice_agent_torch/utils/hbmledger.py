"""The live device-memory ledger: the static plan reconciled against the
engine's tensors and the card's allocator.

Port of ``tpu_voice_agent/utils/hbmledger.py`` (JAX's ``hbm.`` names; the
card's memory is HBM too):

- ``engine_hbm_plan(engine)``: shape arithmetic only, JAX's as it stands:
  weight bytes from the config's matmul dimensions (int8-aware), KV bytes
  from the engine's real layout (the paged pool at its tier,
  ``ops.kvquant.kv_block_bytes``, or the dense slot lines and the cached
  prefix), a prefill-activation workspace estimate.
- ``measure_hbm(engine)``: the bytes of the engine's own parameter and KV
  tensors (``nbytes`` summed over the tree, the pool and its scale planes;
  the per-layer views of the stacked weights count once). On the card it
  adds the caching allocator's view: ``live_bytes`` the bytes its tensors
  hold (``torch.cuda.memory_stats`` ``allocated_bytes.all.current``),
  ``bytes_in_use`` what it holds on the device
  (``reserved_bytes.all.current``), ``workspace_bytes`` the reserve not
  held by a live tensor (JAX's workspace: what the device holds beyond the
  arrays the program knows), ``other_bytes`` live tensors that are neither
  this engine's weights nor its KV, and ``bytes_limit`` / ``free_bytes``
  from ``torch.cuda.mem_get_info``. On the CPU it reports the tensors it
  knows and zero workspace, as JAX does.
- ``hbm_report`` (plan, measured, drift) and ``record_hbm_gauges``
  (throttled by ``HBM_LEDGER_S``, default 1 s; the batcher calls it every
  chunk): the gauges ``hbm.{weights,kv_pool,workspace,free,live}_bytes``,
  ``hbm.plan_total_bytes`` and ``hbm.plan_drift`` = (measured - planned) /
  planned over weights and KV; a drift past ``HBM_DRIFT_WARN`` (default
  0.15) counts ``hbm.drift_events``: a leaked cache, a double-resident
  prefix, an unplanned drafter.
"""

from __future__ import annotations

import os
import time

import torch

from ..parallel.mesh import Sharded
from .tracing import get_metrics


def _tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list / tuple."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, Sharded):  # a mesh engine's per-device blocks
        return tree.nbytes()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def engine_hbm_plan(engine) -> dict:
    """Static byte plan of a dense or paged ``DecodeEngine`` from config
    arithmetic alone (``models.llama.init_params``' leaf shapes: stacked-layer
    matmuls, bf16 norms, MoE experts, int8 weight-only quantization with f32
    per-out-channel scales)."""
    cfg = engine.cfg
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    nq, nkv, L, V = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.vocab_size
    E = getattr(cfg, "n_experts", 0)
    wbytes = 1 if getattr(engine, "quant", None) == "int8" else 2

    attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    ffn = (E * 3 * d * f) if E > 0 else (3 * d * f)
    router = (d * E) if E > 0 else 0
    matmul = L * (attn + ffn) + V * d  # lm_head; embed stays bf16 below
    weights = (matmul + L * router) * wbytes
    if wbytes == 1:
        # f32 per-out-channel scales for every quantized matmul
        out_ch = L * (nq * hd + 2 * nkv * hd + d
                      + ((E * 2 * f + E * d) if E > 0 else (2 * f + d))
                      + (E if E > 0 else 0)) + V
        weights += out_ch * 4
    weights += V * d * 2  # embed: bf16 (a gather, unquantized)
    weights += (L * 2 * d + d) * 2  # attn/mlp norms + final norm, bf16

    pool_blocks = getattr(getattr(engine, "allocator", None), "n_blocks", None)
    if pool_blocks is not None:
        # bytes a block from the stored dtype and the scale planes
        # (ops.kvquant is the one source), so the drift stays ~0 under
        # int8 / int4
        from ..ops.kvquant import kv_block_bytes

        kv = pool_blocks * kv_block_bytes(
            L, engine.block_size, nkv, hd, getattr(engine, "kv_quant", None))
    else:
        kv = 2 * L * engine.batch_slots * engine.max_len * nkv * hd * 2
        P = len(getattr(engine, "prefix_ids", ()) or ())
        if P and getattr(engine, "prefix_kv", None):
            kv += 2 * L * P * nkv * hd * 2  # the dense prefix KV lives beside

    bucket = max(engine.prefill_buckets) if engine.prefill_buckets else engine.max_len
    workspace = bucket * max(d, f) * 4 * 4  # prefill activation high-water

    return {"weights_bytes": int(weights), "kv_pool_bytes": int(kv),
            "workspace_bytes": int(workspace),
            "total_bytes": int(weights + kv + workspace)}


def measure_hbm(engine) -> dict:
    """Measured bytes: the engine's weights and KV, and on the card the
    caching allocator's counts and the device's free bytes."""
    weights = _tree_bytes(getattr(engine, "params", None))
    if getattr(engine, "allocator", None) is not None:
        kv = _tree_bytes([engine.k_pool, engine.v_pool])
        # quantized pools carry their bf16 scale planes beside the values
        kv += _tree_bytes([getattr(engine, "k_scale", None), getattr(engine, "v_scale", None)])
    else:
        kv = _tree_bytes(getattr(engine, "cache", None))
        kv += _tree_bytes(getattr(engine, "prefix_kv", None))

    out = {"weights_bytes": weights, "kv_pool_bytes": kv}
    dev = getattr(engine, "device", None)
    if dev is not None and dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        live = int(stats.get("allocated_bytes.all.current", 0))
        in_use = int(stats.get("reserved_bytes.all.current", 0))
        free, limit = torch.cuda.mem_get_info(dev)
        out.update(live_bytes=live, other_bytes=max(0, live - weights - kv),
                   bytes_in_use=in_use, workspace_bytes=max(0, in_use - live),
                   bytes_limit=int(limit), free_bytes=int(free))
    else:
        out["workspace_bytes"] = 0
    return out


def hbm_report(engine) -> dict:
    """Plan vs measured vs drift: the /health and report body."""
    plan = engine_hbm_plan(engine)
    meas = measure_hbm(engine)
    accounted_plan = plan["weights_bytes"] + plan["kv_pool_bytes"]
    accounted_meas = meas["weights_bytes"] + meas["kv_pool_bytes"]
    drift = ((accounted_meas - accounted_plan) / accounted_plan
             if accounted_plan > 0 else 0.0)
    return {"plan": plan, "measured": meas, "drift": round(drift, 4),
            "t_s": round(time.time(), 3)}


_last_export_s = 0.0


def record_hbm_gauges(engine, min_interval_s: float | None = None,
                      force: bool = False) -> dict | None:
    """Throttled gauge export: at most once per ``HBM_LEDGER_S`` seconds
    (the batcher calls it every chunk). Returns the report, or None when
    throttled."""
    global _last_export_s
    if min_interval_s is None:
        min_interval_s = float(os.environ.get("HBM_LEDGER_S", "1.0"))
    now = time.monotonic()
    if not force and now - _last_export_s < min_interval_s:
        return None
    _last_export_s = now

    rep = hbm_report(engine)
    meas, plan = rep["measured"], rep["plan"]
    m = get_metrics()
    m.set_gauge("hbm.weights_bytes", float(meas["weights_bytes"]))
    m.set_gauge("hbm.kv_pool_bytes", float(meas["kv_pool_bytes"]))
    m.set_gauge("hbm.workspace_bytes", float(meas.get("workspace_bytes", 0)))
    if "free_bytes" in meas:
        m.set_gauge("hbm.free_bytes", float(meas["free_bytes"]))
    if "live_bytes" in meas:
        m.set_gauge("hbm.live_bytes", float(meas["live_bytes"]))
    m.set_gauge("hbm.plan_total_bytes", float(plan["total_bytes"]))
    m.set_gauge("hbm.plan_drift", rep["drift"])
    if abs(rep["drift"]) > float(os.environ.get("HBM_DRIFT_WARN", "0.15")):
        m.inc("hbm.drift_events")
    return rep
