"""The kernels over a dp x tp mesh: one launch per shard, on its own card.

Port of JAX's ``sharded_*`` wrappers (``ops/flash_attention.py:178``,
``ops/decode_attention.py:232``, ``:264``, ``:553``, ``ops/grammar_mask.py:115``,
``:278``, ``:342``). Attention is batch-local and head-local and the grammar
tail row-local, so each device runs the existing kernel (K1, K2, K3, K5, K4,
K11) on its (B / dp, heads / tp) block with no collective. The split follows
JAX's gating: heads split over tp only when tp divides both nq and nkv, the
batch over dp only when dp divides it (a B = 1 admission on a dp > 1 mesh
runs replicated, every dp group computing the same rows); grammar tables
are replicated. ``mesh=None`` falls through to the plain wrapper.

Operands may be tensors, which are laid out here (a copy a block), or
``parallel.mesh.Sharded`` tensors already in the kernel's layout (the
meshed forward's per-shard q and cache, the engine's replicated tables),
which are used in place; a ``Sharded`` in another layout raises. With a
mesh the result is a ``Sharded`` in the kernel's layout (``.full()``
gathers it). Each launch runs with its shard's card current. Every launch
goes through the plain wrapper, so it launches the kernel on a CUDA shard
(raising on what the kernel does not take) and counts in that kernel's
``launches``; the plain versions run only on CPU shards.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import Sharded, as_sharded, on_device
from .decode_attention import decode_attention, decode_attention_layer, decode_block_attention_layer
from .flash_attention import flash_attention
from .grammar_mask import masked_argmax, masked_argmax_advance, masked_argmax_block


def _axes(mesh, B: int, nq: int | None = None, nkv: int | None = None):
    """(dp axis or None, tp axis or None) by JAX's gating."""
    tp, dp = mesh.shape.get("tp", 1), mesh.shape.get("dp", 1)
    tp_ax = ("tp" if nq is not None and tp > 1 and nq % tp == 0 and nkv % tp == 0
             else None)
    dp_ax = "dp" if dp > 1 and B % dp == 0 else None
    return dp_ax, tp_ax


def _per_shard(mesh, fn, operands, out_specs, **kw):
    """Lay ``operands`` ((value, spec) pairs; spec None passes the value as
    it is) out over ``mesh`` and run ``fn`` on each device's blocks."""
    placed = [(as_sharded(x, mesh, s) if s is not None else x) for x, s in operands]
    outs: dict = {}
    for c in mesh.coords():
        with on_device(mesh.device(c)):
            outs[c] = fn(*[p.local(c) if isinstance(p, Sharded) else p for p in placed], **kw)
    if isinstance(out_specs, list):
        return tuple(Sharded.from_locals(mesh, s, {c: o[i] for c, o in outs.items()})
                     for i, s in enumerate(out_specs))
    return Sharded.from_locals(mesh, out_specs, outs)


def _i32(x):
    return x if isinstance(x, Sharded) else x.to(torch.int32)


def sharded_flash_attention(mesh, q, k, v, **kw):
    """K1 per shard: q (B, T, nq, hd), k / v (B, S, nkv, hd); with
    ``return_lse`` the (B, T, nq) lse in its own layout too."""
    if mesh is None:
        return flash_attention(q, k, v, **kw)
    dp_ax, tp_ax = _axes(mesh, q.shape[0], q.shape[2], k.shape[2])
    spec = (dp_ax, None, tp_ax, None)
    outs = [spec, (dp_ax, None, tp_ax)] if kw.get("return_lse") else spec
    return _per_shard(mesh, flash_attention, [(q, spec), (k, spec), (v, spec)], outs, **kw)


def sharded_decode_attention_layer(mesh, q, k_cache, v_cache, kv_len, layer: int, **kw):
    """K2 per shard: q (B, nq, hd) against the stacked (L, B, S, nkv, hd) cache."""
    if mesh is None:
        return decode_attention_layer(q, k_cache, v_cache, kv_len, layer, **kw)
    dp_ax, tp_ax = _axes(mesh, q.shape[0], q.shape[1], k_cache.shape[3])
    qs, cs = (dp_ax, tp_ax, None), (None, dp_ax, None, tp_ax, None)
    return _per_shard(mesh, decode_attention_layer,
                      [(q, qs), (k_cache, cs), (v_cache, cs), (_i32(kv_len), (dp_ax,)),
                       (layer, None)], qs, **kw)


def sharded_decode_attention(mesh, q, k_cache, v_cache, kv_len, **kw):
    """K5 per shard: q (B, nq, hd) against a flat (B, S, nkv, hd) cache."""
    if mesh is None:
        return decode_attention(q, k_cache, v_cache, kv_len, **kw)
    dp_ax, tp_ax = _axes(mesh, q.shape[0], q.shape[1], k_cache.shape[2])
    qs, cs = (dp_ax, tp_ax, None), (dp_ax, None, tp_ax, None)
    return _per_shard(mesh, decode_attention,
                      [(q, qs), (k_cache, cs), (v_cache, cs), (_i32(kv_len), (dp_ax,))], qs, **kw)


def sharded_decode_block_attention_layer(mesh, q, k_cache, v_cache, q_positions, layer: int,
                                         **kw):
    """K3 per shard: a (B, T, nq, hd) block against the stacked cache."""
    if mesh is None:
        return decode_block_attention_layer(q, k_cache, v_cache, q_positions, layer, **kw)
    dp_ax, tp_ax = _axes(mesh, q.shape[0], q.shape[2], k_cache.shape[3])
    qs, cs = (dp_ax, None, tp_ax, None), (None, dp_ax, None, tp_ax, None)
    return _per_shard(mesh, decode_block_attention_layer,
                      [(q, qs), (k_cache, cs), (v_cache, cs),
                       (_i32(q_positions), (dp_ax, None)), (layer, None)], qs, **kw)


def sharded_masked_argmax(mesh, logits, fsm_state, mask_table):
    """K11 per shard: rows over dp, the mask table replicated."""
    if mesh is None:
        return masked_argmax(logits, fsm_state, mask_table)
    dp_ax, _ = _axes(mesh, logits.shape[0])
    return _per_shard(mesh, masked_argmax,
                      [(logits, (dp_ax, None)), (fsm_state, (dp_ax,)),
                       (mask_table, (None, None))], (dp_ax,))


def sharded_masked_argmax_advance(mesh, logits, fsm_state, mask_table, table, col_id):
    """K4 per shard: rows over dp, the FSM tables replicated. Returns
    (tok, next_state)."""
    if mesh is None:
        return masked_argmax_advance(logits, fsm_state, mask_table, table, col_id)
    dp_ax, _ = _axes(mesh, logits.shape[0])
    return _per_shard(mesh, masked_argmax_advance,
                      [(logits, (dp_ax, None)), (fsm_state, (dp_ax,)),
                       (mask_table, (None, None)), (table, (None, None)), (col_id, (None,))],
                      [(dp_ax,), (dp_ax,)])


def sharded_masked_argmax_block(mesh, logits, fsm_state, mask_table):
    """K11 per shard over a (B, T) verify block: rows over dp."""
    if mesh is None:
        return masked_argmax_block(logits, fsm_state, mask_table)
    dp_ax, _ = _axes(mesh, logits.shape[0])
    return _per_shard(mesh, masked_argmax_block,
                      [(logits, (dp_ax, None, None)), (fsm_state, (dp_ax, None)),
                       (mask_table, (None, None))], (dp_ax, None))
