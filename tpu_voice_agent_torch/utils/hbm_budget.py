"""Device-memory sizing for the pp×tp flagship config.

Port of ``tpu_voice_agent/utils/hbm_budget.py``: ``HBMBreakdown``,
``pp_tp_hbm_per_chip`` and ``flagship_70b_breakdown`` as they stand, on the
port's ``PRESETS``, so the byte counts equal the JAX module's. The capacity a
breakdown is held against is a parameter: ``V5E_HBM_PER_CHIP`` (16 GiB, the
JAX default, kept for parity) or ``card_bytes()`` on the card
(``torch.cuda.get_device_properties(0).total_memory``, 80 GB on an H100).
Its consumer, the pipeline-parallel engine, is not ported yet (the
parallelism part of ROADMAP.md Queue 1 item 8; checkpoint import is served).

Accounting mirrors the pp×tp engine's placement:
- staged layer matmuls: int8 {"q","s"} (1 byte + f32 per-out-channel
  scales), layers split over pp, every matmul split over tp
- embed: replicated bf16 (a gather; kept full precision)
- lm_head: int8, replicated (every chip holds the head)
- staged KV cache: (L/pp, slots, max_len, nkv/tp, hd) k+v bf16 per chip
- norms/rope/byte tables: noise (< 10 MB), folded into the margin
"""

from __future__ import annotations

from dataclasses import dataclass

V5E_HBM_PER_CHIP = 16 * 2**30  # bytes
# fraction of device memory usable for steady-state buffers: workspace for
# fusions and collectives, padded layouts; 90% is the conventional
# planning ceiling
USABLE_FRACTION = 0.90


def card_bytes(device: int = 0) -> int:
    """The card's memory in bytes: the capacity to hold a breakdown against
    on the card (needs a CUDA device)."""
    import torch

    return int(torch.cuda.get_device_properties(device).total_memory)


@dataclass(frozen=True)
class HBMBreakdown:
    layer_weights: int  # per chip, bytes
    scales: int
    embed: int
    lm_head: int
    kv_cache: int
    activations: int

    @property
    def total(self) -> int:
        return (self.layer_weights + self.scales + self.embed + self.lm_head
                + self.kv_cache + self.activations)

    def fraction_of(self, hbm_per_chip: int = V5E_HBM_PER_CHIP) -> float:
        return self.total / hbm_per_chip

    def row(self) -> str:
        gb = 2**30
        return (f"weights {self.layer_weights / gb:.2f} + scales "
                f"{self.scales / gb:.2f} + embed {self.embed / gb:.2f} + "
                f"lm_head {self.lm_head / gb:.2f} + kv {self.kv_cache / gb:.2f} "
                f"+ act {self.activations / gb:.2f} = {self.total / gb:.2f} GiB/chip")


def pp_tp_hbm_per_chip(
    cfg,
    pp: int,
    tp: int,
    *,
    batch_slots: int,
    max_len: int,
    quant: str | None = "int8",
    prefill_bucket: int = 2048,
) -> HBMBreakdown:
    """Per-chip steady-state bytes of the pp×tp engine at this config."""
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    nq, nkv, L, V = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.vocab_size
    wbytes = 1 if quant == "int8" else 2

    per_layer_matmul = d * nq * hd + 2 * d * nkv * hd + nq * hd * d + 3 * d * f
    per_layer_out_channels = nq * hd + 2 * nkv * hd + d + 2 * f + d
    layers_per_chip = L // pp
    layer_weights = layers_per_chip * per_layer_matmul * wbytes // tp
    scales = (layers_per_chip * per_layer_out_channels * 4 // tp
              if quant == "int8" else 0)
    norms = layers_per_chip * 2 * d * 2  # bf16, replicated within stage

    embed = V * d * 2  # bf16, replicated
    lm_head = V * d * wbytes + (V * 4 if quant == "int8" else 0)  # replicated

    kv_cache = 2 * layers_per_chip * batch_slots * max_len * (nkv // max(tp, 1) or 1) * hd * 2

    # activation high-water mark: the per-slot prefill block dominates
    # (B=1, T=prefill_bucket): x + q/k/v + gate/up at f32 outputs
    act = prefill_bucket * max(d, f) * 4 * 4

    return HBMBreakdown(layer_weights=layer_weights + norms, scales=scales,
                        embed=embed, lm_head=lm_head, kv_cache=kv_cache,
                        activations=act)


def flagship_70b_breakdown(batch_slots: int = 32, max_len: int = 2048,
                           pp: int = 2, tp: int = 4) -> HBMBreakdown:
    """The flagship config: llama3-70b at the real Llama-3 vocab, int8,
    32-session continuous batching over pp×tp = 8 chips."""
    from dataclasses import replace

    from ..models.llama import PRESETS

    cfg = replace(PRESETS["llama3-70b"], vocab_size=128_256)
    return pp_tp_hbm_per_chip(cfg, pp, tp, batch_slots=batch_slots,
                              max_len=max_len, quant="int8")
