"""The analytic cost meter: FLOPs and KV bytes from config arithmetic,
reconciled against measured walls into MFU / MBU.

Port of ``tpu_voice_agent/utils/costmodel.py``:

- the analytic model (``CostModel``): FLOPs per prefill token and per
  decode position (the weight matmuls from the config's dimensions, only
  ``top_k`` experts active on an MoE preset, plus the attention score / mix
  over the attended context), KV bytes read and written per position
  (``KV_QUANT``-aware through ``ops.kvquant``'s per-(position, head)
  layout), the speculative verify step's 1 + K positions, and Whisper's
  encoder / decoder cost. Config arithmetic only: nothing reads the device.
- exact conservation: every quantity is a Python ``int``. The batcher
  computes one per-row ledger dict per chunk and folds the same ints into
  the slot's request ledger and the meter's totals, so ``sum(per-request
  ledgers) == engine totals`` holds exactly.
- MFU / MBU (``CostMeter``): a chunk's analytic FLOPs (bytes) over its
  measured wall times the device peak (``device_peak``), EMA-smoothed into
  the ``engine.mfu`` / ``engine.mbu`` / ``engine.mfu_prefill`` gauges.
- per-session attribution (``SessionCostLedger``): the brain folds each
  finished request's ``GenerationResult.cost`` into a per-session LRU that
  ``/debug/costs`` names the top-cost sessions from; tenancy folds the same
  ledgers per tenant class.

Ledger keys (all ints): ``prefill_flops`` (prompt positions computed at
admission), ``prefill_cached_flops`` (what the prefix / radix cache saved:
computed + cached is the cold prompt's cost, exactly), ``decode_flops``
(every decode position computed, rejected drafts included),
``decode_bytes`` (KV read + written for them; the weights stream per
dispatch and are metered engine-side), ``wasted_draft_flops`` (the
rejected-draft share of ``decode_flops``), ``kv_block_us`` (KV blocks held
times the chunk wall: owned + shared blocks on the paged pool, one "block",
the slot's KV line, on the dense engine).

``COST_ENABLE`` (default on) builds the batcher's meter and the STT
engines' lanes; ``COST_SESSIONS`` (256) sizes the session LRU;
``COST_PEAK_TFLOPS`` / ``COST_PEAK_GBPS`` override the device peak.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict

from ..ops.kvquant import KV_QUANT_VBYTES, KV_SCALE_BYTES
from .tracing import get_metrics

LEDGER_KEYS = ("prefill_flops", "prefill_cached_flops", "decode_flops",
               "decode_bytes", "wasted_draft_flops", "kv_block_us")


def zero_ledger() -> dict:
    return {k: 0 for k in LEDGER_KEYS}


def _knob_float(name: str) -> float:
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else 0.0


# ------------------------------------------------------------- byte model

def decode_step_bytes(cfg, batch: int, context_tokens: int, kv_quant: str | None = None,
                      weight_quant: str | None = "int8") -> dict:
    """Modeled bytes ONE decode step moves at (batch, context): the weights
    stream once per step for the whole batch (1 byte a weight under int8,
    else 2); each row reads its attended KV in ``ops.kvquant``'s layout."""
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    nq, nkv, L, V = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.vocab_size
    wbytes = 1 if weight_quant == "int8" else 2
    attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    weights = (L * (attn + 3 * d * f) + V * d) * wbytes
    per_pos_head = hd * KV_QUANT_VBYTES[kv_quant] + KV_SCALE_BYTES[kv_quant]
    kv = int(2 * L * context_tokens * nkv * per_pos_head) * batch
    return {"weights_bytes": int(weights), "kv_read_bytes": int(kv),
            "total_bytes": int(weights + kv)}


def kv_position_bytes(cfg, kv_quant: str | None = None) -> int:
    """Stored KV bytes of ONE token position over all layers (K + V, values
    and scale planes)."""
    per_pos_head = cfg.head_dim * KV_QUANT_VBYTES[kv_quant] + KV_SCALE_BYTES[kv_quant]
    return int(2 * cfg.n_layers * cfg.n_kv_heads * per_pos_head)


# ------------------------------------------------------------- FLOP model

def llm_token_flops(cfg) -> int:
    """Weight-matmul FLOPs of ONE token position, 2 a MAC; on an MoE preset
    only the ``top_k`` experts a token computes, plus the router."""
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    nq, nkv, L, V = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.vocab_size
    E = getattr(cfg, "n_experts", 0)
    attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    if E > 0:
        ffn = getattr(cfg, "top_k", 2) * 3 * d * f + d * E
    else:
        ffn = 3 * d * f
    return int(2 * (L * (attn + ffn) + V * d))


def llm_attn_flops_per_ctx(cfg) -> int:
    """Attention score + value-mix FLOPs per (token, attended position)."""
    return int(4 * cfg.n_heads * cfg.head_dim)


def prefill_flops(cfg, n_tokens: int, ctx_end: int) -> int:
    """FLOPs to compute the LAST ``n_tokens`` prompt positions of a context
    ending at ``ctx_end`` (position p attends p + 1 positions): an exact
    integer sum, so cached + computed partitions the cold cost."""
    if n_tokens <= 0:
        return 0
    start = ctx_end - n_tokens
    attended = (start + 1 + ctx_end) * n_tokens // 2
    return int(n_tokens * llm_token_flops(cfg) + attended * llm_attn_flops_per_ctx(cfg))


def decode_flops(cfg, n_positions: int, ctx: int) -> int:
    """FLOPs of ``n_positions`` decode positions at context ``ctx`` (the
    end-of-chunk frontier, charged to every position of the chunk)."""
    return int(n_positions * (llm_token_flops(cfg) + ctx * llm_attn_flops_per_ctx(cfg)))


def spec_verify_flops(cfg, ctx: int, k: int) -> int:
    """Worst-case cost of ONE speculative verify forward: 1 + K positions."""
    return decode_flops(cfg, 1 + k, ctx)


# ---------------------------------------------------------- Whisper model

def whisper_encoder_flops(cfg, n_frames: int) -> int:
    """Encoder FLOPs for ``n_frames`` mel frames: the two kernel-3 convs
    (the second stride 2), per position QKVO 4 d^2 + FFN 2 d f, 2 a MAC,
    and the self-attention over the T = n_frames // 2 positions."""
    d, f = cfg.d_model, cfg.ffn_dim
    T = max(0, int(n_frames) // 2)
    conv = 2 * (3 * cfg.n_mels * d) * int(n_frames) + 2 * (3 * d * d) * T
    per_pos = 2 * cfg.enc_layers * (4 * d * d + 2 * d * f)
    attn = cfg.enc_layers * 4 * d * T * T
    return int(conv + per_pos * T + attn)


def whisper_decoder_flops(cfg, n_tokens: int, enc_len: int) -> int:
    """Decoder FLOPs for ``n_tokens`` forwards cross-attending ``enc_len``
    encoder positions (self QKVO 4 d^2, cross query / out 2 d^2, FFN
    2 d f, logits V d, 2 a MAC, plus 4 d per encoder position); the short
    self-attention context is ignored."""
    d, f = cfg.d_model, cfg.ffn_dim
    per_tok = 2 * (cfg.dec_layers * (6 * d * d + 2 * d * f) + cfg.vocab_size * d)
    cross = cfg.dec_layers * 4 * d * int(enc_len)
    return int(n_tokens * (per_tok + cross))


# ------------------------------------------------------------ device peak

# (dense bf16 FLOP/s, HBM bytes/s) per card, matched by substring against
# torch.cuda.get_device_name(): NVIDIA's data sheet peaks, not measured
# here. H100 SXM (80 GB HBM3): 989 TFLOP/s bf16, 3.35 TB/s, at its 700 W
# limit; a card set below it runs slower than these.
_PEAK_TABLE = (
    ("H100", (989e12, 3350e9)),
)

# Documented CPU proxy: NOT a hardware claim. A fixed reference point so
# MFU / MBU stay finite and comparable run to run on the CPU (the tests
# gate on ratios and conservation, never on absolute CPU MFU).
_CPU_PROXY = (0.5e12, 50e9)


def device_peak(device=None) -> dict:
    """(peak FLOP/s, peak bytes/s) of ``device`` (a torch device or its
    name; None: the card when one is visible, else the CPU): the
    ``COST_PEAK_TFLOPS`` / ``COST_PEAK_GBPS`` override, else the card's
    entry of ``_PEAK_TABLE``, else on the CPU the documented proxy. A card
    that is not in the table raises: its peak is not the CPU proxy's."""
    import torch

    tflops = _knob_float("COST_PEAK_TFLOPS")
    gbps = _knob_float("COST_PEAK_GBPS")
    if tflops > 0 and gbps > 0:
        return {"flops_per_s": tflops * 1e12, "bytes_per_s": gbps * 1e9,
                "device": "knob", "source": "knob"}
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        peaks, source = next(((p, "table") for key, p in _PEAK_TABLE if key in kind),
                             ((0.0, 0.0), "knob"))
    else:
        kind, peaks, source = "cpu", _CPU_PROXY, "cpu-proxy"
    out = {"flops_per_s": peaks[0], "bytes_per_s": peaks[1], "device": kind, "source": source}
    if tflops > 0:
        out["flops_per_s"], out["source"] = tflops * 1e12, "knob"
    if gbps > 0:
        out["bytes_per_s"], out["source"] = gbps * 1e9, "knob"
    if not (out["flops_per_s"] > 0 and out["bytes_per_s"] > 0):
        raise ValueError(f"no peak for {kind!r} in the cost model's table: set both "
                         "COST_PEAK_TFLOPS and COST_PEAK_GBPS")
    return out


# ---------------------------------------------------------------- per-row

class CostModel:
    """An engine's integer cost constants (the config walk runs once)."""

    def __init__(self, cfg, quant: str | None = None, kv_quant: str | None = None) -> None:
        self.cfg = cfg
        self.token_flops = llm_token_flops(cfg)
        self.attn_flops_per_ctx = llm_attn_flops_per_ctx(cfg)
        self.kv_pos_bytes = kv_position_bytes(cfg, kv_quant)
        self.weights_stream_bytes = decode_step_bytes(
            cfg, batch=1, context_tokens=0, kv_quant=kv_quant,
            weight_quant=quant)["weights_bytes"]

    def prefill_split(self, prompt_len: int, cached: int) -> tuple[int, int]:
        """(computed_flops, cached_flops): an exact partition of the cold
        prompt's prefill cost at ``cached`` reused prefix positions."""
        cached = max(0, min(int(cached), int(prompt_len)))
        full = prefill_flops(self.cfg, prompt_len, prompt_len)
        warm = prefill_flops(self.cfg, cached, cached)
        return full - warm, warm

    def decode_row(self, positions: int, ctx: int) -> tuple[int, int]:
        """(flops, bytes) of ``positions`` decode positions at end-of-chunk
        context ``ctx``: KV read over the context plus the new positions'
        writes."""
        positions, ctx = int(positions), int(ctx)
        fl = positions * (self.token_flops + ctx * self.attn_flops_per_ctx)
        by = positions * self.kv_pos_bytes * (1 + ctx)
        return int(fl), int(by)


# ------------------------------------------------------------ engine side

_REGISTRY_LOCK = threading.Lock()
_METERS: OrderedDict[str, CostMeter] = OrderedDict()
_STT_ENGINES: list = []  # weak references: a test's engine must not outlive it


def register_meter(name: str, meter: CostMeter) -> None:
    with _REGISTRY_LOCK:
        _METERS[name] = meter
        while len(_METERS) > 8:
            _METERS.popitem(last=False)


def register_stt_engine(engine) -> None:
    """Track a SpeechEngine for the voice service's ``/debug/costs``."""
    with _REGISTRY_LOCK:
        _STT_ENGINES.append(weakref.ref(engine))
        _STT_ENGINES[:] = [r for r in _STT_ENGINES if r() is not None][-8:]


def stt_cost_summary() -> dict | None:
    """Summed STT encoder / decoder cost over the live SpeechEngines; None
    when none registered."""
    with _REGISTRY_LOCK:
        engines = [r() for r in _STT_ENGINES]
    engines = [e for e in engines if e is not None]
    if not engines:
        return None
    out = {"engines": len(engines), "encoder_flops": 0, "decoder_flops": 0,
           "encoded_frames": 0, "decoded_tokens": 0}
    for e in engines:
        for k, v in getattr(e, "cost_totals", {}).items():
            out[k] = out.get(k, 0) + v
    return out


def cost_snapshot() -> dict | None:
    """A flight dump's ``costs``: every registered meter's summary by name,
    plus the STT share; None when nothing is metered."""
    with _REGISTRY_LOCK:
        meters = list(_METERS.items())
    out = {name: m.summary() for name, m in meters}
    stt = stt_cost_summary()
    if stt is not None:
        out["stt"] = stt
    return out or None


class CostMeter:
    """Engine-side totals and MFU / MBU. The batcher folds each row's
    per-chunk ledger here with the SAME int dict it adds to the slot;
    engine-level lanes (weights streamed per dispatch, forwards, chunks)
    live in ``self.engine``."""

    MFU_EMA = 0.3  # per-chunk smoothing of the exported gauges

    def __init__(self, engine, name: str = "llm") -> None:
        self.model = CostModel(engine.cfg, quant=getattr(engine, "quant", None),
                               kv_quant=getattr(engine, "kv_quant", None))
        self.peak = device_peak(getattr(engine, "device", None))
        self.totals = zero_ledger()
        self.engine = {"weights_stream_bytes": 0, "fwds": 0, "chunks": 0}
        self.mfu = 0.0
        self.mbu = 0.0
        self.mfu_prefill = 0.0
        self._lock = threading.Lock()
        register_meter(name, self)

    def fold_row(self, row: dict) -> None:
        """Fold one row's chunk ledger into the totals."""
        with self._lock:
            for k, v in row.items():
                self.totals[k] += v

    def fold_prefill(self, computed_flops: int, cached_flops: int, compute_ms: float) -> None:
        with self._lock:
            self.totals["prefill_flops"] += int(computed_flops)
            self.totals["prefill_cached_flops"] += int(cached_flops)
        if compute_ms > 0 and computed_flops > 0:
            mfu = computed_flops / (compute_ms / 1e3 * self.peak["flops_per_s"])
            self.mfu_prefill += self.MFU_EMA * (mfu - self.mfu_prefill)
            get_metrics().set_gauge("engine.mfu_prefill", self.mfu_prefill)

    def chunk(self, flops: int, kv_bytes: int, fwds: int, wall_s: float) -> None:
        """One chunk's analytic work against its measured wall: the
        EMA'd MFU / MBU gauges and the ``cost.*`` counters."""
        wbytes = int(fwds) * self.model.weights_stream_bytes
        with self._lock:
            self.engine["weights_stream_bytes"] += wbytes
            self.engine["fwds"] += int(fwds)
            self.engine["chunks"] += 1
        m = get_metrics()
        if flops > 0:
            m.inc("cost.decode_flops", float(flops))
        if kv_bytes > 0:
            m.inc("cost.decode_bytes", float(kv_bytes))
        if wall_s > 0:
            a = self.MFU_EMA
            mfu = flops / (wall_s * self.peak["flops_per_s"])
            mbu = (kv_bytes + wbytes) / (wall_s * self.peak["bytes_per_s"])
            self.mfu += a * (mfu - self.mfu)
            self.mbu += a * (mbu - self.mbu)
            m.set_gauge("engine.mfu", self.mfu)
            m.set_gauge("engine.mbu", self.mbu)

    def summary(self) -> dict:
        with self._lock:
            totals = dict(self.totals)
            engine = dict(self.engine)
        mdl = self.model
        return {
            "totals": totals,
            "engine": engine,
            "mfu": round(self.mfu, 6),
            "mbu": round(self.mbu, 6),
            "mfu_prefill": round(self.mfu_prefill, 6),
            "peak": self.peak,
            "model": {"token_flops": mdl.token_flops,
                      "attn_flops_per_ctx": mdl.attn_flops_per_ctx,
                      "kv_pos_bytes": mdl.kv_pos_bytes,
                      "weights_stream_bytes": mdl.weights_stream_bytes},
        }


def cost_enabled() -> bool:
    """``COST_ENABLE`` (default on; 0, false, no or off turn it off)."""
    return os.environ.get("COST_ENABLE", "1").lower() in ("1", "true", "yes", "on")


# ----------------------------------------------------------- session side

class SessionCostLedger:
    """Per-session rollup LRU (brain side): ``fold`` takes a finished
    request's ``GenerationResult.cost``; ``top`` names the heaviest
    sessions by total FLOPs."""

    def __init__(self, cap: int | None = None) -> None:
        self.cap = cap if cap is not None else int(os.environ.get("COST_SESSIONS", "256"))
        self._lock = threading.Lock()
        self._sessions: OrderedDict[str, dict] = OrderedDict()

    def fold(self, session_id: str | None, cost: dict | None) -> None:
        if not cost:
            return
        key = session_id or "_stateless"
        with self._lock:
            ent = self._sessions.get(key)
            if ent is None:
                ent = self._sessions[key] = dict(zero_ledger(), utterances=0, last_s=0.0)
            for k in LEDGER_KEYS:
                ent[k] += int(cost.get(k, 0))
            ent["utterances"] += 1
            ent["last_s"] = round(time.time(), 3)
            self._sessions.move_to_end(key)
            while len(self._sessions) > self.cap:
                self._sessions.popitem(last=False)

    def top(self, n: int = 8) -> list[dict]:
        with self._lock:
            items = [dict(v, session=k) for k, v in self._sessions.items()]
        items.sort(key=lambda e: e["prefill_flops"] + e["decode_flops"], reverse=True)
        return items[:n]

    def snapshot(self) -> dict[str, dict]:
        """Every entry, keyed as folded (tenant ledgers by class name)."""
        with self._lock:
            return {k: dict(v) for k, v in self._sessions.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)
