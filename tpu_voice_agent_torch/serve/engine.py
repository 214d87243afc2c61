"""Grammar-constrained decode engine, PyTorch.

Port of ``tpu_voice_agent/serve/engine.py``: prompt prefill at bucketed
lengths (with a cached shared prefix), then a decode loop whose every step is
[forward -> grammar mask -> pick -> FSM advance] on the device, with the FSM
tables in device memory and indexed by the row's state. Greedy constrained
decoding on a dense-mask grammar takes the fused kernel K4
(``ops.masked_argmax_advance``); grammar fast-forward turns each step into a
(B, 1 + W) block that appends the state's forced token chain.

``generate`` serves one request on a one-slot engine; with more slots the
continuous batcher (``serve.scheduler``) drives ``prefill_slot`` /
``decode_chunk`` / ``release_slot``, and the paged engine (``serve.paged``)
overrides the layout hooks ``_prefill_suffix`` / ``_prefill_full``. With
``spec`` (``serve.spec.SpecConfig``) greedy constrained decoding runs
draft-K / verify-once steps instead (speculation supersedes fast-forward).

The quality lanes (``quality_lanes``, read from ``QUALITY_ENABLE`` at
construction) accumulate each decision's masked-logit margin and entropy and
the grammar-forced count in the loop's carry on the device; they are read
back once with the tokens and summarized into ``GenerationResult.quality``.
They only read values the step computed, so the tokens are the same on or
off.

The chaos drills (``utils.chaos``): ``prefill_slot`` fires ``prefill_exc``
before it touches any state and raises ``ChaosError``; a ``(B,)`` bool
``nan_inject`` tensor, armed by the scheduler and handed over once by
``_take_nan_inject``, turns a flagged active row's logits to NaN before the
poison gate. With chaos off both are one test that fails.

The JAX ``lax.while_loop`` is a Python loop here: its ``any(active)`` test
reads one bool back from the device on every step. ``warm_restart`` (the
serving loop's stall watchdog) rebuilds the KV cache and keeps the weights.
``supersede`` comes first: from it until ``warm_restart``, every prefill,
table claim and decode forward raises ``Superseded`` before it launches, so a
step still running past the watchdog stops at its next launch.
Left out (still JAX-only): ``from_hf`` and meshes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..grammar.fsm import DeviceFSM, fsm_advance, fsm_row
from ..grammar.intent_grammar import build_intent_fsm
from ..models.llama import (
    PRESETS,
    LlamaConfig,
    forward,
    init_kv_cache,
    init_params,
    quantize_params,
    unstack_layers,
)
from ..ops import masked_argmax_advance
from ..utils.chaos import ChaosError, chaos_fire
from ..utils.quality import conf_summary, quality_lanes_enabled
from ..utils.tracing import get_metrics


class Superseded(BaseException):
    """The stall watchdog superseded the engine while this work ran: it
    stops before its next launch and commits nothing. No request's fault,
    so it passes every per-request handler (``except Exception``) up to
    the serving loop, whose replaced thread then exits."""


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller names another. With
    no CUDA device and no explicit device this raises — an entry point never
    drifts onto the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the port's "
                "plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


def byte_len_table_for(tokenizer, vocab_size: int, device="cpu") -> torch.Tensor:
    """(V,) int32 bytes each token id contributes to decoded output — the
    table the byte-budget stop condition gathers from."""
    return torch.tensor([len(tokenizer.token_bytes(i)) for i in range(vocab_size)],
                        dtype=torch.int32, device=device)


@dataclass
class GenerationResult:
    text: str
    token_ids: list[int]
    prefill_ms: float
    decode_ms: float
    steps: int  # EMITTED tokens (fast-forward chain tokens included)
    finished: bool  # True only if EOS was reached (truncation => False)
    error: str | None = None  # per-request failure (poisoned row)
    forwards: int = 0  # decode forward dispatches (< steps under fast-forward)
    cached_tokens: int = 0  # prompt tokens served from the cached prefix
    prompt_tokens: int = 0
    spec_accepted: int = 0  # draft tokens the verify steps accepted (batched)
    # per-request confidence vector (utils.quality.conf_summary): margin
    # mean / min, entropy mean, forced fraction, decision count; None with
    # the quality lanes off or no decision sampled
    quality: dict | None = None
    # per-request resource ledger (utils.costmodel.LEDGER_KEYS, all ints)
    # from the batcher's cost meter; None with COST_ENABLE=0 or off the
    # batcher. An evicted request carries what it spent before dying.
    cost: dict | None = None

    @property
    def tokens_per_s(self) -> float:
        return self.steps / (self.decode_ms / 1e3) if self.decode_ms > 0 else 0.0


def _mask_sample_advance(logits, fsm_state, tables: DeviceFSM, generator, temperature: float,
                         greedy: bool, constrained: bool):
    """The one sampling block: grammar-mask logits, pick a token, advance
    the FSM. Greedy constrained decoding with a dense mask is ONE kernel
    (K4: mask + argmax + advance); otherwise the compressed two-gather row.
    Sampling is Gumbel-max over ``torch.Generator`` noise (categorical
    sampling that never faults on a fully masked row)."""
    if constrained and greedy and tables.dense_mask is not None:
        return masked_argmax_advance(logits, fsm_state, tables.dense_mask, tables.table,
                                     tables.col_id)
    row = None
    if constrained:
        row = fsm_row(tables, fsm_state)  # (B, V) next states; -1 dead
        logits = torch.where(row >= 0, logits, float("-inf"))
    if greedy:
        tok = torch.argmax(logits, dim=-1)
    else:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        tok = torch.argmax(logits / max(temperature, 1e-4) - torch.log(-torch.log(u)), dim=-1)
    tok = tok.to(torch.int32)
    if constrained:
        fsm_state = torch.gather(row, 1, tok[:, None].long())[:, 0]
    return tok, fsm_state


def _poison_gate(raw, state, state_next, active, poison, constrained: bool):
    """The per-row fault check: non-finite raw logits (code 1) and dead FSM
    transitions at entry or after the advance (code 2, constrained only).
    Returns (ok, poison): ``ok`` is active minus this step's poisoned rows,
    which must not commit the faulty sample."""
    nanp = active & ~torch.all(torch.isfinite(raw), dim=-1)
    if constrained:
        deadp = active & ~nanp & ((state < 0) | (state_next < 0))
    else:
        deadp = torch.zeros_like(active)
    code = torch.where(nanp, 1, torch.where(deadp, 2, 0)).to(poison.dtype)
    return active & ~(nanp | deadp), torch.maximum(poison, code)


_first_token = _mask_sample_advance  # the prefill's first pick is the same block


# margin of a forced decision (one legal token: the gap is +inf; the cap
# keeps windowed means finite and comparable across grammars)
QUALITY_MARGIN_CAP = 30.0


def _conf_stats(raw, state, tables: DeviceFSM, constrained: bool):
    """Masked-logit confidence of ONE sampling decision per row: the top1 -
    top2 margin of the masked logits, the entropy of the masked softmax, and
    the forced flag (the grammar leaves at most one legal token). The legal
    row is rebuilt from the FSM table at ``max(state, 0)`` (K4 never returns
    its masked logits), masked with -inf. Reads only: nothing feeds back
    into sampling."""
    lg = raw.float()
    if constrained:
        row = fsm_row(tables, torch.clamp(state, min=0))
        legal = (row >= 0) & (state >= 0)[:, None]
        lg = torch.where(legal, lg, float("-inf"))
        nlegal = torch.sum(legal, dim=-1)
    else:
        nlegal = torch.sum(torch.isfinite(lg), dim=-1)
    return _masked_conf(lg, nlegal)


def _masked_conf(lg, nlegal):
    """The reduction half of ``_conf_stats`` over already-masked fp32
    logits (the spec verify tail calls it on each position's masked row).
    A dead row (no legal token) carries no signal: margin and entropy 0."""
    top2 = torch.topk(lg, 2, dim=-1).values
    alive = torch.isfinite(top2[:, 0])
    margin = torch.where(torch.isfinite(top2[:, 1]),
                         torch.clamp(top2[:, 0] - top2[:, 1], max=QUALITY_MARGIN_CAP),
                         QUALITY_MARGIN_CAP)
    margin = torch.where(alive, margin, 0.0)
    p = torch.softmax(lg, dim=-1)
    ent = -torch.sum(torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)), 0.0), dim=-1)
    ent = torch.where(alive, ent, 0.0)
    return margin, ent, nlegal <= 1


def _conf_accumulate(conf, ok, margin, ent, forced_one, forced_extra=None):
    """Fold one decision into the per-row lanes ``(margin_sum, margin_min,
    entropy_sum, forced, decisions)``; ``forced_extra`` adds the grammar-
    forced chain tokens of a fast-forward step."""
    msum, mmin, esum, forced, cnt = conf
    msum = msum + torch.where(ok, margin, 0.0)
    mmin = torch.where(ok, torch.minimum(mmin, margin), mmin)
    esum = esum + torch.where(ok, ent, 0.0)
    forced = forced + (ok & forced_one).to(torch.int32)
    if forced_extra is not None:
        forced = forced + forced_extra
    cnt = cnt + ok.to(torch.int32)
    return msum, mmin, esum, forced, cnt


def _conf_init(B: int, device):
    """Fresh per-row lanes (margin_min starts at +inf: no decision yet)."""
    return (torch.zeros((B,), dtype=torch.float32, device=device),
            torch.full((B,), float("inf"), dtype=torch.float32, device=device),
            torch.zeros((B,), dtype=torch.float32, device=device),
            torch.zeros((B,), dtype=torch.int32, device=device),
            torch.zeros((B,), dtype=torch.int32, device=device))


def conf_host(conf) -> list[np.ndarray] | None:
    """The lanes as host arrays, in one transfer (None passes through)."""
    if conf is None:
        return None
    packed = torch.stack([conf[0], conf[1], conf[2], conf[3].float(), conf[4].float()]).cpu()
    a = packed.numpy()
    return [a[0], a[1], a[2], a[3].astype(np.int64), a[4].astype(np.int64)]


def prefill_row(params, cfg: LlamaConfig, cache: dict, tokens, positions, slot: int,
                fresh: bool = True):
    """Admission prefill for ONE batch slot, written in place into that
    slot's cache line. Returns logits (1, T, V)."""
    row = {"k": cache["k"][:, slot:slot + 1], "v": cache["v"][:, slot:slot + 1]}
    logits, _ = forward(params, cfg, tokens, positions, row, fresh_block=fresh)
    return logits


def prefill_row_with_prefix(params, cfg: LlamaConfig, cache: dict, prefix_k, prefix_v,
                            tokens, positions, slot: int):
    """Admission prefill reusing the cached shared prefix: copy its KV
    (L, 1, P, nkv, hd) into the slot's line, then run the forward over ONLY
    the user suffix (positions start at P)."""
    P = prefix_k.shape[2]
    row = {"k": cache["k"][:, slot:slot + 1], "v": cache["v"][:, slot:slot + 1]}
    row["k"][:, :, :P] = prefix_k
    row["v"][:, :, :P] = prefix_v
    logits, _ = forward(params, cfg, tokens, positions, row, fresh_block=False)
    return logits


def chain_block(iw, cur, chain, k, active, pad_id: int, pos):
    """Block tokens/positions for a (B, 1+W) chain step: ``[cur,
    chain_0..k-1]`` with the tail duplicating the last valid (token,
    position) — duplicate cache writes are idempotent. Returns (step_tok,
    blk_tok, blk_pos)."""
    ci = torch.minimum(torch.clamp(iw - 1, min=0), torch.clamp(k[:, None] - 1, min=0))
    chain_tok = torch.gather(chain, 1, ci.long())
    step_tok = torch.where(active, cur, pad_id)
    blk_tok = torch.where(iw == 0, step_tok[:, None],
                          torch.where(k[:, None] > 0, chain_tok, step_tok[:, None]))
    write_pos = torch.where(active, pos, 0)
    blk_pos = write_pos[:, None] + torch.minimum(iw, k[:, None])
    return step_tok, blk_tok.to(torch.int32), blk_pos.to(torch.int32)


def chain_byte_cap(k, chain, cur_tok, nbytes, byte_len_table, byte_budget: int):
    """Cap a chain length so its cumulative bytes still fit after
    ``cur_tok``'s (the plain path overshoots the budget by at most one
    token). Returns (capped k, per-token cumulative bytes)."""
    chain_bytes = torch.cumsum(
        torch.where(chain >= 0, byte_len_table[torch.clamp(chain, min=0).long()], 0), dim=1)
    rem = (byte_budget - nbytes - byte_len_table[torch.clamp(cur_tok, min=0).long()])[:, None]
    return torch.minimum(k, torch.sum(chain_bytes <= rem, dim=1).to(k.dtype)), chain_bytes


@torch.no_grad()
def decode_loop(forward_step, max_pos: int, cur, pos, fsm_state, active, nbytes, tokens_left,
                tables: DeviceFSM, byte_len_table, generator, temperature: float,
                byte_budget: int, chunk_steps: int = 32, greedy: bool = True,
                constrained: bool = True, eos_id: int = 2, pad_id: int = 0,
                quality_lanes: bool = False, nan_inject=None):
    """THE decode loop, for every KV layout: advance every active row by up
    to ``chunk_steps`` steps on the device (engine.py:367-589, and its paged
    twin paged.py:287-492). ``forward_step(tokens, positions, active)``
    writes the block's k/v and returns its logits (B, T, V); ``max_pos``
    bounds positions (rows stop at ``max_pos - 1``).

    With fast-forward chains in ``tables`` (and constrained decoding) each
    step is a (B, 1+W) forward of [cur, forced chain...] and emits up to 1+W
    tokens; otherwise a T=1 step. Idle rows run at position 0 (the layout
    parks or confines their writes). A poisoned row (non-finite logits or a
    dead FSM state) deactivates without committing its sample.
    ``nan_inject`` ((B,) bool on the device, or None) is the chaos drill:
    a flagged active row's logits become NaN before the poison gate.

    With ``quality_lanes`` every committed decision folds its confidence
    into per-row device lanes (``_conf_accumulate``); a fast-forward step
    also counts its chain tokens as forced, masked by ``active`` as in JAX.

    Returns (emitted (B, chunk_steps*(1+W)), counts, eos, cur, pos,
    fsm_state, active, nbytes, tokens_left, forwards, poison, conf): conf is
    the five device lanes, or None with the lanes off."""
    B = cur.shape[0]
    dev = cur.device
    use_ff = constrained and tables.ff_tokens is not None
    W = tables.ff_tokens.shape[1] if use_ff else 0
    cap = chunk_steps * (1 + W)
    # ff emission scatters through a trash column (index `cap`)
    out = torch.full((B, cap + 1 if use_ff else cap), pad_id, dtype=torch.int32, device=dev)
    state, left = fsm_state, tokens_left
    eos = (~active) & (cur == eos_id)  # rows already stopped: EOS at admission
    n = torch.zeros((B,), dtype=torch.int32, device=dev)
    poison = torch.zeros((B,), dtype=torch.int32, device=dev)
    ar = torch.arange(B, device=dev)
    iw = torch.arange(1 + W, dtype=torch.int32, device=dev)[None, :]
    conf = _conf_init(B, dev) if quality_lanes else None
    step = 0
    while step < chunk_steps and bool(active.any()):  # one host sync per step
        if use_ff:
            # dead-at-entry rows must not fast-forward (ff_tokens[-1] wraps)
            dead_in = active & (state < 0)
            active = active & ~dead_in
            poison = torch.maximum(poison, torch.where(dead_in, 2, 0).to(torch.int32))
            sl = torch.clamp(state, min=0).long()
            chain = tables.ff_tokens[sl]  # (B, W); -1 pads
            k = torch.minimum(torch.minimum(tables.ff_len[sl], left - 1), max_pos - 1 - pos)
            k, _ = chain_byte_cap(k, chain, cur, nbytes, byte_len_table, byte_budget)
            k = torch.where(active, torch.clamp(k, min=0), 0).to(torch.int32)
            step_tok, blk_tok, blk_pos = chain_block(iw, cur, chain, k, active, pad_id, pos)

            valid = (iw <= k[:, None]) & active[:, None]
            tgt = torch.where(valid, torch.clamp(n[:, None] + iw, max=cap - 1), cap)
            out[ar[:, None], tgt.long()] = torch.where(valid, blk_tok, pad_id)
            emitted = torch.where(active, 1 + k, 0).to(torch.int32)
            n = n + emitted
            chain_valid = (iw >= 1) & (iw <= k[:, None]) & active[:, None]
            nbytes = (nbytes + torch.where(active, byte_len_table[cur.long()], 0)
                      + torch.sum(torch.where(chain_valid,
                                              byte_len_table[torch.clamp(blk_tok, min=0).long()],
                                              0), dim=1)).to(torch.int32)
            left = left - emitted

            # FSM state after the taken chain tokens, walked stepwise so a
            # budget-truncated chain keeps the state exact
            s_end = state
            for i in range(W):
                s2 = fsm_advance(tables, s_end, torch.clamp(chain[:, i], min=0))
                s_end = torch.where(i < k, s2, s_end)

            logits = forward_step(blk_tok, blk_pos, active)
            raw = logits[ar, k.long()]  # (B, V): logits at the chain's end
            if nan_inject is not None:
                raw = torch.where((nan_inject & active)[:, None], float("nan"), raw)
            nxt, state_next = _mask_sample_advance(raw, s_end, tables, generator, temperature,
                                                   greedy, constrained)
            ok, poison = _poison_gate(raw, s_end, state_next, active, poison, constrained)
            if quality_lanes:
                # the decision at the chain's end, plus the emitted chain
                # tokens counted as forced (masked by active, not ok)
                mg, en, f1 = _conf_stats(raw, s_end, tables, constrained)
                conf = _conf_accumulate(conf, ok, mg, en, f1,
                                        forced_extra=torch.where(active, k, 0))
            pos = torch.where(ok, pos + 1 + k, pos)
        else:
            idx = torch.clamp(n, max=cap - 1).long()
            out[ar, idx] = torch.where(active, cur, out[ar, idx])
            n = n + active.to(torch.int32)
            nbytes = nbytes + torch.where(active, byte_len_table[cur.long()], 0)
            left = left - active.to(torch.int32)

            write_pos = torch.where(active, pos, 0)
            step_tok = torch.where(active, cur, pad_id)
            logits = forward_step(step_tok[:, None], write_pos[:, None], active)
            raw = logits[:, 0, :]
            if nan_inject is not None:
                raw = torch.where((nan_inject & active)[:, None], float("nan"), raw)
            nxt, state_next = _mask_sample_advance(raw, state, tables, generator, temperature,
                                                   greedy, constrained)
            ok, poison = _poison_gate(raw, state, state_next, active, poison, constrained)
            if quality_lanes:
                mg, en, f1 = _conf_stats(raw, state, tables, constrained)
                conf = _conf_accumulate(conf, ok, mg, en, f1)
            pos = torch.where(ok, pos + 1, pos)
        state = torch.where(ok, state_next, state)
        cur = torch.where(ok, nxt, cur)
        eos = eos | (ok & (cur == eos_id))
        stop = (cur == eos_id) | (nbytes >= byte_budget) | (pos >= max_pos - 1) | (left <= 0)
        active = ok & ~stop
        step += 1
    return (out[:, :cap], n, eos, cur, pos, state, active, nbytes, left, step, poison, conf)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecodeEngine:
    """Grammar-constrained decode engine on one device: ``generate`` with
    one slot, or ``batch_slots`` dense cache lines behind the continuous
    batcher."""

    def __init__(
        self,
        preset: str = "test-tiny",
        cfg: LlamaConfig | None = None,
        seed: int = 0,
        max_len: int = 2048,
        batch_slots: int = 1,
        prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048),
        kernels: str = "auto",  # "auto" | "kernels"
        quant: str | None = None,  # None | "int8" — weight-only quantization
        init_weights: bool = True,  # False: the caller loads weights next
        fast_forward: int = 0,  # grammar fast-forward chain width (0 = off)
        device: str | torch.device | None = None,  # None = cuda, or raise
        spec=None,  # serve.spec.SpecConfig | None: speculative decoding
        quality_lanes: bool | None = None,  # None: QUALITY_ENABLE (default on)
    ):
        self.device = resolve_device(device)
        self.quality_lanes = (quality_lanes_enabled() if quality_lanes is None
                              else bool(quality_lanes))
        if batch_slots < 1:
            raise ValueError("need at least one batch slot")
        # "auto" and "kernels" both take the kernel branch split: the
        # wrappers launch the CUDA kernels on cuda tensors and their plain
        # versions on CPU tensors.
        if kernels not in ("auto", "kernels"):
            raise ValueError(f"unknown kernels {kernels!r}")
        self.kernels = "kernels"
        self.tokenizer, self.fsm = build_intent_fsm()
        vocab = self.tokenizer.vocab_size
        self.cfg = replace(cfg or PRESETS[preset], vocab_size=vocab, max_seq_len=max_len)
        self.eos_id = int(self.tokenizer.eos_id)
        self.pad_id = int(self.tokenizer.pad_id)
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.prefill_buckets = tuple(b for b in prefill_buckets if b <= max_len)
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant
        self.params = None
        if init_weights:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            # int8 quantizes as it draws: a mixtral-8x7b tree fits the card
            # only that way
            self.load_params(init_params(self.cfg, gen, device=self.device, quant=quant))
        self.cache = self._init_kv_cache()

        self.tables = self.fsm.device_tables(device=self.device)
        self.fast_forward = fast_forward
        if fast_forward > 0:
            fft, ffl = self.fsm.forced_tables(fast_forward)
            self.tables_ff = self.tables._replace(
                ff_tokens=torch.from_numpy(fft).to(self.device),
                ff_len=torch.from_numpy(ffl).to(self.device))
        else:
            self.tables_ff = None
        self.byte_len_table = byte_len_table_for(self.tokenizer, self.cfg.vocab_size,
                                                 self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        # shared-prefix cache: token ids + their precomputed KV (L,1,P,nkv,hd)
        self.prefix_ids: list[int] = []
        self.prefix_kv: dict | None = None
        self._last_prefill_compute_ms = 0.0
        self._last_cached_tokens = 0
        self._last_fwds = 0  # the last decode_chunk's forward count
        self._last_poison = None  # its per-row fault codes (B,) int32
        self._last_conf = None  # its per-row quality lanes (device), or None
        self._nan_inject = None  # the chaos drill's one-shot (B,) host mask
        # set by supersede, cleared by warm_restart: no launch in between
        self._superseded = False
        self._last_draft_ms = 0.0  # a speculative chunk's drafter share
        # speculative decoding, built last: the decoder reads the engine's
        # surface; the paged engine builds it once its pool exists
        self.spec = None
        self._spec_cfg = spec
        if self._spec_cfg is not None and self.cache is not None:
            self._build_spec()

    def _build_spec(self) -> None:
        from .spec import SpecDecoder

        self.spec = SpecDecoder(self, self._spec_cfg)

    # ------------------------------------------------------------ helpers

    def _init_kv_cache(self):
        """Layout hook: one dense cache line per slot (the paged engine
        holds a block pool instead)."""
        return init_kv_cache(self.cfg, self.batch_slots, self.max_len, device=self.device)

    def load_params(self, params: dict) -> None:
        """Install weights (stacked-layer tree on this engine's device),
        applying the engine's quantization to a raw tree."""
        if self.quant == "int8" and not isinstance(params.get("lm_head"), dict):
            params = quantize_params(params)
        layers = params["layers"]
        self.params = {**params, "layers": (unstack_layers(layers)
                                            if isinstance(layers, dict) else layers)}

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket {self.prefill_buckets[-1]}")

    def _suffix_bucket(self, n: int, limit: int) -> int | None:
        """Bucket for a prefix-cached suffix: finer than the full prefill
        buckets and capped so prefix + bucket fits the cache. None = no
        bucket fits; the caller falls back to the full prefill."""
        for b in (32, 64) + self.prefill_buckets:
            if n <= b <= limit:
                return b
        return None

    def _ids(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, dtype=np.int32), device=self.device)

    # ------------------------------------------------------------ prefix

    def set_prompt_prefix(self, *sample_prompts: str) -> int:
        """Install the shared-prefix cache from >= 2 sample prompts: the
        longest common TOKEN prefix of their encodings, prefilled once.
        Returns the cached prefix length in tokens."""
        if len(sample_prompts) < 2:
            raise ValueError("need >= 2 sample prompts to locate the shared prefix")
        encs = [self.tokenizer.encode(p, bos=True) for p in sample_prompts]
        P = 0
        shortest = min(len(e) for e in encs)
        while P < shortest and all(e[P] == encs[0][P] for e in encs):
            P += 1
        if P == 0:
            self.prefix_ids, self.prefix_kv = [], None
            return 0
        ids = list(encs[0][:P])
        bucket = self._bucket(P)
        tokens = np.full((1, bucket), self.pad_id, dtype=np.int32)
        tokens[0, :P] = ids
        positions = np.arange(bucket, dtype=np.int32)[None, :]
        self.prefix_kv = self._compute_prefix_kv(self._ids(tokens), self._ids(positions), P,
                                                 bucket)
        self.prefix_ids = ids
        return P

    def _compute_prefix_kv(self, tokens, positions, P: int, bucket: int) -> dict:
        """Prefill the prefix (a fresh block: K1) into a scratch cache and
        return its KV (L, 1, P, nkv, hd)."""
        scratch = init_kv_cache(self.cfg, 1, bucket, device=self.device)
        _, kv = forward(self.params, self.cfg, tokens, positions, scratch, fresh_block=True)
        return {"k": kv["k"][:, :, :P].clone(), "v": kv["v"][:, :, :P].clone()}

    def _split_prefix(self, ids: list[int]) -> list[int] | None:
        """The suffix ids when the cached prefix applies (exact token match),
        else None."""
        P = len(self.prefix_ids)
        if self.prefix_kv is None or len(ids) <= P:
            return None
        if list(ids[:P]) != self.prefix_ids:
            return None
        return list(ids[P:])

    # ------------------------------------------------------------ generate

    def prefill_slot(self, ids: list[int], slot: int) -> torch.Tensor:
        """Prefill token ids into one batch slot, reusing the shared-prefix
        KV when ``ids`` starts with it (exact token match). Returns the last
        real token's logits (1, V). The one decision tree of every layout:
        the dense and paged engines override only the ``_prefill_suffix`` /
        ``_prefill_full`` hooks."""
        self._fence()
        if chaos_fire("prefill_exc"):
            # the admission fence's drill: fires before any state is touched
            raise ChaosError("chaos: injected prefill exception")
        # a finished request may still own resources; it is released as
        # not ok: it was never handed back clean (no radix insert, no trace)
        self.release_slot(slot, ok=False)
        if self.spec is not None:
            # the drafters' host context (and the draft model's own prefill)
            self.spec.on_admit(slot, list(ids))
        n = len(ids)
        suffix = self._split_prefix(ids)
        if suffix is not None:
            bucket = self._suffix_bucket(len(suffix), self.max_len - len(self.prefix_ids))
            if bucket is None:
                suffix = None  # no suffix bucket fits; full prefill below
        t0 = time.perf_counter()
        if suffix is not None:
            P, m = len(self.prefix_ids), len(suffix)
            tokens = np.full((1, bucket), self.pad_id, dtype=np.int32)
            tokens[0, :m] = suffix
            positions = (P + np.arange(bucket, dtype=np.int32))[None, :]
            logits = self._prefill_suffix(self._ids(tokens), self._ids(positions), slot, P,
                                          bucket, n)
            last, cached = logits[:, m - 1, :], P
        else:
            bucket = self._bucket(n)
            tokens = np.full((1, bucket), self.pad_id, dtype=np.int32)
            tokens[0, :n] = ids
            positions = np.arange(bucket, dtype=np.int32)[None, :]
            logits = self._prefill_full(self._ids(tokens), self._ids(positions), slot, bucket, n)
            last, cached = logits[:, n - 1, :], 0
        _sync(self.device)
        self._last_prefill_compute_ms = (time.perf_counter() - t0) * 1e3
        self._last_cached_tokens = cached
        return last.contiguous()

    def _prefill_suffix(self, tokens, positions, slot: int, P: int, bucket: int, n: int):
        """Layout hook: admit a prefix-cached suffix into ``slot``."""
        return prefill_row_with_prefix(self.params, self.cfg, self.cache, self.prefix_kv["k"],
                                       self.prefix_kv["v"], tokens, positions, slot)

    def _prefill_full(self, tokens, positions, slot: int, bucket: int, n: int):
        """Layout hook: admit a fresh full prompt into ``slot``."""
        return prefill_row(self.params, self.cfg, self.cache, tokens, positions, slot, fresh=True)

    def _decode_step(self, tokens, positions, active):
        """Layout hook: one decode forward, k/v written in place (idle rows
        write slot 0 of their own line). Returns logits (B, T, V)."""
        self._fence()
        return forward(self.params, self.cfg, tokens, positions, self.cache)[0]

    def _claim(self, span: int, active=None) -> list[int]:
        """Layout hook before a dispatch: room for ``span`` more positions on
        every live row (``active``: host bools; default every slot in use).
        Returns the slots that could not get it. The dense cache already
        holds every position."""
        return []

    def reconcile_coverage(self, pos_h) -> None:
        """Layout hook after a dispatch, with the rows' host positions. The
        dense cache has nothing to settle."""

    def decode_chunk(self, cur, pos, fsm, active, nbytes, tokens_left, generator,
                     temperature: float, byte_budget: int, chunk_steps: int, greedy: bool):
        """Advance all slots by one decode chunk (the batcher's device-work
        entry point; the KV layout stays the engine's business). Sets
        ``_last_fwds`` (forward count), ``_last_poison`` (per-row fault
        codes) and ``_last_conf`` (the per-row quality lanes, or None). Returns (emitted, counts, eos, cur, pos, fsm, active, nbytes,
        tokens_left). With speculation on, greedy chunks are the
        ``SpecDecoder``'s verify steps, each claiming its own room; a plain
        chunk first claims its worst case, ``chunk_steps * (1 + W)``
        positions, and a slot that cannot get it gets ``tokens_left`` 0 and
        truncates at its covered frontier (the batch lives on). CALLER
        OBLIGATION: pass the chunk's host positions to
        ``reconcile_coverage`` afterwards."""
        if self.spec is not None and greedy:
            return self.spec.decode_chunk(cur, pos, fsm, active, nbytes, tokens_left,
                                          byte_budget, chunk_steps)
        W = self.tables_ff.ff_tokens.shape[1] if self.tables_ff is not None else 0
        starved = self._claim(chunk_steps * (1 + W))
        if starved:
            tokens_left = tokens_left.clone()
            tokens_left[starved] = 0
        tables = self.tables_ff if self.tables_ff is not None else self.tables
        (out, n, eos, cur, pos, fsm, active, nbytes, left, fwds, pois, conf) = decode_loop(
            self._decode_step, self.max_len, cur, pos, fsm, active, nbytes, tokens_left,
            tables, self.byte_len_table, generator, temperature, byte_budget,
            chunk_steps=chunk_steps, greedy=greedy, constrained=True,
            eos_id=self.eos_id, pad_id=self.pad_id, quality_lanes=self.quality_lanes,
            nan_inject=self._take_nan_inject())
        self._last_fwds, self._last_poison, self._last_conf = fwds, pois, conf
        return out, n, eos, cur, pos, fsm, active, nbytes, left

    def _take_nan_inject(self):
        """Hand over the chaos drill's one-shot NaN mask (the scheduler sets
        it per admission) as a (B,) bool tensor on the device, once; None
        when no drill is armed."""
        ni = self._nan_inject
        if ni is None:
            return None
        self._nan_inject = None
        return torch.as_tensor(np.asarray(ni, dtype=bool), device=self.device)

    def release_slot(self, slot: int, generated_ids: list[int] | None = None,
                     ok: bool = True) -> None:
        """A batch slot finished. Dense cache lines are reused in place; the
        paged engine returns the slot's blocks (and, with radix reuse on,
        caches the prompt + ``generated_ids`` chain first unless ``ok`` is
        False). The spec decoder drops the slot's context."""
        if self.spec is not None:
            self.spec.on_release(slot, ok=ok)

    def supersede(self) -> None:
        """The stall watchdog's first move, from its own thread while the
        wedged step may still run: every later prefill, table claim, decode
        forward and verify step raises ``Superseded`` (or, in a speculative
        chunk, stops) before it launches, until ``warm_restart``. It touches
        no other state."""
        self._superseded = True
        if self.spec is not None:
            self.spec.supersede()

    def _fence(self) -> None:
        if self._superseded:
            raise Superseded("engine superseded by a warm restart")

    def warm_restart(self) -> None:
        """Rebuild the mutable decode state after a wedged step, keeping the
        loaded weights: a fresh dense KV cache (the shared prefix's KV lives
        outside it and survives), no armed NaN drill, and the spec decoder's
        contexts dropped behind its generation fence. The caller (the serving
        loop's watchdog) fails the in-flight work and resets the batcher.
        JAX also re-arms its recompilation sentinel here; the port compiles
        no XLA programs, so it has no counterpart."""
        if self.cache is not None:
            self.cache = self._init_kv_cache()
        self._nan_inject = None
        if self.spec is not None:
            self.spec.reset()
        self._superseded = False

    def _admit_first_token(self, prompt: str, temperature: float, greedy: bool = True,
                           constrained: bool = True):
        """Prefill slot 0 + pick the first token. Returns (tok0, fsm0,
        prompt_len, prefill_ms)."""
        if self.batch_slots != 1:
            raise ValueError("single-request generate() needs batch_slots=1; batched decode "
                             "is driven by the continuous batcher (serve.scheduler)")
        t0 = time.perf_counter()
        ids = self.tokenizer.encode(prompt, bos=True)
        last_logits = self.prefill_slot(ids, 0)
        fsm_state = torch.full((1,), self.fsm.start, dtype=torch.int32, device=self.device)
        tok0, fsm0 = _first_token(last_logits, fsm_state, self.tables, self._gen, temperature,
                                  greedy, constrained)
        _sync(self.device)
        return tok0, fsm0, len(ids), (time.perf_counter() - t0) * 1e3

    @torch.no_grad()
    def generate(
        self,
        prompt: str,
        max_new_tokens: int = 512,
        constrained: bool = True,
        greedy: bool = True,
        temperature: float = 0.7,
        byte_budget: int = 3900,
    ) -> GenerationResult:
        """Generate a completion; with ``constrained`` the text matches the
        intent grammar, and ``byte_budget`` keeps strings inside the
        schema's caps. With speculation on, a constrained greedy request
        runs verify steps (``steps`` counts its tokens, ``forwards`` its
        verify steps)."""
        tok0, fsm0, n, prefill_ms = self._admit_first_token(
            prompt, temperature, greedy=greedy, constrained=constrained)
        t1 = time.perf_counter()
        i32 = dict(dtype=torch.int32, device=self.device)
        state = (tok0, torch.full((1,), n, **i32), fsm0,
                 tok0 != self.eos_id,  # active
                 torch.zeros((1,), **i32),  # nbytes
                 torch.full((1,), max_new_tokens, **i32))  # tokens_left
        if self.spec is not None and constrained and greedy:
            # every verify step emits a token or stops the row: one chunk
            # of max_new_tokens steps finishes the request
            buf, count, eos = self.spec.decode_chunk(*state, byte_budget,
                                                     chunk_steps=max_new_tokens)[:3]
            fwds, pois, conf = self._last_fwds, self._last_poison, self._last_conf
        else:
            tables = (self.tables_ff if (constrained and self.tables_ff is not None)
                      else self.tables)
            (buf, count, eos, _cur, _pos, _fsm, _act, _nb, _left, fwds, pois,
             conf) = decode_loop(
                self._decode_step, self.max_len, *state,
                tables, self.byte_len_table, self._gen, temperature, byte_budget,
                chunk_steps=max_new_tokens, greedy=greedy, constrained=constrained,
                eos_id=self.eos_id, pad_id=self.pad_id, quality_lanes=self.quality_lanes,
            )
        count_h = int(count[0])
        out_ids = [int(t) for t in buf[0, :count_h].tolist()]
        finished = bool(eos[0])
        pois_h = int(pois[0])
        conf_h = conf_host(conf)
        decode_ms = (time.perf_counter() - t1) * 1e3
        quality = (conf_summary([x[0] for x in conf_h], count_h)
                   if conf_h is not None else None)
        m = get_metrics()
        m.inc("engine.requests")
        m.inc("engine.tokens_generated", count_h)
        m.observe_ms("engine.prefill", prefill_ms)
        m.observe_ms("engine.decode", decode_ms)
        return GenerationResult(
            text=self.tokenizer.decode(out_ids),
            token_ids=out_ids,
            prefill_ms=prefill_ms,
            decode_ms=decode_ms,
            steps=count_h,
            finished=finished,
            error=(None if pois_h == 0 else
                   "poisoned: " + ("non-finite logits" if pois_h == 1
                                   else "grammar dead state")),
            forwards=fwds,
            cached_tokens=self._last_cached_tokens,
            prompt_tokens=n,
            quality=quality,
        )
