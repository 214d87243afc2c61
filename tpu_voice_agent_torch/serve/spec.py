"""Grammar-aware speculative decoding: draft K tokens, verify them in ONE pass.

Port of ``tpu_voice_agent/serve/spec.py``. A host-side drafter proposes up
to K continuation tokens per row; one (B, 1+K) target forward over
``[cur, d_1..d_K]`` scores every draft position; the grammar masks each
position at its own FSM state; the longest draft prefix that equals the
target's masked greedy pick is accepted, and the target's pick at the first
mismatch rides along as a bonus token. A verify step emits 1..K+1 tokens.
An accepted token IS the target's own masked greedy pick, so the stream is
token-identical to plain greedy decoding (fast-forward off) whatever the
drafts; they change only the number of forwards.

Rollback is free in both layouts. Dense: the cache is indexed by position
and attention masks slots past each query's position, so stale draft KV is
overwritten by the next contiguous block before any query attends it.
Paged: draft writes land past the admission frontier, in blocks the slot
owns, so the same holds at block granularity and a radix-cached chain never
holds a rejected draft (release caches only the accepted stream).

On the card the verify forward runs K3 (dense) or K7 / K9 (paged, bf16 /
quantized pool), and the verify tail picks every position's masked greedy
token in one K11 launch (``ops.masked_argmax_block``) where the grammar's
dense (S, V) mask exists; otherwise per position through ``fsm_row``.

Drafters (comma-chained, first non-empty proposal wins per row):
``fsm`` (``TokenFSM.lookahead``: the canonical tiling of the forced byte run),
``prompt`` (n-gram prompt lookup over the row's context) and ``model`` (a
small Llama greedy-drafting under the grammar with its own dense cache).

Env contract (``spec_from_env``): ``SPEC_ENABLE=1`` turns it on, ``SPEC_K``
sets K (default 4), ``SPEC_DRAFTER`` the chain (default ``fsm,prompt``),
``SPEC_TRACE_SINK=<path>`` appends one JSONL draft-trace record per cleanly
released request (JAX's fields). Not ported, and refused at boot when set:
``SPEC_DRAFT_MODEL`` (an orbax checkpoint).

With the engine's quality lanes on, every verified decision (the accepted
drafts and the bonus) folds its masked-logit confidence into per-row lanes
on the device, read back with the chunk. The ``spec.*`` counters and gauges
are JAX's. A warm restart (``reset``) bumps the generation fence, which
stops a verify loop wedged mid-chunk before its next claim or launch. Left
out: speculation under chunked prefill.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..grammar.fsm import DeviceFSM, fsm_advance, fsm_row
from ..models.llama import (MAX_BLOCK_DECODE_T, PRESETS, forward, init_kv_cache, init_params,
                            unstack_layers)
from ..ops import masked_argmax_block
from ..utils.tracing import get_metrics
from .engine import _conf_init, _conf_stats, chain_block, chain_byte_cap, prefill_row

# ---------------------------------------------------------------- config


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs, one per engine."""

    k: int = 4  # draft width per verify step (emits 1..k+1 tokens a step)
    drafter: str = "fsm,prompt"  # comma chain: fsm | prompt | model (random draft-tiny)
    trace_sink: str | None = None  # JSONL path of per-request draft traces


def spec_from_env() -> SpecConfig | None:
    """The SPEC_* contract, read in one place. None (``SPEC_ENABLE`` unset)
    keeps the plain decode path. Raises ``ValueError`` for the variables
    the port does not serve, so a deployment never runs without them
    unknowingly."""
    if os.environ.get("SPEC_ENABLE", "").strip().lower() not in ("1", "true", "yes", "on"):
        return None
    if os.environ.get("SPEC_DRAFT_MODEL"):
        raise ValueError("SPEC_DRAFT_MODEL is not ported yet (the PyTorch port has no orbax "
                         "checkpoint reader: ROADMAP.md Queue 1 item 8); unset it")
    raw_k = os.environ.get("SPEC_K", "").strip()
    try:
        k = int(raw_k) if raw_k else 4
    except ValueError:
        raise ValueError(f"SPEC_K={raw_k!r} is not an integer") from None
    return SpecConfig(k=k, drafter=os.environ.get("SPEC_DRAFTER", "fsm,prompt") or "fsm,prompt",
                      trace_sink=os.environ.get("SPEC_TRACE_SINK") or None)


def check_spec_block(k: int, block_t: int, device: torch.device) -> None:
    """Refuse at boot a draft width the card cannot verify. A verify block is
    ``1 + k`` positions and the draft model feeds ``block_t``-wide blocks; on
    the card both run K3 / K7 / K9, which take at most
    ``MAX_BLOCK_DECODE_T`` positions. A wider block would leave the kernels
    for the plain attention without a word, so it raises instead; the CPU's
    plain versions take any width."""
    if k < 1:
        raise ValueError(f"SPEC_K={k}: the draft width must be at least 1")
    widest = max(1 + k, block_t)
    if device.type == "cuda" and widest > MAX_BLOCK_DECODE_T:
        raise ValueError(f"SPEC_K={k} makes a {widest}-position block, past the "
                         f"{MAX_BLOCK_DECODE_T} that the card's block-attention kernels take")


# ---------------------------------------------------------------- verify


def _draft_cap(draft_len, tokens_left, pos, max_pos, active):
    """Proposal length, capped so emission fits the token budget and the
    cache (accepted writes land at pos .. pos+a <= max_pos-1)."""
    dl = torch.minimum(torch.minimum(draft_len, tokens_left - 1), max_pos - 1 - pos)
    return torch.where(active, torch.clamp(dl, min=0), 0).to(torch.int32)


def _verify_commit(logits, cur, pos, fsm_state, active, nbytes, tokens_left, draft_toks, dl,
                   step_tok, blk_tok, tables: DeviceFSM, byte_len_table, byte_budget: int,
                   K: int, eos_id: int, pad_id: int, max_pos: int, quality_lanes: bool = False):
    """The post-forward half of a verify step (spec.py:128-279): the FSM
    walk along each draft, every position's masked greedy pick, longest
    prefix acceptance plus the bonus token, the byte / token / cache caps,
    and the poison gate per verify position (non-finite logits at a real
    position, or a dead state at entry or on the bonus advance). A poisoned
    row deactivates without committing anything. With ``quality_lanes`` each
    verified decision (positions 0..a of a row that commits) is scored at its
    own FSM state over the position's masked logits, all positions in one
    batched ``_conf_stats``. Returns (out, n_step, eos, new_cur, new_pos,
    new_state, new_active, nbytes, left, a, dl, poison, conf): conf is the
    step's five lanes, or None with the lanes off."""
    dev = logits.device
    iw = torch.arange(1 + K, device=dev)[None, :]  # (1, 1+K) block index
    # states[:, i] = state after cur, d_1..d_i (a dead or padded step pins -1)
    states = [fsm_state]
    s = fsm_state
    for i in range(K):
        t = draft_toks[:, i]
        nxt = fsm_advance(tables, torch.clamp(s, min=0), torch.clamp(t, min=0))
        s = torch.where((s >= 0) & (t >= 0), nxt, -1)
        states.append(s)
    states = torch.stack(states, dim=1).to(torch.int32)  # (B, 1+K)

    if tables.dense_mask is not None:
        # one K11 launch for the whole block; a dead state's pick sits past
        # the first mismatch, so its clamped garbage never decides anything
        g = masked_argmax_block(logits, states, tables.dense_mask)
        g = torch.where(states >= 0, g, 0)
    else:
        gs = []
        for i in range(K + 1):
            s_i = states[:, i]
            row = fsm_row(tables, torch.clamp(s_i, min=0))
            legal = (row >= 0) & (s_i >= 0)[:, None]
            lg = torch.where(legal, logits[:, i, :], float("-inf"))
            gs.append(torch.argmax(lg, dim=-1).to(torch.int32))
        g = torch.stack(gs, dim=1)  # (B, 1+K)

    # accept d_{i+1} where it is the target's pick, never EOS, inside the
    # capped proposal; the cumulative product makes acceptance a prefix
    m = ((draft_toks == g[:, :K]) & (draft_toks != eos_id)
         & (torch.arange(K, device=dev)[None, :] < dl[:, None]))
    a = torch.sum(torch.cumprod(m.to(torch.int32), dim=1), dim=1).to(torch.int32)
    a, chain_bytes = chain_byte_cap(a, draft_toks, step_tok, nbytes, byte_len_table, byte_budget)
    a = torch.where(active, a, 0).to(torch.int32)

    # the bonus: the target's pick at the first unaccepted position
    g_a = torch.gather(g, 1, a[:, None].long())[:, 0]
    s_a = torch.gather(states, 1, a[:, None].long())[:, 0]
    s_next = fsm_advance(tables, torch.clamp(s_a, min=0), g_a)

    real = iw <= dl[:, None]
    finite = torch.all(torch.isfinite(logits), dim=-1)  # (B, 1+K)
    nanp = active & torch.any(~finite & real, dim=1)
    deadp = active & ~nanp & ((fsm_state < 0) | (s_a < 0) | (s_next < 0))
    poison = torch.where(nanp, 1, torch.where(deadp, 2, 0)).to(torch.int32)
    ok = active & ~(nanp | deadp)

    valid = (iw <= a[:, None]) & ok[:, None]
    out = torch.where(valid, blk_tok, pad_id).to(torch.int32)  # slot i = token i
    n_step = torch.where(ok, 1 + a, 0).to(torch.int32)
    acc_bytes = torch.where(
        a > 0, torch.gather(chain_bytes, 1, torch.clamp(a - 1, min=0)[:, None].long())[:, 0], 0)
    nbytes = (nbytes + torch.where(
        ok, byte_len_table[torch.clamp(step_tok, min=0).long()] + acc_bytes, 0)).to(torch.int32)
    left = (tokens_left - n_step).to(torch.int32)

    new_state = torch.where(ok, s_next, fsm_state).to(torch.int32)
    new_cur = torch.where(ok, g_a, cur).to(torch.int32)
    new_pos = torch.where(ok, pos + 1 + a, pos).to(torch.int32)
    eos = ok & (new_cur == eos_id)
    stop = ((new_cur == eos_id) | (nbytes >= byte_budget) | (new_pos >= max_pos - 1)
            | (left <= 0))
    new_active = ok & ~stop
    conf = None
    if quality_lanes:
        B, T, V = logits.shape
        mg, en, f1 = _conf_stats(logits.reshape(B * T, V), states.reshape(B * T), tables, True)
        sel = ok[:, None] & (iw <= a[:, None])  # (B, 1+K) verified decisions
        mg, en, f1 = mg.view(B, T), en.view(B, T), f1.view(B, T)
        conf = (torch.sum(torch.where(sel, mg, 0.0), dim=1),
                torch.amin(torch.where(sel, mg, float("inf")), dim=1),  # +inf: none
                torch.sum(torch.where(sel, en, 0.0), dim=1),
                torch.sum(sel & f1, dim=1).to(torch.int32),
                torch.sum(sel, dim=1).to(torch.int32))
    return (out, n_step, eos, new_cur, new_pos, new_state, new_active, nbytes, left, a, dl,
            poison, conf)


@torch.no_grad()
def verify_step(engine, cur, pos, fsm_state, active, nbytes, tokens_left, draft_toks,
                draft_len, byte_budget: int, K: int, max_pos: int, quality_lanes: bool = False,
                nan_inject=None):
    """ONE speculative step for every row of ``engine``, dense or paged:
    the (B, 1+K) block ``[cur, d_1..d_dl]`` padded by repeating its last
    (token, position) (``engine.chain_block``: duplicate writes are
    idempotent), one forward through the engine's layout hook
    ``_decode_step`` (the dense cache, or the pool through block tables with
    idle rows parked), then ``_verify_commit``. One copy for both layouts:
    the JAX package needs two twins only for jit's static arguments.
    ``nan_inject`` ((B,) bool, or None): the chaos drill turns a flagged
    active row's block logits to NaN before the poison gate."""
    dl = _draft_cap(draft_len, tokens_left, pos, max_pos, active)
    iw = torch.arange(1 + K, dtype=torch.int32, device=cur.device)[None, :]
    step_tok, blk_tok, blk_pos = chain_block(iw, cur, draft_toks, dl, active, engine.pad_id, pos)
    logits = engine._decode_step(blk_tok, blk_pos, active)  # (B, 1+K, V)
    if nan_inject is not None:
        logits = torch.where((nan_inject & active)[:, None, None], float("nan"), logits)
    return _verify_commit(logits, cur, pos, fsm_state, active, nbytes, tokens_left, draft_toks,
                          dl, step_tok, blk_tok, engine.tables, engine.byte_len_table,
                          byte_budget, K, engine.eos_id, engine.pad_id, max_pos,
                          quality_lanes=quality_lanes)


# ---------------------------------------------------------------- drafters


class Drafter:
    """A proposal source. Stateless by default; a stateful drafter (the draft
    model's cache) hooks admission and release like the engine's slots."""

    name = "base"
    block_t = 0  # the widest forward block it runs (0: it runs none)

    def on_admit(self, slot: int, ids: list[int]) -> None:
        pass

    def on_release(self, slot: int) -> None:
        pass

    def draft_one(self, ctx: list[int], state: int, k: int) -> list[int]:
        return []

    def draft_batch(self, ctxs, states, need, k: int):
        """(B, k) int32 proposals (-1 pad) and (B,) lengths. ``ctxs[b]`` is
        the row's full context (prompt + emitted + cur) or None; ``need``
        marks the rows that want drafts."""
        B = len(ctxs)
        toks = np.full((B, k), -1, dtype=np.int32)
        lens = np.zeros((B,), dtype=np.int32)
        for b in range(B):
            if not need[b] or ctxs[b] is None:
                continue
            d = self.draft_one(ctxs[b], int(states[b]), k)[:k]
            if d:
                toks[b, :len(d)] = d
                lens[b] = len(d)
        return toks, lens


class FSMDrafter(Drafter):
    """Grammar lookahead: the canonical tiling of the forced byte run from
    the row's state. Free-choice states draft nothing."""

    name = "fsm"

    def __init__(self, fsm):
        self.fsm = fsm

    def draft_one(self, ctx, state, k):
        return self.fsm.lookahead(state, k)


class PromptLookupDrafter(Drafter):
    """N-gram prompt lookup: the longest suffix n-gram of the context that
    occurs earlier in it proposes what followed its rightmost occurrence
    (intent JSON echoes schema keys and the transcript)."""

    name = "prompt"
    max_ngram = 4  # the longest suffix tried first, down to one token

    def draft_one(self, ctx, state, k):
        L = len(ctx)
        if L < 2:
            return []
        arr = np.asarray(ctx, dtype=np.int64)
        for n in range(min(self.max_ngram, L - 1), 0, -1):
            key = arr[L - n:]
            hits = np.ones(L - n, dtype=bool)  # window starts 0..L-n-1
            for i in range(n):
                hits &= arr[i:i + (L - n)] == key[i]
            js = np.nonzero(hits)[0]
            if len(js):
                j = int(js[-1])  # the rightmost earlier occurrence wins
                return ctx[j + n:j + n + k]
        return []


@torch.no_grad()
def _draft_model_block(params, cfg, cache, toks, poss, last_idx, state, tables: DeviceFSM,
                       K: int, max_pos: int):
    """Feed a (B, D) context block into the draft model's cache, then
    greedy-draft K tokens under the grammar (spec.py:527-561). ``last_idx``
    points at each row's last real context token in the block (the tail
    repeats it: idempotent writes, equal logits). On the card the feed block
    runs K3 and each draft step K2. Returns (B, K) int32 drafts."""
    B = toks.shape[0]
    dev = toks.device
    rows = torch.arange(B, device=dev)
    logits, _ = forward(params, cfg, toks, poss, cache)
    last = logits[rows, last_idx.long()]  # (B, V)
    next_pos = poss[rows, last_idx.long()] + 1
    drafts = []
    s = state
    for i in range(K):
        row = fsm_row(tables, torch.clamp(s, min=0))
        lg = torch.where((row >= 0) & (s >= 0)[:, None], last, float("-inf"))
        t = torch.argmax(lg, dim=-1).to(torch.int32)
        nxt = fsm_advance(tables, torch.clamp(s, min=0), t)
        s = torch.where(s >= 0, nxt, s)
        drafts.append(t)
        if i < K - 1:
            # rows that do not draft this round write past their frontier,
            # clamped into the cache; their results are discarded
            wp = torch.clamp(next_pos, max=max_pos - 1).to(torch.int32)
            logits, _ = forward(params, cfg, t[:, None], wp[:, None], cache)
            last = logits[:, 0, :]
            next_pos = next_pos + 1
    if not drafts:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    return torch.stack(drafts, dim=1)


class DraftModelDrafter(Drafter):
    """A small Llama drafting greedily under the same grammar, with its own
    dense cache on the engine's device. The cache shares the target's
    position rollback: rejected draft KV is stale but never attended, and
    each round's context delta is fed as one block before drafting resumes.
    ``cfg`` / ``params`` give the draft model (the target's own for a
    self-draft); without them a random ``draft-tiny`` model from seed 0.
    ``k`` is the decoder's draft width."""

    name = "model"

    def __init__(self, engine, k: int, cfg=None, params=None):
        base = cfg or PRESETS["draft-tiny"]
        # the draft model must speak the target's token ids
        self.cfg = replace(base, vocab_size=engine.cfg.vocab_size, max_seq_len=engine.max_len)
        if params is None:
            gen = torch.Generator(device=engine.device).manual_seed(0)
            params = init_params(self.cfg, gen, device=engine.device)
        else:
            rows = params["embed"].shape[0]
            if rows > self.cfg.vocab_size:
                raise ValueError(f"draft checkpoint vocab {rows} exceeds target vocab "
                                 f"{self.cfg.vocab_size}; draft and target must share token ids")
            if rows < self.cfg.vocab_size:
                pad = self.cfg.vocab_size - rows
                head = params["lm_head"]
                if isinstance(head, dict):
                    raise ValueError("a quantized draft head narrower than the target vocab "
                                     "cannot be padded")
                params = {**params,
                          "embed": torch.nn.functional.pad(params["embed"], (0, 0, 0, pad)),
                          "lm_head": torch.nn.functional.pad(head, (0, pad))}
        layers = params["layers"]
        self.params = {**params, "layers": (unstack_layers(layers) if isinstance(layers, dict)
                                            else layers)}
        self.engine = engine
        self.B = engine.batch_slots
        self.max_len = engine.max_len
        self.cache = init_kv_cache(self.cfg, self.B, engine.max_len, device=engine.device)
        # host bookkeeping: context tokens already in the draft cache, and
        # the last (token, position) fed, which idle rows re-feed
        self._fed = [0] * self.B
        self._last = [(0, 0)] * self.B
        self._dead = [True] * self.B
        # the feed width covers a fully accepting round's delta (K + 1
        # emitted + the new cur) so the high-accept regime pays no catch-up
        self._dpad = max(8, k + 2)
        self.block_t = self._dpad

    def on_admit(self, slot, ids):
        n = len(ids)
        bucket = next((b for b in self.engine.prefill_buckets if n <= b), None)
        if bucket is None or n == 0:
            self._dead[slot] = True  # longer than every bucket: never drafts
            return
        toks = np.full((1, bucket), self.engine.pad_id, dtype=np.int32)
        toks[0, :n] = ids
        positions = np.arange(bucket, dtype=np.int32)[None, :]
        dev = self.engine.device
        prefill_row(self.params, self.cfg, self.cache, torch.from_numpy(toks).to(dev),
                    torch.from_numpy(positions).to(dev), slot, fresh=True)
        self._fed[slot] = n
        self._last[slot] = (int(ids[-1]), n - 1)
        self._dead[slot] = False

    def on_release(self, slot):
        self._fed[slot] = 0
        self._last[slot] = (0, 0)
        self._dead[slot] = True

    def draft_batch(self, ctxs, states, need, k):
        B = len(ctxs)
        toks = np.full((B, k), -1, dtype=np.int32)
        lens = np.zeros((B,), dtype=np.int32)
        rows = [b for b in range(B)
                if need[b] and ctxs[b] is not None and not self._dead[b]
                and len(ctxs[b]) + k + 1 < self.max_len]
        if not rows:
            return toks, lens
        dev = self.engine.device
        deltas = {b: ctxs[b][self._fed[b]:] for b in rows}
        state_t = torch.as_tensor(np.asarray(states, dtype=np.int32), device=dev)
        while True:
            blk_t = np.zeros((B, self._dpad), dtype=np.int32)
            blk_p = np.zeros((B, self._dpad), dtype=np.int32)
            last_idx = np.zeros((B,), dtype=np.int32)
            more = False
            for b in range(B):
                t0, p0 = self._last[b]
                seq = deltas[b][:self._dpad] if b in deltas else []
                if b in deltas:
                    deltas[b] = deltas[b][len(seq):]
                    more |= bool(deltas[b])
                base_p = p0 + 1
                for i in range(self._dpad):
                    if i < len(seq):
                        blk_t[b, i] = seq[i]
                        blk_p[b, i] = base_p + i
                    else:  # repeat the last real (token, position)
                        blk_t[b, i], blk_p[b, i] = ((seq[-1], base_p + len(seq) - 1) if seq
                                                    else (t0, p0))
                last_idx[b] = max(len(seq) - 1, 0)
                if seq:
                    self._fed[b] += len(seq)
                    self._last[b] = (int(seq[-1]), base_p + len(seq) - 1)
            d = _draft_model_block(
                self.params, self.cfg, self.cache, torch.from_numpy(blk_t).to(dev),
                torch.from_numpy(blk_p).to(dev), torch.from_numpy(last_idx).to(dev), state_t,
                self.engine.tables, 0 if more else k, self.max_len)
            if not more:
                break
        d_h = d.cpu().numpy()
        for b in rows:
            toks[b] = d_h[b]
            lens[b] = k
        return toks, lens


class ChainDrafter(Drafter):
    """First non-empty proposal wins, per row: grammar lookahead for the
    structural runs, prompt lookup for echoed content."""

    name = "chain"

    def __init__(self, drafters: list[Drafter]):
        if not drafters:
            raise ValueError("empty drafter chain")
        self.drafters = drafters
        self.name = "+".join(d.name for d in drafters)
        self.block_t = max(d.block_t for d in drafters)

    def on_admit(self, slot, ids):
        for d in self.drafters:
            d.on_admit(slot, ids)

    def on_release(self, slot):
        for d in self.drafters:
            d.on_release(slot)

    def draft_batch(self, ctxs, states, need, k):
        B = len(ctxs)
        toks = np.full((B, k), -1, dtype=np.int32)
        lens = np.zeros((B,), dtype=np.int32)
        remaining = np.array(need, dtype=bool)
        for d in self.drafters:
            if not remaining.any():
                break
            t, n = d.draft_batch(ctxs, states, remaining, k)
            fill = remaining & (n > 0)
            toks[fill] = t[fill]
            lens[fill] = n[fill]
            remaining &= ~fill
        return toks, lens


def build_drafter(cfg: SpecConfig, engine) -> Drafter:
    """``SPEC_DRAFTER`` name(s) -> a Drafter (a comma chain: first hit wins)."""
    out: list[Drafter] = []
    for name in (s.strip() for s in cfg.drafter.split(",")):
        if not name:
            continue
        if name == "fsm":
            out.append(FSMDrafter(engine.fsm))
        elif name == "prompt":
            out.append(PromptLookupDrafter())
        elif name == "model":
            out.append(DraftModelDrafter(engine, cfg.k))
        else:
            raise ValueError(f"unknown SPEC_DRAFTER {name!r} (fsm | prompt | model, "
                             "comma-chained)")
    if not out:
        raise ValueError(f"SPEC_DRAFTER {cfg.drafter!r} names no drafter")
    return out[0] if len(out) == 1 else ChainDrafter(out)


# ---------------------------------------------------------------- decoder


class SpecDecoder:
    """The per-engine speculative decoder, dense and paged.

    Keeps each slot's host context (prompt + emitted tokens, which the
    drafters read) and stands in for the chunk loop behind the engine's
    ``decode_chunk``: a chunk runs up to ``chunk_steps`` verify steps, each
    one (B, 1+K) target forward advancing every active row by 1..K+1 tokens,
    and each paying one combined readback (the drafters need the new cur and
    state). Each step first claims room for its 1 + K writes through the
    engine's layout hook ``_claim`` (a paged table grows; a slot whose claim
    fails truncates alone) and afterwards hands the actual frontiers to
    ``reconcile_coverage``; both are no-ops on the dense cache. Radix-hit
    admissions seed the drafters with the full cached ids. The verify
    steps' quality lanes accumulate on the device across the chunk."""

    def __init__(self, engine, cfg: SpecConfig, drafter: Drafter | None = None):
        self.engine = engine
        self.K = int(cfg.k)
        self.quality_lanes = bool(getattr(engine, "quality_lanes", False))
        self.paged = getattr(engine, "allocator", None) is not None
        self.drafter = drafter if drafter is not None else build_drafter(cfg, engine)
        check_spec_block(self.K, self.drafter.block_t, engine.device)
        B = engine.batch_slots
        self._ctx: list[list[int] | None] = [None] * B
        self._prompt_len = [0] * B
        self.draft_ms = 0.0  # host drafting time, all chunks
        self._drafted = 0
        self._accepted = 0
        self._steps = 0
        self._emitted = 0
        # per-slot accounting behind the draft-trace records
        self._slot_drafted = np.zeros((B,), np.int64)
        self._slot_accepted = np.zeros((B,), np.int64)
        self._slot_fwds = np.zeros((B,), np.int64)
        self._trace_path = cfg.trace_sink
        self._trace_lock = threading.Lock()
        # the generation fence: a warm restart bumps it, so a thread wedged
        # inside decode_chunk stops dispatching verify steps (each writes
        # the engine's KV) against the restarted engine
        self._gen = 0

    # ------------------------------------------------------------ hooks

    def on_admit(self, slot: int, ids: list[int]) -> None:
        self._ctx[slot] = list(ids)
        self._prompt_len[slot] = len(ids)
        self._slot_drafted[slot] = self._slot_accepted[slot] = self._slot_fwds[slot] = 0
        self.drafter.on_admit(slot, list(ids))

    def on_release(self, slot: int, ok: bool = True) -> None:
        ctx = self._ctx[slot]
        if ok and self._trace_path and ctx is not None and len(ctx) > self._prompt_len[slot]:
            self._trace_record(slot, ctx)
        self._ctx[slot] = None
        self._prompt_len[slot] = 0
        self.drafter.on_release(slot)

    def _trace_record(self, slot: int, ctx: list[int]) -> None:
        """Append one JSONL draft-trace record (cleanly released requests
        only: an errored stream is no training data)."""
        rec = {
            "plane": "paged" if self.paged else "dense",
            "drafter": self.drafter.name,
            "k": self.K,
            "prompt_ids": ctx[:self._prompt_len[slot]],
            "generated_ids": ctx[self._prompt_len[slot]:],
            "drafted": int(self._slot_drafted[slot]),
            "accepted": int(self._slot_accepted[slot]),
            "verify_steps": int(self._slot_fwds[slot]),
        }
        try:
            with self._trace_lock, open(self._trace_path, "a") as f:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        except OSError:  # tracing never fails serving
            return
        get_metrics().inc("spec.trace_records")

    def supersede(self) -> None:
        """Bump the generation fence: a verify loop in flight dispatches no
        further step."""
        self._gen += 1

    def reset(self) -> None:
        """The warm restart's hook: bump the generation fence, then drop
        every slot's host context and drafter state."""
        self.supersede()
        for b in range(self.engine.batch_slots):
            if self._ctx[b] is not None:
                self.on_release(b, ok=False)

    # ------------------------------------------------------------ chunk

    @torch.no_grad()
    def decode_chunk(self, cur, pos, fsm, active, nbytes, tokens_left, byte_budget: int,
                     chunk_steps: int):
        """The engine's ``decode_chunk`` for greedy constrained chunks.
        Returns what the plain chunk returns, as tensors on the engine's
        device: (emitted (B, W) int32, counts, eos, cur, pos, fsm, active,
        nbytes, tokens_left). Sets the engine's ``_last_fwds`` (verify
        steps), ``_last_poison`` (per-row fault codes) and the per-row
        readbacks ``_last_accepts`` / ``_last_row_fwds`` the batcher folds
        into per-request ``spec_accepted`` / ``forwards`` (with
        ``_last_row_drafted``, the cost ledger's rejected drafts), and
        ``_last_conf``, the chunk's quality lanes on the device (None with
        the lanes off)."""
        eng = self.engine
        dev = eng.device
        B, K = eng.batch_slots, self.K
        gen0 = self._gen
        # the chaos drill's one-shot mask rides the chunk's first verify step
        nan_inject = eng._take_nan_inject()
        head = torch.stack([cur, fsm, active.to(torch.int32)], dim=1).cpu().numpy()
        cur_h, fsm_h, act_h = head[:, 0], head[:, 1], head[:, 2].astype(bool)
        eos_total = (~act_h) & (cur_h == eng.eos_id)
        outs: list[list[int]] = [[] for _ in range(B)]
        fwds = drafted = accepted = 0
        draft_ms = 0.0
        row_fwds = np.zeros((B,), np.int64)
        row_accepts = np.zeros((B,), np.int64)
        row_drafted = np.zeros((B,), np.int64)
        poison_h = np.zeros((B,), np.int32)
        # the chunk's lanes, folded on the device (sums add, mins min)
        conf_acc = _conf_init(B, dev) if self.quality_lanes else None
        for _ in range(chunk_steps):
            if not act_h.any() or self._gen != gen0:
                break
            ctxs = [(self._ctx[b] + [int(cur_h[b])]) if act_h[b] and self._ctx[b] is not None
                    else None for b in range(B)]
            t0 = time.perf_counter()
            dtoks, dlen = self.drafter.draft_batch(ctxs, fsm_h, act_h, K)
            draft_ms += (time.perf_counter() - t0) * 1e3
            dlen = np.minimum(np.asarray(dlen, np.int32), K)
            if self._gen != gen0:
                # restarted while the drafters ran: stop before touching the
                # fresh allocator or launching into its pool
                break
            # claim this step's worst case (cur + K drafts) for live rows
            starved = eng._claim(1 + K, active=act_h)
            if starved:
                tokens_left = tokens_left.clone()
                tokens_left[starved] = 0
            (out, n, eosf, cur, pos, fsm, active, nbytes, tokens_left, a, dl,
             pois, conf) = verify_step(eng, cur, pos, fsm, active, nbytes, tokens_left,
                                       torch.from_numpy(np.ascontiguousarray(dtoks)).to(dev),
                                       torch.from_numpy(dlen).to(dev), byte_budget, K,
                                       eng.max_len,  # the paged tables span max_len too
                                       quality_lanes=self.quality_lanes,
                                       nan_inject=nan_inject)
            nan_inject = None
            if conf is not None:
                conf_acc = (conf_acc[0] + conf[0], torch.minimum(conf_acc[1], conf[1]),
                            conf_acc[2] + conf[2], conf_acc[3] + conf[3],
                            conf_acc[4] + conf[4])
            # one combined readback per verify step
            packed = torch.cat([out, torch.stack(
                [n, eosf.to(torch.int32), cur, fsm, active.to(torch.int32), a, dl, pois, pos],
                dim=1)], dim=1).cpu().numpy()
            n_h, eos_h, cur_h, fsm_h, act_new, a_h, dl_h, pois_h, pos_h = (
                packed[:, 1 + K + i] for i in range(9))
            if self._gen != gen0:
                break  # restarted mid-step: discard it, dispatch no more
            eng.reconcile_coverage(pos_h)
            prev_act, act_h = act_h, act_new.astype(bool)
            fwds += 1
            drafted += int(dl_h.sum())
            accepted += int(a_h.sum())
            row_fwds += prev_act
            row_accepts += a_h
            row_drafted += dl_h
            self._slot_fwds += prev_act
            self._slot_drafted += dl_h
            self._slot_accepted += a_h
            poison_h = np.maximum(poison_h, pois_h)
            for b in range(B):
                if n_h[b] > 0:
                    toks = [int(t) for t in packed[b, :n_h[b]]]
                    outs[b].extend(toks)
                    if self._ctx[b] is not None:
                        self._ctx[b].extend(toks)
            eos_total = eos_total | eos_h.astype(bool)

        width = max(1, max(len(o) for o in outs))
        out_arr = np.full((B, width), eng.pad_id, dtype=np.int32)
        for b, o in enumerate(outs):
            out_arr[b, :len(o)] = o
        n_arr = np.array([len(o) for o in outs], dtype=np.int32)

        self.draft_ms += draft_ms
        eng._last_draft_ms = draft_ms  # the step ledger's drafter carve
        eng._last_fwds = fwds
        eng._last_poison = torch.from_numpy(poison_h).to(dev)
        eng._last_accepts = row_accepts
        eng._last_row_fwds = row_fwds
        # the cost ledger's wasted-draft lane: (drafted - accepted) per row
        eng._last_row_drafted = row_drafted
        eng._last_conf = conf_acc
        self._steps += fwds
        self._drafted += drafted
        self._accepted += accepted
        self._emitted += int(n_arr.sum())
        if fwds:
            m = get_metrics()
            m.inc("spec.drafted_tokens", float(drafted))
            m.inc("spec.accepted_tokens", float(accepted))
            m.inc("spec.verify_steps", float(fwds))
            if self._drafted > 0:
                m.set_gauge("spec.accept_rate", self._accepted / self._drafted)
            if self._steps > 0:
                m.set_gauge("spec.tokens_per_step", self._emitted / self._steps)
        return (torch.from_numpy(out_arr).to(dev), torch.from_numpy(n_arr).to(dev),
                torch.from_numpy(eos_total).to(dev), cur, pos, fsm, active, nbytes, tokens_left)

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """Cumulative speculation counters."""
        return {
            "drafted": self._drafted,
            "accepted": self._accepted,
            "verify_steps": self._steps,
            "emitted": self._emitted,
            "accept_rate": self._accepted / self._drafted if self._drafted else 0.0,
            "tokens_per_step": self._emitted / self._steps if self._steps else 0.0,
        }
