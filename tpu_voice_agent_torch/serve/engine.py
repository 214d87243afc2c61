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
serving loop's stall watchdog) rebuilds the KV cache, keeps the weights and
re-arms the compile sentinel's fence. The entry points carry JAX's
compile-sentinel sites (``engine.prefill_row``, ``_first_token``,
``_decode_step``, ``chunk_decode_loop``; ``utils.compilewatch``).
``supersede`` comes first: from it until ``warm_restart``, every prefill,
table claim and decode forward raises ``Superseded`` before it launches, so a
step still running past the watchdog stops at its next launch.
``DecodeEngine.from_hf`` (and so ``PagedDecodeEngine.from_hf``) serves an HF
checkpoint directory over its own tokenizer: the intent FSM is built at the
config's vocab width, where S·V is past the dense-mask limit, so greedy
constrained picks take the compressed two-gather row in torch, not K4, as in
JAX.

``DecodeEngine(mesh=...)`` (and ``from_hf(mesh=...)``) serves on a dp x tp
mesh (``parallel.mesh``): weights and the dense cache live as per-device
blocks laid out by JAX's placement plans, each dp group holds B / dp cache
lines, the forward is ``models.llama``'s tensor-parallel one with its
kernels launched per shard (``ops.sharded``), and the grammar tail runs K4
(K11 under speculation) per shard over tables replicated on every device.
The model vocab is padded to a tp multiple before the FSM is built; the
padded ids are grammar-dead and ``logit_mask`` keeps them unsampleable in
unconstrained decoding too (as it does a checkpoint's own padded ids).
``PPDecodeEngine`` (``serve.pp_engine``) is the pp x tp layout.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..grammar.fsm import DeviceFSM, fsm_advance, fsm_row
from ..grammar.intent_grammar import build_fsm_for, build_intent_fsm
from ..models.llama import (
    PRESETS,
    LlamaConfig,
    forward,
    init_kv_cache,
    init_params,
    quantize_params,
    stack_layers,
    unstack_layers,
)
from ..ops import masked_argmax_advance, sharded_masked_argmax_advance
from ..parallel.mesh import (
    Sharded,
    default_rules,
    kv_cache_shardings,
    param_shardings,
    place,
    place_tree,
    quantized_param_shardings,
    tree_row,
)
from ..utils.chaos import ChaosError, chaos_fire
from ..utils.compilewatch import get_compile_watcher, watch_compiles
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


_CKPT_TOKENIZERS: dict = {}


def checkpoint_tokenizer(model_dir: str):
    """The ``HFTokenizer`` of a checkpoint directory's ``tokenizer.json``,
    one object per file content (SHA-256 of its bytes): engines built over
    the same tokenizer share the object and so its multi-second FSM build
    (``grammar.build_fsm_for`` caches on the object)."""
    import hashlib
    import os

    from ..grammar.hf_tokenizer import load_hf_tokenizer

    path = os.path.join(model_dir, "tokenizer.json")
    with open(path, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()
    tok = _CKPT_TOKENIZERS.get(key)
    if tok is None:
        tok = _CKPT_TOKENIZERS[key] = load_hf_tokenizer(path)
    return tok


def pad_vocab(params: dict, vocab_size: int) -> dict:
    """A param tree with its embedding rows and lm_head columns padded with
    zeros up to ``vocab_size`` (a mesh engine's tp multiple); an int8 head
    pads q with 0 and s with 1, what quantizing a zero column gives. The
    padded ids are grammar-dead and masked out of unconstrained sampling."""
    import torch.nn.functional as F

    pad = vocab_size - params["embed"].shape[0]
    if pad <= 0:
        return params
    head = params["lm_head"]
    return {**params, "embed": F.pad(params["embed"], (0, 0, 0, pad)),
            "lm_head": ({"q": F.pad(head["q"], (0, pad)), "s": F.pad(head["s"], (0, pad),
                                                                     value=1.0)}
                        if isinstance(head, dict) else F.pad(head, (0, pad)))}


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
                         greedy: bool, constrained: bool, mesh_tables=None, logit_mask=None):
    """The one sampling block: grammar-mask logits, pick a token, advance
    the FSM. Greedy constrained decoding with a dense mask is ONE kernel
    (K4: mask + argmax + advance; on a mesh, ``mesh_tables`` = (mesh, mask,
    table, col_id) replicated, one K4 launch per shard over its rows);
    otherwise the compressed two-gather row. ``logit_mask`` ((V,) bool, or
    None) makes padded-vocab ids unsampleable. Sampling is Gumbel-max over
    ``torch.Generator`` noise (categorical sampling that never faults on a
    fully masked row)."""
    if constrained and greedy and tables.dense_mask is not None:
        if mesh_tables is not None:
            tok, nxt = sharded_masked_argmax_advance(mesh_tables[0], logits, fsm_state,
                                                     *mesh_tables[1:])
            return tok.full(logits.device), nxt.full(logits.device)
        return masked_argmax_advance(logits, fsm_state, tables.dense_mask, tables.table,
                                     tables.col_id)
    if logit_mask is not None:
        logits = torch.where(logit_mask[None, :], logits, float("-inf"))
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


# the prefill's first pick is the same block
_first_token = watch_compiles("engine._first_token")(_mask_sample_advance)


# margin of a forced decision (one legal token: the gap is +inf; the cap
# keeps windowed means finite and comparable across grammars)
QUALITY_MARGIN_CAP = 30.0


def _conf_stats(raw, state, tables: DeviceFSM, constrained: bool, logit_mask=None):
    """Masked-logit confidence of ONE sampling decision per row: the top1 -
    top2 margin of the masked logits, the entropy of the masked softmax, and
    the forced flag (the grammar leaves at most one legal token). The legal
    row is rebuilt from the FSM table at ``max(state, 0)`` (K4 never returns
    its masked logits), masked with -inf. Reads only: nothing feeds back
    into sampling."""
    lg = raw.float()
    if logit_mask is not None:
        lg = torch.where(logit_mask[None, :], lg, float("-inf"))
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


@watch_compiles("engine.prefill_row")
def prefill_row(params, cfg: LlamaConfig, cache: dict, tokens, positions, slot: int,
                fresh: bool = True):
    """Admission prefill for ONE batch slot, written in place into that
    slot's cache line. Returns logits (1, T, V)."""
    row = {"k": cache["k"][:, slot:slot + 1], "v": cache["v"][:, slot:slot + 1]}
    logits, _ = forward(params, cfg, tokens, positions, row, fresh_block=fresh)
    return logits


@watch_compiles("engine.prefill_row")
def _prefill_row_mesh(params, cfg: LlamaConfig, row: dict, tokens, positions, rules,
                      fresh: bool):
    """``prefill_row`` / ``prefill_row_with_prefix`` on a dp group: the
    forward over the slot's line views, logits (1, T, V)."""
    return forward(params, cfg, tokens, positions, row, fresh_block=fresh, rules=rules)[0]


@watch_compiles("engine.prefill_row_with_prefix")
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
                quality_lanes: bool = False, nan_inject=None, mesh_tables=None,
                logit_mask=None):
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
    ``mesh_tables`` / ``logit_mask``: ``_mask_sample_advance``'s.

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
                                                   greedy, constrained, mesh_tables, logit_mask)
            ok, poison = _poison_gate(raw, s_end, state_next, active, poison, constrained)
            if quality_lanes:
                # the decision at the chain's end, plus the emitted chain
                # tokens counted as forced (masked by active, not ok)
                mg, en, f1 = _conf_stats(raw, s_end, tables, constrained, logit_mask)
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
                                                   greedy, constrained, mesh_tables, logit_mask)
            ok, poison = _poison_gate(raw, state, state_next, active, poison, constrained)
            if quality_lanes:
                mg, en, f1 = _conf_stats(raw, state, tables, constrained, logit_mask)
                conf = _conf_accumulate(conf, ok, mg, en, f1)
            pos = torch.where(ok, pos + 1, pos)
        state = torch.where(ok, state_next, state)
        cur = torch.where(ok, nxt, cur)
        eos = eos | (ok & (cur == eos_id))
        stop = (cur == eos_id) | (nbytes >= byte_budget) | (pos >= max_pos - 1) | (left <= 0)
        active = ok & ~stop
        step += 1
    return (out[:, :cap], n, eos, cur, pos, state, active, nbytes, left, step, poison, conf)


# the dense engine's chunk loop under JAX's site name (the paged engine's
# is ``paged.paged_chunk_decode_loop``)
chunk_decode_loop = watch_compiles("engine.chunk_decode_loop")(decode_loop)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecodeEngine:
    """Grammar-constrained decode engine on one device or a dp x tp mesh:
    ``generate`` with one slot, or ``batch_slots`` dense cache lines behind
    the continuous batcher."""

    # the decode loop under this layout's compile-sentinel site
    _chunk_loop = staticmethod(chunk_decode_loop)

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
        tokenizer=None,  # a checkpoint tokenizer; None = the in-tree one
        fsm=None,  # a prebuilt grammar.TokenFSM over ``tokenizer``
        init_weights: bool = True,  # False: the caller loads weights next
        fast_forward: int = 0,  # grammar fast-forward chain width (0 = off)
        device: str | torch.device | None = None,  # None = cuda, or raise
        spec=None,  # serve.spec.SpecConfig | None: speculative decoding
        quality_lanes: bool | None = None,  # None: QUALITY_ENABLE (default on)
        mesh=None,  # parallel.mesh.Mesh with ("dp", "tp") axes (make_mesh)
    ):
        self.mesh = mesh
        if mesh is not None:
            first = mesh.devices.flat[0]
            if device is not None and torch.device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first device {first}")
            device = first
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
        base = cfg or PRESETS[preset]
        prebuilt = None
        if tokenizer is None:
            # the in-tree tokenizer: its vocab is the model vocab
            self.tokenizer, prebuilt = build_intent_fsm()
            vocab = self.tokenizer.vocab_size
        else:
            # a checkpoint tokenizer: the model vocab comes from the config
            # (embedding tables are often padded past the tokenizer) and the
            # grammar FSM is built over that width, its padded ids dead
            self.tokenizer = tokenizer
            vocab = base.vocab_size if cfg is not None else tokenizer.vocab_size
            if vocab < tokenizer.vocab_size:
                raise ValueError(
                    f"model vocab {vocab} < tokenizer vocab {tokenizer.vocab_size}")
        if mesh is not None:
            if base.moe_impl == "grouped":
                raise ValueError(
                    "moe_impl='grouped' is single-device; meshed MoE engines "
                    "use dense dispatch (EP shards experts over tp)")
            # lm_head splits the vocab over tp: pad it to a tp multiple
            # before the (multi-second) FSM build, at the final width
            tp = mesh.shape.get("tp", 1)
            vocab = -(-vocab // tp) * tp
        if fsm is not None:
            if fsm.vocab_size != vocab:
                raise ValueError(
                    f"custom fsm width {fsm.vocab_size} != model vocab {vocab} "
                    f"(mesh engines pad the vocab to a tp multiple; build it "
                    f"with grammar.build_fsm_for(tokenizer, vocab_size={vocab}))")
            self.fsm = fsm
        elif prebuilt is not None and prebuilt.vocab_size == vocab:
            self.fsm = prebuilt
        else:
            self.fsm = build_fsm_for(self.tokenizer, vocab_size=vocab)
        self.cfg = replace(base, vocab_size=vocab, max_seq_len=max_len)
        self.eos_id = int(self.tokenizer.eos_id)
        self.pad_id = int(self.tokenizer.pad_id)
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.prefill_buckets = tuple(b for b in prefill_buckets if b <= max_len)
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant
        self.params = None
        self.rules = None
        if mesh is not None:
            dp = mesh.shape.get("dp", 1)
            if batch_slots % dp != 0:
                raise ValueError(
                    f"batch_slots ({batch_slots}) must be divisible by the mesh dp axis "
                    f"({dp}); dp>1 shards the KV-cache batch dim. Use batch_slots=dp*k "
                    "(batched decode is driven by serve.scheduler).")
            self.rules = default_rules(mesh, self.cfg.n_kv_heads, self.cfg.n_heads)
            # one dp group's (1, tp) sub-mesh and rules: a slot's admission
            # runs on the group that holds its cache line
            self._group_rules = [default_rules(mesh.row(g), self.cfg.n_kv_heads,
                                               self.cfg.n_heads) for g in range(dp)]
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
        # ids past the tokenizer (mesh tp padding, a checkpoint's padded
        # embedding table) decode to nothing: unsampleable even unconstrained
        self.logit_mask = (torch.arange(self.cfg.vocab_size, device=self.device)
                           < self.tokenizer.vocab_size
                           if self.cfg.vocab_size > self.tokenizer.vocab_size else None)
        # the grammar tail's tables on every mesh device, placed once
        self.mesh_tables = None
        if mesh is not None and self.tables.dense_mask is not None:
            t = self.tables
            self.mesh_tables = (mesh, place(t.dense_mask, mesh, (None, None)),
                                place(t.table, mesh, (None, None)), place(t.col_id, mesh, (None,)))
        # what every sampling call of this engine passes along
        self.sample_kw = {"mesh_tables": self.mesh_tables, "logit_mask": self.logit_mask}
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
        holds a block pool instead); on a mesh, each device's
        (L, B / dp, S, nkv / tp, hd) block."""
        if self.mesh is not None:
            c = self.cfg
            shape = (c.n_layers, self.batch_slots, self.max_len, c.n_kv_heads, c.head_dim)
            return {name: Sharded.zeros(self.mesh, shape, spec, torch.bfloat16)
                    for name, spec in kv_cache_shardings(self.mesh, c.n_kv_heads).items()}
        return init_kv_cache(self.cfg, self.batch_slots, self.max_len, device=self.device)

    def load_params(self, params: dict) -> None:
        """Install weights (stacked-layer tree on this engine's device),
        applying the engine's quantization to a raw tree. On a mesh the
        (quantized) tree is laid out by JAX's placement plans (each leaf
        quantized whole, then q and s placed); a tree already laid out on
        this mesh, another engine's, is shared as it is."""
        if self.quant == "int8" and not isinstance(params.get("lm_head"), dict):
            params = quantize_params(params)
        layers = params["layers"]
        if self.mesh is not None:
            if not isinstance(params["embed"], Sharded):
                c = self.cfg
                plan = (quantized_param_shardings if self.quant == "int8" else param_shardings)(
                    self.mesh, c.n_kv_heads, c.n_experts)
                params = place_tree({**params, "layers": stack_layers(layers)}, self.mesh, plan)
                layers = params["layers"]
            elif params["embed"].mesh != self.mesh:
                raise ValueError("the tree is laid out on another mesh")
        self.params = {**params, "layers": (unstack_layers(layers)
                                            if isinstance(layers, dict) else layers)}
        if self.mesh is not None:
            self._group_params = [tree_row(self.params, g)
                                  for g in range(self.mesh.shape.get("dp", 1))]

    @classmethod
    def from_hf(
        cls,
        model_dir: str,
        max_len: int = 2048,
        batch_slots: int = 1,
        prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048),
        kernels: str = "auto",
        quant: str | None = None,
        dtype=torch.bfloat16,
        fast_forward: int = 0,
        moe_impl: str | None = None,  # "grouped": K13's dispatch on a Mixtral checkpoint
        device: str | torch.device | None = None,
        mesh=None,  # a dp x tp mesh: the vocab pads to a tp multiple
        **engine_kw,  # subclass knobs (PagedDecodeEngine: pool_blocks, ...)
    ) -> "DecodeEngine":
        """Serve an HF checkpoint directory: ``config.json`` decides the
        architecture, ``tokenizer.json`` supplies the BPE vocab the intent
        FSM is built over, ``*.safetensors`` the weights (checked against the
        config from the headers before anything is built, then read straight
        onto the engine's device; under ``quant="int8"`` one layer at a time).
        A classmethod, so ``PagedDecodeEngine.from_hf`` builds the paged
        engine through the same loader. On a mesh whose tp does not divide
        the checkpoint's vocab the engine pads it, and the embedding rows and
        lm_head columns are padded with zeros to match (int8: q 0, s 1, what
        quantizing a zero column gives)."""
        import os

        from ..ckpt.hf_import import (
            llama_config_from_hf,
            llama_from_hf_state,
            llama_hf_check,
            safetensors_shapes,
        )

        cfg = replace(llama_config_from_hf(os.path.join(model_dir, "config.json")),
                      max_seq_len=max_len)
        if moe_impl is not None:
            cfg = replace(cfg, moe_impl=moe_impl)
        llama_hf_check(safetensors_shapes(model_dir), cfg)
        eng = cls(cfg=cfg, max_len=max_len, batch_slots=batch_slots,
                  prefill_buckets=prefill_buckets, kernels=kernels, quant=quant,
                  tokenizer=checkpoint_tokenizer(model_dir), init_weights=False,
                  fast_forward=fast_forward, device=device, mesh=mesh, **engine_kw)
        params = llama_from_hf_state(model_dir, cfg, dtype=dtype, device=eng.device, quant=quant)
        eng.load_params(pad_vocab(params, eng.cfg.vocab_size))
        return eng

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
        return its KV (L, 1, P, nkv, hd). On a mesh dp group 0 computes it
        and every group gets a copy of its shards (``Sharded`` over the
        mesh, the batch axis replicated)."""
        if self.mesh is not None:
            c, sub = self.cfg, self.mesh.row(0)
            spec = kv_cache_shardings(self.mesh, c.n_kv_heads)["k"]
            shape = (c.n_layers, 1, bucket, c.n_kv_heads, c.head_dim)
            scratch = {n: Sharded.zeros(sub, shape, spec, torch.bfloat16) for n in ("k", "v")}
            forward(self._group_params[0], c, tokens, positions, scratch, fresh_block=True,
                    rules=self._group_rules[0])
            rep_spec = (None, None, None) + spec[3:]
            return {n: Sharded(self.mesh, rep_spec, (c.n_layers, 1, P) + shape[3:],
                               {co: t.local((0, co[1]))[:, :, :P].clone().to(
                                   self.mesh.device(co)) for co in self.mesh.coords()})
                    for n, t in scratch.items()}
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
        if self.mesh is not None:
            return self._prefill_mesh(tokens, positions, slot, fresh=False)
        return prefill_row_with_prefix(self.params, self.cfg, self.cache, self.prefix_kv["k"],
                                       self.prefix_kv["v"], tokens, positions, slot)

    def _prefill_full(self, tokens, positions, slot: int, bucket: int, n: int):
        """Layout hook: admit a fresh full prompt into ``slot``."""
        if self.mesh is not None:
            return self._prefill_mesh(tokens, positions, slot, fresh=True)
        return prefill_row(self.params, self.cfg, self.cache, tokens, positions, slot, fresh=True)

    def _prefill_mesh(self, tokens, positions, slot: int, fresh: bool):
        """A slot's admission on a mesh: its dp group's (1, tp) sub-mesh
        runs the forward over views of the slot's line in each tp block
        (the prefix KV copied in first, unless ``fresh``)."""
        per = self.batch_slots // self.mesh.shape.get("dp", 1)
        g, r = divmod(slot, per)
        row = {}
        for name, cache in self.cache.items():
            grp = cache.row(g)
            row[name] = Sharded(grp.mesh, grp.spec, (grp.shape[0], 1) + tuple(grp.shape[2:]),
                                {c: t[:, r:r + 1] for c, t in grp.shards.items()})
            if not fresh:
                pre = self.prefix_kv[name].row(g)
                for c, t in row[name].shards.items():
                    t[:, :, :pre.shape[2]] = pre.local(c)
        return _prefill_row_mesh(self._group_params[g], self.cfg, row, tokens, positions,
                                 self._group_rules[g], fresh)

    @watch_compiles("engine._decode_step")
    def _decode_step(self, tokens, positions, active):
        """Layout hook: one decode forward, k/v written in place (idle rows
        write slot 0 of their own line). Returns logits (B, T, V)."""
        self._fence()
        return forward(self.params, self.cfg, tokens, positions, self.cache, rules=self.rules)[0]

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
        (out, n, eos, cur, pos, fsm, active, nbytes, left, fwds, pois, conf) = self._chunk_loop(
            self._decode_step, self.max_len, cur, pos, fsm, active, nbytes, tokens_left,
            tables, self.byte_len_table, generator, temperature, byte_budget,
            chunk_steps=chunk_steps, greedy=greedy, constrained=True,
            eos_id=self.eos_id, pad_id=self.pad_id, quality_lanes=self.quality_lanes,
            nan_inject=self._take_nan_inject(), **self.sample_kw)
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
        The compile sentinel's fence is re-armed: the restart keeps every
        warmed shape, so a cold call after it is as suspect as any other
        after warm-up."""
        if self.cache is not None:
            self.cache = self._init_kv_cache()
        self._nan_inject = None
        if self.spec is not None:
            self.spec.reset()
        self._superseded = False
        get_compile_watcher().arm_fence("warm_restart")

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
                                  greedy, constrained, **self.sample_kw)
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
             conf) = self._chunk_loop(
                self._decode_step, self.max_len, *state,
                tables, self.byte_len_table, self._gen, temperature, byte_budget,
                chunk_steps=max_new_tokens, greedy=greedy, constrained=constrained,
                eos_id=self.eos_id, pad_id=self.pad_id, quality_lanes=self.quality_lanes,
                **self.sample_kw)
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
