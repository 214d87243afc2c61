"""Long-session planner: the ring prefill and the ordinary cached decode.

Port of ``tpu_voice_agent/serve/planner.py``. The planner keeps a session's
FULL transcript (every utterance and every plan) as model context:

- cold start / re-anchor: the whole transcript prefills through
  ``parallel.longctx.llama_sp_prefill`` (ring attention over the ``sp``
  mesh, K1 for every block), the KV emerging in the dense decode layout;
- warm turns: new utterances append through the cached
  ``models.llama.forward`` with ``attn_impl="torch"`` (O(new tokens)), as
  JAX's ``attn_impl="xla"``;
- decode: the engines' ``decode_loop``, grammar-constrained so plans always
  parse: K2 a T = 1 step, K3 a forced-chain block, K4 the grammar tail on
  CUDA tensors.

When a session outgrows its decode cache it re-anchors: one ring prefill of
the full transcript into the next context bucket. ``plan_many`` stacks the
sessions of one bucket into one batch (padded to a power of two with zero
caches) and restores each row's slot 0 afterwards: idle rows park their
writes there, and this cache is the session's persistent transcript.

Deliberate differences from the JAX module: the mesh is a list of devices
(``parallel.sp_mesh``) and the weights and caches live on its first
device; a parked session carries an explicit ``parked`` flag (on a CPU
planner its host copy and its live cache sit on the same device); the
RNG is a ``torch.Generator`` seeded ``seed + 1`` (the served paths are
greedy). JAX's ``kernels`` argument is not taken: on CUDA the attention
always runs the port's kernels, and the forced-chain tables go to a
single-session batch only (JAX's rule at its default ``kernels="xla"``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field, replace

import torch

from ..grammar.intent_grammar import build_intent_fsm
from ..models.llama import PRESETS, LlamaConfig, forward, init_params, unstack_layers
from ..parallel.longctx import llama_sp_prefill
from ..utils.tracing import get_metrics
from .engine import _first_token, byte_len_table_for, chunk_decode_loop


@dataclass
class PlannerSession:
    """One live session: transcript ids + its KV cache."""

    ids: list[int] = field(default_factory=list)  # full transcript tokens
    cache: dict | None = None  # (L, 1, S, nkv, hd) on the mesh's first device
    pos: int = 0  # next cache write slot (= len(ids) after anchoring)
    last_logits: torch.Tensor | None = None  # (1, V) at the transcript frontier
    anchors: int = 0  # how many ring re-anchor prefills this session has paid
    parked: bool = False  # cache and logits moved to host memory


class LongSessionPlanner:
    """Grammar-constrained planner over unbounded session transcripts.

    ``ctx_buckets`` are the decode-cache capacities, each divisible by the
    sp axis. A session lives in the smallest bucket that fits its
    transcript + generation headroom and re-anchors upward when it outgrows
    it. ``fast_forward`` (the forced-chain width) is off by default: it
    rewrites the model-visible token history and may part from the T = 1
    path at a later free choice."""

    def __init__(
        self,
        preset: str = "test-tiny",
        cfg: LlamaConfig | None = None,
        mesh: list | None = None,
        seed: int = 0,
        ctx_buckets: tuple[int, ...] = (1024, 2048, 4096, 8192),
        extend_buckets: tuple[int, ...] = (32, 128, 512),
        max_new_tokens: int = 256,
        fast_forward: int = 0,
        init_weights: bool = True,  # False: the caller loads weights next
    ):
        if not mesh:
            raise ValueError("LongSessionPlanner needs an sp mesh (parallel.sp_mesh)")
        self.mesh = list(mesh)
        self.sp = len(self.mesh)
        self.device = self.mesh[0]
        for b in ctx_buckets:
            if b % self.sp:
                raise ValueError(f"ctx bucket {b} not divisible by sp={self.sp}")
        self.ctx_buckets = tuple(sorted(ctx_buckets))
        self.extend_buckets = tuple(sorted(extend_buckets))
        self.max_new_tokens = max_new_tokens

        self.tokenizer, self.fsm = build_intent_fsm()
        base = cfg or PRESETS[preset]
        self.cfg = replace(base, vocab_size=self.tokenizer.vocab_size,
                           max_seq_len=self.ctx_buckets[-1])
        self.eos_id = int(self.tokenizer.eos_id)
        self.pad_id = int(self.tokenizer.pad_id)
        self.tables = self.fsm.device_tables(device=self.device)
        if fast_forward > 0:
            fft, ffl = self.fsm.forced_tables(fast_forward)
            self.tables_ff = self.tables._replace(
                ff_tokens=torch.from_numpy(fft).to(self.device),
                ff_len=torch.from_numpy(ffl).to(self.device))
        else:
            self.tables_ff = None
        self.byte_len_table = byte_len_table_for(self.tokenizer, self.cfg.vocab_size,
                                                 self.device)
        self.params = None
        if init_weights:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.load_params(init_params(self.cfg, gen, device=self.device))
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    def load_params(self, params: dict) -> None:
        """Install weights: a stacked-layer tree on the mesh's first device
        (as ``DecodeEngine.load_params``, the layers unstacked once)."""
        layers = params["layers"]
        self.params = {**params, "layers": (unstack_layers(layers)
                                            if isinstance(layers, dict) else layers)}

    # ------------------------------------------------------------ anchoring

    def _ctx_bucket(self, need: int) -> int:
        for b in self.ctx_buckets:
            if need <= b:
                return b
        raise ValueError(
            f"session needs {need} cache slots, max ctx bucket is "
            f"{self.ctx_buckets[-1]} — add sp devices or a larger bucket")

    def _anchor(self, sess: PlannerSession) -> None:
        """Ring-prefill the full transcript into a fresh decode cache (the
        whole bucket: pad slots carry pad_id and decode overwrites them)."""
        n = len(sess.ids)
        S = self._ctx_bucket(n + self.max_new_tokens)
        tokens = torch.full((1, S), self.pad_id, dtype=torch.int32)
        tokens[0, :n] = torch.tensor(sess.ids, dtype=torch.int32)
        last_logits, kv = llama_sp_prefill(
            self.params, self.cfg, tokens.to(self.device), self.mesh,
            torch.tensor([n - 1], device=self.device))
        sess.cache = kv
        sess.pos = n
        sess.last_logits = last_logits
        sess.anchors += 1

    # ------------------------------------------------------------ session API

    def start(self, transcript: str) -> PlannerSession:
        """Open a session from its initial transcript (cold start)."""
        sess = PlannerSession(ids=self.tokenizer.encode(transcript, bos=True))
        self._anchor(sess)
        return sess

    @torch.no_grad()
    def extend(self, sess: PlannerSession, text: str) -> None:
        """Append an utterance / result line (the warm path: a cached forward
        over only the new tokens). Re-anchors when the bucket cannot hold
        the growth."""
        new_ids = self.tokenizer.encode(text, bos=False)
        sess.ids.extend(new_ids)
        m = len(new_ids)
        S = sess.cache["k"].shape[2]
        bucket = next((b for b in self.extend_buckets if m <= b), None)
        if bucket is None or sess.pos + bucket + self.max_new_tokens > S:
            self._anchor(sess)  # outgrew the bucket: one ring prefill
            return
        tokens = torch.full((1, bucket), self.pad_id, dtype=torch.int32)
        tokens[0, :m] = torch.tensor(new_ids, dtype=torch.int32)
        positions = (sess.pos + torch.arange(bucket, dtype=torch.int32))[None]
        # writes the block's k/v in place at slots >= pos, which an undo
        # snapshot (its own pos) never reads
        logits, _ = forward(self.params, self.cfg, tokens.to(self.device),
                            positions.to(self.device), sess.cache, attn_impl="torch")
        sess.last_logits = logits[:, m - 1, :]
        sess.pos += m

    def session_bytes(self, sess: PlannerSession) -> int:
        """Device bytes this session's KV cache pins (k + v); 0 when parked."""
        if sess.cache is None or sess.parked:
            return 0
        k = sess.cache["k"]
        return 2 * k.numel() * k.element_size()

    def park(self, sess: PlannerSession) -> None:
        """Move the session's cache and frontier logits to host memory: its
        device footprint drops to zero, and resuming costs one upload, not a
        re-anchor prefill."""
        if sess.parked:
            return
        if sess.cache is not None:
            sess.cache = {k: v.to("cpu") for k, v in sess.cache.items()}
        if sess.last_logits is not None:
            sess.last_logits = sess.last_logits.to("cpu")
        sess.parked = True

    def unpark(self, sess: PlannerSession) -> None:
        """Re-upload a parked session's cache to the planner's device."""
        if not sess.parked:
            return
        if sess.cache is not None:
            sess.cache = {k: v.to(self.device) for k, v in sess.cache.items()}
        if sess.last_logits is not None:
            sess.last_logits = sess.last_logits.to(self.device)
        sess.parked = False

    def parked_bytes(self, sess: PlannerSession) -> int:
        """Host bytes a parked session's cache occupies."""
        if sess.cache is None or not sess.parked:
            return 0
        k = sess.cache["k"]
        return 2 * k.numel() * k.element_size()

    def plan(self, sess: PlannerSession, max_new_tokens: int | None = None,
             greedy: bool = True, temperature: float = 0.7,
             byte_budget: int = 3900) -> tuple[str, list[int]]:
        """Decode a grammar-valid intent plan at the session frontier; the
        generated tokens join the transcript."""
        return self.plan_many([sess], max_new_tokens=max_new_tokens, greedy=greedy,
                              temperature=temperature, byte_budget=byte_budget)[0]

    @torch.no_grad()
    def plan_many(self, sessions: list[PlannerSession],
                  max_new_tokens: int | None = None, greedy: bool = True,
                  temperature: float = 0.7,
                  byte_budget: int = 3900) -> list[tuple[str, list[int]]]:
        """Batched plan decode: the sessions of one context bucket share
        every decode step's weight read; buckets decode group by group."""
        for sess in sessions:
            if sess.last_logits is None:
                raise ValueError("no frontier logits: extend() the session before plan()")
        max_new = min(max_new_tokens or self.max_new_tokens, self.max_new_tokens)
        t0 = time.perf_counter()
        dev = self.device
        results: dict[int, tuple[str, list[int]]] = {}
        groups: dict[int, list[int]] = defaultdict(list)
        for i, sess in enumerate(sessions):
            groups[sess.cache["k"].shape[2]].append(i)

        for S, idxs in groups.items():
            B = len(idxs)
            # pad to a power of two; pad rows get ZERO caches (never a copy of
            # a real session's), start inactive and write only their own
            # slot 0; pos 1 keeps their attention window non-empty
            Bp = 1 << (B - 1).bit_length()
            pad = Bp - B
            k_parts = [sessions[i].cache["k"] for i in idxs]
            v_parts = [sessions[i].cache["v"] for i in idxs]
            last_parts = [sessions[i].last_logits for i in idxs]
            if pad:
                k_parts += [torch.zeros_like(k_parts[0])] * pad
                v_parts += [torch.zeros_like(v_parts[0])] * pad
                last_parts += [torch.zeros_like(last_parts[0])] * pad
            cache = {"k": torch.cat(k_parts, dim=1), "v": torch.cat(v_parts, dim=1)}
            last = torch.cat(last_parts, dim=0)
            pos0 = torch.tensor([sessions[i].pos for i in idxs] + [1] * pad,
                                dtype=torch.int32, device=dev)
            state0 = torch.full((Bp,), self.fsm.start, dtype=torch.int32, device=dev)
            tok0, fsm0 = _first_token(last, state0, self.tables, self._gen, temperature,
                                      greedy, True)
            live = torch.arange(Bp, device=dev) < B
            # idle rows park their writes at slot 0 of their own line: save
            # every row's slot 0 and restore it after the loop, or a row
            # that ends early loses its first transcript token's k/v
            slot0_k = cache["k"][:, :, 0].clone()
            slot0_v = cache["v"][:, :, 0].clone()
            # the forced-chain tables for a single session only, as JAX's
            # rule at kernels="xla" (tpu_voice_agent/serve/planner.py:307)
            tables = self.tables_ff if Bp == 1 and self.tables_ff is not None else self.tables

            def step(tokens, positions, active, cache=cache):
                return forward(self.params, self.cfg, tokens, positions, cache)[0]

            out, count, _eos, _cur, pos, *_ = chunk_decode_loop(
                step, S, tok0, pos0, fsm0, live & (tok0 != self.eos_id),
                torch.zeros((Bp,), dtype=torch.int32, device=dev),
                torch.full((Bp,), max_new, dtype=torch.int32, device=dev),
                tables, self.byte_len_table, self._gen, temperature, byte_budget,
                chunk_steps=max_new, greedy=greedy, constrained=True,
                eos_id=self.eos_id, pad_id=self.pad_id)
            cache["k"][:, :, 0] = slot0_k
            cache["v"][:, :, 0] = slot0_v
            out_h, count_h, pos_h = out.cpu(), count.cpu(), pos.cpu()
            for j, i in enumerate(idxs):
                sess = sessions[i]
                out_ids = [int(t) for t in out_h[j, : int(count_h[j])]]
                if Bp == 1:
                    sess.cache = cache
                else:  # own storage: the batch (and its pad rows) is freed
                    sess.cache = {k: v[:, j: j + 1].clone() for k, v in cache.items()}
                sess.ids.extend(out_ids)
                sess.pos = int(pos_h[j])
                sess.last_logits = None  # frontier consumed; the next turn extends
                results[i] = (self.tokenizer.decode(out_ids), out_ids)

        m = get_metrics()
        m.inc("planner.plans", float(len(sessions)))
        if len(sessions) > 1:
            m.inc("planner.batched_plans")
        m.observe_ms("planner.plan", (time.perf_counter() - t0) * 1e3)
        return [results[i] for i in range(len(sessions))]

