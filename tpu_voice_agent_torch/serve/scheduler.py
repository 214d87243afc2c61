"""Continuous batching: slot-based, over one engine's model and KV layout.

Port of the core of ``tpu_voice_agent/serve/scheduler.py``
``ContinuousBatcher``. The engine holds ``batch_slots`` independent
sequences; a new request prefills into a free slot only (cost independent of
batch width, the shared prefix reused), and decode advances every active
slot together in chunks of ``chunk_steps`` steps, with one host readback per
chunk. New arrivals join at chunk boundaries.

Containment at the chunk boundaries: ``PoolExhausted`` at admission requeues
the request at the head (after ``SCHED_REQUEUE_MAX`` head retries it rotates
to the back) and sheds it with ``"shed: ..."`` once no live slot can free
blocks or ``SCHED_POOL_WAIT_S`` has passed; any other admission error fails
that request alone; a row the decode loop poisoned (non-finite logits, dead
grammar state) is evicted with ``"poisoned: ..."``. A CUDA runtime fault is
never per-request: it propagates out of ``step``.

Each slot keeps the engine's per-row quality lanes across chunks (folded on
the host from the chunk's one readback, reset at admission) and a finished
request carries ``quality=conf_summary(...)``. The ``scheduler.*`` counters,
gauges and histograms of these features are JAX's, and each chunk exports
the paged pool's and the radix tree's gauges.

Left for later: deadlines and cancellation, the quarantine list and chaos
drills, tenancy, the cost meter, the step ledger, prefix feeds and exports,
chunked admissions.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.quality import conf_summary
from ..utils.tracing import get_metrics
from .engine import GenerationResult, _first_token
from .paged import PoolExhausted, record_pool_gauges
from .radix import record_radix_gauges


def is_device_fault(e: BaseException) -> bool:
    """A CUDA runtime error (or a refused kernel launch): the engine's
    device state may be corrupt, so it must never be handled per request."""
    accel = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                              getattr(torch.cuda, "CudaError", None),
                              torch.cuda.OutOfMemoryError) if isinstance(t, type))
    if isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and ("CUDA error" in str(e) or "cudaError" in str(e))


def _err_result(error: str, steps: int = 0, prefill_ms: float = 0.0) -> GenerationResult:
    """The one spelling of a typed per-request failure. ``shed:`` prefixes
    a retryable overload; ``poisoned:`` a fault of this request's row."""
    return GenerationResult(text="", token_ids=[], prefill_ms=prefill_ms, decode_ms=0.0,
                            steps=steps, finished=False, error=error)


@dataclass
class _Slot:
    request_id: int = -1
    token_ids: list = field(default_factory=list)
    start_s: float = 0.0
    prefill_ms: float = 0.0  # computed prefill only (cached KV costs no forward)
    prompt_len: int = 0
    cached_tokens: int = 0  # prompt tokens served from cached KV at admission
    forwards: int = 0  # verify steps this request rode (speculation only)
    spec_accepts: int = 0  # draft tokens its verify steps accepted
    # the quality lanes folded across chunks (margin_min starts at +inf)
    conf_msum: float = 0.0
    conf_mmin: float = float("inf")
    conf_esum: float = 0.0
    conf_forced: int = 0
    conf_cnt: int = 0


class ContinuousBatcher:
    """Slot-based continuous batching over a ``DecodeEngine`` (dense or
    paged). Synchronous core: ``submit`` / ``step`` / ``run_until_done``;
    a service drives ``step`` from one thread."""

    def __init__(self, engine, chunk_steps: int = 32, greedy: bool = True,
                 temperature: float = 0.7, byte_budget: int = 3900,
                 max_new_tokens: int = 512, seed: int = 1234):
        self.engine = engine
        self.B = engine.batch_slots
        self.chunk_steps = chunk_steps
        self.greedy = greedy
        self.temperature = temperature
        self.byte_budget = byte_budget
        self.max_new_tokens = max_new_tokens
        dev = engine.device
        i32 = dict(dtype=torch.int32, device=dev)
        # device-resident per-slot state; idle rows sit at max_len - 1
        self.cur = torch.full((self.B,), engine.pad_id, **i32)
        self.pos = torch.full((self.B,), engine.max_len - 1, **i32)
        self.fsm = torch.zeros((self.B,), **i32)
        self.active = torch.zeros((self.B,), dtype=torch.bool, device=dev)
        self.nbytes = torch.zeros((self.B,), **i32)
        self.tokens_left = torch.zeros((self.B,), **i32)
        self.generator = torch.Generator(device=dev).manual_seed(seed)

        self.slots = [_Slot() for _ in range(self.B)]
        self.pending: list[tuple[int, object]] = []
        self.results: dict[int, GenerationResult] = {}
        self._next_id = 0
        self._enqueued_at: dict[int, float] = {}
        # host mirror of `active`: admission never reads the device
        self._active_h = np.zeros((self.B,), dtype=bool)
        self._pool_wait: dict[int, float] = {}
        self._pool_wait_s = float(os.environ.get("SCHED_POOL_WAIT_S", "1.0"))
        self._requeues: dict[int, int] = {}
        self._requeue_max = int(os.environ.get("SCHED_REQUEUE_MAX", "8"))
        self.chunks = 0
        self.tokens_generated = 0
        self.forwards = 0
        self._tps_ema = 0.0
        # the contract counters exist from construction, at zero
        m = get_metrics()
        m.inc("scheduler.slots_quarantined", 0.0)
        m.inc("scheduler.requeue_rotations", 0.0)

    # ------------------------------------------------------------ submit

    def submit(self, prompt) -> int:
        """Queue one request: a prompt string, or pre-tokenized ids (the
        session-aware parser's turn N is turn N-1's ids + generated ids +
        the new frame's ids, a strict token extension the radix tree
        matches)."""
        rid = self._next_id
        self._next_id += 1
        self._enqueued_at[rid] = time.perf_counter()
        self.pending.append((rid, prompt))
        return rid

    def cancel(self, rid: int) -> bool:
        """Drop a request that is still queued. True if it was; a request
        already in a slot decodes on and its result is left for the
        caller."""
        n = len(self.pending)
        self.pending = [(r, p) for r, p in self.pending if r != rid]
        if len(self.pending) == n:
            return False
        self._cleanup(rid)
        return True

    def _free_slot(self, act: np.ndarray) -> int | None:
        for b in range(self.B):
            if not act[b] and self.slots[b].request_id < 0:
                return b
        return None

    def _cleanup(self, rid: int) -> None:
        self._enqueued_at.pop(rid, None)
        self._pool_wait.pop(rid, None)
        self._requeues.pop(rid, None)

    def _admit(self, slot: int, rid: int, prompt) -> None:
        """Prefill ONE slot (reusing the engine's cached prefix or radix
        chain), then the first grammar-masked pick and the slot's device
        state."""
        eng = self.engine
        t0 = time.perf_counter()
        ids = (eng.tokenizer.encode(prompt, bos=True) if isinstance(prompt, str)
               else [int(t) for t in prompt])
        last_logits = eng.prefill_slot(ids, slot)
        self._finish_admission(slot, rid, len(ids), last_logits, t0)

    def _finish_admission(self, slot: int, rid: int, n: int, last_logits, t0: float) -> None:
        eng = self.engine
        start = torch.full((1,), eng.fsm.start, dtype=torch.int32, device=eng.device)
        tok0, fsm0 = _first_token(last_logits, start, eng.tables, self.generator,
                                  self.temperature, self.greedy, True)
        self.cur[slot] = tok0[0]
        self.fsm[slot] = fsm0[0]
        self.pos[slot] = n
        self.nbytes[slot] = 0
        self.tokens_left[slot] = self.max_new_tokens
        self.active[slot] = True
        sl = self.slots[slot]
        sl.request_id = rid
        sl.token_ids = []
        # fresh lanes: a re-admitted slot (or a requeued request) never
        # carries an earlier admission's
        sl.conf_msum, sl.conf_mmin, sl.conf_esum = 0.0, float("inf"), 0.0
        sl.conf_forced = sl.conf_cnt = 0
        sl.start_s = t0
        sl.prompt_len = n
        sl.prefill_ms = eng._last_prefill_compute_ms
        sl.cached_tokens = int(eng._last_cached_tokens)
        # TTFT: enqueue through the first sampled token, queue wait included
        t_enq = self._enqueued_at.pop(rid, t0)
        get_metrics().observe_ms("scheduler.ttft", (time.perf_counter() - t_enq) * 1e3)

    def _release_quietly(self, slot: int) -> None:
        """Best-effort cleanup of a failed admission's partial state."""
        try:
            self.engine.release_slot(slot, ok=False)
        except Exception as e:  # noqa: BLE001 - the admission error is the one reported
            if is_device_fault(e):
                raise

    # ------------------------------------------------------------ step

    def _admit_pending(self, act: np.ndarray) -> None:
        while self.pending:
            slot = self._free_slot(act)
            if slot is None:
                return
            rid, prompt = self.pending.pop(0)
            try:
                self._admit(slot, rid, prompt)
            except PoolExhausted as e:
                self._release_quietly(slot)
                first = self._pool_wait.setdefault(rid, time.perf_counter())
                if not act.any() or time.perf_counter() - first >= self._pool_wait_s:
                    # nothing live can free blocks, or the wait budget is spent
                    self.results[rid] = _err_result(f"shed: {e}")
                    get_metrics().inc("scheduler.shed_pool")
                    self._cleanup(rid)
                    continue
                n_req = self._requeues.get(rid, 0) + 1
                if n_req > self._requeue_max and self.pending:
                    # an oversized head waiter rotates to the back so the
                    # requests behind it get their attempt
                    self._requeues[rid] = 0
                    self.pending.append((rid, prompt))
                    get_metrics().inc("scheduler.requeue_rotations")
                else:
                    self._requeues[rid] = n_req
                    self.pending.insert(0, (rid, prompt))
                return  # let the live batch drain blocks
            except Exception as e:
                if is_device_fault(e):
                    raise
                self._release_quietly(slot)
                self.results[rid] = _err_result(str(e))
                if not isinstance(e, ValueError):  # a prompt too long is no fault
                    get_metrics().inc("scheduler.prefill_faults")
                self._cleanup(rid)
                continue
            self._pool_wait.pop(rid, None)
            self._requeues.pop(rid, None)
            act[slot] = True

    def step(self) -> None:
        """Admit pending requests into free slots, then run one chunk."""
        act = self._active_h
        self._admit_pending(act)
        if not act.any():
            return
        eng = self.engine
        t_chunk0 = time.perf_counter()
        # stale-readback fence: only a speculative chunk publishes per-row
        # accept / participation counts, and a plain chunk must not re-serve
        # an earlier one's
        eng._last_accepts = None
        eng._last_row_fwds = None
        (out, n, eos, cur, pos, fsm, active, nbytes, tokens_left) = eng.decode_chunk(
            self.cur, self.pos, self.fsm, self.active, self.nbytes, self.tokens_left,
            self.generator, self.temperature, self.byte_budget, self.chunk_steps, self.greedy)
        # one host readback for everything the host needs this chunk: the
        # quality lanes ride it as float32 columns (the int lanes are counts
        # far below 2**24, exact in float32)
        cols = [n, active.to(torch.int32), eos.to(torch.int32), pos, eng._last_poison]
        ints = torch.cat([out, torch.stack(cols, dim=1)], dim=1)
        conf = eng._last_conf
        if conf is not None:
            lanes = torch.stack([conf[0], conf[1], conf[2], conf[3].float(), conf[4].float()],
                                dim=1)
            packed = torch.cat([ints.float(), lanes], dim=1).cpu().numpy()
        else:
            packed = ints.cpu().numpy()
        cap = out.shape[1]
        out_h = packed[:, :cap].astype(np.int64)
        n_h, act_h, eos_h, pos_h, pois_h = (packed[:, cap + i].astype(np.int64)
                                            for i in range(5))
        conf_arr = None if conf is None else [packed[:, cap + 5 + i] for i in range(5)]
        act_h = act_h.astype(bool)
        (self.cur, self.pos, self.fsm, self.active, self.nbytes,
         self.tokens_left) = cur, pos, fsm, active, nbytes, tokens_left
        self._active_h = act_h.copy()
        eng.reconcile_coverage(pos_h)
        self.chunks += 1
        self.tokens_generated += int(n_h.sum())
        self.forwards += int(eng._last_fwds)
        row_fwds, row_accepts = eng._last_row_fwds, eng._last_accepts
        self._record_chunk_gauges(n_h, act_h, int(eng._last_fwds), t_chunk0)

        for b in range(self.B):
            sl = self.slots[b]
            if sl.request_id < 0:
                continue
            if int(pois_h[b]) > 0:
                # the loop fenced this row off mid-chunk without touching
                # batch-mates: fail the request, free its KV without caching
                reason = "non-finite logits" if int(pois_h[b]) == 1 else "grammar dead state"
                self.results[sl.request_id] = _err_result(
                    f"poisoned: {reason}", steps=len(sl.token_ids), prefill_ms=sl.prefill_ms)
                self._evict(b)
                continue
            sl.token_ids.extend(int(t) for t in out_h[b, :n_h[b]])
            if row_fwds is not None:
                sl.forwards += int(row_fwds[b])
                sl.spec_accepts += int(row_accepts[b])
            if conf_arr is not None:
                sl.conf_msum += float(conf_arr[0][b])
                sl.conf_mmin = min(sl.conf_mmin, float(conf_arr[1][b]))
                sl.conf_esum += float(conf_arr[2][b])
                sl.conf_forced += int(conf_arr[3][b])
                sl.conf_cnt += int(conf_arr[4][b])
            if not act_h[b]:
                # stopped this chunk: EOS, or a byte / token / length budget
                self.results[sl.request_id] = GenerationResult(
                    text=eng.tokenizer.decode(sl.token_ids), token_ids=list(sl.token_ids),
                    prefill_ms=sl.prefill_ms,
                    decode_ms=max(0.0, (time.perf_counter() - sl.start_s) * 1e3
                                  - sl.prefill_ms),
                    steps=len(sl.token_ids), finished=bool(eos_h[b]),
                    cached_tokens=sl.cached_tokens, prompt_tokens=sl.prompt_len,
                    forwards=sl.forwards, spec_accepted=sl.spec_accepts,
                    quality=conf_summary((sl.conf_msum, sl.conf_mmin, sl.conf_esum,
                                          sl.conf_forced, sl.conf_cnt), len(sl.token_ids)))
                m = get_metrics()
                m.inc("scheduler.requests_completed")
                m.observe_ms("scheduler.request_total", (time.perf_counter() - sl.start_s) * 1e3)
                self._cleanup(sl.request_id)
                self.slots[b] = _Slot()
                # with radix reuse on, release caches prompt + generated first
                eng.release_slot(b, generated_ids=sl.token_ids)

    def _record_chunk_gauges(self, n_h, act_h, fwds: int, t_chunk0: float) -> None:
        """The chunk's counters and the saturation gauges continuous batching
        is tuned by: backlog, occupancy, tokens per forward, throughput, and
        the paged pool's and radix tree's occupancy."""
        m = get_metrics()
        emitted = float(n_h.sum())
        m.inc("scheduler.tokens_generated", emitted)
        m.inc("scheduler.chunks")
        if fwds > 0:
            m.inc("scheduler.forwards", float(fwds))
            m.set_gauge("scheduler.tokens_per_forward", emitted / fwds)
        m.set_gauge("scheduler.queue_depth", len(self.pending))
        m.set_gauge("scheduler.active_slots", float(act_h.sum()))
        m.set_gauge("scheduler.batch_slots", float(self.B))
        m.set_gauge("scheduler.batch_occupancy", float(act_h.sum()) / self.B)
        chunk_s = time.perf_counter() - t_chunk0
        if chunk_s > 0:
            inst = emitted / chunk_s
            self._tps_ema = inst if self._tps_ema == 0.0 else 0.8 * self._tps_ema + 0.2 * inst
            m.set_gauge("scheduler.tokens_per_s", self._tps_ema)
        eng = self.engine
        if getattr(eng, "allocator", None) is not None:
            record_pool_gauges(eng.allocator, engine=eng)
        if getattr(eng, "radix", None) is not None:
            record_radix_gauges([eng.radix])

    def _evict(self, b: int) -> None:
        get_metrics().inc("scheduler.slots_quarantined")
        self._cleanup(self.slots[b].request_id)
        self.slots[b] = _Slot()
        self.active[b] = False
        self._active_h[b] = False
        self.engine.release_slot(b, ok=False)

    # ------------------------------------------------------------ drain

    def busy(self) -> bool:
        return bool(self.pending) or any(s.request_id >= 0 for s in self.slots)

    def run_until_done(self, max_chunks: int | None = None) -> None:
        if max_chunks is None:
            # worst case: every request decodes its whole token budget
            per_req = math.ceil(self.max_new_tokens / self.chunk_steps) + 1
            max_chunks = per_req * (len(self.pending) + self.B) + self.B
        for _ in range(max_chunks):
            if not self.busy():
                break
            self.step()

    def generate_many(self, prompts: list) -> list[GenerationResult]:
        ids = [self.submit(p) for p in prompts]
        self.run_until_done()
        return [self.results.pop(i, _err_result("scheduler gave up (chunk cap)")) for i in ids]
