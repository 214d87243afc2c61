"""Continuous batching: slot-based, over one engine's model and KV layout.

Port of the core of ``tpu_voice_agent/serve/scheduler.py``
``ContinuousBatcher``. The engine holds ``batch_slots`` independent
sequences; a new request prefills into a free slot only (cost independent of
batch width, the shared prefix reused), and decode advances every active
slot together in chunks of ``chunk_steps`` steps, with one host readback per
chunk. New arrivals join at chunk boundaries.

Containment at the chunk boundaries, with JAX's typed errors: a request
whose ``deadline`` (``services.resilience.Deadline``) ran out sheds at
dequeue (``"shed: deadline expired in queue"``) or is evicted between
chunks (``"cancelled: deadline expired mid-decode"``); ``cancel`` drops a
queued request or evicts a decoding one (``"cancelled: <reason>"``);
``PoolExhausted`` at admission requeues the request at the head (after
``SCHED_REQUEUE_MAX`` head retries it rotates to the back) and sheds it with
``"shed: ..."`` once no live slot can free blocks or ``SCHED_POOL_WAIT_S``
has passed; any other admission error fails that request alone; a row the
decode loop poisoned (non-finite logits, dead grammar state) is evicted
with ``"poisoned: ..."`` and freezes the flight recorder
(``scheduler.quarantine``). A prompt that poisons or breaks its admission
``QUARANTINE_AFTER`` times (default 2; a 64-entry LRU of fingerprints) is
refused at submit (``"quarantined: ..."``). An evicted slot releases with
``ok=False``: its chain never enters the radix tree. A CUDA runtime fault is
never per-request: it propagates out of ``step``. The chaos points
``nan_logits`` and ``dead_fsm`` arm at admission (``utils.chaos``).

``PREFILL_CHUNK_TOKENS`` = C (paged engines, which have
``begin_chunked_prefill``) admits a prompt longer than C in (1, C) pieces,
one per step, between the batch-mates' decode chunks; unset, or on the
dense engine, admission is the one barrier prefill. Each step records one
step-ledger entry (``utils.steplog``): admit, prefill, draft, decode,
readback and release tile its wall.

Each slot keeps the engine's per-row quality lanes across chunks (folded on
the host from the chunk's one readback, reset at admission) and a finished
request carries ``quality=conf_summary(...)``. The ``scheduler.*`` counters,
gauges and histograms of these features are JAX's, and each chunk exports
the paged pool's and the radix tree's gauges.

The cost meter (``COST_ENABLE``, default on; ``utils.costmodel``): each
admission folds its exact cached-vs-computed prefill split and each chunk
one per-row ledger (positions computed: a spec row's verify forwards plus
its drafts, else its emitted tokens; KV bytes; rejected drafts; KV
block-microseconds) into the slot's ledger and the meter's totals as the
same ints, so the finished requests' ``cost`` ledgers sum to the totals
exactly; the chunk's wall gives ``engine.mfu`` / ``engine.mbu``. Host
arithmetic on the chunk's one readback: tokens are the same on or off.

Tenancy (``TENANT_CLASSES``; ``serve.tenancy``): ``submit(tenant=)`` sheds a
rate-limited tenant with ``"shed: tenant <name> rate-limited"``, admission
picks the waiter of the poorest lane with slot headroom, each slot's radix
chains live in its tenant's namespace under the tenant's block quota, and
with ``TENANT_PREEMPT`` (default 1) a chunk boundary at which a poorer lane
waits with no slot free preempts one slot of the richest lane: its chain is
released warm into its namespace and its prompt requeued at the head, once
per request, so it resumes from the cache and finishes with the tokens it
would have had. Unset, nothing of it is built.

Prefill-only admissions (the brain's warm-state surface): ``feed_prefix``
prefills a prompt through a borrowed free slot and commits its chain to the
radix tree (a prefix feed: the eventual parse admits warm);
``prefill_export`` does the same in chunks of ``stream_blocks`` pool blocks
and hands each newly complete block run behind the compute frontier to
``emit`` as a packed ``kv_seg`` blob (the disagg KV stream). Both run on the
serving-loop thread, shed with JAX's reasons (``radix_off``, ``busy``,
``no_slot``, ``pool_exhausted``) and leave no block behind. The chaos point
``stall_step`` sleeps ``CHAOS_STALL_S`` (default 2.0) at the top of
``step``, before any launch; a step that wakes to a bumped epoch (the
watchdog's ``supersede``) returns without touching the engine, and one
superseded later stops at the engine's next launch (``Superseded``).
"""

from __future__ import annotations

import math
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.chaos import chaos_fire
from ..utils.costmodel import CostMeter, cost_enabled
from ..utils.hbmledger import record_hbm_gauges
from ..utils.quality import conf_summary
from ..utils.steplog import get_steplog
from ..utils.tracing import get_flight_recorder, get_metrics, log_event
from .engine import GenerationResult, _first_token
from .paged import PoolExhausted, record_pool_gauges
from .radix import record_radix_gauges
from .tenancy import TenancyPlane, tenancy_enabled


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
    a retryable overload (the brain answers 503 + Retry-After);
    ``quarantined:`` / ``poisoned:`` / ``cancelled:`` are terminal for these
    bytes."""
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
    # the request's cost ledger (utils.costmodel.LEDGER_KEYS), set at
    # admission with the meter on; folded per chunk with the same ints as
    # the meter's totals
    cost: dict | None = None


class ContinuousBatcher:
    """Slot-based continuous batching over a ``DecodeEngine`` (dense or
    paged). Synchronous core: ``submit`` / ``step`` / ``run_until_done``;
    a service drives ``step`` and ``cancel`` from one thread."""

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
        # per-request deadlines: checked at dequeue and between chunks
        self._deadline: dict[int, object] = {}
        # repeat-offender quarantine: prompt fingerprint -> offence record
        self.quarantine_after = int(os.environ.get("QUARANTINE_AFTER", "2"))
        self._offenses: OrderedDict[object, dict] = OrderedDict()
        self._prompt_fp: dict[int, object] = {}
        # chaos-armed NaN slots, and the epoch a reset bumps: a step begun
        # before the reset discards its commit
        self._nan_slots: set[int] = set()
        self._epoch = 0
        # chunked admissions: slot -> (cursor, enqueue stamp); the slot is
        # reserved (request_id set, device row inactive)
        pc = os.environ.get("PREFILL_CHUNK_TOKENS")
        self._prefill_chunk = int(pc) if pc else 0
        self._admitting: dict[int, tuple[object, float]] = {}
        self.chunks = 0
        self.tokens_generated = 0
        self.forwards = 0
        self._tps_ema = 0.0
        # the contract counters exist from construction, at zero
        m = get_metrics()
        m.inc("scheduler.slots_quarantined", 0.0)
        m.inc("scheduler.cancelled", 0.0)
        m.inc("scheduler.shed_expired", 0.0)
        m.inc("scheduler.quarantine_rejected", 0.0)
        m.inc("scheduler.requeue_rotations", 0.0)
        if self._prefill_chunk:
            m.inc("prefill.chunked_admissions", 0.0)
            m.inc("prefill.chunks", 0.0)
        m.inc("prefill.feeds", 0.0)
        m.inc("prefill.feeds_committed", 0.0)
        m.inc("prefill.feeds_shed", 0.0)
        # the cost meter: host arithmetic over readbacks the chunk pays for
        self.costs: CostMeter | None = CostMeter(engine) if cost_enabled() else None
        # the tenancy plane, built only when TENANT_CLASSES is set
        self.tenancy: TenancyPlane | None = TenancyPlane() if tenancy_enabled() else None
        self._tenant: dict[int, str | None] = {}  # rid -> wire tenant tag
        self._prompt_src: dict[int, object] = {}  # rid -> prompt (the preemption requeue)
        self._preempted: dict[int, int] = {}  # rid -> preemptions
        self._preempt_on = os.environ.get("TENANT_PREEMPT", "1") != "0"
        if self.tenancy is not None:
            m.inc("tenant.throttled", 0.0)
            m.inc("tenant.preemptions", 0.0)
            if getattr(engine, "radix", None) is not None:
                engine.radix.ns_quota = self.tenancy.block_quota

    # ------------------------------------------------------------ submit

    def supersede(self) -> None:
        """The stall watchdog's fence, set from its own thread while a step
        may still run: the epoch goes up (the step commits nothing) and the
        engine refuses every launch until its ``warm_restart``. The full
        ``reset`` follows on the serving loop's next thread."""
        self._epoch += 1
        self.engine.supersede()

    def reset(self) -> None:
        """Abandon all queued and in-flight work. Bumps the epoch, so a step
        in flight discards its commit. The quarantine list survives."""
        self._epoch += 1
        self.pending.clear()
        self._enqueued_at.clear()
        self._deadline.clear()
        self._prompt_fp.clear()
        self._pool_wait.clear()
        self._nan_slots.clear()
        self._requeues.clear()
        self._admitting.clear()
        self._tenant.clear()
        self._prompt_src.clear()
        self._preempted.clear()
        if self.tenancy is not None:
            self.tenancy.reset_occupancy()
        self.results.clear()
        self.slots = [_Slot() for _ in range(self.B)]
        self.active = torch.zeros_like(self.active)
        self._active_h = np.zeros((self.B,), dtype=bool)
        for b in range(self.B):
            self.engine.release_slot(b, ok=False)

    def submit(self, prompt, deadline=None, tenant=None) -> int:
        """Queue one request: a prompt string, or pre-tokenized ids (the
        session-aware parser's turn N is turn N-1's ids + generated ids +
        the new frame's ids, a strict token extension the radix tree
        matches). ``deadline`` (``services.resilience.Deadline``) arms the
        shed at dequeue and the eviction between chunks. ``tenant`` names
        the request's lane under tenancy (ignored without it). A
        quarantined prompt, or a rate-limited tenant's, is refused here: its
        result is ready at once."""
        rid = self._next_id
        self._next_id += 1
        fp = self._fingerprint(prompt)
        off = self._offenses.get(fp)
        if off is not None and off["count"] >= self.quarantine_after:
            off["rejected"] += 1
            get_metrics().inc("scheduler.quarantine_rejected")
            self.results[rid] = _err_result(
                f"quarantined: {off['reason']} x{off['count']} (prompt {off['preview']!r})")
            return rid
        if self.tenancy is not None:
            if not self.tenancy.admit(tenant):
                get_metrics().inc("tenant.throttled")
                self.results[rid] = _err_result(
                    f"shed: tenant {self.tenancy.resolve(tenant)} rate-limited")
                return rid
            self._tenant[rid] = tenant
            self._prompt_src[rid] = prompt
            self.tenancy.on_queue(tenant)
        self._prompt_fp[rid] = fp
        if deadline is not None:
            self._deadline[rid] = deadline
        self._enqueued_at[rid] = time.perf_counter()
        self.pending.append((rid, prompt))
        return rid

    # ------------------------------------------------------------ containment

    @staticmethod
    def _fingerprint(prompt) -> object:
        return prompt if isinstance(prompt, str) else tuple(prompt)

    @staticmethod
    def _preview(prompt) -> str:
        return prompt[:60] if isinstance(prompt, str) else f"<{len(prompt)} token ids>"

    def _record_offense(self, rid: int, reason: str) -> None:
        """Count a poison event against the request's prompt fingerprint; at
        ``quarantine_after`` the fingerprint is refused at submit."""
        fp = self._prompt_fp.get(rid)
        if fp is None:
            return
        off = self._offenses.get(fp)
        if off is None:
            off = self._offenses[fp] = {"count": 0, "rejected": 0, "reason": reason,
                                        "preview": self._preview(fp)}
        off["count"] += 1
        off["reason"] = reason
        self._offenses.move_to_end(fp)
        while len(self._offenses) > 64:
            self._offenses.popitem(last=False)

    def quarantined(self) -> list[dict]:
        """The active quarantine entries (the brain's ``/health``)."""
        return [{"preview": off["preview"], "count": off["count"], "rejected": off["rejected"],
                 "reason": off["reason"]}
                for off in self._offenses.values() if off["count"] >= self.quarantine_after]

    def _cleanup(self, rid: int) -> None:
        """Drop every per-request map entry (terminal paths only)."""
        self._enqueued_at.pop(rid, None)
        self._deadline.pop(rid, None)
        self._prompt_fp.pop(rid, None)
        self._pool_wait.pop(rid, None)
        self._requeues.pop(rid, None)
        self._tenant.pop(rid, None)
        self._prompt_src.pop(rid, None)
        self._preempted.pop(rid, None)

    def _dequeued(self, rid: int, admitted: bool) -> None:
        """A waiter left the queue (admitted, shed or failed): its lane's
        occupancy follows."""
        if self.tenancy is not None:
            self.tenancy.on_dequeue(self._tenant.get(rid), admitted=admitted)

    def _evict_slot(self, b: int, error: str, counter: str) -> None:
        """Evict ONE in-flight slot with a typed error: deactivate its row,
        free its KV without caching its chain (``ok=False``), resolve the
        request. Batch-mates' rows are untouched."""
        sl = self.slots[b]
        rid = sl.request_id
        res = _err_result(error, steps=len(sl.token_ids), prefill_ms=sl.prefill_ms)
        # an evicted row still accounts what it spent: the ledger conserves
        res.cost = dict(sl.cost) if sl.cost is not None else None
        self.results[rid] = res
        get_metrics().inc(counter)
        if self.tenancy is not None:
            t = self._tenant.get(rid)
            self.tenancy.on_release(t)
            self.tenancy.fold_cost(t, res.cost)
        self._cleanup(rid)
        self.slots[b] = _Slot()
        self.active[b] = False
        self._active_h[b] = False
        self._nan_slots.discard(b)
        self._admitting.pop(b, None)  # a chunked admission drops its cursor
        self.engine.release_slot(b, ok=False)

    def cancel(self, rid: int, reason: str = "client gone") -> bool:
        """Cancel one request: a queued one is dropped, one in a slot is
        evicted (its slot and KV blocks freed at once, not decoded on). Runs
        on the thread that drives ``step``. True when the request was
        live."""
        for i, (r, _) in enumerate(self.pending):
            if r == rid:
                del self.pending[i]
                self.results[rid] = _err_result(f"cancelled: {reason}")
                get_metrics().inc("scheduler.cancelled")
                self._dequeued(rid, admitted=False)
                self._cleanup(rid)
                return True
        for b in range(self.B):
            if self.slots[b].request_id == rid:
                self._evict_slot(b, f"cancelled: {reason}", "scheduler.cancelled")
                return True
        return False

    def _preempt_slot(self, b: int) -> None:
        """Vacate ONE over-budget slot for a starved lane at a chunk
        boundary: its spent cost folds into its tenant's ledger, its prompt
        + generated chain is released warm (``ok``) into the tenant's radix
        namespace, and the original prompt requeues at the head. Greedy
        decoding is deterministic, so the re-admission, warm from that
        chain, replays the same stream: the result arrives late, not
        failed. One preemption per request (the caller's filter)."""
        sl = self.slots[b]
        rid = sl.request_id
        prompt = self._prompt_src.get(rid)
        if prompt is None:
            return  # no requeue source: leave the slot alone
        t = self._tenant.get(rid)
        self._preempted[rid] = self._preempted.get(rid, 0) + 1
        plane = self.tenancy
        plane.fold_cost(t, sl.cost)
        plane.on_release(t)
        plane.on_queue(t)
        plane.note_preemption(t)
        get_metrics().inc("tenant.preemptions")
        self.engine.release_slot(b, generated_ids=sl.token_ids)
        self.slots[b] = _Slot()
        self.active[b] = False
        self._active_h[b] = False
        self._nan_slots.discard(b)
        self._enqueued_at[rid] = time.perf_counter()
        self.pending.insert(0, (rid, prompt))

    def _maybe_preempt(self, act: np.ndarray) -> None:
        """Every slot busy while a poorer lane waits: preempt the richest
        lane's slot (at most one a step; see ``_preempt_slot``)."""
        plane = self.tenancy
        if plane is None or not self._preempt_on or not self.pending:
            return
        if self._free_slot(act) is not None:
            return
        victim = plane.over_budget_victim(
            [(b, self._tenant.get(sl.request_id)) for b, sl in enumerate(self.slots)
             if sl.request_id >= 0 and act[b] and sl.token_ids
             and self._preempted.get(sl.request_id, 0) < 1],
            [self._tenant.get(r) for r, _ in self.pending])
        if victim is not None:
            self._preempt_slot(victim)

    def _free_slot(self, act: np.ndarray) -> int | None:
        for b in range(self.B):
            if not act[b] and self.slots[b].request_id < 0:
                return b
        return None

    # ------------------------------------------------------------ admission

    def _admit(self, slot: int, rid: int, prompt) -> bool:
        """Prefill ONE slot (reusing the engine's cached prefix or radix
        chain), then the first grammar-masked pick and the slot's device
        state. Returns True when a chunked admission was started instead:
        the slot is reserved and ``_advance_admissions`` runs its pieces."""
        eng = self.engine
        if self.tenancy is not None and hasattr(eng, "set_slot_ns"):
            # the slot's chains live in its tenant's radix namespace
            eng.set_slot_ns(slot, self.tenancy.resolve(self._tenant.get(rid)))
        t0 = time.perf_counter()
        ids = (eng.tokenizer.encode(prompt, bos=True) if isinstance(prompt, str)
               else [int(t) for t in prompt])
        n = len(ids)
        C = self._prefill_chunk
        if C > 0 and n > C:
            begin = getattr(eng, "begin_chunked_prefill", None)
            if begin is not None:
                cursor = begin(ids, slot, C)
                if cursor is not None:
                    sl = self.slots[slot]
                    sl.request_id = rid
                    sl.token_ids = []
                    sl.start_s = t0
                    sl.prompt_len = n
                    # TTFT still covers the queue wait and every piece
                    self._admitting[slot] = (cursor, self._enqueued_at.pop(rid, t0))
                    get_metrics().inc("prefill.chunked_admissions")
                    return True
        last_logits = eng.prefill_slot(ids, slot)
        self._finish_admission(slot, rid, n, last_logits, t0, self._enqueued_at.pop(rid, t0))
        return False

    def _finish_admission(self, slot: int, rid: int, n: int, last_logits, t0: float,
                          t_enq: float) -> None:
        """The admission tail of one-shot and chunked prefills alike: the
        first grammar-masked pick, the slot's device state and bookkeeping,
        TTFT."""
        eng = self.engine
        start = torch.full((1,), eng.fsm.start, dtype=torch.int32, device=eng.device)
        t_fm = time.perf_counter()
        tok0, fsm0 = _first_token(last_logits, start, eng.tables, self.generator,
                                  self.temperature, self.greedy, True,
                                  **getattr(eng, "sample_kw", {}))
        # the host's dispatch of the one standalone mask -> pick tail (K4)
        get_metrics().set_gauge("engine.step.fused_mask_sample_ms",
                                (time.perf_counter() - t_fm) * 1e3)
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
        get_metrics().observe_ms("scheduler.ttft", (time.perf_counter() - t_enq) * 1e3)
        if self.costs is not None:
            # the prefill's exact cached-vs-computed partition of the cold
            # prompt's cost, into the slot's ledger and the totals alike
            computed, cached = self.costs.model.prefill_split(n, sl.cached_tokens)
            sl.cost = dict.fromkeys(("decode_flops", "decode_bytes", "wasted_draft_flops",
                                     "kv_block_us"), 0)
            sl.cost["prefill_flops"] = computed
            sl.cost["prefill_cached_flops"] = cached
            self.costs.fold_prefill(computed, cached, sl.prefill_ms)
        else:
            sl.cost = None

    def _arm_chaos(self, slot: int) -> None:
        """The admission's drills (no-ops with chaos off): NaN logits on the
        slot's next chunk, its FSM state forced dead."""
        if chaos_fire("nan_logits"):
            self._nan_slots.add(slot)
        if chaos_fire("dead_fsm"):
            self.fsm[slot] = -1

    def _advance_admissions(self, act: np.ndarray) -> tuple[int, int, float]:
        """Run one piece of every chunked admission. A slot whose final
        piece lands finishes admission and decodes in this step's chunk.
        Returns (completed, pieces run, their dispatch ms) for the ledger."""
        if not self._admitting:
            return 0, 0, 0.0
        m = get_metrics()
        eng = self.engine
        done, stepped, pf_ms = 0, 0, 0.0
        for slot in sorted(self._admitting):
            cursor, t_enq = self._admitting[slot]
            rid = self.slots[slot].request_id
            try:
                last_logits = eng.chunked_prefill_step(cursor)
            except Exception as e:
                if is_device_fault(e):
                    raise
                # the admission fails alone; its blocks free through eviction
                if not isinstance(e, ValueError):
                    self._record_offense(rid, f"prefill {type(e).__name__}")
                self._evict_slot(slot, str(e), "scheduler.prefill_faults")
                continue
            stepped += 1
            pf_ms += cursor.step_ms
            m.inc("prefill.chunks")
            if last_logits is None:
                continue
            self._admitting.pop(slot, None)
            sl = self.slots[slot]
            self._finish_admission(slot, rid, sl.prompt_len, last_logits, sl.start_s, t_enq)
            act[slot] = True
            done += 1
            self._arm_chaos(slot)  # as the one-shot admission arms
        return done, stepped, pf_ms

    def _release_quietly(self, slot: int) -> None:
        """Best-effort cleanup of a failed admission's partial state."""
        try:
            self.engine.release_slot(slot, ok=False)
        except Exception as e:  # noqa: BLE001 - the admission error is the one reported
            if is_device_fault(e):
                raise

    def _admit_pending(self, act: np.ndarray) -> tuple[int, int, float]:
        """Dequeue into free slots. Returns (admitted, attempted, the
        admissions' prefill ms) for the ledger."""
        m = get_metrics()
        n_admitted = n_attempted = 0
        prefill_ms = 0.0
        plane = self.tenancy
        while self.pending:
            slot = self._free_slot(act)
            if slot is None:
                break
            if plane is None:
                rid, prompt = self.pending.pop(0)
            else:
                # the poorest lane with slot headroom, FIFO within a lane
                idx = plane.pick([self._tenant.get(r) for r, _ in self.pending])
                if idx is None:
                    break  # every waiter's lane is at its slot cap
                rid, prompt = self.pending.pop(idx)
            n_attempted += 1
            dl = self._deadline.get(rid)
            if dl is not None and dl.expired:
                # the queue wait spent the budget: never occupy a slot
                self.results[rid] = _err_result("shed: deadline expired in queue")
                m.inc("scheduler.shed_expired")
                self._dequeued(rid, admitted=False)
                self._cleanup(rid)
                continue
            try:
                chunked = self._admit(slot, rid, prompt)
            except PoolExhausted as e:
                self._release_quietly(slot)
                first = self._pool_wait.setdefault(rid, time.perf_counter())
                if (not act.any() or time.perf_counter() - first >= self._pool_wait_s
                        or (dl is not None and dl.expired)):
                    # nothing live can free blocks, or the wait budget is spent
                    self.results[rid] = _err_result(f"shed: {e}")
                    m.inc("scheduler.shed_pool")
                    self._dequeued(rid, admitted=False)
                    self._cleanup(rid)
                    continue
                n_req = self._requeues.get(rid, 0) + 1
                if n_req > self._requeue_max and self.pending:
                    # an oversized head waiter rotates to the back so the
                    # requests behind it get their attempt
                    self._requeues[rid] = 0
                    self.pending.append((rid, prompt))
                    m.inc("scheduler.requeue_rotations")
                else:
                    self._requeues[rid] = n_req
                    self.pending.insert(0, (rid, prompt))
                break  # let the live batch drain blocks
            except Exception as e:
                if is_device_fault(e):
                    raise
                # a prompt too long, a tokenizer fault, an injected prefill
                # fault: fails alone; a non-ValueError counts an offence
                self._release_quietly(slot)
                self.results[rid] = _err_result(str(e))
                if not isinstance(e, ValueError):
                    m.inc("scheduler.prefill_faults")
                    self._record_offense(rid, f"prefill {type(e).__name__}")
                self._dequeued(rid, admitted=False)
                self._cleanup(rid)
                continue
            self._pool_wait.pop(rid, None)
            self._requeues.pop(rid, None)
            self._dequeued(rid, admitted=True)
            if not chunked:
                act[slot] = True
                n_admitted += 1
                prefill_ms += self.slots[slot].prefill_ms
                self._arm_chaos(slot)  # a chunked admission arms at its final piece
        return n_admitted, n_attempted, prefill_ms

    # ------------------------------------------------------------ feeds

    def _borrow_slot(self, tenant, shed_counter: str):
        """A free slot for a prefill-only admission, or the shed answer:
        live work always wins (``busy`` while requests wait, ``no_slot``
        while every slot is taken). Names the slot's tenant namespace."""
        eng = self.engine
        if getattr(eng, "radix", None) is None:
            return None, {"ok": False, "reason": "radix_off"}
        m = get_metrics()
        if self.pending:
            m.inc(shed_counter)
            return None, {"ok": False, "reason": "busy"}
        slot = self._free_slot(self._active_h)
        if slot is None:
            m.inc(shed_counter)
            return None, {"ok": False, "reason": "no_slot"}
        if self.tenancy is not None:
            eng.set_slot_ns(slot, self.tenancy.resolve(tenant))
        return slot, None

    def feed_prefix(self, prompt, tenant=None) -> dict:
        """Prefill-only admission (a prefix feed): prefill ``prompt``
        through a borrowed free slot, commit its chain to the radix tree
        and release, all in this call on the serving-loop thread. Each feed
        starts from the longest cached prefix (usually the last feed's), so
        an incremental feed costs its new tokens, and the eventual parse
        admits warm. Best-effort: sheds while live work waits, with no free
        slot, or on an exhausted pool. ``tenant`` salts the chain into its
        lane's namespace."""
        m = get_metrics()
        m.inc("prefill.feeds")
        eng = self.engine
        slot, shed = self._borrow_slot(tenant, "prefill.feeds_shed")
        if shed is not None:
            return shed
        ids = (eng.tokenizer.encode(prompt, bos=True) if isinstance(prompt, str)
               else [int(t) for t in prompt])
        try:
            eng.prefill_slot(ids, slot)
        except PoolExhausted:
            self._release_quietly(slot)
            m.inc("prefill.feeds_shed")
            return {"ok": False, "reason": "pool_exhausted"}
        except Exception as e:
            if is_device_fault(e):
                raise
            self._release_quietly(slot)
            return {"ok": False, "reason": f"{type(e).__name__}: {e}"}
        cached = int(getattr(eng, "_last_cached_tokens", 0))
        # generated_ids=[]: the release's radix insert adopts the fed
        # prompt's full blocks and frees the rest before this call returns
        eng.release_slot(slot, generated_ids=[], ok=True)
        m.inc("prefill.feeds_committed")
        return {"ok": True, "prompt_tokens": len(ids), "cached_tokens": cached}

    def prefill_export(self, prompt, *, stream_blocks: int = 4, emit=None, stream_id=None,
                       tenant=None) -> dict:
        """Prefill-only admission that exports the computed chain (the
        disagg KV stream): ``feed_prefix`` run in chunks of ``stream_blocks``
        pool blocks (``begin_chunked_prefill``); after each chunk every
        newly complete block behind the compute frontier goes to ``emit`` as
        one packed ``kv_seg`` blob (``serve.handoff.pack_kv_segment``), so
        the first segments ship while later chunks still compute. Shipping
        stops at ``(len(ids) - 1) // block_size`` blocks, the admission-side
        match limit. The chain then commits to the local tree too. Sheds as
        ``feed_prefix`` does; a shed or fault after segments went out leaves
        the receiver a torn stream, which its adopter commits partially.
        Serving-loop thread only."""
        from .handoff import pack_kv_segment

        m = get_metrics()
        m.inc("disagg.exports")
        eng = self.engine
        slot, shed = self._borrow_slot(tenant, "disagg.exports_shed")
        if shed is not None:
            if shed["reason"] == "radix_off":
                m.inc("disagg.exports_shed")
            return shed
        ids = (eng.tokenizer.encode(prompt, bos=True) if isinstance(prompt, str)
               else [int(t) for t in prompt])
        bs = eng.block_size
        ship_cap = (len(ids) - 1) // bs
        n_ship = max(1, int(stream_blocks))
        sent = len(eng._prefix_blocks)
        segments = 0

        def ship(upto: int, final: bool) -> None:
            nonlocal sent, segments
            upto = min(int(upto), ship_cap)
            if emit is None or upto <= sent or (not final and upto - sent < n_ship):
                return  # nothing new, or less than a segment's worth yet
            chain = eng.slot_chain_blocks(slot)
            emit(pack_kv_segment(eng, ids, chain[sent:upto], sent, stream_id=stream_id))
            m.inc("disagg.blocks_streamed", float(upto - sent))
            sent = upto
            segments += 1

        try:
            cur = eng.begin_chunked_prefill(ids, slot, n_ship * bs)
            if cur is None:
                eng.prefill_slot(ids, slot)  # mostly cached: one shot, one segment
            else:
                logits = None
                while logits is None:
                    logits = eng.chunked_prefill_step(cur)
                    ship((cur.P + min(cur.j * cur.C, len(cur.suffix))) // bs, final=False)
        except Exception as e:
            if is_device_fault(e):
                raise
            self._release_quietly(slot)
            m.inc("disagg.exports_shed")
            reason = "pool_exhausted" if isinstance(e, PoolExhausted) else \
                f"{type(e).__name__}: {e}"
            return {"ok": False, "reason": reason, "segments": segments}
        cached = int(getattr(eng, "_last_cached_tokens", 0))
        try:
            ship(ship_cap, final=True)
        except Exception:  # noqa: BLE001 - a dead sink is the receiver's torn stream
            pass
        eng.release_slot(slot, generated_ids=[], ok=True)
        return {"ok": True, "prompt_tokens": len(ids), "cached_tokens": cached,
                "chain_tokens": sent * bs, "segments": segments}

    # ------------------------------------------------------------ step

    def step(self) -> None:
        """Evict expired slots, admit pending requests into free slots,
        advance chunked admissions, then run one chunk."""
        epoch = self._epoch
        if chaos_fire("stall_step"):
            # the stalled-step watchdog's drill: sleep as if the dispatch
            # wedged. A bumped epoch on waking means the watchdog already
            # warm-restarted the engine: this step vanishes before it
            # launches anything
            time.sleep(float(os.environ.get("CHAOS_STALL_S", "").strip() or "2.0"))
            if epoch != self._epoch:
                return
        # the step ledger: one timer a step, lapped at each stage boundary
        # (perf_counter only; STEPLOG_ENABLE=0 records nothing)
        timer = get_steplog().timer()
        act = self._active_h
        for b in range(self.B):
            rid = self.slots[b].request_id
            if rid >= 0:
                dl = self._deadline.get(rid)
                if dl is not None and dl.expired:
                    self._evict_slot(b, "cancelled: deadline expired mid-decode",
                                     "scheduler.cancelled")
        self._maybe_preempt(act)
        n_admitted, n_attempted, admit_prefill_ms = self._admit_pending(act)
        adm_done, adm_stepped, adm_pf_ms = self._advance_admissions(act)
        n_admitted += adm_done
        n_attempted += adm_stepped
        timer.lap("admit")
        # the prefill compute was measured inside the admission segment
        timer.carve("admit", "prefill", admit_prefill_ms + adm_pf_ms)
        if not act.any():
            if n_attempted:
                # admissions were tried and none went live: still a step
                timer.finish(occupancy=0, tokens=0, admitted=n_admitted)
            return
        eng = self.engine
        if self._nan_slots:
            mask = np.zeros((self.B,), dtype=bool)
            mask[list(self._nan_slots)] = True
            eng._nan_inject = mask
            self._nan_slots.clear()
        t_chunk0 = time.perf_counter()
        occupancy = int(act.sum())
        # stale-readback fence: only a speculative chunk publishes per-row
        # accept / participation counts and a drafter share, and a plain
        # chunk must not re-serve an earlier one's
        eng._last_accepts = None
        eng._last_row_fwds = None
        eng._last_row_drafted = None
        eng._last_draft_ms = 0.0
        (out, n, eos, cur, pos, fsm, active, nbytes, tokens_left) = eng.decode_chunk(
            self.cur, self.pos, self.fsm, self.active, self.nbytes, self.tokens_left,
            self.generator, self.temperature, self.byte_budget, self.chunk_steps, self.greedy)
        timer.lap("decode")
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
        timer.lap("readback")
        if epoch != self._epoch:
            return  # a reset happened while this step was in flight
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
        chunk_s = self._record_chunk_gauges(n_h, act_h, int(eng._last_fwds), t_chunk0)
        plane = self.tenancy
        if plane is not None:
            plane.export_gauges()
        chunk_cost = [0, 0]  # the chunk's analytic FLOPs and KV bytes

        for b in range(self.B):
            sl = self.slots[b]
            if sl.request_id < 0 or b in self._admitting:
                # mid chunked admission: its row did not decode, the
                # readback holds nothing of it
                continue
            if plane is not None:
                # the lane's clock advances by the row's emitted tokens
                plane.charge(self._tenant.get(sl.request_id), int(n_h[b]))
            if self.costs is not None and sl.cost is not None:
                # before the poison branch: an evicted row's spent chunk
                # rides out on its error result
                self._fold_row_cost(b, sl, int(n_h[b]), int(pos_h[b]), chunk_s, chunk_cost)
            if int(pois_h[b]) > 0:
                # the loop fenced this row off mid-chunk without touching
                # batch-mates: count the offence, evict without caching, and
                # freeze the flight recorder
                reason = "non-finite logits" if int(pois_h[b]) == 1 else "grammar dead state"
                self._record_offense(sl.request_id, reason)
                self._evict_slot(b, f"poisoned: {reason}", "scheduler.slots_quarantined")
                get_flight_recorder().trigger("scheduler.quarantine", detail=reason)
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
                self.results[sl.request_id].cost = (dict(sl.cost) if sl.cost is not None
                                                    else None)
                m = get_metrics()
                m.inc("scheduler.requests_completed")
                total_ms = (time.perf_counter() - sl.start_s) * 1e3
                m.observe_ms("scheduler.request_total", total_ms)
                if plane is not None:
                    t = self._tenant.get(sl.request_id)
                    plane.on_release(t)
                    plane.fold_cost(t, sl.cost)
                    plane.observe_latency(t, total_ms)
                self._cleanup(sl.request_id)
                self.slots[b] = _Slot()
                # with radix reuse on, release caches prompt + generated first
                eng.release_slot(b, generated_ids=sl.token_ids)
        if self.costs is not None:
            # the chunk's analytic work against its wall: engine.mfu / mbu
            try:
                self.costs.chunk(chunk_cost[0], chunk_cost[1], int(eng._last_fwds), chunk_s)
            except Exception:  # noqa: BLE001 - metering never becomes a serving fault
                pass
        # everything after the readback is release; the drafter's host share
        # was measured inside decode
        timer.lap("release")
        timer.carve("decode", "draft", float(eng._last_draft_ms))
        timer.finish(occupancy=occupancy, tokens=int(n_h.sum()), admitted=n_admitted or None,
                     forwards=int(eng._last_fwds),
                     accepted=int(np.sum(row_accepts)) if row_accepts is not None else None)

    def _fold_row_cost(self, b: int, sl: _Slot, emitted: int, frontier: int, chunk_s: float,
                       chunk_cost: list) -> None:
        """One row's chunk ledger, folded into the slot's and the meter's
        with the same ints. Positions computed: a spec row's verify forwards
        plus its drafts (rejected ones included: the card did the work),
        else one per emitted token; KV held: the paged slot's owned + shared
        blocks, the dense slot's one line, for the chunk's wall."""
        eng, costs = self.engine, self.costs
        row_fwds = eng._last_row_fwds
        row_drafted = eng._last_row_drafted
        row_accepts = eng._last_accepts
        if row_fwds is not None and row_drafted is not None:
            positions = int(row_fwds[b]) + int(row_drafted[b])
        else:
            positions = emitted
        fl, by = costs.model.decode_row(positions, frontier)
        wasted = 0
        if row_drafted is not None and row_accepts is not None:
            w_pos = max(0, int(row_drafted[b]) - int(row_accepts[b]))
            if w_pos:
                wasted = costs.model.decode_row(w_pos, frontier)[0]
        owned = getattr(eng, "_slot_owned", None)
        blocks = len(owned[b]) + len(eng._slot_shared[b]) if owned is not None else 1
        kv_us = int(round(chunk_s * 1e6)) * blocks
        row = {"decode_flops": fl, "decode_bytes": by, "wasted_draft_flops": wasted,
               "kv_block_us": kv_us}
        for k, v in row.items():
            sl.cost[k] += v
        costs.fold_row(row)
        chunk_cost[0] += fl
        chunk_cost[1] += by

    def _record_chunk_gauges(self, n_h, act_h, fwds: int, t_chunk0: float) -> float:
        """The chunk's counters and the saturation gauges continuous batching
        is tuned by: backlog, occupancy, tokens per forward, throughput, and
        the paged pool's and radix tree's occupancy. Returns the chunk's
        wall in seconds."""
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
        # the device-memory ledger, throttled to HBM_LEDGER_S inside: a
        # drift is an alarm and a failed read is logged, never a step fault
        try:
            record_hbm_gauges(eng)
        except Exception as e:  # noqa: BLE001
            log_event("scheduler", "hbm_ledger_failed", error=repr(e)[:200])
        return chunk_s

    # ------------------------------------------------------------ drain

    def busy(self) -> bool:
        return bool(self.pending) or any(s.request_id >= 0 for s in self.slots)

    def run_until_done(self, max_chunks: int | None = None) -> None:
        if max_chunks is None:
            # worst case: every request decodes its whole token budget
            per_req = math.ceil(self.max_new_tokens / self.chunk_steps) + 1
            if self._prefill_chunk:
                # a chunked admission spends up to ceil(max_len / C) steps
                # on its pieces before its first decode chunk
                per_req += math.ceil(self.engine.max_len / self._prefill_chunk)
            if self.tenancy is not None:
                # a preempted request re-admits and may replay its budget once
                per_req *= 2
            max_chunks = per_req * (len(self.pending) + self.B) + self.B
        for _ in range(max_chunks):
            if not self.busy():
                break
            self.step()

    def generate_many(self, prompts: list) -> list[GenerationResult]:
        ids = [self.submit(p) for p in prompts]
        self.run_until_done()
        return [self.results.pop(i, _err_result("scheduler gave up (chunk cap)")) for i in ids]
