"""The batched STT plane: one shared Whisper engine for every connection.

Port of ``tpu_voice_agent/serve/stt_batch.py`` (``STT_BATCH_ENABLE=1``).
The per-connection plane decodes each utterance at B = 1 behind one lock,
so STT capacity falls as 1/N while the card idles between tiny GEMVs. Here
connections submit transcription work and get futures back; one worker
takes each tick's queued items (at most ``slots``), encodes each at B = 1
and decodes all of them in ONE (S, ...) greedy loop, so every decoder step
reads the weights once for all streams and K5 runs at B = S.

- A slotted cross-KV pool (``models.whisper.init_cross_kv_pool``): each
  live utterance's incremental encoder state owns one slot of an (L, S,
  enc_positions, nh, hd) buffer; a slot's valid frames are a host-side
  ``enc_len``, the decode's per-row kv_len, so stale positions past it (an
  earlier utterance's) are never read.
- Work kinds follow the streaming events: ``partial`` (new blocks encoded
  into the slot, the decode over the slot), ``spec_final`` / ``final``
  (the full window re-encoded at B = 1 through ``SpeechEngine._encode_window``,
  transcribe's own path, padded to enc_positions so ragged buckets share
  one decode). Per row the batched output is the B = 1 path's: the same
  block encoder, the same decode loop, dead slots (``live`` False, kv_len
  0) done from the start. The tests hold that differentially on the CPU
  and ``chip_smoke.py``'s ``stt_batch`` phase on the card.
- Priority and coalescing: finals > spec_finals > partials, FIFO within a
  class; a newer partial (or spec_final) of the same utterance supersedes
  a queued one (``stt.partials_coalesced`` counts the partials).
- Admission: partials past the pending cap (4 x slots) or beyond the slot
  pool shed (``stt.shed_overload``); finals are never shed and need no
  slot.
- Tenancy (``TENANT_CLASSES``): the queue sorts by the tenant's
  ``FairLanes`` rank first, charged by audio seconds, then by priority.

``BatchedStreamingSTT`` is ``StreamingSTT`` with its four transcription
hooks overridden: the same host-side utterance state machine, but partials
and spec_finals are futures delivered by a later feed, and a final blocks
(``feed``) or is awaited (``feed_async``, the voice service's event loop).

The worker is the only thread that runs the model. A batcher is one
member of the replicated tier (``serve/stt_replicas.py``, ``STT_REPLICAS`` >
1): ``kill`` retires it like a crashed process (the ``dead`` latch; its
queued and in-flight futures fail, a later submit fails at once) and
``healthy`` is its liveness. The chaos points ``stt_replica_kill`` (the
worker kills its batcher as it takes a batch) and ``stt_replica_hang`` (it
sleeps ``CHAOS_HANG_S`` before the batch) are drawn here. A killed
batcher's worker starts no launch after the kill: it checks the latch before
each slot feed, each final's encode and each decode step (``Killed``), so a
worker that wakes from a hang, or was stalled inside its batch, stops there
and a warm restart's fresh batcher, with its own pool, does not share the
card with the corpse's work past the launch that was running.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import itertools
import os
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from ..models.whisper import init_cross_kv_pool, init_self_cache, pad_cross_kv
from ..utils.chaos import ChaosError, chaos_fire
from ..utils.tracing import get_metrics
from .stt import (
    SpeechEngine,
    StreamingSTT,
    TranscribeResult,
    _append_cross_kv,
    _stt_decode_loop,
    finalize_stt_ids,
)
from .tenancy import FairLanes, tenancy_enabled

# work-class priority: the utterance-carrying finals, then the speculative
# finals inside the endpoint window, then best-effort partials
_PRIORITY = {"final": 0, "spec_final": 1, "partial": 2}

# process-wide utterance keys: a late future can never be taken for the
# next utterance's
_UTT_IDS = itertools.count(1)


class Killed(BaseException):
    """The batcher was killed while its worker ran a batch: the worker
    stops before its next launch. Its futures are failed already, so it is
    no item's fault and passes every per-item handler (``except
    Exception``) up to the worker, which exits."""


def _resolve(fut: Future, value) -> None:
    """``set_result`` unless the future is settled (``feed_async`` cancels
    its future on a timeout)."""
    if not fut.done():
        try:
            fut.set_result(value)
        except Exception:  # noqa: BLE001 - raced a cancel
            pass


def _fail(fut: Future, exc: BaseException) -> None:
    if not fut.done():
        try:
            fut.set_exception(exc)
        except Exception:  # noqa: BLE001 - raced a cancel
            pass


@dataclass
class _Work:
    kind: str  # "partial" | "spec_final" | "final"
    utt: int  # utterance key
    buf: np.ndarray  # the utterance's audio so far (a host copy)
    future: Future
    seq: int  # FIFO within a priority class
    tenant: str | None = None


@dataclass
class _SlotState:
    """Host-side incremental accounting of one pool slot
    (``IncrementalState`` without its KV, which lives in the pool)."""

    utt: int
    enc_len: int = 0
    consumed_frames: int = 0
    anchor_frames: int = 0


class STTBatcher:
    """Coalesces every connection's STT work onto one ``SpeechEngine``.
    ``submit`` / ``release`` are thread-safe; the pool is touched only by
    the worker thread (or by ``tick`` with ``autostart=False``)."""

    def __init__(self, engine: SpeechEngine, slots: int = 4, max_pending: int | None = None,
                 autostart: bool = True):
        if slots < 1:
            raise ValueError("need at least one batch slot")
        self.engine = engine
        self.S = slots
        cfg = engine.cfg
        self.pool = init_cross_kv_pool(cfg, slots, engine._param_dtype, device=engine.device)
        self.slot_of: dict[int, int] = {}  # utt -> slot
        self.slot_state: list[_SlotState | None] = [None] * slots
        self.max_pending = max_pending if max_pending is not None else 4 * slots
        self.queue: list[_Work] = []
        self._wake = threading.Condition()
        self._seq = 0
        self._stop = False
        self._busy = False
        self.ticks = 0
        # the dead latch: a killed batcher fails new work at submit
        self.dead = False
        # the batch being processed: kill() fails these futures too
        self._inflight: list[_Work] = []
        # one blank row for dead slots (never written)
        self._blank_row = torch.zeros((cfg.dec_layers, 1, cfg.enc_positions, cfg.n_heads,
                                       cfg.head_dim), dtype=engine._param_dtype,
                                      device=engine.device)
        get_metrics().set_gauge("stt.batch_slots", float(slots))
        self.lanes: FairLanes | None = FairLanes() if tenancy_enabled() else None
        self._thread: threading.Thread | None = None
        if autostart:
            self._thread = threading.Thread(target=self._worker, name="stt-batcher", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ submit

    def submit(self, kind: str, utt: int, buf: np.ndarray, tenant: str | None = None) -> Future:
        """Queue one item; the future resolves to a TranscribeResult, or to
        None when the item was superseded, shed, or had no complete block."""
        if kind not in _PRIORITY:
            raise ValueError(f"unknown STT work kind {kind!r}")
        fut: Future = Future()
        m = get_metrics()
        with self._wake:
            if self.dead:
                # under the lock kill() takes: a submit racing the kill is
                # failed here or lands in the queue kill() fails
                _fail(fut, RuntimeError("stt replica is down"))
                return fut
            if kind != "final":
                # a newer buffer of the same (kind, utterance) supersedes
                for w in self.queue:
                    if w.kind == kind and w.utt == utt:
                        self.queue.remove(w)
                        _resolve(w.future, None)
                        if kind == "partial":
                            m.inc("stt.partials_coalesced")
                        break
            if kind == "partial":
                # admission at submit, under the lock release() takes: the
                # slot is reserved here, never by the worker, so a released
                # utterance's in-flight partial cannot leak one
                if len(self.queue) >= self.max_pending or (
                        utt not in self.slot_of and self._alloc_slot_locked(utt, buf) is None):
                    m.inc("stt.shed_overload")
                    _resolve(fut, None)
                    return fut
            if kind == "final":
                # the utterance is closing: its queued partials are moot
                for w in list(self.queue):
                    if w.kind == "partial" and w.utt == utt:
                        self.queue.remove(w)
                        _resolve(w.future, None)
            self.queue.append(_Work(kind, utt, buf, fut, self._seq, tenant))
            self._seq += 1
            m.set_gauge("stt.queue_depth", float(len(self.queue)))
            self._wake.notify()
        return fut

    def release(self, utt: int) -> None:
        """The utterance closed: free its slot, drop its queued partials
        (queued finals keep their own audio)."""
        with self._wake:
            s = self.slot_of.pop(utt, None)
            if s is not None:
                self.slot_state[s] = None
            for w in list(self.queue):
                if w.kind == "partial" and w.utt == utt:
                    self.queue.remove(w)
                    _resolve(w.future, None)

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Block until every queued item ran; False on timeout."""
        give_up = time.perf_counter() + timeout_s
        with self._wake:
            while self.queue or self._busy:
                if time.perf_counter() >= give_up:
                    return False
                self._wake.wait(timeout=0.02)
        return True

    def stop(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def healthy(self) -> bool:
        """Not dead-latched, and the worker runs (a manually ticked batcher
        counts healthy: its caller is the worker)."""
        if self.dead:
            return False
        return self._thread is None or self._thread.is_alive()

    def kill(self, exc: Exception) -> None:
        """Retire this batcher like a crashed process: latch dead, fail
        every queued and in-flight future with ``exc`` (their waiters fail
        over instead of timing out) and stop the worker."""
        with self._wake:
            self.dead = True
            self._stop = True
            stale, self.queue = self.queue, []
            inflight = list(self._inflight)
            self._wake.notify_all()
        for w in stale + inflight:
            _fail(w.future, exc)

    # ------------------------------------------------------------ worker

    def _worker(self) -> None:
        while True:
            with self._wake:
                while not self.queue and not self._stop:
                    self._wake.wait()
                if self._stop:
                    for w in self.queue:
                        _resolve(w.future, None)
                    self.queue.clear()
                    return
                batch = self._take_batch_locked()
                self._inflight = batch
                self._busy = True
            try:
                if chaos_fire("stt_replica_kill"):
                    # the drill: this replica crashes as it takes a batch
                    self.kill(ChaosError("chaos: stt replica killed"))
                    return
                self._process(batch)
            except Killed:
                return  # kill failed the batch's futures and stopped this worker
            except Exception as e:  # noqa: BLE001 - the batch fails, not the worker
                for w in batch:
                    _fail(w.future, e)
            finally:
                with self._wake:
                    self._inflight = []
                    self._busy = False
                    self._wake.notify_all()

    def tick(self) -> int:
        """Process ONE batch on the calling thread (``autostart=False``).
        Returns the number of items taken."""
        with self._wake:
            batch = self._take_batch_locked()
        if batch:
            with contextlib.suppress(Killed):
                self._process(batch)
        return len(batch)

    def _take_batch_locked(self) -> list[_Work]:
        lanes = self.lanes
        if lanes is None:
            self.queue.sort(key=lambda w: (_PRIORITY[w.kind], w.seq))
        else:
            # the poorest tenant first, then the single-tenant order
            self.queue.sort(key=lambda w: (lanes.rank(w.tenant), _PRIORITY[w.kind], w.seq))
        batch, self.queue = self.queue[:self.S], self.queue[self.S:]
        if lanes is not None:
            for w in batch:
                # charged by audio seconds: a long final costs more credit
                lanes.charge(w.tenant, max(0.25, len(w.buf) / 16000.0))
        get_metrics().set_gauge("stt.queue_depth", float(len(self.queue)))
        return batch

    # ----------------------------------------------------------- process

    def _alloc_slot_locked(self, utt: int, buf: np.ndarray) -> _SlotState | None:
        """Reserve a slot for a new utterance, anchored by
        ``SpeechEngine.anchor_for`` as the B = 1 first partial is."""
        for s, st in enumerate(self.slot_state):
            if st is None:
                anchor = self.engine.anchor_for(len(buf) // self.engine.mel_cfg.hop)
                st = _SlotState(utt, enc_len=0, consumed_frames=anchor, anchor_frames=anchor)
                self.slot_state[s] = st
                self.slot_of[utt] = s
                return st
        return None

    def _feed_slot(self, s: int, st: _SlotState, buf: np.ndarray) -> None:
        """``SpeechEngine.incremental_feed`` into pool slot ``s``: the same
        block encoder and anchor rules, so the slot's KV equals a B = 1
        state's fed the same audio. A re-anchor resets the accounting only:
        positions past the new enc_len are never read."""
        eng = self.engine
        step = eng.INC_STEP
        total = len(buf) // eng.mel_cfg.hop
        while total - st.consumed_frames >= step:
            if st.enc_len + step // 2 > eng.cfg.enc_positions:
                anchor = eng.anchor_for(total)
                st.enc_len, st.consumed_frames, st.anchor_frames = 0, anchor, anchor
                continue
            new_k, new_v, keep = eng._encode_block(buf, st.anchor_frames, st.consumed_frames)
            _append_cross_kv(self.pool["k"], self.pool["v"], new_k, new_v, st.enc_len, s)
            st.enc_len += keep
            st.consumed_frames += step

    def _encode_finals(self, works: list[_Work]) -> dict[int, tuple]:
        """The full-window encode of each final / spec_final at B = 1,
        through ``_encode_window`` (transcribe's path: a batched (B, T)
        encode is not row-stable in bf16). An item's fault fails its
        future alone (``stt.item_faults``). Returns id(work) ->
        (padded cross-KV row, valid frames, n_frames)."""
        eng = self.engine
        out: dict[int, tuple] = {}
        for w in works:
            self._fence()
            try:
                cross_kv, enc_len, n_frames = eng._encode_window(w.buf)
                row = pad_cross_kv(cross_kv, eng.cfg.enc_positions)
            except Exception as e:  # noqa: BLE001 - the item fails alone
                get_metrics().inc("stt.item_faults")
                _fail(w.future, e)
                continue
            out[id(w)] = (row, enc_len, n_frames)
        return out

    def _fence(self) -> None:
        """Called by the worker before each launch: a killed batcher's
        worker launches nothing more."""
        if self.dead:
            raise Killed

    @torch.no_grad()
    def _process(self, batch: list[_Work]) -> None:
        if chaos_fire("stt_replica_hang"):
            # the drill: a wedged worker; the tier's stalled-tick watchdog
            # warm-restarts the replica while it sleeps
            time.sleep(float(os.environ.get("CHAOS_HANG_S", "60")))
        self._fence()
        eng = self.engine
        finals = [w for w in batch if w.kind != "partial"]
        partials = [w for w in batch if w.kind == "partial"]
        rows: list[tuple[_Work, object, int, int]] = []  # (work, slot or row, valid, n_frames)
        for w in partials:
            with self._wake:
                # slots are reserved at submit and freed by release(); the
                # worker only looks up. A miss: the utterance closed while
                # this item waited, so it is dropped.
                s = self.slot_of.get(w.utt)
                st = self.slot_state[s] if s is not None else None
            if st is None or st.utt != w.utt:
                _resolve(w.future, None)
                continue
            self._fence()
            try:
                self._feed_slot(s, st, w.buf)
            except Exception:  # noqa: BLE001 - a partial fails alone, as a shed
                get_metrics().inc("stt.item_faults")
                _resolve(w.future, None)
                continue
            if st.enc_len <= 0:
                _resolve(w.future, None)  # no complete block yet, as at B = 1
                continue
            rows.append((w, s, st.enc_len, st.consumed_frames))
        # the finals' encode, reported per item
        t_enc = time.perf_counter()
        enc = self._encode_finals(finals) if finals else {}
        encode_ms = (time.perf_counter() - t_enc) * 1e3 / len(finals) if finals else 0.0
        for w in finals:
            if id(w) in enc:
                row, valid, n_frames = enc[id(w)]
                rows.append((w, row, valid, n_frames))
        if not rows:
            return
        # ONE (S, ...) decode over every live row; dead rows read nothing
        t1 = time.perf_counter()
        ks, vs = [], []
        valid_h = np.zeros((self.S,), np.int32)
        for i, (w, src, valid, _) in enumerate(rows):
            if isinstance(src, int):
                ks.append(self.pool["k"][:, src:src + 1])
                vs.append(self.pool["v"][:, src:src + 1])
            else:
                ks.append(src["k"])
                vs.append(src["v"])
            valid_h[i] = valid
        while len(ks) < self.S:
            ks.append(self._blank_row)
            vs.append(self._blank_row)
        dev = eng.device
        cross_kv = {"k": torch.cat(ks, dim=1), "v": torch.cat(vs, dim=1)}
        enc_len = torch.from_numpy(valid_h).to(dev)
        live = torch.arange(self.S, device=dev) < len(rows)
        cache = init_self_cache(eng.cfg, self.S, dtype=eng._param_dtype, device=dev)
        bos = torch.tensor([list(eng.bos_ids)] * self.S, dtype=torch.int32, device=dev)
        out, n, _, conf = _stt_decode_loop(eng.params, eng.cfg, cache, cross_kv, enc_len, bos,
                                           max_new=eng.max_new_tokens, eos_id=eng.eos_id,
                                           pad_id=eng.pad_id, quality_lanes=eng.quality_lanes,
                                           live=live, fence=self._fence,
                                           suppress=eng.suppress)
        # one readback: tokens, counts and lanes (exact in float32)
        cols = [out.float(), n.float()[:, None]]
        if conf is not None:
            cols += [c.float()[:, None] for c in conf]
        h = torch.cat(cols, dim=1).cpu().numpy()
        decode_ms = (time.perf_counter() - t1) * 1e3
        W = out.shape[1]
        m = get_metrics()
        self.ticks += 1
        m.inc("stt.batch_ticks")
        m.set_gauge("stt.batch_occupancy", len(rows) / self.S)
        if finals:
            m.inc("stt.finals_batched", float(len(finals)))
        for i, (w, _, _, n_frames) in enumerate(rows):
            n_i = int(h[i, W])
            ids = [int(t) for t in h[i, :n_i]]
            # the one post-decode tail of both planes
            ids, logp_mean, logp_min, logp_first, rep = finalize_stt_ids(
                ids, h[i, W + 1:W + 4], eng.quality_lanes, final=w.kind != "partial")
            _resolve(w.future, TranscribeResult(
                text=eng.tokenizer.decode(ids).strip(),
                encode_ms=encode_ms if w.kind != "partial" else 0.0,
                decode_ms=decode_ms, n_frames=n_frames, token_ids=ids,
                forwards=1 + min(n_i, eng.max_new_tokens),
                logp_mean=logp_mean, logp_min=logp_min, logp_first=logp_first,
                repetition=rep))


class BatchedStreamingSTT(StreamingSTT):
    """``StreamingSTT`` whose transcriptions go through a shared
    ``STTBatcher``: partials and spec_finals are futures delivered by a
    later ``feed`` (they never stall audio ingest); a final blocks in
    ``feed`` (thread callers) or is awaited by ``feed_async``. ``tenant``
    (the voice service's ``tenant`` control frame) lanes this connection's
    work."""

    def __init__(self, engine: SpeechEngine, batcher: STTBatcher, result_timeout_s: float = 30.0,
                 **kw):
        super().__init__(engine, **kw)
        self.batcher = batcher
        self.result_timeout_s = result_timeout_s
        self.tenant: str | None = None
        self._utt = next(_UTT_IDS)
        self._ready: collections.deque = collections.deque()
        self._spec_future: tuple[int, int, Future] | None = None
        self._pending_final: tuple[Future | None, TranscribeResult | None] | None = None
        self._defer_final = False

    # ------------------------------------------------- hook overrides

    def _start_speculation(self, spoken: int, events: list) -> None:
        self._spec_final = None
        self._spec_at_speech = spoken
        fut = self.batcher.submit("spec_final", self._utt, self._buf.copy(), tenant=self.tenant)
        self._spec_future = (spoken, self._utt, fut)

        def _cb(f, utt=self._utt, spoken=spoken):
            try:
                res = f.result()
            except BaseException:  # noqa: BLE001 - a failed speculation is no hint
                res = None
            self._ready.append(("spec", utt, spoken, res))

        fut.add_done_callback(_cb)

    def _emit_partial(self, events: list) -> None:
        fut = self.batcher.submit("partial", self._utt, self._buf.copy(), tenant=self.tenant)

        def _cb(f, utt=self._utt):
            try:
                res = f.result()
            except BaseException:  # noqa: BLE001 - a failed partial is dropped
                res = None
            self._ready.append(("partial", utt, res))

        fut.add_done_callback(_cb)

    def _drain_ready(self, events: list) -> None:
        while self._ready:
            item = self._ready.popleft()
            if item[0] == "spec":
                _, utt, spoken, res = item
                if utt != self._utt or res is None or self._spec_at_speech != spoken:
                    continue  # another utterance's, or superseded
                self._spec_final = res
                # the hint only while the content is still frozen
                if res.text and self.endpointer.total_speech_frames == spoken:
                    events.append(("spec_final", res.text))
            else:
                _, utt, res = item
                if utt == self._utt and res is not None and res.text:
                    events.append(("partial", res.text))

    def _final_result(self, fresh: bool, spoken: int) -> TranscribeResult | None:
        fut: Future | None = None
        res: TranscribeResult | None = None
        if fresh:
            res = self._spec_final  # exact, already delivered
        else:
            sf = self._spec_future
            if sf is not None and sf[0] == spoken and sf[1] == self._utt:
                fut = sf[2]  # in flight for exactly this frozen content
            else:
                fut = self.batcher.submit("final", self._utt, self._buf.copy(),
                                          tenant=self.tenant)
        self._spec_future = None
        if self._defer_final:
            self._pending_final = (fut, res)
            return None
        if fut is not None:
            # an engine fault or a timeout propagates out of feed(): the
            # voice handler warns; None only when the batcher was stopped
            res = fut.result(timeout=self.result_timeout_s)
        return res if res is not None else TranscribeResult("", 0.0, 0.0, 0)

    def _utterance_closed(self) -> None:
        self.batcher.release(self._utt)
        self._utt = next(_UTT_IDS)
        self._spec_future = None

    # ---------------------------------------------------- public surface

    def reset(self) -> None:
        super().reset()
        self.batcher.release(self._utt)
        self._utt = next(_UTT_IDS)
        self._spec_future = None
        self._pending_final = None
        self._ready.clear()

    def close(self) -> None:
        """Connection teardown: free the utterance's slot."""
        self.batcher.release(self._utt)

    async def feed_async(self, samples: np.ndarray) -> list[tuple[str, str]]:
        """The event loop's feed: the host-side state machine runs inline
        (numpy only) and a final's future is awaited, so no executor thread
        waits on the model."""
        self._defer_final = True
        try:
            events = self.feed(samples)
        finally:
            self._defer_final = False
        pending, self._pending_final = self._pending_final, None
        if pending is not None:
            fut, res = pending
            if fut is not None:
                res = await asyncio.wait_for(asyncio.wrap_future(fut),
                                             timeout=self.result_timeout_s)
            if res is not None:
                self.last_final = res
            if res is not None and res.text:
                events.append(("final", res.text))
        return events
