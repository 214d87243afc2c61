"""Brain service: text + context -> validated intent plan.

Port of the rule and engine paths of ``tpu_voice_agent/services/brain.py``.
``POST /parse`` takes ``{text, session_id?, context, speculative?}`` and
answers with the ParseResponse dict (every default field filled, as
pydantic's ``model_dump()`` fills it); errors come back as
``{"error", "detail"}``:

- 400 ``invalid_request``: the body is not JSON or not a ParseRequest;
- 409 ``prefix_feed_unsupported``: a ``prefix_feed`` to a backend without a
  prefill-only admission path (the rule and one-slot parsers, as in JAX);
- 413: a body past 1 MiB (aiohttp's default cap, which the JAX brain runs
  with), answered without reading it; 411 a chunked body with no length;
- 422 ``schema_validation_failed``: the decode ran out of budget before EOS;
- 503 ``overloaded`` (with ``Retry-After``): the request's ``x-deadline-ms``
  budget had run out on arrival (``deadline_expired``, ``Retry-After: 0``),
  ``BRAIN_MAX_INFLIGHT`` parses (default 32) were already in flight
  (``overload``), or the batcher shed it (the KV pool stayed exhausted, or
  the deadline ran out in the queue: ``engine_overload``);
- 500 ``llm_error``: the engine failed (poisoned row, quarantined prompt,
  prompt too long, ...).

A single-slot parser is serialized by one lock (one KV cache); the batched
parser (``BRAIN_BATCH`` > 1) is ``concurrent_safe``: its requests share
decode chunks on one serving thread. The batched parser carries the
request's deadline into the scheduler (shed at dequeue, evicted between
chunks), and a client that closes its socket mid-parse has its decode
cancelled at the next chunk boundary (``brain.parses_cancelled``): the
handler watches the socket while it waits. A session-aware parser (paged
engine with ``RADIX_ENABLE=1``) receives ``session_id`` and
``speculative``. ``GET /health`` reports the backend, its device, the SLO
verdict, the ``quality`` block, the in-flight count and cap, the quarantine
list and the last step-ledger entry. Every parse records a ``parse`` span
(``Tracer("brain")``) carrying the decode split and the intent confidence
as stage notes, an SLO sample and a quality record; a response from an engine backend carries
``x-intent-margin`` beside the decode headers. ``GET /metrics`` (JSON, or
Prometheus text under ``Accept: text/plain``), ``GET /debug/trace/{id}``,
``GET /debug/quality``, ``GET /debug/steplog``, ``GET
/debug/flightrecorder`` and ``GET /debug/costs`` (the batcher's cost meter,
the per-session rollup and, under tenancy, the lanes) are served. So is the
batched parser's warm state (``serve.handoff``): ``GET /admin/handoff/{id}``
exports a session as one ``TVAH1`` blob, ``POST /admin/handoff`` adopts one
(a ``TVAF1`` framed body is reassembled; both take up to 256 MiB and answer
413 ``handoff_too_large`` past it), ``POST /admin/disagg/prefill`` streams a
prompt's KV chain as chunked frames while it computes, ``POST
/admin/disagg/adopt`` installs one forwarded frame payload
(``x-disagg-stream`` names the stream), ``POST /admin/drain`` latches the
drain (``/health`` then reads ``draining`` and ``drained``), and ``/parse``
with ``prefix_feed: true`` warms the session's radix chain without a
decode. A backend without that surface answers 404 ``handoff_unsupported``
/ ``disagg_unsupported``, as JAX's does. ``/health`` also carries ``role``
(``BRAIN_ROLE``, default ``both``), ``disagg`` and the ``pressure`` block
the router's prober reads (``score``: the largest of the live saturation
fractions, 1.0 under a violated SLO, at least 0.95 at risk). ``GET
/debug/timeseries?since=`` serves the app's time-series ring
(``utils.timeseries``: the global registry, then the tracer-local one, so
the ``brain.parse`` window stays this replica's own in a process that holds
several brains). A request's tenant (the body's ``tenant``, else the
``x-tenant`` header) rides into the batcher. The HTTP layer is the standard
library's ``ThreadingHTTPServer``.

    BRAIN_BACKEND=engine:tinyllama-1.1b BRAIN_QUANT=int8 \\
        python -m tpu_voice_agent_torch.services.brain

Environment (the JAX service's names): ``BRAIN_BACKEND`` (``rule``, the
default: ``RuleBasedParser``, no model and no device; ``distilled[:<dir>]``,
the in-repo trained checkpoint; or ``engine[:preset]``, preset default
``tinyllama-1.1b``), ``BRAIN_QUANT`` (``int8``), ``BRAIN_FF``
(fast-forward width, default 8), ``BRAIN_PREFIX`` (``0`` skips the cached
prompt prefix), ``BRAIN_PORT`` (default 8090), ``BRAIN_BATCH`` (slots,
default 1), ``BRAIN_PAGED`` (``1``: the paged KV pool), ``BRAIN_POOL_BLOCKS``
(pool size, default the dense worst case), ``BRAIN_CHUNK`` (decode steps per
chunk, default 16), ``RADIX_ENABLE`` (``1``: session KV reuse on the paged
pool), ``KV_QUANT`` (``int8`` / ``int4``: the quantized paged pool),
``BRAIN_MOE`` (``grouped``: the grouped-matmul MoE dispatch on an MoE
preset such as ``mixtral-8x7b``), and ``BRAIN_DEVICE`` (default ``cuda``;
``cpu`` runs the plain versions), ``QUALITY_ENABLE`` (the decode loops'
quality lanes, default on), ``QUALITY_WINDOW`` / ``QUALITY_SLO_*``,
``SLO_*``, ``TRACE_SINK``, ``BRAIN_MAX_INFLIGHT``, ``QUARANTINE_AFTER`` and
``PREFILL_CHUNK_TOKENS`` (read by the batcher), ``ENGINE_STALL_S`` (the
serving loop's stall watchdog, default 30), ``HANDOFF_KV`` (``0`` exports
the transcript alone), ``BRAIN_ROLE``, ``STEPLOG_*``, ``FLIGHT_*``,
``QUALITY_CANARY_S`` / ``QUALITY_CANARY_SLICE`` / ``QUALITY_CANARY_OCCUPANCY``
(the golden-replay canary, started by ``make_server``), ``TS_INTERVAL_S`` /
``TS_SAMPLES`` / ``TS_GAUGES`` (the time-series ring), ``TENANT_CLASSES`` /
``TENANT_PREEMPT`` (the batcher's tenancy plane), ``RADIX_SESSIONS`` (the
session transcripts' LRU), ``RADIX_MAX_NODES`` / ``RADIX_PRESSURE_S`` (the
paged engine's tree), ``COST_ENABLE`` / ``COST_SESSIONS`` /
``COST_PEAK_TFLOPS`` / ``COST_PEAK_GBPS`` (the cost meter), and ``CHAOS_FAULTS`` /
``CHAOS_SEED`` with ``CHAOS_HANG_S`` / ``CHAOS_SLOW_S`` / ``CHAOS_STALL_S``:
the replica points draw on ``POST /parse`` only (``replica_kill`` latches and
closes every later connection without a response, ``replica_hang`` /
``replica_slow`` sleep, ``replica_degrade`` latches slow),
``replica_join_stall`` sleeps one ``POST /admin/handoff``,
``prefill_replica_kill`` drops a disagg stream between frames,
``stall_step`` wedges a batcher step, and ``intent_downgrade`` latches a
rule-fallback "unknown" answer. The JAX service's knobs and chaos points
that the port does not serve raise ``ValueError`` at boot
(``check_unserved_knobs``). ``main`` merges the repo-root ``.env`` into the
environment first (``utils.envcfg``), so its knobs are served or refused
alike.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import select
import socket
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from concurrent.futures import CancelledError, Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from contextlib import nullcontext
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ..schemas import (
    ValidationError,
    parse_response_from_json,
    validate_parse_request,
    validate_parse_response,
)
from ..utils.chaos import chaos_fire, check_served_points
from ..utils.costmodel import SessionCostLedger
from ..utils.envcfg import load_env_cascade
from ..utils.quality import GoldenCanary, QualityMonitor
from ..utils.steplog import get_steplog, steplog_response
from ..utils.timeseries import TIMESERIES_ROUTE, service_ring, timeseries_response
from ..utils.tracing import (
    TRACE_ROUTE,
    Tracer,
    flightrecorder_response,
    get_flight_recorder,
    get_metrics,
    metrics_response,
    new_trace_id,
    note_stage,
    peek_stage_notes,
    pop_stage_notes,
    trace_response,
)
from .prompts import render_prompt
from .resilience import (
    AdmissionController,
    Deadline,
    RequestContext,
    current_request_context,
    pop_request_context,
    push_request_context,
)
from .slo import SLOTracker
from .ws import Headers, Request

log = logging.getLogger("tpu_voice_agent_torch.brain")


class ParserError(Exception):
    def __init__(self, kind: str, detail: str):
        super().__init__(detail)
        self.kind = kind  # "schema_validation_failed" | "overloaded" | "llm_error"
        self.detail = detail


def _result_to_response(res) -> dict:
    """GenerationResult -> the ParseResponse dict, with the service's
    error mapping: a shed request (``shed: ...``) is ``overloaded``, any
    other failure (poisoned, quarantined, cancelled) ``llm_error``, a decode that never
    reached EOS ``schema_validation_failed``. Deposits the request's decode
    split and confidence (from its own result) as stage notes on the
    calling thread: the handler's span, quality record and headers read
    them there."""
    note_stage("prefill_ms", round(res.prefill_ms, 3))
    note_stage("decode_ms", round(res.decode_ms, 3))
    note_stage("cached_tokens", int(res.cached_tokens))
    note_stage("prompt_tokens", int(res.prompt_tokens))
    q = res.quality
    if q:
        note_stage("intent_margin", q["margin_mean"])
        note_stage("intent_entropy", q["entropy_mean"])
        note_stage("intent_forced_frac", q["forced_frac"])
    if res.error:
        raise ParserError("overloaded" if res.error.startswith("shed:") else "llm_error",
                          res.error)
    if not res.finished:
        raise ParserError("schema_validation_failed",
                          f"decode truncated after {res.steps} tokens (no EOS)")
    resp, err = parse_response_from_json(res.text)
    if resp is None:
        # unreachable under the grammar; kept as a hard backstop
        raise ParserError("schema_validation_failed", err or "invalid")
    return resp


def install_prompt_prefix(engine) -> int:
    """Prefill the request-invariant prompt head (system + few-shots) into
    the engine's shared-prefix cache: two differing sample payloads locate
    the common token prefix. Returns its length in tokens."""
    return engine.set_prompt_prefix(
        render_prompt("sample utterance alpha", {}),
        render_prompt("a rather different beta payload", {"last_query": "gamma"}),
    )


class EngineParser:
    """Grammar-constrained decode on a one-slot engine. ``render`` maps
    (text, context) -> prompt; the default is the few-shot prompt.
    ``last_result`` keeps the most recent GenerationResult (the service
    reads its timings under the parse lock)."""

    def __init__(self, engine, max_new_tokens: int = 512, render=None):
        self.engine = engine
        self.max_new_tokens = max_new_tokens
        self.render = render or render_prompt
        self.last_result = None

    def parse(self, text: str, context: dict) -> dict:
        prompt = self.render(text, context)
        self.last_result = None
        try:
            res = self.engine.generate(prompt, max_new_tokens=self.max_new_tokens,
                                       greedy=True, constrained=True)
        except ValueError as e:  # prompt too long etc.
            raise ParserError("llm_error", str(e)) from e
        self.last_result = res
        return _result_to_response(res)


class SessionTranscripts:
    """Multi-turn prompts in token-id space, for the radix KV plane.

    Turn 1 renders through ``render`` (default ``render_prompt``); turn N
    is the literal turn
    N-1 prompt ids + the ids the model generated + one freshly encoded
    ``<|user|>`` / ``<|assistant|>`` frame: a STRICT token extension of what
    the engine already decoded, which the radix tree turns into an
    O(new utterance) admission. Id space, not text space, because
    re-encoding generated text is not id-stable under grammar-constrained
    decoding. The frame serializes the payload with sorted keys, so the same
    (text, context) always renders the same bytes. LRU over ``max_sessions``
    sessions (``RADIX_SESSIONS``, default ``MAX_SESSIONS``)."""

    MAX_SESSIONS = 256

    def __init__(self, tokenizer, render=None):
        self.tokenizer = tokenizer
        self.render = render or render_prompt
        self.max_sessions = int(os.environ.get("RADIX_SESSIONS", str(self.MAX_SESSIONS)))
        self._hist: OrderedDict[str, list[int]] = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def user_frame(text: str, context: dict) -> str:
        return json.dumps({"text": text, "context": context}, separators=(",", ":"),
                          sort_keys=True)

    def prompt_for(self, session_id: str, text: str, context: dict):
        """This turn's prompt: a rendered string for turn 1, else the
        transcript ids + the new frame's ids (the batcher takes both)."""
        with self._lock:
            hist = self._hist.get(session_id)
            if hist is not None:
                self._hist.move_to_end(session_id)
                hist = list(hist)
        if hist is None:
            return self.render(text, context)
        frame = f"\n<|user|>\n{self.user_frame(text, context)}\n<|assistant|>\n"
        return hist + self.tokenizer.encode(frame, bos=False)

    def record(self, session_id: str, prompt, generated_ids: list[int]) -> None:
        """Commit a finished turn: the next prompt extends prompt + output."""
        ids = (self.tokenizer.encode(prompt, bos=True) if isinstance(prompt, str)
               else list(prompt))
        with self._lock:
            self._hist[session_id] = ids + [int(t) for t in generated_ids]
            self._hist.move_to_end(session_id)
            while len(self._hist) > self.max_sessions:
                self._hist.popitem(last=False)

    def peek(self, session_id: str) -> list[int] | None:
        """The session's committed transcript ids (a copy), LRU order
        untouched: the warm-state export's read."""
        with self._lock:
            hist = self._hist.get(session_id)
            return list(hist) if hist is not None else None

    def adopt(self, session_id: str, ids: list[int]) -> None:
        """Install a transcript shipped from another brain: the donor is
        authoritative at re-home time, so a local entry is overwritten."""
        with self._lock:
            self._hist[session_id] = [int(t) for t in ids]
            self._hist.move_to_end(session_id)
            while len(self._hist) > self.max_sessions:
                self._hist.popitem(last=False)

    def forget(self, session_id: str) -> None:
        with self._lock:
            self._hist.pop(session_id, None)


@dataclass
class LoopStats:
    """The serving loop's lanes, as JAX's ``ColocationStats`` counts them."""

    stt_jobs: int = 0
    parse_jobs: int = 0
    stt_busy_ms: float = 0.0
    decode_busy_ms: float = 0.0
    decode_chunks: int = 0
    max_stt_queue: int = 0
    max_parse_inflight: int = 0
    restarts: int = 0  # serving loops the watchdog replaced (dead or stalled)
    # the dispatch order, "stt" / "chunk" entries (the fairness tests read it)
    trace: list = field(default_factory=list)


class ServingLoop:
    """One thread that steps a ``ContinuousBatcher`` and, given a
    ``SpeechEngine`` (``stt``), serves transcriptions between its decode
    chunks: the port of JAX's ``ColocatedServing`` lanes.

    ``submit`` queues a prompt (with its ``Deadline`` and tenant) and
    returns a ``Future`` of its GenerationResult; ``submit_stt`` queues
    16 kHz float32 audio and returns a ``Future`` of its TranscribeResult
    (a loop built without ``stt`` raises ``RuntimeError``); ``submit_call``
    queues a function (the warm-state export and adoption, prefix feeds,
    the disagg stream) and returns a ``Future`` of its result. Each ``step``
    runs every queued STT job first, then the queued calls, then one decode
    chunk: an STT job waits at most one chunk. New requests join at chunk
    boundaries; one the batcher refuses at submit (a quarantined prompt, a
    rate-limited tenant) resolves before the next step. Every engine call
    runs on the loop's thread: the kernels' split scratch and tickets serve
    one stream at a time, so K5 (the STT) and K6 / K7 (the batch) never
    launch from two threads at once, and the allocator and radix tree have
    one writer. An STT job's or a call's own error fails its future alone;
    a fault out of the decode step, or a CUDA fault anywhere (never handled
    per request), fails every waiting future and stops the loop: ``healthy``
    turns False and later submits fail at once. ``autostart=False`` leaves
    the thread unstarted, for a caller that drives ``step`` itself
    (``start`` starts it). The ``colocate.stt_queue`` and
    ``colocate.parse_inflight`` gauges read each step's lanes before it
    runs them.

    The drain latch (``begin_drain``, ``colocate.drains_started``) refuses
    nothing: a request racing the router's decision to stop placing work
    here is served (the zero-drop contract), and ``drained`` turns True once
    the latch is set and both lanes are empty. ``start_watchdog`` watches
    the thread: a loop that died of anything but a CUDA fault is replaced
    (``colocate.worker_restarts``); a decode step running past
    ``ENGINE_STALL_S`` (default 30) supersedes the batcher and its engine
    (the epoch up, every later launch refused), fails the in-flight work
    with "decode step stalled; engine warm-restarted, work failed fast" and
    starts a fresh loop (``engine.restarts``, an ``engine.stall``
    flight-recorder freeze). The stalled thread stops at its next prefill,
    claim or forward and exits; it holds the engine lock for the whole of
    its step, so the fresh thread's first act, ``batcher.reset()`` then
    ``warm_restart()`` under that lock, waits for it, and one thread at a
    time ever touches the engine. A kernel hung on the device blocks the
    stream for every thread: no watchdog in the process recovers that."""

    def __init__(self, batcher, stt=None, autostart: bool = True):
        self.batcher = batcher
        self.stt = stt
        self.stats = LoopStats()
        self._cv = threading.Condition()
        self._inbox: list[tuple[object, object, object, Future]] = []
        self._stt_q: list[tuple[object, Future]] = []
        self._calls: list[tuple[object, Future]] = []
        self._abandoned: set[Future] = set()
        self._futures: dict[int, Future] = {}
        self._stop = False
        self._draining = False
        self.error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._watchdog: threading.Thread | None = None
        # set while the live thread is inside batcher.step(): the stall
        # watchdog's clock
        self._step_t0: float | None = None
        self._replaced: set[threading.Thread] = set()  # loop threads the watchdog replaced
        # held by a loop thread for each batcher step and for a restart's
        # reset: the engine has one writer even while a stalled step runs on
        self._engine_lock = threading.Lock()
        self._stopped = threading.Event()  # wakes the watchdog's poll at stop
        if autostart:
            self.start()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="brain-batcher", daemon=True)
            self._thread.start()

    def _refuse_if_stopped(self, fut: Future) -> bool:
        if self.error is not None or self._stop:
            fut.set_exception(RuntimeError(f"serving loop stopped: {self.error}"))
            return True
        return False

    def submit(self, prompt, deadline=None, tenant=None) -> Future:
        fut: Future = Future()
        with self._cv:
            if not self._refuse_if_stopped(fut):
                self._inbox.append((prompt, deadline, tenant, fut))
                self.stats.max_parse_inflight = max(self.stats.max_parse_inflight,
                                                    len(self._futures) + len(self._inbox))
                self._cv.notify()
        return fut

    def submit_stt(self, audio) -> Future:
        """Queue one transcription (the STT lane runs first in each step)."""
        if self.stt is None:
            raise RuntimeError("this serving loop was built without an STT engine")
        fut: Future = Future()
        with self._cv:
            if not self._refuse_if_stopped(fut):
                self._stt_q.append((audio, fut))
                self.stats.max_stt_queue = max(self.stats.max_stt_queue, len(self._stt_q))
                self._cv.notify()
        return fut

    def submit_call(self, fn) -> Future:
        """Run ``fn()`` on the loop's thread between steps (after the STT
        lane, before the decode chunk) and resolve the future with its
        result: the engine's allocator, pool and radix tree have one writer."""
        fut: Future = Future()
        with self._cv:
            if not self._refuse_if_stopped(fut):
                self._calls.append((fn, fut))
                self._cv.notify()
        return fut

    def abandon(self, fut: Future) -> None:
        """Give up on a request (its caller timed out or disconnected): the
        loop cancels it in the batcher, so a queued one leaves the queue and
        one already decoding is evicted at the next chunk boundary, its slot
        and KV blocks freed. The loop's thread then cancels the future: no
        other thread changes a future's state."""
        with self._cv:
            self._abandoned.add(fut)
            self._cv.notify()

    def healthy(self) -> bool:
        return self.error is None and self._thread is not None and self._thread.is_alive()

    def begin_drain(self) -> None:
        """Arm the drain latch. New submissions are still served."""
        with self._cv:
            self._draining = True
        get_metrics().inc("colocate.drains_started")

    @property
    def draining(self) -> bool:
        return self._draining

    def drained(self) -> bool:
        """The latch is set and both lanes are empty: nothing queued, no
        future unresolved, no slot decoding."""
        if not self._draining:
            return False
        with self._cv:
            return not (self._has_work() or self._futures)

    def drain(self, timeout_s: float = 120.0) -> None:
        """Block until every queued job of both lanes has completed (JAX's
        name for ``run_until_idle``)."""
        self.run_until_idle(timeout_s)

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        if self._watchdog is not None:
            self._watchdog.join(timeout=60)
            self._watchdog = None

    def _has_work(self) -> bool:
        return bool(self._inbox or self._abandoned or self._stt_q or self._calls
                    or self.batcher.busy())

    def _abandoned_thread(self) -> bool:
        """True on a loop thread the watchdog replaced: it must not touch
        the batcher, the engine or a future again."""
        return threading.current_thread() in self._replaced

    def run_until_idle(self, timeout_s: float = 120.0) -> None:
        """Block until both lanes are empty: steps inline when the thread is
        not running, else waits for it. ``TimeoutError`` past
        ``timeout_s``."""
        give_up = time.monotonic() + timeout_s
        while time.monotonic() < give_up:
            with self._cv:
                idle = not (self._has_work() or self._futures)
            if idle:
                return
            if self._thread is not None and self._thread.is_alive():
                time.sleep(0.005)
            else:
                self.step()
        raise TimeoutError("serving loop did not go idle")

    def _run(self, restart: str | None = None) -> None:
        """The loop thread. A replacement first resets the batcher and,
        after a stall, warm-restarts the engine (``restart``: "reset" or
        "warm"), once the step it replaces has let go of the engine."""
        me = threading.current_thread()
        if restart is not None:
            with self._engine_lock:
                self.batcher.reset()
                if restart == "warm":
                    self.batcher.engine.warm_restart()
        while True:
            with self._cv:
                while not (self._has_work() or self._stop) and self._thread is me:
                    self._cv.wait()
                if self._stop or self._thread is not me or me in self._replaced:
                    return  # stopped, or replaced by the watchdog
            try:
                self.step()
            except BaseException:  # noqa: BLE001 - step already failed every waiter
                return

    def step(self) -> bool:
        """One scheduling decision: queued submits and cancels into the
        batcher, every queued STT job, the queued calls, then one decode
        chunk. True when any work ran."""
        from ..serve.scheduler import is_device_fault

        b = self.batcher
        m = get_metrics()
        with self._cv:
            inbox, self._inbox = self._inbox, []
            gone, self._abandoned = self._abandoned, set()
            stt_jobs, self._stt_q = self._stt_q, []
            calls, self._calls = self._calls, []
            # the lanes' depths before this step runs them
            m.set_gauge("colocate.stt_queue", len(stt_jobs))
            m.set_gauge("colocate.parse_inflight", len(self._futures) + len(inbox))
        did = False
        try:
            for prompt, deadline, tenant, fut in inbox:
                if fut not in gone:
                    kw = {"tenant": tenant} if tenant is not None else {}
                    self._futures[b.submit(prompt, deadline=deadline, **kw)] = fut
            for r in [r for r, f in self._futures.items() if f in gone]:
                b.cancel(r, "client gone")
                self._futures.pop(r)
                b.results.pop(r, None)  # nobody reads it
            for fut in gone:
                fut.cancel()
            self._resolve()  # refused at submit: answered before any step
            while stt_jobs:  # the priority lane
                audio, fut = stt_jobs.pop(0)
                t0 = time.perf_counter()
                try:
                    res = self.stt.transcribe(audio)
                except Exception as e:  # noqa: BLE001 - the job fails alone
                    if is_device_fault(e):
                        stt_jobs.insert(0, (audio, fut))
                        raise
                    _settle(fut.set_exception, e)
                else:
                    _settle(fut.set_result, res)
                self.stats.stt_busy_ms += (time.perf_counter() - t0) * 1e3
                self.stats.stt_jobs += 1
                self.stats.trace.append("stt")
                did = True
            while calls:  # after the STT lane: a handoff must not delay a transcription
                fn, fut = calls.pop(0)
                if not fut.set_running_or_notify_cancel():
                    continue  # its caller gave up before it started
                try:
                    res = fn()
                except Exception as e:  # noqa: BLE001 - the call fails alone
                    if is_device_fault(e):
                        _settle(fut.set_exception, e)
                        raise
                    _settle(fut.set_exception, e)
                else:
                    _settle(fut.set_result, res)
                did = True
            if b.busy():
                t0 = time.perf_counter()
                with self._cv:
                    self._step_t0 = t0
                try:
                    with self._engine_lock:
                        b.step()
                finally:
                    with self._cv:
                        # a replaced thread must not disarm its successor's clock
                        if not self._abandoned_thread():
                            self._step_t0 = None
                if self._abandoned_thread():
                    return did  # the watchdog restarted the world meanwhile
                self.stats.decode_busy_ms += (time.perf_counter() - t0) * 1e3
                self.stats.decode_chunks += 1
                self.stats.trace.append("chunk")
                did = True
                self._resolve()
        except BaseException as e:  # every waiter must hear of it
            if self._abandoned_thread():
                raise  # the replacement loop owns the waiters now
            # a thread killed outright (not an Exception) fails its waiters
            # as JAX's watchdog does a dead worker's
            exc = e if isinstance(e, Exception) else RuntimeError(
                "serving worker died; work failed fast on restart")
            with self._cv:
                self.error = e
                waiting = (list(self._futures.values())
                           + [f for *_, f in inbox + self._inbox]
                           + [f for _, f in stt_jobs + self._stt_q]
                           + [f for _, f in calls + self._calls])
                self._futures.clear()
                self._inbox.clear()
                self._stt_q.clear()
                self._calls.clear()
            for fut in waiting:
                _settle(fut.set_exception, exc)
            raise
        return did

    def _resolve(self) -> None:
        b = self.batcher
        for rid in [r for r in self._futures if r in b.results]:
            _settle(self._futures.pop(rid).set_result, b.results.pop(rid))
            self.stats.parse_jobs += 1

    # ------------------------------------------------------------ watchdog

    def start_watchdog(self, interval_s: float = 0.5, stall_s: float | None = None) -> None:
        """Watch the loop's thread every ``interval_s``: replace a dead one,
        warm-restart a step stalled past ``stall_s`` (default
        ``ENGINE_STALL_S``, 30 s). ``engine.restarts`` exists from here, at
        0."""
        if self._watchdog is not None:
            return
        if stall_s is None:
            stall_s = float(os.environ.get("ENGINE_STALL_S", "").strip() or "30")
        get_metrics().inc("engine.restarts", 0.0)
        self._watchdog = threading.Thread(target=self._watch, args=(interval_s, stall_s),
                                          name="brain-watchdog", daemon=True)
        self._watchdog.start()

    def _fail_inflight(self, exc: Exception) -> None:
        """Fail every waiting future of both lanes: the parses submitted or
        queued, the STT jobs and the calls."""
        with self._cv:
            futs = (list(self._futures.values()) + [f for *_, f in self._inbox]
                    + [f for _, f in self._stt_q + self._calls])
            self._futures.clear()
            self._inbox.clear()
            self._stt_q, self._calls = [], []
        for fut in futs:
            _settle(fut.set_exception, exc)

    def _restart_worker(self, exc: Exception, restart: str) -> None:
        """The dead and the stalled recovery alike: fail the waiting work,
        then start a fresh loop thread that resets the batcher (and, on
        ``restart="warm"``, the engine) before its first step."""
        self._fail_inflight(exc)
        with self._cv:
            if self._stop:
                return
            self._step_t0 = None
            self.error = None
            self._thread = threading.Thread(target=self._run, args=(restart,),
                                            name="brain-batcher", daemon=True)
            self._thread.start()

    def _watch(self, interval_s: float, stall_s: float) -> None:
        from ..serve.scheduler import is_device_fault

        while True:
            with self._cv:
                if self._stop:
                    return
                t = self._thread
                dead = t is not None and not t.is_alive()
                t0 = self._step_t0
                stalled = not dead and t0 is not None and time.perf_counter() - t0 >= stall_s
                err = self.error
                if stalled:
                    # in the same critical section as the reading: the step's
                    # own exit (under this lock) sees it replaced and resolves
                    # nothing; the epoch up and the engine fenced stop it at
                    # its next launch
                    self._replaced.add(t)
                    self.batcher.supersede()
            if dead and not (err is not None and is_device_fault(err)):
                # a CUDA fault leaves the loop stopped: the device state is
                # suspect and no restart in this process cures it
                log.error("serving loop died; failing in-flight work and restarting it")
                get_metrics().inc("colocate.worker_restarts")
                self.stats.restarts += 1
                self._restart_worker(RuntimeError(
                    "serving worker died; work failed fast on restart"), "reset")
            elif stalled:
                log.error("decode step stalled >%.1fs; failing in-flight work and "
                          "warm-restarting the engine", stall_s)
                get_metrics().inc("engine.restarts")
                self.stats.restarts += 1
                get_flight_recorder().trigger(
                    "engine.stall", detail=f"step stalled >{stall_s}s"
                    + (" (speculative chunk)"
                       if getattr(self.batcher.engine, "spec", None) is not None else ""))
                self._restart_worker(RuntimeError(
                    "decode step stalled; engine warm-restarted, work failed fast"), "warm")
            self._stopped.wait(interval_s)


def _settle(setter, value) -> None:
    """Resolve a future unless it is already done: one cancelled by some
    other holder in the meantime stays cancelled (its setter raises)."""
    try:
        setter(value)
    except InvalidStateError:
        pass


class BatchedEngineParser:
    """Continuous-batched grammar-constrained decode behind /parse.

    Concurrent requests share chunked decode dispatches on one engine
    through a ``ServingLoop``; each parse waits on its future for at most
    ``timeout_s``. With ``session_aware`` (a paged engine with radix reuse)
    a per-session transcript makes turn N's prompt a strict token extension
    of turn N-1's. Speculative turns run two-phase: the provisional turn
    decodes, but the transcript advances only when the matching final
    commits it (answered from the cached plan, no decode). ``render`` maps
    (text, context) -> prompt, as ``EngineParser``'s does.

    The request context on the calling thread (``RequestContext``, pushed by
    ``BrainApp``) carries the deadline into the batcher, and registers the
    abandon of this request as its cancel callback; while the parse waits,
    its ``client_gone`` probe is asked every ``WATCH_S``, and a gone client
    cancels the context."""

    concurrent_safe = True  # BrainApp skips the serialization lock
    WATCH_S = 0.2  # how often a waiting parse asks whether its client is gone

    def __init__(self, engine, chunk_steps: int = 16, max_new_tokens: int = 512,
                 timeout_s: float = 120.0, session_aware: bool = False, render=None):
        from ..serve.scheduler import ContinuousBatcher

        self.engine = engine
        self.max_new_tokens = max_new_tokens
        self.batcher = ContinuousBatcher(engine, chunk_steps=chunk_steps,
                                         max_new_tokens=max_new_tokens)
        self.timeout_s = timeout_s
        self.render = render or render_prompt
        self.wants_session = session_aware
        self.transcripts = (SessionTranscripts(engine.tokenizer, render=self.render)
                            if session_aware else None)
        # sid -> the pending two-phase speculative turn, LRU-capped as the
        # transcripts are
        self._pending: OrderedDict[str, dict] = OrderedDict()
        self._pending_cap = (self.transcripts.max_sessions if self.transcripts is not None
                             else 64)
        # every finished request's cost ledger, rolled up per session (the
        # meter /debug/costs names the top sessions from); None with the
        # meter off
        self.session_costs = (SessionCostLedger() if self.batcher.costs is not None
                              else None)
        self._plock = threading.Lock()
        self._tls = threading.local()
        # disagg adopt streams: stream id -> StreamAdopter, touched only on
        # the loop's thread (adopt_stream's calls run there)
        self._disagg_adopt: OrderedDict[str, object] = OrderedDict()
        self.loop = ServingLoop(self.batcher)
        # the watchdog: a dead loop restarts and a stalled step warm-restarts
        # the engine, with the in-flight futures failed fast
        self.loop.start_watchdog()

    @property
    def last_result(self):
        """The calling thread's most recent GenerationResult (None after a
        speculative commit, which decodes nothing)."""
        return getattr(self._tls, "result", None)

    def _decode(self, prompt):
        ctx = current_request_context()
        fut = self.loop.submit(prompt, deadline=ctx.deadline if ctx is not None else None,
                               tenant=ctx.tenant if ctx is not None else None)
        if ctx is not None:
            ctx.on_cancel(lambda: self.loop.abandon(fut))
        give_up = time.monotonic() + self.timeout_s
        while True:
            try:
                res = fut.result(timeout=max(0.0, min(self.WATCH_S,
                                                      give_up - time.monotonic())))
                break
            except FutureTimeout as e:
                if ctx is not None and ctx.client_gone():
                    ctx.cancel()  # abandons the request: evicted at the next chunk
                    raise ParserError("llm_error", "cancelled: client disconnected") from e
                if time.monotonic() >= give_up:
                    # queued: dropped now; decoding: evicted at the next chunk
                    self.loop.abandon(fut)
                    raise ParserError("llm_error", "batched decode timed out") from e
            except CancelledError as e:  # a BaseException: the broad catch misses it
                raise ParserError("llm_error", "cancelled: client disconnected") from e
            except Exception as e:
                raise ParserError("llm_error", str(e)) from e
        self._tls.result = res
        return res

    def _too_long(self, prompt) -> bool:
        """The prompt must fit a prefill bucket and leave the decode
        budget's headroom before ``max_len``."""
        eng = self.engine
        limit = min(eng.prefill_buckets[-1], eng.max_len - self.max_new_tokens)
        n = (len(eng.tokenizer.encode(prompt, bos=True)) if isinstance(prompt, str)
             else len(prompt))
        return n > limit

    def _fold_cost(self, session_id: str | None, res) -> None:
        """The request's ledger into its session's (before the response
        conversion: an errored result still spent what it spent)."""
        if self.session_costs is not None and res.cost:
            self.session_costs.fold(session_id, res.cost)

    def parse(self, text: str, context: dict, session_id: str | None = None,
              speculative: bool = False) -> dict:
        self._tls.result = None
        if self.transcripts is None or not session_id:
            res = self._decode(self.render(text, context))
            self._fold_cost(session_id, res)
            return _result_to_response(res)
        user = SessionTranscripts.user_frame(text, context)
        with self._plock:
            pend = self._pending.pop(session_id, None)
        if pend is not None and not speculative and pend["user"] == user:
            # commit: the speculative turn IS this turn; its decode split and
            # confidence are replayed as this request's stage notes
            self.transcripts.record(session_id, pend["prompt"], pend["gen"])
            get_metrics().inc("brain.session_spec_commits")
            for k, v in pend["notes"].items():
                note_stage(k, v)
            return pend["resp"]
        # a superseded speculation needs no rollback: the transcript never
        # advanced, and its chain stays in the radix tree as plain cache
        prompt = self.transcripts.prompt_for(session_id, text, context)
        if self._too_long(prompt):
            # the transcript outgrew the engine: cold-start the session
            self.transcripts.forget(session_id)
            prompt = self.transcripts.prompt_for(session_id, text, context)
        res = self._decode(prompt)
        self._fold_cost(session_id, res)
        resp = _result_to_response(res)  # raises on truncation: the session
        # stays at its last committed turn
        if speculative:
            with self._plock:
                self._pending[session_id] = {"user": user, "resp": resp, "prompt": prompt,
                                             "gen": list(res.token_ids),
                                             "notes": peek_stage_notes()}
                self._pending.move_to_end(session_id)
                while len(self._pending) > self._pending_cap:
                    self._pending.popitem(last=False)
        else:
            self.transcripts.record(session_id, prompt, res.token_ids)
        return resp

    def healthy(self) -> bool:
        return self.loop.healthy()

    def _prompt_for(self, text: str, context: dict, session_id: str | None):
        """The prompt a parse of this turn would render: through the
        session's transcript when this brain knows it."""
        if self.transcripts is not None and session_id:
            return self.transcripts.prompt_for(session_id, text, context)
        return self.render(text, context)

    def _call(self, fn, timeout_s: float | None = None):
        """``fn()`` on the loop's thread; its result or its exception."""
        return self.loop.submit_call(fn).result(
            timeout=self.timeout_s if timeout_s is None else timeout_s)

    # prefix feeds: a stabilized STT partial warms the session's radix chain
    # through the same prompt_for a parse uses, taking no decode slot and
    # advancing no transcript; best-effort, shed whenever live work waits
    supports_prefix_feed = True

    def feed_prefix(self, text: str, context: dict, session_id: str | None = None) -> dict:
        prompt = self._prompt_for(text, context, session_id)
        if self._too_long(prompt):
            return {"ok": False, "reason": "too_long"}
        ctx = current_request_context()
        tenant = ctx.tenant if ctx is not None else None
        fut = self.loop.submit_call(lambda: self.batcher.feed_prefix(prompt, tenant=tenant))
        if ctx is not None:
            # a torn-down client drops a feed that has not started; one
            # already prefilling commits plain reusable cache
            ctx.on_cancel(fut.cancel)
        try:
            return fut.result(timeout=self.timeout_s)
        except CancelledError:
            return {"ok": False, "reason": "cancelled"}
        except FutureTimeout:
            return {"ok": False, "reason": "timeout"}
        except Exception as e:  # noqa: BLE001 - a feed never fails its caller
            return {"ok": False, "reason": f"{type(e).__name__}: {e}"}

    # prefill/decode disaggregation: a prefill brain exports a prompt's
    # chain as it computes (``disagg_prefill``), a decode brain adopts the
    # forwarded segments behind its pinned root (``adopt_stream``)
    supports_disagg = True
    _DISAGG_STREAMS_CAP = 4

    def disagg_prefill(self, text: str, context: dict, session_id: str | None = None, *,
                       stream_blocks: int = 4, emit=None, stream_id: str | None = None) -> dict:
        """Run the prefill-only export on the loop's thread; ``emit(blob)``
        gets each ``kv_seg`` blob as it is packed."""
        prompt = self._prompt_for(text, context, session_id)
        if self._too_long(prompt):
            return {"ok": False, "reason": "too_long"}
        try:
            return self._call(lambda: self.batcher.prefill_export(
                prompt, stream_blocks=stream_blocks, emit=emit, stream_id=stream_id))
        except Exception as e:  # noqa: BLE001 - the caller answers it as a shed
            return {"ok": False, "reason": f"{type(e).__name__}: {e}"}

    def adopt_stream(self, stream_id: str, blob: bytes) -> dict:
        """Install one forwarded stream blob (a ``kv_seg`` or the ``kv_end``)
        into ``stream_id``'s ``StreamAdopter``. At most
        ``_DISAGG_STREAMS_CAP`` streams stay open: the oldest past it is
        abandoned (its partial chain committed, its refs freed)."""
        from ..serve.handoff import StreamAdopter

        def run() -> dict:
            ad = self._disagg_adopt.get(stream_id)
            if ad is None:
                ad = self._disagg_adopt[stream_id] = StreamAdopter(self.engine)
                while len(self._disagg_adopt) > self._DISAGG_STREAMS_CAP:
                    self._disagg_adopt.popitem(last=False)[1].abandon()
            else:
                self._disagg_adopt.move_to_end(stream_id)
            try:
                out = ad.feed(blob)
            except ValueError as e:
                self._disagg_adopt.pop(stream_id, None)
                return {"ok": False, "reason": str(e)}
            if out.get("final"):
                self._disagg_adopt.pop(stream_id, None)
            return out

        try:
            return self._call(run)
        except Exception as e:  # noqa: BLE001 - a torn stream is a cold fallback
            return {"ok": False, "reason": f"{type(e).__name__}: {e}"}

    # warm-state handoff: the session's transcript and radix-chain KV leave
    # an old home and land on a new one, both halves on the loop's thread;
    # any failure is a cold re-home, never an error
    def export_session(self, session_id: str) -> bytes | None:
        if self.transcripts is None:
            return None
        from ..serve import handoff

        try:
            return self._call(lambda: handoff.export_session(self.engine, self.transcripts,
                                                             session_id))
        except Exception:  # noqa: BLE001 - no warm state to ship
            return None

    def adopt_session(self, blob: bytes) -> int:
        if self.transcripts is None:
            return 0
        from ..serve import handoff

        try:
            return int(self._call(lambda: handoff.adopt_session(self.engine, self.transcripts,
                                                                blob)))
        except Exception:  # noqa: BLE001 - a malformed blob is a counted cold fallback
            get_metrics().inc("handoff.adopt_fallbacks")
            log.warning("handoff adoption failed; the session will cold-prefill",
                        exc_info=True)
            return 0

    # the drain latch: the router stops placing new sessions here, the
    # in-flight work completes, and /health's ``drained`` says when
    def begin_drain(self) -> None:
        self.loop.begin_drain()

    def drained(self) -> bool:
        return self.loop.drained()

    def quarantine_info(self) -> list[dict]:
        """The active quarantine entries (``/health``)."""
        return self.batcher.quarantined()

    def pressure_fractions(self) -> dict:
        """Live saturation fractions: slot occupancy and, on the paged pool,
        the blocks in use net of what the radix tree could reclaim. Read
        from the current state, unlocked: racy but monotone reads, enough
        for a busy test."""
        b = self.batcher
        out = {"scheduler.batch_occupancy":
               sum(1 for s in b.slots if s.request_id >= 0) / max(1, b.B)}
        alloc = getattr(self.engine, "allocator", None)
        if alloc is not None:
            used = alloc.blocks_in_use
            radix = getattr(self.engine, "radix", None)
            if radix is not None:
                used -= radix.reclaimable_blocks()
            out["paged.kv_pressure"] = max(0, used) / max(1, alloc.usable_blocks)
        return out

    def close(self) -> None:
        self.loop.stop()


class RuleBasedParser:
    """Deterministic heuristic parser: the service's default backend (no
    model, no device), and its test fake.

    Port of the JAX service's ``RuleBasedParser``: the same command families
    as the prompt's few-shots, the same intents, context updates, confidence,
    ``tts_summary`` and ``follow_up_question``, returned as the validated
    ParseResponse dict (every default field filled). Stateless, so requests
    need not serialize."""

    concurrent_safe = True
    _URL = re.compile(r"(https?://\S+|\b[\w-]+\.(?:com|org|net|io|dev)\b)", re.I)

    def parse(self, text: str, context: dict) -> dict:
        t = text.strip().lower()
        intents: list[dict] = []
        ctx_updates: dict = {}
        tts = None
        follow_up = None
        confidence = 0.9

        def add(type_: str, **kw):
            intents.append({"type": type_, **kw})

        m = re.search(r"(?:search(?: for)?|find|look for)\s+(.+)", t)
        url = self._URL.search(text)
        if m:
            q = m.group(1).strip(" .!?")
            add("search", args={"query": q})
            ctx_updates["last_query"] = q
            tts = f"Searching for {q}"
        elif url and ("open" in t or "navigate" in t or "go to" in t):
            u = url.group(0)
            if not u.startswith("http"):
                u = "https://" + u
            add("navigate", args={"url": u})
            tts = f"Opening {u}"
        elif "upload" in t:
            add("upload", args={"fileRef": None}, requires_confirmation=True)
            if "submit" in t:
                add("click", target={"strategy": "text", "value": "Submit"},
                    requires_confirmation=True)
            tts = "I will upload after you confirm"
        elif (m := re.search(r"sort(?:ed)?(?: these)?(?: by)?\s+(\w+)", t)):
            direction = "desc" if ("high to low" in t or "descending" in t) else "asc"
            add("sort", args={"field": m.group(1), "direction": direction})
            tts = f"Sorting by {m.group(1)}"
        elif (m := re.search(r"open the (first|second|third|\d+\w*) (?:result|item|link)", t)):
            idx = {"first": 1, "second": 2, "third": 3}.get(m.group(1))
            if idx is None:
                idx = int(re.sub(r"\D", "", m.group(1)) or 1)
            add("click", target={"strategy": "auto", "role": "link"}, args={"index": idx})
            tts = f"Opening result {idx}"
        elif (m := re.search(r"click(?: on)?(?: the)?\s+(.+?)(?: button| link)?$", t)):
            add("click", target={"strategy": "text", "value": m.group(1).strip(" .!?")})
            tts = f"Clicking {m.group(1).strip(' .!?')}"
        elif "screenshot" in t:
            add("screenshot")
            tts = "Taking a screenshot"
        elif "scroll" in t:
            add("scroll", args={"direction": "up" if "up" in t else "down"})
        elif re.search(r"\bgo back\b|\bback\b", t):
            add("back")
        elif "extract" in t and "table" in t:
            add("extract_table", args={"format": "csv"})
            tts = "Extracting the table"
        elif "summarize" in t or "summary" in t:
            add("summarize")
        elif "cancel" in t:
            add("cancel")
        else:
            add("unknown")
            confidence = 0.3
            follow_up = "I did not catch a browser action - could you rephrase?"

        resp, err = validate_parse_response({
            "intents": intents, "context_updates": ctx_updates, "confidence": confidence,
            "tts_summary": tts, "follow_up_question": follow_up})
        if resp is None:  # unreachable: every branch builds a valid plan
            raise ParserError("schema_validation_failed", err)
        return resp


def _wrap_batched(engine) -> BatchedEngineParser:
    """The batched serving shape (``BRAIN_PREFIX`` / ``BRAIN_CHUNK``): an
    engine carrying a radix tree gets the session-aware transcripts; dense
    engines stay stateless."""
    if os.environ.get("BRAIN_PREFIX", "1") != "0":
        install_prompt_prefix(engine)
    return BatchedEngineParser(engine, chunk_steps=int(os.environ.get("BRAIN_CHUNK", "16")),
                               session_aware=getattr(engine, "radix", None) is not None)


def _wrap_engine(engine):
    """Pick the serving shape: more than one slot puts the continuous
    batcher behind /parse; otherwise cache the shared prompt head
    (``BRAIN_PREFIX=0`` skips it) and serve the serialized single-slot
    parser."""
    if engine.batch_slots > 1:
        return _wrap_batched(engine)
    if os.environ.get("BRAIN_PREFIX", "1") != "0":
        install_prompt_prefix(engine)
    return EngineParser(engine)


# Knobs whose value must parse: name -> its type. JAX reads them where
# it builds the engine, the batcher, the session LRU or the watchdog; the
# port checks them at boot, whatever the backend.
PARSED_KNOBS = {"RADIX_SESSIONS": int, "RADIX_MAX_NODES": int, "RADIX_PRESSURE_S": float,
                "COST_SESSIONS": int, "COST_PEAK_TFLOPS": float, "COST_PEAK_GBPS": float,
                "ENGINE_STALL_S": float, "CHAOS_STALL_S": float}


def check_unserved_knobs() -> None:
    """Refuse at boot what the JAX brain would honour and the port would
    silently ignore: ``BRAIN_MODEL`` (no checkpoint import yet) and a
    ``CHAOS_FAULTS`` that names an unknown point or arms one the port does
    not serve. A malformed ``TENANT_CLASSES`` or a radix / cost / watchdog
    knob that does not parse raises here too, naming the knob."""
    from ..serve.tenancy import parse_tenant_classes

    if os.environ.get("BRAIN_MODEL"):
        raise ValueError("BRAIN_MODEL is not ported yet (the PyTorch port has no checkpoint "
                         "import: ROADMAP.md Queue 1 item 8); unset it")
    for name, kind in PARSED_KNOBS.items():
        raw = os.environ.get(name, "").strip()
        if raw:
            try:
                kind(raw)
            except ValueError as e:
                raise ValueError(f"{name}={raw!r}: not a {kind.__name__}") from e
    if os.environ.get("TENANT_CLASSES", "").strip():
        parse_tenant_classes()  # a malformed entry names TENANT_CLASSES itself
    check_served_points()


# Knobs JAX's distilled backend ignores without a word (its engine is fixed:
# one slot, ff off, no prefix, the dense cache); the port logs each one set
DISTILLED_IGNORED = ("BRAIN_FF", "BRAIN_BATCH", "BRAIN_PREFIX", "KV_QUANT", "RADIX_ENABLE")


def make_parser_from_env():
    """``BRAIN_BACKEND=rule`` (the default: ``RuleBasedParser``, no model, no
    device), ``distilled[:<dir>]`` (``distilled.parser_from_env``: the
    in-repo trained checkpoint, ``SPEC_ENABLE`` passed through) or
    ``engine[:preset]`` (preset default ``tinyllama-1.1b``) with
    ``BRAIN_QUANT`` / ``BRAIN_FF`` / ``BRAIN_PREFIX``; ``BRAIN_BATCH`` slots
    behind the continuous batcher; ``BRAIN_PAGED=1`` the paged pool
    (``BRAIN_POOL_BLOCKS``), with ``RADIX_ENABLE=1`` session KV reuse and
    ``KV_QUANT=int8|int4`` the quantized pool (both read at engine
    construction); ``SPEC_ENABLE=1`` speculative decoding on either engine
    (``serve.spec.spec_from_env``: ``SPEC_K``, ``SPEC_DRAFTER``; the
    variables the port does not serve, and an unknown drafter, raise
    ``ValueError`` here, at boot); ``BRAIN_MOE=grouped`` the grouped-matmul
    MoE dispatch (a no-op on a dense preset, as in the JAX service). The
    engine runs on ``BRAIN_DEVICE`` (default ``cuda``: with no card it
    raises). ``check_unserved_knobs`` runs first, before any engine; the
    rule backend logs a warning for each engine knob set, as the JAX
    service does, and ignores it."""
    from ..serve.spec import spec_from_env

    check_unserved_knobs()
    slots = int(os.environ.get("BRAIN_BATCH", "1"))
    device = os.environ.get("BRAIN_DEVICE") or None
    paged = os.environ.get("BRAIN_PAGED") == "1"
    quant = os.environ.get("BRAIN_QUANT") or None
    moe = os.environ.get("BRAIN_MOE") == "grouped"
    spec = spec_from_env()  # None unless SPEC_ENABLE=1
    backend = os.environ.get("BRAIN_BACKEND", "rule")
    if backend == "rule":
        for name, val in (("BRAIN_PAGED", paged), ("BRAIN_QUANT", quant), ("BRAIN_MOE", moe),
                          ("SPEC_ENABLE", spec)):
            if val:
                log.warning("%s is not supported by the rule backend; ignoring", name)
        return RuleBasedParser()
    if backend == "distilled" or backend.startswith("distilled:"):
        from ..distilled import parser_from_env

        for name, val in (("BRAIN_PAGED", paged), ("BRAIN_QUANT", quant), ("BRAIN_MOE", moe)):
            if val:  # JAX's own warnings
                log.warning("%s is not supported by the distilled backend; ignoring", name)
        for name in DISTILLED_IGNORED:
            if os.environ.get(name, "").strip():
                log.warning("%s is ignored by the distilled backend (as in the JAX service)",
                            name)
        return parser_from_env(backend, device=device, spec=spec)
    if not backend.startswith("engine"):
        raise ValueError(f"BRAIN_BACKEND {backend!r} is not ported yet (the port serves rule, "
                         "distilled and engine[:preset]; the planner, pp / tp / sp layouts "
                         "and planner-distilled are ROADMAP.md Queue 1 item 8)")
    from ..models.llama import PRESETS
    from ..serve.engine import DecodeEngine
    from ..serve.paged import PagedDecodeEngine

    preset = backend.split(":", 1)[1] if ":" in backend else "tinyllama-1.1b"
    if preset not in PRESETS:
        raise ValueError(f"BRAIN_BACKEND {backend!r}: unknown preset {preset!r}")
    cfg = replace(PRESETS[preset], moe_impl="grouped") if moe else None
    kw = dict(preset=preset, cfg=cfg, quant=quant,
              fast_forward=int(os.environ.get("BRAIN_FF", "8")), device=device, spec=spec)
    if paged:
        pool = int(os.environ.get("BRAIN_POOL_BLOCKS", "0")) or None
        return _wrap_batched(PagedDecodeEngine(batch_slots=max(slots, 1), pool_blocks=pool,
                                               **kw))
    return _wrap_engine(DecodeEngine(batch_slots=slots, **kw))


# ---------------------------------------------------------------- app


# served routes: path (a prefix when it ends in "/") -> method
SERVED_ROUTES = (("/health", "GET"), ("/parse", "POST"), ("/metrics", "GET"),
                 (TRACE_ROUTE, "GET"), ("/debug/quality", "GET"), ("/debug/steplog", "GET"),
                 ("/debug/flightrecorder", "GET"), ("/debug/costs", "GET"),
                 (TIMESERIES_ROUTE, "GET"),
                 ("/admin/handoff/", "GET"), ("/admin/handoff", "POST"),
                 ("/admin/disagg/prefill", "POST"), ("/admin/disagg/adopt", "POST"),
                 ("/admin/drain", "POST"))

# request body caps: aiohttp's default client_max_size (1 MiB) everywhere,
# as the JAX brain runs it, and the handoff bound on the two routes that
# take a shipped session or a forwarded KV segment
MAX_BODY_BYTES = 1024 * 1024
HANDOFF_MAX_BYTES = 256 * 1024 * 1024
HANDOFF_ROUTES = ("/admin/handoff", "/admin/disagg/adopt")


def body_cap(method: str, path: str) -> int:
    """The most body bytes the brain reads for this request."""
    return HANDOFF_MAX_BYTES if method == "POST" and path in HANDOFF_ROUTES else MAX_BODY_BYTES


def over_cap_response(method: str, path: str, nbytes: int | None) -> tuple[int, dict]:
    """The answer to a body the brain will not read: 413 past the cap
    (``handoff_too_large`` with ``limit_bytes`` on the handoff routes, as
    JAX's), 411 for a chunked body with no ``Content-Length``."""
    cap = body_cap(method, path)
    if nbytes is None:
        return 411, {"error": "length_required",
                     "detail": "a request body needs a Content-Length"}
    if cap == HANDOFF_MAX_BYTES:
        return 413, {"error": "handoff_too_large", "limit_bytes": cap}
    return 413, {"error": "request_too_large",
                 "detail": f"body of {nbytes} bytes is past the {cap}-byte cap",
                 "limit_bytes": cap}


class StreamBody:
    """A response body written as it is produced: an iterator of byte
    chunks the HTTP layer sends with ``Transfer-Encoding: chunked``, each
    flushed as it comes. An iterator raising ``ConnectionDropped`` closes
    the connection with no final chunk (a torn stream)."""

    def __init__(self, chunks):
        self.chunks = chunks


def _match(path: str, table):
    for prefix, v in table:
        if prefix.endswith("/"):
            if path.startswith(prefix) and len(path) > len(prefix):
                return v
        elif path == prefix:
            return v
    return None


def shed_count(service: str, reason: str) -> None:
    """The ``<service>.shed_<reason>`` counter of an overload answer."""
    get_metrics().inc(f"{service}.shed_{reason}")


class ConnectionDropped(Exception):
    """Close the connection without a response: a chaos-killed replica, or
    a client that went away mid-parse."""


# the degraded answer the intent_downgrade latch serves (JAX's)
DOWNGRADED_RESPONSE = {"intents": [{"type": "unknown"}], "confidence": 0.1,
                       "follow_up_question": "I did not catch a browser action - "
                                             "could you rephrase?"}


class BrainApp:
    """The brain's handlers, free of any HTTP machinery: ``parse`` and
    ``health`` return (status, body, extra headers); ``handle`` routes any
    request and raises ``ConnectionDropped`` where no response may go out.
    One ``Tracer("brain")`` per app (its registry also holds the quality
    monitor's gauges), one ``SLOTracker("brain")``, one
    ``AdmissionController("brain")`` (``max_inflight``, default
    ``BRAIN_MAX_INFLIGHT`` or 32), one ``GoldenCanary`` (running only with
    ``QUALITY_CANARY_S`` > 0) and one time-series ring; ``start`` / ``close``
    start and stop the canary and the ring's sampler."""

    def __init__(self, parser, tracer: Tracer | None = None, max_inflight: int | None = None):
        self.parser = parser
        self.lock = threading.Lock()
        self.tracer = tracer or Tracer("brain", emit=False)
        self.slo = SLOTracker("brain")
        self.admission = AdmissionController(
            "brain", max_inflight if max_inflight is not None
            else int(os.environ.get("BRAIN_MAX_INFLIGHT", "32")))
        self.qmon = QualityMonitor("brain", metrics=self.tracer.metrics)
        # registered at zero, as in JAX: the downgrade latch counts through
        # the monitor's ledger
        self.qmon.metrics.inc("quality.intent_downgrades", 0.0)
        self._downgraded = False
        # the replica chaos latches: killed (every later request dropped),
        # degraded (every later /parse slow)
        self._dead = False
        self._slow = False
        # the drain latch /admin/drain sets (drained is computed, not latched)
        self._draining = False
        occupancy = float(os.environ.get("QUALITY_CANARY_OCCUPANCY", "0.5"))

        def busy() -> bool:
            if self.admission.inflight > 0:
                return True
            live = getattr(parser, "pressure_fractions", None)
            if live is None:
                return False
            try:
                fr = live()
            except Exception:  # noqa: BLE001 - a busy test never fails the canary
                return False
            return bool(fr) and max(fr.values()) >= occupancy

        self.canary = GoldenCanary(lambda text, ctx: self._do_parse(text, ctx, None, False),
                                   self.qmon, busy_fn=busy)
        self.ring = service_ring("brain", self.tracer)

    def start(self) -> None:
        """The serving-side threads: the golden canary, when enabled, and
        the time-series sampler."""
        self.canary.start()
        self.ring.start()

    def close(self) -> None:
        self.canary.stop()
        self.ring.stop()

    def pressure(self, slo_state: str) -> dict:
        """The shed signal the router's prober reads: the parser's live
        saturation fractions and the admission fraction, folded to one
        ``score``; a violated SLO is full, one at risk at least 0.95."""
        fracs = {}
        live = getattr(self.parser, "pressure_fractions", None)
        if live is not None:
            try:
                fracs = {k: round(float(v), 4) for k, v in live().items()}
            except Exception:  # noqa: BLE001 - a failed read is no pressure
                fracs = {}
        fracs["admission"] = round(self.admission.inflight / max(1, self.admission.max_inflight),
                                   4)
        score = max(fracs.values())
        if slo_state == "violated":
            score = 1.0
        elif slo_state == "at_risk":
            score = max(score, 0.95)
        return {"score": round(score, 4), "slo": slo_state, **fracs}

    def health(self) -> tuple[int, dict, dict]:
        engine = getattr(self.parser, "engine", None)
        healthy = getattr(self.parser, "healthy", lambda: True)()
        body = {"ok": healthy, "service": "brain", "slo": self.slo.state(),
                "quality": self.qmon.health(), "inflight": self.admission.inflight,
                "max_inflight": self.admission.max_inflight,
                # the disagg pool tag the router reads (BRAIN_ROLE), and
                # whether this backend can export and adopt a KV stream
                "role": os.environ.get("BRAIN_ROLE", "both"),
                "disagg": bool(getattr(self.parser, "supports_disagg", False))}
        if self._draining:
            body["draining"] = True
            body["drained"] = self._drained()
        qinfo = getattr(self.parser, "quarantine_info", None)
        if qinfo is not None:
            body["quarantine"] = qinfo()
        tenancy = getattr(getattr(self.parser, "batcher", None), "tenancy", None)
        if tenancy is not None:
            # the lanes' occupancy and ledgers (also in /debug/costs, as JAX)
            body["tenants"] = tenancy.snapshot()
        last_step = get_steplog().last()
        if last_step is not None:
            body["last_step"] = last_step
        body["pressure"] = self.pressure(body["slo"])
        if engine is not None:
            body.update(device=str(engine.device), kernels=engine.kernels,
                        quant=engine.quant, fast_forward=engine.fast_forward,
                        prefix_tokens=len(engine.prefix_ids),
                        batch_slots=engine.batch_slots,
                        paged=getattr(engine, "allocator", None) is not None,
                        radix=getattr(engine, "radix", None) is not None,
                        kv_quant=getattr(engine, "kv_quant", None),
                        moe_impl=engine.cfg.moe_impl, n_experts=engine.cfg.n_experts,
                        spec=(None if getattr(engine, "spec", None) is None else
                              {"k": engine.spec.K, "drafter": engine.spec.drafter.name}))
        return (200 if healthy else 503), body, {}

    def _do_parse(self, text: str, context: dict, session_id, speculative: bool) -> dict:
        """One parse through the downgrade latch and the parser (the
        serialization lock for a single-slot engine): what traffic and the
        canary both go through."""
        if self._downgraded or chaos_fire("intent_downgrade"):
            # the latch: fast, healthy-looking answers with quality on the floor
            self._downgraded = True
            self.qmon._count("quality.intent_downgrades")
            resp, _ = validate_parse_response(DOWNGRADED_RESPONSE)
            return resp
        guard = nullcontext() if getattr(self.parser, "concurrent_safe", False) else self.lock
        with guard:
            if getattr(self.parser, "wants_session", False):
                return self.parser.parse(text, context, session_id, speculative)
            if getattr(self.parser, "session_costs", None) is not None:
                # a stateless engine parser still attributes spend per
                # session: the id rides only into the cost fold
                return self.parser.parse(text, context, session_id)
            return self.parser.parse(text, context)

    def costs(self, req: Request) -> tuple[int, dict, dict]:
        """``GET /debug/costs`` in JAX's shape: ``enabled`` (a batcher with
        its cost meter), the meter's summary (integer ``totals``, ``mfu`` /
        ``mbu`` / ``mfu_prefill``, ``peak``, ``model``), the session rollup
        (``sessions``, ``top_sessions``; ``?top=N``, 1-64, default 8) and,
        under tenancy, ``tenants``."""
        batcher = getattr(self.parser, "batcher", None)
        meter = getattr(batcher, "costs", None)
        body: dict = {"service": "brain", "enabled": meter is not None}
        if meter is not None:
            body.update(meter.summary())
        sessions = getattr(self.parser, "session_costs", None)
        if sessions is not None:
            try:
                top_n = int(parse_qs(req.query or "").get("top", ["8"])[0])
            except ValueError:
                top_n = 8
            body["sessions"] = len(sessions)
            body["top_sessions"] = sessions.top(max(1, min(top_n, 64)))
        tenancy = getattr(batcher, "tenancy", None)
        if tenancy is not None:
            body["tenants"] = tenancy.snapshot()
        return 200, body, {}

    def parse(self, raw: bytes, req_headers=None, peer_gone=None) -> tuple[int, dict, dict]:
        """``req_headers``: the request's headers (any mapping with
        ``items()``, names in any case): ``x-trace-id`` and
        ``x-deadline-ms``. ``peer_gone``: the transport's probe of its
        client (``RequestContext``). The SLO sample covers the whole
        request; a 5xx burns error budget, a 4xx is an answer about the
        request. A client gone mid-parse raises ``ConnectionDropped``."""
        t0 = time.perf_counter()
        status, body, headers = self._parse(raw, req_headers, peer_gone)
        self.slo.record((time.perf_counter() - t0) * 1e3, ok=status < 500)
        return status, body, headers

    def _parse(self, raw: bytes, req_headers, peer_gone) -> tuple[int, dict, dict]:
        req_headers = {k.lower(): v for k, v in (req_headers or {}).items()}
        trace_id = req_headers.get("x-trace-id") or new_trace_id()
        headers = {"x-trace-id": trace_id}

        def error(status: int, kind: str, detail: str):
            return status, {"error": kind, "detail": detail[:500]}, headers

        def shed(reason: str, retry_after: str):
            shed_count("brain", reason)
            return 503, {"error": "overloaded", "detail": reason}, {
                **headers, "Retry-After": retry_after}

        try:
            body = json.loads(raw or b"")
        except (json.JSONDecodeError, UnicodeDecodeError):
            return error(400, "invalid_request", "body must be JSON")
        try:
            preq = validate_parse_request(body)
        except ValidationError as e:
            return error(400, "invalid_request", str(e))
        if preq["prefix_feed"] and not getattr(self.parser, "supports_prefix_feed", False):
            # the voice service latches its feeds off on this answer
            return error(409, "prefix_feed_unsupported",
                         "backend has no prefill-only admission path")
        deadline = Deadline.from_headers(req_headers)
        if deadline is not None and deadline.expired:
            # the caller already gave up: answering with work would burn a
            # decode on a response nobody reads
            return shed("deadline_expired", "0")
        if not self.admission.try_acquire():
            return shed("overload", str(int(self.admission.retry_after_s)))
        # the containment handle: the deadline into the scheduler, the
        # disconnect probe for the waiting parse
        # the tenant tag: the body's field first, the x-tenant header next
        ctx = RequestContext(deadline, peer_gone=peer_gone,
                             tenant=preq["tenant"] or req_headers.get("x-tenant"))
        if preq["prefix_feed"]:
            return self._feed(preq, ctx, error, headers)
        push_request_context(ctx)
        pop_stage_notes()  # drop a stale note of an earlier request on this thread
        try:
            with self.tracer.span("parse", trace_id=trace_id, chars=len(preq["text"])) as sp:
                try:
                    resp = self._do_parse(preq["text"], preq["context"], preq["session_id"],
                                          preq["speculative"])
                except ParserError as e:
                    if ctx.cancelled:
                        get_metrics().inc("brain.parses_cancelled")
                        raise ConnectionDropped("client disconnected mid-parse") from e
                    if e.kind == "overloaded":
                        shed_count("brain", "engine_overload")
                        headers["Retry-After"] = "1"
                        return error(503, e.kind, e.detail)
                    status = 422 if e.kind == "schema_validation_failed" else 500
                    return error(status, e.kind, e.detail)
                except Exception as e:  # engine crash etc.
                    return error(500, "llm_error", str(e))
                # the parser noted the split on THIS thread, from its own result
                notes = pop_stage_notes()
                sp.attrs.update(notes)
        finally:
            pop_request_context()
            self.admission.release()
        self.qmon.record_intent(margin=notes.get("intent_margin"),
                                entropy=notes.get("intent_entropy"),
                                forced_frac=notes.get("intent_forced_frac"),
                                downgraded=self._downgraded, text=preq["text"])
        for note, header in (("prefill_ms", "x-prefill-ms"), ("decode_ms", "x-decode-ms"),
                             ("cached_tokens", "x-cached-tokens"),
                             ("prompt_tokens", "x-prompt-tokens"),
                             ("intent_margin", "x-intent-margin")):
            if note in notes:
                headers[header] = str(notes[note])
        if (preq["speculative"] and getattr(self.parser, "wants_session", False)
                and preq["session_id"]):
            # a pending two-phase turn: the matching final parse commits it
            headers["x-speculation-pending"] = "1"
        return 200, resp, headers

    def _feed(self, preq: dict, ctx, error, headers: dict) -> tuple[int, dict, dict]:
        """A prefix feed: prefill-only admission, cache warming and not a
        parse (no decode, no transcript commit, no quality record). A shed
        is a 200 carrying ``ok: false``: feeds are best-effort and never
        retried. Holds an admission slot as a parse does."""
        push_request_context(ctx)
        try:
            out = self.parser.feed_prefix(preq["text"], preq["context"], preq["session_id"])
        except Exception as e:  # noqa: BLE001 - the feed's engine fault
            return error(500, "llm_error", str(e))
        finally:
            pop_request_context()
            self.admission.release()
        return 200, {"prefix_feed": True, **out}, headers

    # ------------------------------------------------------------ admin

    def _drained(self) -> bool:
        if not self._draining:
            return False
        probe = getattr(self.parser, "drained", None)
        if probe is not None:
            return bool(probe())
        return self.admission.inflight == 0

    def drain(self) -> tuple[int, dict, dict]:
        """``POST /admin/drain``: latch draining (``brain.drains_received``,
        the parser's ``begin_drain``). Nothing is refused after it."""
        if not self._draining:
            self._draining = True
            get_metrics().inc("brain.drains_received")
            hook = getattr(self.parser, "begin_drain", None)
            if hook is not None:
                hook()
        return 200, {"ok": True, "draining": True, "drained": self._drained()}, {}

    def handoff_get(self, session_id: str) -> tuple[int, dict | bytes, dict]:
        """``GET /admin/handoff/{id}``: the session's warm state as one
        ``TVAH1`` blob, 404 ``no_warm_state`` for an unknown session, 404
        ``handoff_unsupported`` on a backend without the surface."""
        exporter = getattr(self.parser, "export_session", None)
        if exporter is None:
            return 404, {"error": "handoff_unsupported"}, {}
        blob = exporter(session_id)
        if not blob:
            return 404, {"error": "no_warm_state", "session_id": session_id}, {}
        return 200, blob, {"Content-Type": "application/octet-stream"}

    def handoff_post(self, blob: bytes) -> tuple[int, dict, dict]:
        """``POST /admin/handoff``: adopt a shipped session. A ``TVAF1``
        framed body is reassembled first; bad frames are a counted cold
        fallback answered 200, never an install of torn bytes."""
        from ..serve import handoff

        adopter = getattr(self.parser, "adopt_session", None)
        if adopter is None:
            return 404, {"error": "handoff_unsupported"}, {}
        if blob.startswith(handoff.FRAME_MAGIC):
            try:
                blob = handoff.deframe(blob)
            except ValueError as e:
                get_metrics().inc("handoff.adopt_fallbacks")
                return 200, {"ok": True, "adopted_tokens": 0, "reason": f"bad frames: {e}"}, {}
        return 200, {"ok": True, "adopted_tokens": int(adopter(blob))}, {}

    def disagg_prefill(self, raw: bytes) -> tuple[int, dict | StreamBody, dict]:
        """``POST /admin/disagg/prefill``: run a prefill-only export and
        answer a chunked body of ``TVAF1`` frames, one ``kv_seg`` blob each,
        written while later chunks still compute, then the ``kv_end``
        summary on the FINAL frame. A shed before any segment answers JSON
        (no stream to tear). The chaos point ``prefill_replica_kill`` drops
        the connection between frame writes."""
        from ..serve import handoff

        exporter = getattr(self.parser, "disagg_prefill", None)
        if exporter is None:
            return 404, {"error": "disagg_unsupported"}, {}
        try:
            body = json.loads(raw or b"")
            if not isinstance(body, dict):
                raise ValueError("not an object")
            stream_blocks = max(1, int(body.get("stream_blocks") or 4))
        except (ValueError, TypeError, UnicodeDecodeError):
            return 400, {"error": "invalid_request", "detail": "body must be JSON"}, {}
        text = str(body.get("text") or "")
        context = body.get("context") or {}
        sid = body.get("session_id") or None
        stream_id = str(body.get("stream") or new_trace_id())
        q: queue.Queue = queue.Queue()
        done = object()
        result: dict = {}

        def run() -> None:
            try:
                result["out"] = exporter(text, context, sid, stream_blocks=stream_blocks,
                                         emit=q.put, stream_id=stream_id)
            except Exception as e:  # noqa: BLE001 - answered as a shed
                result["out"] = {"ok": False, "reason": f"{type(e).__name__}: {e}"}
            finally:
                q.put(done)

        threading.Thread(target=run, name="brain-disagg-export", daemon=True).start()
        first = q.get()
        if first is done:  # shed, too long, or nothing past the prefix to ship
            return 200, {"disagg_prefill": True, **(result.get("out") or {})}, {}

        def frames():
            seq, item = 0, first
            while item is not done:
                if chaos_fire("prefill_replica_kill"):
                    raise ConnectionDropped("chaos: prefill replica killed")
                yield handoff.frame_pack(seq, item)
                seq += 1
                item = q.get()
            out = result.get("out") or {}
            summary = {k: v for k, v in out.items()
                       if k in ("ok", "reason", "prompt_tokens", "cached_tokens",
                                "chain_tokens", "segments")}
            yield handoff.frame_pack(seq, handoff.pack_kv_end(stream_id, summary), final=True)

        return 200, StreamBody(frames()), {"Content-Type": "application/x-tva-frames",
                                           "x-disagg-stream": stream_id}

    def disagg_adopt(self, req: Request) -> tuple[int, dict, dict]:
        """``POST /admin/disagg/adopt``: one forwarded stream blob into the
        adopter of the ``x-disagg-stream`` header's stream."""
        adopter = getattr(self.parser, "adopt_stream", None)
        if adopter is None:
            return 404, {"error": "disagg_unsupported"}, {}
        stream_id = req.headers.get("x-disagg-stream")
        if not stream_id:
            return 400, {"error": "invalid_request",
                         "detail": "x-disagg-stream header required"}, {}
        return 200, adopter(stream_id, req.body), {}

    def _replica_chaos(self, req: Request) -> None:
        """The replica chaos points, drawn on ``POST /parse`` only (a health
        probe never consumes an ``@k`` count): ``replica_kill`` latches the
        app dead and drops the connection; ``replica_degrade`` latches it
        slow; ``replica_hang`` sleeps ``CHAOS_HANG_S`` (60), ``replica_slow``
        ``CHAOS_SLOW_S`` (0.25). Chaos off: one dict miss a point."""
        if self._dead:
            raise ConnectionDropped("chaos: replica killed")
        if req.method == "POST" and req.path == "/admin/handoff":
            # a joining brain wedged in its pre-warm adopt
            if chaos_fire("replica_join_stall"):
                time.sleep(float(os.environ.get("CHAOS_HANG_S", "60")))
        if req.method != "POST" or req.path != "/parse":
            return
        if chaos_fire("replica_kill"):
            self._dead = True
            raise ConnectionDropped("chaos: replica killed")
        if chaos_fire("replica_degrade"):
            self._slow = True
        if chaos_fire("replica_hang"):
            time.sleep(float(os.environ.get("CHAOS_HANG_S", "60")))
        elif self._slow or chaos_fire("replica_slow"):
            time.sleep(float(os.environ.get("CHAOS_SLOW_S", "0.25")))

    def handle(self, req: Request, peer_gone=None) -> tuple[int, object, dict]:
        """Route one request: a served route (every route of the JAX
        brain), 405 for another method on it, 404 for a path JAX does not
        route either. ``peer_gone`` reaches ``parse``."""
        self._replica_chaos(req)
        method = _match(req.path, SERVED_ROUTES)
        if method is None:
            return 404, {"error": "not_found", "detail": req.path}, {}
        if req.method != method:
            return 405, {"error": "method_not_allowed", "detail": req.method}, {}
        if req.path == "/parse":
            return self.parse(req.body, req.headers, peer_gone)
        if req.path == "/health":
            return self.health()
        if req.path == "/debug/costs":
            return self.costs(req)
        if req.path == "/admin/drain":
            return self.drain()
        if req.path == "/admin/handoff":
            return self.handoff_post(req.body)
        if req.path.startswith("/admin/handoff/"):
            return self.handoff_get(req.path[len("/admin/handoff/"):])
        if req.path == "/admin/disagg/prefill":
            return self.disagg_prefill(req.body)
        if req.path == "/admin/disagg/adopt":
            return self.disagg_adopt(req)
        if req.path == "/metrics":
            r = metrics_response("brain", self.tracer, req, slo=self.slo)
        elif req.path == "/debug/quality":
            r = self.qmon.response()
        elif req.path == "/debug/steplog":
            r = steplog_response("brain", req)
        elif req.path == "/debug/flightrecorder":
            r = flightrecorder_response("brain", req)
        elif req.path == TIMESERIES_ROUTE:
            r = timeseries_response(self.ring, req)
        else:
            r = trace_response("brain", self.tracer, req)
        return r.status, r.body, r.headers


def socket_gone(sock: socket.socket) -> bool:
    """True when the peer of ``sock`` has closed it (a peek reads nothing)
    or reset it. Peeks without waiting, so request bytes stay. ``poll``,
    not ``select``: a busy server's descriptors pass FD_SETSIZE. A probe
    that cannot tell says the peer is there: the parse then ends on its
    result or its timeout."""
    try:
        p = select.poll()
        p.register(sock, select.POLLIN)
        if not p.poll(0):
            return False
        return sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
    except ConnectionError:  # reset, aborted, broken pipe
        return True
    except (OSError, ValueError):  # would block, or no descriptor to ask
        return False


def make_server(app: BrainApp, host: str = "127.0.0.1", port: int = 8090) -> ThreadingHTTPServer:
    """An HTTP server over ``app`` (``port=0`` picks a free one); starts
    the app's canary (``app.close()`` stops it)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, status: int, body, headers: dict) -> None:
            if isinstance(body, StreamBody):
                return self._send_stream(status, body, headers)
            if isinstance(body, bytes):
                data, ctype = body, "application/octet-stream"
            elif isinstance(body, str):
                data, ctype = body.encode(), "text/plain; charset=utf-8"
            else:
                data, ctype = json.dumps(body).encode(), "application/json"
            headers = {"Content-Type": ctype, **headers}
            self.send_response(status)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _send_stream(self, status: int, body: StreamBody, headers: dict) -> None:
            """Chunked transfer, one flushed chunk per item; a drop mid-way
            closes the socket with no final chunk."""
            self.send_response(status)
            self.send_header("Transfer-Encoding", "chunked")
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.flush()
            try:
                for chunk in body.chunks:
                    if chunk:
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
                        self.wfile.flush()
            except ConnectionDropped:
                self._drop()
                return
            except OSError:  # the client went away mid-stream
                self.close_connection = True
                return
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        def _drop(self) -> None:
            """No (further) response: the client sees the connection close."""
            self.close_connection = True
            try:
                self.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

        def _refuse_body(self, status: int, body: dict) -> None:
            """Answer without reading the body, then close: the unread bytes
            are discarded in small pieces for at most a second, so the close
            does not reset the connection under the client's read."""
            self.close_connection = True
            self._send(status, body, {"Connection": "close"})
            self.wfile.flush()
            sock = self.connection
            try:
                sock.shutdown(socket.SHUT_WR)
                sock.settimeout(0.2)
                give_up = time.monotonic() + 1.0
                while time.monotonic() < give_up and sock.recv(65536):
                    pass
            except OSError:
                pass

        def _route(self, method: str) -> None:
            path, _, query = self.path.partition("?")
            raw_len = self.headers.get("Content-Length")
            chunked = "chunked" in (self.headers.get("Transfer-Encoding") or "").lower()
            try:
                n = int(raw_len) if raw_len is not None else (None if chunked else 0)
            except ValueError:
                n = -1
            if n is not None and n < 0:
                return self._refuse_body(400, {"error": "invalid_request",
                                               "detail": "bad Content-Length"})
            if n is None or n > body_cap(method, path):
                # never read past the cap, nor a body of unknown length
                return self._refuse_body(*over_cap_response(method, path, n))
            raw = self.rfile.read(n) if n else b""
            sock = self.connection
            try:
                out = app.handle(Request(method, path, query, Headers(self.headers.items()), raw),
                                 peer_gone=lambda: socket_gone(sock))
            except ConnectionDropped:
                self._drop()
                return
            self._send(*out)

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def log_message(self, fmt, *args):  # quiet: one line per request is noise
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    app.start()
    return server


def main() -> None:
    # the repo-root .env first: its knobs are served or refused like the
    # environment's
    load_env_cascade()
    port = int(os.environ.get("BRAIN_PORT", "8090"))
    app = BrainApp(make_parser_from_env(), tracer=Tracer("brain"))
    server = make_server(app, host="0.0.0.0", port=port)
    print(f"brain: serving /parse on :{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        app.close()


if __name__ == "__main__":
    main()
