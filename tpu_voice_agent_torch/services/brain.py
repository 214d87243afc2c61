"""Brain service: text + context -> validated intent plan.

Port of the rule and engine paths of ``tpu_voice_agent/services/brain.py``.
``POST /parse`` takes ``{text, session_id?, context, speculative?}`` and
answers with the ParseResponse dict (every default field filled, as
pydantic's ``model_dump()`` fills it); errors come back as
``{"error", "detail"}``:

- 400 ``invalid_request``: the body is not JSON or not a ParseRequest;
- 409 ``prefix_feed_unsupported``: no prefill-only admission path is ported;
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
``GET /debug/quality``, ``GET /debug/steplog`` and ``GET
/debug/flightrecorder`` are served; the JAX brain's other routes answer 501
``not_ported`` with the ROADMAP.md Queue 1 item that brings them
(``UNPORTED_ROUTES``). The HTTP layer is the standard library's
``ThreadingHTTPServer``.

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
``PREFILL_CHUNK_TOKENS`` (read by the batcher), ``STEPLOG_*``, ``FLIGHT_*``,
``QUALITY_CANARY_S`` / ``QUALITY_CANARY_SLICE`` / ``QUALITY_CANARY_OCCUPANCY``
(the golden-replay canary, started by ``make_server``), and ``CHAOS_FAULTS`` /
``CHAOS_SEED`` with ``CHAOS_HANG_S`` / ``CHAOS_SLOW_S``: the replica points
draw on ``POST /parse`` only (``replica_kill`` latches and closes every later
connection without a response, ``replica_hang`` / ``replica_slow`` sleep,
``replica_degrade`` latches slow), and ``intent_downgrade`` latches a
rule-fallback "unknown" answer. The JAX service's knobs and chaos points
that the port does not serve raise ``ValueError`` at boot
(``check_unserved_knobs``).
"""

from __future__ import annotations

import json
import logging
import os
import re
import select
import socket
import threading
import time
from collections import OrderedDict
from dataclasses import replace
from concurrent.futures import CancelledError, Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from contextlib import nullcontext
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..schemas import (
    ValidationError,
    parse_response_from_json,
    validate_parse_request,
    validate_parse_response,
)
from ..utils.chaos import chaos_fire, check_served_points
from ..utils.quality import GoldenCanary, QualityMonitor
from ..utils.steplog import get_steplog, steplog_response
from ..utils.tracing import (
    TRACE_ROUTE,
    Tracer,
    flightrecorder_response,
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
    (text, context) always renders the same bytes. LRU over ``MAX_SESSIONS``
    sessions."""

    MAX_SESSIONS = 256

    def __init__(self, tokenizer, render=None):
        self.tokenizer = tokenizer
        self.render = render or render_prompt
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
            while len(self._hist) > self.MAX_SESSIONS:
                self._hist.popitem(last=False)

    def forget(self, session_id: str) -> None:
        with self._lock:
            self._hist.pop(session_id, None)


class ServingLoop:
    """One thread that steps a ``ContinuousBatcher``: ``submit`` queues a
    prompt (with its ``Deadline``) and returns a ``Future`` of its
    GenerationResult. New requests join at chunk boundaries; one the batcher
    refuses at submit (a quarantined prompt) resolves before the next step.
    Every batcher call runs on the loop's thread. A fault out of ``step`` (a
    CUDA error is never handled per request) fails every in-flight future
    and stops the loop; ``healthy`` turns False and later submits fail at
    once."""

    def __init__(self, batcher):
        self.batcher = batcher
        self._cv = threading.Condition()
        self._inbox: list[tuple[object, object, Future]] = []
        self._abandoned: set[Future] = set()
        self._futures: dict[int, Future] = {}
        self._stop = False
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="brain-batcher", daemon=True)
        self._thread.start()

    def submit(self, prompt, deadline=None) -> Future:
        fut: Future = Future()
        with self._cv:
            if self.error is not None or self._stop:
                fut.set_exception(RuntimeError(f"serving loop stopped: {self.error}"))
                return fut
            self._inbox.append((prompt, deadline, fut))
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
        return self.error is None and self._thread.is_alive()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=60)

    def _run(self) -> None:
        b = self.batcher
        while True:
            with self._cv:
                while not (self._inbox or self._abandoned or b.busy() or self._stop):
                    self._cv.wait()
                if self._stop:
                    return
                inbox, self._inbox = self._inbox, []
                gone, self._abandoned = self._abandoned, set()
            try:
                for prompt, deadline, fut in inbox:
                    if fut not in gone:
                        self._futures[b.submit(prompt, deadline=deadline)] = fut
                for r in [r for r, f in self._futures.items() if f in gone]:
                    b.cancel(r, "client gone")
                    self._futures.pop(r)
                    b.results.pop(r, None)  # nobody reads it
                for fut in gone:
                    fut.cancel()
                self._resolve()  # refused at submit: answered before any step
                b.step()
                self._resolve()
            except BaseException as e:  # noqa: BLE001 - every waiter must hear of it
                with self._cv:
                    self.error = e
                    waiting = (list(self._futures.values())
                               + [f for *_, f in inbox + self._inbox])
                    self._futures.clear()
                    self._inbox.clear()
                for fut in waiting:
                    _settle(fut.set_exception, e)
                return

    def _resolve(self) -> None:
        b = self.batcher
        for rid in [r for r in self._futures if r in b.results]:
            _settle(self._futures.pop(rid).set_result, b.results.pop(rid))


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
        # sid -> the pending two-phase speculative turn, LRU-capped
        self._pending: OrderedDict[str, dict] = OrderedDict()
        self._plock = threading.Lock()
        self._tls = threading.local()
        self.loop = ServingLoop(self.batcher)

    @property
    def last_result(self):
        """The calling thread's most recent GenerationResult (None after a
        speculative commit, which decodes nothing)."""
        return getattr(self._tls, "result", None)

    def _decode(self, prompt):
        ctx = current_request_context()
        fut = self.loop.submit(prompt, deadline=ctx.deadline if ctx is not None else None)
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

    def parse(self, text: str, context: dict, session_id: str | None = None,
              speculative: bool = False) -> dict:
        self._tls.result = None
        if self.transcripts is None or not session_id:
            return _result_to_response(self._decode(self.render(text, context)))
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
        resp = _result_to_response(res)  # raises on truncation: the session
        # stays at its last committed turn
        if speculative:
            with self._plock:
                self._pending[session_id] = {"user": user, "resp": resp, "prompt": prompt,
                                             "gen": list(res.token_ids),
                                             "notes": peek_stage_notes()}
                self._pending.move_to_end(session_id)
                while len(self._pending) > SessionTranscripts.MAX_SESSIONS:
                    self._pending.popitem(last=False)
        else:
            self.transcripts.record(session_id, prompt, res.token_ids)
        return resp

    def healthy(self) -> bool:
        return self.loop.healthy()

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


# Knobs of features the port lacks -> the ROADMAP.md Queue 1 item that
# brings them: any set, non-empty value is refused. Unset or empty is the JAX
# default (no tenant classes, so no preemption) or, for ENGINE_STALL_S, what
# the port has instead of the JAX serving loop's watchdog: none.
UNSERVED_KNOBS = {"TENANT_CLASSES": (4, "tenancy"), "TENANT_PREEMPT": (4, "tenancy"),
                  "ENGINE_STALL_S": (6, "the stalled-step watchdog")}


def check_unserved_knobs() -> None:
    """Refuse at boot what the JAX brain would honour and the port would
    silently ignore: ``BRAIN_MODEL`` (no checkpoint import yet), a radix knob
    at another value than the port's constant, the knobs of features the
    port lacks, and a ``CHAOS_FAULTS`` that names an unknown point or arms
    one the port does not serve. The radix knobs stay fixed until ROADMAP.md
    Queue 1 item 4 (the rest of continuous batching) lands."""
    from ..serve.paged import PRESSURE_WINDOW_S, RADIX_MAX_NODES

    if os.environ.get("BRAIN_MODEL"):
        raise ValueError("BRAIN_MODEL is not ported yet (the PyTorch port has no checkpoint "
                         "import: ROADMAP.md Queue 1 item 8); unset it")
    fixed_knobs = {"RADIX_SESSIONS": (int, SessionTranscripts.MAX_SESSIONS),
                   "RADIX_MAX_NODES": (int, RADIX_MAX_NODES),
                   "RADIX_PRESSURE_S": (float, PRESSURE_WINDOW_S)}
    for name, (kind, fixed) in fixed_knobs.items():
        raw = os.environ.get(name, "").strip()
        if not raw:
            continue
        try:
            ok = kind(raw) == fixed
        except ValueError:
            ok = False
        if not ok:
            raise ValueError(f"{name}={raw!r}: the port serves {name} at {fixed} only "
                             "(configurable with ROADMAP.md Queue 1 item 4); unset it")
    for name, (item, what) in UNSERVED_KNOBS.items():
        raw = os.environ.get(name, "").strip()
        if raw:
            raise ValueError(f"{name}={raw!r}: {what} is not ported yet (ROADMAP.md Queue 1 "
                             f"item {item}); unset it")
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


# Routes of the JAX brain that the port does not serve: path (a prefix when
# it ends in "/") -> the ROADMAP.md Queue 1 item that brings it
UNPORTED_ROUTES = (
    ("/debug/costs", 7), ("/debug/timeseries", 7), ("/admin/handoff", 6), ("/admin/handoff/", 6),
    ("/admin/disagg/prefill", 6), ("/admin/disagg/adopt", 6), ("/admin/drain", 6),
)
# served routes: path (a prefix when it ends in "/") -> method
SERVED_ROUTES = (("/health", "GET"), ("/parse", "POST"), ("/metrics", "GET"),
                 (TRACE_ROUTE, "GET"), ("/debug/quality", "GET"), ("/debug/steplog", "GET"),
                 ("/debug/flightrecorder", "GET"))


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
    ``BRAIN_MAX_INFLIGHT`` or 32) and one ``GoldenCanary`` (``start`` /
    ``close``: running only with ``QUALITY_CANARY_S`` > 0)."""

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

    def start(self) -> None:
        """The serving-side threads: the golden canary, when enabled."""
        self.canary.start()

    def close(self) -> None:
        self.canary.stop()

    def health(self) -> tuple[int, dict, dict]:
        engine = getattr(self.parser, "engine", None)
        healthy = getattr(self.parser, "healthy", lambda: True)()
        body = {"ok": healthy, "service": "brain", "slo": self.slo.state(),
                "quality": self.qmon.health(), "inflight": self.admission.inflight,
                "max_inflight": self.admission.max_inflight}
        qinfo = getattr(self.parser, "quarantine_info", None)
        if qinfo is not None:
            body["quarantine"] = qinfo()
        last_step = get_steplog().last()
        if last_step is not None:
            body["last_step"] = last_step
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
            return self.parser.parse(text, context)

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
        if preq["prefix_feed"]:
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
        ctx = RequestContext(deadline, peer_gone=peer_gone)
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

    def _replica_chaos(self, req: Request) -> None:
        """The replica chaos points, drawn on ``POST /parse`` only (a health
        probe never consumes an ``@k`` count): ``replica_kill`` latches the
        app dead and drops the connection; ``replica_degrade`` latches it
        slow; ``replica_hang`` sleeps ``CHAOS_HANG_S`` (60), ``replica_slow``
        ``CHAOS_SLOW_S`` (0.25). Chaos off: one dict miss a point."""
        if self._dead:
            raise ConnectionDropped("chaos: replica killed")
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

    def handle(self, req: Request, peer_gone=None) -> tuple[int, dict | str, dict]:
        """Route one request: a served route, 405 for another method on it,
        501 ``not_ported`` naming the item for a JAX route the port lacks,
        and 404 only for a path the JAX brain does not route either.
        ``peer_gone`` reaches ``parse``."""
        self._replica_chaos(req)
        method = _match(req.path, SERVED_ROUTES)
        if method is None:
            item = _match(req.path, UNPORTED_ROUTES)
            if item is not None:
                return 501, {"error": "not_ported",
                             "detail": f"ROADMAP.md Queue 1 item {item}"}, {}
            return 404, {"error": "not_found", "detail": req.path}, {}
        if req.method != method:
            return 405, {"error": "method_not_allowed", "detail": req.method}, {}
        if req.path == "/parse":
            return self.parse(req.body, req.headers, peer_gone)
        if req.path == "/health":
            return self.health()
        if req.path == "/metrics":
            r = metrics_response("brain", self.tracer, req, slo=self.slo)
        elif req.path == "/debug/quality":
            r = self.qmon.response()
        elif req.path == "/debug/steplog":
            r = steplog_response("brain", req)
        elif req.path == "/debug/flightrecorder":
            r = flightrecorder_response("brain", req)
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

        def _send(self, status: int, body: dict | str, headers: dict) -> None:
            if isinstance(body, str):
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

        def _route(self, method: str) -> None:
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            path, _, query = self.path.partition("?")
            sock = self.connection
            try:
                out = app.handle(Request(method, path, query, Headers(self.headers.items()), raw),
                                 peer_gone=lambda: socket_gone(sock))
            except ConnectionDropped:
                # no response at all: the client sees the connection close
                self.close_connection = True
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
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
