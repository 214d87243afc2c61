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
  or the batcher shed it (the KV pool stayed exhausted);
- 500 ``llm_error``: the engine failed (poisoned row, prompt too long, ...).

A single-slot parser is serialized by one lock (one KV cache); the batched
parser (``BRAIN_BATCH`` > 1) is ``concurrent_safe``: its requests share
decode chunks on one serving thread. A session-aware parser (paged engine
with ``RADIX_ENABLE=1``) receives ``session_id`` and ``speculative``.
``GET /health`` reports the backend and its device. The HTTP layer is the
standard library's ``ThreadingHTTPServer``.

    BRAIN_BACKEND=engine:tinyllama-1.1b BRAIN_QUANT=int8 \\
        python -m tpu_voice_agent_torch.services.brain

Environment (the JAX service's names): ``BRAIN_BACKEND`` (``rule``, the
default: ``RuleBasedParser``, no model and no device; or
``engine[:preset]``, preset default ``tinyllama-1.1b``), ``BRAIN_QUANT`` (``int8``), ``BRAIN_FF``
(fast-forward width, default 8), ``BRAIN_PREFIX`` (``0`` skips the cached
prompt prefix), ``BRAIN_PORT`` (default 8090), ``BRAIN_BATCH`` (slots,
default 1), ``BRAIN_PAGED`` (``1``: the paged KV pool), ``BRAIN_POOL_BLOCKS``
(pool size, default the dense worst case), ``BRAIN_CHUNK`` (decode steps per
chunk, default 16), ``RADIX_ENABLE`` (``1``: session KV reuse on the paged
pool), ``KV_QUANT`` (``int8`` / ``int4``: the quantized paged pool),
``BRAIN_MOE`` (``grouped``: the grouped-matmul MoE dispatch on an MoE
preset such as ``mixtral-8x7b``), and ``BRAIN_DEVICE`` (default ``cuda``;
``cpu`` runs the plain versions). The JAX service's knobs that the port
does not serve raise ``ValueError`` at boot (``check_unserved_knobs``).
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import uuid
from collections import OrderedDict
from dataclasses import replace
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from contextlib import nullcontext
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..schemas import (
    ValidationError,
    parse_response_from_json,
    validate_parse_request,
    validate_parse_response,
)
from .prompts import render_prompt
from .resilience import Deadline

log = logging.getLogger("tpu_voice_agent_torch.brain")


class ParserError(Exception):
    def __init__(self, kind: str, detail: str):
        super().__init__(detail)
        self.kind = kind  # "schema_validation_failed" | "overloaded" | "llm_error"
        self.detail = detail


def _result_to_response(res) -> dict:
    """GenerationResult -> the ParseResponse dict, with the service's
    error mapping: a shed request (``shed: ...``) is ``overloaded``, any
    other failure (a poisoned row) ``llm_error``, a decode that never
    reached EOS ``schema_validation_failed``."""
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
    prompt and returns a ``Future`` of its GenerationResult. New requests
    join at chunk boundaries. A fault out of ``step`` (a CUDA error is never
    handled per request) fails every in-flight future and stops the loop;
    ``healthy`` turns False and later submits fail at once."""

    def __init__(self, batcher):
        self.batcher = batcher
        self._cv = threading.Condition()
        self._inbox: list[tuple[object, Future]] = []
        self._abandoned: set[Future] = set()
        self._futures: dict[int, Future] = {}
        self._stop = False
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="brain-batcher", daemon=True)
        self._thread.start()

    def submit(self, prompt) -> Future:
        fut: Future = Future()
        with self._cv:
            if self.error is not None or self._stop:
                fut.set_exception(RuntimeError(f"serving loop stopped: {self.error}"))
                return fut
            self._inbox.append((prompt, fut))
            self._cv.notify()
        return fut

    def abandon(self, fut: Future) -> None:
        """Drop a request nobody waits for: a queued one leaves the queue;
        one already decoding finishes and its result is discarded."""
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
            for prompt, fut in inbox:
                if fut not in gone:
                    self._futures[b.submit(prompt)] = fut
            for r in [r for r, f in self._futures.items() if f in gone]:
                if b.cancel(r):  # still queued; a decoding one finishes unread
                    self._futures.pop(r)
            try:
                b.step()
            except BaseException as e:  # noqa: BLE001 - every waiter must hear of it
                with self._cv:
                    self.error = e
                    waiting = list(self._futures.values()) + [f for _, f in self._inbox]
                    self._futures.clear()
                    self._inbox.clear()
                for fut in waiting:
                    if not fut.done():
                        fut.set_exception(e)
                return
            for rid in [r for r in self._futures if r in b.results]:
                fut = self._futures.pop(rid)
                res = b.results.pop(rid)
                if not fut.done():
                    fut.set_result(res)


class BatchedEngineParser:
    """Continuous-batched grammar-constrained decode behind /parse.

    Concurrent requests share chunked decode dispatches on one engine
    through a ``ServingLoop``; each parse waits on its future for at most
    ``timeout_s``. With ``session_aware`` (a paged engine with radix reuse)
    a per-session transcript makes turn N's prompt a strict token extension
    of turn N-1's. Speculative turns run two-phase: the provisional turn
    decodes, but the transcript advances only when the matching final
    commits it (answered from the cached plan, no decode). ``render`` maps
    (text, context) -> prompt, as ``EngineParser``'s does."""

    concurrent_safe = True  # BrainApp skips the serialization lock

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
        fut = self.loop.submit(prompt)
        try:
            res = fut.result(timeout=self.timeout_s)
        except FutureTimeout as e:
            self.loop.abandon(fut)
            raise ParserError("llm_error", "batched decode timed out") from e
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
            # commit: the speculative turn IS this turn
            self.transcripts.record(session_id, pend["prompt"], pend["gen"])
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
                                             "gen": list(res.token_ids)}
                self._pending.move_to_end(session_id)
                while len(self._pending) > SessionTranscripts.MAX_SESSIONS:
                    self._pending.popitem(last=False)
        else:
            self.transcripts.record(session_id, prompt, res.token_ids)
        return resp

    def healthy(self) -> bool:
        return self.loop.healthy()

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


# Knobs of features the port lacks: any set, non-empty value is refused.
# Unset or empty is the JAX default (one-shot prefill, no quarantine list,
# no tenant preemption, no admission cap, no tenant classes, no injected
# faults) or, for ENGINE_STALL_S, what the port has instead of the JAX
# serving loop's watchdog: none.
UNSERVED_KNOBS = ("PREFILL_CHUNK_TOKENS", "QUARANTINE_AFTER", "TENANT_PREEMPT",
                  "BRAIN_MAX_INFLIGHT", "TENANT_CLASSES", "CHAOS_FAULTS", "ENGINE_STALL_S")


def check_unserved_knobs() -> None:
    """Refuse at boot what the JAX brain would honour and the port would
    silently ignore: ``BRAIN_MODEL`` (no checkpoint import yet), a radix knob
    at another value than the port's constant, and the knobs of features the
    port lacks. The radix knobs stay fixed until ROADMAP.md Queue 1 item 4
    (the rest of continuous batching) lands."""
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
    for name in UNSERVED_KNOBS:
        raw = os.environ.get(name, "").strip()
        if raw:
            raise ValueError(f"{name}={raw!r} is not ported yet (ROADMAP.md Queue 1 item 4, "
                             "the rest of continuous batching); unset it")


def make_parser_from_env():
    """``BRAIN_BACKEND=rule`` (the default: ``RuleBasedParser``, no model, no
    device) or ``engine[:preset]`` (preset default ``tinyllama-1.1b``) with
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
    if not backend.startswith("engine"):
        raise ValueError(f"BRAIN_BACKEND {backend!r} is not ported (rule, engine[:preset])")
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


class BrainApp:
    """The /parse and /health handlers, free of any HTTP machinery: each
    returns (status, body dict, extra headers)."""

    def __init__(self, parser):
        self.parser = parser
        self.lock = threading.Lock()

    def health(self) -> tuple[int, dict, dict]:
        engine = getattr(self.parser, "engine", None)
        healthy = getattr(self.parser, "healthy", lambda: True)()
        body = {"ok": healthy, "service": "brain"}
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

    def parse(self, raw: bytes, req_headers=None) -> tuple[int, dict, dict]:
        """``req_headers``: the request's headers (any mapping with
        ``items()``, names in any case): ``x-trace-id`` and
        ``x-deadline-ms``."""
        req_headers = {k.lower(): v for k, v in (req_headers or {}).items()}
        headers = {"x-trace-id": req_headers.get("x-trace-id") or uuid.uuid4().hex[:16]}

        def error(status: int, kind: str, detail: str):
            return status, {"error": kind, "detail": detail[:500]}, headers

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
            return 503, {"error": "overloaded", "detail": "deadline_expired"}, {
                **headers, "Retry-After": "0"}
        session = getattr(self.parser, "wants_session", False)
        # a single-slot engine owns one KV cache: its parses serialize
        guard = nullcontext() if getattr(self.parser, "concurrent_safe", False) else self.lock
        with guard:
            try:
                if session:
                    resp = self.parser.parse(preq["text"], preq["context"], preq["session_id"],
                                             preq["speculative"])
                else:
                    resp = self.parser.parse(preq["text"], preq["context"])
            except ParserError as e:
                if e.kind == "overloaded":
                    headers["Retry-After"] = "1"
                    return error(503, e.kind, e.detail)
                status = 422 if e.kind == "schema_validation_failed" else 500
                return error(status, e.kind, e.detail)
            except Exception as e:  # engine crash etc.
                return error(500, "llm_error", str(e))
            res = getattr(self.parser, "last_result", None)
        if res is not None:
            headers.update({"x-prefill-ms": f"{res.prefill_ms:.3f}",
                            "x-decode-ms": f"{res.decode_ms:.3f}",
                            "x-cached-tokens": str(res.cached_tokens),
                            "x-prompt-tokens": str(res.prompt_tokens)})
        if preq["speculative"] and session and preq["session_id"]:
            # a pending two-phase turn: the matching final parse commits it
            headers["x-speculation-pending"] = "1"
        return 200, resp, headers


def make_server(app: BrainApp, host: str = "127.0.0.1", port: int = 8090) -> ThreadingHTTPServer:
    """An HTTP server over ``app`` (``port=0`` picks a free one)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, status: int, body: dict, headers: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self._send(*app.health())
            else:
                self._send(404, {"error": "not_found", "detail": self.path}, {})

        def do_POST(self):
            raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if self.path == "/parse":
                self._send(*app.parse(raw, self.headers))
            else:
                self._send(404, {"error": "not_found", "detail": self.path}, {})

        def log_message(self, fmt, *args):  # quiet: one line per request is noise
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main() -> None:
    port = int(os.environ.get("BRAIN_PORT", "8090"))
    server = make_server(BrainApp(make_parser_from_env()), host="0.0.0.0", port=port)
    print(f"brain: serving /parse on :{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
