"""Voice orchestrator: WS /stream — audio in, typed events out.

Port of ``tpu_voice_agent/services/voice.py`` on the standard library's
``asyncio`` (``services/ws.py``: the WebSocket server and the HTTP client to
the brain and the executor). Binary WS frames carry PCM16 at 16 kHz mono;
JSON frames carry control messages (``context_update``, ``tenant``,
``text``, ``confirm_execute``, ``reset``); the service emits the JAX
service's event vocabulary: ``transcript_partial``, ``transcript_final``,
``intent``, ``tts``, ``execution_result``, ``execution_error``,
``confirmation_required``, ``latency_budget``, ``info``, ``warn`` and
``error``.

- STT: ``StreamingSTT`` on the port's Whisper (``VOICE_STT``), or the null
  mode (``NullSTT``, a ``warn`` frame first). ``feed`` runs Whisper inline,
  so the loop calls it on an executor thread, never on the loop thread.
  Under ``STT_BATCH_ENABLE=1`` every connection's ``BatchedStreamingSTT``
  shares one ``STTBatcher`` (``serve/stt_batch.py``): the loop awaits its
  ``feed_async``, the ``tenant`` control frame lanes its work, and a
  closing connection frees its pool slot. ``STT_REPLICAS`` > 1 puts
  that many batchers over the one engine behind the replicated tier
  (``serve/stt_replicas.py``: utterance affinity, the stalled-tick
  watchdog's warm restarts, final failover), and ``/health`` carries
  ``stt_replicas``.
- The brain hop: ``POST /parse`` through the retry / breaker kit
  (``services/resilience.py``), speculatively on ``spec_final`` (the 409
  ``speculation_unsupported`` latch re-probes after ``VOICE_RESPEC_AFTER``
  utterances), and prefix feeds under ``PREFIX_FEED_ENABLE=1`` (a batched
  brain commits each stabilized partial's chain to its radix tree; a brain
  that answers 409 ``prefix_feed_unsupported``, the rule or one-slot
  backend, latches the connection's feeds off).
  A transport error or a 5xx degrades to the local ``RuleBasedParser``.
- The safety gate: risky intents (``requires_confirmation`` or a type in
  ``schemas.RISKY_INTENT_TYPES``) emit ``confirmation_required``; safe ones
  auto-execute against the executor, whose ``session_id`` is threaded into
  the next ``/execute``.
- A control frame that is JSON but not an object gets the ``bad control
  frame`` warn of one that is not JSON (the JAX handler raises on it and
  drops the session).
- Observability, as JAX's: a ``transcript_final`` from a Whisper STT carries
  ``confidence`` (the final's logprob lanes and repetition score, with the
  quality lanes on); a ``QualityMonitor("voice")`` records every final and
  every parse (healthy or degraded); ``Tracer("voice")`` records the
  ``audio_ingest``, ``stt_finalize``, ``parse_roundtrip`` and
  ``execute_roundtrip`` spans; the ``voice.*`` counters, the
  ``voice.live_sessions`` and ``engine.prefill_remaining_at_endpoint`` gauges
  and the ``resilience.*`` series go to the process-global registry.
  ``GET /metrics`` (JSON, or Prometheus text under ``Accept: text/plain``),
  ``GET /debug/trace/{id}``, ``GET /debug/quality``, ``GET
  /debug/costs`` (the STT share of the cost meter) and ``GET
  /debug/timeseries?since=`` (the service's time-series ring,
  ``utils.timeseries``) are served.

One card, one stream: the split kernels' scratch and ticket counters are
per-device buffers that serve one stream at a time (``ops/_lib.py``
``scratch``, ``tickets``). The STT feed thread and a brain in the same
process launch on the same card, which is safe only because every launch
goes to the default stream; neither side may take a stream of its own.

    VOICE_STT=null python -m tpu_voice_agent_torch.services.voice

Environment (the JAX service's names): ``BRAIN_URL``, ``EXECUTOR_URL``,
``VOICE_PORT`` (7072), ``VOICE_PARSE_TIMEOUT_S``, ``VOICE_EXEC_TIMEOUT_S``,
``VOICE_RETRY_ATTEMPTS``, ``VOICE_BREAKER_THRESHOLD``,
``VOICE_BREAKER_RESET_S``, ``VOICE_SPEC_SILENCE_MS``,
``VOICE_EARLY_CLOSE_MS``, ``VOICE_RESPEC_AFTER``,
``VOICE_CAPACITY_SESSIONS``, ``VOICE_BRAIN_HEALTH_S``,
``PREFIX_FEED_ENABLE``, ``PREFIX_FEED_STABLE_K``, ``PREFIX_FEED_MIN_CHARS``,
``SLO_*``, ``QUALITY_ENABLE`` / ``QUALITY_WINDOW`` / ``QUALITY_SLO_*``,
``STT_BATCH_ENABLE`` / ``STT_BATCH_SLOTS``, ``STT_REPLICAS`` /
``STT_REPLICA_PROBE_S`` / ``STT_REPLICA_STALL_S`` / ``STT_SHED_PRESSURE``
(the replicated tier; ``STT_REPLICAS`` > 1 without the batched plane is
logged and ignored, as JAX ignores it), ``TS_INTERVAL_S`` / ``TS_SAMPLES`` /
``TS_GAUGES``, ``COST_ENABLE``, ``TRACE_SINK``, ``FLIGHT_*`` (the flight recorder behind ``GET
/debug/flightrecorder``), ``CHAOS_FAULTS`` / ``CHAOS_SEED`` (``drop_frame``
drops an incoming binary frame and counts ``voice.frames_dropped_chaos``;
``stt_garble`` collapses a final) and ``VOICE_STT`` (``null``; ``whisper[:preset]``, random
weights from seed 0; ``whisper-ckpt:<path>`` whose last component names one
of the port's in-repo checkpoints). The port adds ``VOICE_DEVICE`` (default
``cuda``; ``cpu`` runs the plain versions). What the port does not serve is
refused at boot (``check_unserved_knobs``, ``stt_factory_from_env``) or
answered 501 (``UNPORTED_ROUTES``), each naming its ROADMAP.md Queue 1
item. ``QUALITY_CANARY_S`` is not read: the canary is the brain's, as in
JAX. ``main`` merges the repo-root ``.env`` first (``utils.envcfg``).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import threading
import time
from pathlib import Path

from ..audio.mel import pcm16_to_float
from ..schemas import ValidationError, is_risky, validate_intent, validate_parse_response
from ..utils.chaos import chaos_fire, check_served_points
from ..utils.costmodel import cost_enabled, stt_cost_summary
from ..utils.envcfg import load_env_cascade
from ..utils.quality import QualityMonitor
from ..utils.timeseries import TIMESERIES_ROUTE, service_ring, timeseries_response
from ..utils.tracing import (
    TRACE_ROUTE,
    Tracer,
    flightrecorder_response,
    get_metrics,
    metrics_response,
    new_trace_id,
    trace_response,
)
from . import ws as wslib
from .resilience import (
    BreakerOpenError,
    CircuitBreaker,
    Deadline,
    ResilienceError,
    RetryPolicy,
    post_with_resilience,
)
from .slo import SLOTracker

log = logging.getLogger("tpu_voice_agent_torch.voice")


class VoiceConfig:
    def __init__(
        self,
        brain_url: str | None = None,
        executor_url: str | None = None,
        stt_factory=None,
        parse_timeout_s: float | None = None,
        exec_timeout_s: float | None = None,
        retry_attempts: int | None = None,
        breaker_threshold: int | None = None,
        breaker_reset_s: float | None = None,
    ):
        self.brain_url = brain_url or os.environ.get("BRAIN_URL", "http://127.0.0.1:8090")
        self.executor_url = executor_url or os.environ.get("EXECUTOR_URL",
                                                           "http://127.0.0.1:7081")
        self.stt_factory = stt_factory or stt_factory_from_env()
        # per-hop time budgets: each is the WHOLE deadline for that hop,
        # retries included, and travels downstream as x-deadline-ms
        self.parse_timeout_s = parse_timeout_s if parse_timeout_s is not None \
            else float(os.environ.get("VOICE_PARSE_TIMEOUT_S", "60"))
        self.exec_timeout_s = exec_timeout_s if exec_timeout_s is not None \
            else float(os.environ.get("VOICE_EXEC_TIMEOUT_S", "120"))
        # resilience knobs (shared by the brain and executor hops)
        self.retry_attempts = retry_attempts if retry_attempts is not None \
            else int(os.environ.get("VOICE_RETRY_ATTEMPTS", "3"))
        self.breaker_threshold = breaker_threshold if breaker_threshold is not None \
            else int(os.environ.get("VOICE_BREAKER_THRESHOLD", "3"))
        self.breaker_reset_s = breaker_reset_s if breaker_reset_s is not None \
            else float(os.environ.get("VOICE_BREAKER_RESET_S", "2.0"))


def _refuse(name: str, raw: str, item: int, what: str) -> None:
    raise ValueError(f"{name}={raw!r}: {what} is not ported yet (ROADMAP.md Queue 1 item "
                     f"{item}); unset it")


def check_unserved_knobs() -> None:
    """Refuse at boot a ``CHAOS_FAULTS`` that names an unknown point."""
    check_served_points()


def stt_factory_from_env():
    """``VOICE_STT=null`` (default, no model), ``whisper[:preset]`` (random
    weights from seed 0, preset default ``whisper-tiny``) or
    ``whisper-hf:<dir>`` (an HF Whisper checkpoint directory:
    ``SpeechEngine.from_hf``, its own tokenizer and weights; a path that is
    no such directory is refused here, naming it) or
    ``whisper-ckpt:<dir>`` (an in-repo trained checkpoint, named by the
    path's last component: ``whisper-tiny-overfit`` or
    ``whisper-tiny-heldout``, as ``checkpoints/whisper-tiny-heldout`` names it
    in the JAX package). The engine runs on ``VOICE_DEVICE`` (default
    ``cuda``: with no card it raises). ``STT_BATCH_ENABLE=1``: one
    process-wide engine and ``STTBatcher`` (``STT_BATCH_SLOTS`` slots,
    default 4) serve every connection through ``BatchedStreamingSTT``;
    with ``STT_REPLICAS`` > 1, that many batchers over the one engine behind
    ``STTReplicaTier`` (``STT_REPLICA_PROBE_S``, ``STT_REPLICA_STALL_S``,
    ``STT_SHED_PRESSURE``); unset, each connection's ``LockedStreaming``
    decodes at B = 1 behind one lock (``STT_REPLICAS`` is then logged and
    ignored, as in JAX). Refused at boot: any other ``whisper-ckpt:``
    checkpoint (its orbax reader is Queue 1 item 8's training part).
    ``QUALITY_ENABLE`` (default on) is read by the engine: its finals carry
    the confidence lanes."""
    from ..serve.stt import NullSTT

    replicas = int(os.environ.get("STT_REPLICAS", "1") or "1")
    batched = os.environ.get("STT_BATCH_ENABLE", "") == "1"
    if replicas > 1 and not batched:
        log.warning("STT_REPLICAS=%d needs STT_BATCH_ENABLE=1 (the replicated tier is "
                    "built over batchers); ignoring it, as the JAX service does", replicas)
    slots = int(os.environ.get("STT_BATCH_SLOTS", "4"))
    spec = os.environ.get("VOICE_STT", "null")
    if spec == "null":
        return lambda: NullSTT()
    if not (spec == "whisper" or spec.startswith(("whisper:", "whisper-ckpt:",
                                                   "whisper-hf:"))):
        raise ValueError(f"unknown VOICE_STT {spec!r}")
    from ..audio.endpoint import EnergyEndpointer
    from ..serve.stt import SpeechEngine, StreamingSTT

    device = os.environ.get("VOICE_DEVICE") or None
    if spec.startswith("whisper-hf:"):
        from ..ckpt.hf_import import check_hf_dir

        path = spec.split(":", 1)[1]
        check_hf_dir(path, "VOICE_STT")
        engine = SpeechEngine.from_hf(path, device=device)
    elif spec.startswith("whisper-ckpt:"):
        from .. import whisper_ckpt

        path = spec.split(":", 1)[1]
        name = Path(path.rstrip("/")).name
        if name not in whisper_ckpt.CHECKPOINTS:
            _refuse("VOICE_STT", spec, 8, f"an orbax checkpoint reader, with the training "
                                          f"part, (the port carries only "
                                          f"{', '.join(whisper_ckpt.CHECKPOINTS)})")
        cfg, params = whisper_ckpt.load_whisper(name, device=device)
        engine = whisper_ckpt.whisper_engine_from(cfg, params, device=device)
    else:
        from ..models.whisper import PRESETS

        preset = spec.split(":", 1)[1] if ":" in spec else "whisper-tiny"
        if preset not in PRESETS:
            raise ValueError(f"VOICE_STT {spec!r}: unknown preset {preset!r}")
        engine = SpeechEngine(preset=preset, device=device)
    # adaptive endpointing knobs: VOICE_SPEC_SILENCE_MS, the silence before
    # the speculative final fires (default 120, on the web client's 60 ms
    # frame boundary); VOICE_EARLY_CLOSE_MS, the stable-silence floor of the
    # early close once the speculative parse lands (default 240; 0 disables)
    spec_ms = int(os.environ.get("VOICE_SPEC_SILENCE_MS", "120"))
    early_ms = float(os.environ.get("VOICE_EARLY_CLOSE_MS", "240"))

    def make_endpointer():
        return EnergyEndpointer(sample_rate=engine.mel_cfg.sample_rate, spec_silence_ms=spec_ms)

    if batched:
        from ..serve.stt_batch import BatchedStreamingSTT, STTBatcher

        if replicas > 1:
            from ..serve.stt_replicas import STTReplicaTier

            batcher = STTReplicaTier(engine, replicas=replicas, slots=slots)
        else:
            batcher = STTBatcher(engine, slots=slots)
        return lambda: BatchedStreamingSTT(engine, batcher, endpointer=make_endpointer(),
                                           early_close_ms=early_ms if early_ms > 0 else None)
    lock = threading.Lock()

    class LockedStreaming(StreamingSTT):
        """One process-wide engine: every connection's feed takes the lock."""

        def feed(self, samples):
            with lock:
                return super().feed(samples)

    return lambda: LockedStreaming(engine, endpointer=make_endpointer(),
                                   early_close_ms=early_ms if early_ms > 0 else None)


class ClientState:
    def __init__(self, stt):
        self.stt = stt
        self.context: dict = {}
        self.session_id: str | None = None  # the executor's, after the first /execute
        # stable per-connection conversation key for /parse: a session-keyed
        # brain must see every turn of this connection under one key
        self.convo_id = new_trace_id()
        # per-UTTERANCE trace id (rotated when a new utterance starts)
        self.trace_id = new_trace_id()
        # utt_t0: perf_counter at the utterance's first audio frame; stages:
        # the split accumulated capture -> final -> parse (latency_budget)
        self.utt_t0: float | None = None
        self.stages: dict = {}
        # perf_counter at the start of an utterance whose SLO sample has not
        # been recorded yet; a teardown while set records an error sample
        self.slo_open_t0: float | None = None
        # trace id of the utterance whose risky plan awaits confirmation
        self.confirm_trace_id: str | None = None
        # serializes executor calls, so the first execution's session_id is
        # threaded into the next
        self.exec_lock = asyncio.Lock()
        # in-flight speculative parse: (provisional transcript, task)
        self.spec: tuple[str, asyncio.Task] | None = None
        self.tenant: str | None = None
        # prefix feeds (PREFIX_FEED_ENABLE=1): the stability tracker over
        # partials, the one in-flight feed task, and the newest commit queued
        # behind it
        self.feed_tracker = None
        self.feed_task: asyncio.Task | None = None
        self.feed_pending: str | None = None

    def drop_spec(self) -> None:
        if self.spec is not None:
            task = self.spec[1]
            self.spec = None
            _reap(task)

    def drop_feed(self) -> None:
        """Reap the in-flight prefix feed (teardown, reset, context change)."""
        self.feed_pending = None
        if self.feed_task is not None:
            task = self.feed_task
            self.feed_task = None
            _reap(task)
            get_metrics().inc("voice.feeds_reaped")


def _reap(task: "asyncio.Task") -> None:
    """Cancel or abandon a speculative task without a 'Task exception was
    never retrieved' log on GC: a dropped speculation's failure is expected."""
    if task.done():
        if not task.cancelled():
            task.exception()
    else:
        task.add_done_callback(lambda t: t.cancelled() or t.exception())
        task.cancel()


class _PrefixFeedTracker:
    """Longest-stable-prefix commit over a stream of STT partials.
    ``observe(partial)`` returns the newly committable prefix, or None. A
    prefix commits once it has survived K consecutive partials
    character-identically, trimmed back to the last whitespace boundary, and
    only when it grew by >= min_chars since the last commit. A retraction
    (STT revising text already committed) resets the baseline."""

    def __init__(self, k: int = 3, min_chars: int = 8):
        self.k = max(1, int(k))
        self.min_chars = max(1, int(min_chars))
        self._recent: list[str] = []
        self.committed = ""

    def observe(self, partial: str) -> str | None:
        self._recent.append(partial)
        if len(self._recent) > self.k:
            self._recent.pop(0)
        if len(self._recent) < self.k:
            return None
        stable = self._recent[0]
        for p in self._recent[1:]:
            n = min(len(stable), len(p))
            i = 0
            while i < n and stable[i] == p[i]:
                i += 1
            stable = stable[:i]
        # word-boundary trim: a prefix the newest partial continues without a
        # space ends mid-word and would tokenize differently from the final
        latest = self._recent[-1]
        if (len(stable) < len(latest) and not latest[len(stable)].isspace()
                and not stable[-1:].isspace()):
            cut = stable.rfind(" ")
            if cut <= 0:
                return None
            stable = stable[:cut]
        stable = stable.rstrip()
        if not stable:
            return None
        if not stable.startswith(self.committed):
            self.committed = ""  # retraction: re-baseline
        if len(stable) - len(self.committed) < self.min_chars:
            return None
        self.committed = stable
        return stable

    def reset(self) -> None:
        self._recent.clear()
        self.committed = ""


def _prefill_remaining(stages: dict, spec_pre_parsed: bool, degraded: bool) -> float:
    """Outstanding un-prefilled prompt tokens when the endpoint fired: 0 for
    a speculative parse that finished before the endpoint and for a degraded
    or headerless parse; else prompt_tokens minus what the KV cache
    absorbed."""
    if spec_pre_parsed:
        return 0.0
    pt = stages.get("prompt_tokens")
    if degraded or pt is None:
        return 0.0
    return max(0.0, float(pt) - float(stages.get("cached_tokens", 0.0)))


# Routes of the JAX service that the port does not serve: prefix -> the
# ROADMAP.md Queue 1 item that brings them
UNPORTED_ROUTES = (
    ("/static/", 9),
)


def _unported_item(path: str) -> int | None:
    if path == "/":
        return 9  # the web client
    for prefix, item in UNPORTED_ROUTES:
        if path == prefix or (prefix.endswith("/") and path.startswith(prefix)):
            return item
    return None


def build_app(cfg: VoiceConfig | None = None, tracer: Tracer | None = None) -> wslib.App:
    check_unserved_knobs()
    cfg = cfg or VoiceConfig()
    tracer = tracer or Tracer("voice", emit=False)
    from ..serve.stt import NullSTT
    from .brain import RuleBasedParser

    # per-dependency circuits, shared across connections: one client's
    # timeouts warn the next client's calls. An open brain circuit is not
    # terminal: handle_final degrades to the local rule parser
    brain_breaker = CircuitBreaker("brain", failure_threshold=cfg.breaker_threshold,
                                   reset_after_s=cfg.breaker_reset_s)
    exec_breaker = CircuitBreaker("executor", failure_threshold=cfg.breaker_threshold,
                                  reset_after_s=cfg.breaker_reset_s)
    retry_policy = RetryPolicy(max_attempts=max(1, cfg.retry_attempts))
    fallback_parser = RuleBasedParser()
    # the north-star SLO: voice->intent (end-of-speech processing cost: STT
    # finalize + parse; the speaker's own talking time is not latency)
    slo = SLOTracker("voice")
    # STT confidence per final, the parses' structure, and the voice-side
    # quality verdict, on the tracer-local registry
    qmon = QualityMonitor("voice", metrics=tracer.metrics)
    live_sessions = {"n": 0}
    capacity_sessions = int(os.environ.get("VOICE_CAPACITY_SESSIONS", "0"))
    ring = service_ring("voice", tracer)
    get_metrics().set_gauge("voice.live_sessions", 0)

    # the brain's /health keys forwarded into ours, refreshed in the
    # background at most every VOICE_BRAIN_HEALTH_S (fetch budget 1 s); only
    # the very first scrape awaits the fetch
    brain_fwd = {"t": 0.0, "body": None, "task": None, "fetched": False}
    brain_fwd_s = float(os.environ.get("VOICE_BRAIN_HEALTH_S", "3.0"))

    async def _refresh_brain_fwd() -> None:
        try:
            h = (await wslib.HTTPClient().get(cfg.brain_url + "/health", timeout=1.0)).json()
            brain_fwd["body"] = {
                k: h[k] for k in ("compile_sentinel", "last_step", "hbm", "replicas",
                                  "home_replica", "quality")
                if h.get(k) is not None
            } or None
        except (wslib.HTTPError, ValueError, AttributeError):
            brain_fwd["body"] = None
        finally:
            brain_fwd["fetched"] = True
            brain_fwd["task"] = None

    async def _brain_engine_health() -> dict | None:
        now = time.monotonic()
        if now - brain_fwd["t"] >= brain_fwd_s and brain_fwd["task"] is None:
            brain_fwd["t"] = now
            brain_fwd["task"] = asyncio.ensure_future(_refresh_brain_fwd())
            if not brain_fwd["fetched"]:
                await brain_fwd["task"]
        return brain_fwd["body"]

    async def health() -> wslib.Response:
        breakers = {"brain": brain_breaker.state, "executor": exec_breaker.state}
        status = "ok" if all(s == "closed" for s in breakers.values()) else "degraded"
        body = {
            "ok": status == "ok", "status": status, "service": "voice",
            "breakers": breakers,
            "slo": slo.state(),
            "sessions": live_sessions["n"],
            "capacity_sessions": capacity_sessions,
            "quality": qmon.health(),
        }
        fwd = await _brain_engine_health()
        if fwd is not None:
            body["brain"] = fwd
        from ..serve.stt_replicas import current_tier

        tier = current_tier()
        if tier is not None:
            body["stt_replicas"] = tier.tier_health()
        # degraded still serves (that is the point): 200 either way
        return wslib.Response(200, body)

    async def route(req: wslib.Request) -> wslib.Response:
        served = req.path in ("/health", "/metrics", "/debug/quality",
                              "/debug/flightrecorder", "/debug/costs", TIMESERIES_ROUTE) or (
            req.path.startswith(TRACE_ROUTE) and len(req.path) > len(TRACE_ROUTE))
        if served:
            if req.method != "GET":
                return wslib.Response(405, {"error": "method_not_allowed",
                                            "detail": req.method})
            if req.path == "/health":
                return await health()
            if req.path == "/metrics":
                return metrics_response("voice", tracer, req, slo=slo)
            if req.path == "/debug/quality":
                return qmon.response()
            if req.path == "/debug/flightrecorder":
                return flightrecorder_response("voice", req)
            if req.path == TIMESERIES_ROUTE:
                return timeseries_response(ring, req)
            if req.path == "/debug/costs":
                # the STT share of the cost meter, over the live engines
                return wslib.Response(200, {"service": "voice", "enabled": cost_enabled(),
                                            "stt": stt_cost_summary()})
            return trace_response("voice", tracer, req)
        item = _unported_item(req.path)
        if item is not None:
            return wslib.Response(501, {"error": "not_ported",
                                        "detail": f"ROADMAP.md Queue 1 item {item}"})
        return wslib.Response(404, {"error": "not_found", "detail": req.path})

    async def send(ws: wslib.WebSocket, type_: str, **payload) -> None:
        if not ws.closed:
            # a peer that vanished mid-send ends the session through the
            # reader (its close message), not through the sender
            with contextlib.suppress(ConnectionError):
                await ws.send_json({"type": type_, **payload})

    async def post_parse(state: ClientState, text: str, http, speculative: bool = False,
                         deadline: Deadline | None = None):
        """One budgeted /parse roundtrip (no events, no side effects).
        Raises BreakerOpenError / DeadlineExpired / transport errors."""
        json_body = {"text": text, "session_id": state.convo_id,
                     "context": state.context, "speculative": speculative}
        headers = {"x-trace-id": state.trace_id}
        if state.tenant:
            json_body["tenant"] = state.tenant
            headers["x-tenant"] = state.tenant
        return await post_with_resilience(
            http, cfg.brain_url + "/parse", json_body=json_body, headers=headers,
            deadline=deadline or Deadline.after(cfg.parse_timeout_s),
            policy=retry_policy, breaker=brain_breaker)

    # sticky across the app: a 409 speculation_unsupported means the brain
    # is session-keyed, so stop paying a wasted roundtrip per utterance.
    # After RESPEC_AFTER skipped utterances one speculation re-probes. Any
    # other 409 never latches.
    RESPEC_AFTER = int(os.environ.get("VOICE_RESPEC_AFTER", "25"))
    spec_supported = {"ok": True, "skips": 0}

    # prefix feeds (PREFIX_FEED_ENABLE=1): stabilized partial prefixes go to
    # the brain as prefill-only feeds while the user is still speaking
    feed_enable = os.environ.get("PREFIX_FEED_ENABLE", "") == "1"
    feed_k = int(os.environ.get("PREFIX_FEED_STABLE_K", "3"))
    feed_min_chars = int(os.environ.get("PREFIX_FEED_MIN_CHARS", "8"))
    # sticky like spec_supported, with no re-probe
    feed_supported = {"ok": True}
    if feed_enable:
        get_metrics().inc("voice.feeds_sent", 0.0)
        get_metrics().inc("voice.feeds_reaped", 0.0)

    async def feed_prefix_send(state: ClientState, text: str, http) -> None:
        """Fire one coalesced prefill-only feed: a raw post (never retried,
        never counted by the breaker, never surfaced to the user), and only
        while the brain's circuit is closed."""
        if not feed_enable or not feed_supported["ok"]:
            return
        if brain_breaker.state != "closed":
            return
        if state.feed_task is not None:
            state.feed_pending = text  # coalesce: the newest commit wins
            return

        async def run(text: str) -> None:
            json_body = {"text": text, "session_id": state.convo_id,
                         "context": state.context, "prefix_feed": True}
            headers = {"x-trace-id": state.trace_id}
            if state.tenant:
                json_body["tenant"] = state.tenant
                headers["x-tenant"] = state.tenant
            get_metrics().inc("voice.feeds_sent")
            try:
                r = await http.post(cfg.brain_url + "/parse", json=json_body, headers=headers,
                                    timeout=cfg.parse_timeout_s)
                if r.status_code == 409:
                    try:
                        latch = r.json().get("error") == "prefix_feed_unsupported"
                    except (ValueError, AttributeError):
                        latch = False
                    if latch:
                        feed_supported["ok"] = False
            except asyncio.CancelledError:
                raise
            except (wslib.HTTPError, OSError, RuntimeError):
                pass  # best-effort: the final just cold-prefills
            finally:
                if state.feed_task is asyncio.current_task():
                    state.feed_task = None
                # chain the coalesced commit (drop_feed cleared it on teardown)
                nxt, state.feed_pending = state.feed_pending, None
                if nxt is not None:
                    await feed_prefix_send(state, nxt, http)

        state.feed_task = asyncio.ensure_future(run(text))

    async def speculate(state: ClientState, text: str, http) -> None:
        """Start parsing the provisional transcript inside the endpoint's
        trailing-silence window. The result is only DELIVERED by a matching
        transcript_final, so the confirmation gate is untouched."""
        if not spec_supported["ok"]:
            return  # the skip counter advances per utterance (handle_final)
        if brain_breaker.state != "closed":
            return  # the half-open probe belongs to the final's parse
        if state.spec is not None and state.spec[0] == text:
            return  # already in flight for this exact transcript
        state.drop_spec()

        async def run():
            r = await post_parse(state, text, http, speculative=True)
            if r.status_code == 409:
                # latch here too: a superseded speculation is reaped unread
                try:
                    latch = r.json().get("error") == "speculation_unsupported"
                except (ValueError, AttributeError):
                    latch = False
                if latch:
                    spec_supported["ok"] = False
                    spec_supported["skips"] = 0
            elif r.status_code == 200:
                # grammar-complete: the STT may close the endpoint early once
                # the transcript has stayed stable (feed() re-validates)
                notify = getattr(state.stt, "parse_complete", None)
                if notify is not None:
                    notify(text)
            return r

        get_metrics().inc("voice.spec_parse_started")
        state.spec = (text, asyncio.ensure_future(run()))

    executions: set[asyncio.Task] = set()  # fire-and-forget /execute tasks, kept alive

    async def emit_budget(ws, state: ClientState, stages: dict | None = None) -> None:
        """The per-utterance latency_budget event. total_ms is the
        processing cost; audio_ingest_ms (the speaker's own talking time
        included) is reported but not summed."""
        stages = dict(stages if stages is not None else state.stages)
        stages["total_ms"] = round(sum(
            stages.get(k, 0.0) for k in ("stt_finalize_ms", "parse_ms", "execute_ms")), 3)
        await send(ws, "latency_budget", trace_id=stages.pop("trace_id", state.trace_id),
                   stages=stages)

    async def handle_final(ws, state: ClientState, text: str, http) -> None:
        """transcript final -> brain -> gate -> executor (the hot path)."""
        t_final0 = time.perf_counter()
        if not spec_supported["ok"]:
            # one skipped utterance per final; after RESPEC_AFTER of them the
            # next utterance re-probes speculation
            spec_supported["skips"] += 1
            if spec_supported["skips"] > RESPEC_AFTER:
                spec_supported["ok"] = True
                spec_supported["skips"] = 0
        r = None
        # True when the parse finished BEFORE the endpoint fired
        spec_pre_parsed = False
        spec, state.spec = state.spec, None
        if spec is not None:
            stext, task = spec
            if stext == text:
                # hit: done-ness is read BEFORE the await, which would always
                # finish by the time the flag is read
                was_done_at_endpoint = task.done()
                try:
                    maybe = await task
                except asyncio.CancelledError:
                    if not task.cancelled():
                        raise  # WE were cancelled, not the spec task
                    maybe = None
                except Exception:  # noqa: BLE001 - a failed speculation just parses again
                    maybe = None
                if (maybe is not None and maybe.status_code == 200
                        and maybe.headers.get("x-speculation-pending") == "1"):
                    # two-phase backend: the speculative turn is PENDING; the
                    # normal parse below commits it (no decode)
                    get_metrics().inc("voice.spec_parse_hit")
                    get_metrics().inc("voice.spec_parse_commit")
                    spec_pre_parsed = was_done_at_endpoint
                elif maybe is not None and maybe.status_code == 200:
                    r = maybe
                    get_metrics().inc("voice.spec_parse_hit")
                    spec_pre_parsed = was_done_at_endpoint
                elif maybe is not None and maybe.status_code == 409:
                    get_metrics().inc("voice.spec_parse_unsupported")
                else:
                    get_metrics().inc("voice.spec_parse_failed")
            else:
                _reap(task)
                get_metrics().inc("voice.spec_parse_stale")
        degraded_reason = None
        if r is None:
            with tracer.span("parse_roundtrip", trace_id=state.trace_id, chars=len(text)):
                try:
                    r = await post_parse(state, text, http)
                except asyncio.CancelledError:
                    raise  # connection teardown mid-parse is not a brain fault
                except (ResilienceError, wslib.HTTPError, OSError) as e:
                    degraded_reason = ("circuit open" if isinstance(e, BreakerOpenError)
                                       else f"{type(e).__name__}: {e}")
        if degraded_reason is None and r.status_code >= 500:
            # shed (503) or failed server-side (500): a local degraded parse
            # beats a terminal error. 4xx stays terminal: those are answers
            # about THIS request, not brain-health signals
            degraded_reason = f"brain error {r.status_code}"
        if degraded_reason is not None:
            get_metrics().inc("voice.degraded_parses")
            parsed = fallback_parser.parse(text, state.context)
            degraded = True
            # a degraded-mode rule fallback is a quality event even though
            # the session survived
            qmon.record_intent(degraded=True, rule_fallback=True, text=text)
            await send(ws, "warn", degraded=True,
                       message=f"brain unavailable ({degraded_reason}); "
                               "serving rule-based parse")
        else:
            degraded = False
            if r.status_code != 200:
                await send(ws, "error", message=f"brain error {r.status_code}",
                           detail=r.text[:300])
                await utterance_failed(ws, state, t_final0)
                return
            try:
                parsed, err = validate_parse_response(r.json())
            except ValueError as e:
                parsed, err = None, str(e)
            if parsed is None:
                await send(ws, "error", message=f"brain returned invalid payload: {err}")
                await utterance_failed(ws, state, t_final0)
                return

        state.stages["parse_ms"] = round((time.perf_counter() - t_final0) * 1e3, 3)
        if not degraded:
            # the brain's decode split rides back as response headers
            for header, key in (("x-prefill-ms", "parse_prefill_ms"),
                                ("x-decode-ms", "parse_decode_ms"),
                                ("x-cached-tokens", "cached_tokens"),
                                ("x-prompt-tokens", "prompt_tokens"),
                                ("x-intent-margin", "intent_margin")):
                v = r.headers.get(header)
                if v is not None:
                    try:
                        state.stages[key] = float(v)
                    except ValueError:
                        pass
            # healthy parses feed the quality windows too
            qmon.record_intent(margin=state.stages.get("intent_margin"), text=text)
        if degraded:
            state.stages["degraded"] = True
        get_metrics().set_gauge("engine.prefill_remaining_at_endpoint",
                                _prefill_remaining(state.stages, spec_pre_parsed, degraded))
        slo.record(state.stages.get("stt_finalize_ms", 0.0) + state.stages["parse_ms"], ok=True)
        state.slo_open_t0 = None

        tag = {"degraded": True} if degraded else {}
        await send(ws, "intent", data=parsed, **tag)
        if parsed["tts_summary"]:
            await send(ws, "tts", text=parsed["tts_summary"], **tag)
        if parsed["follow_up_question"]:
            await send(ws, "tts", text=parsed["follow_up_question"], **tag)
        state.context.update(parsed["context_updates"])

        safe = [i for i in parsed["intents"] if not is_risky(i) and i["type"] != "unknown"]
        risky = [i for i in parsed["intents"] if is_risky(i)]
        if risky:
            state.confirm_trace_id = state.trace_id
            await send(ws, "confirmation_required", intents=risky,
                       session_id=state.session_id, **tag)
        if safe:
            # the latency_budget event follows the execution; the stages and
            # the trace id are snapshotted NOW (the next utterance rotates
            # them while this task runs). The task is kept until it ends
            task = asyncio.ensure_future(execute_and_report(
                ws, state, safe, http, stages=dict(state.stages, trace_id=state.trace_id),
                trace_id=state.trace_id))
            executions.add(task)
            task.add_done_callback(executions.discard)
        else:
            await emit_budget(ws, state)

    async def utterance_failed(ws, state: ClientState, t_final0: float) -> None:
        """Terminal parse failure: the utterance still costs SLO error budget
        and still reports its (partial) stage split."""
        state.stages["parse_ms"] = round((time.perf_counter() - t_final0) * 1e3, 3)
        state.stages["error"] = True
        slo.record(state.stages.get("stt_finalize_ms", 0.0) + state.stages["parse_ms"],
                   ok=False)
        state.slo_open_t0 = None
        await emit_budget(ws, state)

    async def execute_and_report(ws, state: ClientState, intents: list[dict], http,
                                 stages: dict | None = None,
                                 trace_id: str | None = None) -> None:
        # trace_id is snapshotted by the caller: this task is fire-and-forget
        trace_id = trace_id or state.trace_id
        t0 = time.perf_counter()
        async with state.exec_lock:
            await _execute_locked(ws, state, intents, http, trace_id)
        if stages is not None:
            stages["execute_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            await emit_budget(ws, state, stages)

    async def _execute_locked(ws, state: ClientState, intents: list[dict], http,
                              trace_id: str) -> None:
        try:
            with tracer.span("execute_roundtrip", trace_id=trace_id, intents=len(intents)):
                r = await post_with_resilience(
                    http, cfg.executor_url + "/execute",
                    json_body={"session_id": state.session_id, "intents": intents},
                    headers={"x-trace-id": trace_id},
                    deadline=Deadline.after(cfg.exec_timeout_s),
                    policy=retry_policy, breaker=exec_breaker)
        except asyncio.CancelledError:
            raise
        except BreakerOpenError:
            get_metrics().inc("voice.exec_shed")
            await send(ws, "execution_error", degraded=True,
                       message="executor unavailable (circuit open); "
                               "command dropped — try again shortly")
            return
        except (ResilienceError, wslib.HTTPError, OSError, RuntimeError) as e:
            await send(ws, "execution_error", message=str(e))
            return
        if r.status_code != 200:
            await send(ws, "execution_error", message=f"executor {r.status_code}",
                       detail=r.text[:300])
            return
        body = r.json()
        state.session_id = body.get("session_id") or state.session_id
        await send(ws, "execution_result", data=body)

    async def stream(ws: wslib.WebSocket, _req: wslib.Request) -> None:
        state = ClientState(cfg.stt_factory())
        if feed_enable:
            state.feed_tracker = _PrefixFeedTracker(k=feed_k, min_chars=feed_min_chars)
        live_sessions["n"] += 1
        get_metrics().set_gauge("voice.live_sessions", live_sessions["n"])
        try:
            await _stream_session(ws, state)
        finally:
            close = getattr(state.stt, "close", None)
            if close is not None:
                close()  # the batched plane frees the utterance's slot
            live_sessions["n"] = max(0, live_sessions["n"] - 1)
            get_metrics().set_gauge("voice.live_sessions", live_sessions["n"])
            if state.slo_open_t0 is not None:
                # the client went away mid-utterance: an aborted utterance is
                # an error sample (the wall the speaker waited for nothing)
                slo.record((time.perf_counter() - state.slo_open_t0) * 1e3, ok=False)
                state.slo_open_t0 = None
                get_metrics().inc("voice.utterances_aborted")

    async def _stream_session(ws: wslib.WebSocket, state: ClientState) -> None:
        if isinstance(state.stt, NullSTT):
            await send(ws, "warn", message="no STT model loaded; running in null mode")
        else:
            await send(ws, "info", message="listening")
        loop = asyncio.get_running_loop()
        http = wslib.HTTPClient()
        try:
            async for msg in ws:
                if msg.type == wslib.BINARY:
                    if chaos_fire("drop_frame"):
                        # the drill: a frame lost on the network; the
                        # pipeline degrades (a later endpoint, a shorter
                        # transcript), never wedges
                        get_metrics().inc("voice.frames_dropped_chaos")
                        continue
                    t_feed0 = time.perf_counter()
                    try:
                        samples = pcm16_to_float(msg.data)
                        # the batched plane's feed is host work with awaited
                        # futures; otherwise feed runs Whisper inline: keep
                        # it off the loop
                        afeed = getattr(state.stt, "feed_async", None)
                        if afeed is not None:
                            events = await afeed(samples)
                        else:
                            events = await loop.run_in_executor(None, state.stt.feed, samples)
                    except Exception as e:  # noqa: BLE001 - a bad packet must not end the session
                        await send(ws, "warn", message=f"bad audio frame: {e}")
                        continue
                    t_feed1 = time.perf_counter()
                    if state.utt_t0 is None:
                        # a new utterance starts at SPEECH ONSET (an open mic
                        # streams silence continuously); STT backends without
                        # an endpointer (NullSTT) arm on any frame
                        ep = getattr(state.stt, "endpointer", None)
                        if ep is None or ep.in_speech or events:
                            state.utt_t0 = t_feed0
                            state.slo_open_t0 = t_feed0
                            state.trace_id = new_trace_id()
                            state.stages = {}
                    for kind, text in events:
                        if kind == "partial":
                            await send(ws, "transcript_partial", text=text)
                            if state.feed_tracker is not None:
                                commit = state.feed_tracker.observe(text)
                                if commit:
                                    await feed_prefix_send(state, commit, http)
                        elif kind == "spec_final":
                            # the speaker paused: parse the provisional
                            # transcript while the endpoint window runs out
                            await speculate(state, text, http)
                        else:
                            # the waterfall's stage spans: the capture window
                            # and the feed call that finalized the transcript
                            tracer.record_span("audio_ingest", state.trace_id, state.utt_t0,
                                               t_feed1)
                            tracer.record_span("stt_finalize", state.trace_id, t_feed0,
                                               t_feed1, chars=len(text))
                            state.stages.update(
                                audio_ingest_ms=round((t_feed1 - state.utt_t0) * 1e3, 3),
                                stt_finalize_ms=round((t_feed1 - t_feed0) * 1e3, 3),
                            )
                            state.utt_t0 = None
                            if state.feed_tracker is not None:
                                state.feed_tracker.reset()
                                state.drop_feed()
                            # the STT published this final's full result on
                            # the feed call that emitted it: its confidence
                            # rides the event
                            conf_payload = {}
                            lf = getattr(state.stt, "last_final", None)
                            if lf is not None and lf.repetition is not None:
                                conf_payload["confidence"] = {
                                    k: getattr(lf, k)
                                    for k in ("logp_mean", "logp_min", "logp_first", "repetition")
                                    if getattr(lf, k) is not None}
                                qmon.record_stt(lf.logp_mean, lf.logp_min, lf.repetition,
                                                text=text, logp_first=lf.logp_first)
                            await send(ws, "transcript_final", text=text, **conf_payload)
                            await handle_final(ws, state, text, http)
                elif msg.type == wslib.TEXT:
                    try:
                        ctrl = json.loads(msg.data)
                    except json.JSONDecodeError:
                        ctrl = None
                    if not isinstance(ctrl, dict):
                        await send(ws, "warn", message="bad control frame")
                        continue
                    ctype = ctrl.get("type")
                    if ctype == "context_update":
                        state.context.update(ctrl.get("data") or {})
                        # in-flight speculation and feed saw the OLD context
                        state.drop_spec()
                        state.drop_feed()
                        if state.feed_tracker is not None:
                            state.feed_tracker.reset()
                        await send(ws, "info", message="context updated")
                    elif ctype == "tenant":
                        # rides every /parse from here on and re-lanes this
                        # connection's STT work (the batched plane's)
                        state.tenant = str(ctrl.get("tenant") or "") or None
                        if hasattr(state.stt, "tenant"):
                            state.stt.tenant = state.tenant
                        await send(ws, "info", message="tenant set")
                    elif ctype == "text":
                        # typed command path: the same pipeline minus STT
                        text = str(ctrl.get("text") or "")
                        if text:
                            state.trace_id = new_trace_id()
                            state.stages = {}
                            state.utt_t0 = None
                            state.slo_open_t0 = time.perf_counter()
                            await send(ws, "transcript_final", text=text)
                            await handle_final(ws, state, text, http)
                    elif ctype == "confirm_execute":
                        # the UI approved risky intents: execute them now
                        try:
                            intents = [validate_intent(i) for i in ctrl.get("intents") or []]
                        except (ValidationError, TypeError) as e:
                            await send(ws, "warn", message=f"bad intents: {e}")
                            continue
                        if intents:
                            # attributed to the utterance that PROPOSED the plan
                            await execute_and_report(ws, state, intents, http,
                                                     trace_id=state.confirm_trace_id)
                            state.confirm_trace_id = None
                    elif ctype == "reset":
                        state.stt.reset()
                        state.context = {}
                        # a client reset CANCELS the armed utterance: it is
                        # not an aborted one at teardown
                        state.utt_t0 = None
                        state.slo_open_t0 = None
                        state.drop_spec()
                        state.drop_feed()
                        if state.feed_tracker is not None:
                            state.feed_tracker.reset()
                        await send(ws, "info", message="state reset")
                    else:
                        await send(ws, "warn", message=f"unknown control type {ctype!r}")
        finally:
            state.drop_spec()
            state.drop_feed()

    async def start_ring() -> None:
        ring.start()

    async def stop_ring() -> None:
        ring.stop()

    app = wslib.App(http=route, websockets={"/stream": stream}, on_startup=[start_ring],
                    on_cleanup=[stop_ring])
    app.ring = ring
    return app


async def _serve_forever(app: wslib.App, host: str, port: int) -> None:
    server = await wslib.serve(app, host, port)
    print(f"voice: serving /stream and /health on :{server.sockets[0].getsockname()[1]}",
          flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await wslib.stop(server)


def main() -> None:
    # the repo-root .env first: its knobs are served or refused like the
    # environment's
    load_env_cascade()
    from ..parallel.multihost import init_multihost

    init_multihost()  # a multi-process setting is refused first, as JAX joins first
    if os.environ.get("VOICE_STT", "null").startswith(("whisper:", "whisper-ckpt:")) \
            or os.environ.get("VOICE_STT") == "whisper":
        # a Whisper engine the service serves: the card's first touch under
        # the watchdog (a refused one fails in the factory, before any device)
        from ..utils.devinit import require_card_unless_cpu

        require_card_unless_cpu(os.environ.get("VOICE_DEVICE") or None)
    port = int(os.environ.get("VOICE_PORT", "7072"))
    asyncio.run(_serve_forever(build_app(tracer=Tracer("voice")), "0.0.0.0", port))


if __name__ == "__main__":
    main()
