"""The port's voice WS service (``services/voice.py`` on ``services/ws.py``)
held against the JAX service (aiohttp) on the CPU.

- Scripted differential: both voice services point at the same JAX brain and
  the same JAX executor on ``FakePage``; ``NullSTT`` plays the same scripted
  events on both sides. Each scenario of ``tests/test_voice.py`` (and an
  odd-length PCM frame, a brain that is down, a breaker that opens and
  recovers) is driven step by step through one WebSocket, and the frame
  sequences and the brain's call logs must be equal once trace ids, ms
  values and the executor's session id are masked.
- The WebSocket layer both ways: the aiohttp client against the port's
  server and the port's client against the JAX server, plus raw frames
  (fragments, unmasked) sent to both.
- The pure parts against JAX's, on a fake clock and a seeded rng:
  ``_PrefixFeedTracker``, ``_prefill_remaining``, ``RetryPolicy``,
  ``CircuitBreaker``, ``post_with_resilience``'s retry / no-retry split and
  ``SLOTracker``.
- Refusals: each knob and route the port does not serve raises ``ValueError``
  at boot or answers 501, naming its ROADMAP.md Queue 1 item.
"""

import asyncio
import json
import os
import random
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import httpx
import numpy as np
import pytest
import torch
from aiohttp import web

from tests.http_helper import AppServer
from tpu_voice_agent.serve.stt import NullSTT as JaxNullSTT
from tpu_voice_agent.services.brain import PlannerParser, RuleBasedParser
from tpu_voice_agent.services.brain import build_app as build_jax_brain
from tpu_voice_agent.services.executor import SessionManager
from tpu_voice_agent.services.executor import build_app as build_executor
from tpu_voice_agent.services.executor.page import FakePage
from tpu_voice_agent.services.voice import VoiceConfig as JaxVoiceConfig
from tpu_voice_agent.services.voice import _PrefixFeedTracker as JaxTracker
from tpu_voice_agent.services.voice import _prefill_remaining as jax_prefill_remaining
from tpu_voice_agent.services.voice import build_app as build_jax_voice
from tpu_voice_agent.utils import resilience as jres
from tpu_voice_agent.utils.slo import SLOTracker as JaxSLOTracker
from tpu_voice_agent_torch.serve.stt import NullSTT
from tpu_voice_agent_torch.services import resilience as pres
from tpu_voice_agent_torch.services import voice, ws
from tpu_voice_agent_torch.services.slo import SLOTracker

ROOT = Path(__file__).resolve().parents[1]
PCM = np.zeros(1600, dtype="<i2").tobytes()  # 100 ms of silence
STEP_TIMEOUT_S = 15.0
QUIET_S = 0.12  # after a step's condition holds: frames that follow still count


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------------ brains


def with_call_log(app: web.Application, calls: list) -> web.Application:
    """Record what every /parse asked for (the conversation key, random per
    connection, left out)."""

    @web.middleware
    async def log(request, handler):
        if request.path == "/parse":
            body = await request.json()
            calls.append({k: body.get(k) for k in ("text", "context", "speculative",
                                                   "prefix_feed", "tenant")})
        return await handler(request)

    app.middlewares.append(log)
    return app


class SessionParser:
    """A session-keyed backend: the JAX brain refuses speculation for it."""

    wants_session = True

    def __init__(self):
        self.rule = RuleBasedParser()

    def parse(self, text, context, session_id=None):
        return self.rule.parse(text, context)


class OneShotPlanner:
    """The deterministic planner stub of tests/test_voice.py: the JAX brain
    answers its speculative turn with ``x-speculation-pending: 1``."""

    max_new_tokens = 64
    PLAN = ('{"version":"1.0","intents":[{"type":"scroll","target":null,'
            '"args":{"direction":"down"},"priority":1,"requires_confirmation":false,'
            '"timeout_ms":15000,"retries":0}],"context_updates":{},"confidence":0.9,'
            '"tts_summary":"ok","follow_up_question":null}')

    def __init__(self):
        self.plans = 0

    def start(self, text):
        from types import SimpleNamespace

        return SimpleNamespace(ids=list(range(4)), pos=4, anchors=1, last_logits=object(),
                               cache=None)

    def extend(self, sess, text):
        sess.ids.extend([7] * 2)

    def plan_many(self, sessions, max_new_tokens=None, **kw):
        self.plans += len(sessions)
        for s in sessions:
            s.ids.extend([9] * 3)
        return [(self.PLAN, [9] * 3) for _ in sessions]

    def session_bytes(self, sess):
        return 0

    def park(self, sess):
        pass

    def unpark(self, sess):
        pass

    def parked_bytes(self, sess):
        return 0


def scripted_brain(state: dict) -> web.Application:
    """A rule brain with faults on demand: 409 ``upstream_restarting`` to
    speculative requests (a transient 409 that must not latch) when
    ``state["spec_409"]``, and 500 to everything while ``state["down"]``."""
    rule = RuleBasedParser()

    async def parse(request):
        body = await request.json()
        if state.get("down"):
            return web.json_response({"error": "llm_error", "detail": "down"}, status=500)
        if body.get("speculative") and state.get("spec_409"):
            return web.json_response({"error": "upstream_restarting"}, status=409)
        res = rule.parse(body["text"], body.get("context") or {})
        return web.json_response(json.loads(res.model_dump_json()))

    app = web.Application()
    app.router.add_post("/parse", parse)
    return app


@pytest.fixture(scope="module")
def executor(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exec")
    manager = SessionManager(page_factory=FakePage.demo, artifacts_root=str(tmp / "art"),
                             uploads_dir=str(tmp / "up"))
    with AppServer(build_executor(manager)) as srv:
        yield srv


# ------------------------------------------------------------------ driver


async def _collect(sock, frames: list, done, calls: list, timeout_s: float) -> None:
    end = time.monotonic() + timeout_s
    while not done(frames, calls):
        if time.monotonic() > end:
            raise AssertionError(f"step timed out; frames so far {frames}, calls {calls}")
        try:
            msg = await sock.receive(timeout=0.05)
        except asyncio.TimeoutError:
            continue
        if msg.type != ws.TEXT:
            raise AssertionError(f"connection closed mid-step: {msg}")
        frames.append(json.loads(msg.data))
    quiet_end = time.monotonic() + QUIET_S
    while time.monotonic() < quiet_end:
        try:
            msg = await sock.receive(timeout=max(0.0, quiet_end - time.monotonic()))
        except asyncio.TimeoutError:
            break
        if msg.type == ws.TEXT:
            frames.append(json.loads(msg.data))


def until_type(kind: str, n: int = 1):
    return lambda frames, calls: sum(f["type"] == kind for f in frames) >= n


def until_calls(n: int):
    """The brain has seen n calls (of this service) and had time to answer."""
    state = {}

    def done(frames, calls):
        if len(calls) < n:
            return False
        t = state.setdefault("t", time.monotonic())
        return time.monotonic() - t >= 0.25

    return done


def drive(url: str, steps: list, calls: list) -> list:
    """Open /stream with the port's client, take the greeting, then run each
    step: send a frame and read until its condition holds. Returns one list
    of frames a step (the greeting first)."""

    async def run():
        out = []
        sock = await ws.connect(url.replace("http", "ws") + "/stream")
        try:
            first: list = []
            await _collect(sock, first, lambda f, c: len(f) >= 1, calls, STEP_TIMEOUT_S)
            out.append(first)
            for step in steps:
                kind = step[0]
                if kind == "health":
                    r = await ws.HTTPClient().get(url + "/health", timeout=5)
                    body = r.json()
                    out.append([{"health": body["status"], "breakers": body["breakers"]}])
                    continue
                if kind == "do":
                    step[1]()
                    continue
                if kind == "sleep":
                    await asyncio.sleep(step[1])
                    continue
                _, payload, done = step
                if kind == "bytes":
                    await sock.send_bytes(payload)
                elif kind == "json":
                    await sock.send_json(payload)
                else:
                    await sock.send_str(payload)
                frames: list = []
                await _collect(sock, frames, done, calls, STEP_TIMEOUT_S)
                out.append(frames)
        finally:
            await sock.close()
        return out

    return asyncio.run(run())


def normalize(x, sids: set):
    """Mask what differs between two runs: trace ids, ms values and the
    executor's session id."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k == "trace_id":
                out[k] = "<trace>"
            elif k.endswith("_ms") and isinstance(v, (int, float)):
                out[k] = "<ms>"
            elif k == "session_id" and isinstance(v, str):
                sids.add(v)
                out[k] = "<sid>"
            else:
                out[k] = normalize(v, sids)
        return out
    if isinstance(x, list):
        return [normalize(v, sids) for v in x]
    return x


def masked(steps: list) -> list:
    sids: set = set()
    norm = normalize(steps, sids)
    text = json.dumps(norm, sort_keys=True)
    for sid in sorted(sids, key=len, reverse=True):
        text = text.replace(sid, "<sid>")
    return json.loads(text)


# ---------------------------------------------------------------- scenarios


def final_step(text_kind: str = "latency_budget"):
    return ("bytes", PCM, until_type(text_kind))


SCENARIOS = {
    "null_mode_warn": dict(script=[], steps=[]),
    "audio_to_execution": dict(
        script=[("partial", "search for"), ("final", "search for laptops")],
        steps=[("bytes", PCM, until_type("transcript_partial")), final_step()]),
    "risky_then_confirm": dict(
        script=[("final", "upload my resume and submit the form")],
        steps=[final_step(),
               ("json", {"type": "confirm_execute", "intents": [{"type": "screenshot"}]},
                until_type("execution_result"))]),
    "typed_text": dict(
        script=[],
        steps=[("json", {"type": "text", "text": "take a screenshot"},
                until_type("latency_budget"))]),
    "context_update": dict(
        script=[],
        steps=[("json", {"type": "context_update", "data": {"last_query": "tvs"}},
                until_type("info")),
               ("json", {"type": "text", "text": "scroll down"}, until_type("latency_budget"))]),
    "bad_control_frames": dict(
        script=[],
        steps=[("json", {"type": "florble"}, until_type("warn")),
               ("str", "not json", until_type("warn")),
               ("json", {"type": "tenant", "tenant": "gold"}, until_type("info")),
               ("json", {"type": "reset"}, until_type("info"))]),
    "odd_length_pcm": dict(
        script=[("final", "scroll down")],
        steps=[("bytes", b"\x01\x02\x03", until_type("warn")), final_step()]),
    "speculative_hit": dict(
        script=[("spec_final", "search for usb hubs"), ("final", "search for usb hubs")],
        steps=[("bytes", PCM, until_calls(1)), final_step()]),
    "speculation_superseded": dict(
        script=[("spec_final", "sort by price"), ("final", "search for red shoes")],
        steps=[("bytes", PCM, until_calls(1)), final_step()]),
    "sticky_409_and_reprobe": dict(
        brain="session", env={"VOICE_RESPEC_AFTER": "2"},
        script=[("spec_final", "scroll down"), ("final", "scroll down")] * 5,
        steps=[("bytes", PCM, until_calls(1)), final_step(),
               ("bytes", PCM, until_calls(2)), final_step(),
               ("bytes", PCM, until_calls(3)), final_step(),
               ("bytes", PCM, until_calls(4)), final_step(),
               ("bytes", PCM, until_calls(6)), final_step()]),
    "transient_409_no_latch": dict(
        brain="scripted", faults={"spec_409": True},
        script=[("spec_final", "scroll down"), ("final", "scroll down")] * 2,
        steps=[("bytes", PCM, until_calls(1)), final_step(),
               ("bytes", PCM, until_calls(3)), final_step()]),
    "speculation_pending_commit": dict(
        brain="planner",
        script=[("spec_final", "scroll down"), ("final", "scroll down")],
        steps=[("bytes", PCM, until_calls(1)), final_step()]),
    "brain_down_degraded": dict(
        brain="down",
        steps=[("json", {"type": "text", "text": "search for red shoes"},
                until_type("latency_budget")),
               ("json", {"type": "text", "text": "take a screenshot"},
                until_type("latency_budget")),
               ("health",)]),
    "breaker_opens_then_recovers": dict(
        brain="scripted", faults={"down": True},
        config={"breaker_threshold": 2, "breaker_reset_s": 0.5},
        steps=[("json", {"type": "text", "text": "scroll down"}, until_type("latency_budget")),
               ("json", {"type": "text", "text": "go back"}, until_type("latency_budget")),
               ("health",),
               ("json", {"type": "text", "text": "scroll up"}, until_type("latency_budget")),
               ("do", "recover"), ("sleep", 0.6), ("health",),
               ("json", {"type": "text", "text": "search for lamps"},
                until_type("latency_budget")),
               ("health",)]),
}


def _run_scenario(name: str, executor, monkeypatch, build_voice) -> tuple[list, list]:
    sc = SCENARIOS[name]
    for k, v in sc.get("env", {}).items():
        monkeypatch.setenv(k, v)
    calls: list = []
    faults = dict(sc.get("faults", {}))
    kind = sc.get("brain", "rule")
    brain = None
    if kind == "down":
        brain_url = f"http://127.0.0.1:{free_port()}"
    else:
        app = {"rule": lambda: build_jax_brain(RuleBasedParser()),
               "session": lambda: build_jax_brain(SessionParser()),
               "planner": lambda: build_jax_brain(PlannerParser(OneShotPlanner())),
               "scripted": lambda: scripted_brain(faults)}[kind]()
        brain = AppServer(with_call_log(app, calls)).__enter__()
        brain_url = brain.url
    steps = [("do", lambda: faults.update(down=False)) if s == ("do", "recover") else s
             for s in sc["steps"]]
    try:
        frames = build_voice(brain_url, executor.url, sc.get("script", []),
                             sc.get("config", {}), steps, calls)
    finally:
        if brain is not None:
            brain.__exit__(None, None, None)
    return frames, calls


def _jax_voice(brain_url, exec_url, script, config, steps, calls):
    app = build_jax_voice(JaxVoiceConfig(brain_url=brain_url, executor_url=exec_url,
                                         stt_factory=lambda: JaxNullSTT(scripted=list(script)),
                                         **config))
    with AppServer(app) as srv:
        return drive(srv.url, steps, calls)


def _port_voice(brain_url, exec_url, script, config, steps, calls):
    app = voice.build_app(voice.VoiceConfig(brain_url=brain_url, executor_url=exec_url,
                                            stt_factory=lambda: NullSTT(scripted=list(script)),
                                            **config))
    with ws.ServerThread(app) as srv:
        return drive(srv.url, steps, calls)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scripted_frames_and_brain_calls_match_the_jax_service(name, executor, monkeypatch):
    jax_frames, jax_calls = _run_scenario(name, executor, monkeypatch, _jax_voice)
    port_frames, port_calls = _run_scenario(name, executor, monkeypatch, _port_voice)
    assert masked(port_frames) == masked(jax_frames)
    assert port_calls == jax_calls
    # and each scenario does what it is named for
    flat = [f for step in port_frames for f in step]
    types = [f.get("type") for f in flat]
    if name == "null_mode_warn":
        assert types == ["warn"] and "null mode" in flat[0]["message"]
    elif name == "audio_to_execution":
        res = next(f for f in flat if f.get("type") == "execution_result")
        assert res["data"]["results"][0]["ok"] and res["data"]["session_id"]
    elif name == "risky_then_confirm":
        conf = next(f for f in flat if f.get("type") == "confirmation_required")
        assert all(i["requires_confirmation"] for i in conf["intents"])
        assert types.index("execution_result") > types.index("confirmation_required")
    elif name == "speculative_hit":
        assert [c["speculative"] for c in port_calls] == [True]
    elif name == "speculation_superseded":
        assert [(c["text"], c["speculative"]) for c in port_calls] == [
            ("sort by price", True), ("search for red shoes", False)]
    elif name == "sticky_409_and_reprobe":
        assert sum(c["speculative"] for c in port_calls) == 2
    elif name == "transient_409_no_latch":
        assert sum(c["speculative"] for c in port_calls) == 2
    elif name == "speculation_pending_commit":
        assert [c["speculative"] for c in port_calls] == [True, False]
        assert "execution_result" in types
    elif name == "brain_down_degraded":
        warns = [f["message"] for f in flat if f.get("type") == "warn" and f.get("degraded")]
        assert warns[0].startswith("brain unavailable (ConnectError")
        assert "circuit open" in warns[1]
    elif name == "breaker_opens_then_recovers":
        healths = [f["breakers"]["brain"] for f in flat if "health" in f]
        assert healths == ["open", "half_open", "closed"]
    elif name == "odd_length_pcm":
        assert flat[1]["message"].startswith("bad audio frame:") and "intent" in types


# ------------------------------------------------------------- the WS layer


@pytest.fixture(scope="module")
def two_servers(executor):
    """The JAX voice service and the port's, both in null-STT mode."""
    port_url = f"http://127.0.0.1:{free_port()}"  # no brain: never called here
    jax = AppServer(build_jax_voice(JaxVoiceConfig(
        brain_url=port_url, executor_url=executor.url,
        stt_factory=lambda: JaxNullSTT()))).__enter__()
    port = ws.ServerThread(voice.build_app(voice.VoiceConfig(
        brain_url=port_url, executor_url=executor.url,
        stt_factory=lambda: NullSTT()))).__enter__()
    yield {"jax": jax.url, "port": port.url}
    port.__exit__(None, None, None)
    jax.__exit__(None, None, None)


def _raw_frame(opcode: int, payload: bytes, *, fin: bool = True, mask: bool = True) -> bytes:
    return ws.encode_frame(opcode, payload, mask=mask, fin=fin)


async def _raw_session(url: str, frames: list[bytes], wait_s: float = 3.0) -> list:
    """Open /stream with a hand-written handshake, send raw frames, and read
    the server's frames (opcode, payload) until it closes or goes quiet."""
    u = url.replace("http://", "")
    host, port = u.split(":")
    reader, writer = await asyncio.open_connection(host, int(port))
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    writer.write((f"GET /stream HTTP/1.1\r\nHost: {u}\r\nUpgrade: websocket\r\n"
                  f"Connection: keep-alive, Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    head = await reader.readuntil(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 101"), head
    assert ws.accept_key(key).encode() in head
    for f in frames:
        writer.write(f)
    await writer.drain()
    got = []
    try:
        while True:
            b0, b1 = await asyncio.wait_for(reader.readexactly(2), wait_s)
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack("!H", await reader.readexactly(2))
            elif n == 127:
                (n,) = struct.unpack("!Q", await reader.readexactly(8))
            payload = await reader.readexactly(n)
            got.append((b0 & 0x0F, payload))
            if b0 & 0x0F == ws.OP_CLOSE:
                break
    except (asyncio.TimeoutError, asyncio.IncompleteReadError, ConnectionError):
        pass
    writer.close()
    return got


def _texts(got) -> list:
    return [json.loads(p) for op, p in got if op == ws.OP_TEXT]


def _close_code(got):
    codes = [struct.unpack("!H", p[:2])[0] for op, p in got if op == ws.OP_CLOSE and p]
    return codes[0] if codes else None


@pytest.mark.parametrize("server", ["jax", "port"])
def test_raw_frames_fragmented_text_and_ping(two_servers, server):
    msg = json.dumps({"type": "context_update", "data": {"k": "v"}}).encode()
    frames = [_raw_frame(ws.OP_TEXT, msg[:10], fin=False),
              _raw_frame(ws.OP_PING, b"hello"),  # a control frame between fragments
              _raw_frame(ws.OP_CONT, msg[10:20], fin=False),
              _raw_frame(ws.OP_CONT, msg[20:])]
    got = asyncio.run(_raw_session(two_servers[server], frames, wait_s=1.0))
    assert (ws.OP_PONG, b"hello") in got
    assert [t["type"] for t in _texts(got)] == ["warn", "info"]
    assert _texts(got)[1]["message"] == "context updated"


def test_raw_unmasked_frame_is_closed_with_1002(two_servers):
    """RFC 6455 5.1: a server closes on an unmasked client frame. (aiohttp,
    under the JAX service, reads it as if masked; the port keeps to the RFC.)"""
    frames = [_raw_frame(ws.OP_TEXT, b'{"type": "reset"}', mask=False)]
    got = asyncio.run(_raw_session(two_servers["port"], frames))
    assert _close_code(got) == 1002
    assert [t["type"] for t in _texts(got)] == ["warn"]


@pytest.mark.parametrize("server", ["jax", "port"])
def test_raw_invalid_utf8_text_is_closed_with_1007(two_servers, server):
    got = asyncio.run(_raw_session(two_servers[server], [_raw_frame(ws.OP_TEXT, b"\xff\xfe")]))
    assert _close_code(got) == 1007


@pytest.mark.parametrize("server", ["jax", "port"])
def test_bad_confirm_intents_warn_and_keep_the_session(two_servers, server):
    """The warn's detail is the validator's own text (pydantic's in JAX), so
    only its head is compared; the session answers the next frame."""

    async def run():
        c = await ws.connect(two_servers[server] + "/stream")
        await c.receive(timeout=5)
        out = []
        for intents in ([{"type": "fly"}], [{"type": "click", "priority": 9}], 5):
            await c.send_json({"type": "confirm_execute", "intents": intents})
            out.append((await c.receive(timeout=5)).json())
        await c.send_json({"type": "reset"})
        out.append((await c.receive(timeout=5)).json())
        await c.close()
        return out

    out = asyncio.run(run())
    assert [f["message"].split(":")[0] for f in out[:3]] == ["bad intents"] * 3
    assert out[3] == {"type": "info", "message": "state reset"}


def test_aiohttp_client_against_the_port_server(two_servers):
    url = two_servers["port"].replace("http", "ws") + "/stream"

    async def run():
        async with aiohttp.ClientSession() as sess:
            async with sess.ws_connect(url, autoping=False) as w:
                assert json.loads((await w.receive(timeout=5)).data)["type"] == "warn"
                await w.ping(b"p1")
                msg = await w.receive(timeout=5)
                assert msg.type == aiohttp.WSMsgType.PONG and msg.data == b"p1"
                await w.send_json({"type": "context_update", "data": {"a": 1}})
                assert json.loads((await w.receive(timeout=5)).data)["message"] == \
                    "context updated"
                await w.close(code=4000)
                assert w.close_code == 4000  # the peer's code echoed
            async with sess.ws_connect(url) as w:
                await w.receive(timeout=5)
                await w.send_bytes(b"\0" * (ws.MAX_MSG_SIZE + 1))
                msg = await w.receive(timeout=10)
                assert msg.type == aiohttp.WSMsgType.CLOSE and msg.data == 1009
            async with sess.get(two_servers["port"] + "/health") as r:
                assert r.status == 200 and (await r.json())["service"] == "voice"

    asyncio.run(run())


def test_port_client_against_the_jax_server(two_servers):
    url = two_servers["jax"] + "/stream"

    async def run():
        c = await ws.connect(url)
        assert (await c.receive(timeout=5)).json()["type"] == "warn"
        await c.ping(b"x")  # answered by aiohttp; nothing surfaces
        await c.send_json({"type": "florble"})
        assert "unknown control" in (await c.receive(timeout=5)).json()["message"]
        await c.close(code=4000)
        # the handshake completed: aiohttp answers with its own code
        assert c.closed and c.close_code == 1000
        c = await ws.connect(url)
        await c.receive(timeout=5)
        await c.send_bytes(b"\0" * (ws.MAX_MSG_SIZE + 1))
        msg = await c.receive(timeout=10)
        assert msg.type == ws.CLOSE and msg.data == 1009
        r = await ws.HTTPClient().get(two_servers["jax"] + "/health", timeout=5)
        assert r.status_code == 200 and r.json()["service"] == "voice"

    asyncio.run(run())


def test_concurrent_senders_never_interleave_frames():
    """Fire-and-forget tasks and the read loop share one socket: 40 tasks
    each send 25 frames (some past 64 KiB, so writes go out in parts) and
    every frame must arrive whole and in each task's own order."""
    n_tasks, n_frames = 40, 25

    async def handler(sock, _req):
        async def sender(t):
            for i in range(n_frames):
                await sock.send_json({"t": t, "i": i, "pad": "x" * (70_000 if i % 7 == 0 else i)})
                await asyncio.sleep(0)

        await asyncio.gather(*(sender(t) for t in range(n_tasks)))

    async def http(_req):
        return ws.Response(404, {})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ws.ServerThread(ws.App(http=http, websockets={"/s": handler})) as srv:
            async def run():
                c = await ws.connect(srv.url + "/s")
                seen = {t: [] for t in range(n_tasks)}
                for _ in range(n_tasks * n_frames):
                    f = (await c.receive(timeout=30)).json()
                    seen[f["t"]].append(f["i"])
                await c.close()
                return seen

            seen = asyncio.run(asyncio.wait_for(run(), 60))
    finally:
        sys.setswitchinterval(old)
    assert all(v == list(range(n_frames)) for v in seen.values())


def test_a_slow_handler_pushes_back_on_a_fast_sender():
    """The server stops reading while more than INBOX_BYTES of received
    messages wait for its handler: a client that sends 4 MiB while the
    handler sleeps leaves at most INBOX_BYTES and one message queued, and
    every message still arrives whole and in order."""
    n, size = 128, 32 * 1024

    def payload(i):
        return bytes([i % 251]) * size

    async def handler(sock, _req):
        got = [(await sock.receive(timeout=10)).data]
        peak = 0
        for _ in range(50):  # half a second behind the sender
            await asyncio.sleep(0.01)
            peak = max(peak, sock._inbox_bytes)
        paused = not sock._inbox_room.is_set()
        while len(got) < n:
            got.append((await sock.receive(timeout=10)).data)
        await sock.send_json({"peak": peak, "paused": paused,
                              "intact": got == [payload(i) for i in range(n)]})

    async def http(_req):
        return ws.Response(404, {})

    with ws.ServerThread(ws.App(http=http, websockets={"/s": handler})) as srv:
        async def run():
            c = await ws.connect(srv.url + "/s")

            async def send_all():
                for i in range(n):
                    await c.send_bytes(payload(i))

            sender = asyncio.ensure_future(send_all())
            reply = (await c.receive(timeout=30)).json()
            await sender
            await c.close()
            return reply

        reply = asyncio.run(asyncio.wait_for(run(), 60))
    assert reply["paused"] and reply["intact"]
    assert 0 < reply["peak"] <= ws.INBOX_BYTES + size


def test_http_client_splits_connect_from_read_failures():
    async def run():
        with pytest.raises(ws.ConnectError):
            await ws.HTTPClient().post(f"http://127.0.0.1:{free_port()}/parse", json={})

        async def hang_up(reader, writer):  # reads the request, answers nothing
            await reader.readuntil(b"\r\n\r\n")
            writer.close()

        srv = await asyncio.start_server(hang_up, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        with pytest.raises(ws.ReadError):
            await ws.HTTPClient().post(f"http://127.0.0.1:{port}/parse", json={})
        srv.close()

    asyncio.run(run())


# --------------------------------------------------------------- pure parts


def _partial_streams(seed: int, n: int = 40) -> list[list[str]]:
    """Seeded partial streams: growing transcripts with revisions, word
    joins and retractions, as a streaming STT emits them."""
    rng = random.Random(seed)
    words = ["search", "for", "red", "shoes", "sort", "by", "price", "open", "the", "second",
             "result", "scroll", "down", "a", "bit"]
    streams = []
    for _ in range(n):
        text, out = "", []
        for _ in range(rng.randint(3, 14)):
            r = rng.random()
            if r < 0.55:
                text = (text + " " + rng.choice(words)).strip()
            elif r < 0.7 and text:
                text = text[:-rng.randint(1, 3)]  # mid-word revision
            elif r < 0.8:
                text = " ".join(rng.sample(words, 2))  # retraction
            out.append(text)
            if rng.random() < 0.5:
                out.append(text)  # a stable tick
        streams.append(out)
    return streams


@pytest.mark.parametrize("k,min_chars", [(1, 1), (2, 4), (3, 8), (4, 3)])
def test_prefix_feed_tracker_matches_jax(k, min_chars):
    for stream in _partial_streams(seed=k * 100 + min_chars):
        a, b = voice._PrefixFeedTracker(k, min_chars), JaxTracker(k, min_chars)
        for i, partial in enumerate(stream):
            if i == len(stream) // 2 and k == 2:
                a.reset()
                b.reset()
            assert a.observe(partial) == b.observe(partial)
            assert a.committed == b.committed


def test_prefill_remaining_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        stages = {}
        if rng.random() < 0.7:
            stages["prompt_tokens"] = float(rng.integers(0, 1200))
        if rng.random() < 0.6:
            stages["cached_tokens"] = float(rng.integers(0, 1200))
        spec, degraded = bool(rng.random() < 0.3), bool(rng.random() < 0.3)
        assert voice._prefill_remaining(stages, spec, degraded) == \
            jax_prefill_remaining(stages, spec, degraded)


def test_retry_backoff_matches_jax():
    for kw in ({}, {"jitter": 0.0}, {"base_delay_s": 0.2, "multiplier": 3.0, "max_delay_s": 1.0}):
        a, b = pres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
        ra, rb = random.Random(7), random.Random(7)
        for attempt in range(8):
            assert a.backoff_s(attempt, ra.random) == b.backoff_s(attempt, rb.random)


def test_circuit_breaker_state_machine_matches_jax():
    rng = random.Random(3)
    clock = {"t": 0.0}
    now = lambda: clock["t"]  # noqa: E731
    a = pres.CircuitBreaker("p", failure_threshold=3, reset_after_s=2.0, clock=now)
    b = jres.CircuitBreaker("j", failure_threshold=3, reset_after_s=2.0, clock=now)
    for _ in range(600):
        op = rng.choice(["allow", "allow", "ok", "fail", "fail", "tick"])
        if op == "tick":
            clock["t"] += rng.choice([0.1, 0.5, 1.0, 2.5])
            out = None, None
        elif op == "allow":
            out = a.allow(), b.allow()
        elif op == "ok":
            out = a.record_success(), b.record_success()
        else:
            out = a.record_failure(), b.record_failure()
        assert out[0] == out[1] and a.state == b.state, op


class _FakeResp:
    def __init__(self, status: int, headers: dict | None = None):
        self.status_code = status
        self.headers = ws.Headers(headers or {})


class _FakeHTTP:
    """Plays one outcome an attempt: an int status, a (status, headers)
    pair, or "connect" / "read" (the transport failures of each client)."""

    def __init__(self, outcomes, exc):
        self.outcomes, self.exc, self.sent = list(outcomes), exc, []

    async def post(self, url, json=None, headers=None, timeout=None):
        self.sent.append(dict(headers))
        o = self.outcomes.pop(0)
        if o in self.exc:
            raise self.exc[o]
        status, hdrs = (o, {}) if isinstance(o, int) else o
        return _FakeResp(status, hdrs)


PORT_EXC = {"connect": ws.ConnectError("All connection attempts failed"),
            "read": ws.ReadError("reset")}
JAX_EXC = {"connect": httpx.ConnectError("All connection attempts failed"),
           "read": httpx.ReadError("reset")}


@pytest.mark.parametrize("outcomes", [
    [200], ["connect", "connect", 200], ["connect", "connect", "connect"], ["read", 200],
    [(503, {"Retry-After": "0.3"}), 200], [503, 503, 503], [500], [409], ["connect", 422],
])
def test_post_with_resilience_retry_split_matches_jax(outcomes):
    def run(mod, exc):
        http = _FakeHTTP(outcomes, exc)
        sleeps: list = []
        clock = {"t": 0.0}

        async def sleep(s):
            sleeps.append(round(s, 9))
            clock["t"] += s

        breaker = mod.CircuitBreaker("b", failure_threshold=3, clock=lambda: clock["t"])
        deadline = mod.Deadline.after(5.0, clock=lambda: clock["t"])
        rng = random.Random(11)

        async def go():
            try:
                r = await mod.post_with_resilience(
                    http, "http://x/parse", json_body={}, deadline=deadline,
                    policy=mod.RetryPolicy(), breaker=breaker, sleep=sleep, rng=rng.random)
                return ("status", r.status_code)
            except Exception as e:  # noqa: BLE001 - compared by kind below
                return ("raised", "connect" if "Connect" in type(e).__name__ else
                        "read" if "Read" in type(e).__name__ else type(e).__name__)

        out = asyncio.run(go())
        return out, len(http.sent), sleeps, breaker.state, [
            sorted(h) for h in http.sent], [h["x-deadline-ms"] for h in http.sent]

    assert run(pres, PORT_EXC) == run(jres, JAX_EXC)


def test_slo_tracker_matches_jax():
    rng = np.random.default_rng(5)
    clock = {"t": 0.0}
    kw = dict(window_s=30.0, target_p50_ms=800.0, target_p99_ms=3200.0,
              error_rate_target=0.05, at_risk_fraction=0.8, min_samples=5,
              clock=lambda: clock["t"])
    a, b = SLOTracker("voice", **kw), JaxSLOTracker("voice", passive=True, **kw)
    seen = set()
    for _ in range(300):
        clock["t"] += float(rng.exponential(0.4))
        ms, ok = float(rng.lognormal(6.3, 0.5)), bool(rng.random() > 0.04)
        a.record(ms, ok)
        b.record(ms, ok)
        ea, eb = a.evaluate(), b.evaluate()
        assert ea == eb
        seen.add(ea["state"])
    assert seen == {"ok", "at_risk", "violated"}


def test_slo_env_defaults_match_jax(monkeypatch):
    monkeypatch.setenv("SLO_TARGET_P50_MS", "500")
    monkeypatch.setenv("SLO_WINDOW_S", "60")
    monkeypatch.setenv("SLO_MIN_SAMPLES", "2")
    a, b = SLOTracker("voice"), JaxSLOTracker("voice", passive=True)
    assert (a.window_s, a.target_p50_ms, a.target_p99_ms, a.error_rate_target,
            a.at_risk_fraction, a.min_samples) == (
        b.window_s, b.target_p50_ms, b.target_p99_ms, b.error_rate_target,
        b.at_risk_fraction, b.min_samples)


def test_deadline_header_matches_jax():
    clock = {"t": 10.0}
    a = pres.Deadline.after(1.2345, clock=lambda: clock["t"])
    b = jres.Deadline.after(1.2345, clock=lambda: clock["t"])
    for dt in (0.0, 0.5, 1.0, 2.0):
        clock["t"] = 10.0 + dt
        assert (a.remaining_s(), a.header_value(), a.expired) == \
            (b.remaining_s(), b.header_value(), b.expired)


def test_intent_validation_and_risk_match_jax():
    from tpu_voice_agent.schemas import Intent

    from tpu_voice_agent_torch.schemas import ValidationError, is_risky, validate_intent

    good = [{"type": "screenshot"}, {"type": "upload", "args": {"fileRef": None}},
            {"type": "click", "target": {"strategy": "text", "value": "Go"},
             "requires_confirmation": True, "priority": 3},
            {"type": "confirm", "timeout_ms": 0, "retries": 3}]
    for obj in good:
        jax = Intent.model_validate(obj)
        assert validate_intent(obj) == jax.model_dump()
        assert is_risky(validate_intent(obj)) == jax.is_risky()
    for bad in [{"type": "fly"}, {"args": {}}, {"type": "click", "extra": 1},
                {"type": "click", "priority": 9}, "screenshot"]:
        with pytest.raises(ValidationError):
            validate_intent(bad)


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("env,item", [
    ({"VOICE_STT": "whisper-hf:/models/whisper"}, 8),
    ({"VOICE_STT": "whisper-ckpt:checkpoints/some-other-ckpt"}, 8),
    ({"STT_BATCH_ENABLE": "1", "STT_REPLICAS": "2", "VOICE_STT": "whisper-hf:x"}, 8),
    ({"STT_REPLICAS": "3", "VOICE_STT": "whisper-ckpt:checkpoints/whisper-large"}, 8),
    ({"STT_REPLICAS": "2", "VOICE_STT": "whisper-hf:openai/whisper-tiny"}, 8),
])
def test_stt_factory_refuses_what_it_would_ignore(monkeypatch, env, item):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=f"ROADMAP.md Queue 1 item {item}"):
        voice.stt_factory_from_env()


@pytest.mark.parametrize("env,kind", [
    ({"STT_BATCH_ENABLE": "1", "STT_REPLICAS": "2"}, "tier"),
    ({"STT_REPLICAS": "3"}, "locked"),
    ({"STT_REPLICAS": "2", "VOICE_STT": "null"}, "null"),
], ids=["tier", "no-batch", "null"])
def test_stt_replicas_are_served(monkeypatch, env, kind):
    """Once refused: ``STT_REPLICAS`` > 1 on the batched plane builds the
    replicated tier over the one engine (``/health`` then reports it);
    without the batched plane it is ignored, as JAX ignores it."""
    from tpu_voice_agent_torch.serve.stt_replicas import STTReplicaTier, current_tier

    monkeypatch.setenv("VOICE_STT", "whisper-ckpt:checkpoints/whisper-tiny-overfit")
    monkeypatch.setenv("VOICE_DEVICE", "cpu")
    monkeypatch.delenv("STT_BATCH_ENABLE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    stt = voice.stt_factory_from_env()()
    tier = current_tier()
    try:
        if kind == "tier":
            assert isinstance(stt.batcher, STTReplicaTier) and tier is stt.batcher
            assert len(tier.replicas) == 2 and tier.tier_health()["healthy"] == 2
        elif kind == "locked":
            assert type(stt).__name__ == "LockedStreaming" and tier is None
        else:
            assert isinstance(stt, NullSTT) and tier is None
    finally:
        if tier is not None:
            tier.stop()


def test_quality_enable_boots_whisper_whose_finals_carry_confidence(monkeypatch):
    """``QUALITY_ENABLE=1`` (once refused) boots a Whisper STT with the
    confidence lanes on: its final carries JAX's four keys."""
    from tpu_voice_agent_torch import whisper_ckpt

    monkeypatch.setenv("VOICE_STT", f"whisper-ckpt:{ROOT / 'checkpoints' / 'whisper-tiny-overfit'}")
    monkeypatch.setenv("VOICE_DEVICE", "cpu")
    monkeypatch.setenv("QUALITY_ENABLE", "1")
    stt = voice.stt_factory_from_env()()
    assert stt.engine.quality_lanes
    audio = np.concatenate([whisper_ckpt.render_speech("scroll down"),
                            np.zeros(16_000, np.float32)])
    events = []
    for i in range(0, len(audio), 960):
        events += stt.feed(audio[i:i + 960])
    assert [t for k, t in events if k == "final"] == ["scroll down"]
    lf = stt.last_final
    assert lf.logp_mean is not None and lf.logp_min <= lf.logp_mean <= 0
    assert lf.logp_first is not None and 0 <= lf.repetition < 1


def test_chaos_faults_refused_at_boot(monkeypatch):
    """An unknown chaos point is refused at boot, and the STT replica points
    (once refused) are served; ``drop_frame`` (once refused with the whole
    plane) is served:
    armed at its 2nd event, the 2nd binary frame never reaches the STT and
    ``voice.frames_dropped_chaos`` counts it, while the session lives on."""
    from tpu_voice_agent_torch.utils import chaos as tchaos
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    monkeypatch.setenv("CHAOS_FAULTS", "tyop_fault:1")
    with pytest.raises(ValueError, match="unknown chaos point 'tyop_fault'"):
        voice.build_app(voice.VoiceConfig(stt_factory=lambda: NullSTT()))
    monkeypatch.setenv("CHAOS_FAULTS", "stt_replica_kill:1")  # served with the STT tier
    voice.build_app(voice.VoiceConfig(stt_factory=lambda: NullSTT()))
    monkeypatch.setenv("CHAOS_FAULTS", "drop_frame@2")
    tchaos.reset()
    fed = []

    class CountingSTT(NullSTT):
        def feed(self, samples):
            fed.append(len(samples))
            return super().feed(samples)

    def dropped():
        return get_metrics().snapshot()["counters"].get("voice.frames_dropped_chaos", 0.0)

    async def run(url):
        c = await ws.connect(url.replace("http", "ws") + "/stream")
        await c.receive(timeout=5)  # the null-mode warn
        for _ in range(3):
            await c.send_bytes(np.zeros(160, np.int16).tobytes())
        await c.send_json({"type": "reset"})
        reply = (await c.receive(timeout=5)).json()
        await c.close()
        return reply

    before = dropped()
    try:
        app = voice.build_app(voice.VoiceConfig(brain_url="http://127.0.0.1:9",
                                                stt_factory=CountingSTT))
        with ws.ServerThread(app) as srv:
            reply = asyncio.run(run(srv.url))
    finally:
        tchaos.reset()
    assert reply["type"] != "error"
    assert dropped() == before + 1
    assert fed == [160, 160]  # frames 1 and 3


def test_canary_refused_at_boot(monkeypatch, executor):
    """Once refused: ``QUALITY_CANARY_S`` is the brain's knob, and the voice
    service boots with it set and ignores it, as JAX's does; its /health
    then has the JAX service's keys under the same environment."""
    monkeypatch.setenv("QUALITY_CANARY_S", "0.5")
    no_brain = f"http://127.0.0.1:{free_port()}"
    jax = AppServer(build_jax_voice(JaxVoiceConfig(
        brain_url=no_brain, executor_url=executor.url,
        stt_factory=lambda: JaxNullSTT()))).__enter__()
    port = ws.ServerThread(voice.build_app(voice.VoiceConfig(
        brain_url=no_brain, executor_url=executor.url,
        stt_factory=lambda: NullSTT()))).__enter__()
    try:
        jh = httpx.get(jax.url + "/health", timeout=5).json()
        ph = httpx.get(port.url + "/health", timeout=5).json()
    finally:
        port.__exit__(None, None, None)
        jax.__exit__(None, None, None)
    assert set(ph) == set(jh) - {"brain"}
    assert set(ph["quality"]) == set(jh["quality"])


def test_unknown_stt_spec_and_preset_raise(monkeypatch):
    for spec in ("deepgram", "whisper:whisper-huge"):
        monkeypatch.setenv("VOICE_STT", spec)
        with pytest.raises(ValueError, match="VOICE_STT"):
            voice.stt_factory_from_env()


def test_whisper_stt_needs_a_card_or_voice_device_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    monkeypatch.setenv("VOICE_STT", "whisper:whisper-test")
    monkeypatch.delenv("VOICE_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        voice.stt_factory_from_env()
    monkeypatch.setenv("VOICE_DEVICE", "cpu")
    monkeypatch.setenv("QUALITY_ENABLE", "0")  # served: no confidence lanes either way
    stt = voice.stt_factory_from_env()()
    assert type(stt).__name__ == "LockedStreaming"
    assert stt.engine.device.type == "cpu" and stt.endpointer.spec_frames == 120 // 20


@pytest.mark.parametrize("path,item", [
    ("/static/", 9), ("/", 9), ("/static/app.js", 9),
])
def test_unported_routes_answer_501(two_servers, path, item):
    r = httpx.get(two_servers["port"] + path, timeout=5)
    assert r.status_code == 501
    assert r.json() == {"error": "not_ported", "detail": f"ROADMAP.md Queue 1 item {item}"}


@pytest.mark.parametrize("path", ["/metrics", "/debug/trace/abc123", "/debug/quality",
                                  "/debug/flightrecorder", "/debug/timeseries"])
def test_observability_routes_answer_with_the_jax_keys(two_servers, path):
    """Once 501: the routes answer 200 with the JAX service's body keys."""
    if path == "/debug/flightrecorder":
        # both recorders are process-global: compare them armed
        from tpu_voice_agent.utils.tracing import get_flight_recorder as jax_flight
        from tpu_voice_agent_torch.utils.tracing import get_flight_recorder

        jax_flight().rearm()
        get_flight_recorder().rearm()
    jax = httpx.get(two_servers["jax"] + path, timeout=5)
    port = httpx.get(two_servers["port"] + path, timeout=5)
    assert port.status_code == jax.status_code == 200
    jb, pb = jax.json(), port.json()
    assert set(pb) == set(jb) and pb["service"] == jb["service"] == "voice"
    if path == "/metrics":
        assert set(pb["local"]) == set(jb["local"]) and set(pb["slo"]) == set(jb["slo"])
    elif path == "/debug/quality":
        assert pb["counts"] == jb["counts"] and pb["lanes_enabled"] == jb["lanes_enabled"]
        assert set(pb["slo"]) == set(jb["slo"])
    elif path == "/debug/flightrecorder":
        assert pb["frozen"] is jb["frozen"] is False and pb["armed"] is True
    elif path == "/debug/timeseries":
        assert pb["interval_s"] == jb["interval_s"] and pb["max_samples"] == jb["max_samples"]
    else:
        assert pb == jb == {"service": "voice", "trace_id": "abc123", "spans": []}
    prom = httpx.get(two_servers["port"] + "/metrics", timeout=5,
                     headers={"Accept": "text/plain"})
    assert prom.headers["content-type"].startswith("text/plain; version=0.0.4")
    assert "# TYPE voice_live_sessions gauge" in prom.text


def test_health_keys_are_the_jax_services_but_quality(two_servers):
    """The JAX service's /health keys, ``quality`` included since the quality
    observatory was ported (no brain answers here, so neither forwards one)."""
    jax = httpx.get(two_servers["jax"] + "/health", timeout=5).json()
    port = httpx.get(two_servers["port"] + "/health", timeout=5).json()
    assert set(port) == set(jax) - {"brain"}
    for k in ("ok", "status", "service", "breakers", "slo", "sessions", "capacity_sessions"):
        assert port[k] == jax[k], k
    assert set(port["quality"]) == set(jax["quality"]) == {"slo"}


def test_module_entry_point_serves_without_a_card(tmp_path):
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(VOICE_STT="null", VOICE_PORT=str(port), BRAIN_URL="http://127.0.0.1:9",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-m", "tpu_voice_agent_torch.services.voice"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                r = httpx.get(f"http://127.0.0.1:{port}/health", timeout=2)
                break
            except httpx.TransportError:
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "the voice service never came up"
                time.sleep(0.2)
        assert r.json()["service"] == "voice" and r.json()["ok"]

        async def stream():
            c = await ws.connect(f"ws://127.0.0.1:{port}/stream")
            first = (await c.receive(timeout=5)).json()
            await c.close()
            return first

        assert asyncio.run(stream())["message"] == "no STT model loaded; running in null mode"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# ------------------------------------------------------ the batched STT plane


def test_debug_costs_answers_the_jax_body(two_servers):
    """Once 501: ``/debug/costs`` answers the STT share of the cost meter,
    the JAX service's keys with the same ``enabled``."""
    port = httpx.get(two_servers["port"] + "/debug/costs", timeout=5)
    jax = httpx.get(two_servers["jax"] + "/debug/costs", timeout=5)
    assert port.status_code == jax.status_code == 200
    pb, jb = port.json(), jax.json()
    assert set(pb) == set(jb) == {"service", "enabled", "stt"}
    assert (pb["service"], pb["enabled"]) == (jb["service"], jb["enabled"]) == ("voice", True)


@pytest.mark.parametrize("env", [{"STT_BATCH_ENABLE": "1", "STT_BATCH_SLOTS": "2"},
                                 {"STT_BATCH_ENABLE": "1", "STT_REPLICAS": "1"}])
def test_stt_factory_serves_the_batched_plane(monkeypatch, env):
    """``STT_BATCH_ENABLE=1`` (``STT_BATCH_SLOTS``, ``STT_REPLICAS`` 1):
    every connection shares one engine and one batcher."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("VOICE_STT", "whisper:whisper-test")
    monkeypatch.setenv("VOICE_DEVICE", "cpu")
    factory = voice.stt_factory_from_env()
    a, b = factory(), factory()
    try:
        assert type(a).__name__ == "BatchedStreamingSTT"
        assert a.batcher is b.batcher and a.engine is b.engine
        assert a.batcher.S == int(env.get("STT_BATCH_SLOTS", "4"))
    finally:
        a.batcher.stop()


def test_batched_stt_frames_match_the_jax_service(executor, monkeypatch):
    """Both services under ``STT_BATCH_ENABLE=1`` on the trained
    ``whisper-tiny-overfit`` (the port on the CPU), one rule brain, one
    executor: a ``tenant`` control frame, then "search for red shoes" as
    60 ms PCM16 frames and a second of silence. Every frame but the
    partials (which the batcher delivers a feed later or a feed sooner, as
    its worker's timing falls) is equal once masked, and the tenant rides
    each /parse."""
    from tpu_voice_agent_torch import whisper_ckpt

    monkeypatch.setenv("STT_BATCH_ENABLE", "1")
    monkeypatch.setenv("VOICE_STT", f"whisper-ckpt:{ROOT / 'checkpoints' / 'whisper-tiny-overfit'}")
    monkeypatch.setenv("VOICE_DEVICE", "cpu")
    audio = np.concatenate([whisper_ckpt.render_speech("search for red shoes"),
                            np.zeros(16_000, np.float32)])
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    frames = [pcm[i:i + 1920] for i in range(0, len(pcm), 1920)]

    def stream(url, calls):
        async def run():
            got: list = []
            sock = await ws.connect(url.replace("http", "ws") + "/stream")
            try:
                await sock.send_json({"type": "tenant", "tenant": "gold"})
                for f in frames:
                    await sock.send_bytes(f)
                await _collect(sock, got, until_type("latency_budget"), calls, 60.0)
            finally:
                await sock.close()
            return got

        return asyncio.run(run())

    out = {}
    for side in ("jax", "port"):
        calls: list = []
        brain_app = with_call_log(scripted_brain({}), calls)
        with AppServer(brain_app) as b:
            if side == "jax":
                app = build_jax_voice(JaxVoiceConfig(brain_url=b.url, executor_url=executor.url))
                with AppServer(app) as srv:
                    got = stream(srv.url, calls)
            else:
                app = voice.build_app(voice.VoiceConfig(brain_url=b.url,
                                                        executor_url=executor.url))
                with ws.ServerThread(app) as srv:
                    got = stream(srv.url, calls)
        flat = [f for f in got if f.get("type") != "transcript_partial"]
        out[side] = (masked([flat]), calls)
    assert out["port"] == out["jax"]
    frames_p, calls_p = out["port"]
    finals = [f for f in frames_p[0] if f.get("type") == "transcript_final"]
    assert [f["text"] for f in finals] == ["search for red shoes"]
    assert calls_p and all(c["tenant"] == "gold" for c in calls_p)
