"""Prefix feeds (the batcher's ``feed_prefix``, the brain's ``/parse`` with
``prefix_feed: true``, the voice service's ``PREFIX_FEED_ENABLE``) against
the JAX package's.

JAX's ``tests/test_streaming_prefill.py`` feed cases run on both packages
over one float32 test-tiny weight tree, the engines shared across the
module as JAX's are: a fed partial leaves a chain the final parse admits
warm and token-identical to cold, a retracted feed is dead cache, a
re-extension starts from the last feed, feeds shed for live work, need the
radix tree and fail closed on an oversized prompt; the port's answers and
warm counts equal JAX's. Then the HTTP contract on both brains, and the
voice service against the port's radix brain: feeds commit, and the final
intent is the one it is without them.
"""

import asyncio
import json
import threading
import time

import httpx
import numpy as np
import pytest
import torch

from tests.http_helper import AppServer
from tests.torch_warm_helper import Side, jax_weights


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    w = jax_weights()
    out = {}
    for name in ("jax", "port"):
        side = Side(name, w)
        side.eng_off = side.engine(radix=False)
        side.eng_on = side.engine()
        out[name] = side
    return out


def _both(sides, case, *a):
    j = case(sides["jax"], *a)
    t = case(sides["port"], *a)
    assert t == j
    return t


def _render(side, text):
    return side.brain.render_prompt(text, {})


def _leak_check(side, eng):
    """With no live slot, every resident block is the tree's."""
    assert eng.allocator.blocks_in_use == side.tree(eng).nodes


# ------------------------------------------------------------- the batcher


def _warm_final(side):
    p_partial = _render(side, "filter the results under one hundred")
    p_final = _render(side, "filter the results under one hundred dollars please")
    cold = side.run(side.eng_off, [p_final], 48)[0]
    assert cold.error is None
    b = side.batcher(side.eng_on, 48)
    out = b.feed_prefix(p_partial)
    assert out["ok"] is True and out["prompt_tokens"] > 0
    tok = side.eng_on.tokenizer
    ids_p, ids_f = tok.encode(p_partial, bos=True), tok.encode(p_final, bos=True)
    shared = next((i for i, (a, c) in enumerate(zip(ids_p, ids_f)) if a != c), len(ids_p))
    warm = side.run(side.eng_on, [p_final], 48)[0]
    assert warm.error is None and warm.token_ids == cold.token_ids
    bs = side.eng_on.block_size
    assert warm.cached_tokens >= (shared // bs) * bs - bs  # block-rounded
    _leak_check(side, side.eng_on)
    return out, warm.token_ids, warm.cached_tokens


def test_feed_then_final_is_warm_and_token_identical(sides):
    _both(sides, _warm_final)


def _retraction(side):
    fed = _render(side, "recognize speech with this microphone")
    final = _render(side, "wreck a nice beach with this microphone")
    cold = side.run(side.eng_off, [final], 48)[0]
    out = side.batcher(side.eng_on, 48).feed_prefix(fed)
    assert out["ok"] is True
    warm = side.run(side.eng_on, [final], 48)[0]
    assert warm.error is None and warm.token_ids == cold.token_ids
    assert warm.cached_tokens >= len(side.eng_on.prefix_ids)  # the longest valid prefix
    _leak_check(side, side.eng_on)
    return out, warm.token_ids, warm.cached_tokens


def test_feed_retraction_falls_back_token_identically(sides):
    _both(sides, _retraction)


def _reextension(side):
    b = side.batcher(side.eng_on, 48)
    o1 = b.feed_prefix(_render(side, "sort these results by price from low"))
    o2 = b.feed_prefix(_render(side, "sort these results by price from low to high right now"))
    assert o1["ok"] and o2["ok"]
    assert o2["cached_tokens"] >= max(len(side.eng_on.prefix_ids), o1["cached_tokens"])
    _leak_check(side, side.eng_on)
    return o1, o2


def test_feed_reextension_is_incremental(sides):
    _both(sides, _reextension)


def _sheds(side):
    b = side.batcher(side.eng_on, 48)
    before = side.counter("prefill.feeds_shed")
    b.pending.append((999, "queued work"))
    busy = b.feed_prefix(_render(side, "take a screenshot"))
    b.pending.clear()
    for sl in b.slots:  # every slot taken
        sl.request_id = 1
    b._active_h[:] = True
    full = b.feed_prefix(_render(side, "take a screenshot"))
    for sl in b.slots:
        sl.request_id = -1
    b._active_h[:] = False
    assert busy == {"ok": False, "reason": "busy"} and full == {"ok": False, "reason": "no_slot"}
    _leak_check(side, side.eng_on)
    return busy, full, side.counter("prefill.feeds_shed") - before


def test_feed_sheds_for_live_work(sides):
    _both(sides, _sheds)


def _no_radix(side):
    out = side.batcher(side.eng_off, 48).feed_prefix(_render(side, "take a screenshot"))
    assert out == {"ok": False, "reason": "radix_off"}
    return out


def test_feed_requires_radix(sides):
    _both(sides, _no_radix)


def _oversized(side):
    out = side.batcher(side.eng_on, 48).feed_prefix(list(range(1, 4000)))
    assert out["ok"] is False
    _leak_check(side, side.eng_on)
    return out["ok"]


def test_feed_oversized_prompt_fails_closed(sides):
    _both(sides, _oversized)


# ----------------------------------------------------------- the brain seam


class _Brains:
    """A batched brain of each package around its own fresh engine."""

    def __init__(self, sides, radix: bool = True):
        self.j = sides["jax"].brain.BatchedEngineParser(
            sides["jax"].engine(radix=radix), max_new_tokens=24, session_aware=radix)
        self.jsrv = AppServer(sides["jax"].brain.build_app(self.j)).__enter__()
        tb = sides["port"].brain
        self.t = tb.BatchedEngineParser(sides["port"].engine(radix=radix), max_new_tokens=24,
                                        session_aware=radix)
        self.tsrv = tb.make_server(tb.BrainApp(self.t), port=0)
        self.thread = threading.Thread(target=self.tsrv.serve_forever, daemon=True)
        self.thread.start()
        self.urls = {"jax": self.jsrv.url,
                     "port": f"http://127.0.0.1:{self.tsrv.server_address[1]}"}

    def close(self):
        self.jsrv.__exit__(None, None, None)
        self.tsrv.shutdown()
        self.tsrv.server_close()
        self.thread.join(timeout=30)
        self.j.close()
        self.t.close()


def test_parse_prefix_feed_http_contract(sides):
    """Backends without a prefill-only admission path answer 409
    ``prefix_feed_unsupported`` (the rule parser; a one-slot engine parser);
    the batched radix brain answers 200 with the feed's verdict, runs no
    decode, and leaves the session's prompt cached past the static prefix.
    Both brains answer alike."""
    from tpu_voice_agent_torch.services import brain

    text = "search for usb c hubs with four ports and a card reader under fifty dollars"
    body = {"text": text, "context": {}, "prefix_feed": True}
    jb = sides["jax"].brain
    with AppServer(jb.build_app(jb.RuleBasedParser())) as srv:
        jr = httpx.post(srv.url + "/parse", json=body, timeout=30)
    status, tbody, _ = brain.BrainApp(brain.RuleBasedParser()).parse(json.dumps(body).encode())
    assert (status, tbody) == (jr.status_code, jr.json()) == (
        409, {"error": "prefix_feed_unsupported",
              "detail": "backend has no prefill-only admission path"})
    one = brain.EngineParser(sides["port"].engine(batch_slots=1, radix=False))
    assert brain.BrainApp(one).parse(json.dumps(body).encode())[0] == 409

    b = _Brains(sides)
    try:
        got = {}
        for name, url in b.urls.items():
            side = sides[name]
            feeds0 = side.counter("prefill.feeds_committed")
            r = httpx.post(url + "/parse", json={**body, "session_id": "s1"}, timeout=120)
            assert r.status_code == 200
            committed = side.counter("prefill.feeds_committed") - feeds0
            parser = b.j if name == "jax" else b.t
            eng = parser.engine
            ids = eng.tokenizer.encode(parser.transcripts.prompt_for("s1", text, {}), bos=True)
            assert not parser.batcher.results  # no decode ran
            got[name] = (r.json(), committed, side.tree(eng).cached_tokens(ids))
        assert got["port"] == got["jax"]
        feed, committed, cached = got["port"]
        assert feed["prefix_feed"] is True and feed["ok"] is True and committed == 1
        bs = b.t.engine.block_size
        pinned = len(b.t.engine.prefix_ids) // bs * bs
        assert cached == (len(ids) - 1) // bs * bs > pinned  # the fed chain is in the tree
    finally:
        b.close()


def test_a_radix_off_batched_brain_sheds_feeds_as_jax(sides):
    """A batched brain without the tree takes the feed and sheds it:
    ``radix_off``, answered 200 (never retried), on both brains."""
    b = _Brains(sides, radix=False)
    try:
        bodies = {name: httpx.post(url + "/parse", json={"text": "go back", "context": {},
                                                         "prefix_feed": True}, timeout=60)
                  for name, url in b.urls.items()}
        assert {k: (r.status_code, r.json()) for k, r in bodies.items()} == {
            k: (200, {"prefix_feed": True, "ok": False, "reason": "radix_off"})
            for k in bodies}
    finally:
        b.close()


# ------------------------------------------------------------ voice service


PARTIALS = ["search for", "search for wireless", "search for wireless head",
            "search for wireless headphones"]


def _distilled_brain():
    """The port's brain on the in-repo distilled checkpoint, served batched
    on a paged radix pool of 4-position blocks (its prompts are ~20 tokens), so
    its answers are real intents."""
    from dataclasses import replace

    from tpu_voice_agent_torch import distilled
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
    from tpu_voice_agent_torch.services import brain

    cfg, params = distilled.load_distilled(device="cpu")
    eng = PagedDecodeEngine(cfg=replace(cfg, max_seq_len=512), max_len=512,
                            prefill_buckets=(64, 128), init_weights=False, device="cpu",
                            batch_slots=2, block_size=4, radix_enable=True)
    eng.load_params(params)
    parser = brain.BatchedEngineParser(eng, max_new_tokens=300, session_aware=True,
                                       render=distilled.distilled_prompt)
    srv = brain.make_server(brain.BrainApp(parser), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def close():
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        parser.close()

    return f"http://127.0.0.1:{srv.server_address[1]}", close


def _utterance(url: str, feeds: bool, monkeypatch) -> tuple[dict, dict, float]:
    """One utterance through the port's voice service with a scripted STT:
    the partials (each a binary frame), then, once the brain has committed
    what the service fed, the final. Returns (the intent frame, the
    latency_budget frame, feeds committed)."""
    from tpu_voice_agent_torch.serve.stt import NullSTT
    from tpu_voice_agent_torch.services import voice, ws
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    def committed():
        return get_metrics().snapshot()["counters"].get("prefill.feeds_committed", 0.0)

    monkeypatch.setenv("PREFIX_FEED_ENABLE", "1" if feeds else "0")
    monkeypatch.setenv("PREFIX_FEED_STABLE_K", "2")
    monkeypatch.setenv("PREFIX_FEED_MIN_CHARS", "4")
    script = [("partial", t) for t in PARTIALS] + [("final", PARTIALS[-1])]
    app = voice.build_app(voice.VoiceConfig(brain_url=url, executor_url="http://127.0.0.1:9",
                                            stt_factory=lambda: NullSTT(list(script))))
    c0 = committed()

    async def run(base):
        c = await ws.connect(base.replace("http", "ws") + "/stream")
        frames = [(await c.receive(timeout=10)).json()]  # the null-mode warn
        frame = np.zeros(160, np.int16).tobytes()
        for _ in PARTIALS:
            await c.send_bytes(frame)
        give_up = time.monotonic() + 120
        while feeds and committed() - c0 < 2 and time.monotonic() < give_up:
            await asyncio.sleep(0.05)
        await c.send_bytes(frame)
        while not any(f["type"] == "latency_budget" for f in frames):
            frames.append((await c.receive(timeout=300)).json())
        await c.close()
        return frames

    with ws.ServerThread(app) as srv:
        frames = asyncio.run(run(srv.url))
    intent = next(f for f in frames if f["type"] == "intent")
    budget = next(f for f in frames if f["type"] == "latency_budget")
    return intent, budget, committed() - c0


def test_voice_feeds_commit_on_the_ports_radix_brain(monkeypatch):
    """``PREFIX_FEED_ENABLE=1`` against the port's batched radix brain: the
    stabilized partials are committed (no 409 latch any more), the final
    parse is served from the fed chain, and its intent is the one a fresh
    brain answers without feeds."""
    results = {}
    for feeds in (False, True):
        url, close = _distilled_brain()
        try:
            results[feeds] = _utterance(url, feeds, monkeypatch)
        finally:
            close()
    (i_off, b_off, c_off), (i_on, b_on, c_on) = results[False], results[True]
    assert c_off == 0 and c_on >= 2
    assert i_on["data"] == i_off["data"] and i_on["data"]["intents"][0]["type"] == "search"
    assert b_on["stages"]["cached_tokens"] > b_off["stages"]["cached_tokens"]
