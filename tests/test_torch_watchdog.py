"""The serving loop's watchdog, warm restart, spec fence, drain latch and
the brain's body cap, against the JAX package's.

JAX's cases (``tests/test_faults.py``'s dead-worker watchdog,
``tests/test_chaos.py``'s warm restart and ``stall_step`` drill,
``tests/test_colocate.py``'s drain) run on the port beside the JAX
package's ``ColocatedServing`` and engines on one float32 test-tiny weight
tree: a dead loop is replaced with its future failed fast, a stalled step
fails its parses with JAX's text, warm-restarts the engine (the static
prefix kept, the tree pinned-root-only) and the next batch equals a fresh
engine's, and the abandoned thread never touches the engine again; a
speculative verify loop stops once ``reset`` bumps its fence; the drain
latch refuses nothing and says drained once both lanes are empty. Last,
the brain's body cap: a 1 MiB+ ``/parse`` body gets 413 from both brains,
the port's without reading it.
"""

import http.client
import json
import socket
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from tests.http_helper import AppServer
from tests.torch_warm_helper import Side, jax_weights

PROMPTS = ["search for laptops under 1000", "take a screenshot of this page",
           "scroll down two pages", "open the second result"]
STALL_TEXT = "decode step stalled; engine warm-restarted, work failed fast"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    w = jax_weights()
    return {"jax": Side("jax", w), "port": Side("port", w)}


@pytest.fixture(autouse=True)
def _chaos_hygiene():
    from tpu_voice_agent.utils import chaos as jchaos
    from tpu_voice_agent_torch.utils import chaos as tchaos

    jchaos.reset()
    tchaos.reset()
    yield
    jchaos.reset()
    tchaos.reset()


def _wait(cond, timeout_s: float = 10.0, what: str = "the condition"):
    give_up = time.monotonic() + timeout_s
    while time.monotonic() < give_up:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


class _DeadableBatcher:
    """JAX's stand-in batcher: one pending request answered a step, or the
    loop's thread killed outright when armed (``SystemExit`` is no
    ``Exception``)."""

    def __init__(self):
        self.pending: list = []
        self.slots: list = []
        self.results: dict = {}
        self.die = False
        self._n = 0

    def submit(self, prompt, deadline=None, **kw) -> int:
        rid, self._n = self._n, self._n + 1
        self.pending.append((rid, prompt))
        return rid

    def cancel(self, rid: int, reason: str = "client gone") -> bool:
        live = [(r, p) for r, p in self.pending if r != rid]
        found = len(live) != len(self.pending)
        self.pending = live
        return found

    def busy(self) -> bool:
        return bool(self.pending)

    def step(self) -> None:
        if self.die:
            self.die = False
            raise SystemExit("injected worker death")
        if self.pending:
            rid, prompt = self.pending.pop(0)
            self.results[rid] = f"done:{prompt}"

    def reset(self) -> None:
        self.pending = []


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_restarts_dead_worker_and_fails_inflight_fast():
    """JAX's ``ColocatedServing`` and the port's ``ServingLoop`` on the same
    stand-in: the killed loop's future fails fast with JAX's text, the loop
    is replaced (``colocate.worker_restarts``), and it serves again."""
    from tpu_voice_agent.serve.colocate import ColocatedServing
    from tpu_voice_agent_torch.services.brain import ServingLoop
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    outcomes = {}
    for name in ("jax", "port"):
        if name == "jax":
            co = ColocatedServing(None, _DeadableBatcher())
            co.start()
            submit = co.submit_parse
        else:
            co = ServingLoop(_DeadableBatcher())
            submit = co.submit
        before = get_metrics().snapshot()["counters"].get("colocate.worker_restarts", 0.0)
        co.start_watchdog(interval_s=0.05)
        try:
            co.batcher.die = True
            fut = submit("doomed")
            with pytest.raises(RuntimeError, match="worker died") as e:
                fut.result(timeout=5)
            _wait(co.healthy, what="the restarted loop")
            outcomes[name] = (str(e.value), co.stats.restarts, submit("revived").result(timeout=5))
            if name == "port":
                assert get_metrics().snapshot()["counters"]["colocate.worker_restarts"] == \
                    before + 1
        finally:
            co.stop()
        assert not co.healthy()
    assert outcomes["port"] == outcomes["jax"] == (
        "serving worker died; work failed fast on restart", 1, "done:revived")


def _warm_restart(side):
    from tpu_voice_agent_torch.services.prompts import render_prompt

    e = side.engine()
    prompt = render_prompt(PROMPTS[0], {})
    b = side.batcher(e, 48, chunk_steps=8)
    r1 = b.generate_many([prompt])[0]
    assert r1.error is None and r1.cached_tokens > 0
    b.reset()
    e.warm_restart()
    pb = side.prefix_blocks(e)
    assert e.allocator.blocks_in_use == len(pb)  # only the re-reserved prefix survives
    assert side.tree(e).nodes == len(pb)  # the tree is pinned-root-only
    r2 = side.batcher(e, 48, chunk_steps=8).generate_many([prompt])[0]
    assert r2.error is None and r2.token_ids == r1.token_ids
    assert r2.cached_tokens == r1.cached_tokens
    return r2.token_ids, r2.cached_tokens, len(pb)


def test_warm_restart_keeps_prefix_and_token_identity(sides):
    assert _warm_restart(sides["port"]) == _warm_restart(sides["jax"])


def test_warm_restart_keeps_the_trees_limits_and_clears_slot_state(sides):
    """The tree keeps ``max_nodes`` and its tenant quota; the slot tables,
    ``_mid_prefill``, the namespaces, the pressure window and an armed NaN
    drill are cleared; the pool tensors are the same objects."""
    side = sides["port"]
    e = side.engine(max_nodes=64)
    quota = lambda ns: 3  # noqa: E731
    e.radix.ns_quota = quota
    pool = e.k_pool
    e._slot_ns[1] = "gold"
    e._mid_prefill.add(0)
    e._pressure_until = time.monotonic() + 60
    e._nan_inject = np.ones(2, bool)
    e.block_tables[0, :3] = 5
    e.warm_restart()
    assert e.radix.max_nodes == 64 and e.radix.ns_quota is quota
    assert not e._slot_ns and not e._mid_prefill and e._nan_inject is None
    assert e._pressure_until == 0.0 and int(e.block_tables.abs().sum()) == 0
    assert e.k_pool is pool


def test_dense_warm_restart_keeps_the_prefix(sides):
    """The dense layout (JAX's ``DecodeEngine.warm_restart``): a fresh KV
    cache, the shared prefix's KV kept, the same tokens after it."""
    from tpu_voice_agent_torch import bridge
    from tpu_voice_agent_torch.serve.engine import DecodeEngine
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix
    from tpu_voice_agent_torch.services.prompts import render_prompt

    from tests.torch_warm_helper import KW

    e = DecodeEngine(init_weights=False, device="cpu", **KW)
    e.load_params(bridge.params_from_numpy(sides["port"].weights))
    install_prompt_prefix(e)
    prompt = render_prompt(PROMPTS[1], {})
    b = sides["port"].batcher(e, 32, chunk_steps=8)
    r1 = b.generate_many([prompt])[0]
    cache = e.cache
    b.reset()
    e.warm_restart()
    assert e.cache is not cache and e.prefix_kv is not None
    r2 = sides["port"].batcher(e, 32, chunk_steps=8).generate_many([prompt])[0]
    assert r2.token_ids == r1.token_ids and r2.cached_tokens == r1.cached_tokens > 0


def _stall_drill(side, monkeypatch):
    """``stall_step@1`` with a 1 s stall against a 0.3 s watchdog: every
    in-flight parse fails fast with JAX's text, ``engine.restarts`` moves by
    one, the flight recorder freezes on ``engine.stall``, and the next batch
    equals a fresh engine's."""
    from tpu_voice_agent_torch.services.prompts import render_prompt

    monkeypatch.setenv("CHAOS_STALL_S", "1.0")
    if side.name == "jax":
        from tpu_voice_agent.serve.colocate import ColocatedServing
        from tpu_voice_agent.utils import chaos
    else:
        from tpu_voice_agent_torch.services.brain import ServingLoop
        from tpu_voice_agent_torch.utils import chaos
    e = side.engine()
    b = side.batcher(e, 24, chunk_steps=8)
    prompts = [render_prompt(p, {}) for p in PROMPTS]
    fresh = side.batcher(side.engine(), 24, chunk_steps=8).generate_many(prompts)
    before = side.counter("engine.restarts")
    launches: list[tuple[threading.Thread, float]] = []
    forward = e._forward if side.name == "port" else None
    if forward is not None:
        def watched(*a, **kw):
            launches.append((threading.current_thread(), time.monotonic()))
            return forward(*a, **kw)

        e._forward = watched
    if side.name == "jax":
        co = ColocatedServing(None, b)
        co.start()
        submit = co.submit_parse
    else:
        co = ServingLoop(b, autostart=False)
        submit = co.submit
    chaos.configure("stall_step@1")
    futs = [submit(p) for p in prompts]  # all queued before the first step
    if side.name == "port":
        co.start()
    old = co._thread
    co.start_watchdog(interval_s=0.05, stall_s=0.3)
    try:
        errors = []
        for f in futs:
            with pytest.raises(RuntimeError) as exc:
                f.result(timeout=10)  # failed fast, long before the stall ends
            errors.append(str(exc.value))
        t_restart = time.monotonic()
        assert side.counter("engine.restarts") == before + 1
        chaos.reset()
        _wait(co.healthy, what="the replacement loop")
        assert co._thread is not old
        again = [f.result(timeout=120) for f in [submit(p) for p in prompts]]
        assert [r.token_ids for r in again] == [r.token_ids for r in fresh]
        _wait(lambda: not old.is_alive(), timeout_s=5, what="the abandoned thread to exit")
        if forward is not None:
            # the abandoned thread woke after the restart and launched nothing
            assert not [t for t, at in launches if t is old], "the abandoned thread ran a forward"
            assert [t for t, at in launches if at > t_restart]  # the new loop did
    finally:
        co.stop()
    return errors, side.counter("engine.restarts") - before


def test_stall_step_drill_warm_restarts_and_fails_inflight_fast(sides, monkeypatch):
    from tpu_voice_agent_torch.utils.tracing import get_flight_recorder

    get_flight_recorder().rearm()
    port = _stall_drill(sides["port"], monkeypatch)
    jax_ = _stall_drill(sides["jax"], monkeypatch)
    assert port == jax_ == ([STALL_TEXT] * len(PROMPTS), 1)
    dump = get_flight_recorder().frozen_dump()
    assert dump is not None and dump["reason"] == "engine.stall"


def test_a_step_stalled_mid_decode_launches_nothing_after_the_restart(sides):
    """A real step, not the chaos sleep, runs past the watchdog while its
    rows are live: the 2nd decode forward of the first chunk is slowed past
    ``stall_s``. From the watchdog's supersede on, the stalled thread
    launches no forward and claims no block; the restart waits for it to
    let go of the engine; the next batch on the same loop equals the JAX
    package's fresh engine token for token, and no block leaks."""
    from tpu_voice_agent_torch.services.brain import ServingLoop
    from tpu_voice_agent_torch.services.prompts import render_prompt

    port, jax_ = sides["port"], sides["jax"]
    prompts = [render_prompt(p, {}) for p in PROMPTS]
    want = [r.token_ids for r in jax_.batcher(jax_.engine(), 24, chunk_steps=8)
            .generate_many(prompts)]
    e = port.engine()
    b = port.batcher(e, 24, chunk_steps=8)
    co = ServingLoop(b, autostart=False)
    forwards: list[tuple[threading.Thread, float]] = []
    claims: list[tuple[threading.Thread, float]] = []
    superseded: list[float] = []
    steps = {"n": 0}
    decode_step, forward, claim, supersede = e._decode_step, e._forward, e._claim, b.supersede

    def slow_decode_step(*a):
        steps["n"] += 1
        if steps["n"] == 2:
            time.sleep(1.5)  # five times the watchdog's limit, rows live
        return decode_step(*a)

    def watched_forward(*a, **kw):
        forwards.append((threading.current_thread(), time.monotonic()))
        return forward(*a, **kw)

    def watched_claim(*a, **kw):
        claims.append((threading.current_thread(), time.monotonic()))
        return claim(*a, **kw)

    def watched_supersede():
        superseded.append(time.monotonic())
        supersede()

    e._decode_step, e._forward, e._claim = slow_decode_step, watched_forward, watched_claim
    b.supersede = watched_supersede
    futs = [co.submit(p) for p in prompts]
    co.start()
    old = co._thread
    co.start_watchdog(interval_s=0.05, stall_s=0.3)
    try:
        for f in futs:
            with pytest.raises(RuntimeError, match=STALL_TEXT):
                f.result(timeout=10)
        assert len(superseded) == 1
        _wait(lambda: not old.is_alive(), timeout_s=10, what="the stalled thread to exit")
        again = [f.result(timeout=120) for f in [co.submit(p) for p in prompts]]
    finally:
        co.stop()
    t_sup = superseded[0]
    mine = [at for t, at in forwards if t is old]
    assert mine and max(mine) < t_sup, "the stalled thread launched a forward after the restart"
    assert not [at for t, at in claims if t is old and at > t_sup]
    assert [at for t, at in forwards if t is not old and at > t_sup]  # the fresh loop serves
    assert [r.token_ids for r in again] == want
    assert all(r.error is None for r in again)
    port.balanced(e)


def test_a_verify_loop_stops_once_reset_bumps_the_fence(sides):
    """A speculative chunk wedged in its drafters while the engine is warm
    restarted: the verify loop dispatches no step against the fresh engine
    (the generation fence), and the chunk returns with nothing emitted."""
    from tpu_voice_agent_torch import bridge
    from tpu_voice_agent_torch.serve import spec as spec_mod
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix
    from tpu_voice_agent_torch.services.prompts import render_prompt

    from tests.torch_warm_helper import KW

    eng = PagedDecodeEngine(init_weights=False, device="cpu", radix_enable=True,
                            spec=spec_mod.SpecConfig(k=4), **KW)
    eng.load_params(bridge.params_from_numpy(sides["port"].weights))
    install_prompt_prefix(eng)
    b = ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=24)
    b.submit(render_prompt(PROMPTS[0], {}))
    gate, entered = threading.Event(), threading.Event()
    drafter = eng.spec.drafter
    real = drafter.draft_batch
    calls = {"draft": 0, "verify": 0}

    def wedged(*a, **kw):
        calls["draft"] += 1
        if calls["draft"] == 2:  # the chunk's second step wedges here
            entered.set()
            gate.wait(10)
        return real(*a, **kw)

    drafter.draft_batch = wedged
    verify = spec_mod.verify_step

    def counted(*a, **kw):
        calls["verify"] += 1
        return verify(*a, **kw)

    spec_mod.verify_step = counted
    try:
        t = threading.Thread(target=b.step)
        t.start()
        assert entered.wait(60)
        steps_before = calls["verify"]
        b.reset()  # the watchdog's order: the epoch up, then the warm restart
        eng.warm_restart()
        gate.set()
        t.join(60)
        assert calls["verify"] == steps_before == 1  # nothing after the fence
        assert eng.allocator.blocks_in_use == len(eng._prefix_blocks)
        assert not b.results  # the stale step committed nothing
    finally:
        spec_mod.verify_step = verify
        drafter.draft_batch = real


# ------------------------------------------------------------------ drain


class _Stepper:
    """A stand-in batcher whose requests take ``n`` steps each."""

    def __init__(self, n: int = 3):
        self.n = n
        self.slots, self.results = [], {}
        self.pending: list = []  # [rid, prompt, steps left]
        self._next = 0

    def submit(self, prompt, deadline=None, **kw) -> int:
        rid, self._next = self._next, self._next + 1
        self.pending.append([rid, prompt, self.n])
        return rid

    def busy(self) -> bool:
        return bool(self.pending)

    def cancel(self, rid, reason="client gone"):
        n = len(self.pending)
        self.pending = [p for p in self.pending if p[0] != rid]
        return len(self.pending) != n

    def step(self) -> None:
        time.sleep(0.01)
        for p in list(self.pending):
            p[2] -= 1
            if p[2] <= 0:
                self.pending.remove(p)
                self.results[p[0]] = f"done:{p[1]}"

    def reset(self) -> None:
        self.pending.clear()


class _STT:
    def transcribe(self, audio):
        return f"heard {len(audio)}"


def test_colocated_drain_completes_both_lanes():
    """JAX's drain case on both loops: STT jobs and parses queued, the
    latch set (``colocate.drains_started``), a parse submitted after it is
    still served (the zero-drop contract), ``drain`` returns once both lanes
    are done and ``drained`` turns True only then."""
    from tpu_voice_agent.serve.colocate import ColocatedServing
    from tpu_voice_agent.utils import get_metrics as j_metrics
    from tpu_voice_agent_torch.services.brain import ServingLoop
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    got = {}
    for name in ("jax", "port"):
        if name == "jax":
            co = ColocatedServing(_STT(), _Stepper())
            submit, metrics = co.submit_parse, j_metrics
        else:
            co = ServingLoop(_Stepper(), stt=_STT(), autostart=False)
            submit, metrics = co.submit, get_metrics
        before = metrics().snapshot()["counters"].get("colocate.drains_started", 0.0)
        stt = [co.submit_stt(np.zeros(n, np.float32)) for n in (160, 320)]
        parses = [submit(p) for p in ("search for shoes", "scroll down")]
        assert not co.drained()  # no latch yet
        co.begin_drain()
        late = submit("go back")
        assert co.draining and not co.drained()  # work still queued
        co.drain(timeout_s=30)
        assert co.drained()
        got[name] = ([f.result(timeout=1) for f in stt], [f.result(timeout=1) for f in parses],
                     late.result(timeout=1),
                     metrics().snapshot()["counters"]["colocate.drains_started"] - before)
    assert got["port"] == got["jax"] == (["heard 160", "heard 320"],
                                         ["done:search for shoes", "done:scroll down"],
                                         "done:go back", 1.0)


def test_admin_drain_latches_and_health_reports_drained(sides):
    """``POST /admin/drain`` on a batched brain with parses in flight: every
    one answers, a parse sent after the drain began is served too, and
    ``/health`` reads ``draining`` at once and ``drained`` once both lanes
    are empty (``brain.drains_received`` once)."""
    import httpx

    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    parser = brain.BatchedEngineParser(sides["port"].engine(), max_new_tokens=24,
                                       session_aware=True)
    srv = brain.make_server(brain.BrainApp(parser), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    before = get_metrics().snapshot()["counters"].get("brain.drains_received", 0.0)
    try:
        statuses = []

        def post(text):
            statuses.append(httpx.post(url + "/parse", json={"text": text, "context": {}},
                                       timeout=300).status_code)

        ts = [threading.Thread(target=post, args=(p,)) for p in PROMPTS[:2]]
        for t in ts:
            t.start()
        _wait(lambda: parser.batcher.busy(), what="the parses in flight")
        d = httpx.post(url + "/admin/drain", timeout=30).json()
        assert d["ok"] is True and d["draining"] is True
        h = httpx.get(url + "/health", timeout=30).json()
        assert h["draining"] is True and h["role"] == "both" and h["disagg"] is True
        late = threading.Thread(target=post, args=(PROMPTS[2],))
        late.start()
        for t in ts + [late]:
            t.join(300)
        assert len(statuses) == 3 and all(s in (200, 422) for s in statuses), statuses
        _wait(lambda: httpx.get(url + "/health", timeout=30).json()["drained"], timeout_s=30,
              what="drained")
        assert httpx.post(url + "/admin/drain", timeout=30).json()["drained"] is True
        assert get_metrics().snapshot()["counters"]["brain.drains_received"] == before + 1
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        parser.close()


# --------------------------------------------------------------- body cap


def _raw_post(port: int, path: str, head: dict, body: bytes = b"") -> tuple[int, dict]:
    """A raw HTTP/1.1 POST: the headers as given (a lying Content-Length or
    a chunked body included), then the body; (status, JSON body or {})."""
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        lines = [f"POST {path} HTTP/1.1", "Host: x"] + [f"{k}: {v}" for k, v in head.items()]
        s.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        try:
            s.sendall(body)
        except OSError:
            pass  # the server answered and stopped reading
        resp = http.client.HTTPResponse(s)
        resp.begin()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, {}
    finally:
        s.close()


def test_an_over_cap_parse_body_gets_413_from_both_brains(sides, monkeypatch):
    """A ``/parse`` body past 1 MiB: the JAX brain (aiohttp's default
    ``client_max_size``) and the port's both answer 413; the port answers
    from ``Content-Length`` alone, never reading the body nor reaching the
    app. At the cap it is read and parsed (400 here: not a ParseRequest)."""
    from tpu_voice_agent_torch.services import brain

    big = json.dumps({"text": "x" * (1024 * 1024), "context": {}}).encode()
    assert len(big) > brain.MAX_BODY_BYTES
    jb = sides["jax"].brain
    with AppServer(jb.build_app(jb.RuleBasedParser())) as jsrv:
        jstatus = _raw_post(jsrv.port, "/parse", {"Content-Length": len(big),
                                                  "Content-Type": "application/json"}, big)[0]
    app = brain.BrainApp(brain.RuleBasedParser())
    seen = []
    handle = app.handle
    monkeypatch.setattr(app, "handle", lambda req, peer_gone=None: (
        seen.append(req.path), handle(req, peer_gone))[1])
    srv = brain.make_server(app, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    try:
        status, body = _raw_post(port, "/parse", {"Content-Length": len(big)}, big)
        assert status == jstatus == 413
        assert body["error"] == "request_too_large" and body["limit_bytes"] == 1024 * 1024
        assert not seen  # refused before the app
        # a lying Content-Length is refused on its word: nothing is read
        assert _raw_post(port, "/parse", {"Content-Length": 300 * 1024 * 1024})[0] == 413
        # the handoff routes take up to 256 MiB and answer JAX's body past it
        status, body = _raw_post(port, "/admin/handoff",
                                 {"Content-Length": brain.HANDOFF_MAX_BYTES + 1})
        assert (status, body) == (413, {"error": "handoff_too_large",
                                        "limit_bytes": 268435456})
        assert _raw_post(port, "/admin/disagg/adopt",
                         {"Content-Length": brain.HANDOFF_MAX_BYTES + 1})[0] == 413
        # a chunked body with no length is refused, never read unbounded
        status, body = _raw_post(port, "/parse", {"Transfer-Encoding": "chunked"},
                                 b"5\r\nhello\r\n0\r\n\r\n")
        assert status == 411 and body["error"] == "length_required"
        assert not seen
        # under the cap the body reaches the app (and the rule parser answers)
        ok = json.dumps({"text": "go back", "context": {}}).encode()
        assert _raw_post(port, "/parse", {"Content-Length": len(ok)}, ok)[0] == 200
        assert seen == ["/parse"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def test_engine_stall_knob_is_served(monkeypatch):
    """``ENGINE_STALL_S`` (once refused) reaches the batched parser's
    watchdog; one that does not parse is refused at boot, naming it."""
    from tpu_voice_agent_torch.services import brain

    monkeypatch.setenv("ENGINE_STALL_S", "soon")
    with pytest.raises(ValueError, match="ENGINE_STALL_S"):
        brain.check_unserved_knobs()
    monkeypatch.setenv("ENGINE_STALL_S", "7.5")
    brain.check_unserved_knobs()
    seen = {}

    class Loop(brain.ServingLoop):
        def _watch(self, interval_s, stall_s):
            seen["stall_s"] = stall_s

    loop = Loop(_DeadableBatcher(), autostart=False)
    loop.start_watchdog()
    loop._watchdog.join(5)
    assert seen == {"stall_s": 7.5}
    fut: Future = loop.submit_call(lambda: 41 + 1)
    loop.step()
    assert fut.result(timeout=1) == 42
