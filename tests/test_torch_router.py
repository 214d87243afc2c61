"""The port's replicated brain tier (``tpu_voice_agent_torch/services/router.py``)
against the JAX router's contract, on the CPU.

- JAX ``tests/test_router.py``'s cases, each on the port's router over the
  JAX tests' own stand-in replicas (``_fake_replica``: aiohttp apps that log
  every parse and die, slow down, shed or drain on command): affinity and
  spread, failover inside the budget, probe ejection and rejoin, the
  zero-drop drain, the fast-restart rejoin, the full outage's 503, hedging,
  the submit / eject / drain race, the warm and cold re-home, pressure
  shedding, the voice service's ``/health`` forward, and a speculative parse
  whose home dies through the port's voice WS. The prober sweeps when a test
  drives it (``RouterThread.probe``), so the tests wait on events and
  counters, not on the wall clock.
- JAX ``tests/test_disagg.py``'s router cases: the same pools, placements
  and estimates on both routers.
- The HTTP layer under the router: a caller that vanishes cancels the
  forward and the member's handler; raw bodies and chunked responses.
- The mixed ring: the port's router in front of one JAX brain and one port
  brain on the same test-tiny weights; a session drained off one re-homes
  warm onto the other and its next turn equals its stay-home turn, in both
  directions.
"""

import asyncio
import json
import threading
import time

import httpx
import pytest
import torch

from tests.http_helper import AppServer
from tests.test_router import _fake_replica
from tests.torch_fleet_helper import (
    close_all,
    counters,
    delta,
    get,
    post,
    sid_homed_on,
)
from tpu_voice_agent.services.router import BrainRouter as JaxRouter
from tpu_voice_agent_torch.services import ws
from tpu_voice_agent_torch.services.brain import RuleBasedParser
from tpu_voice_agent_torch.services.router import BrainRouter, RouterThread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(n: int, *, session_aware: bool = False, **router_kw):
    """n stand-in replicas (JAX's) behind the port's router."""
    logs = [[] for _ in range(n)]
    controls = [{} for _ in range(n)]
    servers = [AppServer(_fake_replica(f"r{i}", logs[i], session_aware=session_aware,
                                       controls=controls[i])).__enter__() for i in range(n)]
    router_kw.setdefault("probe_fails", 2)
    router_kw.setdefault("fleet_detect", False)
    return RouterThread([s.url for s in servers], **router_kw), servers, logs, controls


def _parse(router, sid, text="scroll down", **kw):
    return post(router.url + "/parse", {"text": text, "session_id": sid, "context": {}, **kw})


def _wait_for(pred, what: str, timeout_s: float = 30.0) -> None:
    """Poll an event that a running request produces (a stand-in's log
    entry): the bound is a hang guard, never the thing tested."""
    end = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < end, f"never happened: {what}"
        time.sleep(0.01)


# ----------------------------------------------------------- affinity


def test_session_affinity_and_spread():
    router, servers, logs, _ = _ring(3)
    try:
        for _ in range(4):
            assert _parse(router, "aff")[0] == 200
        assert len({e[0] for log in logs for e in log if e[1] == "aff"}) == 1
        for i in range(24):
            _parse(router, f"spread{i}", "go back")
        assert len({e[0] for log in logs for e in log}) == 3
    finally:
        router.close()
        close_all(*servers)


def test_homes_equal_the_jax_routers():
    """Both routers place the same sessions on the same members."""
    urls = [f"http://10.0.0.{i}:8090" for i in range(5)]
    port, jax = BrainRouter(urls, fleet_detect=False), JaxRouter(urls, fleet_detect=False)
    for i in range(200):
        assert port.route(f"s{i}").url == jax.route(f"s{i}").url


# ----------------------------------------------------------- failover


def test_failover_retries_in_flight_and_rehomes():
    router, servers, logs, controls = _ring(2)
    robj = router.robj
    try:
        sid = sid_homed_on(robj, 0, "fo")
        st, hdrs, _ = _parse(router, sid)
        assert hdrs["x-router-replica"] == robj.replicas[0].url
        c0 = counters()
        controls[0]["dead"] = True  # crash: every request drops abruptly
        st, hdrs, body = _parse(router, sid)
        assert st == 200 and hdrs["x-router-replica"] == robj.replicas[1].url
        assert body["intents"][0]["type"] == "scroll"
        assert delta(c0, "router.retries") == 1
        assert delta(c0, "router.sessions_rehomed") == 1
        st, hdrs, _ = _parse(router, sid, "go back")
        assert hdrs["x-router-replica"] == robj.replicas[1].url  # sticky on its new home
    finally:
        router.close()
        close_all(*servers)


def test_probe_ejects_dead_replica_and_recovery_rejoins():
    router, servers, logs, controls = _ring(2)
    robj = router.robj
    try:
        controls[0]["dead"] = True
        router.probe(2)  # probe_fails = 2
        assert robj.replicas[0].state == "down"
        st, h = get(router.url + "/health")
        assert h["replicas"] == {"total": 2, "healthy": 1, "draining": 0, "gray": 0}
        assert h["status"] == "degraded"
        controls[0]["dead"] = False
        router.probe()
        assert robj.replicas[0].state == "up"
        assert get(router.url + "/health")[1]["status"] == "ok"
    finally:
        router.close()
        close_all(*servers)


# -------------------------------------------------------------- drain


def test_drain_is_zero_drop():
    router, servers, logs, controls = _ring(2)
    robj = router.robj
    try:
        sid = sid_homed_on(robj, 0, "dr")
        _parse(router, sid, "go back")
        controls[0]["delay_s"] = 0.6  # the in-flight straggler
        results = {}
        n0 = len(logs[0])
        t = threading.Thread(target=lambda: results.update(straggler=_parse(router, sid)))
        t.start()
        _wait_for(lambda: len(logs[0]) > n0, "the straggler reached its home")
        st, _, ack = post(router.url + "/admin/drain", {"replica": robj.replicas[0].url})
        assert ack["state"] == "draining"  # in flight: not ejected yet
        for i in range(8):
            st, hdrs, _ = _parse(router, f"post-drain-{i}", "go back")
            assert hdrs["x-router-replica"] == robj.replicas[1].url
        t.join(timeout=30)
        st, hdrs, _ = results["straggler"]
        assert st == 200 and hdrs["x-router-replica"] == robj.replicas[0].url
        assert robj.replicas[0].state == "drained"  # the last forward's release
        st, hdrs, _ = _parse(router, sid, "go back")
        assert hdrs["x-router-replica"] == robj.replicas[1].url
        assert counters().get("router.drains", 0) >= 1
    finally:
        router.close()
        close_all(*servers)


def test_drained_replica_rejoins_after_fast_restart():
    router, servers, logs, controls = _ring(2)
    robj = router.robj
    try:
        post(router.url + "/admin/drain", {"replica": robj.replicas[0].url})
        assert robj.replicas[0].state == "drained"  # nothing in flight
        router.probe(3)  # the old process's latch: never rejoins
        assert robj.replicas[0].state == "drained" and robj.replicas[0].drain_latched
        c0 = counters()
        controls[0].pop("draining", None)  # the restart: a fresh process
        router.probe()
        assert robj.replicas[0].state == "up"
        assert delta(c0, "router.replicas_recovered") == 1
        sid = sid_homed_on(robj, 0, "rr")
        assert _parse(router, sid, "go back")[1]["x-router-replica"] == robj.replicas[0].url
    finally:
        router.close()
        close_all(*servers)


def test_full_outage_sheds_503_with_retry_after():
    router, servers, logs, controls = _ring(2, probe_fails=1)
    try:
        controls[0]["dead"] = controls[1]["dead"] = True
        router.probe()
        assert all(r.state == "down" for r in router.robj.replicas)
        st, hdrs, body = post(router.url + "/parse", {"text": "x", "session_id": "s",
                                                      "context": {}})
        assert st == 503 and hdrs.get("Retry-After") is not None
        assert body["error"] == "overloaded"
        assert get(router.url + "/health")[0] == 503
    finally:
        router.close()
        close_all(*servers)


# ------------------------------------------------------------- hedging


def test_hedged_parse_first_wins_and_counts():
    router, servers, logs, controls = _ring(2, hedge_ms=80)
    robj = router.robj
    try:
        sid = sid_homed_on(robj, 0, "he")
        controls[0]["delay_s"] = 1.0
        c0 = counters()
        st, hdrs, _ = _parse(router, sid, speculative=True)
        assert st == 200 and hdrs["x-router-replica"] == robj.replicas[1].url
        assert delta(c0, "router.hedges_fired") == 1 and delta(c0, "router.hedges_won") == 1
        # the hedge never re-homed the session
        controls[0]["delay_s"] = 0.0
        assert _parse(router, sid, "go back")[1]["x-router-replica"] == robj.replicas[0].url
    finally:
        router.close()
        close_all(*servers)


def test_hedge_error_answer_does_not_beat_running_primary():
    router, servers, logs, controls = _ring(2, hedge_ms=50)
    robj = router.robj
    try:
        sid = sid_homed_on(robj, 0, "hshed")
        controls[0]["delay_s"] = 0.4
        controls[1]["shed"] = True  # the alternative sheds at once
        c0 = counters()
        st, hdrs, body = _parse(router, sid, speculative=True)
        assert st == 200 and hdrs["x-router-replica"] == robj.replicas[0].url
        assert body["intents"][0]["type"] == "scroll"
        assert delta(c0, "router.hedges_fired") == 1 and delta(c0, "router.hedges_won") == 0
    finally:
        router.close()
        close_all(*servers)


# ---------------------------------------------------------- race hammer


def test_router_races_submit_vs_eject_and_drain():
    """Concurrent submits race a replica kill and a drain, each fired after
    a count of answered requests: every request answers 200, a nonce served
    twice was a failover off the killed or drained member, and no session
    placed after the drain's ack lands on the draining member."""
    router, servers, logs, controls = _ring(3, parse_timeout_s=15.0)
    robj = router.robj
    try:
        n_threads, per_thread = 6, 8
        barrier = threading.Barrier(n_threads + 1)
        errors, statuses = [], []
        lock = threading.Lock()
        drain_acked = threading.Event()
        answered = threading.Semaphore(0)

        def worker(t: int):
            try:
                barrier.wait(timeout=30)
                for i in range(per_thread):
                    nonce = f"{t}-{i}"
                    phase = "post" if drain_acked.is_set() else "pre"
                    st, _, _ = post(router.url + "/parse",
                                    {"text": "scroll down", "session_id": f"{phase}-hammer-{nonce}",
                                     "context": {"nonce": nonce}})
                    with lock:
                        statuses.append(st)
                    answered.release()
            except Exception as e:  # noqa: BLE001 - reported below
                with lock:
                    errors.append(e)

        def chaos_monkey():
            barrier.wait(timeout=30)
            for _ in range(6):
                answered.acquire(timeout=30)
            controls[0]["dead"] = True  # kill r0 mid-hammer
            for _ in range(6):
                answered.acquire(timeout=30)
            post(router.url + "/admin/drain", {"replica": robj.replicas[1].url})
            drain_acked.set()

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        monkey = threading.Thread(target=chaos_monkey)
        for th in threads + [monkey]:
            th.start()
        for th in threads + [monkey]:
            th.join(timeout=120)
            assert not th.is_alive(), "hammer worker hung"
        assert not errors, errors[0]
        assert len(statuses) == n_threads * per_thread and all(st == 200 for st in statuses)
        by_nonce: dict = {}
        for ri, log in enumerate(logs):
            for _name, _sid, _spec, nonce in log:
                by_nonce.setdefault(nonce, []).append(ri)
        suspect = {robj.replicas[0].url, robj.replicas[1].url}
        for nonce, where in by_nonce.items():
            assert len(where) <= 2, (nonce, where)
            if len(where) == 2:
                assert robj.replicas[where[0]].url in suspect and where[0] != where[1]
        assert not [e for e in logs[1] if (e[1] or "").startswith("post-hammer-")]
    finally:
        router.close()
        close_all(*servers)


# ------------------------------------------ warm-state handoff


def test_drain_rehome_ships_warm_state_and_counts_warm():
    router, servers, logs, controls = _ring(2, handoff_enable=True)
    robj = router.robj
    try:
        sid = sid_homed_on(robj, 0, "wh")
        _parse(router, sid, "go back")
        controls[0]["warm"] = {sid: b"warm-session-blob"}
        c0 = counters()
        post(router.url + "/admin/drain", {"replica": robj.replicas[0].url})
        assert robj.replicas[0].state == "drained"
        st, hdrs, _ = _parse(router, sid)
        assert st == 200 and hdrs["x-router-replica"] == robj.replicas[1].url
        assert controls[1].get("adopted") == [b"warm-session-blob"]  # crossed verbatim
        assert delta(c0, "router.sessions_rehomed_warm") == 1
    finally:
        router.close()
        close_all(*servers)


def test_framed_handoff_reassembles_on_the_way():
    """``HANDOFF_FRAMED=1``: the blob crosses as ``TVAF1`` frames, which
    the port's own framing reassembles into the same bytes."""
    from tpu_voice_agent_torch.serve import handoff

    import os
    os.environ["HANDOFF_FRAMED"] = "1"
    try:
        router, servers, logs, controls = _ring(2, handoff_enable=True)
    finally:
        os.environ.pop("HANDOFF_FRAMED", None)
    robj = router.robj
    try:
        sid = sid_homed_on(robj, 0, "fr")
        _parse(router, sid, "go back")
        controls[0]["warm"] = {sid: b"x" * 5000}
        post(router.url + "/admin/drain", {"replica": robj.replicas[0].url})
        _parse(router, sid)
        (shipped,) = controls[1]["adopted"]
        assert shipped.startswith(handoff.FRAME_MAGIC) and handoff.deframe(shipped) == b"x" * 5000
    finally:
        router.close()
        close_all(*servers)


def test_crash_rehome_counts_cold():
    router, servers, logs, controls = _ring(2, handoff_enable=True)
    robj = router.robj
    try:
        sid = sid_homed_on(robj, 0, "ch")
        _parse(router, sid, "go back")
        c0 = counters()
        controls[0]["dead"] = True
        st, hdrs, _ = _parse(router, sid)
        assert st == 200 and hdrs["x-router-replica"] == robj.replicas[1].url
        assert delta(c0, "router.sessions_rehomed_cold") == 1
        assert not controls[1].get("adopted")
    finally:
        router.close()
        close_all(*servers)


def test_handoff_disabled_counts_cold_and_ships_nothing():
    router, servers, logs, controls = _ring(2)
    robj = router.robj
    try:
        sid = sid_homed_on(robj, 0, "hd")
        _parse(router, sid, "go back")
        controls[0]["warm"] = {sid: b"blob"}
        c0 = counters()
        controls[0]["dead"] = True
        router.probe(2)
        assert robj.replicas[0].state == "down"
        _parse(router, sid)
        assert delta(c0, "router.sessions_rehomed_cold") == 1
        assert not controls[1].get("adopted")
    finally:
        router.close()
        close_all(*servers)


# --------------------------------------- gauge-driven shedding


def test_pressure_sheds_new_sessions_but_not_sticky_ones():
    router, servers, logs, controls = _ring(2, shed_pressure=0.9)
    robj = router.robj
    try:
        sticky = sid_homed_on(robj, 0, "ps")
        _parse(router, sticky, "go back")
        controls[0]["pressure"] = 0.97
        router.probe()
        assert robj.replicas[0].pressure >= 0.9
        c0 = counters()
        fresh = sid_homed_on(robj, 0, "ps-new")
        assert _parse(router, fresh)[1]["x-router-replica"] == robj.replicas[1].url
        assert delta(c0, "router.shed_pressure") == 1
        assert _parse(router, sticky, "go back")[1]["x-router-replica"] == robj.replicas[0].url
        controls[1]["pressure"] = 0.99
        router.probe()
        both = sid_homed_on(robj, 0, "ps-full")
        st, hdrs, _ = _parse(router, both, "go back")
        assert st == 200 and hdrs["x-router-replica"] == robj.replicas[0].url  # rendezvous
    finally:
        router.close()
        close_all(*servers)


def test_port_brain_health_carries_the_pressure_block():
    """The router's shed signal: the port brain's ``/health`` carries
    JAX's ``pressure`` block (score and fractions) for the same backend."""
    from tpu_voice_agent.services import brain as jbrain
    from tpu_voice_agent_torch.services import brain

    app = brain.BrainApp(RuleBasedParser())
    _, body, _ = app.health()
    with AppServer(jbrain.build_app(jbrain.RuleBasedParser())) as srv:
        jbody = httpx.get(srv.url + "/health", timeout=10).json()
    assert body["pressure"] == jbody["pressure"] == {"score": 0.0, "slo": "ok",
                                                     "admission": 0.0}


# ------------------------------------------- voice /health forwarding


def test_voice_health_forwards_router_replicas():
    from tpu_voice_agent_torch.serve.stt import NullSTT
    from tpu_voice_agent_torch.services.voice import VoiceConfig, build_app

    router, servers, logs, controls = _ring(2)
    voice = ws.ServerThread(build_app(VoiceConfig(
        brain_url=router.url, executor_url="http://127.0.0.1:1",
        stt_factory=lambda: NullSTT()))).__enter__()
    try:
        h = get(voice.url + "/health")[1]
        assert h["brain"]["replicas"] == {"total": 2, "healthy": 2, "draining": 0, "gray": 0}
    finally:
        voice.__exit__(None, None, None)
        router.close()
        close_all(*servers)


# ------------------------------------- a speculative parse's home dies


def test_replica_killed_during_speculative_parse_does_not_poison_final():
    """Through the port's voice WS: the home dies while the session's
    speculative parse is in flight; the final re-routes and delivers the
    cold parse's intent, with no error frame."""
    from tpu_voice_agent_torch.serve.stt import NullSTT
    from tpu_voice_agent_torch.services.voice import VoiceConfig, build_app

    router, servers, logs, controls = _ring(2, session_aware=True)
    for c in controls:
        c["delay_s"] = 0.5  # the spec parse is still in flight at the kill
    scripted = [("spec_final", "search for usb hubs"), ("final", "search for usb hubs")]
    voice = ws.ServerThread(build_app(VoiceConfig(
        brain_url=router.url, executor_url="http://127.0.0.1:1",
        stt_factory=lambda: NullSTT(scripted=list(scripted)),
        parse_timeout_s=10.0))).__enter__()
    pcm = b"\x00\x00" * 1600

    async def run():
        events = []
        c = await ws.connect(voice.url.replace("http", "ws") + "/stream")
        try:
            await c.send_bytes(pcm)  # -> spec_final -> a speculative parse
            end = time.monotonic() + 30
            victim = None
            while victim is None:
                assert time.monotonic() < end, "the speculation never fired"
                for i, log in enumerate(logs):
                    if any(spec for (_n, _s, spec, _x) in log):
                        victim = i
                        break
                await asyncio.sleep(0.01)
            controls[victim]["dead"] = True
            survivor = 1 - victim
            controls[survivor]["delay_s"] = 0.0
            await c.send_bytes(pcm)  # -> the final
            while True:
                msg = await c.receive(timeout=30)
                if msg.type != ws.TEXT:
                    break
                ev = msg.json()
                events.append(ev)
                if ev["type"] in ("intent", "error"):
                    break
        finally:
            await c.close()
        return events, survivor

    try:
        events, survivor = asyncio.run(run())
        assert "error" not in [e["type"] for e in events], events
        intent = next(e for e in events if e["type"] == "intent")
        assert intent["data"] == RuleBasedParser().parse("search for usb hubs", {})
        assert [e for e in logs[survivor] if not e[2]], "the survivor never served the final"
        assert not intent.get("degraded"), intent
    finally:
        voice.__exit__(None, None, None)
        router.close()
        close_all(*servers)


# ------------------------------------------------- disagg placement


def _both(urls, **kw):
    return BrainRouter(urls, **kw), JaxRouter(urls, **kw)


def test_role_tags_and_prefill_env_build_the_pools(monkeypatch):
    monkeypatch.setenv("ROUTER_PREFILL_REPLICAS", "http://pf2,http://pf2")
    port, jax = _both(["http://d0", "http://pf1#prefill", "http://d1#decode"], disagg=True)
    for r in (port, jax):
        assert {m.url: m.role for m in r.replicas} == {
            "http://d0": "both", "http://pf1": "prefill", "http://d1": "decode",
            "http://pf2": "prefill"}
        assert r.exclude_roles == {"prefill"}
        assert r._pick_prefill(exclude=set()).role == "prefill"
        assert r._pick_prefill(exclude={"http://pf1", "http://pf2"}) is None
    for i in range(40):
        home = port.route(f"sess-{i}")
        assert home.role != "prefill" and home.url == jax.route(f"sess-{i}").url


def test_all_prefill_ring_still_serves():
    port, jax = _both(["http://pf1#prefill", "http://pf2#prefill"], disagg=True)
    assert port.route("s").url == jax.route("s").url


def test_probe_role_refines_but_both_never_clears_a_tag():
    for r in _both(["http://a#prefill", "http://b"], disagg=True):
        a, b = r._by_url["http://a"], r._by_url["http://b"]
        r.apply_probe(a, True, {"status": "ok", "role": "both"})
        assert a.role == "prefill"
        r.apply_probe(b, True, {"status": "ok", "role": "decode"})
        assert b.role == "decode"
        r.apply_probe(b, True, {"status": "ok", "role": "prefill"})
        assert b.role == "prefill"


def test_uncached_estimate_cold_sticky_rehomed():
    port, jax = _both(["http://d0"], disagg=True)
    body = {"text": "w" * 400, "context": {}}
    hdrs = {"x-prompt-tokens": "600", "x-cached-tokens": "590"}
    out = []
    for r, resp in ((port, ws.HTTPResponse(200, ws.Headers(hdrs), b"")),
                    (jax, httpx.Response(200, headers=hdrs))):
        cold = r._uncached_estimate("s1", body)
        r._sessions["s1"] = "http://d0"
        r._note_session_tokens("s1", "http://d0", resp)
        sticky = r._uncached_estimate("s1", body)
        r._sessions["s1"] = "http://elsewhere"
        out.append((cold, sticky, r._uncached_estimate("s1", body)))
    assert out[0] == out[1]
    cold, sticky, rehomed = out[0]
    assert cold >= 100 and 10 <= sticky < cold + 20 and rehomed >= 600


def test_disagg_unset_is_byte_identical():
    import os
    assert os.environ.get("ROUTER_DISAGG") is None
    port, jax = _both(["http://d0", "http://d1"])
    assert port.disagg is False and port.exclude_roles == set() and port._session_tokens == {}
    assert [m.describe() for m in port.replicas] == [m.describe() for m in jax.replicas]
    assert port.disagg_stats() == jax.disagg_stats()


# ------------------------------------------------- the HTTP layer


def test_a_vanished_caller_cancels_the_forward():
    """A caller that closes its socket mid-parse cancels the router's
    handler, whose forward closes its own socket, which cancels the
    member's handler (an aiohttp member with handler cancellation on, as
    the JAX brain runs): the cancellation crosses both hops."""
    import socket

    from aiohttp import web

    from tpu_voice_agent.services import HANDLER_CANCELLATION

    started, cancelled = threading.Event(), threading.Event()

    async def parse(_req):
        started.set()
        try:
            await asyncio.sleep(60)
        except asyncio.CancelledError:
            cancelled.set()
            raise
        return web.json_response({})

    async def health(_req):
        return web.json_response({"ok": True})

    app = web.Application()
    app[HANDLER_CANCELLATION] = True
    app.router.add_post("/parse", parse)
    app.router.add_get("/health", health)
    member = AppServer(app).__enter__()
    router = RouterThread([member.url], fleet_detect=False)
    robj = router.robj
    try:
        port = int(router.url.rsplit(":", 1)[1])
        s = socket.create_connection(("127.0.0.1", port))
        data = json.dumps({"text": "scroll down", "session_id": "gone", "context": {}}).encode()
        s.sendall(b"POST /parse HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n%s" % (len(data), data))
        assert started.wait(30), "the parse never reached the member"
        assert robj.replicas[0].inflight == 1
        s.close()  # the caller vanishes
        assert cancelled.wait(30), "the member's handler was never cancelled"
        _wait_for(lambda: robj.replicas[0].inflight == 0, "the forward released its member")
        assert robj.replicas[0].breaker.state == "closed"
    finally:
        router.close()
        close_all(member)


def test_client_reads_raw_and_chunked_bodies():
    """``HTTPClient`` posts raw ``content`` bytes and reads a chunked
    answer whole or as a stream of chunks."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("x-ctype", self.headers["Content-Type"])
            self.end_headers()
            for part in (body[:3], body[3:]):
                self.wfile.write(b"%x\r\n%s\r\n" % (len(part), part))
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/x"

    async def run():
        c = ws.HTTPClient()
        r = await c.post(url, content=b"\x00\x01binary", timeout=10,
                         headers={"Content-Type": "application/octet-stream"})
        chunks = []
        async with c.stream("POST", url, content=b"abcdef", timeout=10) as s:
            async for chunk in s.aiter_bytes():
                chunks.append(chunk)
        return r, s.status_code, chunks

    try:
        r, status, chunks = asyncio.run(run())
    finally:
        srv.shutdown()
    assert r.status_code == 200 and r.content == b"\x00\x01binary"
    assert r.headers["x-ctype"] == "application/octet-stream"
    assert status == 200 and chunks == [b"abc", b"def"]


# ------------------------------------------------- the mixed ring

SID = "mixed-session"
TURNS = [("search for wireless headphones", {"page": "home"}),
         ("sort these by price", {"page": "results"})]
TURN3 = ("open the second result", {"page": "results"})


@pytest.fixture(scope="module")
def sides():
    from tests.torch_warm_helper import Side, jax_weights

    w = jax_weights()
    return {"jax": Side("jax", w), "port": Side("port", w)}


class _Brain:
    """A batched, session-aware brain of one package on an ephemeral port;
    every decode's (prompt, result) is logged."""

    def __init__(self, side):
        self.side = side
        self.parser = side.brain.BatchedEngineParser(side.engine(None), max_new_tokens=32,
                                                     session_aware=True)
        self.decodes = []
        inner = self.parser._decode

        def logged(prompt):
            res = inner(prompt)
            self.decodes.append((prompt, res))
            return res

        self.parser._decode = logged
        if side.name == "jax":
            self._srv = AppServer(side.brain.build_app(self.parser)).__enter__()
            self.url = self._srv.url
        else:
            self._srv = side.brain.make_server(side.brain.BrainApp(self.parser), port=0)
            self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
            self._thread.start()
            self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"

    def turn(self, text, ctx, sid=SID):
        """One session turn through the parser's own serving path."""
        tr = self.parser.transcripts
        prompt = tr.prompt_for(sid, text, ctx)
        r = self.parser._decode(prompt)
        assert r.error is None, r.error
        tr.record(sid, prompt, r.token_ids)
        return r

    def close(self):
        if self.side.name == "jax":
            self._srv.__exit__(None, None, None)
        else:
            self._srv.shutdown()
            self._srv.server_close()
            self._thread.join(timeout=30)
        self.parser.close()


@pytest.mark.parametrize("donor_pkg,recip_pkg", [("jax", "port"), ("port", "jax")],
                         ids=["jax-to-port", "port-to-jax"])
def test_mixed_ring_rehomes_warm_across_packages(sides, donor_pkg, recip_pkg):
    """Two turns on the session's home, a drain of the home through the
    router, then turn 3 through the router: the session re-homes warm
    (``router.sessions_rehomed_warm``) onto the other package's brain, and
    that turn's tokens and cached span equal a stay-home reference's."""
    stay_ref = _Brain(sides[donor_pkg])  # the same session, never moved
    donor, recip = _Brain(sides[donor_pkg]), _Brain(sides[recip_pkg])
    router = RouterThread([donor.url, recip.url], handoff_enable=True, fleet_detect=False)
    robj = router.robj
    try:
        for text, ctx in TURNS:
            stay_ref.turn(text, ctx)
            donor.turn(text, ctx)
        stay = stay_ref.turn(*TURN3)

        async def place():
            return robj.route_ex(SID)

        home, moved_from = router.on_loop(place())
        if home.url != donor.url:  # the rendezvous home is the recipient: pin it
            robj._sessions[SID] = donor.url
        c0 = counters()
        st, _, ack = post(router.url + "/admin/drain", {"replica": donor.url})
        assert st == 200 and ack["state"] == "drained"
        n0 = len(recip.decodes)
        st, hdrs, _ = post(router.url + "/parse", {"text": TURN3[0], "context": TURN3[1],
                                                   "session_id": SID})
        assert hdrs["x-router-replica"] == recip.url
        assert delta(c0, "router.sessions_rehomed_warm") == 1
        assert delta(c0, "router.sessions_rehomed_cold") == 0
        (prompt, moved), = recip.decodes[n0:]
        assert moved.token_ids == stay.token_ids
        assert moved.cached_tokens == stay.cached_tokens > len(recip.parser.engine.prefix_ids)
        assert st in (200, 422)  # random weights may run out of decode budget
    finally:
        router.close()
        for b in (stay_ref, donor, recip):
            b.close()


# ------------------------------------------------- disagg end to end


def test_disagg_admission_streams_a_long_prompt_into_the_decode_home(sides):
    """``ROUTER_DISAGG=1`` over two port brains, one tagged ``#prefill``: a
    long cold prompt is exported on the prefill member and pumped frame by
    frame into the decode home (``disagg.admissions``,
    ``disagg.frames_streamed``); the home's decode then equals a cold
    engine's and starts from the adopted span."""
    side = sides["port"]
    pf, dec = _Brain(side), _Brain(side)
    router = RouterThread([dec.url, pf.url + "#prefill"], disagg=True, fleet_detect=False,
                        disagg_min_tokens=64, disagg_stream_blocks=1)
    ctx = {"history": [f"step {i}: compared item number {i} against the shortlist"
                       for i in range(14)]}
    text = "search for wireless noise cancelling headphones and sort them by rating"
    try:
        c0 = counters()
        n0 = len(dec.decodes)
        st, hdrs, _ = post(router.url + "/parse", {"text": text, "context": ctx,
                                                   "session_id": "long"})
        assert hdrs["x-router-replica"] == dec.url
        assert delta(c0, "disagg.admissions") == 1 and delta(c0, "disagg.fallbacks") == 0
        assert delta(c0, "disagg.frames_streamed") >= 2
        assert delta(c0, "disagg.tokens_prewarmed") > 0
        (prompt, warm), = dec.decodes[n0:]
        cold = side.run(side.engine(None), [prompt])[0]
        assert warm.token_ids == cold.token_ids
        assert warm.cached_tokens > cold.cached_tokens
        h = get(router.url + "/health")[1]
        assert h["disagg"]["prefill"]["total"] == 1 and h["disagg"]["enabled"] is True
    finally:
        router.close()
        pf.close()
        dec.close()
