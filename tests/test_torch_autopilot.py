"""The port's fleet autopilot (``tpu_voice_agent_torch/services/autopilot.py``)
against the JAX package's, on the CPU.

JAX ``tests/test_autopilot.py``'s eleven cases on the port's controller and
router, over the JAX tests' own stand-in members and spawner (aiohttp apps
with a controllable ``brain.parse`` window, handoff pack and adopt): the
pre-warmed scale-up and the fresh state of an admitted member, respawn
hygiene, a joining member invisible to probes, the manual drain winning
the join race, the join-stall timeout, the ``replica_join_stall`` point on
the port's brain, starved signals holding, the cooldown block, the
zero-drop scale-down with its warm ship, the STT band, and the race hammer
(ticks, probes and phases driven by count on a stepped controller clock).
Beside them: the knob defaults equal JAX's, the same tick sequence gives
the same decisions on both controllers, and a scale-up and a scale-down
over in-process port brains on test-tiny weights (the chip phase's spawner)
pre-warm through the real handoff and drop no parse.
"""

import asyncio
import json
import threading
import time

import pytest
import torch

from tests.test_autopilot import _fake_member, _Spawner
from tests.torch_fleet_helper import (
    close_all,
    counters,
    delta,
    post,
    sid_homed_on,
)
from tpu_voice_agent_torch.services import autopilot as pap
from tpu_voice_agent_torch.services.autopilot import AutopilotController
from tpu_voice_agent_torch.services.router import RouterThread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(n: int, **router_kw):
    from tests.http_helper import AppServer

    logs = [[] for _ in range(n)]
    controls = [{"parse_ms": 10.0} for _ in range(n)]
    servers = [AppServer(_fake_member(f"r{i}", logs[i], controls[i])).__enter__()
               for i in range(n)]
    router_kw.setdefault("fleet_windows", 2)
    router_kw.setdefault("fleet_min_peers", 3)
    return RouterThread([s.url for s in servers], **router_kw), servers, logs, controls


def _mk_ap(router, spawner, **kw):
    for k, v in dict(min_replicas=1, max_replicas=3, interval_s=0.1, target_util=0.5,
                     up_windows=2, down_windows=3, cooldown_s=0.05, join_timeout_s=5.0,
                     forecast_lead_s=0.3).items():
        kw.setdefault(k, v)
    return AutopilotController(router.robj, spawner, **kw)


def _tick(router, ap) -> dict:
    return router.on_loop(ap.tick_once())


def _parse(router, sid, text="scroll down"):
    return post(router.url + "/parse", {"text": text, "session_id": sid, "context": {}})[0]


def test_knob_defaults_equal_jaxs():
    from tpu_voice_agent.utils.knobs import knob_float

    for name, raw in pap.KNOB_DEFAULTS.items():
        assert float(raw) == knob_float(name), name


# ------------------------------------------------------------ join pipeline


def test_scale_up_prewarms_then_admits_fresh():
    router, servers, logs, controls = _ring(1)
    spawner = _Spawner()
    try:
        controls[0]["pack_tokens"] = 9
        assert _parse(router, "warmsrc") == 200
        ap = _mk_ap(router, spawner)
        c0 = counters()
        controls[0]["parse_ms"] = 300.0  # busy 1.5 -> desired 3 of max 3
        _tick(router, ap)
        desc = _tick(router, ap)
        assert desc["brain"]["target"] == 2 and desc["brain"]["actual"] == 2, desc
        join = [d for d in ap.decisions if d["action"] == "join"]
        assert join[-1]["reason"] == "prewarmed" and join[-1]["adopted_tokens"] == 9
        assert delta(c0, "autopilot.scale_ups") == 1
        assert delta(c0, "autopilot.joins_prewarmed") == 1
        assert delta(c0, "autopilot.joins_cold") == 0
        new = next(r for r in router.robj.replicas if r.url in spawner.servers)
        assert new.state == "up" and not new.gray and new.pressure == 0.0
        assert new.gray_streak == 0
        # the router serves the controller's state
        from tests.torch_fleet_helper import get

        st, body = get(router.url + "/admin/autopilot")
        assert st == 200 and body["brain"]["target"] == 2 and body["enabled"] is True
    finally:
        router.close()
        close_all(*servers)
        spawner.close()


def test_respawn_and_admit_reset_gray_and_pressure():
    router, servers, logs, controls = _ring(3)
    robj = router.robj
    try:
        controls[0]["parse_ms"] = 300.0
        router.probe(3)
        assert robj.replicas[0].gray, "never went gray"
        victim = robj.replicas[0]
        victim.pressure = 0.8

        async def respawn():
            old_idx = victim.idx
            robj.start_drain(victim)
            robj.remove_member(victim.url)
            return old_idx, robj.add_member(victim.url, joining=True)

        old_idx, fresh = router.on_loop(respawn())
        assert fresh.idx != old_idx and not fresh.gray and fresh.pressure == 0.0
        assert fresh.outlier_score == 0.0 and fresh.signals == {}

        async def admit():
            fresh.pressure = 0.5
            fresh.gray_streak = 2
            robj.admit(fresh)

        router.on_loop(admit())
        assert fresh.state == "up" and fresh.pressure == 0.0 and fresh.gray_streak == 0
    finally:
        router.close()
        close_all(*servers)


def test_joining_member_is_probe_invisible():
    router, servers, logs, controls = _ring(1, probe_fails=2)
    robj = router.robj
    try:
        async def add_dead():
            return robj.add_member("http://127.0.0.1:9", joining=True)

        r = router.on_loop(add_dead())
        router.probe(4)  # every probe of it fails: it stays the controller's
        assert r.state == "joining" and robj._by_url.get(r.url) is r
        assert _parse(router, None) == 200 and logs[0]

        async def remove():
            robj.remove_member(r.url)

        router.on_loop(remove())
    finally:
        router.close()
        close_all(*servers)


def test_manual_drain_wins_join_race():
    router, servers, logs, controls = _ring(1)
    robj = router.robj
    spawner = _Spawner({"adopt_stall_s": 0.4, "pack_tokens": 5})
    try:
        assert _parse(router, "racewarm") == 200
        ap = _mk_ap(router, spawner, down_windows=100)
        c0 = counters()

        async def drive() -> str:
            ap.target = 2
            t = asyncio.ensure_future(ap.tick_once())
            while not any(r.state == "joining" for r in robj.replicas):
                await asyncio.sleep(0.005)
            j = next(r for r in robj.replicas if r.state == "joining")
            assert robj.start_drain(j)  # the operator's drain lands mid-pre-warm
            await t
            return j.url

        claimed = router.on_loop(drive())
        aborted = [d for d in ap.decisions if d["action"] == "join_aborted"]
        assert aborted[-1]["reason"] == "manual_drain" and aborted[-1]["replica"] == claimed
        assert delta(c0, "autopilot.joins_prewarmed") == delta(c0, "autopilot.joins_cold") == 0
        for _ in range(5):
            if _tick(router, ap)["brain"]["actual"] == 2 and claimed not in robj._by_url:
                break
        assert claimed not in robj._by_url and claimed in spawner.retired
        joins = [d for d in ap.decisions if d["action"] == "join"]
        assert joins and all(d["replica"] != claimed for d in joins)
    finally:
        router.close()
        close_all(*servers)
        spawner.close()


def test_join_stall_times_out_retires_and_retries():
    router, servers, logs, controls = _ring(1)
    robj = router.robj
    spawner = _Spawner({"adopt_stall_s": 3.0})
    try:
        controls[0]["pack_tokens"] = 6
        assert _parse(router, "stallwarm") == 200
        ap = _mk_ap(router, spawner, down_windows=100, join_timeout_s=0.4)
        c0 = counters()
        ap.target = 2
        desc = _tick(router, ap)
        assert delta(c0, "autopilot.join_timeouts") == 1
        assert delta(c0, "autopilot.joins_cold") == 0
        aborted = [d for d in ap.decisions if d["action"] == "join_aborted"]
        assert aborted[-1]["reason"] == "join_timeout"
        stuck = aborted[-1]["replica"]
        assert stuck not in robj._by_url and stuck in spawner.retired
        assert ap.target == 2 and desc["brain"]["actual"] == 1
        spawner.template["adopt_stall_s"] = 0.0
        assert _tick(router, ap)["brain"]["actual"] == 2
        joins = [d for d in ap.decisions if d["action"] == "join"]
        assert joins[-1]["reason"] == "prewarmed" and joins[-1]["adopted_tokens"] == 6
    finally:
        router.close()
        close_all(*servers)
        spawner.close()


def test_chaos_replica_join_stall_point_fires_in_brain(monkeypatch):
    """The port brain's ``POST /admin/handoff`` stalls ``CHAOS_HANG_S`` on
    the armed event, once, counted ``chaos.replica_join_stall``."""
    from tpu_voice_agent_torch.services import brain, ws
    from tpu_voice_agent_torch.utils import chaos

    monkeypatch.setenv("CHAOS_HANG_S", "0.4")
    chaos.configure("replica_join_stall@1", seed=7)
    try:
        app = brain.BrainApp(brain.RuleBasedParser())
        c0 = counters()
        req = ws.Request("POST", "/admin/handoff", "", ws.Headers(), b"{}")
        t0 = time.monotonic()
        app.handle(req)
        assert time.monotonic() - t0 >= 0.35
        assert delta(c0, "chaos.replica_join_stall") == 1
        app.handle(req)
        assert delta(c0, "chaos.replica_join_stall") == 1  # @1 fired once
    finally:
        chaos.reset()


# --------------------------------------------------------- band discipline


def test_starved_signals_hold_everything():
    router, servers, logs, controls = _ring(1)
    spawner = _Spawner()
    try:
        controls[0]["mute_ts"] = True
        controls[0]["parse_ms"] = 500.0
        ap = _mk_ap(router, spawner)
        c0 = counters()
        for _ in range(4):
            desc = _tick(router, ap)
        assert delta(c0, "autopilot.holds_starved") == 4
        assert desc["brain"]["target"] == 1 and spawner.spawns == 0
        holds = [d for d in ap.decisions if d["action"] == "hold"]
        assert holds[-1]["reason"] == "starved"
    finally:
        router.close()
        close_all(*servers)
        spawner.close()


def test_cooldown_block_is_counted_and_logged():
    router, servers, logs, controls = _ring(1)
    spawner = _Spawner()
    try:
        ap = _mk_ap(router, spawner, up_windows=1, cooldown_s=60.0)
        c0 = counters()
        controls[0]["parse_ms"] = 300.0
        _tick(router, ap)
        assert ap.target == 2
        desc = _tick(router, ap)
        assert ap.target == 2 and delta(c0, "autopilot.cooldown_blocks") >= 1
        holds = [d for d in ap.decisions if d["action"] == "hold" and d["reason"] == "cooldown"]
        assert holds[-1]["cooldown_remaining_s"] > 0
        assert desc["brain"]["cooldown_remaining_s"] > 50.0
    finally:
        router.close()
        close_all(*servers)
        spawner.close()


def test_scale_down_ships_warm_and_drops_nothing():
    router, servers, logs, controls = _ring(3)
    robj = router.robj
    spawner = _Spawner()
    try:
        sids = [sid_homed_on(robj, 0, "a"), sid_homed_on(robj, 0, "b"),
                sid_homed_on(robj, 1, "c"), sid_homed_on(robj, 1, "d"),
                sid_homed_on(robj, 2, "v")]
        for sid in sids:
            assert _parse(router, sid) == 200
        victim_sid, victim_url = sids[-1], robj.replicas[2].url
        ap = _mk_ap(router, spawner, min_replicas=2, max_replicas=3, down_windows=2)
        assert ap.target == 3
        c0 = counters()
        _tick(router, ap)
        _tick(router, ap)
        assert ap.target == 2 and delta(c0, "autopilot.scale_downs") == 1
        drains = [d for d in ap.decisions if d["action"] == "drain"]
        assert drains[-1]["replica"] == victim_url
        assert delta(c0, "autopilot.sessions_shipped") == 1
        new_home = robj._sessions[victim_sid]
        assert new_home != victim_url
        assert _parse(router, victim_sid, "go back") == 200
        served = next(i for i, s in enumerate(servers) if s.url == new_home)
        assert any(e[1] == victim_sid for e in logs[served])
        _tick(router, ap)  # the retirement tail: out at inflight == 0
        assert victim_url not in robj._by_url
        assert delta(c0, "autopilot.retired") == 1 and victim_url in spawner.retired
        assert sum(1 for r in robj.replicas if r.state == "up") == 2
    finally:
        router.close()
        close_all(*servers)
        spawner.close()


class _FakeSTT:
    def __init__(self):
        self.pressure = 0.0

    def servable(self):
        return True


class _FakeTier:
    def __init__(self, n):
        self.replicas = [_FakeSTT() for _ in range(n)]
        self.resizes: list[int] = []

    def resize(self, n):
        self.resizes.append(n)
        while len(self.replicas) < n:
            self.replicas.append(_FakeSTT())
        del self.replicas[n:]


def test_stt_tier_rides_the_band():
    router, servers, logs, controls = _ring(1)
    spawner = _Spawner()
    tier = _FakeTier(1)
    try:
        ap = _mk_ap(router, spawner, stt_tier=tier, up_windows=2, down_windows=2,
                    cooldown_s=0.0)
        for r in tier.replicas:
            r.pressure = 0.9
        _tick(router, ap)
        _tick(router, ap)
        assert ap.stt_target == 2 and tier.resizes == [2]
        ups = [d for d in ap.decisions if d["tier"] == "stt" and d["action"] == "scale_up"]
        assert ups[-1]["reason"] == "pressure"
        for r in tier.replicas:
            r.pressure = 0.05
        _tick(router, ap)
        _tick(router, ap)
        assert ap.stt_target == 1 and tier.resizes == [2, 1] and len(tier.replicas) == 1
    finally:
        router.close()
        close_all(*servers)
        spawner.close()


def test_same_ticks_give_the_same_decisions_on_both_controllers(monkeypatch):
    """One band sequence, driven by hand on each package's controller over
    its own router and stand-ins, both on one stepped clock: the same
    actions, reasons, targets and counts (the scale-up joins pre-warmed,
    the scale-down ships)."""
    from tests.http_helper import AppServer
    from tpu_voice_agent.services import autopilot as jap
    from tpu_voice_agent.services.autopilot import AutopilotController as JaxController
    from tpu_voice_agent.services.router import BrainRouter as JaxRouter
    from tpu_voice_agent.services.router import build_app as jax_build

    loads = [10.0, 300.0, 300.0, 300.0, 300.0, 10.0, 10.0, 10.0, 10.0, 10.0]
    kw = dict(min_replicas=1, max_replicas=3, interval_s=0.1, target_util=0.5, up_windows=2,
              down_windows=3, cooldown_s=0.0, join_timeout_s=5.0, forecast_lead_s=0.3)
    clock = _StepClock()
    monkeypatch.setattr(pap, "time", clock)
    monkeypatch.setattr(jap, "time", clock)
    out = {}
    for pkg in ("jax", "port"):
        clock.t = 1000.0
        logs, controls = [[]], [{"parse_ms": 10.0, "pack_tokens": 3}]
        seed = AppServer(_fake_member("r0", logs[0], controls[0])).__enter__()
        spawner = _Spawner({"pack_tokens": 3})
        if pkg == "port":
            router = RouterThread([seed.url], fleet_detect=False)
            robj, on_loop = router.robj, router.on_loop
            ap = AutopilotController(robj, spawner, **kw)
        else:
            robj = JaxRouter([seed.url], fleet_detect=False, probe_s=3600.0)
            router = AppServer(jax_build(robj)).__enter__()

            def on_loop(coro, _srv=router):
                return asyncio.run_coroutine_threadsafe(coro, _srv._loop).result(60)

            ap = JaxController(robj, spawner, **kw)
        try:
            on_loop(robj.forward_parse(json.dumps({"text": "scroll down", "session_id": "w",
                                                   "context": {}}).encode(),
                                       {"session_id": "w"}, {}))
            trace = []
            for load in loads:
                clock.t += 0.1
                controls[0]["parse_ms"] = load
                for c in spawner.controls.values():
                    c["parse_ms"] = load
                desc = on_loop(ap.tick_once())
                trace.append((desc["brain"]["target"], desc["brain"]["actual"],
                              desc["brain"]["joining"]))
            out[pkg] = (trace, [(d["tier"], d["action"], d["reason"], d["target"],
                                 d.get("adopted_tokens")) for d in ap.decisions])
        finally:
            router.close() if pkg == "port" else router.__exit__(None, None, None)
            seed.__exit__(None, None, None)
            spawner.close()
    assert out["port"] == out["jax"]
    actions = [a for _, a, *_ in out["port"][1]]
    assert "join" in actions and "drain" in actions and "retire" in actions


# ------------------------------------------------------------- race hammer


class _StepClock:
    """The controller's clocks (``time.monotonic`` for its cooldown,
    ``time.time`` for its decision stamps), advanced by the test a tick."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


def test_autopilot_race_hammer(monkeypatch):
    """Ticks at a fixed step on the controller's clock, racing live
    traffic, a manual drain, a gray demotion and a cold kill of a spawned
    member, each phase a count of ticks: every parse answers 200, committed
    scale actions are spaced by the cooldown, and the drained slot is never
    re-admitted."""
    clock = _StepClock()
    monkeypatch.setattr(pap, "time", clock)
    router, servers, logs, controls = _ring(3, probe_fails=2)
    robj = router.robj
    spawner = _Spawner({"pack_tokens": 4})
    ap = AutopilotController(robj, spawner, min_replicas=1, max_replicas=6, interval_s=0.1,
                             target_util=0.5, up_windows=2, down_windows=3, cooldown_s=0.6,
                             join_timeout_s=5.0, forecast_lead_s=0.3)
    statuses: list = []
    stop = threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            try:
                st = _parse(router, f"ham{i % 6}")
            except Exception as e:  # noqa: BLE001 - a transport loss is a lost turn
                st = f"exc:{type(e).__name__}"
            statuses.append(st)
            i += 1

    def ticks(n):
        for _ in range(n):
            clock.t += 0.1
            router.probe()
            _tick(router, ap)

    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        for c in controls:
            c["parse_ms"] = 400.0
        ticks(16)  # sustained load: the controller ramps
        victim = next(r for r in robj.replicas if r.state == "up")
        drained_url = victim.url
        st, _, body = post(router.url + "/admin/drain", {"replica": drained_url})
        assert st == 200 and body["ok"]
        seed_urls = [s.url for s in servers]
        gray_url = next(u for u in seed_urls if u != drained_url and u in robj._by_url
                        and robj._by_url[u].state == "up")
        controls[seed_urls.index(gray_url)]["parse_ms"] = 4000.0
        ticks(3)
        assert gray_url not in robj._by_url or robj._by_url[gray_url].gray
        for url, srv in list(spawner.servers.items()):  # a spawned member dies cold
            spawner.servers.pop(url)
            srv.__exit__(None, None, None)
            break
        ticks(8)
        for c in controls:
            c["parse_ms"] = 10.0
        for c in spawner.controls.values():
            c["parse_ms"] = 10.0
        ticks(20)  # the load collapses: the controller shrinks back
    finally:
        stop.set()
        th.join(30.0)
        router.close()
        close_all(*servers)
        spawner.close()
    assert statuses and all(st == 200 for st in statuses), \
        [st for st in statuses if st != 200][:5]
    acts = [d for d in ap.decisions if d["tier"] == "brain"]
    commits = [d for d in acts if d["action"] in ("scale_up", "scale_down")]
    assert any(d["action"] == "scale_up" for d in commits)
    assert any(d["action"] == "scale_down" for d in commits)
    assert any(d["action"] == "join" for d in acts)
    for a, b in zip(commits, commits[1:]):
        assert b["t"] - a["t"] >= 0.6 - 1e-6, (a, b)
    assert any(d["action"] == "hold" and d["reason"] == "cooldown" for d in acts)
    r = robj._by_url.get(drained_url)
    assert r is None or r.state in ("draining", "drained")
    assert all(d.get("replica") != drained_url for d in acts if d["action"] == "join")


# ------------------------------------------- over in-process port brains


class PortBrainSpawner:
    """The duck-typed spawner over in-process port brains: each spawn boots
    a batched paged radix brain on test-tiny weights (one shared weight
    tree) on its own port; ``retire`` stops it."""

    def __init__(self, weights):
        self.weights = weights
        self.brains: dict[str, tuple] = {}
        self.retired: list[str] = []
        self.leaked: dict[str, int] = {}  # blocks past the tree's at retire

    def boot(self) -> str:
        from tpu_voice_agent_torch import bridge
        from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
        from tpu_voice_agent_torch.services import brain

        eng = PagedDecodeEngine(preset="test-tiny", max_len=2048, batch_slots=2,
                                prefill_buckets=(128, 256, 512, 1024, 2048), device="cpu",
                                radix_enable=True, init_weights=False)
        eng.load_params(bridge.params_from_numpy(self.weights))
        brain.install_prompt_prefix(eng)
        parser = brain.BatchedEngineParser(eng, max_new_tokens=16, session_aware=True)
        app = brain.BrainApp(parser)
        srv = brain.make_server(app, port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        self.brains[url] = (srv, th, app, parser)
        return url

    async def spawn(self) -> str:
        return await asyncio.get_running_loop().run_in_executor(None, self.boot)

    def stop(self, url: str) -> None:
        srv, th, app, parser = self.brains.pop(url)
        eng = parser.engine
        self.leaked[url] = eng.allocator.blocks_in_use - eng.radix.nodes
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        app.close()
        parser.close()

    async def retire(self, url: str) -> None:
        self.retired.append(url)
        if url in self.brains:
            await asyncio.get_running_loop().run_in_executor(None, self.stop, url)

    def close(self) -> None:
        for url in list(self.brains):
            self.stop(url)


def test_scale_up_and_down_over_port_brains():
    """The chip phase's controller on the CPU: a scale-up spawns a port
    brain, pre-warms it through the real handoff (adopted tokens past the
    prefix) and admits it; a scale-down drains, ships and retires one with
    parses in flight, every one answered, the retired brain's blocks freed
    back to its prefix."""
    from tests.torch_warm_helper import jax_weights

    spawner = PortBrainSpawner(jax_weights())
    seed = spawner.boot()
    router = RouterThread([seed], fleet_detect=False)
    robj = router.robj
    # the band never commits on its own here (idle brains, 100 windows):
    # the test sets the target and the reconcile follows it
    ap = AutopilotController(robj, spawner, min_replicas=1, max_replicas=2, interval_s=0.1,
                             target_util=0.5, up_windows=100, down_windows=100, cooldown_s=0.0,
                             join_timeout_s=60.0, forecast_lead_s=0.3)
    try:
        # a session with warm state on the seed (random weights answer
        # /parse 422 and record no turn, so the turn is played on the
        # parser), placed on the seed in the router's table
        parser = spawner.brains[seed][3]
        prompt = parser.transcripts.prompt_for("w0", "scroll down", {})
        parser.transcripts.record("w0", prompt, parser._decode(prompt).token_ids)

        async def place():
            return robj.route_ex("w0")

        assert router.on_loop(place())[0].url == seed
        c0 = counters()
        ap.target = 2
        desc = _tick(router, ap)
        assert desc["brain"]["actual"] == 2 and delta(c0, "autopilot.joins_prewarmed") == 1
        join = [d for d in ap.decisions if d["action"] == "join"][-1]
        new_url = join["replica"]
        assert join["adopted_tokens"] > len(spawner.brains[seed][3].engine.prefix_ids)
        # scale down with parses in flight on every member
        results: list = []
        threads = [threading.Thread(target=lambda i=i: results.append(post(
            router.url + "/parse", {"text": "go back", "context": {}, "session_id": f"d{i}"})[0]))
            for i in range(6)]
        for t in threads:
            t.start()
        ap.target = 1
        _tick(router, ap)
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 6 and all(st in (200, 422) for st in results), results
        for _ in range(10):
            _tick(router, ap)
            if len(robj.replicas) == 1:
                break
        assert len(robj.replicas) == 1 and len(spawner.retired) == 1
        gone = spawner.retired[0]
        assert gone in (seed, new_url) and gone not in spawner.brains
        assert spawner.leaked[gone] == 0
    finally:
        router.close()
        spawner.close()
