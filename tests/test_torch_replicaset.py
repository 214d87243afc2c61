"""The port's replica-set core and fleet detector
(``tpu_voice_agent_torch/services/replicaset.py``) against the JAX package's,
on the CPU.

- ``rendezvous_weight`` equal on a table of member keys and session ids, so
  a JAX router and the port's place a session on the same home.
- JAX ``tests/test_fleet.py``'s detector cases: the MAD scores (direction,
  floors, min peers), ``signal_values`` / ``reduce_window``, the gray hold's
  expiry (on a stepped clock), each equal on both packages.
- Seeded sequences of placements, probes, drains, admits, membership changes
  and fleet windows through both ``ReplicaSet``s: the same states, scores,
  session homes and hook counts after every step.
- The gray drill through the port's router over JAX's stand-in members
  (sticky sessions stay, new ones avoid the gray member, the flight dump
  carries the evidence, symmetric recovery), and the same probe windows on
  the JAX router give the same verdicts; too few peers stay quiet; the
  clock-skew estimate and the flight fan-out; ``replica_degrade`` on one of
  three real port brains demoted through the router-observed ``fwd_ms``.
"""

import random

import pytest

from tests.http_helper import AppServer
from tests.test_fleet import _fake_member
from tests.torch_fleet_helper import (
    close_all,
    counters,
    delta,
    get,
    post,
    sid_homed_on,
)
from tpu_voice_agent.services import replicaset as jrs
from tpu_voice_agent.services.router import BrainRouter as JaxRouter
from tpu_voice_agent.services.router import build_app as jax_build_router
from tpu_voice_agent_torch.services import replicaset as prs
from tpu_voice_agent_torch.services.router import RouterThread
from tpu_voice_agent_torch.utils.tracing import get_flight_recorder

MODS = {"jax": jrs, "port": prs}


def test_fleet_signal_table_equals_jaxs():
    assert prs.FLEET_SIGNALS == jrs.FLEET_SIGNALS


def test_rendezvous_weight_table():
    keys = [f"http://127.0.0.1:{8090 + i}" for i in range(6)] + ["stt-0", "stt-1", "a", ""]
    sids = ["", "s", "sess-1", "60001", "ünïcode-☃", "x" * 300] + [f"hammer-{i}" for i in range(50)]
    table = [(k, s, prs.rendezvous_weight(k, s)) for k in keys for s in sids]
    assert table == [(k, s, jrs.rendezvous_weight(k, s)) for k in keys for s in sids]
    assert all(0 <= w < 1 << 64 for _, _, w in table)


def _readings(**parse_ms):
    return {m: {"parse_ms": v} for m, v in parse_ms.items()}


MAD_CASES = {
    "outlier-high": (_readings(a=10.0, b=11.0, c=10.5, d=300.0), "d", "high"),
    "fast-is-not-gray": (_readings(a=100.0, b=101.0, c=99.0, d=1.0), "d", "zero"),
    "tokens-low": ({m: {"tokens_per_forward": v}
                    for m, v in dict(a=4.0, b=4.2, c=3.9, d=1.0).items()}, "d", "high"),
    "faster-drafter": ({m: {"tokens_per_forward": v}
                        for m, v in dict(a=4.0, b=4.2, c=3.9, d=9.0).items()}, "d", "zero"),
    "floor": (_readings(a=1.000, b=1.001, c=1.002), None, "quiet"),
    "two-peers": (_readings(a=1.0, b=500.0), None, "empty"),
    "mixed": ({"a": {"parse_ms": 10.0, "kv_utilization": 0.5},
               "b": {"parse_ms": 12.0, "kv_utilization": 0.95},
               "c": {"parse_ms": 11.0, "kv_utilization": 0.5},
               "d": {"parse_ms": 10.5}}, "b", "high"),
}


@pytest.mark.parametrize("case", list(MAD_CASES))
def test_mad_outlier_scores_equal_jaxs(case):
    readings, member, expect = MAD_CASES[case]
    port = prs.fleet_outlier_scores(readings, min_peers=3)
    assert port == jrs.fleet_outlier_scores(readings, min_peers=3)
    scores, agg = port
    if expect == "high":
        assert scores[member]["score"] > 3
    elif expect == "zero":
        assert scores[member]["score"] == 0.0
    elif expect == "quiet":
        assert all(v["score"] < 1 for v in scores.values())
    else:
        assert agg == {} and all(v["score"] == 0.0 for v in scores.values())


def test_signal_values_and_reduce_window():
    sample = {"gauges": {"slo.brain.p99_ms": 42.0, "paged.kv_utilization": 0.5,
                         "scheduler.tokens_per_forward": 2.5, "quality.golden_accuracy": 1.0},
              "rates": {"scheduler.slots_quarantined": 0.25, "scheduler.prefill_faults": 0.0},
              "hist": {"brain.parse": {"ms_per": 12.5, "per_s": 3.0},
                       "engine.step.decode": {"ms_per": 4.0, "per_s": 9.0},
                       "router.forward": {"ms_per": 1.0, "per_s": 1.0}}}
    s2 = {"gauges": {}, "rates": {}, "hist": {"brain.parse": {"ms_per": 37.5, "per_s": 1.0}}}
    assert prs.signal_values(sample) == jrs.signal_values(sample)
    assert "fwd_ms" not in prs.signal_values(sample)  # observed, never sampled
    for window in ([sample, s2], [s2], []):
        assert prs.reduce_window(window) == jrs.reduce_window(window)
    assert prs.reduce_window([sample, s2])["parse_ms"] == pytest.approx(25.0)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t


def test_gray_hold_expiry_bounds_evidence_starvation(monkeypatch):
    """The same windows on both sets under one stepped clock: the verdict
    holds while evidence flows, arms the hold when it starves, and expires
    past ``gray_hold_s``."""
    clock = _Clock()
    for mod in MODS.values():
        monkeypatch.setattr(mod, "time", clock)
    slow = {"a": {"parse_ms": 300.0}, "b": {"parse_ms": 10.0}, "c": {"parse_ms": 10.0}}
    other = {k: {"kv_utilization": 0.1} for k in ("a", "b", "c")}
    steps = [slow, slow, slow, other, other, other, "tick", other]
    traces = {}
    for name, mod in MODS.items():
        clock.t = 1000.0
        rs = mod.ReplicaSet(["a", "b", "c"], gray_mad=4.0, gray_windows=2, gray_min_peers=3,
                            gray_hold_s=30.0)
        trace = []
        for st in steps:
            if st == "tick":
                clock.t += 31.0
                continue
            out = rs.apply_fleet_window(st)
            ra = rs.replicas[0]
            trace.append((ra.gray, ra.gray_held_since, ra.outlier_signal, out))
        traces[name] = trace
    assert traces["port"] == traces["jax"]
    gray = [t[0] for t in traces["port"]]
    assert gray == [False, True, True, True, True, True, False]
    assert traces["port"][5][1] is not None  # the hold armed before the expiry


class _Hooked:
    """Counts every hook of a ReplicaSet subclass."""

    HOOKS = ("_on_rehome", "_on_shed_pressure", "_on_shed_gray", "_on_gray_entered",
             "_on_gray_cleared", "_on_drain", "_on_drain_completed", "_on_member_added",
             "_on_member_removed", "_on_ejected", "_on_recovered")


def _hooked(mod):
    class Hooked(mod.ReplicaSet):
        def __init__(self, *a, **kw):
            self.calls: dict[str, int] = {}
            super().__init__(*a, **kw)

    def make(name):
        def hook(self, *a):
            self.calls[name] = self.calls.get(name, 0) + 1
        return hook

    for name in _Hooked.HOOKS:
        setattr(Hooked, name, make(name))
    return Hooked


def _run_sequence(mod, seed: int, clock) -> list:
    rng = random.Random(seed)
    rs = _hooked(mod)(["m0", "m1", "m2", "m3"], gray_mad=4.0, gray_windows=2, gray_min_peers=3,
                      shed_pressure=0.9, probe_fails_limit=2, max_sessions=16)
    trace = []
    n_added = 0
    for step in range(160):
        clock.t += 1.0
        op = rng.choice(["route", "route", "route", "probe", "probe", "drain", "admit",
                         "window", "window", "add", "remove", "pressure", "finish"])
        members = list(rs.replicas)
        r = rng.choice(members) if members else None
        if op == "route":
            sid = f"s{rng.randrange(24)}"
            home, moved = rs.route_ex(sid, exclude={r.url} if rng.random() < 0.1 else ())
            out = (home.url if home else None, moved)
        elif op == "probe" and r is not None:
            body = rng.choice([None, {}, {"draining": True}, {"role": "prefill"}, {"ok": True}])
            rs.apply_probe(r, rng.random() < 0.7, body)
            out = r.state
        elif op == "drain" and r is not None:
            out = rs.start_drain(r)
        elif op == "admit" and r is not None:
            rs.admit(r)
            out = r.state
        elif op == "window":
            readings = {}
            for m in members:
                if rng.random() < 0.8:
                    readings[m.url] = {"parse_ms": rng.choice([10.0, 11.0, 10.5, 400.0]),
                                       "kv_utilization": rng.choice([0.2, 0.3, 0.99])}
            out = rs.apply_fleet_window(readings)
        elif op == "add" and len(members) < 6:
            n_added += 1
            out = rs.add_member(f"n{n_added}", joining=rng.random() < 0.5).idx
        elif op == "remove" and len(members) > 2 and r is not None:
            out = rs.remove_member(r.url).idx
        elif op == "pressure" and r is not None:
            r.pressure = rng.choice([0.0, 0.5, 0.95])
            out = r.pressure
        elif op == "finish" and r is not None:
            r.inflight = 0
            rs._maybe_finish_drain(r)
            out = r.state
        else:
            out = None
        trace.append((step, op, out, [(x.url, x.state, x.gray, x.outlier_score, x.role,
                                       x.probe_fails, x.drain_latched) for x in rs.replicas],
                      dict(rs._sessions), dict(rs.calls), rs.health_counts()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_seeded_ring_sequences_equal_jaxs(monkeypatch, seed):
    clock = _Clock()
    for mod in MODS.values():
        monkeypatch.setattr(mod, "time", clock)
    clock.t = 0.0
    jax = _run_sequence(jrs, seed, clock)
    clock.t = 0.0
    port = _run_sequence(prs, seed, clock)
    for a, b in zip(port, jax):
        assert a == b
    assert len(port) == len(jax)


# ----------------------------------------------------- gray drill (stand-ins)


def _fleet(n: int, pkg: str = "port"):
    """n JAX stand-in members with a controllable parse wall, behind one
    router of ``pkg`` whose every probe window the test drives."""
    logs = [[] for _ in range(n)]
    controls = [{"parse_ms": 10.0} for _ in range(n)]
    servers = [AppServer(_fake_member(f"r{i}", logs[i], controls[i])).__enter__()
               for i in range(n)]
    kw = dict(fleet_windows=2, fleet_min_peers=3, probe_s=3600.0)
    if pkg == "port":
        router = RouterThread([s.url for s in servers], **kw)
    else:
        router = _JaxRing([s.url for s in servers], **kw)
    return router, servers, logs, controls


class _JaxRing:
    """The JAX router on its own loop, swept by hand like ``RouterThread``."""

    def __init__(self, urls, **kw):
        import asyncio

        self._asyncio = asyncio
        self.robj = JaxRouter(urls, **kw)
        self._srv = AppServer(jax_build_router(self.robj)).__enter__()
        self.url = self._srv.url

    def probe(self, n: int = 1):
        for _ in range(n):
            self._asyncio.run_coroutine_threadsafe(self.robj.probe_once(),
                                                   self._srv._loop).result(60)

    def close(self):
        self._srv.__exit__(None, None, None)


def _drill(pkg: str) -> list:
    """The gray drill's observable outcomes, one router of ``pkg``."""
    router, servers, logs, controls = _fleet(3, pkg)
    robj = router.robj
    obs = []
    try:
        sticky = sid_homed_on(robj, 0, "sticky")
        post(router.url + "/parse", {"text": "scroll down", "session_id": sticky, "context": {}})
        router.probe(2)
        obs.append(("healthy", get(router.url + "/health")[1]["replicas"]["gray"]))
        controls[0]["parse_ms"] = 300.0
        for w in range(3):
            router.probe()
            obs.append(("window", w, [(r.gray, r.outlier_signal, round(r.outlier_score, 3))
                                      for r in robj.replicas]))
        before = len(logs[0])
        post(router.url + "/parse", {"text": "go back", "session_id": sticky, "context": {}})
        obs.append(("sticky stays", len(logs[0]) == before + 1))
        fresh = [sid_homed_on(robj, 0, f"fresh{i}_") for i in range(4)]
        for sid in fresh:
            post(router.url + "/parse", {"text": "scroll down", "session_id": sid,
                                         "context": {}})
        obs.append(("fresh avoided", [any(e[1] == sid for e in logs[0]) for sid in fresh]))
        controls[0]["parse_ms"] = 10.0
        for w in range(3):
            router.probe()
            obs.append(("recovery", w, [r.gray for r in robj.replicas]))
    finally:
        router.close()
        close_all(*servers)
    return obs


def test_gray_enter_exit_drill():
    """The drill on the port's router: demoted within ``fleet_windows``
    windows, the dump frozen with the peer evidence, ``fleet.*`` counted;
    the JAX router under the same windows gives the same verdicts."""
    get_flight_recorder().rearm()
    c0 = counters()
    port = _drill("port")
    assert delta(c0, "fleet.gray_entered") == 1 and delta(c0, "fleet.gray_recovered") == 1
    assert delta(c0, "fleet.shed_gray") == 4
    dump = get_flight_recorder().state("router")
    assert dump["frozen"] and dump["reason"] == "fleet.gray"
    ev = dump["extra"]["fleet"]
    assert ev["signal"] == "parse_ms" and len(ev["peers"]) == 3 and ev["score"] >= 4.0
    assert ev["fleet_median"] < ev["value"]
    get_flight_recorder().rearm()
    assert port == _drill("jax")
    gray_windows = [o[2][0][0] for o in port if o[0] == "window"]
    assert gray_windows == [False, True, True]
    assert ("sticky stays", True) in port and ("fresh avoided", [False] * 4) in port
    assert [o[2][0] for o in port if o[0] == "recovery"] == [True, False, False]


def test_gray_needs_min_peers():
    router, servers, logs, controls = _fleet(2)
    try:
        controls[0]["parse_ms"] = 500.0
        router.probe(4)
        assert get(router.url + "/health")[1]["replicas"]["gray"] == 0
    finally:
        router.close()
        close_all(*servers)


def test_clock_skew_estimate_and_flight_fanout():
    router, servers, logs, controls = _fleet(3)
    try:
        controls[1]["now_skew_s"] = 5.0
        router.probe()
        detail = {d["url"]: d for d in get(router.url + "/health")[1]["replica_detail"]}
        assert abs(detail[servers[1].url]["clock_skew_s"] - 5.0) < 1.0
        assert abs(detail[servers[0].url]["clock_skew_s"]) < 1.0
        fan = get(router.url + "/debug/replicas/flightrecorder")[1]
        assert abs(fan["replicas"][servers[1].url]["clock_skew_s"] - 5.0) < 1.0
    finally:
        router.close()
        close_all(*servers)


def test_replica_degrade_e2e_through_real_port_brains(monkeypatch):
    """One of three real port brains latches slow (``replica_degrade@1``):
    the router-observed forward wall demotes it within the drill's windows,
    and the dump names ``fwd_ms`` over three peers."""
    import threading

    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.utils import chaos

    monkeypatch.setenv("CHAOS_SLOW_S", "0.3")
    monkeypatch.setenv("SLO_TARGET_P50_MS", "60000")  # only fleet.gray freezes
    monkeypatch.setenv("SLO_TARGET_P99_MS", "120000")
    get_flight_recorder().rearm()
    chaos.configure("replica_degrade@1", seed=3)
    apps, servers = [], []
    for _ in range(3):
        app = brain.BrainApp(brain.RuleBasedParser())
        srv = brain.make_server(app, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        apps.append(app)
        servers.append(srv)
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    router = RouterThread(urls, fleet_windows=2, fleet_min_peers=3)
    try:
        detected = False
        for i in range(12):
            for j in range(6):
                post(router.url + "/parse", {"text": "scroll down",
                                             "session_id": f"e2e{i}_{j}", "context": {}})
            router.probe()
            if get(router.url + "/health")[1]["replicas"]["gray"] == 1:
                detected = True
                break
        assert detected, "the degraded replica was never marked gray"
        h = get(router.url + "/health")[1]
        gray = [d["url"] for d in h["replica_detail"] if d["gray"]]
        dump = get(router.url + "/debug/flightrecorder")[1]
        assert dump["frozen"] and dump["reason"] == "fleet.gray"
        ev = dump["extra"]["fleet"]
        assert ev["replica"] == gray[0] and ev["signal"] == "fwd_ms" and len(ev["peers"]) == 3
        assert ev["value"] > ev["fleet_median"]
        slow = [a for a in apps if a._slow]
        assert len(slow) == 1
    finally:
        router.close()
        for srv, app in zip(servers, apps):
            srv.shutdown()
            srv.server_close()
            app.close()
        chaos.reset()
        get_flight_recorder().rearm()
