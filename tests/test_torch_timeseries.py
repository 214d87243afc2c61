"""The port's time-series plane (``tpu_voice_agent_torch/utils/timeseries.py``)
against the JAX package's, on the CPU.

- JAX ``tests/test_fleet.py``'s ring cases on both rings fed the same
  sequence with the same clock: equal samples (bounds, monotonic seqs, the
  ``?since=`` cursor, counter rates with the reset clamp, histogram window
  means, the gauge-prefix filter, the tracer-local registry winning), and
  the ``TS_*`` knobs read alike.
- The thread hammer's twin: writers, readers and the sampler on threads,
  each a fixed count of iterations (no wall-clock bound).
- ``GET /debug/timeseries?since=`` on the port's brain, voice service and
  router, each against its ring.
- Two port brains in one process keep their ``brain.parse`` windows apart
  (the tracer-local registry), and a port brain's sample carries the same
  fleet signals as a JAX brain's after the same requests on the same
  test-tiny weights.
"""

import json
import threading

import pytest
import torch

from tests.torch_fleet_helper import get
from tpu_voice_agent.services.replicaset import signal_values as jax_signal_values
from tpu_voice_agent.utils import timeseries as jts
from tpu_voice_agent.utils import tracing as jt
from tpu_voice_agent_torch.services import brain, ws
from tpu_voice_agent_torch.services.replicaset import signal_values
from tpu_voice_agent_torch.services.router import RouterThread
from tpu_voice_agent_torch.utils import timeseries as pts
from tpu_voice_agent_torch.utils import tracing as pt

PKGS = {"jax": (jts, jt), "port": (pts, pt)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strip(state: dict) -> dict:
    return {k: v for k, v in state.items() if k != "now_s"}


def _both(scenario) -> dict:
    """Run ``scenario(ts_module, tracing_module)`` on both packages; the
    two results must be equal."""
    out = {name: scenario(ts, tr) for name, (ts, tr) in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_ring_bounds_and_since_contract():
    def scenario(ts, tr):
        clock = iter(float(i) for i in range(100))
        ring = ts.TimeSeriesRing("t", sources=(tr.Metrics(),), interval_s=60.0,
                                 max_samples=8, clock=lambda: next(clock))
        for _ in range(20):
            ring.sample_once()
        return (_strip(ring.state()), ring.since(18), ring.since(20), ring.since(0))

    state, s18, s20, s0 = _both(scenario)
    assert [s["seq"] for s in state["samples"]] == list(range(12, 20))
    assert state["next_seq"] == 20 and state["service"] == "t"
    assert [s["seq"] for s in s18] == [18, 19] and s20 == [] and len(s0) == 8


def test_rate_and_hist_derivation():
    def scenario(ts, tr):
        src = tr.Metrics()
        t = {"now": 100.0}
        ring = ts.TimeSeriesRing("t", sources=(src,), interval_s=60.0, max_samples=16,
                                 clock=lambda: t["now"])
        src.inc("c.total", 10.0)
        src.observe_ms("h.lat", 10.0)
        first = ring.sample_once()
        src.inc("c.total", 5.0)
        for ms in (10.0, 20.0, 30.0):
            src.observe_ms("h.lat", ms)
        src.set_gauge("g.x", 0.7)
        t["now"] = 102.0
        second = ring.sample_once()
        src2 = tr.Metrics()  # a restarted registry steps the counter back
        ring.sources = (src2,)
        src2.inc("c.total", 1.0)
        t["now"] = 103.0
        return first, second, ring.sample_once()

    first, s, s2 = _both(scenario)
    assert first["rates"] == {} and first["hist"] == {}
    assert s["dt_s"] == 2.0 and s["rates"]["c.total"] == pytest.approx(2.5)
    assert s["hist"]["h.lat"] == {"ms_per": 20.0, "per_s": 1.5}
    assert s["gauges"]["g.x"] == 0.7 and s2["rates"]["c.total"] == 0.0


def test_gauge_prefix_filter():
    def scenario(ts, tr):
        src = tr.Metrics()
        for name, v in (("keep.a", 1.0), ("keep.b", 2.0), ("drop.c", 3.0)):
            src.set_gauge(name, v)
        ring = ts.TimeSeriesRing("t", sources=(src,), interval_s=60.0, max_samples=4,
                                 gauge_prefixes=("keep.",), clock=lambda: 1.0)
        return ring.sample_once()

    assert set(_both(scenario)["gauges"]) == {"keep.a", "keep.b"}


def test_source_precedence_local_wins():
    def scenario(ts, tr):
        glob, local = tr.Metrics(), tr.Metrics()
        glob.set_gauge("x", 1.0)
        local.set_gauge("x", 2.0)
        glob.observe_ms("brain.parse", 100.0)
        local.observe_ms("brain.parse", 5.0)
        t = {"now": 0.0}
        ring = ts.TimeSeriesRing("t", sources=(glob, local), interval_s=60.0,
                                 clock=lambda: t["now"])
        ring.sample_once()
        glob.observe_ms("brain.parse", 100.0)
        local.observe_ms("brain.parse", 7.0)
        t["now"] = 1.0
        return ring.sample_once()

    s = _both(scenario)
    assert s["gauges"]["x"] == 2.0 and s["hist"]["brain.parse"]["ms_per"] == 7.0


@pytest.mark.parametrize("env,expect", [
    ({}, (0.5, 240, None)),
    ({"TS_INTERVAL_S": "0.05", "TS_SAMPLES": "7", "TS_GAUGES": "slo., paged."},
     (0.05, 7, ("slo.", "paged."))),
], ids=["defaults", "set"])
def test_knobs_read_alike(monkeypatch, env, expect):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _both(lambda ts, tr: (lambda r: (r.interval_s, r.max_samples, r.gauge_prefixes))(
        ts.TimeSeriesRing("t")))
    assert got == expect


def test_ring_thread_hammer():
    """4 metric writers, 2 ring readers and the sampler thread, each a
    fixed count of iterations: no exception, a bounded ring, strictly
    monotonic seqs."""
    src = pt.Metrics()
    ring = pts.TimeSeriesRing("t", sources=(src,), interval_s=0.001, max_samples=16)
    errors: list = []
    go = threading.Barrier(7)

    def writer(i: int) -> None:
        try:
            go.wait(timeout=30)
            for n in range(3000):
                src.inc(f"w{i}.count")
                src.set_gauge(f"w{i}.gauge", n)
                src.observe_ms(f"w{i}.lat", n % 50)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def reader() -> None:
        try:
            go.wait(timeout=30)
            for _ in range(500):
                st = ring.state(since=0)
                assert len(st["samples"]) <= 16
                seqs = [s["seq"] for s in st["samples"]]
                assert seqs == sorted(set(seqs))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def sampler() -> None:
        go.wait(timeout=30)
        for _ in range(200):
            ring.sample_once()

    ring.start()
    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    threads += [threading.Thread(target=reader) for _ in range(2)]
    threads += [threading.Thread(target=sampler)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    ring.stop()
    assert not errors, errors
    assert ring.state()["next_seq"] >= 201  # the start's sample, the sampler's 200


# ------------------------------------------------------------- over HTTP


def _brain_app():
    app = brain.BrainApp(brain.RuleBasedParser())
    srv = brain.make_server(app, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def close():
        srv.shutdown()
        srv.server_close()
        app.close()

    return f"http://127.0.0.1:{srv.server_address[1]}", app.ring, close


def _voice_app():
    from tpu_voice_agent_torch.serve.stt import NullSTT
    from tpu_voice_agent_torch.services.voice import VoiceConfig, build_app

    app = build_app(VoiceConfig(brain_url="http://127.0.0.1:1",
                                executor_url="http://127.0.0.1:1",
                                stt_factory=lambda: NullSTT()))
    srv = ws.ServerThread(app).__enter__()
    return srv.url, app.ring, lambda: srv.__exit__(None, None, None)


def _router_app():
    url, _ring, close_brain = _brain_app()
    router = RouterThread([url], fleet_detect=False)
    ring = router.srv.app.ring

    def close():
        router.close()
        close_brain()

    return router.url, ring, close


@pytest.mark.parametrize("make,service", [(_brain_app, "brain"), (_voice_app, "voice"),
                                          (_router_app, "router")])
def test_since_contract_over_http(monkeypatch, make, service):
    monkeypatch.setenv("TS_INTERVAL_S", "3600")  # samples only when the test takes them
    url, ring, close = make()
    try:
        ring.sample_once()
        st, body = get(url + "/debug/timeseries")
        assert st == 200 and body["service"] == service and body["samples"]
        assert isinstance(body["now_s"], float) and body["interval_s"] == 3600.0
        nxt = body["next_seq"]
        assert body["samples"][-1]["seq"] == nxt - 1
        assert get(url + f"/debug/timeseries?since={nxt}")[1]["samples"] == []
        ring.sample_once()
        later = get(url + f"/debug/timeseries?since={nxt}")[1]
        assert [s["seq"] for s in later["samples"]] == [nxt]
        assert "ts.samples_buffered" in later["samples"][0]["gauges"]
        assert get(url + "/debug/timeseries?since=x")[1]["next_seq"] == nxt + 1
    finally:
        close()


def test_two_brains_in_one_process_keep_their_parse_windows_apart():
    """The tracer-local registry wins: parses on one brain move only its
    own ring's ``brain.parse`` window, though both share the global one."""
    a, b = brain.BrainApp(brain.RuleBasedParser()), brain.BrainApp(brain.RuleBasedParser())
    for app in (a, b):
        app.ring.sample_once(now_s=0.0)
    for _ in range(3):
        st, _, _ = a.parse(b'{"text": "scroll down", "context": {}}')
        assert st == 200
    sa, sb = a.ring.sample_once(now_s=1.0), b.ring.sample_once(now_s=1.0)
    assert sa["hist"]["brain.parse"]["per_s"] == 3.0 and "parse_ms" in signal_values(sa)
    assert "brain.parse" not in sb["hist"] and "parse_ms" not in signal_values(sb)


def test_signal_keys_of_a_port_brain_equal_a_jax_brains(monkeypatch):
    """The same two session parses on a batched paged test-tiny brain of
    each package, each with fresh global registries: their samples carry
    the same fleet signals."""
    import httpx

    from tests.http_helper import AppServer
    from tests.torch_warm_helper import Side, jax_weights

    monkeypatch.setattr(jt, "_GLOBAL_METRICS", jt.Metrics())
    monkeypatch.setattr(pt, "_GLOBAL_METRICS", pt.Metrics())
    w = jax_weights()
    bodies = [{"text": "scroll down", "context": {}, "session_id": "ts-1"},
              {"text": "go back", "context": {}, "session_id": "ts-1"}]
    keys = {}
    for name in ("jax", "port"):
        side = Side(name, w)
        parser = side.brain.BatchedEngineParser(side.engine(None), max_new_tokens=32,
                                                session_aware=True)
        ts, tr = PKGS[name]
        tracer = tr.Tracer("brain", emit=False)
        ring = ts.TimeSeriesRing("brain", sources=(tr.get_metrics(), tracer.metrics))
        try:
            ring.sample_once(now_s=0.0)
            if name == "jax":
                with AppServer(side.brain.build_app(parser, tracer=tracer)) as srv:
                    for body in bodies:
                        httpx.post(srv.url + "/parse", json=body, timeout=120)
                    httpx.get(srv.url + "/health", timeout=30)
                sig = jax_signal_values(ring.sample_once(now_s=1.0))
            else:
                app = brain.BrainApp(parser, tracer=tracer)
                for body in bodies:
                    app.handle(ws.Request("POST", "/parse", "", ws.Headers(),
                                          json.dumps(body).encode()))
                app.health()
                sig = signal_values(ring.sample_once(now_s=1.0))
        finally:
            parser.close()
        keys[name] = sorted(sig)
    assert keys["port"] == keys["jax"]
    assert {"parse_ms", "decode_ms", "kv_utilization"} <= set(keys["port"])
