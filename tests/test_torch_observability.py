"""The port's metrics and trace plane, and its brain's routes, against the JAX
package's, on the CPU.

- The brain's route table: every route of the JAX brain's aiohttp app is
  served by the port's brain or answered 501 ``not_ported`` naming its
  ROADMAP.md Queue 1 item; only a path JAX does not route is 404.
- ``BRAIN_BACKEND=distilled`` booted from the environment by both brains,
  on the golden utterances: equal JSON, ``x-intent-margin`` in JAX's format
  and within ``ENGINE_TOL`` of JAX's, equal ``/debug/quality`` counts and
  means within ``ENGINE_TOL``; the port's ``/metrics`` (JSON and
  Prometheus), ``/debug/trace/<id>`` and ``/debug/quality`` bodies.
- The registry and the tracer against JAX's on one seeded sequence:
  ``prometheus_exposition`` byte-equal, the JSON snapshot, collisions, the
  span ring and the ``TRACE_SINK`` lines; the ``slo.*`` gauges, the
  ``QualityMonitor`` state and the ``resilience.<dep>.*`` series.
- Metric names held to the JAX catalog (``tools/metrics_lint.py``
  ``scan_source``): no collision, every port name a JAX name of the same
  kind, every JAX name ported or listed in ``NOT_PORTED_METRICS`` with the
  Queue 1 item that brings it.
- The refusals: other ``distilled:`` directories, ``planner-distilled``.
- The golden-replay canary (``QUALITY_CANARY_S``): rounds on the served
  brain's thread, and ``GoldenCanary.run_once`` against JAX's.
- The flight recorder against JAX's: buffering, freeze and re-arm, the
  freezes on a breaker trip and on SLO and quality violations, the sink,
  bounded rings under concurrent writers.
"""

import asyncio
import json
import sys
import threading
import time
from pathlib import Path

import httpx
import numpy as np
import pytest
import torch

from tests.http_helper import AppServer
from tpu_voice_agent.services import brain as jbrain
from tpu_voice_agent.utils import quality as jq
from tpu_voice_agent.utils import resilience as jres
from tpu_voice_agent.utils import slo as jslo
from tpu_voice_agent.utils import tracing as jt
from tpu_voice_agent_torch import distilled
from tpu_voice_agent_torch.evals.golden import GOLDEN_INTENT_CASES, score_case
from tpu_voice_agent_torch.services import brain, resilience, slo, ws
from tpu_voice_agent_torch.utils import quality as tq
from tpu_voice_agent_torch.utils import tracing as tt

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import metrics_lint  # noqa: E402

# The JAX metric names the port does not register yet, by name or by prefix
# (an entry covers every name that starts with it), with the
# ROADMAP.md Queue 1 item that brings them. This map is the observability
# work still to do.
NOT_PORTED_METRICS = {
    "quality.exec_success_rate": 9,  # record_exec, fed by the executor service
    "hbm.": 7, "xla.": 7,
    "planner.": 8,
    "executor.": 9,
}


# the engines' logits agree to their own tolerance, not bit for bit (the
# bf16 KV cache): a margin mean may move by ~1e-4 (tests/test_torch_quality.py)
ENGINE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unported_item(name: str) -> int | str | None:
    for key, item in NOT_PORTED_METRICS.items():
        if name.startswith(key.rstrip("*")):
            return item
    return None


# ---------------------------------------------------------------- routes


def _jax_brain_routes():
    app = jbrain.build_app(jbrain.RuleBasedParser())
    out = set()
    for r in app.router.routes():
        if r.method == "HEAD":
            continue
        info = r.resource.get_info()
        path = info.get("path") or info.get("formatter") or info.get("prefix")
        out.add((r.method, path.replace("{trace_id}", "abc123")
                 .replace("{session_id}", "s1")))
    return sorted(out)


@pytest.mark.parametrize("method,path", _jax_brain_routes())
def test_every_jax_brain_route_is_served_or_501(method, path):
    app = brain.BrainApp(brain.RuleBasedParser())
    status, body, _ = app.handle(ws.Request(method, path, "", ws.Headers(), b"{}"))
    # the warm-state routes answer a backend without the surface 404 with
    # JAX's typed body (tests/test_torch_handoff.py holds it to JAX's)
    assert status != 404 or body["error"] in ("handoff_unsupported", "disagg_unsupported"), (
        method, path, body)
    if status == 501:
        assert body["error"] == "not_ported"
        assert body["detail"].startswith("ROADMAP.md Queue 1 item "), body
    else:
        assert path in ("/health", "/parse", "/metrics", "/debug/quality", "/debug/steplog",
                        "/debug/flightrecorder", "/debug/costs", "/debug/timeseries",
                        "/admin/handoff",
                        "/admin/disagg/prefill", "/admin/disagg/adopt", "/admin/drain") \
            or path.startswith(("/debug/trace/", "/admin/handoff/")), (path, status)


def test_debug_costs_of_a_meterless_backend_equals_jax():
    """Once 501: the rule backend has no meter, and both brains say so in
    the same body."""
    app = brain.BrainApp(brain.RuleBasedParser())
    status, body, _ = app.handle(ws.Request("GET", "/debug/costs", "", ws.Headers(), b""))
    with AppServer(jbrain.build_app(jbrain.RuleBasedParser())) as srv:
        jbody = httpx.get(srv.url + "/debug/costs", timeout=10).json()
    assert status == 200 and body == jbody == {"service": "brain", "enabled": False}


def test_unrouted_paths_stay_404_and_wrong_methods_405():
    app = brain.BrainApp(brain.RuleBasedParser())
    for path in ("/nope", "/debug", "/debug/trace/", "/parse/x"):
        assert app.handle(ws.Request("GET", path, "", ws.Headers(), b""))[0] == 404, path
    assert app.handle(ws.Request("GET", "/parse", "", ws.Headers(), b""))[0] == 405
    assert app.handle(ws.Request("POST", "/metrics", "", ws.Headers(), b""))[0] == 405


# ---------------------------------------------------------------- distilled


@pytest.fixture(scope="module")
def distilled_brains():
    """Both brains booted from ``BRAIN_BACKEND=distilled``. The JAX parser
    is then switched onto its Pallas kernels (interpret mode), the path the
    golden recordings and the port's kernels follow: on the CPU it would
    pick XLA's cache attention, which flips a golden case (ROADMAP.md ground
    rules)."""
    with pytest.MonkeyPatch.context() as mp:
        for k in ("BRAIN_FF", "BRAIN_BATCH", "BRAIN_PREFIX", "KV_QUANT", "RADIX_ENABLE",
                  "BRAIN_PAGED", "BRAIN_QUANT", "BRAIN_MOE", "SPEC_ENABLE", "QUALITY_ENABLE",
                  "QUALITY_CANARY_S"):
            mp.delenv(k, raising=False)
        mp.setenv("BRAIN_BACKEND", "distilled")
        mp.setenv("BRAIN_DEVICE", "cpu")
        jparser = jbrain.make_parser_from_env()
        jparser.engine.kernels = "pallas"
        tparser = brain.make_parser_from_env()
    jsrv = AppServer(jbrain.build_app(jparser)).__enter__()
    server = brain.make_server(brain.BrainApp(tparser), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield {"jax": jsrv.url, "port": f"http://127.0.0.1:{server.server_address[1]}",
           "tparser": tparser}
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    jsrv.__exit__(None, None, None)


def test_distilled_backend_parses_equal_the_jax_brain(distilled_brains):
    recs = distilled.golden_records()[:6]
    margins = {"jax": [], "port": []}
    for rec in recs:
        bodies = {}
        for side in ("jax", "port"):
            r = httpx.post(distilled_brains[side] + "/parse", timeout=60,
                           json={"text": rec["text"], "context": rec["context"]},
                           headers={"x-trace-id": f"t{len(margins[side])}"})
            assert r.status_code == 200, (side, r.text)
            bodies[side] = r.json()
            margins[side].append(r.headers["x-intent-margin"])
        assert bodies["port"] == bodies["jax"] == rec["response"], rec["text"]
    # the header is str(round(margin_mean, 4)) on both sides; the engines'
    # logits agree to their own tolerance only (a bf16 KV cache), so a
    # margin may land one 4th-decimal step apart: held to ENGINE_TOL
    for p, j in zip(margins["port"], margins["jax"]):
        assert p == str(round(float(p), 4)) and abs(float(p) - float(j)) <= ENGINE_TOL, (p, j)
    q = {side: httpx.get(distilled_brains[side] + "/debug/quality", timeout=10).json()
         for side in ("jax", "port")}
    assert q["port"]["counts"] == q["jax"]["counts"] == {"quality.parses": len(recs)}
    assert set(q["port"]) == set(q["jax"]) and set(q["port"]["windows"]) == set(q["jax"]["windows"])
    for sig, w in q["jax"]["windows"].items():
        pw = q["port"]["windows"][sig]
        assert pw["n"] == w["n"] == len(recs) and abs(pw["mean"] - w["mean"]) <= ENGINE_TOL, sig


def test_brain_metrics_trace_and_health_bodies(distilled_brains):
    url = distilled_brains["port"]
    rec = distilled.golden_records()[0]
    r = httpx.post(url + "/parse", json={"text": rec["text"], "context": rec["context"]},
                   headers={"x-trace-id": "trace-one"}, timeout=60)
    assert r.status_code == 200
    spans = httpx.get(url + "/debug/trace/trace-one", timeout=10).json()
    assert spans["service"] == "brain" and spans["trace_id"] == "trace-one"
    (span,) = spans["spans"]
    assert span["span"] == "parse" and span["trace"] == "trace-one"
    for k in ("prefill_ms", "decode_ms", "cached_tokens", "prompt_tokens", "intent_margin",
              "intent_entropy", "intent_forced_frac"):
        assert k in span, k
    assert str(span["intent_margin"]) == r.headers["x-intent-margin"]
    m = httpx.get(url + "/metrics", timeout=10).json()
    assert set(m) == {"service", "local", "runtime", "slo"} and m["service"] == "brain"
    assert m["local"]["latency_ms"]["brain.parse"]["count"] >= 1
    assert m["runtime"]["counters"]["engine.requests"] >= 1
    assert m["slo"]["name"] == "brain"
    prom = httpx.get(url + "/metrics", headers={"Accept": "text/plain"}, timeout=10)
    assert prom.headers["content-type"].startswith("text/plain; version=0.0.4")
    assert "# TYPE brain_parse_ms histogram" in prom.text
    assert "# TYPE quality_intent_margin gauge" in prom.text
    h = httpx.get(url + "/health", timeout=10).json()
    assert h["quality"]["slo"] == "ok" and "intent_margin" in h["quality"]
    gauges = httpx.get(url + "/metrics?gauges=1", timeout=10).json()
    assert set(gauges) == {"service", "local", "runtime"}


@pytest.mark.parametrize("backend,match", [
    ("distilled:/models/other-ckpt", "item 8"),
    ("distilled:checkpoints/whisper-tiny-heldout", "item 8"),
    ("planner-distilled", "item 8"),
    ("pp:llama3-70b", "item 8"),
])
def test_backends_refused_at_boot(monkeypatch, backend, match):
    monkeypatch.setenv("BRAIN_BACKEND", backend)
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    with pytest.raises(ValueError, match=match):
        brain.make_parser_from_env()


def test_distilled_dir_named_like_the_checkpoint_boots(monkeypatch, caplog):
    monkeypatch.setenv("BRAIN_BACKEND", f"distilled:{ROOT / 'checkpoints' / distilled.INTENT_CKPT}/")
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    for k in ("BRAIN_PAGED", "BRAIN_QUANT", "BRAIN_MOE", "SPEC_ENABLE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BRAIN_FF", "8")
    monkeypatch.setenv("BRAIN_PAGED", "1")
    with caplog.at_level("WARNING", logger="tpu_voice_agent_torch.brain"):
        parser = brain.make_parser_from_env()
    eng = parser.engine
    assert (eng.fast_forward, eng.batch_slots, eng.max_len, eng.prefix_ids) == (0, 1, 512, [])
    warned = [r.getMessage() for r in caplog.records]
    assert "BRAIN_PAGED is not supported by the distilled backend; ignoring" in warned
    assert any(w.startswith("BRAIN_FF is ignored by the distilled backend") for w in warned)
    monkeypatch.setenv("SPEC_ENABLE", "1")
    monkeypatch.delenv("BRAIN_PAGED")
    assert brain.make_parser_from_env().engine.spec is not None  # SPEC_ENABLE passes through


def test_canary_refused_in_the_brain(monkeypatch):
    """Once refused: ``QUALITY_CANARY_S=0.5`` boots the brain with its
    golden-replay canary on, and the served brain runs rounds on its own
    thread, each scoring ``QUALITY_CANARY_SLICE`` cases into the golden
    window (the rule parser scores every case)."""
    monkeypatch.setenv("QUALITY_CANARY_S", "0.05")
    monkeypatch.setenv("QUALITY_CANARY_SLICE", "2")
    for k in ("BRAIN_BACKEND", "CHAOS_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    app = brain.BrainApp(brain.make_parser_from_env(), tracer=tt.Tracer("brain", emit=False))
    assert app.canary.enabled and (app.canary.interval_s, app.canary.slice_n) == (0.05, 2)
    srv = brain.make_server(app, port=0)  # starts the canary
    try:
        deadline = time.monotonic() + 30
        while app.canary.rounds < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        srv.server_close()
        app.close()
    assert app.canary.rounds >= 2
    q = app.qmon.state()
    assert q["counts"]["quality.canary_runs"] == app.canary.rounds
    n = 2 * app.canary.rounds
    assert q["windows"]["golden"]["n"] == n
    rule = brain.RuleBasedParser()
    scores = [score_case(c, rule.parse(c.text, dict(c.context)))
              for c in (GOLDEN_INTENT_CASES * 2)[:n]]
    assert q["windows"]["golden"]["mean"] == round(
        sum((0.5 if t else 0.0) + 0.5 * a for t, a in scores) / n, 4)


def test_golden_canary_rounds_equal_jax_on_the_rule_parser():
    """``GoldenCanary.run_once`` against JAX's on the rule parser: the same
    rotating slice, the same scores and window means, the same counts; a
    busy replica's round is skipped by both."""
    jmon = jq.QualityMonitor("brain", metrics=jt.Metrics(), window=16)
    tmon = tq.QualityMonitor("brain", metrics=tt.Metrics(), window=16)
    busy = {"on": False}
    jp, tp = jbrain.RuleBasedParser(), brain.RuleBasedParser()
    jc = jq.GoldenCanary(lambda t, c: jp.parse(t, c), jmon, interval_s=1.0, slice_n=4,
                         busy_fn=lambda: busy["on"])
    tc = tq.GoldenCanary(lambda t, c: tp.parse(t, c), tmon, interval_s=1.0, slice_n=4,
                         busy_fn=lambda: busy["on"])
    for i in range(5):
        busy["on"] = i == 2
        assert tc.run_once() == jc.run_once() == (0 if busy["on"] else 4)
        assert tmon.state()["windows"] == jmon.state()["windows"]
    assert (tc.rounds, tc._idx) == (jc.rounds, jc._idx) == (4, 16)
    assert tmon.state()["counts"] == jmon.state()["counts"]
    assert tmon.health() == jmon.health()
    assert tmon.metrics.snapshot() == jmon.metrics.snapshot()


# ---------------------------------------------------------------- registry


def _drive(m, rng):
    """One seeded sequence of registrations, the same on any registry."""
    names = ["engine.requests", "scheduler.chunks", "voice.spec_parse_hit", "9lives.x",
             "a-b.c"]
    for _ in range(60):
        k = rng.integers(0, 3)
        name = names[rng.integers(0, len(names))]
        if k == 0:
            m.inc(name + ".n", float(rng.integers(0, 4)))
        elif k == 1:
            m.set_gauge(name + ".g", float(rng.standard_normal()))
        else:
            m.observe_ms(name + ".h", float(rng.exponential(300.0)))
    m.inc("collide.x")
    m.set_gauge("collide.x", 2.0)


def test_prometheus_exposition_and_snapshot_equal_jax():
    jm, tm = jt.Metrics(), tt.Metrics()
    _drive(jm, np.random.default_rng(5))
    _drive(tm, np.random.default_rng(5))
    jm2, tm2 = jt.Metrics(), tt.Metrics()
    jm2.inc("engine.requests.n", 100.0)  # the first registry wins
    tm2.inc("engine.requests.n", 100.0)
    assert tt.prometheus_exposition(tm, tm2) == jt.prometheus_exposition(jm, jm2)
    assert tm.snapshot() == jm.snapshot()
    assert tm.collisions() == jm.collisions() == [("collide.x", "counter", "gauge")]
    assert tm.gauges() == jm.gauges()
    assert tt.prom_name("9a.b-c") == jt.prom_name("9a.b-c")


def test_tracer_ring_sink_and_stage_notes_match_jax(tmp_path):
    js = tmp_path / "jax.jsonl"
    ts = tmp_path / "port.jsonl"
    jtr = jt.Tracer("svc", emit=False, sink_path=str(js))
    ttr = tt.Tracer("svc", emit=False, sink_path=str(ts))
    for tr in (jtr, ttr):
        with tr.span("parse", trace_id="abc", chars=3, ignored=[1]) as sp:
            sp.attrs["note"] = 1.5
        tr.record_span("stt_finalize", "abc", 1.0, 1.25, chars=4)
        with pytest.raises(ValueError, match="bad span name"):
            with tr.span("a b"):
                pass
    strip = ("ms", "wall_start_s", "wall_end_s")

    def clean(spans):
        return [{k: v for k, v in s.items() if k not in strip} for s in spans]

    assert clean(ttr.spans_for("abc")) == clean(jtr.spans_for("abc"))
    assert [s["ms"] for s in ttr.spans_for("abc")][1] == 250.0
    assert clean(json.loads(x) for x in ts.read_text().splitlines()) == \
        clean(json.loads(x) for x in js.read_text().splitlines())
    assert set(ttr.metrics.snapshot()["latency_ms"]) == {"svc.parse", "svc.stt_finalize"}

    def notes(mod, out):
        mod.pop_stage_notes()
        mod.note_stage("prefill_ms", 1.0)
        out.append(mod.peek_stage_notes())
        out.append(mod.pop_stage_notes())
        out.append(mod.pop_stage_notes())

    seen = []
    t = threading.Thread(target=notes, args=(tt, seen))
    t.start()
    t.join()
    tt.note_stage("other_thread", 2.0)  # never reaches the thread above
    assert seen == [{"prefill_ms": 1.0}, {"prefill_ms": 1.0}, {}]
    assert tt.pop_stage_notes() == {"other_thread": 2.0}


def test_slo_gauges_equal_jax():
    clock = {"t": 100.0}

    def now():
        return clock["t"]

    jtrk = jslo.SLOTracker("obs_test", clock=now, min_samples=2)
    ttrk = slo.SLOTracker("obs_test", clock=now, min_samples=2)
    for i, ms in enumerate([100.0, 900.0, 3500.0, 200.0, 5000.0]):
        clock["t"] += 0.5
        jtrk.record(ms, ok=i != 3)
        ttrk.record(ms, ok=i != 3)
    assert ttrk.evaluate() == jtrk.evaluate()

    def series(m):
        return {k: v for k, v in m.gauges().items() if k.startswith("slo.obs_test.")}

    assert series(tt.get_metrics()) == series(jt.get_metrics())
    assert set(series(tt.get_metrics())) == {f"slo.obs_test.{k}" for k in (
        "state", "window_samples", "error_rate", "p50_ms", "p99_ms")}


def test_quality_monitor_state_equals_jax(monkeypatch):
    monkeypatch.setenv("QUALITY_SLO_MARGIN_MIN", "2.0")
    jmon = jq.QualityMonitor("brain", metrics=jt.Metrics(), window=4)
    tmon = tq.QualityMonitor("brain", metrics=tt.Metrics(), window=4)
    rng = np.random.default_rng(9)
    for mon in (jmon, tmon):
        r = np.random.default_rng(9)
        for i in range(9):
            mon.record_stt(float(-r.random()), float(-2 * r.random()), float(r.random()),
                           text="x" * 70, logp_first=None if i % 3 else float(-r.random()))
            mon.record_intent(margin=float(r.random() * 3), entropy=float(r.random()),
                              forced_frac=float(r.random()), degraded=i % 4 == 0,
                              rule_fallback=i % 5 == 0, text="go")
    del rng
    assert tmon.state() == jmon.state()
    assert tmon.health() == jmon.health()
    assert tmon.metrics.snapshot() == jmon.metrics.snapshot()


def test_breaker_and_retry_series_equal_jax():
    clock = {"t": 0.0}

    def now():
        return clock["t"]

    jb = jres.CircuitBreaker("obsdep", failure_threshold=2, reset_after_s=1.0, clock=now)
    tb = resilience.CircuitBreaker("obsdep", failure_threshold=2, reset_after_s=1.0, clock=now)

    def series(m):
        snap = m.snapshot()
        return ({k: v for k, v in snap["counters"].items() if ".obsdep." in k},
                {k: v for k, v in snap["gauges"].items() if ".obsdep." in k})

    assert series(tt.get_metrics()) == series(jt.get_metrics()) == (
        {}, {"resilience.obsdep.breaker_state": 0.0})  # registered at construction
    for step in ("fail", "fail", "allow", "tick", "allow", "fail", "tick", "allow", "ok"):
        for b in (jb, tb):
            if step == "fail":
                b.record_failure()
            elif step == "ok":
                b.record_success()
            elif step == "allow":
                b.allow()
        if step == "tick":
            clock["t"] += 1.5
        assert series(tt.get_metrics()) == series(jt.get_metrics()), step

    class Flaky:
        def __init__(self, exc):
            self.calls, self.exc = 0, exc

        async def post(self, *a, **kw):
            self.calls += 1
            raise self.exc("refused")

    async def run(mod, exc):
        with pytest.raises(exc):
            await mod.post_with_resilience(
                Flaky(exc), "http://x/parse", json_body={}, deadline=mod.Deadline(30.0),
                policy=mod.RetryPolicy(max_attempts=3), sleep=lambda s: asyncio.sleep(0),
                breaker=mod.CircuitBreaker("obsretry", failure_threshold=99))

    asyncio.run(run(jres, httpx.ConnectError))
    asyncio.run(run(resilience, ws.ConnectError))
    key = ("resilience.obsretry.retries", "resilience.obsretry.transport_errors")
    tc, jc = tt.get_metrics().snapshot()["counters"], jt.get_metrics().snapshot()["counters"]
    assert [tc[k] for k in key] == [jc[k] for k in key] == [2.0, 3.0]


# ---------------------------------------------------------------- catalog


@pytest.fixture(scope="module")
def catalogs():
    return (metrics_lint.scan_source(ROOT / "tpu_voice_agent"),
            metrics_lint.scan_source(ROOT / "tpu_voice_agent_torch"))


def test_port_metric_names_are_jax_names_of_the_same_kind(catalogs):
    jax_reg, port_reg = catalogs
    assert port_reg, "the scan found no registration in the port"
    for name, kinds in port_reg.items():
        assert len(kinds) == 1, f"collision: {name} registered as {sorted(kinds)}"
        assert name in jax_reg, f"{name} is no JAX metric"
        assert set(kinds) == set(jax_reg[name]), (name, kinds, jax_reg[name])


def test_every_jax_metric_is_ported_or_listed_with_its_item(catalogs):
    jax_reg, port_reg = catalogs
    missing = sorted(n for n in jax_reg if n not in port_reg and _unported_item(n) is None)
    assert not missing, f"JAX metrics neither ported nor in NOT_PORTED_METRICS: {missing}"
    # no stale entry: each key still covers a JAX name the port lacks
    for key in NOT_PORTED_METRICS:
        covered = [n for n in jax_reg if n not in port_reg and n.startswith(key.rstrip("*"))]
        assert covered, f"NOT_PORTED_METRICS[{key!r}] covers nothing"
    # the names this slice ports
    for name in ("engine.requests", "paged.kv_bytes_per_block", "radix.hit_rate",
                 "scheduler.ttft", "spec.trace_records", "stt.confidence_mean",
                 "stt.feed_lag_s", "voice.live_sessions", "slo.*.p50_ms",
                 "resilience.*.breaker_state", "quality.intent_margin", "*.shed_*",
                 # the containment slice
                 "chaos.*", "flight.freezes", "engine.step.*", "engine.step.wall",
                 "prefill.chunks", "scheduler.cancelled", "scheduler.shed_expired",
                 "scheduler.quarantine_rejected", "resilience.*.inflight",
                 "resilience.*.shed_overload", "brain.parses_cancelled",
                 "quality.golden_accuracy", "quality.intent_downgrades",
                 "voice.frames_dropped_chaos",
                 # the cost meter, tenancy, the loop's STT lane, batched STT
                 "engine.mfu", "engine.mbu", "engine.mfu_prefill", "cost.decode_flops",
                 "cost.stt_encoder_flops", "tenant.throttled", "tenant.preemptions",
                 "tenant.active_slots.*", "colocate.stt_queue", "colocate.parse_inflight",
                 "stt.batch_ticks", "stt.batch_occupancy", "stt.partials_coalesced",
                 "stt.shed_overload", "stt.queue_depth", "stt.finals_batched",
                 "stt.item_faults",
                 # the brain's warm state: handoff, the disagg stream, feeds,
                 # drain and the watchdog
                 "handoff.sessions_exported", "handoff.sessions_adopted",
                 "handoff.adopt_fallbacks", "handoff.tokens_adopted", "disagg.exports",
                 "disagg.exports_shed", "disagg.blocks_streamed", "disagg.segments_adopted",
                 "disagg.streams_aborted", "prefill.feeds", "prefill.feeds_committed",
                 "prefill.feeds_shed", "engine.restarts", "colocate.drains_started",
                 "colocate.worker_restarts", "brain.drains_received"):
        assert name in port_reg, name


# ---------------------------------------------------------------- flight recorder


def _flight_dump_shape(d):
    """The dump without its timestamps and gauge values (those differ run
    to run and registry to registry)."""
    return {"reason": d["reason"], "detail": d["detail"], "frozen": d["frozen"],
            "traces": d["traces"], "config": d["config"],
            "n_snapshots": len(d["metric_snapshots"]), "keys": sorted(d)}


def test_flight_recorder_buffers_freezes_and_rearms_as_jax():
    recs = [mod.FlightRecorder(max_traces=4, max_snapshots=8, snapshot_interval_s=999)
            for mod in (jt, tt)]
    for rec in recs:
        for i in range(10):  # 10 traces through a 4-trace ring
            rec.observe_span({"svc": "t", "span": "s", "trace": f"tr{i}", "ms": 1.0,
                              "wall_start_s": float(i), "wall_end_s": float(i) + 0.1})
    jrec, trec = recs
    assert trec.state("svc") == jrec.state("svc") == {
        "frozen": False, "armed": True, "traces_buffered": 4, "snapshots_buffered": 1,
        "service": "svc"}
    assert trec.trigger("slo.test.violated", detail="p50 blown") is True
    assert jrec.trigger("slo.test.violated", detail="p50 blown") is True
    td, jd = trec.frozen_dump(), jrec.frozen_dump()
    assert _flight_dump_shape(td) == _flight_dump_shape(jd)
    assert [t["trace_id"] for t in td["traces"]] == ["tr6", "tr7", "tr8", "tr9"]
    # JAX's dump carries its cost meter's summary; the port has none
    assert td["costs"] is None and set(td["steplog"]) == set(jd["steplog"])
    # the first freeze wins; the dump is immutable under later spans and triggers
    assert trec.trigger("breaker.x.open") is False
    trec.observe_span({"svc": "t", "span": "s", "trace": "later", "ms": 1.0})
    assert trec.frozen_dump()["reason"] == "slo.test.violated"
    assert len(trec.frozen_dump()["traces"]) == 4
    trec.rearm()
    assert trec.state()["frozen"] is False
    assert trec.trigger("second.incident") is True


def test_flight_freeze_carries_the_step_ring():
    from tpu_voice_agent_torch.utils.steplog import get_steplog

    log = get_steplog()
    log.clear()
    log.timer().finish(occupancy=1, tokens=3)
    rec = tt.FlightRecorder(max_traces=4)
    assert rec.trigger("test.freeze", detail="steplog ride-along")
    steps = rec.frozen_dump()["steplog"]["steps"]
    assert steps and steps[-1]["tokens"] == 3
    log.clear()


def test_breaker_trip_and_slo_edges_freeze_the_global_recorder():
    """A breaker opening, an SLO's ok -> violated edge and a quality
    tracker's freeze the process-global recorder under JAX's reasons; a
    passive tracker scores without freezing or exporting."""
    rec = tt.get_flight_recorder()
    clock = {"t": 0.0}
    try:
        rec.rearm()
        resilience.CircuitBreaker("flighttestdep", failure_threshold=1,
                                  reset_after_s=60.0).record_failure()
        assert rec.frozen_dump()["reason"] == "breaker.flighttestdep.open"
        rec.rearm()
        s = slo.SLOTracker("flightslo", window_s=60.0, target_p50_ms=1.0, min_samples=2,
                           clock=lambda: clock["t"])
        for _ in range(5):
            s.record(100.0)
        assert s.state() == "violated"
        dump = rec.frozen_dump()
        assert dump["reason"] == "slo.flightslo.violated" and "p50_ms" in dump["detail"]
        rec.rearm()
        s.evaluate()  # still violated: no new edge, no new freeze
        assert rec.frozen_dump() is None
        q = slo.QualityTracker("qflight", floors={"golden_accuracy": 0.7}, min_samples=2,
                               metrics=tt.Metrics())
        for _ in range(3):
            q.record("golden_accuracy", 0.25, {"text": "x"})
        assert q.evaluate()["state"] == "violated"
        dump = rec.frozen_dump()
        assert dump["reason"] == "slo.qflight.violated"
        assert dump["extra"]["quality"]["golden_accuracy"]["recent"][0]["text"] == "x"
        rec.rearm()
        p = slo.SLOTracker("passiveprobe", window_s=60.0, target_p50_ms=1.0, min_samples=2,
                           passive=True)
        for _ in range(5):
            p.record(100.0)
        assert p.state() == "violated" and rec.frozen_dump() is None
        assert "slo.passiveprobe.state" not in tt.get_metrics().gauges()
    finally:
        rec.rearm()


def test_flight_sink_writes_the_dump_on_the_triggering_thread(tmp_path, monkeypatch):
    monkeypatch.setenv("FLIGHT_SINK", str(tmp_path / "fl"))
    rec = tt.FlightRecorder(max_traces=4, snapshot_interval_s=999)
    rec.observe_span({"svc": "t", "span": "s", "trace": "tr", "ms": 1.0})
    t = threading.Thread(target=rec.trigger, args=("slo.sink.violated",))
    t.start()
    t.join()
    files = list(tmp_path.glob("fl_slo.sink.violated_*.json"))
    assert len(files) == 1
    body = json.loads(files[0].read_text())
    assert body["frozen"] and body["traces"][0]["trace_id"] == "tr"
    monkeypatch.setenv("FLIGHT_SINK", str(tmp_path / "missing" / "fl"))
    before = tt.get_metrics().snapshot()["counters"].get("flight.sink_write_errors", 0.0)
    assert tt.FlightRecorder().trigger("x")  # a failed write never fails the freeze
    assert tt.get_metrics().snapshot()["counters"]["flight.sink_write_errors"] == before + 1


def test_trace_and_flight_rings_bounded_under_concurrent_writers():
    """Threads finish spans of mostly unique trace ids through one tracer
    while another triggers and re-arms: both rings stay at their bounds and
    every span reached the recorder's ring or aged out of it."""
    rec = tt.FlightRecorder(max_traces=16, max_snapshots=8, snapshot_interval_s=0.0)
    tracer = tt.Tracer("hammer", emit=False)
    errors = []

    def writer(w):
        try:
            for i in range(200):
                d = {"svc": "h", "span": "s", "trace": f"w{w}-{i % 50}", "ms": 1.0}
                rec.observe_span(d)
                with tracer.span("s", trace_id=f"w{w}-{i}"):
                    pass
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def freezer():
        for _ in range(50):
            rec.trigger("hammer")
            rec.rearm()

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(6)]
    threads.append(threading.Thread(target=freezer))
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors
    st = rec.state()
    assert st["traces_buffered"] == 16 and st["snapshots_buffered"] <= 8
    assert len(tracer._ring) <= tt.Tracer.MAX_TRACES


def test_flightrecorder_and_steplog_routes_answer_as_jax():
    """``/debug/flightrecorder`` (armed, frozen, ``?rearm=1``) and
    ``/debug/steplog?last=K`` on the port's brain, with the JAX brain's body
    keys."""
    from tpu_voice_agent.utils.steplog import get_steplog as jax_steplog
    from tpu_voice_agent_torch.utils.steplog import get_steplog

    def get(app, path, query=""):
        return app.handle(ws.Request("GET", path, query, ws.Headers(), b""))

    for log in (get_steplog(), jax_steplog()):
        log.clear()
        for i in range(5):
            log.timer().finish(occupancy=i, tokens=i)
    app = brain.BrainApp(brain.RuleBasedParser())
    rec = tt.get_flight_recorder()
    rec.rearm()
    with AppServer(jbrain.build_app(jbrain.RuleBasedParser())) as srv:
        jt.get_flight_recorder().rearm()
        jarmed = httpx.get(srv.url + "/debug/flightrecorder", timeout=5).json()
        jsteps = httpx.get(srv.url + "/debug/steplog?last=2", timeout=5).json()
        jt.get_flight_recorder().trigger("test.route")
        jfrozen = httpx.get(srv.url + "/debug/flightrecorder?rearm=1", timeout=5).json()
    status, armed, _ = get(app, "/debug/flightrecorder")
    assert status == 200 and set(armed) == set(jarmed) and armed["service"] == "brain"
    status, steps, _ = get(app, "/debug/steplog", "last=2")
    assert status == 200 and set(steps) == set(jsteps)
    assert (len(steps["steps"]), steps["recorded"], steps["steps"][-1]["occupancy"]) == (2, 5, 4)
    rec.trigger("test.route")
    _, frozen, _ = get(app, "/debug/flightrecorder", "rearm=1")
    assert frozen["reason"] == "test.route" and frozen["rearmed"] is True
    assert set(frozen) == set(jfrozen)
    assert rec.frozen_dump() is None
    get_steplog().clear()
    jax_steplog().clear()


def test_steplog_units_match_jax():
    """StepTimer tiling, ``carve`` clamping, ring bounds and sequence
    numbers, and a disabled log, against JAX's ``utils.steplog``."""
    from tpu_voice_agent.utils import steplog as js
    from tpu_voice_agent_torch.utils import steplog as ts

    assert ts.STAGES == js.STAGES
    log = ts.StepLog(max_steps=8, enabled=True)
    t = log.timer()
    time.sleep(0.002)
    t.lap("admit")
    time.sleep(0.003)
    t.lap("decode")
    t.lap("readback")
    t.lap("release")
    rec = t.finish(occupancy=2, tokens=5, admitted=None)
    assert rec["occupancy"] == 2 and "admitted" not in rec and rec["events"] == []
    slack = 5e-4 * (len(rec["stages"]) + 1)
    assert 0.95 * rec["wall_ms"] <= sum(rec["stages"].values()) <= rec["wall_ms"] + slack
    for mod in (js, ts):
        c = mod.StepLog(max_steps=8, enabled=True).timer()
        c.lap("admit")
        c.stages["admit"] = 10.0
        c.carve("admit", "prefill", 4.0)
        c.carve("admit", "prefill", 100.0)  # clamped: tiling kept
        c.carve("decode", "draft", 0.0)  # nothing to carve
        assert c.stages == {"admit": 0.0, "prefill": 10.0}
    for mod in (js, ts):
        ring = mod.StepLog(max_steps=4, enabled=True)
        for _ in range(10):
            ring.timer().finish()
        d = ring.dump()
        assert (len(d["steps"]), d["recorded"], [s["seq"] for s in d["steps"]]) == (
            4, 10, [6, 7, 8, 9])
        assert ring.last()["seq"] == 9 and len(ring.steps(last=2)) == 2
        off = mod.StepLog(max_steps=4, enabled=False)
        off.timer().finish()
        assert off.dump()["steps"] == [] and off.last() is None
