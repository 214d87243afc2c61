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
- The refusals: other ``distilled:`` directories, ``planner-distilled``,
  ``QUALITY_CANARY_S``.
"""

import asyncio
import json
import sys
import threading
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
    "flight.": 3,  # the flight recorder
    "quality.golden": 3,  # the golden-replay canary
    "quality.exec_success_rate": 9,  # record_exec, fed by the executor service
    "brain.parses_cancelled": 4, "chaos.": 4, "colocate.": 4, "engine.restarts": 4,
    "engine.step.": 4, "prefill.chunk": 4, "resilience.*.inflight": 4,
    "resilience.*.max_inflight": 4, "resilience.*.shed_overload": 4,
    "resilience.cancel_callback_errors": 4, "scheduler.cancelled": 4,
    "scheduler.quarantine_rejected": 4, "scheduler.shed_expired": 4, "tenant.": 4,
    "voice.frames_dropped_chaos": 4,
    "stt.batch_": 5, "stt.finals_batched": 5, "stt.item_faults": 5,
    "stt.partials_coalesced": 5, "stt.queue_depth": 5, "stt.shed_overload": 5,
    "stt.replica": 5,
    "autopilot.": 6, "brain.drains_received": 6, "disagg.": 6, "fleet.": 6, "handoff.": 6,
    "prefill.feeds": 6, "router.": 6,
    "cost.": 7, "engine.mbu": 7, "engine.mfu": 7, "hbm.": 7, "ts.": 7, "xla.": 7,
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


def _unported_item(name: str) -> int | None:
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
    assert status != 404, (method, path, body)
    if status == 501:
        assert body["error"] == "not_ported"
        assert body["detail"].startswith("ROADMAP.md Queue 1 item "), body
    else:
        assert path in ("/health", "/parse", "/metrics", "/debug/quality") \
            or path.startswith("/debug/trace/"), (path, status)


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
    monkeypatch.setenv("QUALITY_CANARY_S", "0.5")
    with pytest.raises(ValueError, match="QUALITY_CANARY_S.*item 3"):
        brain.make_parser_from_env()
    with pytest.raises(ValueError, match="item 3"):
        brain.BrainApp(brain.RuleBasedParser())
    monkeypatch.setenv("QUALITY_CANARY_S", "0")
    brain.BrainApp(brain.RuleBasedParser())


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
                 "resilience.*.breaker_state", "quality.intent_margin", "*.shed_*"):
        assert name in port_reg, name
