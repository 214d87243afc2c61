"""The port's brain service: the ``/parse`` contract on CPU engines, its env
factory, and the rule that the port imports neither JAX nor the JAX package.

The contract is the JAX service's (services/brain.py ``_parse_inner``):
``{text, context, session_id?}`` in; 200 with the ParseResponse dict; 400
``invalid_request``; 422 ``schema_validation_failed`` when the decode runs
out of budget before EOS; 500 ``llm_error`` when the engine fails; errors as
``{"error", "detail"}``. The 200 body is held equal to the JAX package's
``model_dump()`` through the recorded golden parses of the distilled
checkpoint.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from tpu_voice_agent_torch import distilled
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.services import brain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _short_prompt(text, context):
    return f"<|user|>\n{text}\n<|assistant|>\n"


@pytest.fixture(scope="module")
def distilled_app():
    return brain.BrainApp(distilled.intent_engine_from(*distilled.load_distilled(device="cpu"),
                                                       device="cpu"))


@pytest.fixture(scope="module")
def tiny_engine():
    return DecodeEngine(preset="test-tiny", max_len=256, prefill_buckets=(64, 128),
                        fast_forward=8, device="cpu")


def _post(app, body):
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    return app.parse(raw)


def test_parse_200_is_the_recorded_model_dump(distilled_app):
    rec = distilled.golden_records()[0]
    status, body, headers = _post(distilled_app, {"text": rec["text"],
                                                  "context": rec["context"],
                                                  "session_id": "s1"})
    assert status == 200
    assert body == rec["response"]  # the JAX package's model_dump() of this parse
    assert int(headers["x-prompt-tokens"]) > 0 and "x-trace-id" in headers


@pytest.mark.parametrize("raw", [
    b"not json",
    b"[1, 2]",
    json.dumps({"context": {}}).encode(),  # text missing
    json.dumps({"text": ""}).encode(),  # too short
    json.dumps({"text": "go back", "bogus": 1}).encode(),  # extra field
    json.dumps({"text": "go back", "context": []}).encode(),
])
def test_parse_400_invalid_request(distilled_app, raw):
    status, body, _ = _post(distilled_app, raw)
    assert status == 400 and body["error"] == "invalid_request" and body["detail"]


def test_parse_409_prefix_feed_is_refused(distilled_app):
    status, body, _ = _post(distilled_app, {"text": "go", "prefix_feed": True})
    assert (status, body["error"]) == (409, "prefix_feed_unsupported")


def test_parse_422_when_the_decode_is_truncated(tiny_engine):
    app = brain.BrainApp(brain.EngineParser(tiny_engine, max_new_tokens=6,
                                            render=_short_prompt))
    status, body, _ = _post(app, {"text": "search for headphones"})
    assert status == 422
    assert body == {"error": "schema_validation_failed",
                    "detail": "decode truncated after 6 tokens (no EOS)"}


def test_parse_500_when_the_prompt_does_not_fit(tiny_engine):
    # the few-shot prompt (~880 tokens) exceeds this engine's 128 bucket
    app = brain.BrainApp(brain.EngineParser(tiny_engine, max_new_tokens=6))
    status, body, _ = _post(app, {"text": "search for headphones"})
    assert status == 500 and body["error"] == "llm_error"
    assert "exceeds max bucket" in body["detail"]


def test_parse_500_on_a_poisoned_row():
    eng = DecodeEngine(preset="test-tiny", max_len=256, prefill_buckets=(64, 128),
                       fast_forward=8, device="cpu")
    eng.params["final_norm"] = torch.full_like(eng.params["final_norm"], float("nan"))
    app = brain.BrainApp(brain.EngineParser(eng, max_new_tokens=6, render=_short_prompt))
    status, body, _ = _post(app, {"text": "go back"})
    assert status == 500
    assert body == {"error": "llm_error", "detail": "poisoned: non-finite logits"}


def test_http_server_round_trip(distilled_app):
    server = brain.make_server(distilled_app, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["device"] == "cpu" and health["kernels"] == "kernels"
        rec = distilled.golden_records()[5]
        req = urllib.request.Request(base + "/parse", method="POST",
                                     data=json.dumps({"text": rec["text"]}).encode(),
                                     headers={"Content-Type": "application/json",
                                              "x-trace-id": "abc"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200 and r.headers["x-trace-id"] == "abc"
            assert json.loads(r.read()) == rec["response"]
        bad = urllib.request.Request(base + "/parse", method="POST", data=b"{")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
        assert json.loads(e.value.read())["error"] == "invalid_request"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_env_factory_reads_the_jax_service_names(monkeypatch):
    monkeypatch.setenv("BRAIN_BACKEND", "engine:test-tiny")
    monkeypatch.setenv("BRAIN_QUANT", "int8")
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    monkeypatch.delenv("BRAIN_FF", raising=False)
    monkeypatch.delenv("BRAIN_PREFIX", raising=False)
    parser = brain.make_parser_from_env()
    eng = parser.engine
    assert (eng.fast_forward, eng.quant, eng.max_len) == (8, "int8", 2048)
    assert isinstance(eng.params["lm_head"], dict)  # int8 {"q", "s"}
    assert len(eng.prefix_ids) > 800  # the few-shot head is cached at boot
    monkeypatch.setenv("BRAIN_FF", "0")
    monkeypatch.setenv("BRAIN_PREFIX", "0")
    monkeypatch.delenv("BRAIN_QUANT")
    eng = brain.make_parser_from_env().engine
    assert (eng.fast_forward, eng.quant, eng.prefix_ids) == (0, None, [])


UNSERVED = ("BRAIN_MODEL", "RADIX_SESSIONS", "RADIX_MAX_NODES", "RADIX_PRESSURE_S",
            "TENANT_PREEMPT", "TENANT_CLASSES", "ENGINE_STALL_S", "COST_ENABLE", "COST_SESSIONS",
            "COST_PEAK_TFLOPS", "COST_PEAK_GBPS", "CHAOS_STALL_S", "HANDOFF_KV", "BRAIN_ROLE")
# served since the containment slice
SERVED_CONTAINMENT = ("PREFILL_CHUNK_TOKENS", "QUARANTINE_AFTER", "BRAIN_MAX_INFLIGHT",
                      "CHAOS_FAULTS", "CHAOS_SEED")


def _tiny_env(monkeypatch):
    monkeypatch.setenv("BRAIN_BACKEND", "engine:test-tiny")
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    monkeypatch.setenv("BRAIN_PREFIX", "0")
    for name in UNSERVED + SERVED_CONTAINMENT + ("BRAIN_MOE", "BRAIN_QUANT", "BRAIN_BATCH",
                                                 "BRAIN_PAGED"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("name,value", [
    ("BRAIN_MODEL", "/models/intent-8b"), ("BRAIN_BACKEND", "pp:test-tiny"),
    ("BRAIN_BACKEND", "planner-distilled"), ("BRAIN_BACKEND", "planner"),
])
def test_env_factory_refuses_knobs_it_would_ignore(monkeypatch, name, value):
    """Each knob the JAX brain honours and the port does not serve raises at
    boot, before any engine is built, and names the knob and the ROADMAP
    item that will serve it."""
    _tiny_env(monkeypatch)
    monkeypatch.setenv(name, value)
    built = []
    monkeypatch.setattr(DecodeEngine, "__init__", lambda *a, **k: built.append(1))
    with pytest.raises(ValueError, match=name) as e:
        brain.make_parser_from_env()
    assert "ROADMAP.md Queue 1 item" in str(e.value) and not built


@pytest.mark.parametrize("spec", ["stt_replica_hang:1", "stt_replica_kill:1"])
def test_env_factory_serves_the_stt_replica_chaos_points(monkeypatch, spec):
    """Once refused at brain boot (the replicated STT tier was missing):
    every chaos point of JAX's plane is served, so the factory builds."""
    _tiny_env(monkeypatch)
    monkeypatch.setenv("CHAOS_FAULTS", spec)
    built = []
    monkeypatch.setattr(DecodeEngine, "__init__", lambda *a, **k: built.append(1))
    with pytest.raises(Exception) as e:  # the stubbed engine has no attributes
        brain.make_parser_from_env()
    assert built == [1] and "CHAOS_FAULTS" not in str(e.value)


@pytest.mark.parametrize("name,value", [
    ("RADIX_SESSIONS", "lots"), ("RADIX_MAX_NODES", "1e3"), ("RADIX_PRESSURE_S", "soon"),
    ("TENANT_CLASSES", "gold:4:0.5,free:1:0.1"), ("TENANT_CLASSES", "gold:0"),
    ("COST_SESSIONS", "many"), ("COST_PEAK_TFLOPS", "fast"), ("ENGINE_STALL_S", "thirty"),
    ("CHAOS_STALL_S", "long"),
])
def test_env_factory_refuses_malformed_values(monkeypatch, name, value):
    """A served knob whose value does not parse (the radix and cost knobs,
    a malformed tenant registry) raises at boot naming the knob, before any
    engine is built."""
    _tiny_env(monkeypatch)
    monkeypatch.setenv(name, value)
    built = []
    monkeypatch.setattr(DecodeEngine, "__init__", lambda *a, **k: built.append(1))
    with pytest.raises(ValueError, match=name):
        brain.make_parser_from_env()
    assert not built


@pytest.mark.parametrize("name,value", [
    ("RADIX_SESSIONS", "512"), ("RADIX_MAX_NODES", "1024"), ("RADIX_PRESSURE_S", "0.5"),
    ("TENANT_PREEMPT", "0"), ("TENANT_CLASSES", "gold:4:slots=1,free:1:rps=2"),
    ("COST_ENABLE", "0"), ("COST_SESSIONS", "8"),
])
def test_env_factory_serves_the_tenancy_radix_and_cost_knobs(monkeypatch, name, value):
    """The knobs refused until the rest of continuous batching was ported
    boot on a batched paged radix engine and reach what reads them."""
    _tiny_env(monkeypatch)
    monkeypatch.setenv("BRAIN_BATCH", "2")
    monkeypatch.setenv("BRAIN_PAGED", "1")
    monkeypatch.setenv("RADIX_ENABLE", "1")
    monkeypatch.setenv(name, value)
    parser = brain.make_parser_from_env()
    try:
        b, eng = parser.batcher, parser.engine
        reached = {"RADIX_SESSIONS": lambda: parser.transcripts.max_sessions == 512,
                   "RADIX_MAX_NODES": lambda: eng.radix.max_nodes == 1024,
                   "RADIX_PRESSURE_S": lambda: eng._pressure_window_s == 0.5,
                   "TENANT_PREEMPT": lambda: b.tenancy is None and not b._preempt_on,
                   "TENANT_CLASSES": lambda: (set(b.tenancy.classes) == {"gold", "free",
                                                                         "default"}
                                              and eng.radix.ns_quota is not None),
                   "COST_ENABLE": lambda: b.costs is None and parser.session_costs is None,
                   "COST_SESSIONS": lambda: parser.session_costs.cap == 8}
        assert reached[name]()
    finally:
        parser.close()


def test_env_factory_refuses_an_unknown_chaos_point_with_the_jax_message(monkeypatch):
    """``nan_inject`` names no chaos point: both packages' ``Chaos`` refuse
    the spec with the same message, and the port does so at boot."""
    from tpu_voice_agent.utils import chaos as jchaos

    _tiny_env(monkeypatch)
    monkeypatch.setenv("CHAOS_FAULTS", "nan_inject:0.5")
    built = []
    monkeypatch.setattr(DecodeEngine, "__init__", lambda *a, **k: built.append(1))
    with pytest.raises(ValueError) as jax_err:
        jchaos.Chaos("nan_inject:0.5")
    with pytest.raises(ValueError, match="unknown chaos point 'nan_inject'") as e:
        brain.make_parser_from_env()
    assert str(e.value) == str(jax_err.value) and not built


@pytest.mark.parametrize("name,value", [
    ("PREFILL_CHUNK_TOKENS", "256"), ("QUARANTINE_AFTER", "2"), ("BRAIN_MAX_INFLIGHT", "32"),
])
def test_env_factory_serves_the_containment_knobs(monkeypatch, name, value):
    """The knobs once refused boot on a batched paged engine, and each
    reaches what reads it: the batcher (chunk size, quarantine threshold)
    or the app's admission controller (the in-flight cap)."""
    _tiny_env(monkeypatch)
    monkeypatch.setenv("BRAIN_BATCH", "2")
    monkeypatch.setenv("BRAIN_PAGED", "1")
    monkeypatch.setenv(name, value)
    parser = brain.make_parser_from_env()
    try:
        b = parser.batcher
        reached = {"PREFILL_CHUNK_TOKENS": lambda: b._prefill_chunk,
                   "QUARANTINE_AFTER": lambda: b.quarantine_after,
                   "BRAIN_MAX_INFLIGHT": lambda: brain.BrainApp(parser).admission.max_inflight}
        assert reached[name]() == int(value)
    finally:
        parser.close()


@pytest.mark.parametrize("name,value", [
    ("RADIX_SESSIONS", "256"), ("RADIX_MAX_NODES", "4096"), ("RADIX_PRESSURE_S", "2"),
    ("PREFILL_CHUNK_TOKENS", ""), ("QUARANTINE_AFTER", ""), ("TENANT_PREEMPT", " "),
    ("BRAIN_MAX_INFLIGHT", ""), ("BRAIN_MODEL", ""),
    ("TENANT_CLASSES", ""), ("CHAOS_FAULTS", " "), ("ENGINE_STALL_S", ""),
    ("ENGINE_STALL_S", "30"), ("CHAOS_STALL_S", "3"), ("HANDOFF_KV", "0"),
    ("BRAIN_ROLE", "prefill"),
])
def test_env_factory_passes_the_values_it_serves(monkeypatch, name, value):
    """The radix knobs at the port's constants, and the unported knobs unset
    or empty (the JAX defaults), boot."""
    _tiny_env(monkeypatch)
    monkeypatch.setenv(name, value)
    assert brain.make_parser_from_env().engine.cfg.n_experts == 0


def test_env_factory_serves_brain_moe(monkeypatch):
    """``BRAIN_MOE=grouped`` picks the grouped dispatch on an MoE preset and
    is a no-op on a dense one, as in the JAX service; /health says which."""
    _tiny_env(monkeypatch)
    monkeypatch.setenv("BRAIN_BACKEND", "engine:mixtral-test")
    monkeypatch.setenv("BRAIN_QUANT", "int8")
    eng = brain.make_parser_from_env().engine
    assert (eng.cfg.n_experts, eng.cfg.moe_impl) == (4, "dense")
    monkeypatch.setenv("BRAIN_MOE", "grouped")
    parser = brain.make_parser_from_env()
    eng = parser.engine
    assert (eng.cfg.n_experts, eng.cfg.moe_impl, eng.quant) == (4, "grouped", "int8")
    assert eng.params["layers"][0]["moe_gate"]["q"].dtype == torch.int8
    assert not isinstance(eng.params["layers"][0]["router"], dict)
    status, body, _ = brain.BrainApp(parser).health()
    assert status == 200 and (body["moe_impl"], body["n_experts"]) == ("grouped", 4)
    res = eng.generate(_short_prompt("go back", {}), max_new_tokens=8)
    assert res.error is None and res.steps == 8
    monkeypatch.setenv("BRAIN_BACKEND", "engine:test-tiny")
    eng = brain.make_parser_from_env().engine
    assert (eng.cfg.n_experts, eng.cfg.moe_impl) == (0, "grouped")  # dense FFN all the same


def test_env_factory_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    monkeypatch.setenv("BRAIN_BACKEND", "engine:test-tiny")
    monkeypatch.delenv("BRAIN_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brain.make_parser_from_env()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_voice_agent_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import tpu_voice_agent_torch.services.brain\n"
        # the STT slice, the batched paged serving slice, the voice service
        # and the GPU smoke script (namespace subpackages are not walked, so
        # name them)
        "for m in ('audio.mel', 'audio.endpoint', 'models.whisper', 'serve.stt',\n"
        "          'whisper_ckpt', 'voicebench', 'models.llama', 'ops.paged_attention',\n"
        "          'serve.engine', 'serve.paged', 'serve.radix', 'serve.scheduler',\n"
        "          'serve.spec', 'models.moe', 'ops.grouped_matmul', 'services.voice',\n"
        "          'services.ws', 'services.slo', 'services.resilience', 'utils',\n"
        "          'utils.tracing', 'utils.quality', 'utils.chaos', 'utils.steplog',\n"
        "          'evals.wer', 'evals.golden', 'distilled', 'utils.envcfg',\n"
        "          'utils.costmodel', 'serve.tenancy', 'serve.stt_batch', 'serve.handoff'):\n"
        "    importlib.import_module('tpu_voice_agent_torch.' + m)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k in ('jax', 'jaxlib', 'tpu_voice_agent', 'aiohttp',\n"
        "                                       'httpx', 'ml_dtypes')\n"
        "       or k.startswith(('jax.', 'jaxlib.', 'tpu_voice_agent.', 'aiohttp.', 'httpx.'))]\n"
        "print(len([k for k in sys.modules if k.startswith('tpu_voice_agent_torch')]), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 47 and bad.strip() == "[]"


# ---------------------------------------------------------------- batched


def _distilled_paged(**kw):
    """The distilled checkpoint in a paged engine (block 16, so short
    transcripts fill blocks the radix tree can share)."""
    cfg, params = distilled.load_distilled(device="cpu")
    eng = PagedDecodeEngine(cfg=dataclasses.replace(cfg, max_seq_len=512), max_len=512,
                            prefill_buckets=(64, 128, 256), init_weights=False, device="cpu",
                            block_size=16, **kw)
    eng.load_params(params)
    return eng


def test_batched_parser_answers_concurrent_requests():
    parser = brain.BatchedEngineParser(_distilled_paged(batch_slots=4), max_new_tokens=300,
                                       render=distilled.distilled_prompt)
    app = brain.BrainApp(parser)
    recs = distilled.golden_records()[:6]
    out = [None] * len(recs)

    def one(i):
        out[i] = _post(app, {"text": recs[i]["text"], "context": recs[i]["context"]})

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(recs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for rec, (status, body, headers) in zip(recs, out):
            assert status == 200 and body == rec["response"]
            assert headers["x-cached-tokens"] == "0" and int(headers["x-prompt-tokens"]) > 0
        # the six requests shared decode chunks on four slots
        assert parser.batcher.chunks < sum(-(-len(r["token_ids"]) // 16) for r in recs)
        assert app.health()[1]["batch_slots"] == 4
    finally:
        parser.close()
    assert parser.engine.allocator.blocks_in_use == 0


def test_timed_out_requests_leave_no_batcher_state():
    """Abandoned parses leave the queue (or decode on unread), and the
    batcher keeps no bookkeeping for any of them."""
    parser = brain.BatchedEngineParser(_distilled_paged(batch_slots=1), max_new_tokens=300,
                                       timeout_s=0.05, render=distilled.distilled_prompt)
    recs = distilled.golden_records()[:3]
    errs = []

    def one(rec):
        try:
            parser.parse(rec["text"], rec["context"])
        except brain.ParserError as e:
            errs.append(e)

    try:
        threads = [threading.Thread(target=one, args=(r,)) for r in recs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(errs) == 3
        b = parser.batcher
        for _ in range(600):
            with parser.loop._cv:
                idle = not (b.busy() or parser.loop._futures or parser.loop._abandoned)
            if idle:
                break
            threading.Event().wait(0.1)
        assert idle and parser.loop.healthy()
        assert not (b.pending or b.results or b._enqueued_at or b._pool_wait or b._requeues)
    finally:
        parser.close()
    assert parser.engine.allocator.blocks_in_use == 0


def test_session_parser_extends_the_transcript_and_commits_speculation():
    parser = brain.BatchedEngineParser(_distilled_paged(batch_slots=2, radix_enable=True),
                                       max_new_tokens=200, session_aware=True,
                                       render=distilled.distilled_prompt)
    app = brain.BrainApp(parser)
    recs = distilled.golden_records()
    try:
        status, body, h = _post(app, {"text": recs[0]["text"], "session_id": "a",
                                      "context": recs[0]["context"]})
        assert status == 200 and body == recs[0]["response"]
        assert h["x-cached-tokens"] == "0"
        # turn 2 extends turn 1's ids: the radix tree serves its full blocks
        req = {"text": recs[2]["text"], "session_id": "a", "context": recs[2]["context"]}
        status, body, h = _post(app, {**req, "speculative": True})
        assert status == 200 and h["x-speculation-pending"] == "1"
        cached = int(h["x-cached-tokens"])
        assert 0 < cached < int(h["x-prompt-tokens"])
        chunks = parser.batcher.chunks
        status2, body2, h2 = _post(app, req)  # the final commits the pending turn
        assert (status2, body2) == (status, body) and parser.batcher.chunks == chunks
        # answered without a decode; the pending turn's split is replayed,
        # as the JAX brain replays its stage notes
        assert h2["x-cached-tokens"] == h["x-cached-tokens"]
        status, body, h = _post(app, {"text": recs[4]["text"], "session_id": "a",
                                      "context": recs[4]["context"]})
        assert status == 200 and int(h["x-cached-tokens"]) > cached
        # a session-less request stays stateless
        status, body, h = _post(app, {"text": recs[0]["text"], "context": recs[0]["context"]})
        assert status == 200 and body == recs[0]["response"]
    finally:
        parser.close()


def test_batched_parser_sheds_with_503_when_the_pool_stays_exhausted(monkeypatch):
    monkeypatch.setenv("SCHED_POOL_WAIT_S", "0")
    parser = brain.BatchedEngineParser(_distilled_paged(batch_slots=2, pool_blocks=3),
                                       render=distilled.distilled_prompt)
    try:
        status, body, headers = _post(brain.BrainApp(parser), {"text": "go back"})
    finally:
        parser.close()
    assert status == 503 and body["error"] == "overloaded" and headers["Retry-After"] == "1"
    assert body["detail"].startswith("shed: KV pool exhausted")


def test_env_factory_builds_the_batched_paged_brain(monkeypatch):
    monkeypatch.setenv("BRAIN_BACKEND", "engine:test-tiny")
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    monkeypatch.setenv("BRAIN_BATCH", "3")
    monkeypatch.setenv("BRAIN_PAGED", "1")
    monkeypatch.setenv("RADIX_ENABLE", "1")
    monkeypatch.setenv("BRAIN_POOL_BLOCKS", "40")
    parser = brain.make_parser_from_env()
    try:
        eng = parser.engine
        assert isinstance(parser, brain.BatchedEngineParser) and parser.wants_session
        assert isinstance(eng, PagedDecodeEngine) and eng.radix is not None
        assert (eng.batch_slots, eng.allocator.n_blocks, eng.fast_forward) == (3, 40, 8)
        assert eng.allocator.blocks_in_use == len(eng.prefix_ids) // eng.block_size > 0
        health = brain.BrainApp(parser).health()[1]
        assert health["ok"] and health["paged"] and health["radix"]
    finally:
        parser.close()
    monkeypatch.delenv("BRAIN_PAGED")
    monkeypatch.setenv("BRAIN_BATCH", "2")
    parser = brain.make_parser_from_env()
    try:
        assert isinstance(parser, brain.BatchedEngineParser) and not parser.wants_session
        assert type(parser.engine) is DecodeEngine and parser.engine.batch_slots == 2
    finally:
        parser.close()
