"""The port's cost meter (``utils/costmodel.py`` and the batcher's folds)
against the JAX package's.

- Every analytic function equals JAX's ints exactly, on tinyllama-1.1b,
  mixtral-8x7b and test-tiny, at bf16, int8 and int4 KV, and on the Whisper
  presets up to whisper-large-v3.
- On the same batch drain (one float32 weight tree, the JAX engine on its
  Pallas kernels in interpret mode), each request's ledger equals JAX's
  (the wall-clock lane ``kv_block_us`` aside), on the dense and the paged
  engine at fast-forward 8 and under speculation.
- Conservation: the requests' ledgers sum to the meter's totals with
  ``==``, over a mixed paged run (radix warm hits, speculation, a
  chaos-poisoned row, a mid-decode cancel) on bf16, int8 and int4 pools.
- ``COST_ENABLE=0`` leaves the tokens equal, with no ledgers; ``/debug/costs``
  answers JAX's shape on the brain and the voice service; a flight dump
  carries ``costs``; the STT engine's lanes equal JAX's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models.llama import PRESETS as J_LLAMA
from tpu_voice_agent.models.whisper import PRESETS as J_WHISPER
from tpu_voice_agent.models.whisper import init_params as j_winit
from tpu_voice_agent.serve import DecodeEngine as JDense
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve import SpecConfig as JSpecConfig
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.serve.stt import SpeechEngine as JSpeech
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent.utils import costmodel as jcost
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.models.llama import PRESETS
from tpu_voice_agent_torch.models.whisper import PRESETS as W_PRESETS
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.serve.spec import SpecConfig
from tpu_voice_agent_torch.serve.stt import SpeechEngine
from tpu_voice_agent_torch.services import brain
from tpu_voice_agent_torch.services.brain import SessionTranscripts, install_prompt_prefix
from tpu_voice_agent_torch.utils import chaos, costmodel
from tpu_voice_agent_torch.utils.costmodel import LEDGER_KEYS, SessionCostLedger, zero_ledger
from tpu_voice_agent_torch.utils.tracing import get_flight_recorder, get_metrics

MAXTOK = 32
KW = dict(preset="test-tiny", max_len=2048, prefill_buckets=(128, 256, 512, 1024, 2048))
PROMPTS = [render_prompt("search for laptops under 1000", {}),
           render_prompt("upload my resume and submit", {}),
           render_prompt("take a screenshot of this page", {})]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module (the driver runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    return PRESETS[name], J_LLAMA[name]


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("name", ["tinyllama-1.1b", "mixtral-8x7b", "test-tiny", "llama3-8b"])
@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_analytic_llm_functions_equal_jax(name, kv):
    t, j = _cfgs(name)
    assert costmodel.llm_token_flops(t) == jcost.llm_token_flops(j)
    assert costmodel.llm_attn_flops_per_ctx(t) == jcost.llm_attn_flops_per_ctx(j)
    assert costmodel.kv_position_bytes(t, kv) == jcost.kv_position_bytes(j, kv)
    for wq in ("int8", None):
        for batch, ctx in ((1, 0), (32, 943), (8, 2048)):
            assert (costmodel.decode_step_bytes(t, batch, ctx, kv_quant=kv, weight_quant=wq)
                    == jcost.decode_step_bytes(j, batch, ctx, kv_quant=kv, weight_quant=wq))
    for n, ctx in ((0, 0), (1, 1), (879, 879), (26, 905), (1000, 1024)):
        assert costmodel.prefill_flops(t, n, ctx) == jcost.prefill_flops(j, n, ctx)
        assert costmodel.decode_flops(t, n, ctx) == jcost.decode_flops(j, n, ctx)
        assert costmodel.spec_verify_flops(t, ctx, 4) == jcost.spec_verify_flops(j, ctx, 4)
    tm = costmodel.CostModel(t, quant="int8", kv_quant=kv)
    jm = jcost.CostModel(j, quant="int8", kv_quant=kv)
    assert (tm.token_flops, tm.attn_flops_per_ctx, tm.kv_pos_bytes, tm.weights_stream_bytes) == (
        jm.token_flops, jm.attn_flops_per_ctx, jm.kv_pos_bytes, jm.weights_stream_bytes)
    for n, c in ((100, 0), (100, 37), (100, 100), (7, 3), (10, 99), (0, 0)):
        assert tm.prefill_split(n, c) == jm.prefill_split(n, c)
        assert sum(tm.prefill_split(n, c)) == costmodel.prefill_flops(t, n, n)
    assert tm.decode_row(9, 943) == jm.decode_row(9, 943)


@pytest.mark.parametrize("name", ["whisper-test", "whisper-tiny", "whisper-large-v3"])
def test_analytic_whisper_functions_equal_jax(name):
    t, j = W_PRESETS[name], J_WHISPER[name]
    for frames in (0, 50, 70, 300, 1000, 3000):
        assert costmodel.whisper_encoder_flops(t, frames) == jcost.whisper_encoder_flops(j, frames)
    for tokens, enc in ((0, 250), (1, 1), (33, 150), (64, 1500)):
        assert (costmodel.whisper_decoder_flops(t, tokens, enc)
                == jcost.whisper_decoder_flops(j, tokens, enc))
    assert isinstance(costmodel.whisper_encoder_flops(t, 1000), int)


def test_device_peak_knob_table_and_proxy(monkeypatch):
    monkeypatch.setenv("COST_PEAK_TFLOPS", "100")
    monkeypatch.setenv("COST_PEAK_GBPS", "1000")
    assert costmodel.device_peak("cpu") == jcost.device_peak()
    monkeypatch.delenv("COST_PEAK_TFLOPS")
    monkeypatch.delenv("COST_PEAK_GBPS")
    p = costmodel.device_peak("cpu")
    assert p == {"flops_per_s": 0.5e12, "bytes_per_s": 50e9, "device": "cpu",
                 "source": "cpu-proxy"} == jcost.device_peak()
    # a card: its data sheet entry, or a refusal (never the CPU proxy)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    p = costmodel.device_peak("cuda")
    assert (p["flops_per_s"], p["bytes_per_s"], p["source"]) == (989e12, 3350e9, "table")
    monkeypatch.setenv("COST_PEAK_GBPS", "2000")
    assert costmodel.device_peak("cuda")["bytes_per_s"] == 2000e9
    monkeypatch.delenv("COST_PEAK_GBPS")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="COST_PEAK_TFLOPS"):
        costmodel.device_peak("cuda")


def test_session_cost_ledger_lru_and_top():
    for led in (SessionCostLedger(cap=2), jcost.SessionCostLedger(cap=2)):
        led.fold(None, None)
        assert len(led) == 0
        cost_a = dict(zero_ledger(), prefill_flops=100, decode_flops=50)
        cost_b = dict(zero_ledger(), prefill_flops=10, decode_flops=5)
        led.fold("a", cost_a)
        led.fold("a", cost_a)
        led.fold("b", cost_b)
        top = led.top()
        assert top[0]["session"] == "a" and top[0]["prefill_flops"] == 200
        assert top[0]["utterances"] == 2
        led.fold(None, cost_b)
        assert len(led) == 2
        assert {e["session"] for e in led.top(8)} == {"b", "_stateless"}


# ------------------------------------------------------ ledgers vs JAX

@pytest.fixture(scope="module")
def weights():
    eng = JPaged(kernels="pallas", batch_slots=3, **KW)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


def _port(weights, cls=PagedDecodeEngine, **kw):
    eng = cls(init_weights=False, device="cpu", **KW, **kw)
    eng.load_params(bridge.params_from_numpy(weights))
    install_prompt_prefix(eng)
    return eng


def _jax(weights, cls=JPaged, **kw):
    eng = cls(kernels="pallas", init_weights=False, **KW, **kw)
    eng.load_params(jax.device_put(weights))
    j_install(eng)
    return eng


def _sum(results):
    out = zero_ledger()
    for r in results:
        assert r.cost is not None, f"request missing its ledger: {r.error}"
        for k in LEDGER_KEYS:
            out[k] += r.cost[k]
    return out


def _assert_conserved(batcher, results):
    summed, totals = _sum(results), batcher.costs.totals
    for k in LEDGER_KEYS:
        assert summed[k] == totals[k], f"{k}: {summed[k]} != {totals[k]}"
        assert isinstance(totals[k], int) and isinstance(summed[k], int)


def _no_wall(cost):
    return {k: v for k, v in cost.items() if k != "kv_block_us"}


@pytest.mark.parametrize("layout", ["dense", "paged", "spec"])
def test_per_request_ledgers_equal_jax(weights, layout):
    """The same three rendered prompts drained by each package's batcher:
    equal tokens and equal ledgers (``kv_block_us`` is a wall, so only its
    sign is held), and the port's ledgers sum to its totals."""
    kw = dict(batch_slots=3, fast_forward=8)
    if layout == "spec":
        kw = dict(batch_slots=3, fast_forward=0)
    jkw, tkw = dict(kw), dict(kw)
    if layout == "spec":
        jkw["spec"] = JSpecConfig(k=4, drafter="fsm,prompt")
        tkw["spec"] = SpecConfig(k=4, drafter="fsm,prompt")
    jcls, tcls = (JDense, DecodeEngine) if layout == "dense" else (JPaged, PagedDecodeEngine)
    jeng, teng = _jax(weights, jcls, **jkw), _port(weights, tcls, **tkw)
    jres = JBatcher(jeng, chunk_steps=8, max_new_tokens=MAXTOK).generate_many(PROMPTS)
    tb = ContinuousBatcher(teng, chunk_steps=8, max_new_tokens=MAXTOK)
    tres = tb.generate_many(PROMPTS)
    for j, t in zip(jres, tres):
        assert t.token_ids == j.token_ids
        assert _no_wall(t.cost) == _no_wall(j.cost)
        assert t.cost["kv_block_us"] > 0
    _assert_conserved(tb, tres)
    t = tb.costs.totals
    assert t["prefill_cached_flops"] > 0  # the cached prompt prefix is priced
    if layout == "spec":
        assert 0 < t["wasted_draft_flops"] <= t["decode_flops"]
    else:
        assert t["wasted_draft_flops"] == 0


@pytest.mark.parametrize("tier", [None, "int8", "int4"])
def test_paged_mixed_batch_conservation(weights, tier):
    """ONE meter over radix warm hits, speculation, a chaos-poisoned row and
    a mid-decode cancel reconciles exactly; errored rows still bill what
    they spent."""
    eng = _port(weights, batch_slots=2, radix_enable=True, kv_quant=tier or "off",
                spec=SpecConfig(k=4, drafter="fsm,prompt"), fast_forward=0)
    b = ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=MAXTOK)
    assert b.costs is not None
    tok, P, seen = eng.tokenizer, len(eng.prefix_ids), []
    st = SessionTranscripts(tok)
    turns = []
    for text in ("search for wireless headphones", "open the second result"):
        prompt = st.prompt_for("sess", text, {})
        ids = tok.encode(prompt, bos=True) if isinstance(prompt, str) else list(prompt)
        r = b.generate_many([ids])[0]
        assert r.error is None, r.error
        turns.append(r)
        seen.append(r)
        st.record("sess", ids, r.token_ids)
    assert turns[0].cached_tokens == P and turns[1].cached_tokens > P
    assert turns[1].cost["prefill_cached_flops"] > turns[0].cost["prefill_cached_flops"] > 0
    chaos.configure("nan_logits@2")
    try:
        pois = b.generate_many([render_prompt("scroll down", {}), render_prompt("go back", {})])
    finally:
        chaos.reset()
    seen += pois
    assert pois[0].error is None and pois[1].error.startswith("poisoned: non-finite")
    assert pois[1].cost is not None and pois[1].cost["kv_block_us"] > 0
    rid = b.submit(render_prompt("search for mechanical keyboards", {}))
    b.step()
    assert b.cancel(rid, "client gone")
    b.run_until_done()
    seen.append(b.results[rid])
    assert "cancel" in seen[-1].error and seen[-1].cost["kv_block_us"] > 0
    _assert_conserved(b, seen)
    t = b.costs.totals
    assert eng.spec.stats()["accepted"] > 0
    assert 0 <= t["wasted_draft_flops"] <= t["decode_flops"] and t["kv_block_us"] > 0


def test_cost_off_token_identity_and_gauges(weights, monkeypatch):
    eng = _port(weights, batch_slots=3, fast_forward=8)
    on_b = ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=MAXTOK)
    on = on_b.generate_many(PROMPTS[:2])
    snap = get_metrics().snapshot()
    for g in ("engine.mfu", "engine.mbu", "engine.mfu_prefill"):
        assert snap["gauges"][g] > 0
    assert snap["counters"]["cost.decode_flops"] > 0 and snap["counters"]["cost.decode_bytes"] > 0
    assert on_b.costs.engine["chunks"] > 0 and on_b.costs.engine["weights_stream_bytes"] > 0
    monkeypatch.setenv("COST_ENABLE", "0")
    off_b = ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=MAXTOK)
    assert off_b.costs is None
    off = off_b.generate_many(PROMPTS[:2])
    assert [r.token_ids for r in on] == [r.token_ids for r in off]
    assert all(r.cost is not None for r in on) and all(r.cost is None for r in off)


def test_tenant_ledgers_sum_to_the_totals_under_preemption(weights, monkeypatch):
    """Under tenancy a preempted request's spent ledger folds into its
    tenant's at the preemption; the tenant ledgers sum to the totals."""
    monkeypatch.setenv("TENANT_CLASSES", "premium:4,free:1")
    eng = _port(weights, batch_slots=1, radix_enable=True)
    b = ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=48)
    r_free = b.submit(PROMPTS[0], tenant="free")
    b.step()
    b.submit(PROMPTS[1], tenant="premium")
    b.run_until_done()
    assert b.results[r_free].error is None
    led = b.tenancy.snapshot()
    assert led["lanes"]["free"]["preemptions"] == 1
    summed = zero_ledger()
    for ent in led["ledgers"].values():
        for k in LEDGER_KEYS:
            summed[k] += ent[k]
    assert summed == b.costs.totals
    assert led["ledgers"]["free"]["utterances"] == 2  # the preempted run and the resumed one


# ------------------------------------------------------------- surfaces

def _json_keys(obj, depth=2):
    if not isinstance(obj, dict) or depth == 0:
        return type(obj).__name__
    return {k: _json_keys(v, depth - 1) for k, v in obj.items()}


def test_brain_debug_costs_matches_the_jax_shape(weights, monkeypatch):
    """A stateless batched engine parser, two parses under one session id:
    ``/debug/costs`` has JAX's keys at two levels, integer totals, the
    session attributed (errored parses included)."""
    from tests.http_helper import AppServer
    from tpu_voice_agent.services.brain import BatchedEngineParser as JParser
    from tpu_voice_agent.services.brain import ParserError as JParserError
    from tpu_voice_agent.services.brain import build_app as j_build

    jeng = _jax(weights, JDense, batch_slots=2)
    jparser = JParser(jeng, chunk_steps=8, max_new_tokens=40)
    tparser = brain.BatchedEngineParser(_port(weights, DecodeEngine, batch_slots=2),
                                        chunk_steps=8, max_new_tokens=40)
    app = brain.BrainApp(tparser)
    try:
        for text in ("turn on the lights", "turn off the lights"):
            try:
                jparser.parse(text, {}, session_id="s1")
            except JParserError:
                pass
            app.parse(json.dumps({"text": text, "session_id": "s1"}).encode())
        with AppServer(j_build(jparser)) as srv:
            import urllib.request

            with urllib.request.urlopen(srv.url + "/debug/costs?top=4", timeout=10) as r:
                jbody = json.loads(r.read().decode())
        req = type("R", (), {"method": "GET", "path": "/debug/costs", "query": "top=4",
                             "headers": {}, "body": b""})()
        status, body, _ = app.handle(req)
    finally:
        jparser.close()
        tparser.close()
    assert status == 200
    for b in (body, jbody):
        b["peak"].pop("device")
        b["peak"].pop("source")
    assert _json_keys(body) == _json_keys(jbody)
    assert body["service"] == "brain" and body["enabled"]
    assert all(isinstance(v, int) for v in body["totals"].values())
    assert body["totals"] == {k: v for k, v in jbody["totals"].items()} or \
        _no_wall(body["totals"]) == _no_wall(jbody["totals"])
    top = body["top_sessions"]
    assert top[0]["session"] == "s1" and top[0]["utterances"] == 2
    assert (body["sessions"], jbody["sessions"]) == (1, 1)


def test_voice_debug_costs_carries_the_stt_share():
    from tpu_voice_agent_torch.services import voice
    from tpu_voice_agent_torch.serve.stt import NullSTT

    class FakeSTT:
        cost_totals = {"encoder_flops": 1000, "decoder_flops": 200, "encoded_frames": 300,
                       "decoded_tokens": 12}

    fake = FakeSTT()  # a strong ref: the registry is weak
    costmodel.register_stt_engine(fake)
    app = voice.build_app(voice.VoiceConfig(brain_url="http://127.0.0.1:1",
                                            executor_url="http://127.0.0.1:1",
                                            stt_factory=lambda: NullSTT()))
    import asyncio

    req = type("R", (), {"method": "GET", "path": "/debug/costs", "query": "",
                         "headers": {}, "body": b""})()
    resp = asyncio.run(app.http(req))
    assert resp.status == 200
    body = resp.body
    assert (body["service"], body["enabled"]) == ("voice", True)
    assert body["stt"]["encoder_flops"] >= 1000 and body["stt"]["engines"] >= 1
    assert set(body) == {"service", "enabled", "stt"}


def test_stt_cost_lanes_equal_jax():
    """One transcribe and one incremental feed + decode on both packages'
    engines (the same float32 weights): equal ``cost_totals``."""
    KWS = {"preset": "whisper-test", "frame_buckets": (100, 200), "max_new_tokens": 8}
    jeng = JSpeech(kernels="pallas", init_weights=False, **KWS)
    params = j_winit(jeng.cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    jeng.load_params(params)
    teng = SpeechEngine(init_weights=False, device="cpu", **KWS)
    teng.load_params(bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    t = np.arange(16_000) / 16_000
    audio = (0.2 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    for eng in (jeng, teng):
        eng.transcribe(audio)
        st = eng.incremental_feed(eng.incremental_init(), audio)
        eng.incremental_decode(st)
    assert teng.cost_totals == jeng.cost_totals
    assert teng.cost_totals["encoder_flops"] > 0 and teng.cost_totals["decoded_tokens"] > 0
    s = costmodel.stt_cost_summary()
    assert s is not None and s["engines"] >= 1


def test_flight_dump_carries_the_cost_snapshot(weights):
    eng = _port(weights, batch_slots=3, fast_forward=8)
    ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=MAXTOK).generate_many(PROMPTS[:1])
    rec = get_flight_recorder()
    rec.rearm()
    rec.trigger("test", "cost snapshot drill")
    dump = rec.frozen_dump()
    rec.rearm()
    assert dump["costs"] is not None and dump["costs"]["llm"]["totals"]["decode_flops"] > 0
