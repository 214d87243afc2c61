"""The pp x tp engine and the ``pp`` brain backend against the JAX package.

JAX's ``test_pipeline.py::TestPPDecodeEngine`` (at test-tiny and a short
token budget), ``test_fastforward.py::test_batched_ff_pp_matches_dense``,
``test_spec.py::test_spec_accepted_on_paged_refused_on_pp`` and
``test_brain.py::test_make_parser_env_routes_pp_backend`` on
``serve/pp_engine.py``: float32 weights from JAX's init, shared as numpy,
drive JAX's ``PPDecodeEngine`` on its 8 virtual CPU devices and the port's
on a one-process mesh of CPU devices behind each package's continuous
batcher; the tokens must be identical to each other and to JAX's dense
engine on its XLA path, the comparison JAX's tests make (float32 keeps
greedy picks clear of the tp sums' reordering). Both pp engines attend with
the plain full-mask attention, as that path does; the dense engines' kernels
compute the same attention in another order, which at a near-tie can pick
another token (JAX's own Pallas dense engine parts from its XLA one on the
first case's second prompt).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models.llama import init_params as j_init
from tpu_voice_agent.parallel.pipeline import pp_tp_mesh as j_pp_tp_mesh
from tpu_voice_agent.serve import DecodeEngine as JDense
from tpu_voice_agent.serve import PPDecodeEngine as JPP
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.serve.spec import SpecConfig as JSpec
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.models.llama import PRESETS, LlamaConfig, quantize_params
from tpu_voice_agent_torch.parallel.pipeline import pp_tp_mesh, stage_params
from tpu_voice_agent_torch.serve.pp_engine import PPDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.serve.spec import SpecConfig
from tpu_voice_agent_torch.services import brain
from tpu_voice_agent_torch.utils.tracing import get_metrics

CPU = torch.device("cpu")
KW = dict(max_len=1024, batch_slots=2, prefill_buckets=(512, 1024), init_weights=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(pp, tp):
    return pp_tp_mesh(pp, tp, [CPU] * (pp * tp))


def _engines(seed, **kw):
    """(JAX pp 2 x 2, port pp 2 x 2, JAX dense on XLA) on one float32
    weight set."""
    jpp = JPP(preset="test-tiny", mesh=j_pp_tp_mesh(2, 2), **KW, **kw)
    raw = j_init(jpp.cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    jpp.load_params(raw)
    dense = JDense(preset="test-tiny", kernels="xla", **KW, **kw)
    dense.load_params(raw)
    tpp = PPDecodeEngine(preset="test-tiny", mesh=_mesh(2, 2), **KW, **kw)
    tpp.load_params(bridge.params_from_numpy(jax.tree.map(np.asarray, raw)))
    return jpp, tpp, dense


def _run(eng, prompts, chunk=16, max_new=60):
    Batcher = JBatcher if isinstance(eng, (JPP, JDense)) else ContinuousBatcher
    return Batcher(eng, chunk_steps=chunk, max_new_tokens=max_new).generate_many(prompts)


def test_batcher_output_token_identical_to_jax_and_dense():
    jpp, tpp, dense = _engines(11)
    prompts = [render_prompt("search for mechanical keyboards", {}),
               render_prompt("go back", {"last_query": "keyboards"})]
    for j, t, d in zip(_run(jpp, prompts), _run(tpp, prompts), _run(dense, prompts)):
        assert j.error is None and t.error is None
        assert tpp.fsm.walk(t.token_ids) >= 0
        assert t.token_ids == j.token_ids == d.token_ids


def test_pp_prefix_cache_matches_jax_and_dense():
    jpp, tpp, dense = _engines(13)
    assert j_install(jpp) == brain.install_prompt_prefix(tpp) == j_install(dense) > 0
    prompts = [render_prompt("filter under two hundred dollars", {}),
               render_prompt("take a screenshot", {"last_query": "filters"})]
    for j, t, d in zip(_run(jpp, prompts), _run(tpp, prompts), _run(dense, prompts)):
        assert t.error is None and t.cached_tokens == d.cached_tokens > 0
        assert t.token_ids == j.token_ids == d.token_ids


def test_batched_ff_pp_matches_jax_and_dense():
    """ff 8 on the pipeline layout: the (B, 1 + W) step goes through the
    same pipeline forward; the tokens equal JAX's ff'd pp engine's and the
    dense engine's, and the rows multi-emit (fewer forwards than tokens)."""
    jpp, tpp, dense = _engines(21, fast_forward=8)
    prompts = [render_prompt("search for mechanical keyboards", {}),
               render_prompt("take a screenshot", {"last_query": "keyboards"})]
    jr, dr = _run(jpp, prompts, chunk=8), _run(dense, prompts, chunk=8)
    m0 = get_metrics().snapshot()["counters"]
    tr = _run(tpp, prompts, chunk=8)
    m1 = get_metrics().snapshot()["counters"]
    toks = m1.get("scheduler.tokens_generated", 0) - m0.get("scheduler.tokens_generated", 0)
    for j, t, d in zip(jr, tr, dr):
        assert t.error is None and t.token_ids == j.token_ids == d.token_ids
    assert sum(r.forwards for r in tr) < toks == sum(r.steps for r in tr)


def test_pp_generate_and_spec_are_refused_as_in_jax():
    eng = PPDecodeEngine(preset="test-tiny", mesh=_mesh(2, 1), max_len=512,
                         prefill_buckets=(256,))
    with pytest.raises(ValueError, match="batcher"):
        eng.generate("x")
    with pytest.raises(ValueError, match="batcher"):
        eng.generate_stepwise("x")
    with pytest.raises(ValueError, match="not supported on the pp layout") as e:
        PPDecodeEngine(preset="test-tiny", max_len=512, prefill_buckets=(64,),
                       mesh=_mesh(1, 1), init_weights=False, spec=SpecConfig(k=4))
    with pytest.raises(ValueError) as ej:
        JPP(preset="test-tiny", max_len=512, prefill_buckets=(64,), mesh=j_pp_tp_mesh(1, 1),
            init_weights=False, spec=JSpec(k=4))
    assert str(e.value) == str(ej.value)


@pytest.mark.parametrize("cfg,pp,tp", [
    (dict(PRESETS["test-tiny"].__dict__, n_layers=3), 2, 1),
    (dict(PRESETS["test-tiny"].__dict__, n_kv_heads=1, n_heads=3, dim=96), 1, 2),
    (dict(PRESETS["test-tiny"].__dict__, ffn_dim=255), 1, 2),
    (dict(PRESETS["mixtral-test"].__dict__), 1, 1),
], ids=["layers", "heads", "ffn", "moe"])
def test_pp_engine_refusals_equal_jax(cfg, pp, tp):
    from tpu_voice_agent.models.llama import LlamaConfig as JConfig

    with pytest.raises(ValueError) as e:
        PPDecodeEngine(cfg=LlamaConfig(**cfg), mesh=_mesh(pp, tp), init_weights=False)
    with pytest.raises(ValueError) as ej:
        JPP(cfg=JConfig(**cfg), mesh=j_pp_tp_mesh(pp, tp), init_weights=False)
    assert str(e.value) == str(ej.value)
    with pytest.raises(ValueError, match="'pp' axis"):
        PPDecodeEngine(preset="test-tiny", mesh=None, init_weights=False)


def test_int8_load_quantizes_per_leaf_onto_staged_shards():
    eng = PPDecodeEngine(preset="test-tiny", mesh=_mesh(2, 2), quant="int8", **KW)
    raw = bridge.params_from_numpy(jax.tree.map(
        np.asarray, j_init(eng.cfg, jax.random.PRNGKey(3), dtype=jnp.float32)))
    eng.load_params(raw)
    want = stage_params(quantize_params(raw)["layers"], 2)
    for name in ("wq", "wo", "w_down"):
        leaf = eng.params["staged"][name]
        assert leaf["q"].dtype == torch.int8
        assert torch.equal(leaf["q"].full(), want[name]["q"])
        assert torch.equal(leaf["s"].full(), want[name]["s"])
    assert eng.params["staged"]["wq"]["s"].spec == ("pp", None, None, "tp")
    assert eng.params["staged"]["wo"]["s"].spec == ("pp", None, None, None)
    res = _run(eng, [render_prompt("go back", {})], max_new=12)[0]
    assert res.error is None and eng.fsm.walk(res.token_ids) >= 0


def _pp_env(monkeypatch, **env):
    for knob in ("BRAIN_MODEL", "BRAIN_QUANT", "BRAIN_MOE", "BRAIN_PAGED", "BRAIN_PREFIX",
                 "BRAIN_CHUNK", "BRAIN_FF", "BRAIN_PP", "BRAIN_TP", "SPEC_ENABLE",
                 "BRAIN_BATCH", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_make_parser_env_routes_pp_backend(monkeypatch):
    """``BRAIN_BACKEND=pp:test-tiny`` with ``BRAIN_PP`` / ``BRAIN_TP`` 2 x 2
    over four CPU devices (the brain's device list patched), then the
    defaults: pp = min(2, n), tp = n // pp, ff 0 unless ``BRAIN_FF``."""
    _pp_env(monkeypatch, BRAIN_BACKEND="pp:test-tiny", BRAIN_PP="2", BRAIN_TP="2",
            BRAIN_BATCH="2", BRAIN_PREFIX="0")
    monkeypatch.setattr(brain, "brain_devices", lambda device=None: [CPU] * 4)
    parser = brain.make_parser_from_env()
    try:
        assert isinstance(parser.engine, PPDecodeEngine)
        assert (parser.engine.pp, parser.engine.tp, parser.engine.fast_forward) == (2, 2, 0)
        try:
            assert parser.parse("go back", {})["version"] == "1.0"
        except brain.ParserError as e:
            # random weights may ramble to the budget: the 422 truncation
            assert e.kind == "schema_validation_failed"
    finally:
        parser.close()
    monkeypatch.delenv("BRAIN_PP")
    monkeypatch.delenv("BRAIN_TP")
    monkeypatch.setenv("BRAIN_FF", "8")
    built = []
    monkeypatch.setattr(PPDecodeEngine, "__init__",
                        lambda self, **kw: built.append(kw) or (_ for _ in ()).throw(
                            RuntimeError("stub")))
    with pytest.raises(RuntimeError, match="stub"):
        brain.make_parser_from_env()
    assert built[0]["mesh"].shape == {"pp": 2, "tp": 2}
    assert built[0]["fast_forward"] == 8


def test_pp_backend_boots_on_the_cpu_and_answers_parse(monkeypatch):
    _pp_env(monkeypatch, BRAIN_BACKEND="pp:test-tiny")
    parser = brain.make_parser_from_env()
    try:
        assert (parser.engine.pp, parser.engine.tp) == (1, 1)
        app = brain.BrainApp(parser)
        status, body, _ = app.parse(json.dumps({"text": "go back", "context": {}}).encode())
        assert status in (200, 422), body
        if status == 422:
            assert body["error"] == "schema_validation_failed"
        code, health, _ = app.health()
        assert code == 200 and health["batch_slots"] == 1 and health["prefix_tokens"] > 0
    finally:
        parser.close()


@pytest.mark.parametrize("env,want", [
    ({"BRAIN_PP": "2"}, "BRAIN_PP=2 x BRAIN_TP=1 needs 2 devices, have 1"),
    ({"BRAIN_PP": "1", "BRAIN_TP": "2"}, "BRAIN_PP=1 x BRAIN_TP=2 needs 2 devices, have 1"),
    ({"SPEC_ENABLE": "1"}, "not supported on the pp layout"),
    ({"BRAIN_PP": "two"}, "BRAIN_PP='two': not a int"),
])
def test_pp_backend_refusals_at_boot(monkeypatch, env, want):
    _pp_env(monkeypatch, BRAIN_BACKEND="pp:test-tiny", **env)
    with pytest.raises(ValueError) as e:
        brain.make_parser_from_env()
    assert want in str(e.value)
