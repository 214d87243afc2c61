"""The port's checkpoint constructors against the JAX package's, on one
HF directory.

``DecodeEngine.from_hf`` (fast-forward 8 and 0), ``PagedDecodeEngine.from_hf``
behind the continuous batcher and ``SpeechEngine.from_hf`` read the same small
directory as the JAX package's ``from_hf``; in float32 their greedy tokens
and transcripts must be identical. The checkpoint's vocab is the tokenizer's
plus 8 padded ids, as real embedding tables are, so the intent FSM runs at
the config's width with the padded ids dead. Then the services:
``BRAIN_MODEL=<dir>`` boots the port's brain (dense, and paged at ff 0, the
JAX branch's engine, with ``BRAIN_FF`` unset or set and logged as ignored)
and ``VOICE_STT=whisper-hf:<dir>``
its voice STT, on the CPU, answering as the JAX services do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_hf_helper import write_llama_checkpoint, write_whisper_checkpoint
from tpu_voice_agent.serve import DecodeEngine as JDense
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.serve.stt import SpeechEngine as JSpeech
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent_torch.serve.engine import DecodeEngine, checkpoint_tokenizer
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.serve.stt import SpeechEngine
from tpu_voice_agent_torch.serve.stt_batch import STTBatcher
from tpu_voice_agent_torch.services.brain import install_prompt_prefix
from tpu_voice_agent_torch.whisper_ckpt import render_speech


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs in six worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPTS = [("search for wireless headphones", {}),
           ("open the second result", {"last_query": "wireless headphones"})]
KW = dict(max_len=2048, prefill_buckets=(512, 1024, 2048))


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_llama")
    write_llama_checkpoint(d)
    return d


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_whisper")
    write_whisper_checkpoint(d)
    return d


@pytest.mark.parametrize("ff", [8, 0])
def test_dense_from_hf_matches_jax(llama_dir, ff):
    jeng = JDense.from_hf(str(llama_dir), dtype=jnp.float32, fast_forward=ff, **KW)
    teng = DecodeEngine.from_hf(str(llama_dir), dtype=torch.float32, fast_forward=ff,
                                device="cpu", **KW)
    assert teng.cfg.vocab_size == teng.tokenizer.vocab_size + 8 == jeng.cfg.vocab_size
    assert (teng.eos_id, teng.pad_id) == (jeng.eos_id, jeng.pad_id)
    assert teng.eos_id == teng.tokenizer.id_of("<|end_of_text|>")
    assert np.array_equal(teng.fsm.table, jeng.fsm.table)
    assert not teng.fsm.allowed(teng.fsm.start)[teng.tokenizer.vocab_size:].any()
    assert teng.tables.dense_mask is not None  # a small vocab keeps K4's mask
    assert j_install(jeng) == install_prompt_prefix(teng) > 100
    for text, ctx in PROMPTS:
        prompt = render_prompt(text, ctx)
        jres = jeng.generate(prompt, max_new_tokens=40)
        tres = teng.generate(prompt, max_new_tokens=40)
        assert tres.token_ids == jres.token_ids
        assert (tres.steps, tres.finished, tres.text) == (jres.steps, jres.finished, jres.text)
        assert teng.fsm.walk(tres.token_ids) >= 0


def test_dense_from_hf_on_the_compressed_tail(llama_dir):
    """With the dense mask dropped (as at a checkpoint vocab, where S·V is
    past 2^25) the greedy picks take the compressed two-gather row and
    decode the dense-mask engine's tokens."""
    eng = DecodeEngine.from_hf(str(llama_dir), dtype=torch.float32, fast_forward=8,
                               device="cpu", **KW)
    prompt = render_prompt("scroll down", {})
    want = eng.generate(prompt, max_new_tokens=24).token_ids
    eng.tables = eng.tables._replace(dense_mask=None)
    eng.tables_ff = eng.tables_ff._replace(dense_mask=None)
    assert eng.generate(prompt, max_new_tokens=24).token_ids == want


def test_paged_from_hf_matches_jax(llama_dir):
    """Classmethod polymorphism: the paged engine loads through the same
    loader, ``pool_blocks`` passing through; batched tokens equal JAX's."""
    jeng = JPaged.from_hf(str(llama_dir), dtype=jnp.float32, batch_slots=2, pool_blocks=40,
                          **KW)
    teng = PagedDecodeEngine.from_hf(str(llama_dir), dtype=torch.float32, batch_slots=2,
                                     pool_blocks=40, device="cpu", **KW)
    assert teng.allocator.n_blocks == jeng.allocator.n_blocks == 40
    assert j_install(jeng) == install_prompt_prefix(teng)
    prompts = [render_prompt(t, c) for t, c in PROMPTS]
    jres = JBatcher(jeng, chunk_steps=16, max_new_tokens=40).generate_many(prompts)
    tres = ContinuousBatcher(teng, chunk_steps=16, max_new_tokens=40).generate_many(prompts)
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
    assert all(r.error is None and teng.fsm.walk(r.token_ids) >= 0 for r in tres)


def test_int8_from_hf_quantizes_per_layer(llama_dir):
    from tpu_voice_agent_torch import bridge
    from tpu_voice_agent_torch.ckpt.hf_import import llama_config_from_hf, llama_from_hf_state
    from tpu_voice_agent_torch.models.llama import quantize_params

    eng = DecodeEngine.from_hf(str(llama_dir), quant="int8", device="cpu", **KW)
    assert eng.params["lm_head"]["q"].dtype == torch.int8
    want = quantize_params(llama_from_hf_state(str(llama_dir), llama_config_from_hf(llama_dir)))
    got = {**eng.params, "layers": {k: torch.stack([layer[k] for layer in eng.params["layers"]])
                                    for k in eng.params["layers"][0] if k[0] != "w"}}
    for k in ("embed", "final_norm"):
        assert torch.equal(eng.params[k], want[k])
    for k, v in bridge.flatten({"lm_head": want["lm_head"]}).items():
        assert torch.equal(bridge.flatten({"lm_head": eng.params["lm_head"]})[k], v)
    for i, layer in enumerate(eng.params["layers"]):
        for k in ("wq", "w_down"):
            assert torch.equal(layer[k]["q"], want["layers"][k]["q"][i])
            assert torch.equal(layer[k]["s"], want["layers"][k]["s"][i])
    assert got["layers"]["attn_norm"].shape[0] == 2
    res = eng.generate(render_prompt("go back", {}), max_new_tokens=12)
    assert res.error is None and eng.fsm.walk(res.token_ids) >= 0


def test_checkpoint_tokenizer_is_shared_by_content(llama_dir, tmp_path):
    (tmp_path / "tokenizer.json").write_bytes((llama_dir / "tokenizer.json").read_bytes())
    assert checkpoint_tokenizer(str(tmp_path)) is checkpoint_tokenizer(str(llama_dir))


def test_from_hf_refuses_a_model_vocab_below_the_tokenizer(llama_dir):
    from dataclasses import replace

    from tpu_voice_agent_torch.ckpt.hf_import import llama_config_from_hf

    tok = checkpoint_tokenizer(str(llama_dir))
    cfg = replace(llama_config_from_hf(llama_dir), vocab_size=tok.vocab_size - 1)
    with pytest.raises(ValueError, match="model vocab .* < tokenizer vocab"):
        DecodeEngine(cfg=cfg, tokenizer=tok, init_weights=False, device="cpu", **KW)


# ---------------------------------------------------------------- whisper


def _audio(seed: int, seconds: float = 1.0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.1, int(16000 * seconds)).astype(np.float32)


SPEECH_KW = dict(frame_buckets=(100, 200), max_new_tokens=12)


@pytest.fixture(scope="module")
def speech_engines(whisper_dir):
    jeng = JSpeech.from_hf(str(whisper_dir), dtype=jnp.float32, **SPEECH_KW)
    teng = SpeechEngine.from_hf(str(whisper_dir), dtype=torch.float32, device="cpu",
                                **SPEECH_KW)
    return jeng, teng


def test_speech_from_hf_prompt_and_suppress_equal_jax(speech_engines):
    jeng, teng = speech_engines
    tok = teng.tokenizer
    assert teng.bos_ids == jeng.bos_ids == tuple(
        tok.id_of(c) for c in ("<|startoftranscript|>", "<|en|>", "<|transcribe|>",
                               "<|notimestamps|>"))
    assert teng.eos_id == jeng.eos_id == tok.id_of("<|endoftext|>")
    assert np.array_equal(teng.suppress.numpy(), np.asarray(jeng.suppress))
    assert teng.suppress[tok.id_of("<|0.00|>")] and not teng.suppress[teng.eos_id]


@pytest.mark.parametrize("seed", [0, 1])
def test_speech_from_hf_transcripts_equal_jax(speech_engines, seed):
    jeng, teng = speech_engines
    audio = _audio(seed)
    jres, tres = jeng.transcribe(audio), teng.transcribe(audio)
    # JAX's result carries the text and the lanes (its ids stay inside)
    assert tres.text == jres.text and tres.token_ids
    assert tres.repetition == jres.repetition
    assert tres.logp_mean == pytest.approx(jres.logp_mean, abs=1e-3)
    assert not set(tres.token_ids) & teng.tokenizer.special_ids


def test_suppress_is_what_keeps_the_control_tokens_out(speech_engines):
    """The control rows are loud in this checkpoint: with the mask lifted
    greedy decode emits them, with it (both planes) never."""
    _, teng = speech_engines
    audio = _audio(2)
    special = teng.tokenizer.special_ids - {teng.eos_id}
    sup = teng.suppress
    teng.suppress = None
    try:
        assert set(teng.transcribe(audio).token_ids) & special
    finally:
        teng.suppress = sup
    b = STTBatcher(teng, slots=2)
    try:
        futs = [b.submit("final", 7000 + i, _audio(2 + i)) for i in range(2)]
        batched = [f.result(timeout=120).token_ids for f in futs]
    finally:
        b.stop()
    assert batched[0] == teng.transcribe(audio).token_ids
    assert not any(set(ids) & special for ids in batched)


# ---------------------------------------------------------------- services


def _brain_env(monkeypatch, llama_dir, **env):
    for k in ("BRAIN_BACKEND", "BRAIN_QUANT", "BRAIN_MOE", "BRAIN_PREFIX", "BRAIN_CHUNK",
              "BRAIN_FF", "BRAIN_PAGED", "BRAIN_BATCH", "BRAIN_POOL_BLOCKS", "SPEC_ENABLE",
              "RADIX_ENABLE", "KV_QUANT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BRAIN_MODEL", str(llama_dir))
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _outcome(parse, text):
    """(response dict, None) or (None, (code, detail))."""
    try:
        resp = parse(text, {})
    except Exception as e:  # noqa: BLE001 - both packages' ParserError
        return None, (getattr(e, "code", type(e).__name__), str(getattr(e, "detail", e)))
    return (resp if isinstance(resp, dict) else resp.model_dump(mode="json")), None


PAGED_ENV = {"BRAIN_PAGED": "1", "BRAIN_BATCH": "2", "BRAIN_POOL_BLOCKS": "40"}


# the paged brain at the default env (no BRAIN_FF) and with BRAIN_FF=8 set:
# both JAX's ff 0 engine, the knob logged as ignored
@pytest.mark.parametrize("env", [{}, PAGED_ENV, {**PAGED_ENV, "BRAIN_FF": "8"}])
def test_brain_model_boots_and_answers_as_jax(monkeypatch, caplog, llama_dir, env):
    import logging

    from tpu_voice_agent.services import brain as jbrain
    from tpu_voice_agent_torch.services import brain

    _brain_env(monkeypatch, llama_dir, **env)
    # both services load float32 (their default is bf16, where XLA's CPU
    # products and the plain versions round apart): the plumbing is held
    # here, the bf16 kernels on the card
    for cls, dt in ((JDense, jnp.float32), (DecodeEngine, torch.float32)):
        monkeypatch.setattr(cls, "from_hf", classmethod(
            lambda c, *a, _f=cls.from_hf.__func__, _dt=dt, **k: _f(c, *a, dtype=_dt, **k)))
    with caplog.at_level(logging.WARNING, logger="tpu_voice_agent_torch.brain"):
        tparser = brain.make_parser_from_env()
    ignored = "BRAIN_FF is ignored by the paged BRAIN_MODEL engine (ff 0, as in the JAX service)"
    assert (ignored in [r.getMessage() for r in caplog.records]) == ("BRAIN_FF" in env)
    jparser = jbrain.make_parser_from_env()
    try:
        eng = tparser.engine
        assert isinstance(eng, PagedDecodeEngine if env else DecodeEngine)
        assert eng.cfg.vocab_size == eng.tokenizer.vocab_size + 8
        assert eng.fast_forward == (0 if env else 8)
        assert eng.params["embed"].dtype == torch.float32
        assert len(eng.prefix_ids) == len(jparser.engine.prefix_ids) > 100
        for text in ("go back", "search for red shoes"):
            assert _outcome(tparser.parse, text) == _outcome(jparser.parse, text)
        status, body, _ = brain.BrainApp(tparser).health()
        assert status == 200 and body["ok"]
    finally:
        for p in (tparser, jparser):
            getattr(p, "close", lambda: None)()


def test_brain_model_quant_and_moe_knobs_reach_the_engine(monkeypatch, tmp_path):
    from tpu_voice_agent_torch.services import brain

    d = tmp_path / "mixtral"
    write_llama_checkpoint(d, experts=4)
    _brain_env(monkeypatch, d, BRAIN_QUANT="int8", BRAIN_MOE="grouped", BRAIN_PREFIX="0")
    eng = brain.make_parser_from_env().engine
    assert (eng.quant, eng.cfg.n_experts, eng.cfg.moe_impl, eng.fast_forward) == (
        "int8", 4, "grouped", 8)
    assert eng.params["layers"][0]["moe_gate"]["q"].dtype == torch.int8
    res = eng.generate(render_prompt("go back", {}), max_new_tokens=8)
    assert res.error is None and eng.fsm.walk(res.token_ids) >= 0


def test_whisper_hf_voice_stt_answers_as_jax(monkeypatch, whisper_dir):
    """The voice service's STT factory on ``whisper-hf:<dir>`` (locked and
    batched planes) streams the events the JAX factory streams."""
    from tpu_voice_agent.services import voice as jvoice
    from tpu_voice_agent_torch.services import voice

    monkeypatch.setenv("VOICE_STT", f"whisper-hf:{whisper_dir}")
    monkeypatch.setenv("VOICE_DEVICE", "cpu")
    for k in ("STT_BATCH_ENABLE", "STT_REPLICAS"):
        monkeypatch.delenv(k, raising=False)
    audio = np.concatenate([0.3 * render_speech("go back"), np.zeros(16000, np.float32)])
    frames = [audio[i:i + 960] for i in range(0, len(audio), 960)]
    tstt, jstt = voice.stt_factory_from_env()(), jvoice.stt_factory_from_env()()
    assert tstt.engine.bos_ids == jstt.engine.bos_ids and tstt.engine.suppress is not None
    t_events = [e for f in frames for e in tstt.feed(f)]
    j_events = [e for f in frames for e in jstt.feed(f)]
    assert [k for k, _ in t_events] == [k for k, _ in j_events]
    assert "final" in [k for k, _ in t_events]
    assert all("<|" not in text for _, text in t_events)
    monkeypatch.setenv("STT_BATCH_ENABLE", "1")
    monkeypatch.setenv("STT_BATCH_SLOTS", "2")
    bstt = voice.stt_factory_from_env()()
    try:
        b_events = [e for f in frames for e in bstt.feed(f)]
        assert "final" in [k for k, _ in b_events]
        assert all("<|" not in text for _, text in b_events)
    finally:
        getattr(bstt, "close", lambda: None)()
