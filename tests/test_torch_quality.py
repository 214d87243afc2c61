"""The port's quality lanes held against the JAX package's, on the CPU.

- The pure parts on seeded numpy inputs: ``_conf_stats`` / ``_masked_conf``
  over real grammar states of the 619-token vocabulary and unconstrained at
  V 32000, B 1 and 8 (rows with one legal token, none, ties and all -inf):
  margin within 1e-5, entropy within 1e-4, the forced flag exact;
  ``conf_fold``, ``conf_summary``, ``repetition_score``, ``finalize_stt_ids``
  and ``wer`` equal to JAX's.
- Engine level: the distilled checkpoint's parses equal the recorded golden
  tokens, with a quality dict close to the live JAX engine's (the counts
  exact, the margins and entropy within 1e-3: ``ENGINE_TOL``); test-tiny at
  ff = 8, on the paged batched pool and under speculation, the same against
  JAX's on the same weights, and the tokens the same with the lanes
  on and off on both sides; both Whisper checkpoints' logprob lanes and
  repetition, full and incremental.
- ``SPEC_TRACE_SINK`` records equal to JAX's, and ``voicebench``'s neural
  mode on the CPU.

The JAX engines run their Pallas kernels in interpret mode, the path the
port's kernels mirror.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.grammar.intent_grammar import build_intent_fsm as j_build_fsm
from tpu_voice_agent.models import llama as jl
from tpu_voice_agent.models.llama import LlamaConfig
from tpu_voice_agent.models.whisper import WhisperConfig
from tpu_voice_agent.serve import DecodeEngine as JEngine
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve import engine as jengine
from tpu_voice_agent.serve import spec as jspec
from tpu_voice_agent.serve import stt as jstt
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.train import distill
from tpu_voice_agent.utils import quality as jq
from tpu_voice_agent_torch import bridge, distilled, voicebench, whisper_ckpt
from tpu_voice_agent_torch.evals import wer as twer
from tpu_voice_agent_torch.grammar import build_intent_fsm
from tpu_voice_agent_torch.serve import engine as tengine
from tpu_voice_agent_torch.serve import spec as tspec
from tpu_voice_agent_torch.serve import stt as tstt
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.utils import quality as tq

jwer = importlib.import_module("tpu_voice_agent.evals.wer")  # the package re-exports wer()
PROMPTS = ["search for usb hubs", "scroll down"]
MAXTOK = 48
KW = dict(preset="test-tiny", max_len=512, prefill_buckets=(64,))
QUALITY_TOL = 1e-4 + 1e-9  # a value rounded to 4 decimals, on the same logits
# Engine level the two sides' logits are not the same: they agree to the
# forward's fp32 tolerance per step, and the bf16 KV cache turns a last-ulp
# fp32 difference into a bf16 step now and then. A margin then moves by
# that much (4e-4 seen on a margin mean of 15.6, 5e-4 on one decision's
# margin_min), so the margin and entropy keys are held to 1e-3 there, and
# the counts (decisions, forced_frac) exactly
ENGINE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: intra-op threads buy nothing and contend under the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_quality_close(port: dict | None, ref: dict | None, what=""):
    assert (port is None) == (ref is None), (what, port, ref)
    if ref is None:
        return
    assert set(port) == set(ref), (what, port, ref)
    assert (port["decisions"], port["forced_frac"]) == (ref["decisions"], ref["forced_frac"])
    for k in ("margin_mean", "margin_min", "entropy_mean"):
        if ref[k] is None:
            assert port[k] is None, (what, k)
        else:
            assert abs(port[k] - ref[k]) <= ENGINE_TOL, (what, k, port[k], ref[k])


# ---------------------------------------------------------------- the lanes


@pytest.fixture(scope="module")
def tables():
    jfsm = j_build_fsm()[1]
    tfsm = build_intent_fsm()[1]
    return jfsm, jfsm.device_tables(), tfsm, tfsm.device_tables(device="cpu")


def _states(tfsm, B: int, rng) -> np.ndarray:
    """Real grammar states: one with a single legal token, one with many,
    a dead one (-1) first, then seeded draws."""
    legal = np.asarray(tfsm.mask).sum(axis=1)
    picks = [int(np.flatnonzero(legal == 1)[0]), int(np.argmax(legal)), -1]
    picks += list(rng.integers(0, tfsm.num_states, size=8))
    return np.asarray(picks[:B] if B < 3 else picks[:B], np.int32)


@pytest.mark.parametrize("B", [1, 8])
def test_conf_stats_equal_jax_on_real_grammar_states(tables, B):
    jfsm, jt, tfsm, tt = tables
    rng = np.random.default_rng(B)
    states = _states(tfsm, B, rng) if B > 1 else np.array([tfsm.start], np.int32)
    raw = rng.standard_normal((B, tfsm.vocab_size)).astype(np.float32) * 4
    if B > 1:
        raw[3] = 0.5  # a tie over every legal token: margin 0
        raw[4, ::3] = np.float32("-inf")  # -inf logits inside the legal set
    jm, je, jf = jengine._conf_stats(jnp.asarray(raw), jnp.asarray(states), jt, True, None)
    tm, te, tf = tengine._conf_stats(torch.from_numpy(raw), torch.from_numpy(states), tt, True)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    if B > 1:
        assert tf.numpy()[0] and tm.numpy()[0] == tengine.QUALITY_MARGIN_CAP  # one legal
        assert tm.numpy()[2] == 0 and te.numpy()[2] == 0 and tf.numpy()[2]  # dead state
        assert tm.numpy()[3] == 0  # the tie


@pytest.mark.parametrize("B", [1, 8])
def test_unconstrained_conf_equals_jax_at_32000(B):
    rng = np.random.default_rng(100 + B)
    V = 32000
    raw = rng.standard_normal((B, V)).astype(np.float32) * 3
    raw[:, rng.random(V) < 0.5] = np.float32("-inf")
    if B > 1:
        raw[1] = np.float32("-inf")  # all -inf: a dead row, no NaN
        raw[2] = np.float32("-inf")
        raw[2, 17] = 1.0  # one finite logit: the cap
        raw[3, :] = np.where(np.isfinite(raw[3]), 2.0, raw[3])  # ties
    states = np.zeros((B,), np.int32)
    jm, je, jf = jengine._conf_stats(jnp.asarray(raw), jnp.asarray(states), None, False, None)
    tm, te, tf = tengine._conf_stats(torch.from_numpy(raw), torch.from_numpy(states), None,
                                     False)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert np.isfinite(te.numpy()).all()
    if B > 1:
        assert (tm.numpy()[1], te.numpy()[1]) == (0, 0)
        assert tm.numpy()[2] == tengine.QUALITY_MARGIN_CAP and tf.numpy()[2]
        assert tm.numpy()[3] == 0


def test_conf_fold_and_summary_equal_jax():
    rng = np.random.default_rng(3)

    def lanes():
        return [rng.random(4).astype(np.float32) * 5, rng.random(4).astype(np.float32),
                rng.random(4).astype(np.float32), rng.integers(0, 5, 4), rng.integers(0, 9, 4)]

    chunks = [lanes() for _ in range(3)]
    chunks[1][4][2] = 0  # a row with no decision in one chunk
    ja = ta = None
    for c in chunks:
        ja, ta = jq.conf_fold(ja, c), tq.conf_fold(ta, c)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a, b)
    for row in range(4):
        for steps in (0, 7, 30):
            conf = [x[row] for x in ta]
            assert tq.conf_summary(conf, steps) == jq.conf_summary(conf, steps)
    none = (0.0, float("inf"), 0.0, 0, 0)
    assert tq.conf_summary(none, 5) is None and jq.conf_summary(none, 5) is None
    inf_min = (3.0, float("inf"), 1.0, 1, 2)
    assert tq.conf_summary(inf_min, 4) == jq.conf_summary(inf_min, 4)


@pytest.mark.parametrize("ids", [[], [5], [5, 5, 5, 5], [1, 2, 3, 2, 1], list(range(40))])
def test_repetition_and_finalize_stt_ids_equal_jax(ids):
    assert tq.repetition_score(ids) == jq.repetition_score(ids)
    conf = np.array([-3.25, -1.5, -0.125], np.float32)
    for lanes in (True, False):
        assert tstt.finalize_stt_ids(list(ids), conf, lanes) == jstt.finalize_stt_ids(
            list(ids), conf, lanes, final=True)
    no_min = np.array([-1.0, np.inf, -0.5], np.float32)
    assert tstt.finalize_stt_ids(list(ids), no_min, True) == jstt.finalize_stt_ids(
        list(ids), no_min, True, final=False)


@pytest.mark.parametrize("ref,hyp", [
    ("search for red shoes", "search for screenshot"), ("", ""), ("", "noise"),
    ("Scroll DOWN!", "scroll down"), ("go back now", "go back"),
    ("open the second result", "open a second results please"), ("it's fine", "its fine"),
])
def test_wer_equals_jax(ref, hyp, tmp_path):
    assert twer.normalize_words(ref) == jwer.normalize_words(ref)
    assert twer.wer(ref, hyp) == jwer.wer(ref, hyp)
    (tmp_path / "a.wav").write_bytes(b"")
    (tmp_path / "a.txt").write_text(ref)
    (tmp_path / "b.wav").write_bytes(b"")  # no reference: skipped
    assert twer.wer_over_dir(lambda p: hyp, tmp_path) == jwer.wer_over_dir(lambda p: hyp,
                                                                            tmp_path)


# ---------------------------------------------------------------- engines


def test_distilled_generate_is_golden_with_jax_quality():
    """The distilled checkpoint: tokens equal to the recorded golden parses,
    the quality dict within 1e-4 of the live JAX engine's (Pallas)."""
    cfg, params = distill.load_ckpt("checkpoints", distill.INTENT_CKPT, LlamaConfig)
    jeng = JEngine(cfg=dataclasses.replace(cfg, max_seq_len=512), max_len=512,
                   prefill_buckets=(64, 128), init_weights=False, kernels="pallas")
    jeng.load_params(jax.device_put(params))
    teng = distilled.intent_engine_from(*distilled.load_distilled(device="cpu"),
                                        device="cpu").engine
    assert teng.quality_lanes and jeng.quality_lanes
    for rec in distilled.golden_records()[:6]:
        prompt = distilled.distilled_prompt(rec["text"], rec["context"])
        j = jeng.generate(prompt, max_new_tokens=300)
        t = teng.generate(prompt, max_new_tokens=300)
        assert t.token_ids == rec["token_ids"] == j.token_ids, rec["text"]
        assert t.quality["decisions"] > 0
        assert_quality_close(t.quality, j.quality, rec["text"])


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def weights():
    cfg = JEngine(init_weights=False, **KW).cfg
    return _f32(jl.init_params(cfg, jax.random.PRNGKey(11), dtype=jnp.float32))


def _jax(weights, cls=JEngine, **kw):
    eng = cls(kernels="pallas", init_weights=False, **{**KW, **kw})
    eng.load_params(jax.device_put(weights))
    return eng


def _port(weights, cls=DecodeEngine, **kw):
    eng = cls(device="cpu", init_weights=False, **{**KW, **kw})
    eng.load_params(bridge.params_from_numpy(weights))
    return eng


def _run(eng, batched: bool, jax_side: bool):
    if batched:
        cls = JBatcher if jax_side else ContinuousBatcher
        return cls(eng, chunk_steps=8, max_new_tokens=MAXTOK).generate_many(PROMPTS)
    return [eng.generate(p, max_new_tokens=MAXTOK) for p in PROMPTS]


@pytest.mark.parametrize("plane", ["ff8", "paged", "spec"])
def test_test_tiny_quality_equals_jax_and_lanes_never_change_tokens(weights, plane):
    """test-tiny at fast-forward 8 (the chain tokens counted forced), on the
    paged pool behind the batcher, and under speculation (the verify
    step's lanes): the quality dicts within 1e-4 of JAX's; lanes off gives
    the same tokens and ``quality`` None, on both sides."""
    if plane == "ff8":
        kw, batched = dict(fast_forward=8), False
        jeng, teng = _jax(weights, **kw), _port(weights, **kw)
    elif plane == "paged":
        kw, batched = dict(batch_slots=2, block_size=16, radix_enable=False), True
        jeng = _jax(weights, cls=JPaged, **kw)
        teng = _port(weights, cls=PagedDecodeEngine, kv_quant="off", **kw)
    else:
        batched = False
        jeng = _jax(weights, spec=jspec.SpecConfig(k=4, drafter="fsm,prompt"))
        teng = _port(weights, spec=tspec.SpecConfig(k=4, drafter="fsm,prompt"))
    runs = {}
    for lanes in (True, False):
        jeng.quality_lanes = teng.quality_lanes = lanes
        if jeng.spec is not None:
            jeng.spec.quality_lanes = teng.spec.quality_lanes = lanes
        runs[lanes] = (_run(jeng, batched, True), _run(teng, batched, False))
    (jon, ton), (joff, toff) = runs[True], runs[False]
    for jr, tr, jr0, tr0 in zip(jon, ton, joff, toff):
        assert tr.token_ids == jr.token_ids == tr0.token_ids == jr0.token_ids
        assert tr0.quality is None and jr0.quality is None
        assert tr.quality is not None
        assert_quality_close(tr.quality, jr.quality, plane)
    if plane == "ff8":
        assert any(r.quality["forced_frac"] > 0 for r in ton)


@pytest.fixture(scope="module", params=whisper_ckpt.CHECKPOINTS)
def speech_pair(request):
    name = request.param
    cfg, params = distill.load_ckpt("checkpoints", name, WhisperConfig)
    jeng = jstt.SpeechEngine(cfg=cfg, frame_buckets=(cfg.max_audio_frames,), max_new_tokens=48,
                             init_weights=False, kernels="pallas")
    jeng.load_params(jax.device_put(params))
    teng = whisper_ckpt.whisper_engine_from(*whisper_ckpt.load_whisper(name, device="cpu"),
                                            device="cpu")
    return name, jeng, teng


LANES = ("logp_mean", "logp_min", "logp_first", "repetition")


def _lanes_close(t, j, what):
    for k in LANES:
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), (what, k)
        if b is not None:
            assert abs(a - b) <= QUALITY_TOL, (what, k, a, b)


def test_stt_lanes_equal_jax_full_and_incremental(speech_pair):
    name, jeng, teng = speech_pair
    for text in whisper_ckpt.WHISPER_EVAL_TEXTS[:3]:
        audio = whisper_ckpt.render_speech(text)
        j, t = jeng.transcribe(audio), teng.transcribe(audio)
        assert t.text == j.text, (name, text)
        _lanes_close(t, j, (name, text))
        assert t.logp_min <= t.logp_mean <= 0
    audio = whisper_ckpt.render_speech(whisper_ckpt.WHISPER_EVAL_TEXTS[0])
    js, ts = jeng.incremental_init(), teng.incremental_init()
    js, ts = jeng.incremental_feed(js, audio), teng.incremental_feed(ts, audio)
    j, t = jeng.incremental_decode(js), teng.incremental_decode(ts)
    assert t.text == j.text
    _lanes_close(t, j, (name, "incremental"))
    teng.quality_lanes = False
    try:
        off = teng.transcribe(audio)
    finally:
        teng.quality_lanes = True
    assert off.text == teng.transcribe(audio).text
    assert (off.logp_mean, off.logp_min, off.logp_first) == (None, None, None)
    assert off.repetition is not None  # host-side, lanes or not


def test_spec_trace_sink_records_equal_jax(weights, tmp_path):
    """One JSONL record per cleanly released speculative request, JAX's
    fields and values."""
    paths = {side: tmp_path / f"{side}.jsonl" for side in ("jax", "port")}
    jeng = _jax(weights, batch_slots=2,
                spec=jspec.SpecConfig(k=4, drafter="fsm,prompt", trace_sink=str(paths["jax"])))
    teng = _port(weights, batch_slots=2,
                 spec=tspec.SpecConfig(k=4, drafter="fsm,prompt", trace_sink=str(paths["port"])))
    _run(jeng, True, True)
    _run(teng, True, False)
    recs = {side: [json.loads(x) for x in p.read_text().splitlines()]
            for side, p in paths.items()}
    assert len(recs["port"]) == len(PROMPTS)
    key = lambda r: r["prompt_ids"]  # noqa: E731 - release order may differ
    assert sorted(recs["port"], key=key) == sorted(recs["jax"], key=key)
    assert set(recs["port"][0]) == {"plane", "drafter", "k", "prompt_ids", "generated_ids",
                                    "drafted", "accepted", "verify_steps"}


def test_neural_voicebench_reads_the_eval_texts():
    """``voicebench``'s neural mode on the CPU: the trained pair, five runs,
    a WER per run; whisper-tiny-heldout reads the first two texts exactly."""
    parser, stt_engine, name = voicebench.make_neural_engines(device="cpu")
    assert name == "whisper-tiny-heldout"
    r = voicebench.run_neural_voice_bench(parser, stt_engine, runs=5)
    assert r["references"] == whisper_ckpt.WHISPER_EVAL_TEXTS[:5]
    assert r["finals"][:2] == r["references"][:2] and r["wer"][:2] == [0.0, 0.0]
    assert len(r["wer"]) == 5 and 0 <= r["wer_mean"] < 1
    assert r["p50_ms"] > 0 and r["p95_ms"] >= r["p50_ms"]
