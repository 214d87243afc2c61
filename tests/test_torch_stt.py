"""The port's speech engine and streaming wrapper against the JAX package's.

Both ``SpeechEngine``s run ``whisper-test`` on the same float32 random
weights (``jax.random`` at a seed, carried over by ``bridge``); the JAX one on
its Pallas kernels (interpret mode), the path the port's K1 and K5 mirror.
float32, because bf16 random weights leave near-ties in the logits that
rounding at other places can flip. Transcripts, incremental partials and the
``StreamingSTT`` event stream must be token-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.audio.endpoint import EnergyEndpointer as JEndpointer
from tpu_voice_agent.models.whisper import init_params as j_init
from tpu_voice_agent.serve.stt import SpeechEngine as JSpeech
from tpu_voice_agent.serve.stt import StreamingSTT as JStreaming
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.audio.endpoint import EnergyEndpointer
from tpu_voice_agent_torch.serve.stt import NullSTT, SpeechEngine, StreamingSTT
from tpu_voice_agent_torch.whisper_ckpt import render_speech
from test_torch_stt_golden import jax_transcribe

KW = {"preset": "whisper-test", "frame_buckets": (100, 200), "max_new_tokens": 8}


@pytest.fixture(scope="module")
def engines():
    jeng = JSpeech(kernels="pallas", init_weights=False, **KW)
    params = j_init(jeng.cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    jeng.load_params(params)
    teng = SpeechEngine(init_weights=False, device="cpu", **KW)
    teng.load_params(bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    assert teng.cfg == type(teng.cfg)(**{k: getattr(jeng.cfg, k)
                                         for k in teng.cfg.__dataclass_fields__})
    return jeng, teng


def _speech(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000
    return (0.2 * np.sin(2 * np.pi * (220 + 40 * seed) * t) * (np.sin(2 * np.pi * 2.5 * t) > -0.3)
            + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("audio", ["short", "bucket2", "past_top_bucket", "font"])
def test_transcribe_is_token_identical(engines, audio):
    jeng, teng = engines
    x = {"short": _speech(0.6), "bucket2": _speech(1.5, 1), "past_top_bucket": _speech(2.7, 2),
         "font": render_speech("scroll down")}[audio]
    jids, jtext = jax_transcribe(jeng, x)
    res = teng.transcribe(x)
    assert res.token_ids == jids and res.text == jtext
    assert res.text == jeng.transcribe(x).text
    assert res.n_frames == min(len(x) // 160, 200) and res.encode_ms > 0 and res.decode_ms > 0


def test_incremental_feed_and_decode_are_token_identical(engines):
    """Blocks appended one by one, then a re-anchor once the 100-frame
    cross-KV budget is spent."""
    jeng, teng = engines
    buf = _speech(2.7, 3)
    js, ts = jeng.incremental_init(), teng.incremental_init()
    for end in (0.55, 1.05, 2.0, 2.7):
        part = buf[:int(16_000 * end)]
        js, ts = jeng.incremental_feed(js, part), teng.incremental_feed(ts, part)
        assert (ts.enc_len, ts.consumed_frames, ts.anchor_frames) == (
            js.enc_len, js.consumed_frames, js.anchor_frames)
        np.testing.assert_allclose(ts.cross_k.numpy(), np.asarray(js.cross_k), atol=1e-4)
        np.testing.assert_allclose(ts.cross_v.numpy(), np.asarray(js.cross_v), atol=1e-4)
        assert teng.incremental_decode(ts).text == jeng.incremental_decode(js).text
    assert ts.anchor_frames > 0  # the budget re-anchored


def _stream(stt, audio, parse_on_spec=False):
    """Feed 60 ms frames; optionally report every spec_final's parse as
    grammar-complete (the voice loop's speculative parse)."""
    events = []
    for j in range(0, len(audio), 960):
        for ev in stt.feed(audio[j:j + 960]):
            events.append(ev)
            if parse_on_spec and ev[0] == "spec_final":
                stt.parse_complete(ev[1])
    return events


def test_streaming_event_stream_is_identical(engines):
    """Partials, spec_final and final on one utterance; then an early close
    armed by parse_complete on the next."""
    jeng, teng = engines
    silence = np.zeros(16_000, np.float32)
    audio = np.concatenate([silence[:3200], _speech(1.2, 4), silence])
    streams = []
    for eng, cls, ep in ((jeng, JStreaming, JEndpointer), (teng, StreamingSTT, EnergyEndpointer)):
        stt = cls(eng, endpointer=ep(spec_silence_ms=120), early_close_ms=240.0)
        first = _stream(stt, audio)
        second = _stream(stt, audio, parse_on_spec=True)
        streams.append((first, second, stt.early_closes, stt.window_closes))
    assert streams[0] == streams[1]
    first, second, early, window = streams[1]
    kinds = [k for k, _ in first]
    assert "partial" in kinds and "spec_final" in kinds and kinds[-1] == "final"
    assert second[-1][0] == "final" and (early, window) == (1, 1)


def test_engine_needs_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeechEngine()
    with pytest.raises(ValueError, match="unknown kernels"):
        SpeechEngine(kernels="pallas", device="cpu")
    with pytest.raises(ValueError, match="no frame bucket"):
        SpeechEngine(frame_buckets=(300,), device="cpu", init_weights=False)
    eng = SpeechEngine("whisper-large-v3", device="cpu", init_weights=False)
    assert (eng.cfg.vocab_size, eng.mel_cfg.n_mels, eng._param_dtype) == (619, 128, torch.bfloat16)


def test_null_stt_scripts_and_faults():
    stt = NullSTT([("final", "go back")])
    assert stt.feed(np.zeros(10, np.float32)) == [("final", "go back")]
    assert stt.feed(np.zeros(5, np.float32)) == [] and stt.fed_samples == 15
    stt.fail_next = True
    with pytest.raises(RuntimeError, match="injected"):
        stt.feed(np.zeros(1, np.float32))
