"""The port's audio front end against the JAX package's, on the same PCM.

The filterbank and DFT matrices are numpy on both sides and must be equal
bit for bit; the log-mel spectrogram (two fp32 matmuls, log10, clamp) is held
to 1e-4 absolute (its values are O(1) and the matmuls sum in another order);
the endpointer is numpy on both sides and must decide identically.
"""

import numpy as np
import pytest
import torch

from tpu_voice_agent.audio import endpoint as jendpoint
from tpu_voice_agent.audio import mel as jmel
from tpu_voice_agent_torch.audio import endpoint as tendpoint
from tpu_voice_agent_torch.audio import mel as tmel
from tpu_voice_agent_torch.whisper_ckpt import render_speech


def _speechlike(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000
    return (0.2 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 2.5 * t) > -0.3)
            + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_tables_are_bit_identical(n_mels):
    jc, tc = jmel.MelConfig(n_mels=n_mels), tmel.MelConfig(n_mels=n_mels)
    np.testing.assert_array_equal(tmel.mel_filterbank(tc), jmel.mel_filterbank(jc))
    for a, b in zip(tmel._dft_matrices(tc), jmel._dft_matrices(jc)):
        np.testing.assert_array_equal(a, b)
    f = np.array([0.0, 300.0, 999.9, 1000.0, 4321.0, 8000.0])
    np.testing.assert_array_equal(tmel._hz_to_mel(f), jmel._hz_to_mel(f))
    np.testing.assert_array_equal(tmel._mel_to_hz(tmel._hz_to_mel(f)),
                                  jmel._mel_to_hz(jmel._hz_to_mel(f)))


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("audio", ["speechlike", "font", "silence"])
def test_log_mel_matches(n_mels, audio):
    x = {"speechlike": _speechlike(1.3, n_mels),
         "font": render_speech("open the second result"),
         "silence": np.zeros(16_000 * 2, np.float32)}[audio]
    out_j = np.asarray(jmel.log_mel_spectrogram(x, jmel.MelConfig(n_mels=n_mels)))
    out_t = tmel.log_mel_spectrogram(torch.from_numpy(x), tmel.MelConfig(n_mels=n_mels))
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == out_j.shape
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-4, rtol=0)


def test_pcm16_to_float_is_identical():
    raw = np.random.default_rng(0).integers(-32768, 32767, 999, dtype=np.int16).tobytes()
    np.testing.assert_array_equal(tmel.pcm16_to_float(raw), jmel.pcm16_to_float(raw))


@pytest.mark.parametrize("kw", [{}, {"spec_silence_ms": 120},
                                {"trailing_silence_ms": 200, "min_speech_ms": 400}])
def test_endpointer_decides_identically(kw):
    """Speech, short and long pauses, a blip shorter than min_speech, odd
    chunk sizes and an early close: every decision and counter equal."""
    sr = 16_000
    z = lambda s: np.zeros(int(sr * s), np.float32)  # noqa: E731
    audio = np.concatenate([z(0.3), _speechlike(1.0, 1), z(0.15), _speechlike(0.6, 2), z(0.5),
                            _speechlike(0.1, 3), z(0.6), _speechlike(0.8, 4), z(0.3)])
    a, b = jendpoint.EnergyEndpointer(**kw), tendpoint.EnergyEndpointer(**kw)
    rng = np.random.default_rng(9)
    i, forced = 0, False
    while i < len(audio):
        n = int(rng.integers(100, 1500))
        chunk = audio[i:i + n]
        i += n
        assert a.feed(chunk) == b.feed(chunk)
        state = lambda e: (e.in_speech, e.in_trailing_silence, e.silence_run_ms,  # noqa: E731
                           e.total_speech_frames, e.noise_floor)
        assert state(a) == state(b)
        if not forced and a.in_trailing_silence and i > len(audio) * 0.8:
            forced = True
            assert a.force_end() == b.force_end()
    assert forced
    a.reset()
    b.reset()
    assert (a.in_speech, a.total_speech_frames) == (b.in_speech, b.total_speech_frames)
