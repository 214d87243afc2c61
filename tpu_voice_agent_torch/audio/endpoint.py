"""Energy-based endpointing (the port's own numpy copy of
``tpu_voice_agent/audio/endpoint.py``; no JAX in either).

The reference adds a fixed 1000 ms debounce to EVERY command
(apps/voice/src/server.ts:229) — the single largest latency constant in its
pipeline. This endpointer closes an utterance after `trailing_silence_ms` of
sub-threshold energy instead, typically clawing back 600-700 ms. A model-free
adaptive noise floor keeps it robust to mic gain differences.

Round 5 makes the window itself adaptive (VERDICT round-4 next #9: the
fixed 350 ms window had become 97% of the measured CPU e2e): the consumer
(StreamingSTT) may close the utterance EARLY via ``force_end`` once its
own evidence — a speculative transcript stable across consecutive silent
frames AND a grammar-complete speculative parse — says the command is
over. The endpointer stays model-free; the policy lives in the caller.
"""

from __future__ import annotations

import numpy as np


class EnergyEndpointer:
    def __init__(
        self,
        sample_rate: int = 16_000,
        frame_ms: int = 20,
        trailing_silence_ms: int = 350,
        min_speech_ms: int = 200,
        threshold_mult: float = 3.0,
        spec_silence_ms: int | None = None,
    ):
        self.sr = sample_rate
        self.frame_ms = frame_ms
        self.frame = int(sample_rate * frame_ms / 1000)
        self.trailing_frames = max(1, trailing_silence_ms // frame_ms)
        # silence needed before the speculative final fires; default half
        # the closing window (the round-3 tuning). Lower = speculate more
        # eagerly (more wasted transcribes on inter-word gaps, but the
        # adaptive early close can then land sooner)
        self.spec_frames = (max(1, spec_silence_ms // frame_ms)
                            if spec_silence_ms is not None
                            else max(1, self.trailing_frames // 2))
        self.min_speech_frames = max(1, min_speech_ms // frame_ms)
        self.threshold_mult = threshold_mult
        self.noise_floor = 1e-4
        self._buf = np.zeros(0, dtype=np.float32)
        self._speech_frames = 0
        self._silence_run = 0
        self.in_speech = False
        # monotone count of supra-threshold frames, NEVER reset by utterance
        # turnover: StreamingSTT keys speculative-final staleness on it
        self.total_speech_frames = 0

    def reset(self) -> None:
        self._buf = np.zeros(0, dtype=np.float32)
        self._speech_frames = 0
        self._silence_run = 0
        self.in_speech = False
        self.total_speech_frames = 0

    @property
    def in_trailing_silence(self) -> bool:
        """Mid-utterance silence long enough (``spec_frames``; half the
        closing window, 175 ms, at defaults) that the utterance content is
        plausibly frozen — the cue for StreamingSTT to compute the final
        transcription speculatively. The threshold trades wasted
        speculations against hidden latency: at the default, inter-word
        gaps (< ~150 ms) never fire; a lower ``spec_silence_ms`` may fire a
        discarded transcribe per inter-phrase pause but lets the adaptive
        early close land sooner."""
        return self.in_speech and self._silence_run >= self.spec_frames

    @property
    def silence_run_ms(self) -> float:
        """Current mid-utterance silence run, for caller-side policies."""
        return self._silence_run * self.frame_ms

    def force_end(self) -> bool:
        """Close the current utterance NOW (adaptive early endpoint).

        The caller — not the endpointer — owns the evidence that the
        utterance is over (stable speculative transcript + grammar-complete
        parse); this just performs the same state turnover a natural window
        expiry would. Returns False (and changes nothing) when there is no
        utterance to close or it is still below ``min_speech_ms`` (the blip
        guard applies to early closes too)."""
        if not self.in_speech or self._speech_frames < self.min_speech_frames:
            return False
        self.in_speech = False
        self._speech_frames = 0
        self._silence_run = 0
        return True

    def feed(self, samples: np.ndarray) -> bool:
        """Feed float32 samples; True when an utterance just ended."""
        self._buf = np.concatenate([self._buf, samples.astype(np.float32)])
        ended = False
        while len(self._buf) >= self.frame:
            frame, self._buf = self._buf[: self.frame], self._buf[self.frame :]
            rms = float(np.sqrt(np.mean(frame * frame) + 1e-12))
            threshold = self.noise_floor * self.threshold_mult
            if rms > threshold:
                self.in_speech = True
                self._speech_frames += 1
                self.total_speech_frames += 1
                self._silence_run = 0
            else:
                # adapt the noise floor on silence only
                self.noise_floor = 0.95 * self.noise_floor + 0.05 * max(rms, 1e-6)
                if self.in_speech:
                    self._silence_run += 1
                    if self._silence_run >= self.trailing_frames:
                        if self._speech_frames >= self.min_speech_frames:
                            ended = True
                        # too-short blips (a door slam) drop the utterance
                        # without an `ended` — otherwise in_speech sticks
                        # True forever and the caller's buffer never trims
                        self.in_speech = False
                        self._speech_frames = 0
                        self._silence_run = 0
        return ended
