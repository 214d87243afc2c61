"""The in-repo Whisper checkpoints, carried into the port as plain numpy.

``data/whisper-tiny-overfit.npz`` and ``data/whisper-tiny-heldout.npz`` hold
the JAX package's ``checkpoints/whisper-tiny-*`` parameter trees (whisper-test
widths: d 64, 4 heads of 16, 2 + 2 layers, 200 mel frames, the in-tree
619-token vocabulary, fp32) flattened with ``/``-joined keys, each with its
config beside it as JSON; ``data/stt_golden.json`` holds the JAX package's
transcripts and token ids of ``WHISPER_EVAL_TEXTS`` on both, recorded through
its Pallas kernels. All are written by
``python tests/test_torch_stt_golden.py --write``.

``render_speech`` (the "acoustic font" the checkpoints were trained on) and
``WHISPER_EVAL_TEXTS`` are the port's own copies of the JAX package's
``train/distill.py`` ones.
"""

from __future__ import annotations

import json

import numpy as np

from . import PACKAGE_DIR

DATA_DIR = PACKAGE_DIR / "data"
CHECKPOINTS = ("whisper-tiny-overfit", "whisper-tiny-heldout")
STT_GOLDEN_JSON = DATA_DIR / "stt_golden.json"

# each character sounds as a 2-tone chord, 60 ms per char
_CHAR_SET = "abcdefghijklmnopqrstuvwxyz '"

WHISPER_EVAL_TEXTS = [
    "search for red shoes",
    "scroll down",
    "go back now",
    "open the second result",
    "sort by price",
    "take a screenshot",
    "upload my resume",
    "cancel that",
    "click the submit button",
    "extract the table",
]


def render_speech(text: str, sr: int = 16_000, char_ms: int = 60) -> np.ndarray:
    """Deterministic text -> waveform (the synthetic 'speaker')."""
    n = int(sr * char_ms / 1000)
    t = np.arange(n) / sr
    chunks = []
    for ch in text.lower():
        i = _CHAR_SET.find(ch)
        if i < 0:
            i = _CHAR_SET.find(" ")
        f0 = 200.0 + 55.0 * i
        f1 = 2000.0 + 90.0 * i
        env = np.hanning(n)
        chunks.append((0.45 * np.sin(2 * np.pi * f0 * t)
                       + 0.25 * np.sin(2 * np.pi * f1 * t)) * env)
    return np.concatenate(chunks).astype(np.float32)


def npz_path(name: str):
    return DATA_DIR / f"{name}.npz"


def meta_path(name: str):
    return DATA_DIR / f"{name}.json"


def load_whisper(name: str, device=None):
    """(WhisperConfig, params on ``device``) of one committed checkpoint."""
    from .bridge import load_npz
    from .models.whisper import WhisperConfig
    from .serve.engine import resolve_device

    cfg = WhisperConfig(**json.loads(meta_path(name).read_text())["config"])
    return cfg, load_npz(npz_path(name), device=resolve_device(device))


def whisper_engine_from(cfg, params, device=None):
    """The speech engine over checkpoint weights, configured as the JAX
    package's ``train.distill.whisper_engine_from``: one bucket equal to the
    training frame count (so serve-time padding matches train-time
    padding), 48 new tokens at most."""
    from .serve.stt import SpeechEngine

    eng = SpeechEngine(cfg=cfg, frame_buckets=(cfg.max_audio_frames,), max_new_tokens=48,
                       init_weights=False, device=device)
    eng.load_params(params)
    return eng


def golden_records() -> dict[str, list[dict]]:
    """The recorded JAX transcriptions: {checkpoint: [{"text", "transcript",
    "token_ids"}, ...]}."""
    return json.loads(STT_GOLDEN_JSON.read_text())["checkpoints"]
