"""Word error rate of the STT stack.

Port of ``tpu_voice_agent/evals/wer.py``: ``wer`` is the Levenshtein word
distance over normalized transcripts; ``wer_over_dir`` walks a directory of
``*.wav`` files with sibling ``.txt`` references (no corpus ships in the
repo; ``voicebench``'s neural mode scores rendered speech instead).
"""

from __future__ import annotations

import re
from pathlib import Path

_NORM = re.compile(r"[^a-z0-9' ]+")


def normalize_words(text: str) -> list[str]:
    return _NORM.sub(" ", text.lower()).split()


def wer(reference: str, hypothesis: str) -> float:
    """(S + D + I) / len(reference words); 0.0 is perfect. An empty
    reference scores 0.0 against an empty hypothesis, else 1.0."""
    ref = normalize_words(reference)
    hyp = normalize_words(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    prev = list(range(len(hyp) + 1))  # single-row Levenshtein over words
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1,  # deletion
                         cur[j - 1] + 1,  # insertion
                         prev[j - 1] + (r != h))  # substitution
        prev = cur
    return prev[-1] / len(ref)


def wer_over_dir(transcribe, audio_dir: str | Path) -> dict:
    """``transcribe(path) -> str`` over every ``*.wav`` with a sibling
    ``.txt`` reference. Returns {pairs, wer}, corpus-level (total errors /
    total reference words)."""
    audio_dir = Path(audio_dir)
    total_errs = 0.0
    total_words = 0
    pairs = 0
    for wav in sorted(audio_dir.glob("*.wav")):
        ref_path = wav.with_suffix(".txt")
        if not ref_path.exists():
            continue
        ref = ref_path.read_text().strip()
        hyp = transcribe(str(wav))
        n = len(normalize_words(ref))
        total_errs += wer(ref, hyp) * max(n, 1)
        total_words += max(n, 1)
        pairs += 1
    return {"pairs": pairs, "wer": (total_errs / total_words) if total_words else None}
