"""Voice→intent latency of the port: ``bench.py``'s voice loop on the
port's engines.

The metric definition is ``bench.py``'s (bench.py:205-338), unchanged:

- 60 ms PCM frames are fed to ``StreamingSTT`` at their real-time
  deadlines, as a microphone would deliver them;
- ``EnergyEndpointer(spec_silence_ms=120)`` speculates the final after 120
  ms of silence and ``StreamingSTT(early_close_ms=240)`` closes early once
  the speculative parse of that transcript is grammar-complete;
- the speculative parse runs in a one-thread pool, launched on
  ``spec_final``; its completion calls ``parse_complete``;
- e2e runs from the real-time end of speech to the intent: to the endpoint
  confirmation and the landed speculative parse when they agree, else to a
  fresh parse of the final (or of a fixed utterance when the final is
  empty);
- the parse is ``generate(prompt, max_new_tokens=64)`` behind the cached
  few-shot prefix, with the prompt's utterance clamped until 66 tokens of
  room remain in the cache;
- 9 runs over ``synth_utterance(2.0)`` and a 1 s silence tail.

``run_voice_bench`` takes the two engines, so a test can drive it at toy
widths on the CPU; ``python -m tpu_voice_agent_torch.voicebench`` builds the
full-width pair (``tinyllama-1.1b`` int8, fast-forward 8, cache 1024, and
``whisper-large-v3`` with buckets (300, 1000), 32 new tokens, random weights
from a seed) on the card and prints the result as JSON.

``run_neural_voice_bench`` is ``bench.py --neural`` (bench.py:136-160,
:231): every model is an in-repo trained checkpoint (``make_neural_engines``:
the distilled intent parser, and ``whisper-tiny-heldout``, or
``whisper-tiny-overfit`` where the first is missing), the speech is the
acoustic-font render of ``WHISPER_EVAL_TEXTS[:5]``, and the parse is the
distilled parser's; the same timing loop, plus each run's word error rate
against the text it spoke (``evals.wer``). ``python -m
tpu_voice_agent_torch.voicebench --neural`` runs it on the card.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# bench.py's synthetic voice traffic (bench.py:238-244)
UTTERANCES = [
    "search for wireless headphones",
    "sort these by price from low to high",
    "open the second result and take a screenshot",
    "filter results under one hundred dollars",
    "upload my resume and submit the form",
]
SAMPLE_RATE = 16_000
FRAME_MS = 60  # the web client ships ~60 ms PCM frames


def synth_utterance(seconds: float, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Speech-like audio: modulated tone bursts over a noise floor (the
    port's copy of bench.py's)."""
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    return (
        0.2 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 2.5 * t) > -0.3)
        + 0.002 * rng.standard_normal(len(t))
    ).astype(np.float32)


def make_parse_engine(preset: str = "tinyllama-1.1b", quant: str | None = "int8",
                      device=None):
    """bench.py's intent engine: cache 1024, one prefill bucket of 1024,
    fast-forward 8, the few-shot prefix cached."""
    from .serve.engine import DecodeEngine
    from .services.brain import install_prompt_prefix

    eng = DecodeEngine(preset=preset, max_len=1024, prefill_buckets=(1024,), quant=quant,
                       fast_forward=8, device=device)
    install_prompt_prefix(eng)
    return eng


def make_stt_engine(preset: str = "whisper-large-v3", frame_buckets=(300, 1000),
                    device=None):
    """bench.py's speech engine: random weights, 32 new tokens."""
    from .serve.stt import SpeechEngine

    return SpeechEngine(preset=preset, frame_buckets=frame_buckets, max_new_tokens=32,
                        device=device)


def run_voice_bench(parse_engine, stt_engine, runs: int = 9,
                    speech: np.ndarray | None = None) -> dict:
    """Drive ``runs`` utterances through STT and the speculative parse;
    returns the e2e, STT and parse times (ms) per run, their p50s, the e2e
    p95, the spec hit and early-close rates, the feed lag at each run's end
    of speech, and the tokens of the parse that ended each run."""
    from .services.prompts import render_prompt

    room = parse_engine.max_len - 66

    def parse_text(text: str) -> int:
        """One bench parse; returns the tokens it emitted."""
        # random-weight STT transcribes unbounded garbage and the prompt
        # prefix alone is ~880 tokens: shrink the utterance until it fits
        for clamp in (100, 50, 20, 8, 0):
            prompt = render_prompt(text[:clamp], {"last_query": None})
            if len(parse_engine.tokenizer.encode(prompt, bos=True)) <= room:
                break
        return parse_engine.generate(prompt, max_new_tokens=64, greedy=True).steps

    speech = synth_utterance(2.0) if speech is None else speech
    return _paced_runs(parse_text, stt_engine, [speech], UTTERANCES, runs)[0]


def make_neural_engines(device=None):
    """``bench.py --neural``'s pair: the distilled intent parser and the
    trained Whisper (``whisper-tiny-heldout``, the generalizing checkpoint,
    else ``whisper-tiny-overfit``). Returns (parser, stt_engine, name)."""
    from . import distilled, whisper_ckpt

    parser = distilled.intent_engine_from(*distilled.load_distilled(device=device),
                                          device=device)
    name = next(n for n in ("whisper-tiny-heldout", "whisper-tiny-overfit")
                if whisper_ckpt.npz_path(n).exists())
    stt_engine = whisper_ckpt.whisper_engine_from(*whisper_ckpt.load_whisper(name, device=device),
                                                  device=device)
    return parser, stt_engine, name


def run_neural_voice_bench(parser, stt_engine, runs: int = 9) -> dict:
    """``bench.py --neural``: the acoustic-font renders of
    ``WHISPER_EVAL_TEXTS[:5]`` through the trained STT and the distilled
    parser, timed as ``run_voice_bench`` times them, with each run's
    reference, final transcript and word error rate."""
    from .evals.wer import wer
    from .whisper_ckpt import WHISPER_EVAL_TEXTS, render_speech

    utterances = WHISPER_EVAL_TEXTS[:5]

    def parse_text(text: str) -> int:
        parser.parse(text, {})
        return parser.last_result.steps

    out, finals = _paced_runs(parse_text, stt_engine,
                              [render_speech(u) for u in utterances], utterances, runs)
    refs = [utterances[i % len(utterances)] for i in range(runs)]
    out.update(references=refs, finals=finals,
               wer=[wer(r, f or "") for r, f in zip(refs, finals)])
    out["wer_mean"] = float(np.mean(out["wer"]))
    return out


def _paced_runs(parse_text, stt_engine, speeches: list, utterances: list, runs: int):
    """The timing loop both modes share: run ``i`` speaks
    ``speeches[i % len]`` in real time, then 1 s of silence. Returns (the
    result dict, each run's final transcript or None)."""
    from .audio.endpoint import EnergyEndpointer
    from .serve.stt import StreamingSTT

    stt = StreamingSTT(stt_engine, endpointer=EnergyEndpointer(spec_silence_ms=120),
                       early_close_ms=240.0)
    sr = stt_engine.mel_cfg.sample_rate
    frame = sr * FRAME_MS // 1000
    silence = np.zeros(sr, dtype=np.float32)  # 1 s tail

    # warmup: both prefill paths of the parse, every bucket, the incremental
    # path and one streaming feed
    for u in (utterances[0], utterances[2] + " and also " + utterances[3]):
        parse_text(u)
    for b in stt_engine.frame_buckets:
        stt_engine.transcribe(np.zeros(b * stt_engine.mel_cfg.hop, np.float32))
    st = stt_engine.incremental_init()
    st = stt_engine.incremental_feed(
        st, np.zeros(stt_engine.INC_STEP * stt_engine.mel_cfg.hop * 3, np.float32))
    stt_engine.incremental_decode(st)
    stt.feed(speeches[0][:frame])
    stt.reset()

    pool = ThreadPoolExecutor(1, thread_name_prefix="spec-parse")
    spec: dict = {"text": None, "fut": None}

    def spec_launch(text: str) -> None:
        if spec["text"] == text and spec["fut"] is not None:
            return
        if spec["fut"] is not None:
            spec["fut"].result()  # single-slot engine: serialize generations

        def run():
            n = parse_text(text)
            stt.parse_complete(text)  # grammar-complete: arm the early close
            return time.perf_counter(), n

        spec["text"], spec["fut"] = text, pool.submit(run)

    def feed_paced(audio: np.ndarray, deadline: float):
        final_text = None
        for j in range(0, len(audio) - frame, frame):
            deadline += FRAME_MS / 1e3
            now = time.perf_counter()
            if now < deadline:
                time.sleep(deadline - now)
            for kind, text in stt.feed(audio[j:j + frame]):
                if kind == "final":
                    final_text = text
                elif kind == "spec_final":
                    spec_launch(text)
            # an emptied buffer means the utterance closed even when the
            # transcript was empty: the clock stops here either way
            if final_text is not None or (j > 0 and stt.buffered_samples == 0):
                break
        return final_text, deadline

    e2e_ms, stt_ms, parse_ms, lag_s, tokens, finals = [], [], [], [], [], []
    spec_hits = 0
    try:
        for i in range(runs):
            stt.reset()
            old = spec["fut"]
            spec["text"], spec["fut"] = None, None
            if old is not None:
                old.result()  # drain any carryover before reusing the engine
            _, t_end_speech = feed_paced(speeches[i % len(speeches)], time.perf_counter())
            lag_s.append(stt.feed_lag_s)
            t0 = t_end_speech  # the real-time moment the speaker stopped
            final_text, _ = feed_paced(silence, t_end_speech)
            t1 = time.perf_counter()
            if final_text and spec["fut"] is not None and spec["text"] == final_text:
                # speculation hit: e2e ends when both the endpoint confirmed
                # and the parse landed
                t_done, n = spec["fut"].result()
                t2 = max(t1, t_done)
                spec_hits += 1
            else:
                if spec["fut"] is not None:
                    spec["fut"].result()  # wasted speculation; drain the slot
                n = parse_text(final_text or utterances[i % len(utterances)])
                t2 = time.perf_counter()
            stt_ms.append((t1 - t0) * 1e3)
            parse_ms.append((t2 - t1) * 1e3)
            e2e_ms.append((t2 - t0) * 1e3)
            tokens.append(n)
            finals.append(final_text)
    finally:
        if spec["fut"] is not None:
            spec["fut"].result()
        pool.shutdown(wait=True)

    closes = stt.early_closes + stt.window_closes
    return {
        "runs": runs,
        "e2e_ms": e2e_ms,
        "stt_ms": stt_ms,
        "parse_ms": parse_ms,
        "p50_ms": float(np.percentile(e2e_ms, 50)),
        "p95_ms": float(np.percentile(e2e_ms, 95)),
        "stt_p50_ms": float(np.percentile(stt_ms, 50)),
        "parse_p50_ms": float(np.percentile(parse_ms, 50)),
        "spec_hit_rate": spec_hits / runs,
        "early_close_rate": stt.early_closes / max(1, closes),
        "early_closes": stt.early_closes,
        "window_closes": stt.window_closes,
        "feed_lag_at_end_of_speech_s": lag_s,
        "parse_tokens": tokens,
    }, finals


if __name__ == "__main__":
    import json
    import sys

    if "--neural" in sys.argv[1:]:
        parser, stt_engine, name = make_neural_engines()
        print(json.dumps({"stt_checkpoint": name, **run_neural_voice_bench(parser, stt_engine)}))
    else:
        print(json.dumps(run_voice_bench(make_parse_engine(), make_stt_engine())))
