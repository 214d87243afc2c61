"""The port's voice→intent loop (``voicebench``) end to end on the CPU, at toy
widths: ``whisper-test`` STT and a ``test-tiny`` parse engine behind the
cached few-shot prefix, one short utterance. The numbers are CPU times and
prove only that the loop runs and reports; the card's come from
``chip_smoke.py``'s voice phase."""

import math

import numpy as np

from tpu_voice_agent_torch import voicebench


def test_voicebench_runs_and_reports_finite_metrics():
    parse = voicebench.make_parse_engine("test-tiny", quant=None, device="cpu")
    assert len(parse.prefix_ids) > 800 and parse.fast_forward == 8
    stt = voicebench.make_stt_engine("whisper-test", frame_buckets=(100, 200), device="cpu")
    res = voicebench.run_voice_bench(parse, stt, runs=1,
                                     speech=voicebench.synth_utterance(0.6))
    for key in ("p50_ms", "p95_ms", "stt_p50_ms", "parse_p50_ms", "spec_hit_rate",
                "early_close_rate"):
        assert math.isfinite(res[key]), key
    assert res["runs"] == 1 and len(res["e2e_ms"]) == 1
    assert res["e2e_ms"][0] >= res["stt_ms"][0] >= 0 and res["parse_ms"][0] >= 0
    assert res["early_closes"] + res["window_closes"] >= 1
    assert len(res["parse_tokens"]) == 1 and 0 < res["parse_tokens"][0] <= 64
    assert 0.0 <= res["spec_hit_rate"] <= 1.0 and 0.0 <= res["early_close_rate"] <= 1.0


def test_synth_utterance_is_bench_pys():
    import bench

    np.testing.assert_array_equal(voicebench.synth_utterance(1.3), bench.synth_utterance(1.3))
    assert voicebench.UTTERANCES == [
        "search for wireless headphones",
        "sort these by price from low to high",
        "open the second result and take a screenshot",
        "filter results under one hundred dollars",
        "upload my resume and submit the form",
    ]
