"""The serving loop's STT lane (``services/brain.py ServingLoop``, the port
of JAX's ``ColocatedServing`` lanes) under the five cases of
``tests/test_colocate.py``: both lanes drained, an STT job served at the
next chunk boundary, the worker thread serving both, an abandoned parse
dequeued without a race, and an STT-less loop refusing STT jobs.

Beside them, each lane's answers equal what its engine gives alone (the
transcript of ``SpeechEngine.transcribe``, the tokens of a batcher drained
without the loop), and the ``colocate.*`` gauges read each step's lanes.
The engines are the port's, on random weights, on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.serve.stt import SpeechEngine
from tpu_voice_agent_torch.services.brain import ServingLoop
from tpu_voice_agent_torch.utils.tracing import get_metrics


def _prompt(utterance: str) -> str:
    # a short prompt: the few-shot one overflows the tiny engine's buckets;
    # the grammar holds regardless
    user = json.dumps({"text": utterance, "context": {}}, separators=(",", ":"))
    return f"<|user|>\n{user}\n<|assistant|>\n"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module (the driver runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stt_engine():
    return SpeechEngine(preset="whisper-test", frame_buckets=(100,), max_new_tokens=8,
                        device="cpu")


@pytest.fixture(scope="module")
def batch_engine():
    return DecodeEngine(preset="test-tiny", max_len=1024, batch_slots=3,
                        prefill_buckets=(64, 128, 256, 512), device="cpu")


def _audio(ms: float = 400.0) -> np.ndarray:
    n = int(16_000 * ms / 1000)
    return (0.1 * np.sin(2 * np.pi * 440 * np.arange(n) / 16_000)).astype(np.float32)


def _loop(batch_engine, stt=None, chunk_steps=8, max_new=192, autostart=False):
    return ServingLoop(ContinuousBatcher(batch_engine, chunk_steps=chunk_steps,
                                         max_new_tokens=max_new), stt=stt, autostart=autostart)


def test_colocated_drain_completes_both_lanes(stt_engine, batch_engine):
    co = _loop(batch_engine, stt_engine)
    stt_futs = [co.submit_stt(_audio()) for _ in range(2)]
    utts = ("search for shoes", "scroll down")
    parse_futs = [co.submit(_prompt(u)) for u in utts]
    co.run_until_idle(timeout_s=300)
    ref = stt_engine.transcribe(_audio())
    for f in stt_futs:
        res = f.result(timeout=1)
        assert res.n_frames > 0 and res.token_ids == ref.token_ids
    alone = ContinuousBatcher(batch_engine, chunk_steps=8, max_new_tokens=192).generate_many(
        [_prompt(u) for u in utts])
    for f, a in zip(parse_futs, alone):
        res = f.result(timeout=1)
        assert res.error is None and res.token_ids == a.token_ids
        if res.finished:  # a truncated decode may stop mid-JSON
            json.loads(res.text)
    assert co.stats.stt_jobs == 2 and co.stats.parse_jobs == 2
    assert co.stats.decode_chunks >= 1 and co.stats.max_stt_queue == 2


def test_stt_preempts_between_decode_chunks(stt_engine, batch_engine):
    """An STT job submitted mid-decode runs at the next chunk boundary, not
    after the whole decode."""
    co = _loop(batch_engine, stt_engine, chunk_steps=4, max_new=64)
    parse_fut = co.submit(_prompt("sort by price low to high"))
    assert co.step()  # admit + the first decode chunk
    assert not parse_fut.done()
    stt_fut = co.submit_stt(_audio())
    assert co.step()  # the STT lane clears within this one step
    assert stt_fut.done()
    assert get_metrics().snapshot()["gauges"]["colocate.stt_queue"] == 1
    co.run_until_idle(timeout_s=300)
    assert parse_fut.result(timeout=1).error is None
    first_stt = co.stats.trace.index("stt")
    last_chunk = len(co.stats.trace) - 1 - co.stats.trace[::-1].index("chunk")
    assert first_stt < last_chunk  # interleaved, not appended at the end
    assert get_metrics().snapshot()["gauges"]["colocate.stt_queue"] == 0


def test_worker_thread_serves_both(stt_engine, batch_engine):
    co = _loop(batch_engine, stt_engine, max_new=48, autostart=True)
    try:
        stt_fut = co.submit_stt(_audio(200))
        parse_fut = co.submit(_prompt("go back"))
        assert stt_fut.result(timeout=300).n_frames > 0
        assert parse_fut.result(timeout=300).error is None
        assert co.healthy()
    finally:
        co.stop()


def test_abandon_parse_dequeues_without_racing_worker(batch_engine):
    """A given-up request is cancelled on the loop's thread and its result
    purged; the surviving request completes."""
    co = _loop(batch_engine, max_new=64)
    keep = co.submit(_prompt("search for keyboards"))
    drop = co.submit(_prompt("take a screenshot"))
    co.abandon(drop)
    co.run_until_idle(timeout_s=300)
    assert keep.result(timeout=1).error is None
    assert drop.cancelled()
    assert not co.batcher.pending and not co._futures and not co.batcher.results


def test_stt_less_runtime_rejects_stt_jobs(batch_engine):
    co = _loop(batch_engine)
    with pytest.raises(RuntimeError, match="without an STT engine"):
        co.submit_stt(_audio())


def test_an_stt_job_fault_fails_its_future_alone(stt_engine, batch_engine):
    """A bad buffer fails its own future; the loop and the decode lane go
    on."""
    co = _loop(batch_engine, stt_engine, max_new=16)
    bad = co.submit_stt(None)
    good = co.submit_stt(_audio())
    parse = co.submit(_prompt("go back"))
    co.run_until_idle(timeout_s=300)
    with pytest.raises(Exception):
        bad.result(timeout=1)
    assert good.result(timeout=1).n_frames > 0 and parse.result(timeout=1).error is None
    assert co.error is None
