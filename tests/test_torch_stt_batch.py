"""The port's batched STT plane (``serve/stt_batch.py``) against its own
B = 1 path and against the JAX package's ``STTBatcher``.

The twelve cases of ``tests/test_stt_batch.py`` run against the port: token
identity with the B = 1 path for every work kind (finals of ragged buckets,
a spec_final, incremental partials over a persistent pool slot, a
re-anchor), the decode loop's per-slot budgets, the batcher's priority,
coalescing and shedding, a release racing an in-flight partial, the
``StreamingSTT``-level event differential, ``feed_async``, and the stream
gauges. Beside them: the same work items through JAX's ``STTBatcher`` and
the port's give equal tokens, and K5's plain version keeps NaN in stale
cross-KV positions out of the sum.

Both packages' ``SpeechEngine`` run ``whisper-test`` on one float32 random
weight tree (``jax.random`` at a seed, carried by ``bridge``): float32, so
no token turns on a bf16 rounding. Tokens are held exactly.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models.whisper import init_params as j_init
from tpu_voice_agent.serve.stt import SpeechEngine as JSpeech
from tpu_voice_agent.serve.stt_batch import STTBatcher as JBatcher
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.audio.endpoint import EnergyEndpointer
from tpu_voice_agent_torch.models.whisper import init_self_cache, pad_cross_kv
from tpu_voice_agent_torch.ops.decode_attention import decode_attention
from tpu_voice_agent_torch.serve.stt import SpeechEngine, StreamingSTT, _stt_decode_loop
from tpu_voice_agent_torch.serve.stt_batch import BatchedStreamingSTT, STTBatcher
from tpu_voice_agent_torch.utils.tracing import get_metrics

KW = {"preset": "whisper-test", "frame_buckets": (50, 100, 200), "max_new_tokens": 16}


def tone(freq, dur_s, amp=0.3, sr=16_000):
    t = np.arange(int(dur_s * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module (the driver runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    jeng = JSpeech(kernels="pallas", init_weights=False, **KW)
    params = j_init(jeng.cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    jeng.load_params(params)
    teng = SpeechEngine(init_weights=False, device="cpu", **KW)
    teng.load_params(bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    return jeng, teng


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


@pytest.fixture()
def batcher(engine):
    b = STTBatcher(engine, slots=4)
    yield b
    b.stop()


def _counter(name):
    return get_metrics().snapshot()["counters"].get(name, 0)


def test_batched_finals_token_identical_ragged_buckets(engine, batcher):
    """Four finals over every bucket in ONE batch equal transcribe per
    slot (ragged encoder lengths)."""
    audios = [tone(300, 0.4), tone(440, 0.9), tone(520, 1.8), tone(260, 0.3)]
    singles = [engine.transcribe(a).token_ids for a in audios]
    futs = [batcher.submit("final", 9000 + i, a) for i, a in enumerate(audios)]
    assert [f.result(timeout=60).token_ids for f in futs] == singles


def test_batched_spec_final_token_identical(engine, batcher):
    a = tone(410, 0.7)
    res = batcher.submit("spec_final", 9100, a).result(timeout=60)
    assert res.token_ids == engine.transcribe(a).token_ids


def test_batched_partials_token_identical_and_slot_persistent(engine, batcher):
    """Partials decode the pool slot's incremental cross-KV, equal to a
    B = 1 ``IncrementalState`` fed the same audio, over two rounds."""
    hop = engine.mel_cfg.hop
    b1, b2 = tone(330, 1.0), tone(400, 1.5)
    st1 = engine.incremental_feed(engine.incremental_init(len(b1) // hop), b1)
    st2 = engine.incremental_feed(engine.incremental_init(len(b2) // hop), b2)
    f1 = batcher.submit("partial", 9201, b1)
    f2 = batcher.submit("partial", 9202, b2)
    assert f1.result(timeout=60).token_ids == engine.incremental_decode(st1).token_ids
    assert f2.result(timeout=60).token_ids == engine.incremental_decode(st2).token_ids
    g1 = np.concatenate([b1, tone(350, 0.5)])
    st1 = engine.incremental_feed(st1, g1)
    assert (batcher.submit("partial", 9201, g1).result(timeout=60).token_ids
            == engine.incremental_decode(st1).token_ids)


def test_batched_partial_reanchor_matches_b1(engine, batcher):
    """An utterance past the cross-KV budget re-anchors in its slot as the
    B = 1 state does."""
    hop = engine.mel_cfg.hop
    b = tone(440, 1.0)
    st = engine.incremental_feed(engine.incremental_init(len(b) // hop), b)
    batcher.submit("partial", 9301, b).result(timeout=60)
    g = np.concatenate([b, tone(380, 2.0)])  # past the 2 s budget
    st = engine.incremental_feed(st, g)
    assert st.anchor_frames > 0
    assert (batcher.submit("partial", 9301, g).result(timeout=60).token_ids
            == engine.incremental_decode(st).token_ids)


def test_decode_loop_mid_batch_eos_and_ragged_budgets(engine):
    """Per-slot budgets: each row stops at its own and emits what a B = 1
    loop with that budget emits."""
    P = engine.cfg.enc_positions
    audios = [tone(300, 0.4), tone(440, 0.9), tone(520, 1.2), tone(260, 0.6)]
    kvs, lens = [], []
    for a in audios:
        kv, enc_len, _ = engine._encode_window(a)
        kvs.append(pad_cross_kv(kv, P))
        lens.append(enc_len)
    ck = {"k": torch.cat([kv["k"] for kv in kvs], dim=1),
          "v": torch.cat([kv["v"] for kv in kvs], dim=1)}
    budgets = torch.tensor([3, 16, 1, 8], dtype=torch.int32)
    bos = torch.tensor([list(engine.bos_ids)] * 4, dtype=torch.int32)
    dt = engine._param_dtype
    out_b, n_b, _, _ = _stt_decode_loop(
        engine.params, engine.cfg, init_self_cache(engine.cfg, 4, dtype=dt), ck,
        torch.tensor(lens, dtype=torch.int32), bos, max_new=16, eos_id=engine.eos_id,
        pad_id=engine.pad_id, live=torch.ones(4, dtype=torch.bool), max_new_each=budgets)
    assert (n_b <= budgets).all()
    assert n_b[2] <= 1 < n_b[1]  # row 2 parked while row 1 ran on
    for i in range(4):
        o1, n1, _, _ = _stt_decode_loop(
            engine.params, engine.cfg, init_self_cache(engine.cfg, 1, dtype=dt), kvs[i],
            torch.tensor([lens[i]], dtype=torch.int32), bos[:1], max_new=16,
            eos_id=engine.eos_id, pad_id=engine.pad_id, max_new_each=budgets[i:i + 1])
        assert out_b[i, :n_b[i]].tolist() == o1[0, :n1[0]].tolist()


def test_batcher_priority_and_coalescing(engine):
    """finals > spec_finals > partials; a newer partial of an utterance
    supersedes the queued one (resolved None, counted)."""
    b = STTBatcher(engine, slots=2, autostart=False)
    a = tone(300, 0.5)
    c0 = _counter("stt.partials_coalesced")
    p1 = b.submit("partial", 1, a)
    p2 = b.submit("partial", 1, tone(300, 0.6))
    sp = b.submit("spec_final", 2, a)
    fi = b.submit("final", 3, a)
    assert p1.done() and p1.result() is None
    assert _counter("stt.partials_coalesced") == c0 + 1
    b.tick()  # width 2: the final and the spec_final; the partial waits
    assert fi.done() and sp.done() and not p2.done()
    assert fi.result().token_ids == engine.transcribe(a).token_ids
    b.tick()
    assert p2.done() and p2.result() is not None


def test_batcher_sheds_partials_under_overload(engine):
    """Partials past the slot pool or the bounded queue shed at submit
    (``stt.shed_overload``); finals are always admitted."""
    b = STTBatcher(engine, slots=1, autostart=False)
    a = tone(300, 0.3)
    s0 = _counter("stt.shed_overload")
    futs = [b.submit("partial", 100 + i, a) for i in range(4)]
    assert len([f for f in futs if f.done() and f.result() is None]) == 3
    assert _counter("stt.shed_overload") == s0 + 3
    f = b.submit("final", 999, a)
    assert not f.done()
    while b.tick():
        pass
    assert f.result(timeout=5).token_ids == engine.transcribe(a).token_ids
    b2 = STTBatcher(engine, slots=4, max_pending=1, autostart=False)
    s1 = _counter("stt.shed_overload")
    q1, q2 = b2.submit("partial", 201, a), b2.submit("partial", 202, a)
    assert not q1.done() and q2.done() and q2.result() is None
    assert _counter("stt.shed_overload") == s1 + 1


def test_batcher_slot_exhaustion_sheds_partial_not_final(engine):
    b = STTBatcher(engine, slots=1, autostart=False)
    a1, a2 = tone(320, 0.8), tone(430, 0.8)
    f1 = b.submit("partial", 501, a1)
    b.tick()
    assert f1.result(timeout=5) is not None  # owns the only slot
    f2 = b.submit("partial", 502, a2)
    b.tick()
    assert f2.result(timeout=5) is None  # no slot left: shed
    fin = b.submit("final", 502, a2)
    b.tick()
    assert fin.result(timeout=5).token_ids == engine.transcribe(a2).token_ids
    b.release(501)  # the slot frees for the next utterance
    f3 = b.submit("partial", 503, a2)
    b.tick()
    assert f3.result(timeout=5) is not None


def test_release_mid_flight_partial_never_leaks_the_slot(engine):
    """An utterance closing while its partial is in the worker's batch does
    not take its slot back (slots are reserved at submit only)."""
    b = STTBatcher(engine, slots=1, autostart=False)
    a = tone(320, 0.8)
    f = b.submit("partial", 601, a)
    with b._wake:
        batch = b._take_batch_locked()
    b.release(601)
    b._process(batch)
    assert f.result(timeout=5) is None
    assert b.slot_of == {} and b.slot_state == [None]
    f2 = b.submit("partial", 602, a)
    b.tick()
    assert f2.result(timeout=5) is not None


def _ep():
    return EnergyEndpointer(trailing_silence_ms=300, min_speech_ms=100)


def _chunks():
    return [tone(300, 0.6)] + [np.zeros(16_000 * 60 // 1000, np.float32)] * 12


def test_batched_streaming_matches_base_events(engine, batcher):
    """The same chunks through the inline and the batched planes give the
    same events (a partial may surface a feed later; the final is equal)."""

    def run(stt, batched):
        events = []
        for c in _chunks():
            events += stt.feed(c)
            if batched:
                assert batcher.drain(timeout_s=30)
        return events

    eb = run(StreamingSTT(engine, partial_interval_s=0.2, endpointer=_ep()), False)
    eB = run(BatchedStreamingSTT(engine, batcher, partial_interval_s=0.2, endpointer=_ep()), True)
    assert sorted(eb) == sorted(eB)
    assert [t for k, t in eb if k == "final"] == [t for k, t in eB if k == "final"]
    assert any(k == "final" for k, _ in eb)


def test_batched_feed_async_delivers_identical_final(engine, batcher):
    base = StreamingSTT(engine, partial_interval_s=60.0, endpointer=_ep())
    ref = [t for c in _chunks() for k, t in base.feed(c) if k == "final"]
    stt = BatchedStreamingSTT(engine, batcher, partial_interval_s=60.0, endpointer=_ep())

    async def drive():
        evs = []
        for c in _chunks():
            evs += await stt.feed_async(c)
        return evs

    evs = asyncio.run(drive())
    assert [t for k, t in evs if k == "final"] == ref and ref
    assert stt.last_final is not None and stt.last_final.text == ref[0]


def test_stream_gauges_aggregate_across_instances(engine):
    """Concurrent streams' buffered seconds sum in the gauge."""
    s1 = StreamingSTT(engine, partial_interval_s=60.0)
    s2 = StreamingSTT(engine, partial_interval_s=60.0)
    s1.feed(tone(300, 0.5))
    g1 = get_metrics().snapshot()["gauges"]["stt.buffered_audio_s"]
    s2.feed(tone(400, 0.3))
    g2 = get_metrics().snapshot()["gauges"]["stt.buffered_audio_s"]
    assert g2 >= g1 + 0.25


# ------------------------------------------------- against the JAX batcher


def test_same_work_items_through_both_batchers_give_equal_tokens(engines):
    """Every work kind, one tick each side: partials (two utterances, two
    rounds of one), a spec_final and finals of ragged buckets, through
    JAX's ``STTBatcher`` (Pallas in interpret mode) and the port's."""
    jeng, teng = engines
    jb = JBatcher(jeng, slots=4, autostart=False)
    tb = STTBatcher(teng, slots=4, autostart=False)
    rounds = [
        [("partial", 1, tone(330, 1.0)), ("partial", 2, tone(400, 1.5)),
         ("spec_final", 3, tone(410, 0.7)), ("final", 4, tone(520, 1.8))],
        [("partial", 1, np.concatenate([tone(330, 1.0), tone(350, 0.5)])),
         ("final", 5, tone(300, 0.4)), ("final", 6, tone(260, 0.3))],
    ]
    for items in rounds:
        jf = [jb.submit(k, u, a) for k, u, a in items]
        tf = [tb.submit(k, u, a) for k, u, a in items]
        assert jb.tick() == tb.tick() == len(items)
        for (kind, _, _), j, t in zip(items, jf, tf):
            jr, tr = j.result(timeout=5), t.result(timeout=5)
            assert jr is not None and tr is not None, kind
            assert tr.text == jr.text and tr.n_frames == jr.n_frames, kind
    assert (tb.slot_of, [s and s.enc_len for s in tb.slot_state]) == (
        jb.slot_of, [s and s.enc_len for s in jb.slot_state])


def test_k5_plain_version_keeps_nan_in_stale_positions_out():
    """K5 at B = 4 with ragged cross kv_len (150, 100, 50, 0): NaN past each
    row's kv_len (a stale slot, a dead row) changes nothing, and the
    kv_len 0 row gives zeros."""
    g = torch.Generator().manual_seed(0)
    B, S, nh, hd = 4, 150, 4, 16
    q = torch.randn(B, nh, hd, generator=g)
    k = torch.randn(B, S, nh, hd, generator=g)
    v = torch.randn(B, S, nh, hd, generator=g)
    kv_len = torch.tensor([150, 100, 50, 0], dtype=torch.int32)
    clean = decode_attention(q, k, v, kv_len)
    kp, vp = k.clone(), v.clone()
    for b, n in enumerate(kv_len.tolist()):
        kp[b, n:] = float("nan")
        vp[b, n:] = float("nan")
    poisoned = decode_attention(q, kp, vp, kv_len)
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, clean)
    assert torch.equal(poisoned[3], torch.zeros_like(poisoned[3]))
