"""The port's replicated STT tier (``tpu_voice_agent_torch/serve/stt_replicas.py``)
against the JAX package's, on the CPU.

JAX ``tests/test_stt_replicas.py``'s seven cases on the port's tier: finals
through the tier equal the engine's B = 1 transcribe and the JAX tier's on
the same weights, an utterance's work stays on one replica and ``release``
forgets it; a final fails over off a killed replica (counted, sticky on the
survivor); a whole-tier outage fails finals and sheds partials; the
``stt_replica_kill`` drill on live workers and the watchdog's warm restart;
the ``stt_replica_hang`` drill (the stalled-tick verdict on a stepped clock,
the hung final failed over, and the hung worker, once awake, launching
nothing); pressure shedding; the voice service's ``/health``. Beside them:
``resize`` grows and shrinks the tier without dropping a final, and the
batched streaming STT gives the same events over the tier as over one
batcher.

Both packages' ``SpeechEngine`` run ``whisper-test`` on one float32 random
weight tree (``bridge``), so tokens are held exactly.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models.whisper import init_params as j_init
from tpu_voice_agent.serve.stt import SpeechEngine as JSpeech
from tpu_voice_agent.serve.stt_replicas import STTReplicaTier as JTier
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.serve import stt_replicas
from tpu_voice_agent_torch.serve.stt import SpeechEngine
from tpu_voice_agent_torch.serve.stt_replicas import STTReplicaTier, current_tier
from tpu_voice_agent_torch.services.replicaset import rendezvous_weight
from tpu_voice_agent_torch.utils import chaos
from tpu_voice_agent_torch.utils.tracing import get_metrics

KW = {"preset": "whisper-test", "frame_buckets": (50, 100, 200), "max_new_tokens": 16}


def tone(freq, dur_s, amp=0.3, sr=16_000):
    t = np.arange(int(dur_s * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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


@pytest.fixture(autouse=True)
def _chaos_reset():
    chaos.reset()
    yield
    chaos.reset()


def _counters():
    return get_metrics().snapshot()["counters"]


def _utt_homed_on(tier, idx: int, base: int = 50_000) -> int:
    keys = [r.url for r in tier.replicas]
    for u in range(base, base + 10_000):
        if max(range(len(keys)), key=lambda j: rendezvous_weight(keys[j], str(u))) == idx:
            return u
    raise AssertionError("no utterance hashed onto the target replica")


def _tick_all(tier, rounds=8):
    for _ in range(rounds):
        for b in list(tier.batchers.values()):
            if b.healthy():
                b.tick()


class _Clock:
    """A stepped ``time.monotonic`` for the watchdog's stalled-tick verdict."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t


# ------------------------------------------------------------- placement


def test_tier_affinity_identity_and_release(engines):
    """Finals through the tier equal B = 1 transcribe and the JAX tier's
    finals; an utterance's work stays on one replica; release forgets it."""
    jeng, engine = engines
    tier = STTReplicaTier(engine, replicas=2, slots=4, autostart=False, register=False)
    jtier = JTier(jeng, replicas=2, slots=4, autostart=False, register=False)
    try:
        audios = {60_001: tone(300, 0.4), 60_002: tone(440, 0.9)}
        singles = {u: engine.transcribe(a) for u, a in audios.items()}
        futs = {u: tier.submit("final", u, a) for u, a in audios.items()}
        jfuts = {u: jtier.submit("final", u, a) for u, a in audios.items()}
        _tick_all(tier)
        _tick_all(jtier)
        for u, f in futs.items():
            res = f.result(timeout=60)
            assert res.token_ids == singles[u].token_ids
            assert jfuts[u].result(timeout=60).text == res.text == singles[u].text
        assert dict(tier._sessions) == dict(jtier._sessions)
        u = 60_003
        tier.submit("partial", u, tone(330, 1.0))
        home = tier._sessions[str(u)]
        tier.submit("final", u, tone(330, 1.0))
        assert tier._sessions[str(u)] == home
        _tick_all(tier)
        tier.release(u)
        assert str(u) not in tier._sessions
        assert all(u not in b.slot_of for b in tier.batchers.values())
    finally:
        tier.stop()
        jtier.stop()


# -------------------------------------------------------------- failover


def test_final_fails_over_off_a_killed_replica(engine):
    tier = STTReplicaTier(engine, replicas=2, slots=4, autostart=False, register=False)
    try:
        u = _utt_homed_on(tier, 0)
        audio = tone(410, 0.7)
        ref = engine.transcribe(audio).token_ids
        c0 = dict(_counters())
        fut = tier.submit("final", u, audio)
        assert tier._sessions[str(u)] == tier.replicas[0].url
        tier.batchers[0].kill(RuntimeError("crashed"))
        _tick_all(tier)
        assert fut.result(timeout=60).token_ids == ref
        c = _counters()
        assert c["stt.replica_failovers"] - c0.get("stt.replica_failovers", 0) == 1
        assert c["stt.replica_rehomed"] - c0.get("stt.replica_rehomed", 0) == 1
        assert tier._sessions[str(u)] == tier.replicas[1].url
        fut2 = tier.submit("final", u, audio)
        _tick_all(tier)
        assert fut2.result(timeout=60).token_ids == ref
        assert _counters()["stt.replica_rehomed"] - c0.get("stt.replica_rehomed", 0) == 1
    finally:
        tier.stop()


def test_all_replicas_down_fails_finals_sheds_partials(engine):
    tier = STTReplicaTier(engine, replicas=2, slots=4, autostart=False, register=False)
    try:
        for b in tier.batchers.values():
            b.kill(RuntimeError("gone"))
        with pytest.raises(RuntimeError):
            tier.submit("final", 61_000, tone(300, 0.4)).result(timeout=5)
        assert tier.submit("partial", 61_001, tone(300, 0.4)).result(timeout=5) is None
        # a killed batcher refuses at submit, under its lock
        with pytest.raises(RuntimeError, match="down"):
            tier.batchers[0].submit("final", 61_002, tone(300, 0.4)).result(timeout=5)
    finally:
        tier.stop()


# -------------------------------------------------------------- watchdog


def test_watchdog_warm_restarts_killed_replica_and_ring_recovers(engine):
    """``stt_replica_kill@1`` on live workers: the first worker to take a
    batch dies; its finals fail over and equal the reference; two sweeps
    eject and warm-restart it (a fresh batcher, a pool of its own, the same
    engine) and the next sweep re-admits it."""
    tier = STTReplicaTier(engine, replicas=2, slots=4, probe_s=3600.0, stall_s=3600.0,
                          register=False)
    try:
        audios = [tone(300, 0.4), tone(440, 0.9)]
        refs = [engine.transcribe(a).token_ids for a in audios]
        chaos.configure("stt_replica_kill@1", seed=3)
        r0 = _counters().get("stt.replica_restarts", 0)
        futs = [tier.submit("final", 62_000 + i, a) for i, a in enumerate(audios)]
        assert [f.result(timeout=60).token_ids for f in futs] == refs
        dead = [r for r in tier.replicas if not tier.batchers[r.idx].healthy()]
        assert len(dead) == 1
        victim = dead[0]
        old = tier.batchers[victim.idx]
        tier.sweep_once()
        tier.sweep_once()  # probe_fails_limit = 2: ejected and restarted
        assert _counters()["stt.replica_restarts"] - r0 == 1
        fresh = tier.batchers[victim.idx]
        assert fresh is not old and fresh.engine is old.engine and fresh.healthy()
        assert fresh.pool["k"].data_ptr() != old.pool["k"].data_ptr()
        tier.sweep_once()
        assert victim.state == "up" and tier.tier_health()["healthy"] == 2
        u = _utt_homed_on(tier, tier.replicas.index(victim), base=63_000)
        assert tier.submit("final", u, audios[0]).result(timeout=60).token_ids == refs[0]
    finally:
        tier.stop()


def test_stalled_tick_watchdog_restarts_hung_replica(engine, monkeypatch):
    """``stt_replica_hang@1``: the worker sleeps before its batch; ticks
    frozen past ``stall_s`` on the watchdog's clock eject and warm-restart
    the replica, the hung final fails over and equals the reference, and
    the hung worker, once awake, returns without a launch (its batcher's
    tick count never moves)."""
    monkeypatch.setenv("CHAOS_HANG_S", "1.5")
    clock = _Clock()
    monkeypatch.setattr(stt_replicas, "time", clock)
    tier = STTReplicaTier(engine, replicas=2, slots=4, probe_s=3600.0, stall_s=0.6,
                          register=False)
    try:
        audio = tone(520, 0.6)
        ref = engine.transcribe(audio).token_ids
        chaos.configure("stt_replica_hang@1", seed=3)
        r0 = _counters().get("stt.replica_restarts", 0)
        u = 64_000
        fut = tier.submit("final", u, audio)
        hung = next(r for r in tier.replicas if r.url == tier._sessions[str(u)])
        old = tier.batchers[hung.idx]
        for _ in range(3000):  # the worker took the batch and sleeps in it
            with old._wake:
                if old._busy and not old.queue:
                    break
            threading.Event().wait(0.001)
        ticks0 = old.ticks
        tier.sweep_once()  # the baseline of the stalled verdict
        clock.t += 1.0
        tier.sweep_once()
        tier.sweep_once()  # two stalled sweeps: ejected, warm-restarted
        assert _counters()["stt.replica_restarts"] - r0 == 1
        assert fut.result(timeout=60).token_ids == ref  # failed over, not lost
        assert tier.batchers[hung.idx] is not old
        old._thread.join(timeout=30)  # the hang ends; the worker exits
        assert not old._thread.is_alive() and old.ticks == ticks0
    finally:
        tier.stop()


def test_killed_batcher_stalled_mid_decode_launches_nothing_more(engine, monkeypatch):
    """A worker stalled inside its batch (in the decode loop, not at the
    chaos point) when the batcher is killed: the forward it is in finishes,
    then it launches no decoder forward and no encode, its future stays
    failed, and its thread exits."""
    from tpu_voice_agent_torch.serve import stt as stt_mod
    from tpu_voice_agent_torch.serve.stt_batch import STTBatcher

    audio = tone(440, 0.8)
    ref = engine.transcribe(audio)
    assert len(ref.token_ids) >= 2  # the decode runs past the stalled step
    real = stt_mod.decoder_forward
    calls = []
    stalled, resume = threading.Event(), threading.Event()

    def slow_forward(*a, **k):
        calls.append(threading.get_ident())
        if len(calls) == 2:
            stalled.set()
            resume.wait(timeout=60)
        return real(*a, **k)

    monkeypatch.setattr(stt_mod, "decoder_forward", slow_forward)
    b = STTBatcher(engine, slots=2)
    try:
        fut = b.submit("final", 1, audio)
        assert stalled.wait(timeout=60)
        b.kill(RuntimeError("killed"))
        n_at_kill = len(calls)
        resume.set()
        b._thread.join(timeout=60)
        assert not b._thread.is_alive()
        assert len(calls) == n_at_kill  # nothing after the forward in flight
        with pytest.raises(RuntimeError, match="killed"):
            fut.result(timeout=1)
        assert b.ticks == 0
    finally:
        resume.set()
        b.stop()


# -------------------------------------------------------------- pressure


def test_pressure_sheds_new_utterances_off_loaded_replica(engine):
    tier = STTReplicaTier(engine, replicas=2, slots=2, max_pending=4, autostart=False,
                          register=False)
    try:
        sticky = _utt_homed_on(tier, 0, base=65_000)
        tier.submit("final", sticky, tone(300, 0.4))
        extra = []
        while len(tier.batchers[0].queue) < tier.batchers[0].max_pending:
            u = _utt_homed_on(tier, 0, base=66_000 + len(extra) * 7)
            if str(u) in tier._sessions:
                u += 1
            tier.submit("final", u, tone(330, 0.4))
            extra.append(u)
        tier.sweep_once()
        assert tier.replicas[0].pressure >= tier.shed_pressure
        shed0 = _counters().get("stt.replica_shed_pressure", 0)
        fresh = _utt_homed_on(tier, 0, base=70_000)
        tier.submit("partial", fresh, tone(300, 1.0))
        assert tier._sessions[str(fresh)] == tier.replicas[1].url
        assert _counters()["stt.replica_shed_pressure"] - shed0 == 1
        assert tier._sessions[str(sticky)] == tier.replicas[0].url
        _tick_all(tier, rounds=12)
    finally:
        tier.stop()


# ----------------------------------------------------- voice /health


def test_voice_health_surfaces_stt_replica_ring(engine):
    from tpu_voice_agent_torch.serve.stt import NullSTT
    from tpu_voice_agent_torch.services import ws
    from tpu_voice_agent_torch.services.voice import VoiceConfig, build_app

    from tests.torch_fleet_helper import get

    tier = STTReplicaTier(engine, replicas=2, slots=2, autostart=False)
    voice = ws.ServerThread(build_app(VoiceConfig(
        brain_url="http://127.0.0.1:1", executor_url="http://127.0.0.1:1",
        stt_factory=lambda: NullSTT()))).__enter__()
    try:
        assert current_tier() is tier
        assert get(voice.url + "/health")[1]["stt_replicas"] == {"total": 2, "healthy": 2,
                                                                  "draining": 0}
        tier.batchers[0].kill(RuntimeError("x"))
        tier.sweep_once()
        tier.sweep_once()
        assert tier.replicas[0].state == "down"
        assert get(voice.url + "/health")[1]["stt_replicas"] == {"total": 2, "healthy": 1,
                                                                  "draining": 0}
        tier.sweep_once()
        assert tier.replicas[0].state == "up"
    finally:
        voice.__exit__(None, None, None)
        tier.stop()
    assert current_tier() is None


# ----------------------------------------------------- elastic resize


def test_resize_grows_and_shrinks_without_dropping_a_final(engine):
    tier = STTReplicaTier(engine, replicas=1, slots=2, probe_s=3600.0, register=False)
    try:
        assert tier.resize(3) == 3 and len(tier.batchers) == 3
        audio = tone(350, 0.5)
        ref = engine.transcribe(audio).token_ids
        futs = [tier.submit("final", 67_000 + i, audio) for i in range(6)]
        assert tier.resize(1) == 1  # drains each victim's work before it goes
        assert [f.result(timeout=60).token_ids for f in futs] == [ref] * 6
        assert [r.idx for r in tier.replicas] == [0] and list(tier.batchers) == [0]
    finally:
        tier.stop()


def test_streaming_over_the_tier_equals_one_batcher(engine):
    """``BatchedStreamingSTT`` over the tier gives the events it gives over
    one batcher on the same audio."""
    from tpu_voice_agent_torch.audio.endpoint import EnergyEndpointer
    from tpu_voice_agent_torch.serve.stt_batch import BatchedStreamingSTT, STTBatcher

    audio = np.concatenate([np.zeros(8000, np.float32), tone(330, 1.2),
                            np.zeros(16000, np.float32)])
    out = {}
    for name in ("batcher", "tier"):
        b = (STTBatcher(engine, slots=4) if name == "batcher"
             else STTReplicaTier(engine, replicas=2, slots=4, register=False))
        try:
            s = BatchedStreamingSTT(engine, b, endpointer=EnergyEndpointer(
                sample_rate=engine.mel_cfg.sample_rate))
            s._defer_final = False
            events = []
            for i in range(0, len(audio), 960):
                events += s.feed(audio[i:i + 960])
            b.drain(60.0)
            out[name] = [e for e in events if e[0] == "final"]
        finally:
            b.stop()
    assert out["tier"] == out["batcher"] and out["tier"]
