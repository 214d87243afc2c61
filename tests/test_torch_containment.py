"""Fault containment of the port's batched brain against the JAX package's.

The drills of JAX's ``tests/test_chaos.py`` (its engine-level ones and the
pool-accounting fuzz), run on test-tiny with one float32 weight tree in both
packages (the JAX engines on their default XLA path on the CPU, the port on
its kernels' plain versions), paged and dense, with the same chaos spec and
seed on both process-global ``Chaos`` controllers. Held exactly: the error
strings, every request's token ids, the quarantine list, the counter deltas
and the pool's free blocks. Beside them: ``Chaos`` itself against JAX's, the
epoch fence of ``reset``, the step ledger on a live batcher, and the
speculative engine's NaN injection in the verify step.
"""

import random

import jax
import numpy as np
import pytest
import torch

from tpu_voice_agent.serve import DecodeEngine as JDense
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.utils import chaos as jchaos
from tpu_voice_agent.utils import get_metrics as j_metrics
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.services.brain import install_prompt_prefix
from tpu_voice_agent_torch.utils import chaos as tchaos
from tpu_voice_agent_torch.utils.steplog import STAGES, get_steplog
from tpu_voice_agent_torch.utils.tracing import get_flight_recorder
from tpu_voice_agent_torch.utils.tracing import get_metrics as t_metrics

PROMPTS = [
    "search for laptops under 1000",
    "upload my resume and submit",
    "take a screenshot of this page",
    "scroll down two pages",
    "open the second result",
    "go back",
]
KW = dict(preset="test-tiny", max_len=1024, batch_slots=3,
          prefill_buckets=(128, 256, 512, 1024))
COUNTERS = ("scheduler.slots_quarantined", "scheduler.prefill_faults", "scheduler.cancelled",
            "scheduler.shed_expired", "scheduler.shed_pool", "scheduler.quarantine_rejected",
            "chaos.injected")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _chaos_hygiene():
    jchaos.reset()
    tchaos.reset()
    yield
    jchaos.reset()
    tchaos.reset()


@pytest.fixture(scope="module")
def weights():
    eng = JPaged(kernels="xla", **KW)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


def _pair(weights, layout: str):
    if layout == "paged":
        jeng = JPaged(kernels="xla", init_weights=False, radix_enable=False, **KW)
        teng = PagedDecodeEngine(init_weights=False, device="cpu", radix_enable=False, **KW)
    else:
        jeng = JDense(kernels="xla", init_weights=False, **KW)
        teng = DecodeEngine(init_weights=False, device="cpu", **KW)
    jeng.load_params(jax.device_put(weights))
    teng.load_params(bridge.params_from_numpy(weights))
    assert j_install(jeng) == install_prompt_prefix(teng) > 800
    return jeng, teng


@pytest.fixture(scope="module")
def paged(weights):
    return _pair(weights, "paged")


@pytest.fixture(scope="module")
def dense(weights):
    return _pair(weights, "dense")


@pytest.fixture(scope="module")
def clean(paged):
    """The undisturbed run every drill diffs against (the paged and dense
    layouts decode the same tokens)."""
    jeng, teng = paged
    j = JBatcher(jeng, chunk_steps=8, max_new_tokens=24).generate_many(PROMPTS)
    t = ContinuousBatcher(teng, chunk_steps=8, max_new_tokens=24).generate_many(PROMPTS)
    assert [r.token_ids for r in t] == [r.token_ids for r in j]
    assert all(r.error is None for r in t)
    return t


def _counters(snap_fn):
    c = snap_fn().snapshot()["counters"]
    return {k: c.get(k, 0.0) for k in COUNTERS}


def _free(eng):
    alloc = getattr(eng, "allocator", None)
    if alloc is None:
        return None
    return alloc.free_blocks(0) if isinstance(eng, (JPaged,)) else alloc.free_blocks()


def _drive(eng, Batcher, chaos_mod, spec, seed, script, **kw):
    """Run ``script(batcher)`` with ``spec`` armed on one package."""
    b = Batcher(eng, chunk_steps=kw.get("chunk_steps", 8),
                max_new_tokens=kw.get("max_new_tokens", 24))
    if spec:
        chaos_mod.configure(spec, seed)
    try:
        return b, script(b)
    finally:
        chaos_mod.reset()


def _both(pair, script, spec=None, seed=0, **kw):
    """The same script on the JAX batcher and the port's: returns both
    (batcher, result) pairs, the counter deltas and the free blocks after."""
    jeng, teng = pair
    out = []
    for eng, Batcher, mod, metrics in ((jeng, JBatcher, jchaos, j_metrics),
                                       (teng, ContinuousBatcher, tchaos, t_metrics)):
        before = _counters(metrics)
        b, res = _drive(eng, Batcher, mod, spec, seed, script, **kw)
        after = _counters(metrics)
        out.append((b, res, {k: after[k] - before[k] for k in COUNTERS}, _free(eng)))
    return out


def _errors_and_ids(res):
    return [(r.error, r.token_ids, r.finished) for r in res]


# ------------------------------------------------------------ Chaos itself


@pytest.mark.parametrize("spec", ["nan_logits:0.3", "alloc_fail:0.5,dead_fsm:0.1",
                                  "prefill_exc@3,replica_slow:0.7"])
@pytest.mark.parametrize("seed", [0, 11])
def test_chaos_fire_sequence_equals_jax(spec, seed):
    j, t = jchaos.Chaos(spec, seed), tchaos.Chaos(spec, seed)
    points = list(j.rules) + ["drop_frame"]  # an unarmed point never fires
    rng = random.Random(seed)
    for _ in range(300):
        p = rng.choice(points)
        assert t.fire(p) == j.fire(p), p
    assert t.counts == j.counts and t.rules == j.rules


def test_chaos_unknown_point_and_off_match_jax(monkeypatch):
    for mod in (jchaos, tchaos):
        with pytest.raises(ValueError, match="unknown chaos point 'tyop_fault'"):
            mod.Chaos("tyop_fault:0.5")
    monkeypatch.delenv("CHAOS_FAULTS", raising=False)
    tchaos.reset()
    assert not tchaos.get_chaos().enabled and not tchaos.chaos_fire("nan_logits")
    c = tchaos.Chaos("alloc_fail@3")
    assert [c.fire("alloc_fail") for _ in range(6)] == [False, False, True, False, False, False]
    # every point of JAX's plane is served now (the STT replica points came
    # with the replicated tier); an unknown one is refused at boot
    monkeypatch.setenv("CHAOS_FAULTS", "stt_replica_hang:1")
    tchaos.check_served_points()
    monkeypatch.setenv("CHAOS_FAULTS", "tyop_fault:1")
    with pytest.raises(ValueError, match="unknown chaos point 'tyop_fault'"):
        tchaos.check_served_points()


# ------------------------------------------------------------ the drills


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_drills_fail_the_victims_alone_as_jax_does(request, clean, layout):
    """nan_logits, dead_fsm and prefill_exc on three admissions: each victim
    fails with JAX's typed error, every batch-mate decodes the clean run's
    tokens, the counters move as JAX's do, and no block leaks."""
    pair = request.getfixturevalue(layout)
    free0 = _free(pair[1])
    (jb, jres, jd, jfree), (tb, tres, td, tfree) = _both(
        pair, lambda b: b.generate_many(PROMPTS), spec="nan_logits@2,dead_fsm@3,prefill_exc@5")
    assert _errors_and_ids(tres) == _errors_and_ids(jres)
    errs = [r.error for r in tres]
    assert errs[1] == "poisoned: non-finite logits"
    assert errs[2] == "poisoned: grammar dead state"
    assert errs[4] == "chaos: injected prefill exception"
    for i in (0, 3, 5):
        assert errs[i] is None and tres[i].token_ids == clean[i].token_ids, i
    assert td == jd
    assert (td["scheduler.slots_quarantined"], td["scheduler.prefill_faults"],
            td["chaos.injected"]) == (2, 1, 3)
    assert tfree == jfree == free0
    assert tb.quarantined() == jb.quarantined() == []  # one offence each


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_mid_decode_cancel_and_deadlines_match_jax(request, clean, layout):
    """A request cancelled after its first chunk is evicted at once; one
    whose deadline has run out before dequeue sheds there; one whose
    deadline runs out mid-decode is evicted between chunks. Batch-mates
    decode on untouched."""
    pair = request.getfixturevalue(layout)
    free0 = _free(pair[1])

    class Budget:  # a deadline the test expires by hand: both runs see one schedule
        def __init__(self, expired=False):
            self.expired = expired

    def script(b):
        mid = Budget()
        rids = [b.submit(PROMPTS[0]), b.submit(PROMPTS[1]), b.submit(PROMPTS[2], deadline=mid),
                b.submit(PROMPTS[3], deadline=Budget(True)), b.submit(PROMPTS[4])]
        b.step()  # three admitted, one chunk in
        assert b.cancel(rids[1], "test disconnect") and not b.cancel(rids[1])
        mid.expired = True
        b.run_until_done()
        return [b.results.pop(r) for r in rids]

    (_, jres, jd, jfree), (_, tres, td, tfree) = _both(pair, script)
    assert _errors_and_ids(tres) == _errors_and_ids(jres)
    assert [r.error for r in tres] == [None, "cancelled: test disconnect",
                                       "cancelled: deadline expired mid-decode",
                                       "shed: deadline expired in queue", None]
    assert tres[0].token_ids == clean[0].token_ids and tres[4].token_ids == clean[4].token_ids
    assert td == jd and (td["scheduler.cancelled"], td["scheduler.shed_expired"]) == (2, 1)
    assert tfree == jfree == free0


def test_repeat_offender_quarantined_and_surfaced_as_jax(paged):
    """Two poisonings of one prompt (``QUARANTINE_AFTER`` = 2) quarantine
    its fingerprint: the third submit is refused at once, the list matches
    JAX's, and another prompt still serves."""

    def script(b):
        out = []
        for _ in range(2):
            b._chaos.configure("nan_logits@1")
            out.append(b.generate_many([PROMPTS[0]])[0])
            b._chaos.reset()
        rid = b.submit(PROMPTS[0])
        assert rid in b.results and not b.pending  # refused at submit
        out.append(b.results.pop(rid))
        out.append(b.generate_many([PROMPTS[2]])[0])
        return out

    runs = []
    for eng, Batcher, mod, metrics in ((paged[0], JBatcher, jchaos, j_metrics),
                                       (paged[1], ContinuousBatcher, tchaos, t_metrics)):
        b = Batcher(eng, chunk_steps=8, max_new_tokens=24)
        b._chaos = mod
        before = _counters(metrics)
        res = script(b)
        after = _counters(metrics)
        runs.append((b, res, {k: after[k] - before[k] for k in COUNTERS}))
    (jb, jres, jd), (tb, tres, td) = runs
    assert _errors_and_ids(tres) == _errors_and_ids(jres)
    assert tres[2].error.startswith("quarantined: non-finite logits x2 (prompt 'search for")
    assert tres[3].error is None
    assert tb.quarantined() == jb.quarantined()
    assert tb.quarantined() == [{"preview": PROMPTS[0], "count": 2, "rejected": 1,
                                 "reason": "non-finite logits"}]
    assert td == jd and td["scheduler.quarantine_rejected"] == 1


def test_quarantine_freezes_the_flight_recorder_with_the_step_ring(paged):
    rec = get_flight_recorder()
    rec.rearm()
    try:
        b = ContinuousBatcher(paged[1], chunk_steps=8, max_new_tokens=24)
        tchaos.configure("dead_fsm@1")
        r = b.generate_many([PROMPTS[5]])[0]
        assert r.error == "poisoned: grammar dead state"
        dump = rec.frozen_dump()
        assert dump["reason"] == "scheduler.quarantine"
        assert dump["detail"] == "grammar dead state"
        assert dump["steplog"]["steps"], "the freeze carries the step ring"
    finally:
        rec.rearm()


def test_poisoned_and_cancelled_chains_never_enter_radix(weights):
    """With radix reuse on, an evicted request (poisoned, cancelled) frees
    its blocks without inserting its chain; a clean one inserts, as in
    JAX."""
    engs = []
    for cls, kw in ((JPaged, dict(kernels="xla")), (PagedDecodeEngine, dict(device="cpu"))):
        e = cls(init_weights=False, radix_enable=True, **kw, **KW)
        e.load_params(jax.device_put(weights) if cls is JPaged
                      else bridge.params_from_numpy(weights))
        engs.append(e)
    j_install(engs[0])
    install_prompt_prefix(engs[1])
    seen = []
    for eng, Batcher, mod in ((engs[0], JBatcher, jchaos), (engs[1], ContinuousBatcher, tchaos)):
        trees = eng.radix if isinstance(eng.radix, list) else [eng.radix]
        inserts = lambda: sum(t.inserts for t in trees)  # noqa: E731
        b = Batcher(eng, chunk_steps=8, max_new_tokens=24)
        assert b.generate_many([PROMPTS[0]])[0].error is None
        n0 = inserts()
        mod.configure("nan_logits@1")
        r = b.generate_many([PROMPTS[1]])[0]
        mod.reset()
        rid = b.submit(PROMPTS[2])
        b.step()
        b.cancel(rid, "gone")
        b.run_until_done()
        seen.append((n0, r.error, b.results.pop(rid).error, inserts(),
                     sum(t.nodes for t in trees), _free(eng)))
    assert seen[0] == seen[1]
    n0, err, cancelled, n1, _, _ = seen[1]
    assert err.startswith("poisoned:") and cancelled == "cancelled: gone" and n1 == n0


def test_pool_accounting_fuzz_zero_leaks_as_jax(paged):
    """Mixed waves of requests under probabilistic chaos (NaN rows, prefill
    faults, allocation failures), expired deadlines and cancellations: every
    outcome equals JAX's, and the pool ends at its starting free count."""
    free0 = _free(paged[1])

    class Budget:
        expired = True

    def script(b):
        rng = random.Random(11)
        out, submitted = [], 0
        while submitted < 36:
            wave = []
            for _ in range(rng.randint(2, 6)):
                p = f"{PROMPTS[submitted % 3]} v{submitted}"  # distinct fingerprints
                wave.append(b.submit(p, deadline=Budget() if rng.random() < 0.1 else None))
                submitted += 1
            b.step()
            if rng.random() < 0.3:
                b.cancel(wave[0], "fuzz")
            b.run_until_done()
            out += [b.results.pop(r) for r in wave]
        return out

    (_, jres, jd, jfree), (_, tres, td, tfree) = _both(
        paged, script, spec="nan_logits:0.15,prefill_exc:0.1,alloc_fail:0.05", seed=11,
        chunk_steps=4, max_new_tokens=4)
    assert _errors_and_ids(tres) == _errors_and_ids(jres)
    assert td == jd
    assert sum(r.error is not None for r in tres) >= 5
    assert tfree == jfree == free0


def test_reset_fences_a_step_in_flight_and_keeps_the_quarantine(paged):
    """``reset`` bumps the epoch: a step that was in flight discards its
    commit; the quarantine list survives; every block is back."""
    teng = paged[1]
    free0 = _free(teng)
    b = ContinuousBatcher(teng, chunk_steps=8, max_new_tokens=24)
    b._offenses["x"] = {"count": 2, "rejected": 0, "reason": "r", "preview": "x"}
    b.submit(PROMPTS[0])
    b.step()
    real = teng.decode_chunk

    def reset_mid_chunk(*a, **kw):
        out = real(*a, **kw)
        b.reset()  # as a restart on another thread would, mid-flight
        return out

    teng.decode_chunk = reset_mid_chunk
    try:
        b.step()
    finally:
        del teng.decode_chunk
    assert not b.results and not b.busy() and b._epoch == 1
    assert len(b.quarantined()) == 1
    assert _free(teng) == free0


# ------------------------------------------------------------ step ledger


def test_step_ledger_tiles_each_step_and_is_token_neutral(paged, clean):
    from tpu_voice_agent_torch.utils.compilewatch import get_compile_watcher

    log = get_steplog()
    log.clear()
    # the compile sentinel's leftovers from earlier work: the clean run warmed
    # every shape, so this run's steps carry no event
    get_compile_watcher().take_pending()
    res = ContinuousBatcher(paged[1], chunk_steps=8, max_new_tokens=24).generate_many(PROMPTS)
    steps = [s for s in log.steps() if s.get("occupancy")]
    assert steps and len(log.steps()) == log.dump()["recorded"]
    for s in steps:
        assert set(s["stages"]) <= set(STAGES) and s["events"] == []
        acct = sum(s["stages"].values())
        assert 0.95 * s["wall_ms"] <= acct <= s["wall_ms"] * 1.05 + 5e-3, s
        assert {"admit", "decode", "readback", "release"} <= set(s["stages"])
    assert sum(s["tokens"] for s in steps) == sum(r.steps for r in res)
    assert any(s.get("admitted") for s in steps)
    snap = t_metrics().snapshot()
    assert snap["latency_ms"]["engine.step.wall"]["count"] >= len(steps)
    assert "engine.step.occupancy" in snap["gauges"]
    log.enabled = False
    try:
        log.clear()
        off = ContinuousBatcher(paged[1], chunk_steps=8, max_new_tokens=24).generate_many(
            PROMPTS)
        assert log.steps() == []
    finally:
        log.enabled = True
    assert [r.token_ids for r in off] == [r.token_ids for r in res] == [
        r.token_ids for r in clean]


def test_all_admissions_shed_still_records_a_step(paged):
    class Budget:
        expired = True

    log = get_steplog()
    log.clear()
    b = ContinuousBatcher(paged[1], chunk_steps=8, max_new_tokens=24)
    b.submit(PROMPTS[0], deadline=Budget())
    b.step()
    assert b.results and log.steps()
    last = log.steps()[-1]
    assert (last["occupancy"], last["tokens"]) == (0, 0) and "admit" in last["stages"]


# ------------------------------------------------------------ speculation


def test_spec_verify_nan_injection_matches_jax(weights):
    """The speculative engine takes the drill's NaN mask in its first verify
    step: the victim is poisoned and its batch-mates' tokens equal the
    JAX spec engine's (and the plain stream's)."""
    from tpu_voice_agent.serve.spec import SpecConfig as JSpecConfig
    from tpu_voice_agent_torch.serve.spec import SpecConfig

    jeng = JPaged(kernels="xla", init_weights=False, radix_enable=False,
                  spec=JSpecConfig(k=4), **KW)
    teng = PagedDecodeEngine(init_weights=False, device="cpu", radix_enable=False,
                             spec=SpecConfig(k=4), **KW)
    jeng.load_params(jax.device_put(weights))
    teng.load_params(bridge.params_from_numpy(weights))
    j_install(jeng)
    install_prompt_prefix(teng)
    (_, jres, jd, jfree), (_, tres, td, tfree) = _both(
        (jeng, teng), lambda b: b.generate_many(PROMPTS[:3]), spec="nan_logits@2")
    assert _errors_and_ids(tres) == _errors_and_ids(jres)
    assert tres[1].error == "poisoned: non-finite logits"
    assert tres[0].error is None and tres[2].error is None
    assert td == jd and tfree == jfree


# ------------------------------------------------------------ the brain over HTTP


class _Served:
    """The port's brain on a free port, served from a thread."""

    def __init__(self, app):
        import threading

        self.app = app
        self.server = brain_mod().make_server(app, port=0)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self._t = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._t.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.app.close()


def brain_mod():
    from tpu_voice_agent_torch.services import brain

    return brain


def _counter(name):
    return t_metrics().snapshot()["counters"].get(name, 0.0)


def _wait(cond, timeout_s=60.0, what=""):
    import time

    end = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_admission_cap_answers_503_with_retry_after_as_jax():
    """``max_inflight`` 2 and 4 concurrent parses held in the parser: two are
    shed at the door with JAX's body and ``Retry-After``, counted in
    ``resilience.brain.shed_overload``, and the slots come back."""
    import threading

    import httpx

    from tests.http_helper import AppServer
    from tpu_voice_agent.services import brain as jbrain

    brain = brain_mod()
    outs = {}
    for side in ("jax", "port"):
        gate = threading.Event()
        entered = []

        rule = jbrain.RuleBasedParser() if side == "jax" else brain.RuleBasedParser()

        class Held:
            concurrent_safe = True

            def parse(self, text, context):
                entered.append(text)  # noqa: B023
                gate.wait(30)  # noqa: B023
                return rule.parse(text, context)  # noqa: B023

        if side == "jax":
            srv = AppServer(jbrain.build_app(Held(), max_inflight=2)).__enter__()
            url, close = srv.url, lambda: srv.__exit__(None, None, None)  # noqa: B023
        else:
            app = brain.BrainApp(Held(), max_inflight=2)
            served = _Served(app)
            url, close = served.url, served.close
        before = _counter("resilience.brain.shed_overload")
        res = []

        def post(i):
            res.append(httpx.post(url + "/parse", json={"text": f"scroll down {i}"},  # noqa: B023
                                  timeout=30))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        try:
            for th in threads:
                th.start()
            _wait(lambda: len(entered) == 2 and len(res) == 2, what="two sheds")  # noqa: B023
            gate.set()
            for th in threads:
                th.join(30)
            health = httpx.get(url + "/health", timeout=5).json()
        finally:
            gate.set()
            close()
        shed = [r for r in res if r.status_code == 503]
        outs[side] = ([(r.json(), r.headers["retry-after"]) for r in shed],
                      sorted(r.status_code for r in res), health["inflight"],
                      health["max_inflight"])
        if side == "port":
            assert _counter("resilience.brain.shed_overload") == before + 2
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == [({"error": "overloaded", "detail": "overload"}, "1")] * 2
    assert outs["port"][1:] == ([200, 200, 503, 503], 0, 2)


@pytest.fixture(scope="module")
def long_brain(weights):
    """A two-slot paged brain on the CPU whose random weights decode long:
    1000-token budgets, 4-step chunks."""
    brain = brain_mod()
    eng = PagedDecodeEngine(init_weights=False, device="cpu", radix_enable=False,
                            **{**KW, "max_len": 2048, "batch_slots": 2})
    eng.load_params(bridge.params_from_numpy(weights))
    install_prompt_prefix(eng)
    parser = brain.BatchedEngineParser(eng, chunk_steps=4, max_new_tokens=1000)
    served = _Served(brain.BrainApp(parser))
    yield served, parser
    served.close()
    parser.close()


def test_deadlines_and_disconnect_cancel_over_http(long_brain):
    """Behind a full batch: a request whose ``x-deadline-ms`` runs out while
    queued is shed at dequeue (503 ``overloaded``, Retry-After), one whose
    budget runs out mid-decode is evicted (500 ``cancelled: ...``), and a
    client that closes its socket mid-parse has its decode cancelled at a
    chunk boundary, its slot freed. The assertions wait on the counters."""
    import json as _json
    import socket
    import threading

    import httpx

    served, parser = long_brain
    b = parser.batcher
    c0 = {k: _counter(k) for k in ("scheduler.shed_expired", "scheduler.cancelled",
                                   "brain.parses_cancelled")}
    body = _json.dumps({"text": "search for laptops", "context": {}}).encode()
    sock = socket.create_connection(("127.0.0.1", served.server.server_address[1]))
    sock.sendall(b"POST /parse HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                 b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
    _wait(lambda: any(s.request_id >= 0 for s in b.slots), what="the raw parse admitted")
    res = {}

    def post(key, ms):
        res[key] = httpx.post(served.url + "/parse", json={"text": f"open {key}"},
                              headers={"x-deadline-ms": str(ms)}, timeout=60)

    mid = threading.Thread(target=post, args=("mid", 1500))
    mid.start()
    _wait(lambda: all(s.request_id >= 0 for s in b.slots), what="a full batch")
    post("queued", 300)  # returns once the mid-decode eviction frees a slot
    mid.join(60)
    assert res["queued"].status_code == 503
    assert res["queued"].json() == {"error": "overloaded",
                                    "detail": "shed: deadline expired in queue"}
    assert res["queued"].headers["retry-after"] == "1"
    assert res["mid"].status_code == 500
    assert res["mid"].json()["detail"] == "cancelled: deadline expired mid-decode"
    assert _counter("scheduler.shed_expired") == c0["scheduler.shed_expired"] + 1
    assert any(s.request_id >= 0 for s in b.slots), "the raw parse still decodes"
    sock.close()  # the client goes away mid-parse
    _wait(lambda: _counter("scheduler.cancelled") >= c0["scheduler.cancelled"] + 2,
          what="the disconnect's eviction")
    _wait(lambda: _counter("brain.parses_cancelled") == c0["brain.parses_cancelled"] + 1,
          what="the handler's cancel")
    _wait(lambda: not b.busy(), what="the batch to drain")
    assert parser.engine.allocator.blocks_in_use == len(parser.engine._prefix_blocks)


def test_replica_chaos_points_and_the_downgrade_latch(monkeypatch):
    """The replica points draw on ``POST /parse`` only: ``replica_slow``
    sleeps ``CHAOS_SLOW_S``; ``intent_downgrade`` latches JAX's degraded
    answer (``quality.intent_downgrades``); ``replica_kill`` latches the app
    dead and every later request, a health probe too, loses its
    connection."""
    import time

    import httpx

    from tpu_voice_agent.schemas import Intent, ParseResponse

    brain = brain_mod()
    monkeypatch.setenv("CHAOS_SLOW_S", "0.3")
    tchaos.configure("replica_slow@1,intent_downgrade@2,replica_kill@4")
    app = brain.BrainApp(brain.RuleBasedParser())
    served = _Served(app)
    try:
        assert httpx.get(served.url + "/health", timeout=5).status_code == 200  # no draw
        t0 = time.perf_counter()
        first = httpx.post(served.url + "/parse", json={"text": "scroll down"}, timeout=10)
        assert time.perf_counter() - t0 >= 0.3 and first.json()["intents"][0]["type"] == "scroll"
        down = [httpx.post(served.url + "/parse", json={"text": "scroll down"}, timeout=10)
                for _ in range(2)]
        assert down[0].json() == down[1].json()
        assert down[0].json()["intents"][0]["type"] == "unknown"
        assert down[0].json()["confidence"] == 0.1
        assert app.qmon.metrics.snapshot()["counters"]["quality.intent_downgrades"] == 2
        for path, method in (("/parse", "POST"), ("/health", "GET")):
            with pytest.raises(httpx.TransportError):
                httpx.request(method, served.url + path, json={"text": "x"}, timeout=5)
    finally:
        served.close()
    # the degraded answer is JAX's, field for field
    jresp = ParseResponse(intents=[Intent(type="unknown")], confidence=0.1,
                          follow_up_question="I did not catch a browser action - "
                                             "could you rephrase?")
    assert down[0].json() == jresp.model_dump()


class _EchoBatcher:
    """A batcher stand-in for ``ServingLoop``: each step answers every
    queued prompt with itself."""

    def __init__(self):
        self.results, self._queued, self._rid = {}, [], 0

    def submit(self, prompt, deadline=None):
        self._rid += 1
        self._queued.append((self._rid, prompt))
        return self._rid

    def busy(self):
        return bool(self._queued)

    def cancel(self, rid, reason):
        self._queued = [q for q in self._queued if q[0] != rid]

    def step(self):
        self.results.update(self._queued)
        self._queued = []


@pytest.mark.parametrize("how", ["cancel_before_result", "abandon"])
def test_serving_loop_survives_a_cancelled_future(monkeypatch, how):
    """A future cancelled by another thread just before the loop sets its
    result (the race between ``done()`` and ``set_result``), or abandoned by
    its waiter while it decodes, leaves the loop serving: the abandoned one
    ends cancelled, the next request is answered and the loop stays
    healthy."""
    import time
    from concurrent.futures import Future

    brain = brain_mod()

    class CancelledFirst(Future):
        def set_result(self, result):
            self.cancel()  # the other thread's cancel lands first
            super().set_result(result)

    class Stuck(_EchoBatcher):
        def step(self):  # "stuck" decodes on until it is cancelled
            time.sleep(0.001)
            self.results.update(q for q in self._queued if q[1] != "stuck")
            self._queued = [q for q in self._queued if q[1] == "stuck"]

    loop = brain.ServingLoop(Stuck())
    try:
        if how == "cancel_before_result":
            monkeypatch.setattr(brain, "Future", CancelledFirst)
            first = loop.submit("first")
            monkeypatch.setattr(brain, "Future", Future)
        else:
            first = loop.submit("stuck")
            _wait(lambda: loop.batcher._queued, what="the request in the batcher")
            loop.abandon(first)
        _wait(first.cancelled, what="the first future cancelled")
        assert loop.submit("second").result(timeout=30) == "second"
        assert loop.healthy() and loop.error is None
        assert not loop.batcher._queued
    finally:
        loop.stop()


def _tcp_pair():
    import socket

    with socket.create_server(("127.0.0.1", 0)) as srv:
        client = socket.create_connection(srv.getsockname())
        server, _ = srv.accept()
    return server, client


@pytest.mark.parametrize("case", ["open", "bytes_waiting", "peer_closed", "peer_reset",
                                  "past_fd_setsize"])
def test_socket_gone_probe(case):
    """``socket_gone`` says gone only for a peer that closed (an empty
    peek) or reset its socket; waiting request bytes are peeked, not eaten,
    and a descriptor past select's FD_SETSIZE (1024) is probed like any
    other."""
    import os
    import socket
    import struct

    brain = brain_mod()
    server, client = _tcp_pair()
    high = None
    try:
        if case == "bytes_waiting":
            client.sendall(b"GET")
            _wait(lambda: bool(__import__("select").select([server], [], [], 0)[0]),
                  what="the bytes to arrive")
        elif case == "peer_closed":
            client.close()
        elif case == "peer_reset":
            client.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            client.close()
        elif case == "past_fd_setsize":
            high = socket.socket(fileno=os.dup2(server.fileno(), 1500))
        probe = high if high is not None else server
        gone = case in ("peer_closed", "peer_reset")
        if gone:
            _wait(lambda: brain.socket_gone(probe), what="the probe to see the peer go")
        assert brain.socket_gone(probe) is gone
        if case == "bytes_waiting":
            assert server.recv(3) == b"GET"
    finally:
        for s in (server, client, high):
            if s is not None:
                s.close()
