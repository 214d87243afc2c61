"""The planner backend behind /parse: JAX's ``tests/test_brain_planner.py``
cases on the port's ``PlannerParser`` and ``_PlanGather``.

The bookkeeping cases (isolation, LRU and byte-aware eviction, parking, the
park budgets, the lock surviving a park failure, speculative commit and
rollback) run on JAX's deterministic planner stub, as JAX's do; the decode
cases run the port's ``LongSessionPlanner`` at test-tiny on a CPU mesh (its
tokens are held to JAX's in ``tests/test_torch_longctx.py``). Random weights
may truncate before EOS: a 422 is the one legal failure.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_voice_agent_torch.parallel import sp_mesh
from tpu_voice_agent_torch.schemas import validate_parse_response
from tpu_voice_agent_torch.serve.planner import LongSessionPlanner
from tpu_voice_agent_torch.services import brain
from tpu_voice_agent_torch.services.brain import ParserError, PlannerParser, _PlanGather
from tpu_voice_agent_torch.utils.tracing import get_metrics

CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: intra-op threads buy nothing under the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planner(**kw):
    args = dict(preset="test-tiny", mesh=sp_mesh(4, CPU4), ctx_buckets=(1024, 2048),
                extend_buckets=(64, 128), max_new_tokens=64)
    args.update(kw)
    return LongSessionPlanner(**args)


@pytest.fixture(scope="module")
def planner_server():
    app = brain.BrainApp(PlannerParser(_planner(), max_new_tokens=64))
    server = brain.make_server(app, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def _parse(url, text, session_id=None, speculative=None):
    body = {"text": text, "context": {}}
    if session_id is not None:
        body["session_id"] = session_id
    if speculative is not None:
        body["speculative"] = speculative
    req = urllib.request.Request(url + "/parse", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_planner_parse_contract(planner_server):
    status, data = _parse(planner_server, "search for usb hubs", session_id="s1")
    assert status in (200, 422)  # 422 = truncation, the one legal failure
    if status == 200:  # a ParseResponse, every default field filled
        assert data["version"] == "1.0" and isinstance(data["intents"], list)
        assert validate_parse_response(data) == (data, None)
    else:
        assert data["error"] == "schema_validation_failed"


def test_planner_session_accumulates(planner_server):
    s1, _ = _parse(planner_server, "search for laptops", session_id="s2")
    s2, _ = _parse(planner_server, "sort by price", session_id="s2")
    assert s1 in (200, 422) and s2 in (200, 422)


def test_planner_http_speculative_commit(planner_server):
    """Speculative requests are accepted (two-phase turns); a matching final
    answers the speculative turn's response."""
    r1 = _parse(planner_server, "search for usb hubs", "sp1", True)
    r2 = _parse(planner_server, "search for usb hubs", "sp1", False)
    assert r1[0] in (200, 422) and r2[0] in (200, 422)
    if r1[0] == 200 and r2[0] == 200:
        assert r1[1] == r2[1]


_PLAN_OK = (
    '{"version":"1.0","intents":[{"type":"scroll","target":null,"args":{},'
    '"priority":1,"requires_confirmation":false,"timeout_ms":15000,'
    '"retries":0}],"context_updates":{},"confidence":0.9,"tts_summary":null,'
    '"follow_up_question":null}'
)


class _StubPlanner:
    """JAX's deterministic planner stub (random tiny models cannot promise an
    EOS); transcript growth mimics start / extend / plan."""

    max_new_tokens = 64

    def __init__(self, plan_text: str = _PLAN_OK, bytes_per_session: int = 0):
        self._mk = lambda: SimpleNamespace(ids=list(range(5)), pos=5, anchors=1,
                                           last_logits=object(), cache=None)
        self.plan_text = plan_text
        self.bytes_per_session = bytes_per_session

    def start(self, text):
        return self._mk()

    def extend(self, sess, text):
        sess.ids.extend([7] * 3)

    def plan(self, sess, max_new_tokens=None):
        sess.ids.extend([9] * 4)
        return self.plan_text, [9] * 4

    def plan_many(self, sessions, max_new_tokens=None, **kw):
        return [self.plan(s, max_new_tokens) for s in sessions]

    def session_bytes(self, sess):
        return 0 if getattr(sess, "parked", False) else self.bytes_per_session

    def park(self, sess):
        sess.parked = True

    def unpark(self, sess):
        sess.parked = False

    def parked_bytes(self, sess):
        return self.bytes_per_session if getattr(sess, "parked", False) else 0


class _CountingPlanner(_StubPlanner):
    """Counts plan decodes (speculation must not decode twice)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.plans = 0

    def plan_many(self, sessions, max_new_tokens=None, **kw):
        self.plans += len(sessions)
        return super().plan_many(sessions, max_new_tokens, **kw)


def test_planner_sessions_isolated_and_evicted():
    parser = PlannerParser(_StubPlanner())
    parser.max_sessions = 2
    for sid in ("a", "b"):
        parser.parse("scroll down", {}, session_id=sid)
    assert parser.session_count() == 2
    parser.parse("scroll down", {}, session_id="c")  # evicts LRU "a"
    assert parser.session_count() == 2
    assert "a" not in parser._sessions and "c" in parser._sessions
    sess_b = parser._sessions["b"]
    n_before = len(sess_b.ids)
    parser.parse("scroll down", {}, session_id="b")  # extends, not restarts
    assert parser._sessions["b"] is sess_b and len(sess_b.ids) > n_before


def test_planner_truncated_plan_drops_session():
    """A plan that fails validation drops its session: its transcript ends
    in half-JSON."""
    parser = PlannerParser(_StubPlanner(plan_text='{"version":"1.0","int'))
    with pytest.raises(ParserError) as ei:
        parser.parse("scroll down", {}, session_id="s")
    assert ei.value.kind == "schema_validation_failed"
    assert parser.session_count() == 0


def test_planner_no_session_id_is_one_shot():
    parser = PlannerParser(_StubPlanner())
    resp = parser.parse("scroll down", {}, session_id=None)
    assert resp["intents"][0]["type"] == "scroll" and parser.session_count() == 0


def test_planner_byte_aware_eviction():
    parser = PlannerParser(_StubPlanner(bytes_per_session=1 << 20),
                           hbm_budget_bytes=int(2.5 * (1 << 20)))
    for sid in ("a", "b", "c", "d"):
        parser.parse("scroll down", {}, session_id=sid)
    assert parser.session_count() == 2
    assert parser.session_hbm_bytes() <= int(2.5 * (1 << 20))
    assert "d" in parser._sessions and "c" in parser._sessions


def test_planner_budgets_read_from_the_environment(monkeypatch):
    monkeypatch.setenv("BRAIN_PLANNER_HBM_MB", "3")
    monkeypatch.setenv("BRAIN_PLANNER_PARK_MB", "0")
    parser = PlannerParser(_StubPlanner())
    assert (parser.hbm_budget_bytes, parser.park_budget_bytes) == (3 << 20, 0)
    monkeypatch.delenv("BRAIN_PLANNER_HBM_MB")
    monkeypatch.delenv("BRAIN_PLANNER_PARK_MB")
    parser = PlannerParser(_StubPlanner())
    assert (parser.hbm_budget_bytes, parser.park_budget_bytes) == (2048 << 20, 4096 << 20)


def test_evicted_session_parks_to_host_and_resumes():
    parser = PlannerParser(_StubPlanner(bytes_per_session=1 << 20))
    parser.max_sessions = 2
    parser.parse("scroll down", {}, session_id="a")
    sess_a = parser._sessions["a"]
    n_before = len(sess_a.ids)
    parser.parse("scroll down", {}, session_id="b")
    parser.parse("scroll down", {}, session_id="c")  # evicts "a" -> parked
    assert "a" not in parser._sessions and "a" in parser._parked
    assert sess_a.parked is True
    parser.parse("go back", {}, session_id="a")  # resumes the SAME session
    assert parser._sessions["a"] is sess_a and sess_a.parked is False
    assert len(sess_a.ids) > n_before


def test_park_budget_zero_disables_offload():
    parser = PlannerParser(_StubPlanner(bytes_per_session=1 << 20))
    parser.max_sessions = 1
    parser.park_budget_bytes = 0
    parser.parse("scroll down", {}, session_id="a")
    parser.parse("scroll down", {}, session_id="b")
    assert "a" not in parser._sessions and not parser._parked


def test_parked_overflow_drops_oldest():
    parser = PlannerParser(_StubPlanner(bytes_per_session=1 << 20))
    parser.max_sessions = 1
    parser.park_budget_bytes = 2 << 20
    for sid in ("a", "b", "c", "d"):
        parser.parse("scroll down", {}, session_id=sid)
    assert list(parser._sessions) == ["d"]
    assert list(parser._parked) == ["b", "c"]


def test_checkin_survives_park_failure_without_leaking_lock():
    """``park`` raising after ``_busy`` is cleared must still release the
    session's lock; the victim is dropped and the request succeeds."""
    planner = _StubPlanner(bytes_per_session=1 << 20)

    def bad_park(sess):
        raise RuntimeError("injected device failure")

    planner.park = bad_park
    parser = PlannerParser(planner, hbm_budget_bytes=1)  # evict on every checkin
    failed0 = get_metrics().snapshot()["counters"].get("planner.sessions_park_failed", 0)
    parser.parse("scroll down", {}, session_id="a")
    assert parser.parse("scroll down", {}, session_id="b")["intents"]
    assert "a" not in parser._parked and "a" not in parser._sessions
    assert get_metrics().snapshot()["counters"]["planner.sessions_park_failed"] > failed0
    done, err = threading.Event(), []

    def turn():
        try:
            parser.parse("scroll up", {}, session_id="b")
        except Exception as e:  # pragma: no cover - diagnostic only
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=turn, daemon=True).start()
    assert done.wait(timeout=10.0), "second turn deadlocked: lock leaked by _checkin"
    assert not err


def test_plan_gather_groups_heterogeneous_budgets():
    """Co-queued requests with different budgets are grouped by budget, not
    clipped to min()."""
    calls, first_entered, release = [], threading.Event(), threading.Event()

    class _RecordingPlanner:
        def plan_many(self, sessions, max_new_tokens=None, **kw):
            calls.append((len(sessions), max_new_tokens))
            if len(calls) == 1:
                first_entered.set()
                release.wait(timeout=10.0)
            return [("{}", [1]) for _ in sessions]

    g = _PlanGather(_RecordingPlanner(), max_batch=8)
    results = {}

    def submit(name, budget):
        results[name] = g.plan(object(), budget)

    t0 = threading.Thread(target=submit, args=("first", 5), daemon=True)
    t0.start()
    assert first_entered.wait(timeout=10.0)
    ts = [threading.Thread(target=submit, args=(f"r{i}", b), daemon=True)
          for i, b in enumerate([10, 20, 10])]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 10.0
    while g._q.qsize() < 3:
        assert time.monotonic() < deadline, "submissions never queued"
        time.sleep(0.005)
    release.set()
    for t in [t0] + ts:
        t.join(timeout=10.0)
    assert len(results) == 4
    assert sorted(calls[1:]) == [(1, 20), (2, 10)], calls


def test_planner_concurrent_sessions_share_batched_decode():
    """8 sessions parse at once; the gather batches their plan decodes."""
    parser = PlannerParser(_planner(ctx_buckets=(1024,), extend_buckets=(64,),
                                    max_new_tokens=48))
    before = get_metrics().snapshot()["counters"].get("planner.batched_plans", 0)
    results: dict = {}

    def turn(sid):
        try:
            results[sid] = parser.parse(f"search for {sid} gadgets", {}, session_id=sid)
        except ParserError as e:  # truncation is legal for random weights
            results[sid] = e

    threads = [threading.Thread(target=turn, args=(f"s{i}",)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert len(results) == 8
    assert all(isinstance(r, (dict, ParserError)) for r in results.values())
    after = get_metrics().snapshot()["counters"].get("planner.batched_plans", 0)
    assert after > before, "concurrent plans never shared a batched dispatch"


def test_plan_many_matches_sequential_plan():
    texts = ["search for red shoes", "scroll down two pages", "go back now"]
    p1, p2 = _planner(max_new_tokens=120), _planner(max_new_tokens=120)
    seq = [p1.plan(p1.start(t)) for t in texts]
    assert p2.plan_many([p2.start(t) for t in texts]) == seq


def test_plan_many_preserves_slot0_kv_of_early_finishers():
    """A row that stops before its batchmates parks its writes at slot 0 of
    its own line; ``plan_many`` restores every row's slot 0."""
    planner = _planner(ctx_buckets=(1024,), max_new_tokens=120)
    texts = ["search for red shoes", "scroll down two pages", "go back now"]
    sessions = [planner.start(t) for t in texts]
    before = [(s.cache["k"][:, 0, 0].clone(), s.cache["v"][:, 0, 0].clone()) for s in sessions]
    counts = [len(ids) for _, ids in planner.plan_many(sessions)]
    # the regression bites only when rows finish at different steps
    assert len(set(counts)) > 1, f"all rows finished together: {counts}"
    for sess, (k0, v0) in zip(sessions, before):
        assert torch.equal(sess.cache["k"][:, 0, 0], k0)
        assert torch.equal(sess.cache["v"][:, 0, 0], v0)
        assert sess.cache["k"].shape[1] == 1  # its own storage, not the batch's


def test_real_planner_park_roundtrip_preserves_decode():
    p1, p2 = _planner(max_new_tokens=100), _planner(max_new_tokens=100)
    s1, s2 = p1.start("search for red shoes"), p2.start("search for red shoes")
    p1.plan(s1)
    p2.plan(s2)
    live = p2.session_bytes(s2)
    p2.park(s2)
    assert s2.parked and s2.cache["k"].device.type == "cpu"
    assert p2.session_bytes(s2) == 0 and p2.parked_bytes(s2) == live > 0
    p2.unpark(s2)
    assert not s2.parked and p2.session_bytes(s2) == live and p2.parked_bytes(s2) == 0
    for p, s in ((p1, s1), (p2, s2)):
        p.extend(s, "\n<|user|>\nsort by price\n<|assistant|>\n")
    assert p1.plan(s1) == p2.plan(s2)


def test_planner_fast_forward_stays_in_grammar():
    """``fast_forward`` > 0 routes a single-session plan through the forced
    chains (K3 on the card); the stream still walks the grammar. The ff
    tables share the base tables' tensors."""
    p8 = _planner(max_new_tokens=120, fast_forward=8)
    t8, ids8 = p8.plan(p8.start("search for red shoes"))
    assert p8.fsm.walk(ids8) >= 0, "ff plan left the grammar"
    assert t8.startswith('{"version":"1.0","intents":[')
    assert p8.tables_ff.table is p8.tables.table
    assert p8.tables_ff.col_id is p8.tables.col_id


def test_planner_refusals():
    with pytest.raises(ValueError, match="sp mesh"):
        LongSessionPlanner(preset="test-tiny", mesh=[])
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        _planner(ctx_buckets=(1026,))


def test_forced_chain_tables_only_for_a_single_session(monkeypatch):
    """JAX's rule at its default kernels: a single-session batch decodes on
    the ff tables, a padded batch of two on the base tables."""
    import tpu_voice_agent_torch.serve.planner as planner_mod

    seen = []
    loop = planner_mod.chunk_decode_loop

    def spy(*args, **kw):
        seen.append(args[8])
        return loop(*args, **kw)

    monkeypatch.setattr(planner_mod, "chunk_decode_loop", spy)
    p8 = _planner(max_new_tokens=8, fast_forward=8)
    p8.plan_many([p8.start("search for red shoes")], max_new_tokens=8)
    p8.plan_many([p8.start("open the cart"), p8.start("scroll down")], max_new_tokens=8)
    assert seen[0] is p8.tables_ff and seen[1] is p8.tables


def test_planner_speculative_commit_is_one_decode():
    planner = _CountingPlanner()
    parser = PlannerParser(planner)
    r1 = parser.parse("scroll down", {}, session_id="s", speculative=True)
    n_after_spec = len(parser._sessions["s"].ids)
    r2 = parser.parse("scroll down", {}, session_id="s")
    assert planner.plans == 1 and r2 == r1
    assert len(parser._sessions["s"].ids) == n_after_spec
    assert getattr(parser._sessions["s"], "pending_spec", None) is None


def test_planner_speculative_mismatch_rolls_back():
    parser = PlannerParser(_CountingPlanner())
    parser.parse("first turn", {}, session_id="a")
    parser.parse("sort by price", {}, session_id="a", speculative=True)
    parser.parse("scroll down", {}, session_id="a")  # a DIFFERENT final
    ref = PlannerParser(_CountingPlanner())
    ref.parse("first turn", {}, session_id="a")
    ref.parse("scroll down", {}, session_id="a")
    assert parser._sessions["a"].ids == ref._sessions["a"].ids


def test_planner_speculative_fresh_session_mismatch_drops_provisional():
    parser = PlannerParser(_CountingPlanner())
    parser.parse("sort by price", {}, session_id="n", speculative=True)
    parser.parse("scroll down", {}, session_id="n")
    ref = PlannerParser(_CountingPlanner())
    ref.parse("scroll down", {}, session_id="n")
    assert parser._sessions["n"].ids == ref._sessions["n"].ids


def test_planner_eviction_rolls_back_pending_speculation():
    parser = PlannerParser(_CountingPlanner(bytes_per_session=1 << 20), hbm_budget_bytes=1)
    parser.max_sessions = 1
    parser.parse("first turn", {}, session_id="a")
    parser.parse("sort by price", {}, session_id="a", speculative=True)
    parser.parse("other session", {}, session_id="b")  # evicts "a" (parked)
    parser.parse("sort by price", {}, session_id="a")  # the matching final
    ref = PlannerParser(_CountingPlanner())
    ref.parse("first turn", {}, session_id="a")
    ref.parse("sort by price", {}, session_id="a")
    assert parser._sessions["a"].ids == ref._sessions["a"].ids


def test_planner_speculative_commit_requires_same_context():
    planner = _CountingPlanner()
    parser = PlannerParser(planner)
    parser.parse("sort by price", {"page": 1}, session_id="c", speculative=True)
    parser.parse("sort by price", {"page": 2}, session_id="c")
    assert planner.plans == 2  # no stale commit
    ref = PlannerParser(_CountingPlanner())
    ref.parse("sort by price", {"page": 2}, session_id="c")
    assert parser._sessions["c"].ids == ref._sessions["c"].ids


def test_planner_failed_speculation_preserves_committed_history():
    planner = _CountingPlanner()
    parser = PlannerParser(planner)
    parser.parse("first turn", {}, session_id="h")
    clean = list(parser._sessions["h"].ids)
    planner.plan_text = '{"version":"1.0","int'  # truncation
    with pytest.raises(ParserError):
        parser.parse("sort by price", {}, session_id="h", speculative=True)
    assert "h" in parser._sessions and parser._sessions["h"].ids == clean
    planner.plan_text = _PLAN_OK
    assert parser.parse("sort by price", {}, session_id="h")["intents"]


def test_real_planner_speculative_commit_matches_plain_turns():
    """[spec A, commit A, turn B] leaves the session token-identical to a
    twin that ran [A, B] plainly, on the real planner."""
    p1 = PlannerParser(_planner(ctx_buckets=(1024,), extend_buckets=(64,)))
    p2 = PlannerParser(_planner(ctx_buckets=(1024,), extend_buckets=(64,)))

    def turn(parser, text, **kw):
        try:
            return parser.parse(text, {}, session_id="s", **kw)
        except ParserError as e:
            return e

    ra_spec = turn(p1, "search for usb hubs", speculative=True)
    ra_fin = turn(p1, "search for usb hubs")
    rb1 = turn(p1, "scroll down")
    ra_plain = turn(p2, "search for usb hubs")
    rb2 = turn(p2, "scroll down")
    if not isinstance(ra_spec, ParserError):
        assert ra_fin == ra_spec == ra_plain
    if "s" in p1._sessions and "s" in p2._sessions:
        assert p1._sessions["s"].ids == p2._sessions["s"].ids
    if not isinstance(rb1, ParserError) and not isinstance(rb2, ParserError):
        assert rb1 == rb2


def test_planner_metrics_count_the_nine_names():
    """JAX's nine ``planner.*`` names, all counted by the port."""
    c = get_metrics().snapshot()["counters"]
    parser = PlannerParser(_StubPlanner(bytes_per_session=1 << 20))
    parser.max_sessions = 1
    parser.park_budget_bytes = 1 << 20
    for sid in ("a", "b", "c"):
        parser.parse("scroll down", {}, session_id=sid)
    parser.parse("sort", {}, session_id="c", speculative=True)
    parser.parse("sort", {}, session_id="c")
    parser.parse("sort", {}, session_id="c", speculative=True)
    parser.parse("scroll", {}, session_id="c")
    planner = _planner(ctx_buckets=(1024,), max_new_tokens=4)
    planner.plan_many([planner.start("go back"), planner.start("scroll down")])
    snap = get_metrics().snapshot()
    after = snap["counters"]
    for name in ("sessions_evicted", "sessions_parked", "sessions_dropped", "spec_commits",
                 "spec_rollbacks", "plans", "batched_plans"):
        assert after.get(f"planner.{name}", 0) > c.get(f"planner.{name}", 0), name
    assert "planner.plan" in json.dumps(snap)
    assert np.isfinite(after["planner.plans"])
