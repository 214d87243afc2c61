"""Warm-state handoff (``tpu_voice_agent_torch/serve/handoff.py``) against
the JAX package's.

JAX's ``tests/test_handoff.py`` cases, each run on both packages over one
float32 test-tiny weight tree and every KV tier: a re-homed session's next
turn is token-identical to staying home, every fallback (an evicted donor
chain, a pressured pool, a tree at capacity, a tier mismatch,
``HANDOFF_KV=0``) is cold, counted, token-identical and leak-free, and the
port's tokens, warm counts and counter deltas equal JAX's. Then the
cross-implementation gate: a session exported by one package and adopted by
the other continues as the donor staying home, through the functions and
through the two brains' ``/admin/handoff`` routes.
"""

import json
import threading
import urllib.request

import httpx
import numpy as np
import pytest
import torch

from tests.http_helper import AppServer
from tests.torch_warm_helper import TIERS, Side, jax_weights, play

SID = "handoff-session"
TURNS = [("search for wireless headphones", {}),
         ("open the second result", {"last_query": "wireless headphones"})]
TURN3 = ("sort these by price from low to high", {"last_query": "wireless headphones"})
IDS = ["none" if t is None else t for t in TIERS]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    w = jax_weights()
    return {"jax": Side("jax", w), "port": Side("port", w)}


def _both(sides, case, *a):
    """Run one case on both packages; the port's summary must equal JAX's."""
    j = case(sides["jax"], *a)
    t = case(sides["port"], *a)
    assert t == j
    return t


# ------------------------------------------------------------ happy path


def _rehome(side, tier):
    donor, recip = side.engine(tier), side.engine(tier)
    tr_d, tr_r = side.transcripts(donor), side.transcripts(recip)
    play(side, donor, tr_d, TURNS)
    blob = side.handoff.export_session(donor, tr_d, SID)
    assert blob is not None
    stay = play(side, donor, tr_d, [TURN3])[0]
    adopted = side.handoff.adopt_session(recip, tr_r, blob)
    assert adopted > len(donor.prefix_ids)  # a chain past the static prefix shipped
    moved = play(side, recip, tr_r, [TURN3])[0]
    assert moved.token_ids == stay.token_ids
    assert moved.cached_tokens == stay.cached_tokens >= adopted  # the chain was served
    side.balanced(recip)
    side.balanced(donor)
    return adopted, moved.token_ids, moved.cached_tokens


@pytest.mark.parametrize("tier", TIERS, ids=IDS)
def test_rehomed_turn_token_identical_per_tier(sides, tier):
    _both(sides, _rehome, tier)


def _idempotent(side, tier):
    donor, recip = side.engine(tier), side.engine(tier)
    tr_d, tr_r = side.transcripts(donor), side.transcripts(recip)
    play(side, donor, tr_d, TURNS)
    blob = side.handoff.export_session(donor, tr_d, SID)
    a1 = side.handoff.adopt_session(recip, tr_r, blob)
    nodes1, used1 = side.tree(recip).nodes, recip.allocator.blocks_in_use
    a2 = side.handoff.adopt_session(recip, tr_r, blob)
    assert a1 == a2 > 0
    assert (side.tree(recip).nodes, recip.allocator.blocks_in_use) == (nodes1, used1)
    side.balanced(recip)
    return a1, nodes1, used1


@pytest.mark.parametrize("tier", TIERS, ids=IDS)
def test_adopt_is_idempotent_and_leak_free(sides, tier):
    _both(sides, _idempotent, tier)


def test_pack_unpack_roundtrip_and_malformed_blob(sides):
    from tpu_voice_agent_torch.serve import handoff

    arrays = {"k": np.arange(12, dtype=np.int8).reshape(3, 4),
              "s": np.ones((2, 2), dtype=np.float32)}
    blob = handoff.pack({"session_id": "x", "ids": [1, 2]}, arrays)
    assert blob == sides["jax"].handoff.pack({"session_id": "x", "ids": [1, 2]}, arrays)
    meta, out = handoff.unpack(blob)
    assert meta["ids"] == [1, 2]
    assert out["k"].tolist() == arrays["k"].tolist()
    assert out["s"].dtype == torch.float32
    with pytest.raises(ValueError):
        handoff.unpack(b"not a handoff blob")
    with pytest.raises(ValueError):
        handoff.unpack(blob[:-4])  # truncated array bytes


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_the_wire_is_jax_byte_for_byte(sides, dtype):
    """A bf16 tensor packs as its raw 2-byte words under JAX's dtype name:
    the port's blob equals the JAX package's for the same values, and each
    package unpacks the other's to the same bits."""
    import ml_dtypes

    jh = sides["jax"].handoff
    from tpu_voice_agent_torch.serve import handoff

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 2, 8)).astype(np.float32)
    if dtype == "bfloat16":
        j_arr = x.astype(ml_dtypes.bfloat16)
        t_arr = torch.from_numpy(x).to(torch.bfloat16)
    elif dtype == "int8":
        j_arr = (x * 40).astype(np.int8)
        t_arr = torch.from_numpy(j_arr.copy())
    else:
        j_arr, t_arr = x, torch.from_numpy(x)
    meta = {"v": 1, "kind": "kv_seg", "ids": [1, 2, 3]}
    jblob = jh.pack(meta, {"k": j_arr})
    tblob = handoff.pack(meta, {"k": t_arr})
    assert tblob == jblob
    _, tout = handoff.unpack(jblob)
    _, jout = jh.unpack(tblob)
    assert tout["k"].dtype == t_arr.dtype
    assert torch.equal(tout["k"], t_arr)
    assert jout["k"].dtype == j_arr.dtype
    assert jout["k"].tobytes() == j_arr.tobytes()


# ------------------------------------------------------------- fallbacks


def _evicted_donor(side, tier):
    donor, recip = side.engine(tier), side.engine(tier)
    tr_d, tr_r = side.transcripts(donor), side.transcripts(recip)
    play(side, donor, tr_d, TURNS)
    side.tree(donor).evict(10_000)  # the whole unreferenced session chain
    blob = side.handoff.export_session(donor, tr_d, SID)
    assert blob is not None
    stay = play(side, donor, tr_d, [TURN3])[0]
    assert side.handoff.adopt_session(recip, tr_r, blob) == 0
    moved = play(side, recip, tr_r, [TURN3])[0]
    assert moved.token_ids == stay.token_ids  # a cold re-prefill, the same tokens
    bs = recip.block_size
    assert moved.cached_tokens >= len(recip.prefix_ids) // bs * bs  # its own prefix serves
    side.balanced(recip)
    return moved.token_ids, moved.cached_tokens


@pytest.mark.parametrize("tier", TIERS, ids=IDS)
def test_mid_chain_evicted_donor_still_ships_transcript_and_matches(sides, tier):
    _both(sides, _evicted_donor, tier)


def _pressured(side, tier):
    donor, recip = side.engine(tier), side.engine(tier)
    tr_d, tr_r = side.transcripts(donor), side.transcripts(recip)
    play(side, donor, tr_d, TURNS)
    blob = side.handoff.export_session(donor, tr_d, SID)
    stay = play(side, donor, tr_d, [TURN3])[0]
    hold = recip.allocator.alloc(side.free_blocks(recip))  # nothing left, nothing evictable
    before = side.counter("handoff.adopt_fallbacks")
    assert side.handoff.adopt_session(recip, tr_r, blob) == 0
    assert side.counter("handoff.adopt_fallbacks") == before + 1
    assert tr_r.peek(SID) is not None  # the transcript did ship
    recip.allocator.free(hold)
    moved = play(side, recip, tr_r, [TURN3])[0]
    assert moved.token_ids == stay.token_ids
    side.balanced(recip)
    return moved.token_ids


@pytest.mark.parametrize("tier", TIERS, ids=IDS)
def test_pool_pressured_recipient_falls_back_cold_counted(sides, tier):
    _both(sides, _pressured, tier)


def _capped(side, tier):
    donor = side.engine(tier)
    tr_d = side.transcripts(donor)
    play(side, donor, tr_d, TURNS)
    blob = side.handoff.export_session(donor, tr_d, SID)
    recip = side.engine(tier, max_nodes=1)  # the pinned prefix chain installs regardless
    tr_r = side.transcripts(recip)
    used0 = recip.allocator.blocks_in_use
    before = side.counter("handoff.adopt_fallbacks")
    assert side.handoff.adopt_session(recip, tr_r, blob) == 0
    assert side.counter("handoff.adopt_fallbacks") == before + 1
    assert recip.allocator.blocks_in_use == used0  # the blocks fell back
    assert tr_r.peek(SID) is not None
    return used0


@pytest.mark.parametrize("tier", TIERS, ids=IDS)
def test_capacity_capped_recipient_tree_counts_cold(sides, tier):
    _both(sides, _capped, tier)


MISMATCHES = [("int8", None), (None, "int4"), ("int4", "int8")]


def _mismatch(side, tiers):
    donor, recip = side.engine(tiers[0]), side.engine(tiers[1])
    tr_d, tr_r = side.transcripts(donor), side.transcripts(recip)
    play(side, donor, tr_d, TURNS)
    blob = side.handoff.export_session(donor, tr_d, SID)
    before = side.counter("handoff.adopt_fallbacks")
    assert side.handoff.adopt_session(recip, tr_r, blob) == 0
    assert side.counter("handoff.adopt_fallbacks") == before + 1
    moved = play(side, recip, tr_r, [TURN3])[0]
    assert moved.error is None and recip.fsm.walk(moved.token_ids) >= 0
    side.balanced(recip)
    return moved.token_ids


@pytest.mark.parametrize("tiers", MISMATCHES, ids=["int8-none", "none-int4", "int4-int8"])
def test_tier_mismatch_falls_back_clean(sides, tiers):
    _both(sides, _mismatch, tiers)


def _ablation(side, tier, monkeypatch):
    donor, recip = side.engine(tier), side.engine(tier)
    tr_d, tr_r = side.transcripts(donor), side.transcripts(recip)
    play(side, donor, tr_d, TURNS)
    monkeypatch.setenv("HANDOFF_KV", "0")
    blob = side.handoff.export_session(donor, tr_d, SID)
    monkeypatch.delenv("HANDOFF_KV")
    meta, arrays = side.handoff.unpack(blob)
    assert not arrays and meta["chain_tokens"] == 0
    stay = play(side, donor, tr_d, [TURN3])[0]
    assert side.handoff.adopt_session(recip, tr_r, blob) == 0
    moved = play(side, recip, tr_r, [TURN3])[0]
    assert moved.token_ids == stay.token_ids
    assert moved.cached_tokens < stay.cached_tokens  # cold: the prefix only
    return moved.token_ids, moved.cached_tokens


@pytest.mark.parametrize("tier", TIERS, ids=IDS)
def test_handoff_kv_ablation_ships_transcript_only(sides, tier, monkeypatch):
    _both(sides, _ablation, tier, monkeypatch)


# ------------------------------------------- the cross-implementation gate


@pytest.mark.parametrize("donor_pkg,recip_pkg", [("jax", "port"), ("port", "jax")],
                         ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("tier", TIERS, ids=IDS)
def test_a_session_crosses_packages_through_the_functions(sides, tier, donor_pkg, recip_pkg):
    """A session exported by one package and adopted by the other: the
    recipient's turn 3 equals the donor's own turn 3, served warm."""
    ds, rs = sides[donor_pkg], sides[recip_pkg]
    donor, recip = ds.engine(tier), rs.engine(tier)
    tr_d, tr_r = ds.transcripts(donor), rs.transcripts(recip)
    play(ds, donor, tr_d, TURNS)
    blob = ds.handoff.export_session(donor, tr_d, SID)
    stay = play(ds, donor, tr_d, [TURN3])[0]
    adopted = rs.handoff.adopt_session(recip, tr_r, blob)
    assert adopted > len(recip.prefix_ids)
    moved = play(rs, recip, tr_r, [TURN3])[0]
    assert moved.token_ids == stay.token_ids
    assert moved.cached_tokens == stay.cached_tokens >= adopted
    rs.balanced(recip)


class _Brain:
    """A batched, session-aware brain of one package around ``eng``, served
    on an ephemeral port (the JAX app under aiohttp, the port's on its
    stdlib server). ``turn`` runs one session turn through the brain's own
    serving loop and transcripts."""

    def __init__(self, side, eng):
        self.side = side
        if side.name == "jax":
            self.parser = side.brain.BatchedEngineParser(eng, max_new_tokens=32,
                                                         session_aware=True)
            self._srv = AppServer(side.brain.build_app(self.parser)).__enter__()
            self.url = self._srv.url
        else:
            self.parser = side.brain.BatchedEngineParser(eng, max_new_tokens=32,
                                                         session_aware=True)
            self._srv = side.brain.make_server(side.brain.BrainApp(self.parser), port=0)
            self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
            self._thread.start()
            self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"

    def turn(self, text, ctx, sid=SID):
        tr = self.parser.transcripts
        prompt = tr.prompt_for(sid, text, ctx)
        if self.side.name == "jax":
            fut = self.parser.runtime.submit_parse(prompt)
        else:
            fut = self.parser.loop.submit(prompt)
        r = fut.result(timeout=300)
        assert r.error is None, r.error
        tr.record(sid, prompt, r.token_ids)
        return r

    def close(self):
        if self.side.name == "jax":
            self._srv.__exit__(None, None, None)
        else:
            self._srv.shutdown()
            self._srv.server_close()
            self._thread.join(timeout=30)
        self.parser.close()


@pytest.mark.parametrize("donor_pkg,recip_pkg", [("jax", "port"), ("port", "jax")],
                         ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("tier", TIERS, ids=IDS)
def test_a_session_crosses_packages_through_the_routes(sides, tier, donor_pkg, recip_pkg):
    """The same through the brains: ``GET /admin/handoff/{id}`` on the
    donor's app, the blob ``POST``ed raw to the recipient's
    ``/admin/handoff``; then the recipient's turn 3 equals the donor's."""
    ds, rs = sides[donor_pkg], sides[recip_pkg]
    donor, recip = _Brain(ds, ds.engine(tier)), _Brain(rs, rs.engine(tier))
    try:
        for text, ctx in TURNS:
            donor.turn(text, ctx)
        r = httpx.get(f"{donor.url}/admin/handoff/{SID}", timeout=60)
        assert r.status_code == 200
        assert r.headers["content-type"].startswith("application/octet-stream")
        blob = r.content
        assert httpx.get(f"{donor.url}/admin/handoff/nobody", timeout=60).json() == \
            {"error": "no_warm_state", "session_id": "nobody"}
        stay = donor.turn(*TURN3)
        req = urllib.request.Request(recip.url + "/admin/handoff", data=blob, method="POST",
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        assert out["ok"] is True and out["adopted_tokens"] > len(recip.parser.engine.prefix_ids)
        moved = recip.turn(*TURN3)
        assert moved.token_ids == stay.token_ids
        assert moved.cached_tokens == stay.cached_tokens >= out["adopted_tokens"]
    finally:
        donor.close()
        recip.close()


def test_framed_and_torn_handoff_bodies_match_jax(sides):
    """``POST /admin/handoff`` with a ``TVAF1`` framed body adopts as the
    raw blob does; a torn framed body is a counted cold fallback answered
    200 with JAX's body, on both brains."""
    bodies = {}
    for name in ("jax", "port"):
        side = sides[name]
        donor = _Brain(side, side.engine(None))
        recip = _Brain(side, side.engine(None))
        try:
            for text, ctx in TURNS:
                donor.turn(text, ctx)
            blob = httpx.get(f"{donor.url}/admin/handoff/{SID}", timeout=60).content
            parts = side.handoff.frame_split(blob, 4096)
            torn = httpx.post(recip.url + "/admin/handoff", content=b"".join(parts[:-1]),
                              timeout=60)
            good = httpx.post(recip.url + "/admin/handoff", content=b"".join(parts),
                              timeout=60)
            bodies[name] = (torn.status_code, torn.json(), good.status_code, good.json())
        finally:
            donor.close()
            recip.close()
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"][1]["adopted_tokens"] == 0 and bodies["port"][3]["adopted_tokens"] > 0


@pytest.mark.parametrize("route", [("GET", "/admin/handoff/s1"), ("POST", "/admin/handoff"),
                                   ("POST", "/admin/disagg/prefill"),
                                   ("POST", "/admin/disagg/adopt")])
def test_backends_without_the_surface_answer_as_jax(sides, route):
    """The rule parser answers the warm-state routes 404 with JAX's typed
    body (the router counts a cold re-home); the dense one-slot parser has
    no such surface either."""
    from tpu_voice_agent_torch.services import brain, ws

    method, path = route
    jb = sides["jax"].brain
    with AppServer(jb.build_app(jb.RuleBasedParser())) as srv:
        jr = httpx.request(method, srv.url + path, content=b"{}",
                           headers={"x-disagg-stream": "s"}, timeout=30)
    app = brain.BrainApp(brain.RuleBasedParser())
    status, body, _ = app.handle(ws.Request(method, path, "", ws.Headers(
        {"x-disagg-stream": "s"}.items()), b"{}"))
    assert (status, body) == (jr.status_code, jr.json())
    assert status == 404 and body["error"] in ("handoff_unsupported", "disagg_unsupported")
