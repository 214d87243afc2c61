"""The port's ``BlockAllocator`` and ``RadixCache`` against the JAX classes
under the same seeded operation sequences, and radix KV reuse at engine
level: multi-turn sessions decode the same tokens with the tree on and off.

The engine-level contract is the one beneath the JAX package's radix parser
tests (``tests/test_radix.py``), whose two session-parser tests fail on the
reference itself with random weights (no EOS within the budget): here each
turn is recorded whether or not it reached EOS, so every later turn extends
the last one's tokens.
"""

import jax
import numpy as np
import pytest

from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve.paged import BlockAllocator as JAllocator
from tpu_voice_agent.serve.radix import RadixCache as JRadix
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.serve.paged import BlockAllocator, PagedDecodeEngine
from tpu_voice_agent_torch.serve.radix import RadixCache
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.services.brain import SessionTranscripts, install_prompt_prefix


def _both(fn_j, fn_t):
    """Run one op on both sides: the same result, or the same exception type."""
    try:
        rj = ("ok", fn_j())
    except (RuntimeError, ValueError) as e:
        rj = ("raise", type(e).__name__)
    try:
        rt = ("ok", fn_t())
    except (RuntimeError, ValueError) as e:
        rt = ("raise", type(e).__name__)
    assert rt == rj
    return rt


def _same_alloc(ja, ta):
    assert ja._refs == ta._refs and ja._free == [ta._free]
    assert (ja.blocks_in_use, ja.blocks_shared, ja.usable_blocks, ja.utilization) == \
        (ta.blocks_in_use, ta.blocks_shared, ta.usable_blocks, ta.utilization)


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_matches_jax_under_a_seeded_op_sequence(seed):
    rng = np.random.default_rng(seed)
    ja, ta = JAllocator(24), BlockAllocator(24)
    live: list[int] = []
    for _ in range(300):
        op = rng.integers(4)
        if op == 0:
            k = int(rng.integers(1, 6))
            kind, got = _both(lambda: ja.alloc(k), lambda: ta.alloc(k))
            if kind == "ok":
                assert 0 not in got  # block 0 is the trash block
                live += got
        elif op == 1 and live:
            pick = [int(b) for b in rng.choice(live, size=min(3, len(live)), replace=False)]
            _both(lambda: ja.ref(pick), lambda: ta.ref(pick))
            live += pick
        elif op == 2 and live:
            i = int(rng.integers(len(live)))
            b = live.pop(i)
            _both(lambda: ja.free([b]), lambda: ta.free([b]))
        else:  # a double free or an untracked ref: refused whole, on both sides
            bad = live[:1] * (live.count(live[0]) + 1) if live else [1]
            _both(lambda: ja.free(bad), lambda: ta.free(bad))
            _both(lambda: ja.ref([0]), lambda: ta.ref([0]))
        _same_alloc(ja, ta)
    _both(lambda: ja.free(live), lambda: ta.free(live))
    assert ta.blocks_in_use == 0
    _same_alloc(ja, ta)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_tree_matches_jax_under_a_seeded_op_sequence(seed):
    """Requests over a pinned 8-token prefix with continuations from a small
    alphabet (so chains share and branch): match, allocate the rest, insert
    at release, free; with evictions and a node cap. Same handed-out ids,
    matches, adoptions, evictions, refcounts and chains; zero leaked blocks
    after ``clear``."""
    rng = np.random.default_rng(seed)
    bs = 4
    ja, ta = JAllocator(96), BlockAllocator(96)
    jr, tr = JRadix(ja, bs, max_nodes=20), RadixCache(ta, bs, max_nodes=20)
    prefix = list(range(100, 108))
    pj, pt = ja.alloc(2), ta.alloc(2)
    assert pj == pt
    jr.pin_root_chain(prefix, pj)
    tr.pin_root_chain(prefix, pt)
    for _ in range(60):
        if rng.random() < 0.15:
            need = int(rng.integers(1, 5))
            assert jr.evict(need) == tr.evict(need)
        else:
            ids = prefix + [int(t) for t in rng.integers(0, 3, size=int(rng.integers(1, 14)))]
            (cj, mj), (ct, mt) = jr.match(ids), tr.match(ids)
            assert (cj, mj) == (ct, mt)
            if mj:
                jr.record_hit(mj)
                tr.record_hit(mt)
            n_owned = -(-len(ids) // bs) - len(cj)
            kind, owned = _both(lambda: ja.alloc(n_owned), lambda: ta.alloc(n_owned))
            if kind == "ok":
                assert jr.insert(ids, cj + owned) == tr.insert(ids, ct + owned)
                ja.free(cj + owned)
                ta.free(ct + owned)
            else:
                ja.free(cj)
                ta.free(ct)
        _same_alloc(ja, ta)
        assert sorted(jr.chains()) == sorted(tr.chains())
        assert (jr.nodes, jr.reclaimable_blocks(), jr.evictions, jr.inserts, jr.hit_rate) == \
            (tr.nodes, tr.reclaimable_blocks(), tr.evictions, tr.inserts, tr.hit_rate)
    assert tr.nodes > 2 and tr.hits > 0  # the sequence did share chains
    jr.clear()
    tr.clear()
    ja.free(pj)
    ta.free(pt)
    assert ta.blocks_in_use == 0 and ta._refs == {}
    _same_alloc(ja, ta)


def test_namespaced_chains_stay_apart():
    """With a tenant namespace a chain is served only to its own namespace,
    while the pinned static prefix is shared."""
    a = BlockAllocator(32)
    rc = RadixCache(a, 4)
    pre = a.alloc(1)
    rc.pin_root_chain([1, 2, 3, 4], pre)
    ids = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    blocks = pre + a.alloc(2)
    a.ref(pre)
    assert rc.insert(ids, blocks, ns="t1") == 1
    assert rc.match(ids, ns="t2") == (pre, 4)
    assert rc.match(ids, ns="t1") == (blocks[:2], 8)
    assert rc.match(ids) == (pre, 4)


# ---------------------------------------------------------------- engine level

KW = dict(preset="test-tiny", max_len=2048, batch_slots=2,
          prefill_buckets=(128, 256, 512, 1024), fast_forward=8)
TURNS = [("search for wireless headphones", {}), ("sort them by price", {"sort": "price"}),
         ("open the second one", {})]


@pytest.fixture(scope="module")
def weights():
    eng = JPaged(kernels="pallas", **KW)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


def _sessions(eng, submit_many, n_sessions=2):
    """Drive ``n_sessions`` sessions through TURNS; every turn is recorded
    (EOS or not). Returns per turn: (prompt ids, generated ids, cached)."""
    tr = SessionTranscripts(eng.tokenizer)
    out = []
    for text, ctx in TURNS:
        sids = [f"s{i}" for i in range(n_sessions)]
        prompts = [tr.prompt_for(sid, f"{text} {sid}", ctx) for sid in sids]
        prompts = [eng.tokenizer.encode(p, bos=True) if isinstance(p, str) else p
                   for p in prompts]
        results = submit_many(prompts)
        for sid, p, r in zip(sids, prompts, results):
            assert r.error is None
            tr.record(sid, p, r.token_ids)
            out.append((p, r.token_ids, r.cached_tokens))
    return out


def _port_engine(weights, radix):
    eng = PagedDecodeEngine(init_weights=False, device="cpu", radix_enable=radix, **KW)
    eng.load_params(bridge.params_from_numpy(weights))
    install_prompt_prefix(eng)
    return eng


def test_radix_on_equals_radix_off_over_turns(weights):
    on = _port_engine(weights, True)
    off = _port_engine(weights, False)
    b_on = ContinuousBatcher(on, chunk_steps=16, max_new_tokens=24)
    b_off = ContinuousBatcher(off, chunk_steps=16, max_new_tokens=24)
    r_on = _sessions(on, b_on.generate_many)
    r_off = _sessions(off, b_off.generate_many)
    P = len(on.prefix_ids)
    for i, ((p1, g1, c1), (p2, g2, c2)) in enumerate(zip(r_on, r_off)):
        assert p1 == p2 and g1 == g2
        assert c2 == P  # radix off: the static prefix only
        assert c1 > P if i >= 2 else c1 == P  # turns >= 2 reuse the session's chain
    assert on.radix.hits >= 4
    # released chains stay cached (the tree's refs); nothing else is held
    tree_blocks = on.radix.nodes
    assert on.allocator.blocks_in_use == tree_blocks
    assert off.allocator.blocks_in_use == len(off._prefix_blocks)


def test_radix_engine_matches_jax(weights):
    jeng = JPaged(kernels="pallas", init_weights=False, radix_enable=True, **KW)
    jeng.load_params(jax.device_put(weights))
    j_install(jeng)
    jb = JBatcher(jeng, chunk_steps=16, max_new_tokens=24)
    teng = _port_engine(weights, True)
    tb = ContinuousBatcher(teng, chunk_steps=16, max_new_tokens=24)
    r_j = _sessions(jeng, jb.generate_many)
    r_t = _sessions(teng, tb.generate_many)
    assert r_t == r_j
    assert sorted(teng.radix.chains()) == sorted(jeng.radix[0].chains())
