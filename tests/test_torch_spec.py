"""The port's speculative decoding (``serve.spec``) and its kernel K11 against
the JAX package, on the same numpy inputs and the same weights.

K11's plain version must equal the JAX ``masked_argmax`` (its Pallas kernel,
interpret mode) exactly: token ids, no tolerance. K12's plain version is held
to the JAX ``decode_block_attention`` at the float32 tolerance, ``rtol =
atol = 1e-5`` (the same arithmetic summed in another order). Everything else
compares token ids, states, counts and byte totals, which must be equal.

Engine-level tests run test-tiny with float32 weights (the JAX engine's
random init, carried over by ``bridge``), so that no argmax turns on a bf16
rounding; the JAX engines run their Pallas kernels in interpret mode and the
port its plain versions. Greedy speculative output must equal the port's
plain fast-forward-0 stream and the JAX speculative stream, for every
drafter, dense and paged; the paged plane adds radix and the int8 pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models import llama as jl
from tpu_voice_agent.ops import decode_block_attention as j_block_attention
from tpu_voice_agent.ops import masked_argmax as j_masked_argmax
from tpu_voice_agent.ops import masked_argmax_block as j_masked_argmax_block
from tpu_voice_agent.serve import DecodeEngine as JEngine
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve import spec as jspec
from tpu_voice_agent.serve.engine import chain_block as j_chain_block
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent_torch import bridge, ops
from tpu_voice_agent_torch.grammar import build_intent_fsm
from tpu_voice_agent_torch.serve import spec as tspec
from tpu_voice_agent_torch.serve.engine import DecodeEngine, chain_block
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.services.brain import SessionTranscripts, install_prompt_prefix
from tpu_voice_agent_torch.services.prompts import render_prompt

PROMPTS = ["search for usb hubs", "scroll down"]
MAXTOK = 48
KW = dict(preset="test-tiny", max_len=512, prefill_buckets=(64,))
DRAFTERS = ["fsm", "prompt", "fsm,prompt", "model"]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: intra-op threads buy nothing, and under the
    suite's parallel workers every process's threads contend for the same
    cores (a file that takes 20 s alone took 15 minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def weights():
    cfg = JEngine(init_weights=False, **KW).cfg
    return _f32(jl.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32))


def _jax(weights, cls=JEngine, **kw):
    eng = cls(kernels="pallas", init_weights=False, **{**KW, **kw})
    eng.load_params(jax.device_put(weights))
    return eng


def _port(weights, cls=DecodeEngine, **kw):
    eng = cls(device="cpu", init_weights=False, **{**KW, **kw})
    eng.load_params(bridge.params_from_numpy(weights))
    return eng


def _share_draft_model(jeng, teng):
    """The JAX engine's random draft model, in float32, on both sides."""
    jd = jeng.spec.drafter
    jd.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jd.params)
    teng.spec.drafter = tspec.DraftModelDrafter(
        teng, teng.spec.K, params=bridge.params_from_numpy(_f32(jd.params)))
    assert teng.spec.drafter._dpad == jd._dpad


@pytest.fixture(scope="module")
def plain(weights):
    """The port's plain greedy stream (fast-forward 0, no speculation)."""
    eng = _port(weights)
    return [eng.generate(p, max_new_tokens=MAXTOK) for p in PROMPTS]


# ---------------------------------------------------------------- K11 / K12


@pytest.fixture(scope="module")
def fsm():
    return build_intent_fsm()[1]


def test_masked_argmax_plain_equals_jax_kernel(fsm):
    """Seeded logits with ties, fully masked rows, the real (619-token) vocab
    and a V of 1500 (neither a multiple of the TPU's 1024-wide tile)."""
    rng = np.random.default_rng(0)
    mask619 = np.ascontiguousarray(fsm.mask)
    states = rng.integers(0, fsm.num_states, size=40).astype(np.int32)
    states[:3] = [fsm.start, 0, fsm.num_states - 1]
    logits = rng.standard_normal((40, fsm.vocab_size)).astype(np.float32)
    logits[5] = 0.25  # a tie across the row: the first legal index wins
    logits[6, ::7] = 3.0  # ties between some legal and illegal entries
    wide_mask = rng.random((6, 1500)) < 0.3
    wide_mask[2] = False  # a fully masked row picks token 0
    wide_states = np.array([0, 1, 2, 3, 4, 5, 2, 0], np.int32)
    wide = rng.standard_normal((8, 1500)).astype(np.float32)
    wide[3, :] = -2.0
    for lg, st, mk in ((logits, states, mask619), (wide, wide_states, wide_mask)):
        ref = np.asarray(j_masked_argmax(jnp.asarray(lg), jnp.asarray(st), jnp.asarray(mk)))
        ops.reset_launch_counts()
        out = ops.masked_argmax(torch.from_numpy(lg), torch.from_numpy(st), torch.from_numpy(mk))
        np.testing.assert_array_equal(out.numpy(), ref)
        assert ops.launch_counts()["masked_argmax"] == 0  # CPU tensors: the plain version
    assert int(ops.masked_argmax(torch.from_numpy(wide), torch.from_numpy(wide_states),
                                 torch.from_numpy(wide_mask))[6]) == 0


def test_masked_argmax_block_plain_equals_jax(fsm):
    """A (B, 1+K) verify block whose positions sit at their own states,
    dead (-1) states among them: clamped to 0 on both sides."""
    rng = np.random.default_rng(1)
    B, T = 6, 5
    states = rng.integers(0, fsm.num_states, size=(B, T)).astype(np.int32)
    states[1, 2:] = -1
    states[4, 4] = -1
    logits = rng.standard_normal((B, T, fsm.vocab_size)).astype(np.float32)
    mask = np.ascontiguousarray(fsm.mask)
    ref = np.asarray(j_masked_argmax_block(jnp.asarray(logits), jnp.asarray(states),
                                           jnp.asarray(mask)))
    out = ops.masked_argmax_block(torch.from_numpy(logits), torch.from_numpy(states),
                                  torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_decode_block_attention_plain_equals_jax_kernel():
    """K12's plain version at the JAX test's shapes (tests/test_ops.py:108):
    a mid-sequence chain, an idle row parked at slot 0, a frontier near the
    odd cache end, and unordered positions with repeats."""
    B, T, nq, nkv, hd, S = 4, 5, 8, 4, 32, 96
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, T, nq, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    q_pos = np.array([[10, 11, 12, 13, 14], [0, 0, 0, 0, 0], [90, 91, 92, 93, 94],
                      [40, 7, 40, 63, 2]], np.int32)
    ref = np.asarray(j_block_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(q_pos)))
    out = ops.decode_block_attention(*[torch.from_numpy(a) for a in (q, kc, vc, q_pos)])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# ---------------------------------------------------------------- drafters


@pytest.fixture(scope="module")
def jfsm():
    return JEngine(init_weights=False, **KW).fsm


def test_lookahead_equals_jax_on_every_state(fsm, jfsm):
    assert fsm.num_states == jfsm.num_states
    for width in range(1, 6):
        for s in range(-1, fsm.num_states + 1):
            assert fsm.lookahead(s, width) == jfsm.lookahead(s, width), (s, width)
    assert any(fsm.lookahead(s, 5) for s in range(fsm.num_states))


def _contexts(seed, n=40):
    """Seeded contexts over a small alphabet, so n-grams recur."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, 9, size=int(rng.integers(1, 40)))]
            for _ in range(n)]


def test_prompt_lookup_and_chain_drafters_equal_jax(fsm, jfsm):
    ctxs = _contexts(3)
    jd, td = jspec.PromptLookupDrafter(), tspec.PromptLookupDrafter()
    for ctx in ctxs:
        for k in (1, 4):
            assert td.draft_one(ctx, 0, k) == jd.draft_one(ctx, 0, k)
    # a chain: grammar lookahead first, prompt lookup where the state is free
    rng = np.random.default_rng(4)
    states = rng.integers(-1, fsm.num_states, size=len(ctxs)).astype(np.int32)
    need = rng.random(len(ctxs)) < 0.8
    ctxs[0] = None
    jc = jspec.ChainDrafter([jspec.FSMDrafter(jfsm), jspec.PromptLookupDrafter()])
    tc = tspec.ChainDrafter([tspec.FSMDrafter(fsm), tspec.PromptLookupDrafter()])
    jt, jl_ = jc.draft_batch(ctxs, states, need, 4)
    tt, tl_ = tc.draft_batch(ctxs, states, need, 4)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl_, jl_)
    assert tc.name == jc.name == "fsm+prompt" and (tl_ > 0).any()


# ---------------------------------------------------------------- verify


def _legal(fsm, s):
    """Token ids the grammar allows in state ``s`` (none when dead)."""
    return np.nonzero(fsm.table[s][fsm.col_id] >= 0)[0] if s >= 0 else []


def _verify_case(fsm, jeng, seed):
    """Seeded verify inputs over the real grammar: live, dead and idle rows;
    drafts that are the FSM's forced chain, random legal walks, an EOS, and
    dead tokens; logits that make a seeded prefix of each draft the greedy
    pick; a NaN row, and rows at the byte, token and cache limits."""
    rng = np.random.default_rng(seed)
    B, K, V = 12, 4, fsm.vocab_size
    ff_tok, ff_len = fsm.forced_tables(K)
    forced = np.nonzero(ff_len > 0)[0]
    free = np.nonzero(ff_len == 0)[0]
    state = np.where(rng.random(B) < 0.5, rng.choice(forced, B), rng.choice(free, B))
    state = state.astype(np.int32)
    state[3] = -1  # dead at entry: poison code 2
    drafts = np.full((B, K), -1, np.int32)
    for b in range(B):
        s = int(state[b])
        if b % 4 == 0 and s >= 0:
            chain = fsm.lookahead(s, K)
        else:
            chain = []
            for _ in range(int(rng.integers(0, K + 1))):
                legal = _legal(fsm, s)
                if not len(legal):
                    break
                t = int(rng.choice(legal))
                chain.append(t)
                s = fsm.step(s, t)
        drafts[b, :len(chain)] = chain
    drafts[5, 1] = jeng.eos_id  # an EOS proposal is never accepted
    drafts[6, 0] = int(np.nonzero(fsm.col_id == 0)[0][0])  # dead everywhere
    dlen = (drafts >= 0).sum(axis=1).astype(np.int32)
    logits = rng.standard_normal((B, 1 + K, V)).astype(np.float32)
    for b in range(B):  # the model agrees with a seeded prefix of the draft
        for i in range(int(rng.integers(0, dlen[b] + 1))):
            logits[b, i, drafts[b, i]] = 8.0
    logits[7, 0, 5] = np.nan  # non-finite at a real position: poison code 1
    cur = rng.integers(3, V, size=B).astype(np.int32)
    pos = rng.integers(40, 100, size=B).astype(np.int32)
    pos[8] = 507  # at the cache limit (max_pos 512)
    active = rng.random(B) < 0.9
    active[[0, 3, 5, 6, 7, 8]] = True
    active[9] = False
    nbytes = rng.integers(0, 30, size=B).astype(np.int32)
    nbytes[10] = 36  # a few bytes under the budget: the chain's bytes cap it
    left = rng.integers(2, 60, size=B).astype(np.int32)
    left[11] = 2  # one token left after cur: no draft fits
    return dict(cur=cur, pos=pos, state=state, active=active, nbytes=nbytes, left=left,
                drafts=drafts, dlen=dlen, logits=logits, K=K, budget=40, max_pos=512)


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_verify_commit_equals_jax(fsm, seed, dense):
    """``_verify_commit`` and the ``_draft_cap`` / ``chain_block`` before it,
    in the dense-mask branch (one K11 block) and the compressed one
    (``dense_limit=0``): every output equal."""
    jeng = JEngine(init_weights=False, kernels="pallas", **KW)
    c = _verify_case(fsm, jeng, seed)
    K = c["K"]
    jtables = jeng.fsm.device_tables(dense_limit=(1 << 25) if dense else 0)
    ttables = fsm.device_tables(dense_limit=(1 << 25) if dense else 0)
    assert (jtables.dense_mask is not None) == (ttables.dense_mask is not None) == dense
    tbl = DecodeEngine(init_weights=False, device="cpu", **KW).byte_len_table
    jbl = jeng.byte_len_table
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jbl))

    j = {k: jnp.asarray(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    t = {k: torch.from_numpy(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    jdl = jspec._draft_cap(j["dlen"], j["left"], j["pos"], c["max_pos"], j["active"])
    jstep, jblk, _ = j_chain_block(jnp.arange(1 + K)[None, :], j["cur"], j["drafts"], jdl,
                                   j["active"], jeng.pad_id, j["pos"])
    jout = jspec._verify_commit(
        j["logits"], j["cur"], j["pos"], j["state"], j["active"], j["nbytes"], j["left"],
        j["drafts"], jdl, jstep, jblk, jtables, jbl, jnp.int32(c["budget"]), None, K,
        jeng.eos_id, jeng.pad_id, c["max_pos"], kernels="pallas")
    tdl = tspec._draft_cap(t["dlen"], t["left"], t["pos"], c["max_pos"], t["active"])
    iw = torch.arange(1 + K, dtype=torch.int32)[None, :]
    tstep, tblk, _ = chain_block(iw, t["cur"], t["drafts"], tdl, t["active"], jeng.pad_id,
                                 t["pos"])
    tout = tspec._verify_commit(
        t["logits"], t["cur"], t["pos"], t["state"], t["active"], t["nbytes"], t["left"],
        t["drafts"], tdl, tstep, tblk, ttables, tbl, c["budget"], K, jeng.eos_id, jeng.pad_id,
        c["max_pos"])
    names = ("out", "n_step", "eos", "cur", "pos", "state", "active", "nbytes", "left",
             "accepted", "dl", "poison")
    for name, a, b in zip(names, jout[:12], tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    poison = tout[11].numpy()
    assert poison[3] == 2 and poison[7] == 1 and tout[9].numpy().max() > 0


# ---------------------------------------------------------------- dense engine


@pytest.mark.parametrize("drafter", DRAFTERS)
def test_dense_spec_equals_plain_and_jax(weights, plain, drafter):
    """Per drafter: the port's spec engine decodes the port's plain ff=0
    stream and the JAX spec engine's, with the same verify forwards, and
    ``stats()`` equal to JAX's (the model drafter on the JAX engine's
    draft weights)."""
    jeng = _jax(weights, spec=jspec.SpecConfig(k=4, drafter=drafter))
    teng = _port(weights, spec=tspec.SpecConfig(k=4, drafter=drafter))
    if drafter == "model":
        _share_draft_model(jeng, teng)
    ops.reset_launch_counts()
    for prompt, ref in zip(PROMPTS, plain):
        rj = jeng.generate(prompt, max_new_tokens=MAXTOK)
        rt = teng.generate(prompt, max_new_tokens=MAXTOK)
        assert rt.token_ids == ref.token_ids == rj.token_ids, drafter
        assert (rt.steps, rt.finished, rt.forwards) == (rj.steps, rj.finished, rj.forwards)
        assert rt.error is None and 0 < rt.forwards <= rt.steps == len(rt.token_ids)
    assert teng.spec.stats() == jeng.spec.stats()
    assert teng.spec.stats()["verify_steps"] > 0
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)  # plain versions on the CPU


def test_self_draft_accepts_everything(weights, plain):
    """The target as its own draft model: every draft is the target's greedy
    pick, so every one is accepted (fp32, dense)."""
    eng = _port(weights)
    eng.spec = tspec.SpecDecoder(eng, tspec.SpecConfig(k=4), drafter=tspec.DraftModelDrafter(
        eng, 4, cfg=eng.cfg, params=eng.params))
    res = eng.generate(PROMPTS[0], max_new_tokens=MAXTOK)
    assert res.token_ids == plain[0].token_ids
    s = eng.spec.stats()
    assert s["accept_rate"] == 1.0 and s["tokens_per_step"] > 2.0
    assert res.forwards < res.steps / 2
    # reset drops every slot's context and the draft model's slot state
    assert eng.spec._ctx[0] is not None and not eng.spec.drafter._dead[0]
    eng.spec.reset()
    assert eng.spec._ctx[0] is None and eng.spec.drafter._dead[0]


def test_batched_dense_spec_equals_singles_and_jax(weights, plain):
    """Two slots behind the batcher: each stream equals its single-slot
    plain stream, and per-request ``forwards`` / ``spec_accepted`` equal
    the JAX batcher's."""
    spec = dict(k=4, drafter="fsm,prompt")
    jres = JBatcher(_jax(weights, spec=jspec.SpecConfig(**spec), batch_slots=2), chunk_steps=8,
                    max_new_tokens=MAXTOK).generate_many(PROMPTS)
    teng = _port(weights, spec=tspec.SpecConfig(**spec), batch_slots=2)
    tres = ContinuousBatcher(teng, chunk_steps=8, max_new_tokens=MAXTOK).generate_many(PROMPTS)
    for ref, j, t in zip(plain, jres, tres):
        assert t.error is None and teng.fsm.walk(t.token_ids) >= 0
        assert t.token_ids == ref.token_ids == j.token_ids
        assert (t.forwards, t.spec_accepted) == (j.forwards, j.spec_accepted)
        assert 0 < t.forwards < t.steps and t.spec_accepted > 0


def test_spec_byte_budget_parity(weights):
    """Truncation by the byte budget lands on the same token with and
    without speculation."""
    a = _port(weights)
    b = _port(weights, spec=tspec.SpecConfig(k=4, drafter="fsm,prompt"))
    for budget in (16, 40):
        ra = a.generate(PROMPTS[0], max_new_tokens=MAXTOK, byte_budget=budget)
        rb = b.generate(PROMPTS[0], max_new_tokens=MAXTOK, byte_budget=budget)
        assert rb.token_ids == ra.token_ids and rb.finished == ra.finished
        assert rb.steps < MAXTOK


# ---------------------------------------------------------------- paged engine

PKW = dict(batch_slots=2, block_size=16)


@pytest.mark.parametrize("drafter", DRAFTERS)
def test_paged_spec_cold_equals_plain_and_jax(weights, plain, drafter):
    """Cold admissions on the paged pool (blocks of 16, so verify blocks
    straddle block boundaries): the port's paged spec engine decodes the
    plain stream and what JAX's ``PagedDecodeEngine(spec=)`` decodes, with
    per-request ``forwards`` and ``spec_accepted`` equal to JAX's; every
    block returns to the pool."""
    jeng = _jax(weights, cls=JPaged, spec=jspec.SpecConfig(k=4, drafter=drafter),
                radix_enable=False, **PKW)
    teng = _port(weights, cls=PagedDecodeEngine, spec=tspec.SpecConfig(k=4, drafter=drafter),
                 radix_enable=False, kv_quant="off", **PKW)
    assert teng.spec is not None
    if drafter == "model":
        _share_draft_model(jeng, teng)
    jres = JBatcher(jeng, chunk_steps=8, max_new_tokens=MAXTOK).generate_many(PROMPTS)
    tres = ContinuousBatcher(teng, chunk_steps=8, max_new_tokens=MAXTOK).generate_many(PROMPTS)
    for ref, j, t in zip(plain, jres, tres):
        assert t.error is None and t.token_ids == ref.token_ids == j.token_ids, drafter
        assert (t.steps, t.finished, t.forwards, t.spec_accepted) == \
            (j.steps, j.finished, j.forwards, j.spec_accepted)
    assert teng.spec.stats() == jeng.spec.stats()
    assert teng.allocator.blocks_in_use == 0


def _tpaged(weights, **kw):
    """A two-slot paged engine behind the few-shot prefix, as the JAX
    package's paged spec tests build it (tests/test_spec_paged.py)."""
    eng = _port(weights, cls=PagedDecodeEngine, max_len=2048,
                prefill_buckets=(128, 256, 512, 1024, 2048), batch_slots=2, **kw)
    install_prompt_prefix(eng)
    return eng


TURNS = [("search for wireless headphones", {}),
         ("open the second result", {"last_query": "wireless headphones"}),
         ("sort these by price from low to high", {"last_query": "wireless headphones"})]


def _session(eng, max_new=40):
    """One multi-turn session through the brain's transcripts (turn N's ids
    extend turn N-1's prompt and generated ids). Returns (results, each
    turn's prompt + generated ids)."""
    st = SessionTranscripts(eng.tokenizer)
    results, streams = [], []
    for text, ctx in TURNS:
        prompt = st.prompt_for("s", text, ctx)
        ids = eng.tokenizer.encode(prompt, bos=True) if isinstance(prompt, str) else list(prompt)
        r = ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=max_new).generate_many([ids])[0]
        assert r.error is None, r.error
        st.record("s", ids, r.token_ids)
        results.append(r)
        streams.append(ids + list(r.token_ids))
    return results, streams


class _WrongLegalDrafter(tspec.Drafter):
    """Grammar-legal proposals chosen to disagree with the model (the highest
    legal id): nearly every verify step rolls back."""

    name = "wrong"

    def __init__(self, fsm):
        self.fsm = fsm

    def draft_one(self, ctx, state, k):
        out, s = [], state
        for _ in range(k):
            legal = _legal(self.fsm, s)
            if not len(legal):
                break
            out.append(int(legal[-1]))
            s = self.fsm.step(s, out[-1])
        return out


def test_radix_spec_warm_identity_and_no_rejected_draft_cached(weights):
    """Warm radix admissions under speculation decode the plain paged
    stream turn by turn (turn 2+ served from the session chain), and with a
    drafter the model mostly rejects, every cached radix chain spells an
    accepted stream: no rejected draft reaches the tree."""
    cold, _ = _session(_tpaged(weights, radix_enable=False))
    warm_eng = _tpaged(weights, radix_enable=True, spec=tspec.SpecConfig(k=4))
    warm, _ = _session(warm_eng)
    P = len(warm_eng.prefix_ids)
    assert [w.token_ids for w in warm] == [c.token_ids for c in cold]
    assert warm[0].cached_tokens == P < warm[1].cached_tokens <= warm[2].cached_tokens
    assert all(w.forwards > 0 for w in warm) and warm_eng.spec.stats()["accepted"] > 0

    eng = _tpaged(weights, radix_enable=True)
    eng.spec = tspec.SpecDecoder(eng, tspec.SpecConfig(k=4), drafter=_WrongLegalDrafter(eng.fsm))
    wrong, streams = _session(eng)
    assert [w.token_ids for w in wrong] == [c.token_ids for c in cold]
    s = eng.spec.stats()
    assert s["drafted"] > 0 and s["accepted"] < s["drafted"]
    accepted = [list(eng.prefix_ids)] + streams
    chains = eng.radix.chains()
    assert chains and all(any(ch == h[:len(ch)] for h in accepted) for ch in chains)
    eng.radix.clear()
    assert eng.allocator.blocks_in_use == len(eng._prefix_blocks)


def test_paged_spec_int8_pool_equals_plain_int8(weights):
    """Speculation on the KV_QUANT=int8 pool decodes what the plain int8
    engine decodes (the verify block's duplicate writes store the same
    value and scale)."""
    prompts = [PROMPTS[0], PROMPTS[1], "open the first result"]
    plain8 = _port(weights, cls=PagedDecodeEngine, kv_quant="int8", radix_enable=False,
                   batch_slots=3, block_size=16)
    spec8 = _port(weights, cls=PagedDecodeEngine, kv_quant="int8", radix_enable=False,
                  batch_slots=3, block_size=16, spec=tspec.SpecConfig(k=4))
    ra = ContinuousBatcher(plain8, chunk_steps=8, max_new_tokens=48).generate_many(prompts)
    rb = ContinuousBatcher(spec8, chunk_steps=8, max_new_tokens=48).generate_many(prompts)
    assert [r.token_ids for r in rb] == [r.token_ids for r in ra]
    assert all(r.error is None and r.forwards < r.steps for r in rb)
    assert spec8.allocator.blocks_in_use == 0


# ---------------------------------------------------------------- env contract


def test_spec_from_env(monkeypatch):
    for k in ("SPEC_ENABLE", "SPEC_K", "SPEC_DRAFTER", "SPEC_DRAFT_MODEL", "SPEC_TRACE_SINK"):
        monkeypatch.delenv(k, raising=False)
    assert tspec.spec_from_env() is None
    monkeypatch.setenv("SPEC_ENABLE", "1")
    assert tspec.spec_from_env() == tspec.SpecConfig(k=4, drafter="fsm,prompt")
    monkeypatch.setenv("SPEC_K", "6")
    monkeypatch.setenv("SPEC_DRAFTER", "fsm")
    cfg = tspec.spec_from_env()
    assert (cfg.k, cfg.drafter) == (6, "fsm")
    monkeypatch.setenv("SPEC_K", "four")  # never silently the default
    with pytest.raises(ValueError, match="SPEC_K='four'"):
        tspec.spec_from_env()
    monkeypatch.setenv("SPEC_K", "6")
    monkeypatch.setenv("SPEC_DRAFT_MODEL", "/some/path")
    with pytest.raises(ValueError, match="SPEC_DRAFT_MODEL"):
        tspec.spec_from_env()
    monkeypatch.delenv("SPEC_DRAFT_MODEL")
    # served since the draft-trace sink was ported: the path rides the config
    monkeypatch.setenv("SPEC_TRACE_SINK", "/some/path")
    assert tspec.spec_from_env().trace_sink == "/some/path"


def test_spec_refusals_and_no_decoder_when_off(weights):
    assert _port(weights).spec is None
    assert _port(weights, cls=PagedDecodeEngine, kv_quant="off").spec is None
    with pytest.raises(ValueError, match="SPEC_DRAFTER"):
        _port(weights, spec=tspec.SpecConfig(drafter="nope"))


def test_spec_refuses_draft_widths_the_card_kernels_lack(monkeypatch, weights):
    """A verify block is 1 + K positions and the draft model feeds K + 2 (at
    least 8); on the card K3 / K7 / K9 take at most 16, so a wider block is
    refused at boot rather than left to the plain attention."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    tspec.check_spec_block(15, 0, cuda)  # a 16-position verify block: the widest
    tspec.check_spec_block(14, 16, cuda)  # the draft model's widest feed block
    with pytest.raises(ValueError, match="SPEC_K=16 makes a 17-position block"):
        tspec.check_spec_block(16, 0, cuda)
    with pytest.raises(ValueError, match="SPEC_K=15 makes a 17-position block"):
        tspec.check_spec_block(15, 17, cuda)
    tspec.check_spec_block(64, 66, cpu)  # the plain versions take any width
    for dev in (cuda, cpu):
        with pytest.raises(ValueError, match="SPEC_K=0"):
            tspec.check_spec_block(0, 0, dev)

    # the decoder consults the check at boot, with its drafter's feed width
    seen = []
    monkeypatch.setattr(tspec, "check_spec_block", lambda *a: seen.append(a))
    _port(weights, spec=tspec.SpecConfig(k=7, drafter="fsm,model"))
    _port(weights, spec=tspec.SpecConfig(k=3, drafter="prompt"))
    assert seen == [(7, 9, cpu), (3, 0, cpu)]


def _brain_env(monkeypatch, **env):
    for k in ("BRAIN_BATCH", "BRAIN_PAGED", "RADIX_ENABLE", "KV_QUANT", "BRAIN_FF", "SPEC_K",
              "SPEC_DRAFTER", "SPEC_DRAFT_MODEL", "SPEC_TRACE_SINK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    monkeypatch.setenv("BRAIN_BACKEND", "engine:test-tiny")
    monkeypatch.setenv("SPEC_ENABLE", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("paged", [False, True])
def test_brain_builds_a_speculative_engine(monkeypatch, paged):
    """``SPEC_ENABLE=1`` on the brain: the dense single-slot engine and the
    batched paged one each carry a decoder (never the plain path unknowingly),
    and ``/health`` names it; an unknown drafter refuses the boot."""
    from tpu_voice_agent_torch.services import brain

    _brain_env(monkeypatch, **({"BRAIN_BATCH": "2", "BRAIN_PAGED": "1"} if paged else {}))
    parser = brain.make_parser_from_env()
    try:
        eng = parser.engine
        assert eng.spec is not None and eng.spec.K == 4
        assert isinstance(eng, PagedDecodeEngine) == paged
        assert isinstance(parser, brain.BatchedEngineParser) == paged
        status, body, _ = brain.BrainApp(parser).health()
        assert status == 200 and body["spec"] == {"k": 4, "drafter": "fsm+prompt"}
        if not paged:  # the single-slot parser's generate takes the verify steps
            res = eng.generate(render_prompt("scroll down", {}), max_new_tokens=8)
            assert res.forwards > 0 and res.steps == len(res.token_ids)
    finally:
        getattr(parser, "close", lambda: None)()
    monkeypatch.setenv("SPEC_DRAFTER", "fsm,nope")
    with pytest.raises(ValueError, match="SPEC_DRAFTER"):
        brain.make_parser_from_env()
