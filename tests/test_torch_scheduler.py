"""The port's ``ContinuousBatcher`` over its ``PagedDecodeEngine`` against
the JAX pair, composed as ``tests/test_paged.py`` composes them: test-tiny,
three slots, the few-shot prefix installed, ``chunk_steps`` 16.

One weight tree (the JAX engine's random init, float32 so that no argmax
turns on a bf16 rounding) serves both sides; the JAX engine runs its Pallas
kernels in interpret mode and the port its plain versions. Greedy ids must
be identical, at fast-forward 8 (every chain step a (3, 9) block through K7)
and 0 (T=1 steps through K6). Beside it, the paged plane's own contracts:
prefix blocks shared and not copied, pool exhaustion failing a request and
not the engine, ``generate`` refused, and the dense batched engine equal to
the paged one.
"""

import jax
import numpy as np
import pytest

from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent_torch import bridge, ops
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.services.brain import install_prompt_prefix

PROMPTS = [
    render_prompt("search for laptops under 1000", {}),
    render_prompt("upload my resume and submit", {}),
    render_prompt("take a screenshot of this page", {}),
]
KW = dict(preset="test-tiny", max_len=2048, batch_slots=3, prefill_buckets=(128, 256, 512, 1024))


@pytest.fixture(scope="module")
def weights():
    eng = JPaged(kernels="pallas", **KW)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


def _port(weights, cls=PagedDecodeEngine, **kw):
    eng = cls(init_weights=False, device="cpu", **KW, **kw)
    eng.load_params(bridge.params_from_numpy(weights))
    return eng


@pytest.mark.parametrize("ff", [8, 0])
def test_paged_batcher_matches_jax(weights, ff):
    jeng = JPaged(kernels="pallas", fast_forward=ff, init_weights=False, **KW)
    jeng.load_params(jax.device_put(weights))
    teng = _port(weights, fast_forward=ff)
    assert j_install(jeng) == install_prompt_prefix(teng) > 800
    jres = JBatcher(jeng, chunk_steps=16, max_new_tokens=40).generate_many(PROMPTS)
    ops.reset_launch_counts()
    tb = ContinuousBatcher(teng, chunk_steps=16, max_new_tokens=40)
    tres = tb.generate_many(PROMPTS)
    for j, t in zip(jres, tres):
        assert t.error is None and teng.fsm.walk(t.token_ids) >= 0
        assert t.token_ids == j.token_ids
        assert (t.steps, t.finished, t.cached_tokens) == (j.steps, j.finished, j.cached_tokens)
    # the three rows share every forward; chain tokens ride them at ff 8
    assert tb.tokens_generated == sum(t.steps for t in tres)
    assert tb.forwards < 40 if ff else tb.forwards == 40
    # the prefix blocks stay; every request's own blocks came back
    assert teng.allocator.blocks_in_use == len(teng._prefix_blocks) > 0
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)  # plain versions on the CPU


def test_dense_batched_engine_matches_paged(weights):
    """The dense engine's batched surface (decode_chunk over dense cache
    lines) and the paged engine decode the same tokens."""
    dense = _port(weights, cls=DecodeEngine, fast_forward=8)
    paged = _port(weights, fast_forward=8)
    install_prompt_prefix(dense)
    install_prompt_prefix(paged)
    rd = ContinuousBatcher(dense, chunk_steps=16, max_new_tokens=24).generate_many(PROMPTS)
    rp = ContinuousBatcher(paged, chunk_steps=16, max_new_tokens=24).generate_many(PROMPTS)
    assert [r.token_ids for r in rd] == [r.token_ids for r in rp]
    assert all(r.error is None and r.steps == 24 for r in rp)


def test_prefix_blocks_are_shared_not_copied(weights):
    eng = _port(weights)
    P = install_prompt_prefix(eng)
    full = P // eng.block_size
    base = eng.allocator.blocks_in_use
    assert base == full >= 1
    b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=24)
    for p in PROMPTS:
        b.submit(p)
    b.step()  # admits all three
    owned = [len(o) for o in eng._slot_owned]
    assert all(o >= 1 for o in owned)
    assert eng.allocator.blocks_in_use == base + sum(owned)
    assert all(s == eng._prefix_blocks[:full] for s in eng._slot_shared)
    assert eng.allocator.blocks_shared == full
    # the sub-block tail was scattered into each slot's first owned block
    tail = P - full * eng.block_size
    k0 = eng.k_pool[:, eng._slot_owned[0][0], :tail]
    assert all(bool((eng.k_pool[:, o[0], :tail] == k0).all()) for o in eng._slot_owned)
    b.run_until_done()
    assert eng.allocator.blocks_in_use == base


def test_pool_exhaustion_fails_the_request_not_the_engine(weights, monkeypatch):
    monkeypatch.setenv("SCHED_POOL_WAIT_S", "0")
    eng = _port(weights, pool_blocks=10)  # 9 usable: one admission fits, two don't
    r1, r2 = ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=16).generate_many(
        [PROMPTS[0], PROMPTS[1]])
    ok = [r for r in (r1, r2) if r.error is None]
    bad = [r for r in (r1, r2) if r.error is not None]
    assert ok and bad
    assert all(r.error.startswith("shed: ") and "exhausted" in r.error for r in bad)
    assert eng.allocator.blocks_in_use == 0


def test_pool_wait_requeues_until_blocks_free(weights, monkeypatch):
    """Within its wait budget the second request waits at the head of the
    queue until the first one's blocks come back, then runs."""
    monkeypatch.setenv("SCHED_POOL_WAIT_S", "600")
    eng = _port(weights, pool_blocks=10)
    r1, r2 = ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=16).generate_many(
        [PROMPTS[0], PROMPTS[1]])
    assert r1.error is None and r2.error is None and r2.steps == 16


def test_cancel_drops_a_queued_request_and_its_bookkeeping(weights, monkeypatch):
    monkeypatch.setenv("SCHED_POOL_WAIT_S", "600")
    eng = _port(weights, pool_blocks=10)
    b = ContinuousBatcher(eng, chunk_steps=8, max_new_tokens=16)
    r1, r2 = b.submit(PROMPTS[0]), b.submit(PROMPTS[1])
    b.step()  # r1 decodes; r2 waits for blocks at the head of the queue
    assert b.slots[0].request_id == r1 and r2 in b._pool_wait and r2 in b._requeues
    assert b.cancel(r2) and not b.cancel(r2)
    assert not b.pending and not (b._enqueued_at or b._pool_wait or b._requeues)
    assert b.results[r2].error == "cancelled: client gone"
    b.run_until_done()
    assert set(b.results) == {r1, r2} and b.results[r1].error is None
    assert eng.allocator.blocks_in_use == 0


def test_paged_generate_is_refused(weights):
    with pytest.raises(ValueError, match="batcher"):
        _port(weights).generate("x")
    with pytest.raises(ValueError, match="batch_slots=1"):
        _port(weights, cls=DecodeEngine).generate("x")
