"""Chunked prefill (``PREFILL_CHUNK_TOKENS``) of the port's batcher against
the JAX package's, and against its own barrier admission.

After JAX's ``tests/test_streaming_prefill.py``: test-tiny on one float32
weight tree (the JAX engine on its default XLA path on the CPU), two slots.
Unset, the knob leaves the barrier admission as it was; set, a prompt longer
than C admits in (1, C) pieces between its batch-mate's decode chunks and
every request decodes the barrier admission's tokens exactly, at C = 16
(the pieces through K7's plain version) and 64 (the plain gathered
attention), cold and through radix chains. A cancel between pieces frees
every block and inserts nothing; a mixed fuzz of chunked, barrier,
cancelled and chaos-poisoned admissions ends with the pool where it began,
each outcome equal to JAX's.
"""

import random

import jax
import numpy as np
import pytest
import torch

from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent.utils import chaos as jchaos
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.services.brain import install_prompt_prefix
from tpu_voice_agent_torch.utils import chaos as tchaos
from tpu_voice_agent_torch.utils.tracing import get_metrics

KW = dict(preset="test-tiny", max_len=1024, batch_slots=2, prefill_buckets=(128, 256, 512, 1024))
PROMPTS = [
    render_prompt("search for wireless headphones", {}),
    render_prompt("open the second result please", {"last_query": "x"}),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    eng = JPaged(kernels="xla", **KW)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


def _port(weights, radix=False, prefix=True, cls=PagedDecodeEngine, **kw):
    extra = {} if cls is DecodeEngine else {"radix_enable": radix}
    eng = cls(init_weights=False, device="cpu", **extra, **KW, **kw)
    eng.load_params(bridge.params_from_numpy(weights))
    if prefix:
        install_prompt_prefix(eng)
    return eng


def _jax(weights, radix=False, prefix=True, **kw):
    eng = JPaged(kernels="xla", init_weights=False, radix_enable=radix, **KW, **kw)
    eng.load_params(jax.device_put(weights))
    if prefix:
        j_install(eng)
    return eng


def _run(eng, prompts, monkeypatch, chunk=None, max_new=24):
    if chunk:
        monkeypatch.setenv("PREFILL_CHUNK_TOKENS", str(chunk))
    else:
        monkeypatch.delenv("PREFILL_CHUNK_TOKENS", raising=False)
    Batcher = JBatcher if isinstance(eng, JPaged) else ContinuousBatcher
    return Batcher(eng, chunk_steps=16, max_new_tokens=max_new).generate_many(prompts)


def _leak_check(eng):
    """With no live slot, every resident block is the tree's (or the
    pinned prefix's, radix off)."""
    if eng.radix is not None:
        trees = eng.radix if isinstance(eng.radix, list) else [eng.radix]
        assert eng.allocator.blocks_in_use == sum(t.nodes for t in trees)
    else:
        pb = eng._prefix_blocks
        pb = pb[0] if pb and isinstance(pb[0], list) else pb  # JAX keeps one list a group
        assert eng.allocator.blocks_in_use == len(pb)


@pytest.fixture(scope="module")
def plain(weights):
    """No cached prefix: the whole ~900-token prompt is computed suffix, so
    a chunked admission runs many pieces beside its batch-mate's decode."""
    return _port(weights, prefix=False)


@pytest.fixture(scope="module")
def barrier(plain):
    mp = pytest.MonkeyPatch()
    try:
        res = _run(plain, PROMPTS, mp)
    finally:
        mp.undo()
    assert all(r.error is None for r in res)
    return res


def test_chunk_knob_unset_keeps_the_barrier_path(plain, weights, monkeypatch):
    monkeypatch.delenv("PREFILL_CHUNK_TOKENS", raising=False)
    b = ContinuousBatcher(plain, chunk_steps=16, max_new_tokens=8)
    assert b._prefill_chunk == 0 and b._admitting == {}
    # the dense engine has no chunked admission: the knob leaves it on the
    # barrier path, token for token
    monkeypatch.setenv("PREFILL_CHUNK_TOKENS", "64")
    dense = _port(weights, prefix=False, cls=DecodeEngine)
    before = get_metrics().snapshot()["counters"].get("prefill.chunked_admissions", 0.0)
    res = ContinuousBatcher(dense, chunk_steps=16, max_new_tokens=24).generate_many(PROMPTS)
    assert get_metrics().snapshot()["counters"]["prefill.chunked_admissions"] == before
    jres = _run(_jax(weights, prefix=False), PROMPTS, monkeypatch)
    assert [r.token_ids for r in res] == [r.token_ids for r in jres]


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_prefill_token_identity_and_batchmate_isolation(plain, barrier, weights,
                                                                monkeypatch, chunk):
    """THE chunked differential: a long cold prompt admitted in C-token
    pieces decodes the barrier admission's tokens, and so does its
    batch-mate decoding while the pieces interleave; the JAX batcher at the
    same C agrees, counters included."""
    c0 = get_metrics().snapshot()["counters"]
    res = _run(plain, PROMPTS, monkeypatch, chunk=chunk)
    c1 = get_metrics().snapshot()["counters"]
    for b, c in zip(barrier, res):
        assert c.error is None and c.token_ids == b.token_ids
        assert c.prompt_tokens == b.prompt_tokens and c.cached_tokens == 0
    adm = c1["prefill.chunked_admissions"] - c0.get("prefill.chunked_admissions", 0.0)
    pieces = c1["prefill.chunks"] - c0.get("prefill.chunks", 0.0)
    assert adm == 2 and pieces == sum(-(-r.prompt_tokens // chunk) for r in res)
    assert plain.allocator.blocks_in_use == 0
    jres = _run(_jax(weights, prefix=False), PROMPTS, monkeypatch, chunk=chunk)
    assert [r.token_ids for r in jres] == [r.token_ids for r in res]


def test_chunked_prefill_identity_with_prefix_and_radix(weights, monkeypatch):
    """Over the cached few-shot prefix and the radix plane: the cold run
    seeds chains, the warm rerun admits through a matched chain, and every
    run decodes the barrier cold engine's tokens, as JAX's do."""
    cold = _run(_port(weights), PROMPTS, monkeypatch)
    on = _port(weights, radix=True)
    warm1 = _run(on, PROMPTS, monkeypatch, chunk=16)
    warm2 = _run(on, PROMPTS, monkeypatch, chunk=16)
    for c, w1, w2 in zip(cold, warm1, warm2):
        assert c.error is None and w1.error is None and w2.error is None
        assert c.token_ids == w1.token_ids == w2.token_ids
    assert all(w.cached_tokens >= len(on.prefix_ids) for w in warm2)
    assert any(w.cached_tokens > len(on.prefix_ids) for w in warm2)
    _leak_check(on)
    jon = _jax(weights, radix=True)
    j1 = _run(jon, PROMPTS, monkeypatch, chunk=16)
    j2 = _run(jon, PROMPTS, monkeypatch, chunk=16)
    assert [(r.token_ids, r.cached_tokens) for r in j1 + j2] == [
        (r.token_ids, r.cached_tokens) for r in warm1 + warm2]


def test_cancel_mid_chunked_admission_releases_everything(weights, monkeypatch):
    """A cancel between pieces: the admission dies alone with a typed error,
    its blocks come back, nothing was half-inserted into the radix tree,
    and the engine serves on."""
    monkeypatch.setenv("PREFILL_CHUNK_TOKENS", "32")
    for eng, Batcher in ((_port(weights, radix=True, prefix=False), ContinuousBatcher),
                         (_jax(weights, radix=True, prefix=False), JBatcher)):
        b = Batcher(eng, chunk_steps=4, max_new_tokens=16)
        rid = b.submit(eng.tokenizer.encode(PROMPTS[0], bos=True))
        b.step()  # begin + the first piece; the prompt is far longer than 32
        assert rid not in b.results and b._admitting
        assert b.cancel(rid, reason="ws teardown")
        assert b.results[rid].error == "cancelled: ws teardown" and not b._admitting
        _leak_check(eng)
        assert eng.allocator.blocks_in_use == 0
        assert Batcher(eng, chunk_steps=16, max_new_tokens=24).generate_many(
            [PROMPTS[1]])[0].error is None
        _leak_check(eng)


def test_mixed_chunked_barrier_cancelled_poisoned_fuzz_zero_leakage(weights, monkeypatch):
    """Random rounds of chunked and barrier admissions, cancels between
    pieces and NaN-poisoned rows (the chaos arms at a chunked admission's
    final piece) on a small radix pool: each outcome equals JAX's, and after
    every drain the only resident blocks are the tree's."""
    monkeypatch.setenv("PREFILL_CHUNK_TOKENS", "48")
    texts = ["search for wireless headphones", "open the second result",
             "scroll down two pages then go back", "take a screenshot of this page"]
    outcomes = []
    for eng, Batcher, mod in ((_port(weights, radix=True, pool_blocks=48), ContinuousBatcher,
                               tchaos),
                              (_jax(weights, radix=True, pool_blocks=48), JBatcher, jchaos)):
        rng = random.Random(19)
        seen = []
        mod.configure("nan_logits:0.3", seed=5)
        try:
            for _ in range(8):
                b = Batcher(eng, chunk_steps=4, max_new_tokens=12)
                t = rng.choice(texts)
                op = rng.random()
                if op < 0.4:
                    # a prompt off the cached prefix: several pieces, so the
                    # cancel lands between them
                    rid = b.submit(eng.tokenizer.encode((t + " ") * 20, bos=True))
                    b.step()
                    assert b._admitting
                    b.cancel(rid, reason="fuzz")
                    seen.append(b.results.pop(rid).error)
                else:
                    r = b.generate_many([render_prompt(t, {}), render_prompt(t[::-1], {})])
                    seen.append([(x.error, x.token_ids) for x in r])
                b.run_until_done()
                _leak_check(eng)
        finally:
            mod.reset()
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]
    flat = repr(outcomes[0])
    assert "cancelled: fuzz" in flat and "poisoned: non-finite logits" in flat
