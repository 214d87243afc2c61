"""The dp x tp mesh of the port against the JAX package.

``parallel/mesh.py``'s placement plans equal JAX's specs; the sharded kernel
wrappers (``ops/sharded.py``) equal JAX's shard_map'd Pallas kernels
(interpret mode, its 8 virtual CPU devices) on a one-process mesh of CPU
devices, where each shard runs the kernel's plain version; the
tensor-parallel forward equals JAX's meshed and unsharded forwards
(rtol / atol 2e-3, JAX's own tolerance); the meshed engine's tokens equal
JAX's meshed engine's and the port's unmeshed engine's in float32 (the tp
sums reorder additions; float32 keeps greedy picks clear of that noise).
Mirrors ``test_llama.py::test_tp_sharded_forward_matches_unsharded``,
``test_engine.py::test_dp_mesh_requires_divisible_batch_slots``,
``test_ops_sharded.py``, ``test_moe_llama.py::test_moe_ep_mesh_forward_matches_unsharded``
and ``test_hf_real.py::test_from_hf_on_mesh_pads_vocab_to_tp_multiple``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_hf_helper import write_llama_checkpoint
from tpu_voice_agent import ops as jops
from tpu_voice_agent.models.llama import LlamaConfig as JConfig
from tpu_voice_agent.models.llama import forward as j_forward
from tpu_voice_agent.models.llama import init_kv_cache as j_cache
from tpu_voice_agent.models.llama import init_params as j_init
from tpu_voice_agent.parallel import mesh as jmesh
from tpu_voice_agent.serve import DecodeEngine as JDense
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent_torch import bridge, ops
from tpu_voice_agent_torch.models.llama import PRESETS, LlamaConfig, forward, init_kv_cache
from tpu_voice_agent_torch.parallel.mesh import (
    Sharded,
    default_rules,
    kv_cache_shardings,
    make_mesh,
    param_shardings,
    place,
    place_tree,
    quantized_param_shardings,
)
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.serve.spec import SpecConfig

CPU = torch.device("cpu")
TOL = dict(rtol=2e-3, atol=2e-3)
CFG = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
           max_seq_len=64)
MOE = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96,
           max_seq_len=128, n_experts=4, top_k=2, capacity_factor=2.0)
PROMPTS = [render_prompt("search for mechanical keyboards", {}),
           render_prompt("go back", {"last_query": "keyboards"})]
KW = dict(max_len=1024, batch_slots=2, prefill_buckets=(512, 1024), init_weights=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one torch thread per worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(jtree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jtree))


def _mesh(dp, tp):
    return make_mesh(dp, tp, [CPU] * (dp * tp))


def _cache(cfg, mesh, B, S):
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    return {n: Sharded.zeros(mesh, shape, s, torch.float32)
            for n, s in kv_cache_shardings(mesh, cfg.n_kv_heads).items()}


# ---------------------------------------------------------------- plans


def test_make_mesh_shape_and_refusal():
    m = _mesh(2, 2)
    assert m.shape == {"dp": 2, "tp": 2} and m.devices.shape == (2, 2)
    with pytest.raises(ValueError) as e:
        make_mesh(4, 4, [CPU] * 8)
    with pytest.raises(ValueError) as ej:
        jmesh.make_mesh(dp=4, tp=4)
    assert str(e.value) == str(ej.value)


@pytest.mark.parametrize("tp,nkv,E", [(2, 2, 0), (4, 2, 0), (2, 2, 4), (4, 2, 6)])
def test_placement_plans_equal_jax(tp, nkv, E):
    m, jm = _mesh(1, tp), jmesh.make_mesh(dp=1, tp=tp)

    def specs(tree):
        if isinstance(tree, dict):
            return {k: specs(v) for k, v in tree.items()}
        return tuple(tree.spec) if hasattr(tree, "spec") else tree

    def norm(tree):  # JAX's P() of a replicated leaf lists no trailing Nones
        if isinstance(tree, dict):
            return {k: norm(v) for k, v in tree.items()}
        t = list(tree)
        while t and t[-1] is None:
            t.pop()
        return tuple(t)

    assert norm(param_shardings(m, nkv, E)) == norm(specs(jmesh.param_shardings(jm, nkv, E)))
    assert norm(quantized_param_shardings(m, nkv, E)) == norm(
        specs(jmesh.quantized_param_shardings(jm, nkv, E)))
    assert norm(kv_cache_shardings(m, nkv)) == norm(specs(jmesh.kv_cache_shardings(jm, nkv)))
    rules, jrules = default_rules(m, nkv, 4), jmesh.default_rules(jm, nkv, 4)
    assert {k: norm(v) for k, v in rules.specs} == {k: norm(tuple(v)) for k, v in jrules.specs}


def test_place_and_gather_round_trip():
    m = _mesh(2, 2)
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    for spec in [("dp", None, "tp"), (None, "tp", None), ("tp", "dp", None), (None,)]:
        s = place(x, m, spec)
        assert torch.equal(s.full(), x)
        assert all(t.is_contiguous() for t in s.shards.values())
    with pytest.raises(ValueError, match="does not divide"):
        place(torch.zeros(3, 4), m, ("dp",))


# ---------------------------------------------------------------- sharded kernels


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_sharded_decode_attention_matches_jax():
    rng = np.random.default_rng(0)
    B, S, nq, nkv, hd = 4, 64, 8, 4, 32
    q, k, v = _randn(rng, B, nq, hd), _randn(rng, B, S, nkv, hd), _randn(rng, B, S, nkv, hd)
    kv_len = np.asarray([5, 17, 33, 64], np.int32)
    ref = np.asarray(jops.sharded_decode_attention(jmesh.make_mesh(dp=2, tp=2),
                                                   *map(jnp.asarray, (q, k, v, kv_len))))
    out = ops.sharded_decode_attention(_mesh(2, 2), *map(torch.from_numpy, (q, k, v, kv_len)))
    assert out.spec == ("dp", "tp", None)
    np.testing.assert_allclose(out.full().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_sharded_decode_attention_tp_indivisible_heads_replicates():
    rng = np.random.default_rng(1)
    B, S, nq, nkv, hd = 2, 32, 6, 3, 16
    q, k, v = _randn(rng, B, nq, hd), _randn(rng, B, S, nkv, hd), _randn(rng, B, S, nkv, hd)
    kv_len = np.asarray([10, 32], np.int32)
    ref = np.asarray(jops.sharded_decode_attention(jmesh.make_mesh(dp=2, tp=2),
                                                   *map(jnp.asarray, (q, k, v, kv_len))))
    out = ops.sharded_decode_attention(_mesh(2, 2), *map(torch.from_numpy, (q, k, v, kv_len)))
    assert out.spec == ("dp", None, None)  # heads replicated, batch still over dp
    np.testing.assert_allclose(out.full().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_sharded_flash_attention_matches_jax():
    rng = np.random.default_rng(2)
    B, T, nq, nkv, hd = 2, 32, 8, 4, 32
    q, k, v = _randn(rng, B, T, nq, hd), _randn(rng, B, T, nkv, hd), _randn(rng, B, T, nkv, hd)
    ref = np.asarray(jops.sharded_flash_attention(jmesh.make_mesh(dp=2, tp=2),
                                                  *map(jnp.asarray, (q, k, v)), causal=True))
    out = ops.sharded_flash_attention(_mesh(2, 2), *map(torch.from_numpy, (q, k, v)),
                                      causal=True)
    np.testing.assert_allclose(out.full().numpy(), ref, rtol=1e-5, atol=1e-5)
    # a B = 1 admission on a dp 2 mesh runs replicated over dp
    one = ops.sharded_flash_attention(_mesh(2, 2), *(torch.from_numpy(a[:1]) for a in (q, k, v)),
                                      causal=True)
    assert one.spec == (None, None, "tp", None)
    np.testing.assert_allclose(one.full().numpy(), ref[:1], rtol=1e-5, atol=1e-5)


def test_sharded_masked_argmax_matches_jax():
    rng = np.random.default_rng(3)
    B, V, S = 4, 512, 7
    logits = _randn(rng, B, V)
    mask = rng.random((S, V)) < 0.3
    mask[:, 0] = True
    state = np.asarray([0, 2, 5, 6], np.int32)
    ref = np.asarray(jops.sharded_masked_argmax(jmesh.make_mesh(dp=2, tp=2),
                                                *map(jnp.asarray, (logits, state, mask))))
    out = ops.sharded_masked_argmax(_mesh(2, 2), *map(torch.from_numpy, (logits, state, mask)))
    np.testing.assert_array_equal(out.full().numpy(), ref)


def test_sharded_masked_argmax_advance_and_block_match_jax():
    rng = np.random.default_rng(4)
    B, T, V, S, C = 4, 3, 256, 9, 5
    logits = _randn(rng, B, T, V)
    mask = rng.random((S, V)) < 0.4
    mask[:, 1] = True
    table = rng.integers(-1, S, (S, C)).astype(np.int32)
    col = rng.integers(0, C, (V,)).astype(np.int32)
    state = rng.integers(0, S, (B, T)).astype(np.int32)
    jm, m = jmesh.make_mesh(dp=2, tp=2), _mesh(2, 2)
    jt, jn = jops.sharded_masked_argmax_advance(jm, *map(jnp.asarray, (
        logits[:, 0], state[:, 0], mask, table, col)))
    t, n = ops.sharded_masked_argmax_advance(m, *map(torch.from_numpy, (
        np.ascontiguousarray(logits[:, 0]), np.ascontiguousarray(state[:, 0]), mask, table, col)))
    np.testing.assert_array_equal(t.full().numpy(), np.asarray(jt))
    np.testing.assert_array_equal(n.full().numpy(), np.asarray(jn))
    jb = jops.sharded_masked_argmax_block(jm, *map(jnp.asarray, (logits, state, mask)))
    b = ops.sharded_masked_argmax_block(m, *map(torch.from_numpy, (logits, state, mask)))
    np.testing.assert_array_equal(b.full().numpy(), np.asarray(jb))


def test_sharded_decode_layer_kernels_match_jax():
    rng = np.random.default_rng(6)
    L, B, T, nq, nkv, hd, S = 2, 4, 3, 8, 4, 32, 128
    q, kc, vc = _randn(rng, B, T, nq, hd), _randn(rng, L, B, S, nkv, hd), _randn(rng, L, B, S,
                                                                                   nkv, hd)
    q_pos = np.asarray([[5, 6, 7], [0, 0, 0], [40, 41, 42], [99, 100, 101]], np.int32)
    kv_len = q_pos[:, -1] + 1
    jm, m = jmesh.make_mesh(dp=2, tp=2), _mesh(2, 2)
    for li in range(L):
        ref = jops.sharded_decode_block_attention_layer(
            jm, *map(jnp.asarray, (q, kc, vc, q_pos)), jnp.int32(li))
        out = ops.sharded_decode_block_attention_layer(
            m, *map(torch.from_numpy, (q, kc, vc, q_pos)), li)
        np.testing.assert_allclose(out.full().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        ref = jops.sharded_decode_attention_layer(
            jm, *map(jnp.asarray, (np.ascontiguousarray(q[:, 0]), kc, vc, kv_len)),
            jnp.int32(li))
        out = ops.sharded_decode_attention_layer(
            m, *map(torch.from_numpy, (np.ascontiguousarray(q[:, 0]), kc, vc, kv_len)), li)
        np.testing.assert_allclose(out.full().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_sharded_wrappers_fall_through_and_keep_layouts():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_randn(rng, 2, 8, 4, 16)) for _ in range(3))
    plain = ops.sharded_flash_attention(None, q, k, v, causal=True)
    assert isinstance(plain, torch.Tensor)
    torch.testing.assert_close(plain, ops.flash_attention(q, k, v, causal=True))
    m = _mesh(2, 2)
    with pytest.raises(ValueError, match="laid out"):  # a Sharded is never re-laid out
        ops.sharded_flash_attention(m, place(q, m, (None, "tp")), k, v, causal=True)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("cfg,dp,tp", [(CFG, 1, 2), (CFG, 2, 2), (CFG, 1, 4), (MOE, 1, 2)],
                         ids=["dense-1x2", "dense-2x2", "dense-1x4-heads-replicated",
                              "moe-ep-1x2"])
def test_tp_sharded_forward_matches_jax_and_unsharded(cfg, dp, tp):
    """JAX's test_tp_sharded_forward_matches_unsharded and
    test_moe_ep_mesh_forward_matches_unsharded on the port: prefill, then a
    T = 1 step and a T = 3 mid-sequence block, each against the JAX meshed
    forward and the port's unsharded one (2e-3)."""
    jcfg, tcfg = JConfig(**cfg), LlamaConfig(**cfg)
    jp = j_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp_params = _tree(jp)
    B, T = max(dp, 1), 8
    jm, m = jmesh.make_mesh(dp=dp, tp=tp), _mesh(dp, tp)
    rules = jmesh.default_rules(jm, jcfg.n_kv_heads, jcfg.n_heads)
    jsp = jax.device_put(jp, jmesh.param_shardings(jm, jcfg.n_kv_heads, jcfg.n_experts))
    jc = jax.device_put(j_cache(jcfg, B, jcfg.max_seq_len, dtype=jnp.float32),
                        jmesh.kv_cache_shardings(jm, jcfg.n_kv_heads))
    sp = place_tree(tp_params, m, param_shardings(m, tcfg.n_kv_heads, tcfg.n_experts))
    sc = _cache(tcfg, m, B, tcfg.max_seq_len)
    rc = init_kv_cache(tcfg, B, tcfg.max_seq_len, dtype=torch.float32)
    trules = default_rules(m, tcfg.n_kv_heads, tcfg.n_heads)
    tokens = (np.arange(T, dtype=np.int32)[None, :] * 3 + np.arange(B)[:, None]) % cfg[
        "vocab_size"]
    steps = [(tokens, np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)), True),
             (tokens[:, :1], np.full((B, 1), T, np.int32), False),
             (tokens[:, 1:4], np.broadcast_to(np.arange(T + 1, T + 4, dtype=np.int32), (B, 3)),
              False)]
    for tok, pos, fresh in steps:
        tok, pos = np.array(tok), np.array(pos)
        jl, jc = j_forward(jsp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc, rules)
        ml, _ = forward(sp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos), sc,
                        fresh_block=fresh, rules=trules)
        rl, _ = forward(tp_params, tcfg, torch.from_numpy(tok), torch.from_numpy(pos), rc,
                        fresh_block=fresh)
        np.testing.assert_allclose(ml.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(ml.numpy(), rl.numpy(), **TOL)
    np.testing.assert_allclose(sc["k"].full().numpy(), rc["k"].numpy(), **TOL)


# ---------------------------------------------------------------- engine


def test_dp_mesh_requires_divisible_batch_slots():
    with pytest.raises(ValueError, match="divisible") as e:
        DecodeEngine(preset="test-tiny", mesh=_mesh(2, 1), batch_slots=1)
    with pytest.raises(ValueError) as ej:
        JDense(preset="test-tiny", mesh=jmesh.make_mesh(dp=2, tp=1), batch_slots=1)
    assert str(e.value) == str(ej.value)


def test_mesh_refusals_name_what_and_where():
    grouped = dataclasses.replace(PRESETS["mixtral-test"], moe_impl="grouped")
    with pytest.raises(ValueError, match="single-device"):
        DecodeEngine(cfg=grouped, mesh=_mesh(1, 2), init_weights=False)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 8"):
        PagedDecodeEngine(preset="test-tiny", mesh=_mesh(1, 2), init_weights=False)
    eng = DecodeEngine(preset="test-tiny", device="cpu", init_weights=False, max_len=256,
                       prefill_buckets=(256,))
    with pytest.raises(ValueError) as e:  # the unpadded FSM on a vocab-padding mesh
        DecodeEngine(preset="test-tiny", mesh=_mesh(1, 2), fsm=eng.fsm, init_weights=False,
                     max_len=256, prefill_buckets=(256,))
    jeng = JDense(preset="test-tiny", init_weights=False, max_len=256, prefill_buckets=(256,))
    with pytest.raises(ValueError) as ej:
        JDense(preset="test-tiny", mesh=jmesh.make_mesh(dp=1, tp=2), fsm=jeng.fsm,
               init_weights=False, max_len=256, prefill_buckets=(256,))
    assert str(e.value) == str(ej.value)


@pytest.fixture(scope="module")
def mesh_weights():
    """float32 test-tiny weights at the dp 2 x tp 2 engine's padded vocab."""
    eng = DecodeEngine(preset="test-tiny", mesh=_mesh(2, 2), **KW)
    raw = j_init(eng.cfg, jax.random.PRNGKey(11), dtype=jnp.float32)
    return jax.tree.map(np.asarray, raw)


def _unpadded(raw, vocab):
    return {**raw, "embed": raw["embed"][:vocab], "lm_head": raw["lm_head"][:, :vocab]}


def test_meshed_engine_tokens_equal_jax_meshed_and_unmeshed(mesh_weights):
    jeng = JDense(preset="test-tiny", mesh=jmesh.make_mesh(dp=2, tp=2), kernels="xla", **KW)
    jeng.load_params(jax.device_put(mesh_weights, jeng._param_shardings))
    meng = DecodeEngine(preset="test-tiny", mesh=_mesh(2, 2), **KW)
    meng.load_params(bridge.params_from_numpy(mesh_weights))
    assert meng.cfg.vocab_size == jeng.cfg.vocab_size == 620
    assert meng.logit_mask is not None and not bool(meng.logit_mask[-1])
    dense = DecodeEngine(preset="test-tiny", device="cpu", **KW)
    dense.load_params(bridge.params_from_numpy(_unpadded(mesh_weights, dense.cfg.vocab_size)))
    jr = JBatcher(jeng, chunk_steps=8, max_new_tokens=40).generate_many(PROMPTS)
    mr = ContinuousBatcher(meng, chunk_steps=8, max_new_tokens=40).generate_many(PROMPTS)
    dr = ContinuousBatcher(dense, chunk_steps=8, max_new_tokens=40).generate_many(PROMPTS)
    for j, m, d in zip(jr, mr, dr):
        assert m.error is None and meng.fsm.walk(m.token_ids) >= 0
        assert m.token_ids == j.token_ids == d.token_ids


@pytest.mark.parametrize("kind", ["ff8", "spec", "prefix-int8"])
def test_meshed_engine_paths_equal_the_unmeshed_engine(mesh_weights, kind):
    """Fast-forward chains (K3 per shard), speculative verify (K11 per
    shard) and the cached prefix with int8 weights quantized onto their
    shards, each against the unmeshed engine on the same weights."""
    kw = dict(KW)
    if kind == "ff8":
        kw["fast_forward"] = 8
    if kind == "spec":
        kw["spec"] = SpecConfig(k=4)
    if kind == "prefix-int8":
        kw["quant"] = "int8"
    meng = DecodeEngine(preset="test-tiny", mesh=_mesh(2, 2), **kw)
    meng.load_params(bridge.params_from_numpy(mesh_weights))
    dense = DecodeEngine(preset="test-tiny", device="cpu", **kw)
    dense.load_params(bridge.params_from_numpy(_unpadded(mesh_weights, dense.cfg.vocab_size)))
    if kind == "prefix-int8":
        from tpu_voice_agent_torch.services.brain import install_prompt_prefix

        assert install_prompt_prefix(meng) == install_prompt_prefix(dense) > 0
        wq = meng.params["layers"][0]["wq"]
        assert wq["q"].dtype == torch.int8 and wq["q"].spec == (None, "tp")
        assert wq["s"].spec == (None, "tp") and meng.params["layers"][0]["wo"]["s"].spec == (
            None, None)
    mr = ContinuousBatcher(meng, chunk_steps=8, max_new_tokens=40).generate_many(PROMPTS)
    dr = ContinuousBatcher(dense, chunk_steps=8, max_new_tokens=40).generate_many(PROMPTS)
    for m, d in zip(mr, dr):
        assert m.error is None and m.token_ids == d.token_ids
        if kind == "prefix-int8":
            assert m.cached_tokens == d.cached_tokens > 0
    meng.warm_restart()
    assert all(float(t.abs().sum()) == 0 for t in meng.cache["k"].shards.values())


def test_unconstrained_decode_never_samples_padded_ids(tmp_path):
    """A checkpoint's padded vocab ids (config vocab past the tokenizer's)
    decode to nothing: JAX masks them out of unconstrained sampling
    (``logit_mask``), and so must the port. The padded lm_head columns are
    made to dominate, so an unmasked pick would take them."""
    from tpu_voice_agent.serve import DecodeEngine as JD

    write_llama_checkpoint(tmp_path)
    kw = dict(max_len=512, prefill_buckets=(256, 512))
    jeng = JD.from_hf(str(tmp_path), dtype=jnp.float32, **kw)
    teng = DecodeEngine.from_hf(str(tmp_path), dtype=torch.float32, device="cpu", **kw)
    n = teng.tokenizer.vocab_size
    head = np.asarray(jeng.params["lm_head"]).copy()
    head[:, n:] = 40.0 * head[:, 3:3 + head.shape[1] - n] * np.sign(
        np.arange(head.shape[1] - n) % 2 - 0.5)[None, :]
    jeng.params = {**jeng.params, "lm_head": jnp.asarray(head)}
    teng.params["lm_head"] = torch.from_numpy(head)
    jres = jeng.generate("hello there", max_new_tokens=12, constrained=False)
    tres = teng.generate("hello there", max_new_tokens=12, constrained=False)
    assert max(tres.token_ids) < n
    assert tres.token_ids == jres.token_ids


def test_from_hf_on_mesh_pads_vocab_to_tp_multiple(tmp_path):
    """from_hf on a dp x tp mesh whose tp does not divide the checkpoint's
    vocab: the embed rows and lm_head columns pad to a tp multiple and the
    constrained decode equals JAX's meshed from_hf (F32 safetensors)."""
    write_llama_checkpoint(tmp_path, pad=7)
    import json

    vocab = json.loads((tmp_path / "config.json").read_text())["vocab_size"]
    tp = next(t for t in (4, 2) if vocab % t)
    kw = dict(batch_slots=2, max_len=4096, prefill_buckets=(1024, 2048, 4096))
    teng = DecodeEngine.from_hf(str(tmp_path), mesh=_mesh(2, tp), dtype=torch.float32, **kw)
    assert teng.cfg.vocab_size % tp == 0 and teng.cfg.vocab_size > vocab
    assert teng.params["embed"].shape[0] == teng.cfg.vocab_size
    assert teng.params["lm_head"].shape[1] == teng.cfg.vocab_size
    jeng = JDense.from_hf(str(tmp_path), mesh=jmesh.make_mesh(dp=2, tp=tp), kernels="xla",
                          dtype=jnp.float32, **kw)
    prompt = [render_prompt("go back", {})]
    res = ContinuousBatcher(teng, chunk_steps=16, max_new_tokens=60).generate_many(prompt)[0]
    jres = JBatcher(jeng, chunk_steps=16, max_new_tokens=60).generate_many(prompt)[0]
    assert res.error is None and teng.fsm.walk(res.token_ids) >= 0
    assert res.token_ids == jres.token_ids
    q8 = DecodeEngine.from_hf(str(tmp_path), mesh=_mesh(1, tp), quant="int8", **kw)
    head = q8.params["lm_head"]
    assert head["q"].shape[1] == q8.cfg.vocab_size
    assert torch.all(head["s"].full()[..., vocab:] == 1.0)
    assert torch.all(head["q"].full()[:, vocab:] == 0)
