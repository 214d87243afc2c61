"""The port's MoE decoder against the JAX package's, on the same numpy-seeded
inputs and ``bridge``d weights.

Covered: the routing math (``models.moe``), K13's plain version
(``ops.grouped_matmul_reference``) against the JAX kernel in interpret mode,
both MoE feed-forward layouts, the MoE leaves of the parameter tree (init,
quantization, the quantizing init, ``param_count``, ``bridge``), and the
``mixtral-test`` engines token for token against JAX's: single slot, dense
and grouped, at fast-forward 8 and 0, and the paged batcher grouped at 8.

Tolerances, each with its reason:
- routing: expert ids exactly (ties included); probabilities 1e-6 (fp32
  softmax of logits summed in another order);
- K13 plain version in fp32: rtol = atol = 1e-5 (fp32 sums in another
  order); in bf16: rtol 2^-7 (both round an fp32 sum to bf16 once, sums in
  another order can land on either side of a rounding boundary: one bf16
  ulp);
- MoE layers in fp32: 1e-5 (fp32 sums in another order); grouped against
  dense in fp32: 2e-4, the JAX test's (the dense path routes through
  one-hot einsums, the grouped one through sorted rows);
- prefill against per-token decode: 2e-4, the JAX test's;
- engines: greedy ids identical, in fp32 so that no argmax turns on a bf16
  rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models import llama as jl
from tpu_voice_agent.models import moe as jmoe
from tpu_voice_agent.ops.grouped_matmul import grouped_matmul as j_gmm
from tpu_voice_agent.serve import DecodeEngine as JEngine
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent_torch import bridge, ops
from tpu_voice_agent_torch.models import llama as tl
from tpu_voice_agent_torch.models import moe as tmoe
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.services.brain import install_prompt_prefix

F32 = dict(rtol=1e-5, atol=1e-5)
# the JAX MoE test's config: drop-free capacity (E / K), ffn 96 (ragged
# against the card kernel's 128-column tile)
JCFG = jl.LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96,
                      max_seq_len=128, n_experts=4, top_k=2, capacity_factor=2.0)
TCFG = tl.LlamaConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: intra-op threads buy nothing, and under the
    suite's parallel workers every process's threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """JCFG weights in fp32: the JAX tree and the port's, bridged."""
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, bridge.params_from_numpy(_np(jp))


def _layer0(jp, tp):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]),
            tl.unstack_layers(tp["layers"])[0])


# ---------------------------------------------------------------- routing


def _router_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    w = rng.standard_normal((32, 6)).astype(np.float32)
    w[:, 4] = w[:, 1]  # experts 1 and 4 tie exactly on every token
    x[3] = 0.0  # all six tie on token 3
    return x, w


def test_select_topk_matches_jax_with_ties():
    x, w = _router_inputs()
    jp, jids = jmoe._select_topk(jnp.asarray(w), jnp.asarray(x), 6, 3)
    tp, tids = tmoe._select_topk(torch.from_numpy(w), torch.from_numpy(x), 6, 3)
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    assert tids[3].tolist() == [0, 1, 2]  # a full tie takes the first indices
    # where 1 and 4 are both picked, the first pick is 1 (the first maximum)
    both = [r for r in tids.tolist() if 1 in r and 4 in r]
    assert both and all(r.index(1) < r.index(4) for r in both)


def test_route_topk_flat_and_dense_match_jax():
    x, w = _router_inputs()
    je, jg = jmoe.route_topk_flat(jnp.asarray(w), jnp.asarray(x), 6, 2)
    te, tg = tmoe.route_topk_flat(torch.from_numpy(w), torch.from_numpy(x), 6, 2)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    for C in (2, 16):  # overflow drops (C = 2 of 16 tokens) and drop-free
        assert tmoe.moe_capacity(16, 6, 2, 1.25) == jmoe.moe_capacity(16, 6, 2, 1.25)
        jd, jc = jmoe.route_topk(jnp.asarray(w), jnp.asarray(x), 6, 2, C)
        td, tc = tmoe.route_topk(torch.from_numpy(w), torch.from_numpy(x), 6, 2, C)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- K13 plain


@pytest.mark.parametrize("tm", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_plain_matches_jax_kernel(tm, dtype):
    """JAX's test shapes at tm 8 (M 64, d 32, f 64, E 4, its tile_expert);
    every other tm on M 256 with f 96 and a random tile_expert."""
    rng = np.random.default_rng(tm)
    if tm == 8:
        M, d, f, E = 64, 32, 64, 4
        te = np.array([0, 0, 1, 3, 3, 2, 1, 0], np.int32)
    else:
        M, d, f, E = 256, 32, 96, 4
        te = rng.integers(0, E, M // tm).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((M, d)), jdt)
    w = jnp.asarray(rng.standard_normal((E, d, f)), jdt)
    ref = np.asarray(j_gmm(x, w, jnp.asarray(te), tm=tm).astype(jnp.float32))
    tx, tw = bridge.tensor_from_numpy(np.asarray(x)), bridge.tensor_from_numpy(np.asarray(w))
    ops.reset_launch_counts()
    out = ops.grouped_matmul(tx, tw, torch.from_numpy(te), tm)
    assert out.dtype == tx.dtype and out.shape == (M, f)
    assert ops.launch_counts()["grouped_matmul"] == 0  # CPU tensors: the plain version
    tol = F32 if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


def test_int8_leaf_is_the_reference_on_w_of_the_leaf():
    """``dequantize_leaf`` is the JAX module's ``_w`` bit for bit, and the
    wrapper on an int8 leaf computes the plain version on it."""
    rng = np.random.default_rng(5)
    w = jnp.asarray(rng.standard_normal((4, 32, 96)) * 0.1, jnp.bfloat16)
    jleaf = jl.quantize_leaf(w)
    leaf = bridge.params_from_numpy(_np(jleaf))
    dense = ops.dequantize_leaf(leaf)
    assert dense.dtype == torch.bfloat16
    np.testing.assert_array_equal(dense.view(torch.int16).numpy(),
                                  np.asarray(jl._w(jleaf)).view(np.int16))
    x = bridge.tensor_from_numpy(np.asarray(jnp.asarray(rng.standard_normal((64, 32)),
                                                        jnp.bfloat16)))
    te = torch.tensor([0, 3, 3, 1], dtype=torch.int32)
    assert torch.equal(ops.grouped_matmul(x, leaf, te, 16),
                       ops.grouped_matmul_reference(x, dense, te, 16))


# ---------------------------------------------------------------- MoE layers


@pytest.mark.parametrize("impl", ["dense", "grouped"])
def test_moe_ffn_matches_jax(trees, impl):
    jp, tp = _layer0(*trees)
    h = np.random.default_rng(1).standard_normal((2, 12, JCFG.dim)).astype(np.float32)
    jcfg, tcfg = (dataclasses.replace(c, moe_impl=impl) for c in (JCFG, TCFG))
    ref = np.asarray(jl._moe_ffn(jp, jnp.asarray(h), jcfg))
    out = tl._moe_ffn(tp, torch.from_numpy(h), tcfg)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def test_moe_ffn_int8_grouped_matches_jax():
    """bf16 activations on int8 experts, grouped: both sides multiply the same
    bf16 ``_w`` values with fp32 sums and round at the same places; sums in
    another order can move a bf16 rounding by one ulp, which the next
    product carries, so 2^-5 relative plus 1e-2 absolute (outputs ~1)."""
    cfg = dataclasses.replace(JCFG, moe_impl="grouped")
    jq = jl.quantize_params(jl.init_params(cfg, jax.random.PRNGKey(2)))
    tq = bridge.params_from_numpy(_np(jq))
    jp, tp = _layer0(jq, tq)
    h = jnp.asarray(np.random.default_rng(3).standard_normal((1, 9, cfg.dim)), jnp.bfloat16)
    ref = np.asarray(jl._moe_ffn(jp, h, cfg).astype(jnp.float32))
    out = tl._moe_ffn(tp, bridge.tensor_from_numpy(np.asarray(h)),
                      tl.LlamaConfig(**dataclasses.asdict(cfg)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2.0 ** -5, atol=1e-2)


def test_grouped_ffn_matches_dense_dispatch():
    """JAX's own check (tests/test_moe_llama.py:198) on the port: the
    mixtral-test preset in fp32, 48 tokens."""
    cfg = dataclasses.replace(tl.PRESETS["mixtral-test"], moe_impl="dense")
    params = tl.init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32)
    p = tl.unstack_layers(params["layers"])[0]
    h = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 24, cfg.dim))
                         .astype(np.float32))
    dense = tl._moe_ffn(p, h, cfg)
    grouped = tl._moe_ffn(p, h, dataclasses.replace(cfg, moe_impl="grouped"))
    np.testing.assert_allclose(grouped.numpy(), dense.numpy(), rtol=2e-4, atol=2e-4)


def test_capacity_below_e_over_k_is_clamped_with_a_warning(trees):
    _, tp = _layer0(*trees)
    h = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 8, JCFG.dim))
                         .astype(np.float32))
    with pytest.warns(UserWarning, match="clamped capacity_factor 1.0"):
        low = tl._moe_ffn(tp, h, dataclasses.replace(TCFG, capacity_factor=1.0))
    assert torch.equal(low, tl._moe_ffn(tp, h, TCFG))  # drop-free either way


@pytest.mark.parametrize("impl", ["dense", "grouped"])
def test_prefill_agrees_with_per_token_decode(trees, impl):
    """JAX's :53 on the port: logits of the last of 12 tokens prefilled at
    once equal 11 prefilled then one decode step."""
    _, tp = trees
    cfg = dataclasses.replace(TCFG, moe_impl=impl)
    T = 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, T))
                            .astype(np.int32))
    pos = torch.arange(T, dtype=torch.int32)[None]
    cache = tl.init_kv_cache(cfg, 1, cfg.max_seq_len, dtype=torch.float32)
    full, _ = tl.forward(tp, cfg, toks, pos, cache)
    cache = tl.init_kv_cache(cfg, 1, cfg.max_seq_len, dtype=torch.float32)
    tl.forward(tp, cfg, toks[:, :-1], pos[:, :-1], cache)
    step, _ = tl.forward(tp, cfg, toks[:, -1:], pos[:, -1:], cache)
    np.testing.assert_allclose(full[:, -1].numpy(), step[:, 0].numpy(), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------- params


def test_moe_tree_shapes_quantization_and_param_count(trees):
    jp, tp = trees
    tinit = tl.init_params(TCFG, torch.Generator().manual_seed(0))
    fj, ft = bridge.flatten(_np(jp)), bridge.flatten(tinit)
    assert fj.keys() == ft.keys()
    for key in fj:
        assert tuple(ft[key].shape) == fj[key].shape, key
    n = sum(t.numel() for t in ft.values())
    assert n == tl.param_count(TCFG) == jl.param_count(JCFG)
    q = tl.quantize_params(tinit)["layers"]
    for k in ("moe_gate", "moe_up", "moe_down"):
        assert q[k]["q"].dtype == torch.int8 and q[k]["s"].shape[-2] == 1
    assert not isinstance(q["router"], dict)  # the router stays raw
    # and bit for bit what the JAX package's quantization gives
    jq = bridge.flatten(_np(jl.quantize_params(jp)))
    tq = bridge.flatten(tl.quantize_params(tp))
    assert jq.keys() == tq.keys()
    for key, a in jq.items():
        assert np.array_equal(np.asarray(a).view(np.uint8), tq[key].numpy().view(np.uint8)), key


def test_quantizing_init_equals_quantize_of_init():
    for preset in ("mixtral-test", "test-tiny"):
        cfg = dataclasses.replace(tl.PRESETS[preset], vocab_size=97)
        a = tl.init_params(cfg, torch.Generator().manual_seed(7), quant="int8")
        b = tl.quantize_params(tl.init_params(cfg, torch.Generator().manual_seed(7)))
        fa, fb = bridge.flatten(a), bridge.flatten(b)
        assert fa.keys() == fb.keys()
        for key in fa:
            assert fa[key].dtype == fb[key].dtype and torch.equal(fa[key], fb[key]), key


def test_bridge_carries_the_moe_leaves():
    """int8 {"q", "s"} leaves verbatim, bf16 leaves bit for bit."""
    jp = jl.init_params(JCFG, jax.random.PRNGKey(1))
    for tree in (jp, jl.quantize_params(jp)):
        flat = bridge.flatten(_np(tree))
        moved = bridge.flatten(bridge.params_from_numpy(_np(tree)))
        for key in [k for k in flat if "moe_" in k or "router" in k]:
            a, b = flat[key], moved[key]
            assert str(b.dtype).endswith(a.dtype.name), key
            assert np.array_equal(a.view(np.uint8),
                                  b.view(torch.uint8).numpy().reshape(a.view(np.uint8).shape))


# ---------------------------------------------------------------- engines

PROMPT = render_prompt("search for wireless headphones", {})
KW = dict(max_len=1024, prefill_buckets=(1024,))


def _mixtral(impl):
    return (dataclasses.replace(jl.PRESETS["mixtral-test"], moe_impl=impl),
            dataclasses.replace(tl.PRESETS["mixtral-test"], moe_impl=impl))


@pytest.fixture(scope="module")
def engine_weights():
    """The JAX mixtral-test engine's random init, in fp32."""
    eng = JEngine(preset="mixtral-test", kernels="pallas", **KW)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


@pytest.mark.parametrize("impl,ff", [("dense", 8), ("dense", 0), ("grouped", 8),
                                     ("grouped", 0)])
def test_mixtral_engine_matches_jax(engine_weights, impl, ff):
    jcfg, tcfg = _mixtral(impl)
    jeng = JEngine(cfg=jcfg, kernels="pallas", fast_forward=ff, init_weights=False, **KW)
    jeng.load_params(jax.device_put(engine_weights))
    teng = DecodeEngine(cfg=tcfg, fast_forward=ff, init_weights=False, device="cpu", **KW)
    teng.load_params(bridge.params_from_numpy(engine_weights))
    assert j_install(jeng) == install_prompt_prefix(teng) > 800
    jres = jeng.generate(PROMPT, max_new_tokens=32)
    ops.reset_launch_counts()
    tres = teng.generate(PROMPT, max_new_tokens=32)
    assert tres.token_ids == jres.token_ids
    assert (tres.steps, tres.finished, tres.error) == (jres.steps, jres.finished, jres.error)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)  # plain versions on the CPU


def test_mixtral_paged_grouped_batcher_matches_jax(engine_weights):
    jcfg, tcfg = _mixtral("grouped")
    kw = dict(max_len=2048, batch_slots=3, prefill_buckets=(128, 256, 512, 1024),
              fast_forward=8, init_weights=False)
    prompts = [render_prompt(t, {}) for t in ("search for laptops under 1000",
                                              "take a screenshot of this page")]
    jeng = JPaged(cfg=jcfg, kernels="pallas", **kw)
    jeng.load_params(jax.device_put(engine_weights))
    teng = PagedDecodeEngine(cfg=tcfg, device="cpu", **kw)
    teng.load_params(bridge.params_from_numpy(engine_weights))
    assert j_install(jeng) == install_prompt_prefix(teng) > 800
    jres = JBatcher(jeng, chunk_steps=16, max_new_tokens=24).generate_many(prompts)
    tres = ContinuousBatcher(teng, chunk_steps=16, max_new_tokens=24).generate_many(prompts)
    for j, t in zip(jres, tres):
        assert t.error is None and t.token_ids == j.token_ids
        assert (t.steps, t.finished, t.cached_tokens) == (j.steps, j.finished, j.cached_tokens)
    assert teng.allocator.blocks_in_use == len(teng._prefix_blocks) > 0
