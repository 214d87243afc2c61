"""The quantized KV tier at head dim 128 (``KV_QUANT=int8|int4`` on the
8B-class models: llama3-8b, llama3-70b, mixtral-8x7b) against the JAX
package's, on the same numpy inputs.

- K8 / K9 / K10: the port's plain versions against the JAX Pallas kernels
  (interpret mode) at 4 query heads and 1 kv head of 128, a few pool
  blocks, float32, at the JAX kernel test's tolerance ``rtol = atol = 2e-5``
  (the same dequantized values summed in another order);
- a ``test-tiny`` variant widened to head dim 128 (dim 256, 2 query heads
  and 1 kv head of 128): the quantized ``PagedDecodeEngine`` behind the
  batcher decodes what the JAX engine decodes, at every tier and at
  fast-forward 8 (K9) and 0 (K8);
- the boot gate: a quantized pool at hd 128 is built on the card's device
  object (``check_kv_quant_head_dim``), and the wrappers' own check takes
  hd 128.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kvquant import BITS, TIERS, TOL, _quantized, _t
from tpu_voice_agent.models import llama as jl
from tpu_voice_agent.ops import decode_attention_quant as j_decode_quant
from tpu_voice_agent.ops import paged_attention_quant as j_paged_quant
from tpu_voice_agent.ops import paged_block_attention_quant as j_paged_block_quant
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent_torch import bridge, ops
from tpu_voice_agent_torch.models import llama as tl
from tpu_voice_agent_torch.ops._lib import QUANT_HEAD_DIMS
from tpu_voice_agent_torch.ops.decode_attention import check_quant_cache
from tpu_voice_agent_torch.serve import paged
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.services.brain import install_prompt_prefix

HD = 128
NQ, NKV = 4, 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("tier", TIERS)
def test_paged_attention_quant_hd128_plain_matches_jax_kernel(tier):
    L, N, bs = 2, 6, 16
    kv, ks, vv, vs = _quantized((L, N, bs, NKV, HD), tier, 31)
    q = np.random.default_rng(32).standard_normal((3, NQ, HD)).astype(np.float32)
    tables = np.array([[3, 5, 1], [2, 4, 0], [1, 2, 3]], np.int32)
    kv_len = np.array([17, 48, 0], np.int32)  # a straddling row, a full one, an empty one
    for layer in (0, 1):
        ref = np.asarray(j_paged_quant(jnp.asarray(q), kv, vv, ks, vs, jnp.asarray(tables),
                                       jnp.asarray(kv_len), jnp.int32(layer), bits=BITS[tier]))
        out = ops.paged_attention_quant(_t(q), _t(kv), _t(vv), _t(ks), _t(vs), _t(tables),
                                        _t(kv_len), layer, bits=BITS[tier])
        assert out.shape == (3, NQ, HD)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
        assert bool((out[2] == 0).all()) and np.all(ref[2] == 0)


@pytest.mark.parametrize("tier", TIERS)
def test_paged_block_attention_quant_hd128_plain_matches_jax_kernel(tier):
    L, N, bs = 1, 6, 16
    kv, ks, vv, vs = _quantized((L, N, bs, NKV, HD), tier, 33)
    # a (3, 9) block, mixtral's fast-forward width: a straddling chain, an
    # unordered one with repeats, and an empty row
    q = np.random.default_rng(34).standard_normal((3, 9, NQ, HD)).astype(np.float32)
    tables = np.array([[3, 1, 5], [2, 4, 0], [1, 2, 3]], np.int32)
    q_pos = np.array([list(range(12, 21)), [30, 2, 30, 7, 7, 8, 9, 40, 41], [-1] * 9], np.int32)
    ref = np.asarray(j_paged_block_quant(jnp.asarray(q), kv, vv, ks, vs, jnp.asarray(tables),
                                         jnp.asarray(q_pos), jnp.int32(0), bits=BITS[tier]))
    out = ops.paged_block_attention_quant(_t(q), _t(kv), _t(vv), _t(ks), _t(vs), _t(tables),
                                          _t(q_pos), 0, bits=BITS[tier])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert bool((out[2] == 0).all()) and np.all(ref[2] == 0)


@pytest.mark.parametrize("tier", TIERS)
def test_decode_attention_quant_hd128_plain_matches_jax_kernel(tier):
    B, S = 3, 256
    kv, ks, vv, vs = _quantized((B, S, NKV, HD), tier, 35)
    q = np.random.default_rng(36).standard_normal((B, NQ, HD)).astype(np.float32)
    kv_len = np.array([1, 133, 256], np.int32)
    ref = np.asarray(j_decode_quant(jnp.asarray(q), kv, vv, ks, vs, jnp.asarray(kv_len),
                                    bits=BITS[tier], block_k=128))
    out = ops.decode_attention_quant(_t(q), _t(kv), _t(vv), _t(ks), _t(vs), _t(kv_len),
                                     bits=BITS[tier])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_hd128_is_a_built_quantized_width():
    """The card's kernels are built at hd 128, so the boot gate and the
    wrappers' operand check take it on a CUDA device object."""
    assert HD in QUANT_HEAD_DIMS
    for tier in TIERS:
        paged.check_kv_quant_head_dim(tier, HD, torch.device("cuda"))
        bits, hdp = BITS[tier], HD if tier == "int8" else HD // 2
        k = torch.zeros((1, 4, NKV, hdp), dtype=torch.int8)
        s = torch.zeros((1, 4, NKV), dtype=torch.bfloat16)
        check_quant_cache("k", k, k, s, s, HD, bits)


# ---------------------------------------------------------------- engine level

# test-tiny widened to head dim 128: 2 query heads and 1 kv head of 128
WIDE = dict(dim=256, n_heads=2, n_kv_heads=1)
KW = dict(max_len=1024, batch_slots=2, prefill_buckets=(1024,))
PROMPTS = [render_prompt("search for laptops under 1000", {}),
           render_prompt("take a screenshot of this page", {})]


@pytest.fixture(scope="module")
def wide():
    jcfg = dataclasses.replace(jl.PRESETS["test-tiny"], **WIDE)
    eng = JPaged(cfg=jcfg, kernels="pallas", init_weights=True, **KW)
    assert eng.cfg.head_dim == HD
    return eng.cfg, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("ff", [8, 0])
def test_hd128_quantized_paged_batcher_matches_jax(wide, tier, ff):
    """float32 weights at head dim 128, the few-shot prefix installed, two
    slots: greedy ids equal the JAX engine's (its Pallas K8 / K9 in
    interpret mode) at ff 8 (K9 on the chains) and ff 0 (K8)."""
    jcfg, weights = wide
    jeng = JPaged(cfg=jcfg, kernels="pallas", fast_forward=ff, kv_quant=tier,
                  init_weights=False, **KW)
    jeng.load_params(jax.device_put(weights))
    teng = PagedDecodeEngine(cfg=tl.LlamaConfig(**dataclasses.asdict(jcfg)), init_weights=False,
                             device="cpu", fast_forward=ff, kv_quant=tier, **KW)
    teng.load_params(bridge.params_from_numpy(weights))
    assert teng.cfg.head_dim == HD and teng.k_pool.shape[-1] == (HD if tier == "int8" else HD // 2)
    assert j_install(jeng) == install_prompt_prefix(teng) > 800
    jres = JBatcher(jeng, chunk_steps=16, max_new_tokens=32).generate_many(PROMPTS)
    tres = ContinuousBatcher(teng, chunk_steps=16, max_new_tokens=32).generate_many(PROMPTS)
    for j, t in zip(jres, tres):
        assert t.error is None and teng.fsm.walk(t.token_ids) >= 0
        assert t.token_ids == j.token_ids
        assert (t.steps, t.finished, t.cached_tokens) == (j.steps, j.finished, j.cached_tokens)
    assert teng.allocator.blocks_in_use == len(teng._prefix_blocks) > 0
