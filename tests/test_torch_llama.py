"""``models.llama.forward`` of the port against the JAX package's, on one set
of weights (test-tiny, moved across with ``bridge``).

One sequence walks every branch of the forward's split: a fresh prefill block
at position 0 (K1), a 24-token suffix block after it (the plain cache
attention), a 9-token fast-forward block padded with duplicates (K3) and a
T=1 step (K2). The JAX side runs its Pallas kernels in interpret mode; the
port's wrappers run their plain versions on CPU tensors.

Tolerances on the logits: float32 1e-5 (the same arithmetic, summed in other
orders); bfloat16 and int8 6e-2, because a bf16 product in PyTorch rounds its
output to bf16 where XLA keeps it in float32 (``preferred_element_type``), a
difference of up to 2^-8 relative at every projection of both layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models import llama as jl
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.models import llama as tl

TOL = {"fp32": 1e-5, "bf16": 6e-2, "int8": 6e-2}
S = 64  # the JAX decode kernels want a cache length divisible by 32


def _cfg(hd=32):
    base = jl.PRESETS["test-tiny"]
    cfg = dataclasses.replace(base, vocab_size=97, n_heads=128 // hd, n_kv_heads=64 // hd)
    return cfg, tl.LlamaConfig(**dataclasses.asdict(cfg))


def _trees(cfg, precision):
    dtype = jnp.float32 if precision == "fp32" else jnp.bfloat16
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=dtype)
    if precision == "int8":
        params = jl.quantize_params(params)
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return params, bridge.params_from_numpy(np_tree)


def _steps():
    """(tokens, positions, fresh) blocks: prefill, suffix, ff block, T=1."""
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 97, size=(1, 54)).astype(np.int32)
    ar = np.arange(54, dtype=np.int32)[None]
    ff_pos = np.array([[44, 45, 46, 47, 48, 48, 48, 48, 48]], np.int32)
    return [(ids[:, :20], ar[:, :20], True),
            (ids[:, 20:44], ar[:, 20:44], False),
            (np.take_along_axis(ids, ff_pos, 1), ff_pos, False),
            (ids[:, 49:50], ar[:, 49:50], False)]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_forward_matches_jax(precision):
    jcfg, tcfg = _cfg()
    jp, tp = _trees(jcfg, precision)
    cache_dt = jnp.float32 if precision == "fp32" else jnp.bfloat16
    jcache = jl.init_kv_cache(jcfg, 1, S, dtype=cache_dt)
    tcache = tl.init_kv_cache(tcfg, 1, S, dtype=torch.float32 if precision == "fp32"
                              else torch.bfloat16)
    for tokens, positions, fresh in _steps():
        jlog, jcache = jl.forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jcache,
                                  attn_impl="pallas", fresh_block=fresh)
        tlog, tcache = tl.forward(tp, tcfg, torch.from_numpy(tokens),
                                  torch.from_numpy(positions), tcache, fresh_block=fresh)
        assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape
        err = np.abs(np.asarray(jlog) - tlog.numpy()).max()
        assert err <= TOL[precision], (precision, tokens.shape, err)
    # the caches agree too: every write landed in the same slot, with the
    # values the logits' tolerance allows (2x for bf16: a k entry of the
    # second layer carries the first layer's rounding)
    jk, tk = np.asarray(jcache["k"], np.float32), tcache["k"].float().numpy()
    np.testing.assert_array_equal(jk != 0, tk != 0)
    assert np.abs(jk - tk).max() <= TOL[precision] * (1 if precision == "fp32" else 2)


def test_forward_hd48_plain_path_matches_jax():
    """Head dim 48 (the distilled checkpoint's), through the torch-only
    branch the JAX package calls "xla"."""
    jcfg = dataclasses.replace(jl.PRESETS["test-tiny"], vocab_size=97, dim=192, n_heads=4,
                               n_kv_heads=2)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    jp, tp = _trees(jcfg, "fp32")
    jcache = jl.init_kv_cache(jcfg, 1, S, dtype=jnp.float32)
    tcache = tl.init_kv_cache(tcfg, 1, S, dtype=torch.float32)
    for tokens, positions, fresh in _steps():
        jlog, jcache = jl.forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jcache)
        tlog, tcache = tl.forward(tp, tcfg, torch.from_numpy(tokens),
                                  torch.from_numpy(positions), tcache, attn_impl="torch")
        assert np.abs(np.asarray(jlog) - tlog.numpy()).max() <= TOL["fp32"]


def test_quantize_is_bit_identical():
    jcfg, _ = _cfg()
    params = jl.init_params(jcfg, jax.random.PRNGKey(1))
    jq = jax.tree_util.tree_map(np.asarray, jl.quantize_params(params))
    tq = tl.quantize_params(bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    flat_j, flat_t = bridge.flatten(jq), bridge.flatten(tq)
    assert flat_j.keys() == flat_t.keys()
    for key, a in flat_j.items():
        b = flat_t[key]
        if key.endswith("/q"):
            assert b.dtype == torch.int8
            np.testing.assert_array_equal(a, b.numpy())
        elif key.endswith("/s"):
            assert b.dtype == torch.float32
            assert np.array_equal(a.view(np.int32), b.numpy().view(np.int32)), key


def test_init_params_shapes_and_dtypes_match():
    jcfg, tcfg = _cfg()
    jp = jax.tree_util.tree_map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tl.init_params(tcfg, torch.Generator().manual_seed(0))
    fj, ft = bridge.flatten(jp), bridge.flatten(tp)
    assert fj.keys() == ft.keys()
    for key in fj:
        assert tuple(ft[key].shape) == fj[key].shape and ft[key].dtype == torch.bfloat16, key
        # same scale: fan-in ** -0.5 (ones for the norms)
        assert abs(float(ft[key].float().std()) - float(fj[key].astype(np.float32).std())) < 0.02
