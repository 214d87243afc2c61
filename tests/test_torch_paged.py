"""The port's paged attention (K6, K7) and ``forward_paged`` against the JAX
package's, on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode; the port's wrappers
run their plain versions on CPU tensors. Everything is float32, so the
tolerance is the float32 one: ``rtol = atol = 1e-5`` (the same arithmetic
summed in other orders). The pools of the forward test are float32 too, so
the written k/v are compared at that tolerance as well; which pool slots a
step writes is compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models import llama as jl
from tpu_voice_agent.ops import paged_attention as j_paged
from tpu_voice_agent.ops import paged_block_attention as j_paged_block
from tpu_voice_agent_torch import bridge, ops
from tpu_voice_agent_torch.models import llama as tl

TOL = dict(rtol=1e-5, atol=1e-5)
L, N, BS, NQ, NKV, HD = 2, 12, 16, 8, 4, 32
# rows own disjoint, deliberately out-of-order blocks
TABLES = np.array([[3, 7, 1, 0], [5, 2, 9, 4], [11, 6, 8, 10]], np.int32)


def _pools(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((L, N, BS, NKV, HD)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("layer", [0, 1])
def test_paged_attention_plain_matches_jax_kernel(layer):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, NQ, HD)).astype(np.float32)
    kp, vp = _pools(1)
    tables = np.concatenate([TABLES, TABLES[:1]])
    kv_len = np.array([5, 40, 64, 0], np.int32)  # the last row reads no key
    ref = np.asarray(j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(tables), jnp.asarray(kv_len), jnp.int32(layer)))
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, kv_len)]
    ops.reset_launch_counts()
    out = ops.paged_attention(*t, layer)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert bool((out[3] == 0).all()) and np.all(ref[3] == 0)  # the l == 0 guard: zeros
    assert ops.launch_counts()["paged_attention"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("layer", [0, 1])
def test_paged_block_attention_plain_matches_jax_kernel(layer):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((4, 9, NQ, HD)).astype(np.float32)
    kp, vp = _pools(3)
    tables = np.concatenate([TABLES, TABLES[2:]])
    # a padded chain step, an unordered block with repeats, a block that
    # straddles two pool blocks, and a row whose every position is negative
    q_pos = np.array([[5, 6, 7, 7, 7, 7, 7, 7, 7],
                      [40, 2, 33, 33, 0, 63, 13, 21, 22],
                      [27, 28, 29, 30, 31, 32, 33, 34, 35],
                      [-1] * 9], np.int32)
    ref = np.asarray(j_paged_block(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(tables), jnp.asarray(q_pos), jnp.int32(layer)))
    out = ops.paged_block_attention(*[torch.from_numpy(a) for a in (q, kp, vp, tables, q_pos)],
                                    layer)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert bool((out[3] == 0).all()) and np.all(ref[3] == 0)


# ---------------------------------------------------------------- forward_paged


def _cfg():
    cfg = dataclasses.replace(jl.PRESETS["test-tiny"], vocab_size=97)
    return cfg, tl.LlamaConfig(**dataclasses.asdict(cfg))


def test_forward_paged_matches_jax():
    """Three rows through every branch: a fresh (3, 20) prefill (K1), a
    gathered (3, 24) suffix, a (3, 9) fast-forward block (K7) with row 1
    parked, and a T=1 step (K6) with row 2 parked. Logits and the pool
    after each write agree; parked rows write only the trash block."""
    jcfg, tcfg = _cfg()
    params = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    Lc, bs, nkv, hd = jcfg.n_layers, 16, jcfg.n_kv_heads, jcfg.head_dim
    shape = (Lc, 16, bs, nkv, hd)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tables = np.array([[3, 7, 1, 12], [5, 2, 9, 4], [11, 6, 8, 10]], np.int32)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 97, size=(3, 54)).astype(np.int32)
    ar = np.broadcast_to(np.arange(54, dtype=np.int32), (3, 54))
    ff_pos = np.array([[44, 45, 46, 47, 48, 48, 48, 48, 48]] * 3, np.int32)
    steps = [  # tokens, positions, fresh, write_mask, gather_blocks
        (ids[:, :20], ar[:, :20], True, None, None),
        (ids[:, 20:44], ar[:, 20:44], False, None, 4),
        (np.take_along_axis(ids, ff_pos, 1), ff_pos, False, [True, False, True], None),
        (ids[:, 49:50], np.array([[49], [0], [0]], np.int32), False, [True, True, False], None),
    ]
    for tokens, positions, fresh, mask, gb in steps:
        before = tk.clone()
        wm = None if mask is None else np.array(mask)
        jlog, jk, jv, _, _ = jl.forward_paged(
            params, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jk, jv,
            jnp.asarray(tables), attn_impl="xla" if gb else "pallas",
            write_mask=None if wm is None else jnp.asarray(wm), fresh_block=fresh,
            gather_blocks=gb)
        tlog = tl.forward_paged(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(np.ascontiguousarray(positions)),
            tk, tv, torch.from_numpy(tables), attn_impl="torch" if gb else "kernels",
            write_mask=None if wm is None else torch.from_numpy(wm), fresh_block=fresh,
            gather_blocks=gb)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        # block 0 is the trash block: parked writes of several rows race there
        for pj, pt in ((jk, tk), (jv, tv)):
            a, b = np.asarray(pj)[:, 1:], pt.numpy()[:, 1:]
            np.testing.assert_array_equal(a != 0, b != 0)
            np.testing.assert_allclose(b, a, **TOL)
        if wm is not None:
            for row in np.flatnonzero(~wm):  # a parked row's own blocks are untouched
                own = torch.from_numpy(tables[row]).long()
                assert torch.equal(tk[:, own], before[:, own])
            assert bool((tk[:, 0] != 0).any())  # ... and its writes went to block 0
