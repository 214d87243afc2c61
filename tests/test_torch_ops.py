"""The PyTorch port's kernels (K1-K4) against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
the plain versions against the Pallas kernels in interpret mode (as
tests/test_ops.py runs them) and against the JAX ``*_reference`` twins, on
the same numpy inputs. ``tests/test_torch_gpu.py`` holds the CUDA kernels
against the plain versions on the card.

Tolerances: float32 1e-5 absolute (the blockwise online softmax and the
one-shot softmax sum in different orders); bfloat16 2^-6 * |ref| + 1e-4,
element by element (each side rounds an fp32 result to bf16, at most one ulp
<= 2^-7 |x| each, on top of that reassociation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent import ops as jops
from tpu_voice_agent.ops.decode_attention import (
    decode_block_attention_reference as j_block_ref,
)
from tpu_voice_agent.ops.grammar_mask import (
    masked_argmax_advance_reference as j_advance_ref,
)
from tpu_voice_agent_torch import ops
from tpu_voice_agent_torch.ops import _lib

F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-4


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(a, dtype):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    t = torch.from_numpy(a)
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), t.to(torch.bfloat16)
    return jnp.asarray(a), t


def _close(j, t, tol, rtol=0.0):
    """|t - j| <= tol + rtol * |j|, element by element."""
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=rtol)


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("hd", [32, 48])
@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 27), (False, None)])
def test_flash_attention_matches_pallas(hd, causal, kv_len):
    rng = np.random.default_rng(0)
    B, T, S, nq, nkv = 2, 40, 40, 4, 2  # 40: ragged against 16-wide tiles
    q, k, v = (_pair(_np(rng, B, n, h, hd), "f32") for n, h in ((T, nq), (S, nkv), (S, nkv)))
    out_j = jops.flash_attention(q[0], k[0], v[0], causal=causal, kv_len=kv_len,
                                 block_q=16, block_k=16)
    out_t = ops.flash_attention(q[1], k[1], v[1], causal=causal, kv_len=kv_len)
    _close(out_j, out_t, F32_TOL)
    assert ops.flash_attention.launches == 0  # CPU tensors never launch


def test_flash_attention_bf16_matches_pallas():
    rng = np.random.default_rng(1)
    q, k, v = (_pair(_np(rng, 1, 64, h, 64), "bf16") for h in (8, 2, 2))
    out_j = jops.flash_attention(q[0], k[0], v[0], causal=True, block_q=32, block_k=32)
    out_t = ops.flash_attention(q[1], k[1], v[1], causal=True)
    assert out_t.dtype == torch.bfloat16
    _close(out_j, out_t, BF16_ATOL, BF16_RTOL)


# ---------------------------------------------------------------- K2


@pytest.mark.parametrize("hd", [32, 48])
def test_decode_attention_layer_matches_pallas(hd):
    rng = np.random.default_rng(2)
    L, B, S, nq, nkv, li = 3, 3, 96, 4, 2, 1
    kc, vc = (_pair(_np(rng, L, B, S, nkv, hd), "f32") for _ in range(2))
    q = _pair(_np(rng, B, nq, hd), "f32")
    kv_len = np.array([1, 45, 96], np.int32)  # ragged frontiers, down to one key
    out_j = jops.decode_attention_layer(q[0], kc[0], vc[0], jnp.asarray(kv_len),
                                        jnp.int32(li), block_k=32)
    out_t = ops.decode_attention_layer(q[1], kc[1], vc[1], torch.from_numpy(kv_len), li)
    _close(out_j, out_t, F32_TOL)
    # and the JAX twin on the flat plane cache[li]
    ref = jops.decode_attention_reference(q[0], kc[0][li], vc[0][li], jnp.asarray(kv_len))
    _close(ref, out_t, F32_TOL)


# ---------------------------------------------------------------- K5


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd,nq,nkv", [(16, 4, 4), (64, 4, 2), (64, 20, 20)])
def test_decode_attention_matches_pallas(dtype, hd, nq, nkv):
    """The flat cache: S = 300 (the JAX wrapper pads it to its 256-key
    block), kv_len 0 (zeros, as the kernel's ``acc / (l or 1)``), 1, ragged
    and S; MHA at the in-repo Whisper checkpoints' head dim 16, GQA at 64;
    and whisper-large-v3's 20 heads of 64 over its 500 encoder frames, at
    the decoder's self-attention length 33 and the full cross-attention."""
    rng = np.random.default_rng(hd + nkv)
    B, S = 4, (500 if nq == 20 else 300)
    kc, vc = (_pair(_np(rng, B, S, nkv, hd), dtype) for _ in range(2))
    q = _pair(_np(rng, B, nq, hd), dtype)
    kv_len = np.array([0, 33 if nq == 20 else 1, 137, S], np.int32)
    out_j = jops.decode_attention(q[0], kc[0], vc[0], jnp.asarray(kv_len))
    out_t = ops.decode_attention(q[1], kc[1], vc[1], torch.from_numpy(kv_len))
    assert out_t.dtype == q[1].dtype and bool((out_t[0] == 0).all())
    if dtype == "f32":
        _close(out_j, out_t, F32_TOL)
    else:
        _close(out_j, out_t, BF16_ATOL, BF16_RTOL)
    assert ops.decode_attention.launches == 0


# ---------------------------------------------------------------- K3


@pytest.mark.parametrize("hd", [32, 48])
def test_decode_block_attention_layer_matches_pallas(hd):
    rng = np.random.default_rng(3)
    L, B, S, nq, nkv, li = 2, 2, 64, 4, 2, 1
    kc, vc = (_pair(_np(rng, L, B, S, nkv, hd), "f32") for _ in range(2))
    q = _pair(_np(rng, B, 9, nq, hd), "f32")
    # row 0: a chain_block step padded with duplicates; row 1: unordered
    pos = np.array([[20, 21, 22, 23, 23, 23, 23, 23, 23],
                    [40, 3, 57, 12, 57, 0, 33, 8, 41]], np.int32)
    out_j = jops.decode_block_attention_layer(q[0], kc[0], vc[0], jnp.asarray(pos),
                                              jnp.int32(li), block_k=32)
    out_t = ops.decode_block_attention_layer(q[1], kc[1], vc[1], torch.from_numpy(pos), li)
    _close(out_j, out_t, F32_TOL)
    ref = j_block_ref(q[0], kc[0][li], vc[0][li], jnp.asarray(pos))
    _close(ref, out_t, F32_TOL)


def test_decode_block_attention_bf16_matches_pallas():
    rng = np.random.default_rng(4)
    kc, vc = (_pair(_np(rng, 2, 1, 128, 2, 64), "bf16") for _ in range(2))
    q = _pair(_np(rng, 1, 9, 16, 64), "bf16")
    pos = np.array([[70, 71, 72, 73, 74, 74, 74, 74, 74]], np.int32)
    out_j = jops.decode_block_attention_layer(q[0], kc[0], vc[0], jnp.asarray(pos),
                                              jnp.int32(0), block_k=32)
    out_t = ops.decode_block_attention_layer(q[1], kc[1], vc[1], torch.from_numpy(pos), 0)
    _close(out_j, out_t, BF16_ATOL, BF16_RTOL)


# ---------------------------------------------------------------- K4


def _grammar_case(seed=5, B=6, S=40, V=300, C=24):
    rng = np.random.default_rng(seed)
    mask = rng.random((S, V)) < 0.3
    mask[7] = False  # an all-masked state
    table = rng.integers(-1, S, size=(S, C)).astype(np.int32)
    col_id = rng.integers(0, C, size=(V,)).astype(np.int32)
    logits = _np(rng, B, V)
    logits[1, :] = 0.5  # ties: the first legal index wins
    state = np.array([0, 3, 7, -1, 39, 12], np.int32)[:B]  # all-masked, negative
    return logits, state, mask, table, col_id


def test_masked_argmax_advance_matches_pallas():
    case = _grammar_case()
    j_args = [jnp.asarray(a) for a in case]
    t_args = [torch.from_numpy(np.ascontiguousarray(a)) for a in case]
    tok_j, nxt_j = jops.masked_argmax_advance(*j_args)
    tok_r, nxt_r = j_advance_ref(*j_args)
    tok_t, nxt_t = ops.masked_argmax_advance(*t_args)
    for j in (tok_j, tok_r):
        np.testing.assert_array_equal(np.asarray(j), tok_t.numpy())
    for j in (nxt_j, nxt_r):
        np.testing.assert_array_equal(np.asarray(j), nxt_t.numpy())
    logits, state, mask, table, col_id = case
    assert tok_t[2] == 0 and nxt_t[2] == table[7, col_id[0]]  # all-masked row
    assert tok_t[3] == np.argmax(np.where(mask[0], logits[3], -1e30))  # state -1 -> 0
    assert tok_t[1] == np.flatnonzero(mask[3])[0]  # tie -> first legal index


def test_masked_argmax_advance_nan_row_does_not_fault():
    logits, state, mask, table, col_id = _grammar_case()
    logits[0, :] = np.nan
    tok, nxt = ops.masked_argmax_advance(*(torch.from_numpy(np.ascontiguousarray(a))
                                           for a in (logits, state, mask, table, col_id)))
    assert 0 <= int(tok[0]) < logits.shape[1]
    np.testing.assert_array_equal(
        tok[1:].numpy(), np.asarray(j_advance_ref(*(jnp.asarray(a) for a in (
            logits[1:], state[1:], mask, table, col_id))))[0])


# ---------------------------------------------------------------- build


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails is an error, never a fallback."""
    monkeypatch.setenv("NVCC", "/bin/false")
    monkeypatch.setenv("TPU_VOICE_CACHE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _lib.build()


def test_launch_counters_reset():
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
