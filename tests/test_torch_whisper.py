"""The port's Whisper model against the JAX package's, on the same weights.

``whisper-test`` widths (d 64, 4 heads of 16, 2 + 2 layers, 200 mel frames,
the in-tree 619-token vocabulary), weights from ``jax.random`` at a seed
carried over by ``bridge``, inputs from numpy seeds. The port's kernel path
(K1 and K5 as their plain versions on the CPU) is held against the JAX
package's Pallas path (interpret mode), and its plain path against the XLA
path.

Tolerance: ``max|port - jax| <= rel * max|jax|`` with rel 1e-4 in float32
(sums taken in another order, GELU and softmax from other libraries) and
2e-2 in bfloat16 (intermediates rounded to bf16 at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models import whisper as jw
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.models import whisper as tw

CFG = dataclasses.replace(jw.PRESETS["whisper-test"], vocab_size=619)
TCFG = tw.WhisperConfig(**dataclasses.asdict(CFG))
REL = {"f32": 1e-4, "bf16": 2e-2}
IMPLS = [("pallas", "kernels"), ("xla", "torch")]


def _close(j, t, rel):
    j = np.asarray(jnp.asarray(j, jnp.float32))
    t = t.float().numpy()
    assert j.shape == t.shape
    err, scale = float(np.abs(t - j).max()), float(np.abs(j).max())
    assert err <= rel * scale, f"max|d| {err} > {rel} * {scale}"


@pytest.fixture(scope="module", params=["f32", "bf16"])
def weights(request):
    dtype = jnp.float32 if request.param == "f32" else jnp.bfloat16
    jparams = jw.init_params(CFG, jax.random.PRNGKey(0), dtype=dtype)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return request.param, jparams, tparams


def _mel(T, seed=0):
    return np.random.default_rng(seed).standard_normal((1, T, CFG.n_mels)).astype(np.float32)


def test_config_presets_and_param_count_match():
    for name, cfg in jw.PRESETS.items():
        assert dataclasses.asdict(tw.PRESETS[name]) == dataclasses.asdict(cfg)
        assert tw.param_count(tw.PRESETS[name]) == jw.param_count(cfg)
    big = tw.PRESETS["whisper-large-v3"]
    assert (big.head_dim, big.ffn_dim, big.enc_positions) == (64, 5120, 1500)
    np.testing.assert_array_equal(tw._sinusoid_pos(1500, 1280), jw._sinusoid_pos(1500, 1280))


def test_bridge_carries_the_whisper_tree(weights):
    _, jparams, tparams = weights
    flat_j = bridge.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    flat_t = bridge.flatten(tparams)
    assert sorted(flat_j) == sorted(flat_t)
    for k, a in flat_j.items():
        t = flat_t[k]
        assert tuple(t.shape) == a.shape and str(t.dtype).endswith(str(a.dtype))
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))
    # init_params builds the same tree shape with torch's generator
    ours = tw.init_params(TCFG, torch.Generator().manual_seed(0), dtype=tparams[
        "decoder"]["tok_emb"].dtype)
    assert {k: tuple(v.shape) for k, v in bridge.flatten(ours).items()} == {
        k: tuple(v.shape) for k, v in flat_t.items()}


@pytest.mark.parametrize("T,pos_offset", [(200, None), (70, 10), (71, None), (70, 90)])
@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_encoder_forward_matches(weights, T, pos_offset, jimpl, timpl):
    """The two buckets' shape, an incremental block at its offset, an odd
    frame count (SAME pads conv2 (1, 1) there) and an offset past the table's
    end (clamped as dynamic_slice does)."""
    name, jparams, tparams = weights
    mel = _mel(T, seed=T)
    off = None if pos_offset is None else jnp.int32(pos_offset)
    out_j = jw.encoder_forward(jparams, CFG, jnp.asarray(mel), attn_impl=jimpl, pos_offset=off)
    out_t = tw.encoder_forward(tparams, TCFG, torch.from_numpy(mel), attn_impl=timpl,
                               pos_offset=pos_offset)
    _close(out_j, out_t, REL[name])


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_cross_kv_and_decoder_steps_match(weights, jimpl, timpl):
    """A 3-token prompt step (plain attention in both packages), then three
    T = 1 steps (JAX's Pallas decode_attention / the port's K5 on the kernel
    path) over a 60-of-100 prefix of valid encoder frames; logits at every
    step and the written self cache."""
    name, jparams, tparams = weights
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((1, 100, CFG.d_model)).astype(np.float32)
    enc_j = jnp.asarray(enc, jparams["decoder"]["tok_emb"].dtype)
    enc_t = torch.from_numpy(enc).to(tparams["decoder"]["tok_emb"].dtype)
    ckv_j = jw.compute_cross_kv(jparams, CFG, enc_j)
    ckv_t = tw.compute_cross_kv(tparams, TCFG, enc_t)
    for key in ("k", "v"):
        _close(ckv_j[key], ckv_t[key], REL[name])
    assert tuple(ckv_t["k"].shape) == (2, 1, 100, 4, 16)

    enc_mask = np.arange(100)[None, :] < 60
    enc_len = torch.tensor([60], dtype=torch.int32)
    cache_j = jw.init_self_cache(CFG, 1, dtype=enc_j.dtype)
    cache_t = tw.init_self_cache(TCFG, 1, dtype=enc_t.dtype)
    toks = [[1, 17, 300], [42], [7], [618]]
    p = 0
    for step in toks:
        tok = np.array([step], np.int32)
        pos = np.arange(p, p + len(step), dtype=np.int32)[None]
        p += len(step)
        lj, cache_j = jw.decoder_forward(jparams, CFG, jnp.asarray(tok), jnp.asarray(pos),
                                         cache_j, ckv_j, jnp.asarray(enc_mask), attn_impl=jimpl)
        lt, cache_t = tw.decoder_forward(tparams, TCFG, torch.from_numpy(tok),
                                         torch.from_numpy(pos), cache_t, ckv_t, enc_len,
                                         attn_impl=timpl)
        assert lt.dtype == torch.float32
        _close(lj, lt, REL[name])
    for key in ("k", "v"):
        _close(cache_j[key], cache_t[key], REL[name])
