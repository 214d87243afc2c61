"""Pipeline parallelism of the port against the JAX package.

JAX's ``tests/test_pipeline.py`` forward and cached-decode cases on
``parallel/pipeline.py``: the same float32 weights (JAX's init, shared as
numpy) go through JAX's ``llama_pp_forward`` / ``llama_pp_forward_cached`` /
``pp_tp_forward_cached`` on its 8 virtual CPU devices and through the port's
on a one-process mesh of CPU devices, each held to the unsharded forward at
JAX's tolerance (atol / rtol 2e-4) and the greedy picks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models.llama import LlamaConfig as JConfig
from tpu_voice_agent.models.llama import init_params as j_init
from tpu_voice_agent.parallel import pipeline as jpipe
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.models.llama import LlamaConfig, forward, init_kv_cache
from tpu_voice_agent_torch.parallel.mesh import place_tree
from tpu_voice_agent_torch.parallel.pipeline import (
    init_pp_cache,
    init_pp_tp_cache,
    llama_pp_forward,
    llama_pp_forward_cached,
    pipeline_apply,
    pp_mesh,
    pp_tp_forward_cached,
    pp_tp_mesh,
    stage_param_shardings,
    stage_params,
    staged_tp_shardings,
)

CPU = torch.device("cpu")
TOL = dict(atol=2e-4, rtol=2e-4)
CFG = dict(vocab_size=128, dim=64, n_layers=8, n_heads=4, n_kv_heads=2, ffn_dim=128,
           max_seq_len=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jp = j_init(JConfig(**CFG), jax.random.PRNGKey(0), dtype=jnp.float32)
    tokens = np.random.default_rng(1).integers(0, 128, (4, 16)).astype(np.int32)
    return LlamaConfig(**CFG), jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp)), tokens


def _ref(cfg, params, tokens, max_len):
    B, T = tokens.shape
    cache = init_kv_cache(cfg, B, max_len, dtype=torch.float32)
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T).contiguous()
    logits, _ = forward(params, cfg, torch.from_numpy(tokens), pos, cache, fresh_block=True)
    return logits, cache, pos


class TestPipelineForward:
    @pytest.mark.parametrize("pp,n_micro", [(2, 2), (4, 2), (8, 4)])
    def test_matches_jax_and_single_device(self, setup, pp, n_micro):
        cfg, jp, tp_params, tokens = setup
        out = llama_pp_forward(tp_params, cfg, torch.from_numpy(tokens), pp_mesh(pp, [CPU] * pp),
                               n_micro=n_micro)
        jout = jpipe.llama_pp_forward(jp, JConfig(**CFG), jnp.asarray(tokens), jpipe.pp_mesh(pp),
                                      n_micro=n_micro)
        ref, _, _ = _ref(cfg, tp_params, tokens, tokens.shape[1])
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)

    def test_rejects_indivisible_layers(self, setup):
        cfg, jp, tp_params, _ = setup
        with pytest.raises(ValueError, match="stages") as e:
            stage_params(tp_params["layers"], 3)
        with pytest.raises(ValueError) as ej:
            jpipe.stage_params(jp["layers"], 3)
        assert str(e.value) == str(ej.value)

    def test_rejects_indivisible_batch(self, setup):
        cfg, _, tp_params, tokens = setup
        with pytest.raises(ValueError, match="microbatch"):
            llama_pp_forward(tp_params, cfg, torch.from_numpy(tokens), pp_mesh(2, [CPU] * 2),
                             n_micro=3)

    def test_pipeline_apply_runs_microbatches_in_stage_order(self):
        """GPipe on any stage function: stage s adds 10**s, the staged
        params carry s; every microbatch crosses every stage once."""
        S, n_micro = 3, 4
        staged = {"w": torch.arange(S, dtype=torch.float32)[:, None]}
        x = torch.zeros(n_micro, 2)
        out = pipeline_apply(staged, x, lambda p, x: x + 10.0 ** p["w"], pp_mesh(S, [CPU] * S))
        assert torch.equal(out, torch.full((n_micro, 2), 111.0))
        assert stage_param_shardings(None, staged) == {"w": ("pp", None, None)}


class TestPipelineCachedDecode:
    @pytest.mark.parametrize("pp", [2, 4])
    def test_prefill_plus_decode_matches_jax_and_single_device(self, setup, pp):
        cfg, jp, tp_params, tokens = setup
        jcfg, B, T, max_len = JConfig(**CFG), *tokens.shape, 32
        ref, ref_cache, pos = _ref(cfg, tp_params, tokens, max_len)
        m, jm = pp_mesh(pp, [CPU] * pp), jpipe.pp_mesh(pp)
        cache = init_pp_cache(cfg, m, B, max_len, dtype=torch.float32)
        jcache = jpipe.init_pp_cache(jcfg, jm, B, max_len, dtype=jnp.float32)
        out, _ = llama_pp_forward_cached(tp_params, cache, cfg, torch.from_numpy(tokens), pos, m)
        jout, jcache = jpipe.llama_pp_forward_cached(jp, jcache, jcfg, jnp.asarray(tokens),
                                                     jnp.asarray(pos.numpy()), jm)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        cur_ref = ref[:, -1].argmax(-1).to(torch.int32)
        cur = out[:, -1].argmax(-1).to(torch.int32)
        for step in range(3):
            p = torch.full((B, 1), T + step, dtype=torch.int32)
            ref, _ = forward(tp_params, cfg, cur_ref[:, None], p, ref_cache)
            out, _ = llama_pp_forward_cached(tp_params, cache, cfg, cur[:, None], p, m)
            jout, jcache = jpipe.llama_pp_forward_cached(
                jp, jcache, jcfg, jnp.asarray(cur.numpy()[:, None]), jnp.asarray(p.numpy()), jm)
            np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
            cur_ref = ref[:, -1].argmax(-1).to(torch.int32)
            cur = out[:, -1].argmax(-1).to(torch.int32)
            assert torch.equal(cur, cur_ref)
        np.testing.assert_allclose(
            cache["k"].full().numpy().reshape(np.asarray(ref_cache["k"]).shape),
            ref_cache["k"].numpy(), **TOL)

    def test_cache_rejects_indivisible_layers(self, setup):
        cfg = setup[0]
        with pytest.raises(ValueError, match="stages"):
            init_pp_cache(cfg, pp_mesh(3, [CPU] * 3), 2, 16)


@pytest.mark.parametrize("pp,tp", [(2, 2), (4, 2), (2, 1)])
def test_pp_tp_forward_cached_matches_jax_and_single_device(setup, pp, tp):
    """The servable pp x tp forward: a prefill and a T = 1 step against JAX's
    ``pp_tp_forward_cached`` and the unsharded forward (2e-4)."""
    cfg, jp, tp_params, tokens = setup
    jcfg, B, T, max_len = JConfig(**CFG), *tokens.shape, 32
    m, jm = pp_tp_mesh(pp, tp, [CPU] * (pp * tp)), jpipe.pp_tp_mesh(pp, tp)
    staged = stage_params(tp_params["layers"], pp)
    params = {**{k: tp_params[k] for k in ("embed", "final_norm", "lm_head")},
              "staged": place_tree(staged, m, staged_tp_shardings(m, staged))}
    jstaged = jpipe.stage_params(jp["layers"], pp)
    jparams = {**{k: jp[k] for k in ("embed", "final_norm", "lm_head")},
               "staged": jax.device_put(jstaged, jpipe.staged_tp_shardings(jm, jstaged))}
    ref, ref_cache, pos = _ref(cfg, tp_params, tokens, max_len)
    cache = init_pp_tp_cache(cfg, m, B, max_len, dtype=torch.float32)
    jcache = jpipe.init_pp_tp_cache(jcfg, jm, B, max_len, dtype=jnp.float32)
    steps = [(torch.from_numpy(tokens), pos)]
    cur = ref[:, -1].argmax(-1).to(torch.int32)[:, None]
    steps.append((cur, torch.full((B, 1), T, dtype=torch.int32)))
    for i, (tok, p) in enumerate(steps):
        out, _ = pp_tp_forward_cached(params, cache, cfg, tok, p, m)
        jout, jcache = jpipe.llama_pp_tp_forward_cached(jparams, jcache, jcfg,
                                                        jnp.asarray(tok.numpy()),
                                                        jnp.asarray(p.numpy()), jm)
        if i:
            ref, _ = forward(tp_params, cfg, tok, p, ref_cache)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    with pytest.raises(ValueError, match="dense-model only"):
        pp_tp_forward_cached(params, cache, LlamaConfig(**CFG, n_experts=2), tok, p, m)
