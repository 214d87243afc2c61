"""The ring prefill and the long-session planner, against the JAX package.

JAX's ``tests/test_longctx.py`` cases on the port (``parallel/longctx.py``,
``serve/planner.py``) with the same fp32 weights (``bridge``): the sp
prefill at sp 4 against JAX's ``llama_sp_prefill`` and the port's dense
``forward`` (2e-4), padded rows, ``sp_pad_len``; and the planner's cold start,
warm extend, re-anchor, frontier refusal and ``plan_many``, token for token
against JAX's planner at sp 1 and sp 4 (JAX on its virtual CPU devices, the
port on a mesh of CPU devices).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models.llama import LlamaConfig as JConfig
from tpu_voice_agent.models.llama import init_params as j_init
from tpu_voice_agent.parallel.longctx import llama_sp_prefill as j_prefill
from tpu_voice_agent.parallel.ring import sp_mesh as j_mesh
from tpu_voice_agent.serve.planner import LongSessionPlanner as JPlanner
from tpu_voice_agent_torch.bridge import params_from_numpy
from tpu_voice_agent_torch.models.llama import LlamaConfig, forward, init_kv_cache
from tpu_voice_agent_torch.parallel import llama_sp_prefill, sp_mesh, sp_pad_len
from tpu_voice_agent_torch.serve.planner import LongSessionPlanner

CFG_KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
              max_seq_len=128)
CFG = LlamaConfig(**CFG_KW)
CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: intra-op threads buy nothing under the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JConfig(**CFG_KW), jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.device_get(jp))


def _dense(tparams, tokens):
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    cache = init_kv_cache(CFG, B, T, dtype=torch.float32)
    return forward(tparams, CFG, tokens, positions, cache, attn_impl="torch")


def test_sp_prefill_matches_jax_and_the_dense_forward(weights):
    jp, tp = weights
    B, T = 2, 64
    tok = np.random.default_rng(0).integers(0, CFG.vocab_size, (B, T)).astype(np.int32)
    last = np.full((B,), T - 1, np.int32)
    j_logits, j_cache = j_prefill(jp, JConfig(**CFG_KW), jnp.asarray(tok), j_mesh(4),
                                  jnp.asarray(last))
    t_logits, t_cache = llama_sp_prefill(tp, CFG, torch.from_numpy(tok),
                                         sp_mesh(4, [CPU] * 4), torch.from_numpy(last))
    ref_logits, ref_cache = _dense(tp, torch.from_numpy(tok))
    assert t_logits.shape == (B, CFG.vocab_size) and t_cache["k"].shape == (2, B, T, 2, 16)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(t_logits.numpy(), ref_logits[:, -1].numpy(), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[name].numpy(), np.asarray(j_cache[name]), **TOL)
        np.testing.assert_allclose(t_cache[name].numpy(), ref_cache[name].numpy(), **TOL)


def test_sp_prefill_padded_rows(weights):
    """Rows shorter than the bucket: ``last_index`` picks each row's own
    frontier logits."""
    _, tp = weights
    B, T, n = 2, 64, [50, 37]
    rng = np.random.default_rng(1)
    tok = np.zeros((B, T), dtype=np.int32)
    for b in range(B):
        tok[b, : n[b]] = rng.integers(1, CFG.vocab_size, n[b])
    ref_logits, _ = _dense(tp, torch.from_numpy(tok))
    sp_logits, _ = llama_sp_prefill(tp, CFG, torch.from_numpy(tok), sp_mesh(4, [CPU] * 4),
                                    torch.tensor([x - 1 for x in n]))
    for b in range(B):
        np.testing.assert_allclose(sp_logits[b].numpy(), ref_logits[b, n[b] - 1].numpy(),
                                   **TOL)


def test_sp_pad_len():
    assert sp_pad_len(1, 4) == 4
    assert sp_pad_len(64, 4) == 64
    assert sp_pad_len(65, 4) == 68
    assert sp_pad_len(10, 4, multiple=8) == 32


PLANNER_KW = dict(preset="test-tiny", ctx_buckets=(128, 256, 512), extend_buckets=(16, 32),
                  max_new_tokens=32)


@pytest.fixture(scope="module")
def planners():
    """JAX's planner and the port's at sp 1 and 4, on JAX's planner weights
    drawn in fp32."""
    out = {}
    for sp in (1, 4):
        jpl = JPlanner(mesh=j_mesh(sp), **PLANNER_KW)
        params = jax.device_get(j_init(jpl.cfg, jax.random.PRNGKey(0), dtype=jnp.float32))
        jpl.load_params(params)
        tpl = LongSessionPlanner(mesh=sp_mesh(sp, [CPU] * sp), init_weights=False,
                                 **PLANNER_KW)
        tpl.load_params(params_from_numpy(params))
        out[sp] = (jpl, tpl)
    return out


def _session_story(pl):
    """Cold start, plan, warm extend, plan, grow past the bucket (re-anchor),
    plan; each step's observable state."""
    seen = []
    sess = pl.start("user: search for usb hubs\n")
    seen.append(("start", sess.pos, sess.anchors, int(sess.cache["k"].shape[2])))
    seen.append(("plan", pl.plan(sess), list(sess.ids)))
    pos0 = sess.pos
    pl.extend(sess, "result: 24 items\nuser: sort by price\n")
    seen.append(("extend", sess.pos > pos0, sess.anchors))
    seen.append(("plan", pl.plan(sess)))
    for i in range(6):
        pl.extend(sess, f"user: now filter results under {i} dollars please\n")
    seen.append(("reanchor", sess.anchors, int(sess.cache["k"].shape[2]), sess.pos))
    seen.append(("plan", pl.plan(sess), list(sess.ids)))
    with pytest.raises(ValueError, match="extend"):
        pl.plan(sess)
    return seen


@pytest.mark.parametrize("sp", [1, 4])
def test_planner_sessions_token_identical_to_jax(planners, sp):
    jpl, tpl = planners[sp]
    t_story = _session_story(tpl)
    assert t_story == _session_story(jpl)
    assert t_story[0] == ("start", t_story[0][1], 1, 128)  # cold start: one anchor
    assert t_story[2][1:] == (True, 1)  # warm extend: no re-anchor
    assert t_story[4][1] >= 2 and t_story[4][2] >= 256  # re-anchored upward
    for step in (1, 3, 5):
        _, ids = t_story[step][1]
        assert ids and tpl.fsm.walk(ids) >= 0


@pytest.mark.parametrize("sp", [1, 4])
def test_plan_many_token_identical_to_jax(planners, sp):
    """3 sessions in one bucket (a batch of 4 with one zero pad row),
    against JAX's ``plan_many`` and against the port's sequential plans."""
    jpl, tpl = planners[sp]
    texts = ["search for red shoes", "scroll down two pages", "go back now"]
    t_out = tpl.plan_many([tpl.start(t) for t in texts])
    assert t_out == jpl.plan_many([jpl.start(t) for t in texts])
    assert t_out == [tpl.plan(tpl.start(t)) for t in texts]
