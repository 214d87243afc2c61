"""Expert parallelism of the port against the JAX package.

JAX's ``tests/test_expert.py`` on ``parallel/expert.py``: the same float32
router and expert weights (JAX's init, shared as numpy) and the same inputs
go through JAX's ``_route`` / ``moe_ffn`` / ``moe_ffn_ep`` (8 virtual CPU
devices) and the port's (a one-process ``ep`` mesh of CPU devices); routing
tensors equal, outputs within JAX's tolerance (atol 1e-5, rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.parallel import expert as jexp
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.parallel.expert import (
    MoEConfig,
    _route,
    ep_mesh,
    init_moe_params,
    moe_ffn,
    moe_ffn_ep,
    moe_param_shardings,
)
from tpu_voice_agent_torch.parallel.mesh import place_tree

CPU = torch.device("cpu")
CFG = MoEConfig(dim=32, ffn_dim=64, n_experts=8, top_k=2, capacity_factor=1.25)
JCFG = jexp.MoEConfig(dim=32, ffn_dim=64, n_experts=8, top_k=2, capacity_factor=1.25)
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jexp.init_moe_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(T=24, seed=1):
    return np.random.default_rng(seed).standard_normal((T, CFG.dim)).astype(np.float32)


def test_routing_equals_jax_and_gates_renormalize(params):
    jp, tp = params
    x = _x()
    dispatch, combine = _route(tp["router"], torch.from_numpy(x), CFG, x.shape[0])
    jd, jc = jexp._route(jp["router"], jnp.asarray(x), JCFG, x.shape[0])
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), atol=1e-6)
    T, E, C = combine.shape
    assert (E, C) == (CFG.n_experts, CFG.capacity(T)) == (JCFG.n_experts, JCFG.capacity(T))
    occ = dispatch.sum(dim=(1, 2)).numpy()
    assert (occ <= CFG.top_k + 1e-6).all()
    w = combine.sum(dim=(1, 2)).numpy()
    np.testing.assert_allclose(w[occ > 0], 1.0, atol=1e-5)
    assert (dispatch.sum(dim=0).numpy() <= 1 + 1e-6).all()


def test_capacity_drops_overflow():
    tight = MoEConfig(dim=32, ffn_dim=64, n_experts=2, top_k=1, capacity_factor=0.5)
    p = init_moe_params(tight, torch.Generator().manual_seed(2), dtype=torch.float32)
    dispatch, _ = _route(p["router"], torch.from_numpy(_x(T=16, seed=3)), tight, 16)
    assert (dispatch.sum(dim=(0, 2)).numpy() <= tight.capacity(16)).all()
    assert float(dispatch.sum()) < 16


def test_moe_output_equals_jax(params):
    jp, tp = params
    y = moe_ffn(tp, CFG, torch.from_numpy(_x()))
    assert y.shape == (24, CFG.dim) and bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(jexp.moe_ffn(jp, JCFG, jnp.asarray(_x()))),
                               **TOL)


@pytest.mark.parametrize("ep,T", [(8, 40), (4, 12)])
def test_ep_matches_jax_and_the_dense_reference(params, ep, T):
    jp, tp = params
    x = _x(T=T, seed=5 + ep)
    mesh = ep_mesh(ep, [CPU] * ep)
    out = moe_ffn_ep(place_tree(tp, mesh, moe_param_shardings(mesh)), CFG,
                     torch.from_numpy(x), mesh)
    jm = jexp.ep_mesh(ep)
    jout = jexp.moe_ffn_ep(jax.device_put(jp, jexp.moe_param_shardings(jm)), JCFG,
                           jnp.asarray(x), jm)
    np.testing.assert_allclose(out.numpy(), moe_ffn(tp, CFG, torch.from_numpy(x)).numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    # plain tensors are laid out by the call itself
    np.testing.assert_allclose(moe_ffn_ep(tp, CFG, torch.from_numpy(x), mesh).numpy(),
                               out.numpy(), atol=0, rtol=0)


def test_ep_mesh_size_validation(params):
    _, tp = params
    bad = MoEConfig(dim=32, ffn_dim=64, n_experts=6, top_k=2)
    with pytest.raises(ValueError) as e:
        moe_ffn_ep(tp, bad, torch.from_numpy(_x(T=12)), ep_mesh(4, [CPU] * 4))
    with pytest.raises(ValueError) as ej:
        jexp.moe_ffn_ep(params[0], jexp.MoEConfig(dim=32, ffn_dim=64, n_experts=6, top_k=2),
                        jnp.asarray(_x(T=12)), jexp.ep_mesh(4))
    assert str(e.value) == str(ej.value)
    with pytest.raises(ValueError, match="needs 9 devices"):
        ep_mesh(9, [CPU] * 8)
    init = init_moe_params(CFG, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == {
        k: (tuple(v.shape), torch.bfloat16) for k, v in tp.items()}
