"""The port's multi-host entry against the JAX package's single-process paths.

JAX's ``tests/test_multihost.py`` on ``parallel/multihost.py``: the no-op
single-process contract, the host-pure (dp, tp) layout with its straddle
refusal, the mesh driving the same tensor-parallel forward as ``make_mesh``,
and ``process_info``. JAX's two-process DCN case becomes the refusal: the
port serves one process owning its devices, so any multi-process setting
raises at boot, naming the three knobs and the ROADMAP item, in both
services' ``main``.
"""

import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.models.llama import LlamaConfig as JConfig
from tpu_voice_agent.models.llama import init_params as j_init
from tpu_voice_agent.parallel import multihost as jmh
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.models.llama import LlamaConfig, forward
from tpu_voice_agent_torch.parallel.mesh import (
    Sharded,
    default_rules,
    kv_cache_shardings,
    make_mesh,
    param_shardings,
    place_tree,
)
from tpu_voice_agent_torch.parallel.multihost import (
    MULTIHOST_KNOBS,
    init_multihost,
    multihost_mesh,
    process_info,
)

CPU = torch.device("cpu")


def _clear(monkeypatch):
    for k in MULTIHOST_KNOBS:
        monkeypatch.delenv(k, raising=False)


def test_init_single_process_noop(monkeypatch):
    _clear(monkeypatch)
    assert init_multihost() is False and jmh.init_multihost() is False
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert init_multihost() is False


@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:9999"},
    {"JAX_NUM_PROCESSES": "2"},
    {"JAX_PROCESS_ID": "1"},
])
def test_multi_process_settings_are_refused(monkeypatch, env):
    _clear(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as e:
        init_multihost()
    for knob in MULTIHOST_KNOBS:
        assert knob in str(e.value)
    assert "ROADMAP.md Queue 1 item 8" in str(e.value)


@pytest.mark.parametrize("service", ["brain", "voice"])
def test_both_services_refuse_a_multi_process_setting_at_boot(monkeypatch, service):
    import importlib

    mod = importlib.import_module(f"tpu_voice_agent_torch.services.{service}")
    _clear(monkeypatch)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setattr(mod, "load_env_cascade", lambda *a, **k: None)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 8"):
        mod.main()


def test_mesh_layout_and_forward():
    mesh = multihost_mesh(2, 4, [CPU] * 8)
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert [getattr(d, "process_index", 0) for d in mesh.devices.flat] == [0] * 8
    cfg = dict(vocab_size=64, dim=32, n_layers=1, n_heads=4, n_kv_heads=4, ffn_dim=64,
               max_seq_len=32)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, j_init(
        JConfig(**cfg), jax.random.PRNGKey(0), dtype=jnp.float32)))
    tcfg = LlamaConfig(**cfg)
    sh = place_tree(params, mesh, param_shardings(mesh, tcfg.n_kv_heads))
    shape = (1, 2, 32, 4, tcfg.head_dim)
    cache = {n: Sharded.zeros(mesh, shape, s, torch.float32)
             for n, s in kv_cache_shardings(mesh, 4).items()}
    toks = torch.zeros((2, 4), dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)[None].expand(2, 4).contiguous()
    logits, _ = forward(sh, tcfg, toks, pos, cache, rules=default_rules(mesh, 4, 4))
    assert bool(torch.isfinite(logits).all()) and logits.shape == (2, 4, 64)


def test_mesh_too_big_raises():
    with pytest.raises(ValueError, match="needs") as e:
        multihost_mesh(4, 4, [CPU] * 8)
    with pytest.raises(ValueError) as ej:
        jmh.multihost_mesh(dp=4, tp=4)
    assert str(e.value) == str(ej.value)


def test_uneven_hosts_straddling_tp_group_refused():
    fakes = ([SimpleNamespace(process_index=0, id=i) for i in range(6)]
             + [SimpleNamespace(process_index=1, id=i) for i in range(4)])
    with pytest.raises(ValueError, match="straddles"):
        multihost_mesh(2, 4, fakes)
    with pytest.raises(ValueError, match="straddles"):
        jmh.multihost_mesh(dp=2, tp=4, devices=fakes)


def test_mesh_equivalent_to_make_mesh_single_host():
    mh, base = multihost_mesh(2, 4, [CPU] * 8), make_mesh(2, 4, [CPU] * 8)
    assert mh.shape == base.shape and mh.axis_names == base.axis_names
    assert mh == base


def test_mesh_dp_over_hosts_tp_inside_host_layout():
    class _Dev:
        def __init__(self, process_index, id):
            self.process_index, self.id = process_index, id

    fakes = [_Dev(h, i) for h in range(2) for i in range(4)]
    random.Random(7).shuffle(fakes)
    grid = multihost_mesh(2, 4, fakes).devices
    jgrid = jmh.multihost_mesh(dp=2, tp=4, devices=fakes).devices
    for h, (row, jrow) in enumerate(zip(grid, jgrid)):
        assert {d.process_index for d in row} == {h}
        assert [d.id for d in row] == [0, 1, 2, 3] == [d.id for d in jrow]
    grid2 = multihost_mesh(4, 2, fakes).devices
    assert all(len({d.process_index for d in r}) == 1 for r in grid2)
    assert [r[0].process_index for r in grid2] == [0, 0, 1, 1]


def test_process_info_shape():
    info = process_info([CPU] * 8)
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 8,
                    "global_devices": 8}
    assert set(info) == set(jmh.process_info())
