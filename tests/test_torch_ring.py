"""Ring and Ulysses attention and K1's log-sum-exp, against the JAX package.

JAX's ``tests/test_ring.py`` cases on the port (``parallel/ring.py``): the
same q/k/v from numpy seeds go through JAX's ``ring_attention`` /
``ulysses_attention`` on its 8 virtual CPU devices and through the port's on
a one-process mesh of CPU devices; both are held to each other and to the
full attention (JAX's ``attention_reference``) at atol / rtol 2e-5. K1's
plain version's log-sum-exp is held to a float64 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_voice_agent.ops import attention_reference as j_attention
from tpu_voice_agent.parallel.ring import ring_attention as j_ring
from tpu_voice_agent.parallel.ring import sp_mesh as j_mesh
from tpu_voice_agent.parallel.ring import ulysses_attention as j_ulysses
from tpu_voice_agent_torch.ops import attention_reference, flash_attention
from tpu_voice_agent_torch.parallel import ring
from tpu_voice_agent_torch.parallel import ring_attention, sp_mesh, ulysses_attention

TOL = dict(atol=2e-5, rtol=2e-5)
CPU = torch.device("cpu")


def _qkv(seed, B, T, nq, nkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, nq, hd), (B, T, nkv, hd), (B, T, nkv, hd)))


def _both(fn_j, fn_t, arrays, sp, **kw):
    out_j = np.asarray(fn_j(*map(jnp.asarray, arrays), j_mesh(sp), **kw))
    out_t = fn_t(*map(torch.from_numpy, arrays), sp_mesh(sp, [CPU] * sp), **kw).numpy()
    ref = np.asarray(j_attention(*map(jnp.asarray, arrays), causal=kw.get("causal", True)))
    return out_j, out_t, ref


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_and_full_attention_at_sp8(causal):
    out_j, out_t, ref = _both(j_ring, ring_attention, _qkv(0, 2, 64, 8, 4, 32), 8,
                              causal=causal)
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(out_t, ref, **TOL)


def test_two_device_ring():
    out_j, out_t, ref = _both(j_ring, ring_attention, _qkv(2, 1, 16, 4, 2, 16), 2, causal=True)
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(out_t, ref, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax_and_full_attention_at_sp8(causal):
    out_j, out_t, ref = _both(j_ulysses, ulysses_attention, _qkv(3, 2, 64, 16, 8, 32), 8,
                              causal=causal)
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(out_t, ref, **TOL)


def test_ulysses_rejects_indivisible_heads():
    q, k, v = map(torch.from_numpy, _qkv(4, 1, 32, 6, 6, 16))
    with pytest.raises(ValueError, match="divisible") as e:
        ulysses_attention(q, k, v, sp_mesh(8, [CPU] * 8))
    with pytest.raises(ValueError) as ej:
        j_ulysses(*map(jnp.asarray, _qkv(4, 1, 32, 6, 6, 16)), j_mesh(8))
    assert str(e.value) == str(ej.value)


def test_sp_mesh_refuses_more_devices_than_it_has():
    with pytest.raises(ValueError) as e:
        sp_mesh(3, [CPU] * 2)
    with pytest.raises(ValueError) as ej:
        j_mesh(3, jax.devices()[:2])
    assert str(e.value) == str(ej.value) == "sp=3 needs 3 devices, have 2"
    assert sp_mesh(2, ["cpu", "cpu"]) == [CPU, CPU]


@pytest.mark.parametrize("causal,blocks", [(True, 10), (False, 16)])
def test_every_visible_block_is_one_k1_call_with_lse(monkeypatch, causal, blocks):
    """At sp 4: the diagonal block causal, earlier ones not, later ones
    skipped under ``causal`` (4 + 3 + 2 + 1 calls); each asks for the lse
    and an fp32 output."""
    calls = []

    def counting(q, k, v, **kw):
        calls.append(kw)
        return flash_attention(q, k, v, **kw)

    monkeypatch.setattr(ring, "flash_attention", counting)
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 32, 4, 2, 16))
    ring_attention(q, k, v, sp_mesh(4, [CPU] * 4), causal=causal)
    assert len(calls) == blocks
    assert all(c["return_lse"] and c["out_dtype"] == torch.float32 for c in calls)
    assert sum(c["causal"] for c in calls) == (4 if causal else 0)


def test_ring_at_sp1_is_the_single_k1_call_bit_for_bit():
    """One block: no merge, one rounding, so the sp prefill at sp 1 is the
    dense fresh-block forward's attention exactly (bf16 too)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(6, 1, 64, 8, 2, 32))
    out = ring_attention(q, k, v, sp_mesh(1, [CPU]), causal=True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 40), (False, 0)])
def test_k1_plain_lse_against_float64(causal, kv_len):
    """``return_lse``: the log-sum-exp of the scaled, masked scores in
    natural log, (B, T, nq) fp32; a row that sees no key gets -inf; the
    output is the call without it, in the asked dtype."""
    q, k, v = map(torch.from_numpy, _qkv(7, 2, 48, 4, 2, 16))
    out, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len, return_lse=True)
    assert lse.shape == (2, 48, 4) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, kv_len=kv_len))
    qd, kd = q.double(), k.double().repeat_interleave(2, dim=2)
    s = torch.einsum("bthd,bshd->bhts", qd, kd) * 16 ** -0.5
    n = 48 if kv_len is None else kv_len
    mask = torch.arange(48)[None, :] < n
    if causal:
        mask = mask & (torch.arange(48)[:, None] >= torch.arange(48)[None, :])
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1).permute(0, 2, 1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=1e-6)
    out32, lse32 = attention_reference(q.to(torch.bfloat16), k.to(torch.bfloat16),
                                       v.to(torch.bfloat16), causal=causal, kv_len=kv_len,
                                       return_lse=True, out_dtype=torch.float32)
    assert out32.dtype == torch.float32 and lse32.dtype == torch.float32
