"""The port's quantized paged KV tier (``KV_QUANT=int8|int4``) against the
JAX package's, on the same numpy inputs.

- ``ops.kvquant``: stored values and bf16 scales byte-identical to JAX's
  (inputs of normal floats: XLA's CPU flushes subnormals to zero, PyTorch
  keeps them, so a row whose amax is subnormal may scale otherwise);
- K8 / K9 / K10: the port's plain versions against the JAX Pallas kernels
  (interpret mode) at ``tests/test_kv_quant.py``'s shapes, float32, so the
  tolerance is the float32 one, ``rtol = atol = 2e-5`` (the JAX test's own:
  the same dequantized values summed in another order);
- ``forward_paged`` with both tiers on shared float32 weights, and the
  quantized ``PagedDecodeEngine`` behind the batcher token-identical to the
  JAX one at fast-forward 8 and 0;
- the port's own contracts: radix warm equals cold at int8, ``KV_QUANT``
  parsing, and the brain built from the environment.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_voice_agent.models import llama as jl
from tpu_voice_agent.ops import decode_attention_quant as j_decode_quant
from tpu_voice_agent.ops import kvquant as jq
from tpu_voice_agent.ops import paged_attention_quant as j_paged_quant
from tpu_voice_agent.ops import paged_block_attention_quant as j_paged_block_quant
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent_torch import bridge, ops
from tpu_voice_agent_torch.models import llama as tl
from tpu_voice_agent_torch.ops import kvquant as tq
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.services import brain
from tpu_voice_agent_torch.services.brain import SessionTranscripts, install_prompt_prefix

TOL = dict(rtol=2e-5, atol=2e-5)
TIERS = ["int8", "int4"]
BITS = {"int8": 8, "int4": 4}


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor (bf16 bit for bit)."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    """A torch tensor as numpy (bf16 as ml_dtypes' bfloat16, bit for bit)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# ---------------------------------------------------------------- value layout


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_quantize_kv_is_byte_identical_to_jax(tier, src):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal((3, 5, 2, 48)) * s for s in (1e-3, 1.0, 300.0)])
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the guarded scale of 1
    x[4, 2, 1, :7] = [0.5, -0.5, 1.5, 2.5, -2.5, 127.0, -127.0]  # half-way points
    jx = jnp.asarray(x).astype(jnp.bfloat16) if src == "bfloat16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(torch.bfloat16) if src == "bfloat16" else torch.from_numpy(x)
    jv, js = jq.quantize_kv(jx, tier)
    tv, ts = tq.quantize_kv(tx, tier)
    assert tv.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tv.shape == (9, 5, 2, 48 if tier == "int8" else 24) and ts.shape == (9, 5, 2)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    assert float(ts[0, 0, 0]) == 1.0 and bool((tv[0, 0, 0] == 0).all())
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(_np(tq.dequantize_kv(tv, ts, tier, dtype)),
                                      np.asarray(jq.dequantize_kv(jv, js, tier, jdtype)))


def test_int4_pack_and_unpack_agree_with_jax_on_every_byte():
    every = np.arange(-128, 128, dtype=np.int8).reshape(8, 32)
    np.testing.assert_array_equal(tq.unpack_int4(torch.from_numpy(every)).numpy(),
                                  np.asarray(jq.unpack_int4(jnp.asarray(every))))
    vals = np.random.default_rng(1).integers(-7, 8, size=(6, 48)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(vals))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), vals)


@pytest.mark.parametrize("tier", [None, "int8", "int4"])
def test_kv_block_bytes_and_store_layout_equal_jax(tier):
    for L, bs, nkv, hd in ((22, 128, 4, 64), (2, 16, 2, 32), (3, 128, 2, 48)):
        assert tq.kv_block_bytes(L, bs, nkv, hd, tier) == jq.kv_block_bytes(L, bs, nkv, hd, tier)
        assert tq.kv_store_dim(hd, tier) == jq.kv_store_dim(hd, tier)
    assert tq.kv_quant_bits(tier) == jq.kv_quant_bits(tier)
    assert str(tq.kv_store_dtype(tier)).split(".")[-1] == jnp.dtype(jq.kv_store_dtype(tier)).name
    # the batch cell's pool at one byte budget: 513 bf16 blocks hold 994 / 1,931
    budget = 513 * tq.kv_block_bytes(22, 128, 4, 64, None)
    assert budget // tq.kv_block_bytes(22, 128, 4, 64, "int8") == 994
    assert budget // tq.kv_block_bytes(22, 128, 4, 64, "int4") == 1931


# ---------------------------------------------------------------- kernels


def _quantized(shape, tier, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        v, s = jq.quantize_kv(jnp.asarray(rng.standard_normal(shape).astype(np.float32)), tier)
        out += [v, s]
    return out  # k values, k scales, v values, v scales


@pytest.mark.parametrize("tier", TIERS)
def test_paged_attention_quant_plain_matches_jax_kernel(tier):
    L, N, bs, nq, nkv, hd = 2, 8, 16, 8, 4, 32
    kv, ks, vv, vs = _quantized((L, N, bs, nkv, hd), tier, 5)
    q = np.random.default_rng(6).standard_normal((4, nq, hd)).astype(np.float32)
    tables = np.array([[3, 7, 1], [5, 2, 6], [4, 0, 2], [1, 2, 3]], np.int32)
    kv_len = np.array([5, 33, 48, 0], np.int32)  # the last row reads no key
    ops.reset_launch_counts()
    for layer in (0, 1):
        ref = np.asarray(j_paged_quant(jnp.asarray(q), kv, vv, ks, vs, jnp.asarray(tables),
                                       jnp.asarray(kv_len), jnp.int32(layer), bits=BITS[tier]))
        out = ops.paged_attention_quant(_t(q), _t(kv), _t(vv), _t(ks), _t(vs), _t(tables),
                                        _t(kv_len), layer, bits=BITS[tier])
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
        assert bool((out[3] == 0).all()) and np.all(ref[3] == 0)
    assert ops.launch_counts()["paged_attention_quant"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("tier", TIERS)
def test_paged_block_attention_quant_plain_matches_jax_kernel(tier):
    L, N, bs, nq, nkv, hd = 1, 6, 16, 8, 4, 32
    kv, ks, vv, vs = _quantized((L, N, bs, nkv, hd), tier, 7)
    q = np.random.default_rng(8).standard_normal((3, 3, nq, hd)).astype(np.float32)
    tables = np.array([[3, 1, 5], [2, 4, 0], [1, 2, 3]], np.int32)
    # a straddling block, an unordered one with a repeat, and an empty row
    q_pos = np.array([[17, 18, 19], [30, 2, 30], [-1, -1, -1]], np.int32)
    ref = np.asarray(j_paged_block_quant(jnp.asarray(q), kv, vv, ks, vs, jnp.asarray(tables),
                                         jnp.asarray(q_pos), jnp.int32(0), bits=BITS[tier]))
    out = ops.paged_block_attention_quant(_t(q), _t(kv), _t(vv), _t(ks), _t(vs), _t(tables),
                                          _t(q_pos), 0, bits=BITS[tier])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert bool((out[2] == 0).all()) and np.all(ref[2] == 0)


@pytest.mark.parametrize("tier", TIERS)
def test_decode_attention_quant_plain_matches_jax_kernel(tier):
    B, S, nq, nkv, hd = 3, 256, 8, 4, 32
    kv, ks, vv, vs = _quantized((B, S, nkv, hd), tier, 9)
    q = np.random.default_rng(10).standard_normal((B, nq, hd)).astype(np.float32)
    kv_len = np.array([5, 133, 256], np.int32)
    ref = np.asarray(j_decode_quant(jnp.asarray(q), kv, vv, ks, vs, jnp.asarray(kv_len),
                                    bits=BITS[tier], block_k=128))
    out = ops.decode_attention_quant(_t(q), _t(kv), _t(vv), _t(ks), _t(vs), _t(kv_len),
                                     bits=BITS[tier])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# ---------------------------------------------------------------- forward_paged


def _quanta_apart(a: np.ndarray, b: np.ndarray, tier: str) -> np.ndarray:
    """Elementwise |a - b| in quanta of the stored values (nibbles at int4)."""
    if tier == "int4":
        a, b = (np.asarray(jq.unpack_int4(jnp.asarray(x))) for x in (a, b))
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


@pytest.mark.parametrize("tier", TIERS)
def test_forward_paged_quant_matches_jax(tier):
    """Three rows through every quantized branch on float32 weights: a fresh
    (3, 20) prefill (K1 over the stored values), a gathered (3, 24) suffix,
    a (3, 9) fast-forward block (K9) with row 1 parked, and a T=1 step (K8)
    with row 2 parked. Logits agree at 2e-5, but for the gathered suffix:
    that branch attends ``dequantize_kv``'s bf16 values and, as ``_attend``
    does on both sides, rounds its probabilities to bf16, where float32
    sums taken in another order can tip a probability's rounding by one
    bf16 ulp (2^-8 of it); there the logits agree within 5e-4 (the widest
    seen is 1.2e-4). The stored values and scales
    equal JAX's except where the two sides' float32 k/v (the same
    arithmetic summed in another order) straddle a rounding point: a value
    may then sit one quantum apart, and its row's scale one bf16 ulp. Such
    elements are counted and must stay under 0.5% of those written."""
    cfg = dataclasses.replace(jl.PRESETS["test-tiny"], vocab_size=97)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(cfg))
    params = jl.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    hdp = tq.kv_store_dim(cfg.head_dim, tier)
    shape = (cfg.n_layers, 16, 16, cfg.n_kv_heads, hdp)
    jk, jv = jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8)
    jks, jvs = jnp.zeros(shape[:4], jnp.bfloat16), jnp.zeros(shape[:4], jnp.bfloat16)
    tk, tv = torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8)
    tks = torch.zeros(shape[:4], dtype=torch.bfloat16)
    tvs = torch.zeros(shape[:4], dtype=torch.bfloat16)
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
    off_values = off_scales = written = 0
    for tokens, positions, fresh, mask, gb in steps:
        before = tk.clone()
        wm = None if mask is None else np.array(mask)
        jlog, jk, jv, jks, jvs = jl.forward_paged(
            params, cfg, jnp.asarray(tokens), jnp.asarray(positions), jk, jv,
            jnp.asarray(tables), attn_impl="xla" if gb else "pallas",
            write_mask=None if wm is None else jnp.asarray(wm), fresh_block=fresh,
            gather_blocks=gb, k_scale=jks, v_scale=jvs, kv_quant=tier)
        tlog = tl.forward_paged(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(np.ascontiguousarray(positions)),
            tk, tv, torch.from_numpy(tables), attn_impl="torch" if gb else "kernels",
            write_mask=None if wm is None else torch.from_numpy(wm), fresh_block=fresh,
            gather_blocks=gb, k_scale=tks, v_scale=tvs, kv_quant=tier)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **(dict(rtol=2e-5, atol=5e-4) if gb else TOL))
        # block 0 is the trash block: parked writes of several rows race there
        for pj, pt in ((jk, tk), (jv, tv)):
            apart = _quanta_apart(np.asarray(pj)[:, 1:], pt.numpy()[:, 1:], tier)
            assert apart.max() <= 1
            off_values += int((apart == 1).sum())
        for sj, st in ((jks, tks), (jvs, tvs)):
            a = np.asarray(sj)[:, 1:].astype(np.float32)
            b = st[:, 1:].float().numpy()
            np.testing.assert_allclose(b, a, rtol=2.0 ** -7, atol=0)  # one bf16 ulp
            off_scales += int((a != b).sum())
        if wm is not None:
            for row in np.flatnonzero(~wm):  # a parked row's own blocks are untouched
                own = torch.from_numpy(tables[row]).long()
                assert torch.equal(tk[:, own], before[:, own])
        written += int((tks[:, 1:] != 0).sum())
    values = written * cfg.head_dim
    assert off_values <= 0.005 * values and off_scales <= 0.005 * written, (
        f"{off_values} of {values} values and {off_scales} of {written} scales apart")


# ---------------------------------------------------------------- engine level

KW = dict(preset="test-tiny", max_len=2048, batch_slots=2, prefill_buckets=(128, 256, 512, 1024))
PROMPTS = [render_prompt("search for laptops under 1000", {}),
           render_prompt("take a screenshot of this page", {})]


@pytest.fixture(scope="module")
def weights():
    eng = JPaged(kernels="pallas", **KW)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


def _port(weights, **kw):
    eng = PagedDecodeEngine(init_weights=False, device="cpu", **KW, **kw)
    eng.load_params(bridge.params_from_numpy(weights))
    install_prompt_prefix(eng)
    return eng


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("ff", [8, 0])
def test_quantized_paged_batcher_matches_jax(weights, tier, ff):
    """float32 weights, the few-shot prefix installed (its full blocks and
    each slot's tail quantized on write), two slots: greedy ids equal the
    JAX engine's (its Pallas K8 / K9 in interpret mode). The installed
    prefix's stored values sit at most one quantum apart, on under 0.01% of
    them (each side quantizes its own bf16 prefill of the prefix), and its
    scales at most one bf16 ulp."""
    jeng = JPaged(kernels="pallas", fast_forward=ff, kv_quant=tier, init_weights=False, **KW)
    jeng.load_params(jax.device_put(weights))
    teng = _port(weights, fast_forward=ff, kv_quant=tier)
    assert j_install(jeng) == len(teng.prefix_ids) > 800
    assert teng.k_pool.dtype == torch.int8 and teng.k_scale.dtype == torch.bfloat16
    # the installed prefix: quantized from each side's bf16 prefill k/v, which
    # a float32 sum taken in another order may round otherwise
    for vals, scales in (("k_pool", "k_scale"), ("v_pool", "v_scale")):
        apart = _quanta_apart(np.asarray(getattr(jeng, vals)), getattr(teng, vals).numpy(), tier)
        assert apart.max() <= 1 and (apart > 0).mean() < 1e-4
        np.testing.assert_allclose(getattr(teng, scales).float().numpy(),
                                   np.asarray(getattr(jeng, scales)).astype(np.float32),
                                   rtol=2.0 ** -7, atol=0)
    jres = JBatcher(jeng, chunk_steps=16, max_new_tokens=32).generate_many(PROMPTS)
    tb = ContinuousBatcher(teng, chunk_steps=16, max_new_tokens=32)
    tres = tb.generate_many(PROMPTS)
    for j, t in zip(jres, tres):
        assert t.error is None and teng.fsm.walk(t.token_ids) >= 0
        assert t.token_ids == j.token_ids
        assert (t.steps, t.finished, t.cached_tokens) == (j.steps, j.finished, j.cached_tokens)
    assert teng.allocator.blocks_in_use == len(teng._prefix_blocks) > 0


TURNS = [("search for wireless headphones", {}),
         ("open the second result", {"last_query": "wireless headphones"}),
         ("sort these by price from low to high", {"last_query": "wireless headphones"})]


def _play_session(eng, max_new=24):
    tr = SessionTranscripts(eng.tokenizer)
    b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=max_new)
    out = []
    for text, ctx in TURNS:
        prompt = tr.prompt_for("sess", text, ctx)
        ids = eng.tokenizer.encode(prompt, bos=True) if isinstance(prompt, str) else list(prompt)
        r = b.generate_many([ids])[0]
        assert r.error is None, r.error
        tr.record("sess", ids, r.token_ids)
        out.append(r)
    return out


def test_int8_radix_warm_equals_cold(weights):
    """Radix chains share quantized blocks with their scales: a session
    served from int8 cached chains decodes what int8 cold admissions decode,
    and a replay from the cached chains still does (the JAX package's
    ``test_int8_radix_warm_cold_identity``)."""
    cold = _play_session(_port(weights, kv_quant="int8", radix_enable=False))
    warm_eng = _port(weights, kv_quant="int8", radix_enable=True)
    warm = _play_session(warm_eng)
    P = len(warm_eng.prefix_ids)
    assert [c.token_ids for c in cold] == [w.token_ids for w in warm]
    assert warm[0].cached_tokens == P and warm[1].cached_tokens > P
    replay = _play_session(warm_eng)
    assert [c.token_ids for c in cold] == [r.token_ids for r in replay]
    assert all(r.cached_tokens > P for r in replay[1:])


# ---------------------------------------------------------------- knobs


def test_kv_quant_env_knob_and_validation(monkeypatch):
    kw = dict(preset="test-tiny", max_len=512, prefill_buckets=(64,), init_weights=False,
              device="cpu")
    monkeypatch.delenv("KV_QUANT", raising=False)
    eng = PagedDecodeEngine(**kw)
    assert eng.kv_quant is None and eng.kv_quant_bits == 16
    assert eng.k_pool.dtype == torch.bfloat16 and eng.k_scale is None and eng.v_scale is None
    hd = eng.cfg.head_dim
    for env, tier, width in (("int8", "int8", hd), ("int4", "int4", hd // 2), ("off", None, hd),
                             ("", None, hd)):
        monkeypatch.setenv("KV_QUANT", env)
        eng = PagedDecodeEngine(**kw)
        assert eng.kv_quant == tier and eng.k_pool.shape[-1] == width
        assert eng.kv_bytes_per_block == tq.kv_block_bytes(
            eng.cfg.n_layers, eng.block_size, eng.cfg.n_kv_heads, hd, tier)
        if tier is not None:
            assert eng.k_pool.dtype == torch.int8 and eng.kv_quant_bits == BITS[tier]
            assert eng.k_scale.shape == eng.k_pool.shape[:4]
            assert eng.v_scale.dtype == torch.bfloat16
    assert PagedDecodeEngine(kv_quant="off", **kw).kv_quant is None  # the explicit baseline
    monkeypatch.setenv("KV_QUANT", "fp8")
    with pytest.raises(ValueError, match="KV_QUANT"):
        PagedDecodeEngine(**kw)


def test_kv_quant_refuses_head_dims_the_card_kernels_lack(monkeypatch):
    from tpu_voice_agent_torch.serve import paged

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for tier in ("int8", "int4"):
        # 128: llama3-8b, llama3-70b and mixtral-8x7b, built since K8-K10 took hd 128
        for hd in (32, 48, 64, 128):
            paged.check_kv_quant_head_dim(tier, hd, cuda)
        for hd in (16, 80):  # dims no quantized kernel was built for
            with pytest.raises(ValueError, match=f"KV_QUANT={tier}.*got {hd}"):
                paged.check_kv_quant_head_dim(tier, hd, cuda)
            paged.check_kv_quant_head_dim(tier, hd, cpu)  # the plain versions take any
    paged.check_kv_quant_head_dim(None, 80, cuda)  # the bf16 pool reads K6 / K7

    # the engine consults the check at boot, with its own head dim and device
    seen = []
    monkeypatch.setattr(paged, "check_kv_quant_head_dim", lambda *a: seen.append(a))
    eng = PagedDecodeEngine(preset="test-tiny", max_len=512, prefill_buckets=(64,),
                            init_weights=False, device="cpu", kv_quant="int8")
    assert seen == [("int8", eng.cfg.head_dim, cpu)]


def test_env_factory_builds_a_quantized_paged_brain(monkeypatch):
    monkeypatch.setenv("BRAIN_BACKEND", "engine:test-tiny")
    monkeypatch.setenv("BRAIN_DEVICE", "cpu")
    monkeypatch.setenv("BRAIN_BATCH", "2")
    monkeypatch.setenv("BRAIN_PAGED", "1")
    monkeypatch.setenv("KV_QUANT", "int8")
    monkeypatch.setenv("BRAIN_POOL_BLOCKS", "40")
    parser = brain.make_parser_from_env()
    try:
        eng = parser.engine
        assert isinstance(parser, brain.BatchedEngineParser)
        assert isinstance(eng, PagedDecodeEngine) and eng.kv_quant == "int8"
        assert eng.k_pool.dtype == torch.int8 and eng.allocator.n_blocks == 40
        app = brain.BrainApp(parser)
        assert app.health()[1]["kv_quant"] == "int8"
        status, body, _ = app.parse(b'{"text": "scroll down"}')
        # random weights: a valid plan, or no EOS inside the budget
        assert status == 200 or (status == 422 and body["detail"].startswith("decode truncated"))
        assert eng.allocator.blocks_in_use == len(eng._prefix_blocks)
    finally:
        parser.close()
