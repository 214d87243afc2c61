"""The port's CUDA kernels (K1-K13) against their plain PyTorch versions, on
the card. Every test here is marked ``gpu`` and skips where there is no CUDA
device. The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest configures JAX.)

Tolerances: bfloat16 outputs 2^-6 * |ref| + 1e-4, element by element (the
kernel and its plain version each round an fp32 result to bf16, at most one
ulp <= 2^-7 |x| each, on top of fp32 sums taken in another order); float32
outputs 1e-5 absolute (sums of ~1-sized terms taken in another order); the
grammar kernel's token ids and states exactly.
"""

import numpy as np
import pytest
import torch

from tpu_voice_agent_torch import ops
from tpu_voice_agent_torch.ops.kvquant import quantize_kv

BF16_TOL = {"atol": 1e-4, "rtol": 2.0 ** -6}
F32_TOL = {"atol": 1e-5, "rtol": 0.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _rnd(g, dev, dtype):
    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    return rnd


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)])
@pytest.mark.parametrize("hd", [16, 32, 48, 64, 128])
def test_attention_kernels_match_plain(cuda, hd, dtype, tol):
    """``tol``: assert_close's |out - ref| <= atol + rtol * |ref|."""
    rnd = _rnd(torch.Generator(device=cuda).manual_seed(hd), cuda, dtype)
    q, k, v = rnd(2, 70, 8, hd), rnd(2, 70, 2, hd), rnd(2, 70, 2, hd)
    for causal, kv_len in ((True, None), (False, 50)):
        out = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        ref = ops.attention_reference(q, k, v, causal=causal, kv_len=kv_len)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
    bf = _rnd(torch.Generator(device=cuda).manual_seed(hd + 1), cuda, torch.bfloat16)
    kc, vc = bf(2, 2, 96, 2, hd), bf(2, 2, 96, 2, hd)  # the cache is bf16 either way
    kv_len = torch.tensor([1, 77], dtype=torch.int32, device=cuda)
    out = ops.decode_attention_layer(q[:, 0].contiguous(), kc, vc, kv_len, 1)
    ref = ops.decode_attention_reference(q[:, 0], kc[1], vc[1], kv_len)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    # a padded chain step and an unordered block with repeats
    pos = torch.tensor([[5, 6, 7, 7, 7, 7, 7, 7, 7], [90, 2, 40, 40, 0, 95, 13, 60, 61]],
                       dtype=torch.int32, device=cuda)
    q9 = q[:, :9].contiguous()
    out = ops.decode_block_attention_layer(q9, kc, vc, pos, 0)
    ref = ops.decode_block_attention_reference(q9, kc[0], vc[0], pos)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,nq,nkv", [(16, 4, 4), (64, 20, 20), (64, 8, 2)])
def test_flat_decode_attention_matches_plain(cuda, hd, nq, nkv, dtype):
    """K5 on a flat cache: S not a multiple of the 32-key tile, kv_len 0
    (zeros), 1, ragged and S; MHA (the Whisper decoder) and GQA."""
    g = torch.Generator(device=cuda).manual_seed(hd + nq)
    S = 300
    kc = torch.randn(4, S, nkv, hd, generator=g, device=cuda).to(dtype)
    vc = torch.randn(4, S, nkv, hd, generator=g, device=cuda).to(dtype)
    q = torch.randn(4, nq, hd, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([0, 1, 177, S], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, kc, vc, kv_len)
    ref = ops.decode_attention_reference(q, kc, vc, kv_len)
    assert out.dtype == dtype and bool((out[0] == 0).all())
    torch.testing.assert_close(out.float(), ref.float(),
                               **(BF16_TOL if dtype == torch.bfloat16 else F32_TOL))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [25, 35, 150, 500])
def test_flash_attention_at_the_whisper_encoder_shapes(cuda, T):
    """K1 non-causal, T = S: the incremental blocks (25, 35) and the 300 and
    1000 frame buckets (150, 500); large-v3 (20 heads, hd 64, bf16) and the
    in-repo checkpoints (4 heads, hd 16, fp32)."""
    g = torch.Generator(device=cuda).manual_seed(T)
    for nh, hd, dtype, tol in ((20, 64, torch.bfloat16, BF16_TOL), (4, 16, torch.float32, F32_TOL)):
        q, k, v = (torch.randn(1, T, nh, hd, generator=g, device=cuda).to(dtype) for _ in range(3))
        out = ops.flash_attention(q, k, v, causal=False)
        ref = ops.attention_reference(q, k, v, causal=False)
        torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
def test_widest_decode_block(cuda):
    """T = 16 queries and a GQA group of 16 (256 query rows per block)."""
    rnd = _rnd(torch.Generator(device=cuda).manual_seed(7), cuda, torch.bfloat16)
    kc, vc = rnd(1, 1, 300, 2, 64), rnd(1, 1, 300, 2, 64)
    q = rnd(1, 16, 32, 64)
    pos = torch.arange(250, 266, dtype=torch.int32, device=cuda)[None]
    out = ops.decode_block_attention_layer(q, kc, vc, pos, 0)
    ref = ops.decode_block_attention_reference(q, kc[0], vc[0], pos)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)


@pytest.mark.gpu
def test_masked_argmax_advance_matches_plain(cuda):
    rng = np.random.default_rng(5)
    S, V, C = 40, 300, 24
    mask = rng.random((S, V)) < 0.3
    mask[7] = False  # an all-masked state
    table = rng.integers(-1, S, size=(S, C)).astype(np.int32)
    col_id = rng.integers(0, C, size=(V,)).astype(np.int32)
    logits = rng.standard_normal((6, V)).astype(np.float32)
    logits[1, :] = 0.5  # ties: the first legal index wins
    logits[4, :] = np.nan  # must not fault
    state = np.array([0, 3, 7, -1, 39, 12], np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (logits, state, mask, table, col_id)]
    tok, nxt = ops.masked_argmax_advance(*args)
    rtok, rnxt = ops.masked_argmax_advance_reference(*args)
    keep = torch.arange(6, device=cuda) != 4  # a NaN row's pick is the poison gate's
    assert torch.equal(tok[keep], rtok[keep]) and torch.equal(nxt[keep], rnxt[keep])
    assert 0 <= int(tok[4]) < V


@pytest.mark.gpu
@pytest.mark.parametrize("V", [300, 619, 1500])
def test_masked_argmax_matches_plain(cuda, V):
    """K11 exactly: ties, an all-masked state (token 0), dead states clamped
    to 0; and a (B, 1+K) verify block in one launch."""
    rng = np.random.default_rng(V)
    S = 40
    mask = rng.random((S, V)) < 0.3
    mask[7] = False
    logits = rng.standard_normal((10, V)).astype(np.float32)
    logits[1, :] = 0.5
    state = np.array([0, 3, 7, -1, 39, 12, 5, 5, 0, 7], np.int32)
    lg, st, mk = (torch.from_numpy(a).to(cuda) for a in (logits, state, mask))
    ops.reset_launch_counts()
    tok = ops.masked_argmax(lg, st, mk)
    assert torch.equal(tok, ops.masked_argmax_reference(lg, st, mk)) and int(tok[2]) == 0
    blk = ops.masked_argmax_block(lg.reshape(2, 5, V), st.reshape(2, 5), mk)
    assert torch.equal(blk.flatten(), ops.masked_argmax_reference(lg, st, mk))
    assert ops.launch_counts()["masked_argmax"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)])
@pytest.mark.parametrize("hd,nq,nkv", [(48, 4, 2), (64, 32, 4)])
def test_flat_decode_block_attention_matches_plain(cuda, hd, nq, nkv, dtype, tol):
    """K12 over a flat bf16 cache: a chain padded with duplicates, an idle
    row at slot 0, unordered positions with repeats; bf16 and fp32 queries."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    kc = torch.randn(3, 300, nkv, hd, generator=g, device=cuda).to(torch.bfloat16)
    vc = torch.randn(3, 300, nkv, hd, generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randn(3, 5, nq, hd, generator=g, device=cuda).to(dtype)
    pos = torch.tensor([[200, 201, 202, 202, 202], [0, 0, 0, 0, 0], [299, 3, 150, 150, 77]],
                       dtype=torch.int32, device=cuda)
    out = ops.decode_block_attention(q, kc, vc, pos)
    ref = ops.decode_block_attention_reference(q, kc, vc, pos)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
def test_wrappers_count_launches_and_refuse_bad_operands(cuda):
    ops.reset_launch_counts()
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16, device=cuda)
    ops.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())
    assert ops.launch_counts()["flash_attention"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 4, 2, 40, dtype=torch.bfloat16, device=cuda)
        ops.flash_attention(z, z, z)
    assert ops.launch_counts()["flash_attention"] == 1
    kc = torch.zeros(1, 8, 2, 64, dtype=torch.float32, device=cuda)
    kv_len = torch.ones(1, dtype=torch.int32, device=cuda)
    ops.decode_attention(q[:, 0].float().contiguous(), kc, kc, kv_len)
    assert ops.launch_counts()["decode_attention"] == 1
    for qq, cc in ((q[:, 0].contiguous(), kc), (q[:, 0].float().contiguous(), kc.bfloat16())):
        with pytest.raises(ValueError, match="share one dtype"):
            ops.decode_attention(qq, cc, cc, kv_len)
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(q[:, 0].float().contiguous(), kc, kc, kv_len.long())
    assert ops.launch_counts()["decode_attention"] == 1


def _paged_tables(B, kv_len, bs, max_blocks, shared, seed):
    """Rows share ``shared`` leading blocks (a prefix), then own shuffled
    blocks; unused entries hold 0. Returns (tables, pool blocks needed)."""
    own = [-(-int(n) // bs) - shared for n in kv_len]
    ids = (torch.randperm(sum(own), generator=torch.Generator().manual_seed(seed))
           + 1 + shared).tolist()
    tables = torch.zeros((B, max_blocks), dtype=torch.int32)
    for b in range(B):
        row = list(range(1, 1 + shared)) + ids[:own[b]]
        ids = ids[own[b]:]
        tables[b, :len(row)] = torch.tensor(row, dtype=torch.int32)
    return tables, 1 + shared + sum(own)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)])
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_paged_kernels_match_plain(cuda, bs, dtype, tol):
    """K6 and K7 at the batch phase's shapes (32 rows, 32/4 heads of 64,
    ragged kv_len 900-1050 over a shared 768-token prefix) at every block
    size the engine or the JAX tests use; q bf16 or fp32, the pool bf16.
    A row with kv_len 0 (K6) or no valid position (K7) gets zeros."""
    g = torch.Generator(device=cuda).manual_seed(bs)
    B, nq, nkv, hd = 32, 32, 4, 64
    lens = torch.randint(900, 1051, (B,), generator=torch.Generator().manual_seed(bs))
    tables, n = _paged_tables(B, lens, bs, -(-1100 // bs), 768 // bs, bs)
    tables = tables.to(cuda)
    kp = torch.randn(2, n, bs, nkv, hd, generator=g, device=cuda).to(torch.bfloat16)
    vp = torch.randn(2, n, bs, nkv, hd, generator=g, device=cuda).to(torch.bfloat16)
    kv_len = lens.to(torch.int32).to(cuda)
    kv_len[5] = 0
    q = torch.randn(B, nq, hd, generator=g, device=cuda).to(dtype)
    out = ops.paged_attention(q, kp, vp, tables, kv_len, 1)
    ref = ops.paged_attention_reference(q, kp, vp, tables, kv_len, 1)
    assert out.dtype == dtype and bool((out[5] == 0).all())
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    chain = torch.randint(0, 9, (B,), generator=g, device=cuda)
    iw = torch.arange(9, device=cuda)[None, :]
    qpos = (lens.to(cuda)[:, None] - 10 + torch.minimum(iw, chain[:, None])).to(torch.int32)
    qpos[7] = torch.tensor([300, 2, 900, 900, 0, 1040, 13, 128, 127], device=cuda)
    qpos[9] = -1
    q9 = torch.randn(B, 9, nq, hd, generator=g, device=cuda).to(dtype)
    out = ops.paged_block_attention(q9, kp, vp, tables, qpos, 0)
    ref = ops.paged_block_attention_reference(q9, kp, vp, tables, qpos, 0)
    assert bool((out[9] == 0).all())
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
def test_paged_wrappers_count_launches_and_refuse_bad_operands(cuda):
    ops.reset_launch_counts()
    kp = torch.zeros(1, 4, 16, 2, 64, dtype=torch.bfloat16, device=cuda)
    tables = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    q = torch.zeros(1, 8, 64, dtype=torch.bfloat16, device=cuda)
    kv_len = torch.tensor([20], dtype=torch.int32, device=cuda)
    ops.paged_attention(q, kp, kp, tables, kv_len, 0)
    ops.paged_block_attention(q[:, None].contiguous(), kp, kp, tables, kv_len[:, None], 0)
    assert ops.launch_counts()["paged_attention"] == 1
    assert ops.launch_counts()["paged_block_attention"] == 1
    with pytest.raises(ValueError, match="bfloat16"):
        ops.paged_attention(q, kp.float(), kp.float(), tables, kv_len, 0)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention(q, kp, kp, tables.long(), kv_len, 0)
    with pytest.raises(ValueError, match="layer"):
        ops.paged_attention(q, kp, kp, tables, kv_len, 1)
    assert ops.launch_counts()["paged_attention"] == 1


# ---------------------------------------------------------------- quantized KV

# the head dims the engines use, each with its own heads: test-tiny,
# the distilled checkpoint (an int4 head row of 24 bytes) and tinyllama-1.1b
QUANT_SHAPES = [(32, 4, 2), (48, 4, 2), (64, 32, 4)]


def _quant_pool(g, shape, tier):
    """Random float32 k and v quantized as the engine stores them:
    (values, scales) each."""
    kv = [quantize_kv(torch.randn(*shape, generator=g, device=g.device), tier) for _ in range(2)]
    return kv[0][0], kv[1][0], kv[0][1], kv[1][1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)])
@pytest.mark.parametrize("hd,nq,nkv", QUANT_SHAPES)
@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quant_paged_kernels_match_plain(cuda, tier, hd, nq, nkv, dtype, tol):
    """K8 and K9 over the quantized pool (blocks of 16 and 128, a shared
    prefix, ragged kv_len) against their plain versions, which dequantize to
    fp32: the kernels' tiles hold the same exact products, so only the sums'
    order and the output rounding differ."""
    bits = 8 if tier == "int8" else 4
    for bs in (16, 128):
        g = torch.Generator(device=cuda).manual_seed(hd + bs)
        B = 8
        lens = torch.randint(200, 400, (B,), generator=torch.Generator().manual_seed(bs))
        tables, n = _paged_tables(B, lens, bs, -(-420 // bs), 128 // bs, bs)
        tables = tables.to(cuda)
        kp, vp, ks, vs = _quant_pool(g, (2, n, bs, nkv, hd), tier)
        kv_len = lens.to(torch.int32).to(cuda)
        kv_len[3] = 0
        q = torch.randn(B, nq, hd, generator=g, device=cuda).to(dtype)
        out = ops.paged_attention_quant(q, kp, vp, ks, vs, tables, kv_len, 1, bits=bits)
        ref = ops.paged_attention_quant_reference(q, kp, vp, ks, vs, tables, kv_len, 1,
                                                  bits=bits)
        assert out.dtype == dtype and bool((out[3] == 0).all())
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        chain = torch.randint(0, 9, (B,), generator=g, device=cuda)
        iw = torch.arange(9, device=cuda)[None, :]
        qpos = (lens.to(cuda)[:, None] - 10 + torch.minimum(iw, chain[:, None])).to(torch.int32)
        qpos[2] = torch.tensor([150, 2, 190, 190, 0, 199, 13, 128, 127], device=cuda)
        qpos[5] = -1
        q9 = torch.randn(B, 9, nq, hd, generator=g, device=cuda).to(dtype)
        out = ops.paged_block_attention_quant(q9, kp, vp, ks, vs, tables, qpos, 0, bits=bits)
        ref = ops.paged_block_attention_quant_reference(q9, kp, vp, ks, vs, tables, qpos, 0,
                                                        bits=bits)
        assert bool((out[5] == 0).all())
        torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)])
@pytest.mark.parametrize("hd,nq,nkv", QUANT_SHAPES)
@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_decode_attention_quant_matches_plain(cuda, tier, hd, nq, nkv, dtype, tol):
    """K10 on a dense quantized cache: S not a multiple of the tile, kv_len
    0 (zeros), 1, ragged and S."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    S = 300
    kc, vc, ks, vs = _quant_pool(g, (4, S, nkv, hd), tier)
    q = torch.randn(4, nq, hd, generator=g, device=cuda).to(dtype)
    kv_len = torch.tensor([0, 1, 177, S], dtype=torch.int32, device=cuda)
    bits = 8 if tier == "int8" else 4
    out = ops.decode_attention_quant(q, kc, vc, ks, vs, kv_len, bits=bits)
    ref = ops.decode_attention_quant_reference(q, kc, vc, ks, vs, kv_len, bits=bits)
    assert bool((out[0] == 0).all())
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
def test_quant_wrappers_count_launches_and_refuse_bad_operands(cuda):
    ops.reset_launch_counts()
    kp = torch.zeros(1, 4, 16, 2, 32, dtype=torch.int8, device=cuda)
    ks = torch.ones(1, 4, 16, 2, dtype=torch.bfloat16, device=cuda)
    tables = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    q = torch.zeros(1, 8, 64, dtype=torch.bfloat16, device=cuda)
    kv_len = torch.tensor([20], dtype=torch.int32, device=cuda)
    ops.paged_attention_quant(q, kp, kp, ks, ks, tables, kv_len, 0, bits=4)
    ops.paged_block_attention_quant(q[:, None].contiguous(), kp, kp, ks, ks, tables,
                                    kv_len[:, None], 0, bits=4)
    kc = torch.zeros(1, 40, 2, 32, dtype=torch.int8, device=cuda)
    kcs = torch.ones(1, 40, 2, dtype=torch.bfloat16, device=cuda)
    ops.decode_attention_quant(q, kc, kc, kcs, kcs, kv_len, bits=4)
    assert ops.launch_counts()["paged_attention_quant"] == 1
    assert ops.launch_counts()["paged_block_attention_quant"] == 1
    assert ops.launch_counts()["decode_attention_quant"] == 1
    with pytest.raises(ValueError, match="stored width"):
        ops.paged_attention_quant(q, kp, kp, ks, ks, tables, kv_len, 0, bits=8)
    with pytest.raises(ValueError, match="int8"):
        ops.paged_attention_quant(q, kp.bfloat16(), kp.bfloat16(), ks, ks, tables, kv_len, 0,
                                  bits=4)
    with pytest.raises(ValueError, match="head dim"):
        ops.paged_attention_quant(q[..., :16].contiguous(), kp[..., :8].contiguous(),
                                  kp[..., :8].contiguous(), ks, ks, tables, kv_len, 0, bits=4)
    with pytest.raises(ValueError, match="scales"):
        ops.paged_attention_quant(q, kp, kp, ks.float(), ks.float(), tables, kv_len, 0, bits=4)
    assert ops.launch_counts()["paged_attention_quant"] == 1


# K13: |out - ref| <= rtol * |ref| + 2^-16 * sum_k |x_ik| * |w_kj|: each side
# rounds its fp32 sum once (rtol 2^-6 in bf16, 1e-5 in fp32), and the two
# fp32 sums over d run in another order (the tensor-core path adds 16-wide
# partial products), an error that scales with the sum of |terms|
GMM_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
GMM_SUM_TOL = 2.0 ** -16


def _gmm_check(out, ref, x, w_dense, te, tm):
    row_e = torch.repeat_interleave(te.long(), tm)
    mag = torch.stack([x[i].float().abs() @ w_dense[e].float().abs()
                       for i, e in enumerate(row_e.tolist())])
    err = (out.float() - ref.float()).abs()
    allowed = GMM_RTOL[x.dtype] * ref.float().abs() + GMM_SUM_TOL * mag
    assert bool((err <= allowed).all()), float((err / allowed).max())


@pytest.mark.gpu
@pytest.mark.parametrize("tm", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,f", [(256, 384), (72, 96), (68, 100)])
def test_grouped_matmul_matches_plain(cuda, tm, xdt, d, f):
    """Dense bf16 / fp32 weights and the int8 leaf; d and f ragged against
    the 32-deep stage and the 128-column tile, and (68, 100) off the
    16-byte vector width; the int8 leaf bit for bit the dense form on its
    dequantized values."""
    g = torch.Generator(device=cuda).manual_seed(tm + d)
    E, M = 4, 2 * max(tm, 64)
    x = torch.randn(M, d, generator=g, device=cuda).to(xdt)
    te = torch.randint(0, E, (M // tm,), generator=g, device=cuda, dtype=torch.int32)
    w32 = torch.randn(E, d, f, generator=g, device=cuda) * d ** -0.5
    leaf = {"q": torch.randint(-127, 128, (E, d, f), generator=g, device=cuda,
                               dtype=torch.int8),
            "s": torch.rand(E, 1, f, generator=g, device=cuda) * 0.01 + 1e-3}
    for w in (w32.bfloat16(), w32, leaf):
        dense = ops.dequantize_leaf(w)
        out = ops.grouped_matmul(x, w, te, tm)
        ref = ops.grouped_matmul_reference(x, dense, te, tm)
        assert out.dtype == xdt and out.shape == (M, f)
        _gmm_check(out, ref, x, dense, te, tm)
        if isinstance(w, dict):
            assert torch.equal(out, ops.grouped_matmul(x, dense, te, tm))


@pytest.mark.gpu
def test_grouped_matmul_counts_launches_and_refuses_bad_operands(cuda):
    ops.reset_launch_counts()
    x = torch.zeros(16, 32, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(2, 32, 64, dtype=torch.bfloat16, device=cuda)
    te = torch.zeros(2, dtype=torch.int32, device=cuda)
    ops.grouped_matmul(x, w, te, 8)
    assert ops.launch_counts()["grouped_matmul"] == 1
    with pytest.raises(ValueError, match="power of two"):
        ops.grouped_matmul(x, w, te, 12)
    with pytest.raises(ValueError, match="tile_expert"):
        ops.grouped_matmul(x, w, te.long(), 8)
    with pytest.raises(ValueError, match="leaf"):
        ops.grouped_matmul(x, w.to(torch.int8), te, 8)
    assert ops.launch_counts()["grouped_matmul"] == 1
