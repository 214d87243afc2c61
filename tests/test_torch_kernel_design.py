"""Design choices of the redesigned K1, K2, K3, K5, K7, K9, K10 and K13,
checked on the CPU.

- K3 (``decode_block_attention_layer``), K2 (``decode_attention_layer``),
  K5 (``decode_attention``) and K10 (``decode_attention_quant``) run one
  split-key body: the key range split into chunks picked on the host from
  the shapes alone (``key_chunk``): whole 32-key tiles, at most 64 splits,
  and about two blocks per SM of the H100's 132 when every key is live.
  K5 and K10 at a group of at most 2 put warp sets on key tiles side by
  side (``key_sets``): the sets merge in shared memory, then the splits in
  two levels, each merge in a fixed order. The emulation below repeats that
  order in float32.
- K13 (``grouped_matmul``) splits the depth of the decode step's product
  (tm 8) across blocks, by a count picked on the host from the shapes alone
  (``split_depth``): whole 64-deep stages, at most 8 splits, none at wider
  row tiles.
- K1 (``flash_attention``) runs P.V on bf16 tensor cores. Its probabilities
  enter as three bf16 fragments (hi, mid, lo), together the fp32 p up to
  fp32 rounding. One bf16 rounding of p misses the bf16 tolerance where a
  row's output cancels to near 0; two parts hold the tolerance but leave
  several times as many bf16 outputs one ulp off the plain version's as
  fp32 arithmetic does, which is enough to move bf16 decoding that reads
  the prefix. The emulation below repeats the kernel's rounding of P in
  float64 sums; the card's own check is ``chip_smoke.py``'s kernels phase.
- K7 (``paged_block_attention``) and K9 (``paged_block_attention_quant``)
  with bf16 queries run the paged split body: chunks of whole 64-key tiles
  picked from the shapes (``paged_key_chunk``) so that the engines' rows
  leave at least two live blocks an SM, products on bf16 tensor cores (K9:
  the stored integers, the scales after Q.K^T and before P.V), P in three
  bf16 parts, and the dense bodies' merge. The emulation below repeats that
  arithmetic in float32 with exact products.
- K6 (``paged_attention``) and K8 (``paged_attention_quant``) with bf16
  queries run that body's T = 1 kernel: chunks of whole block steps
  (``paged_t1_chunk``: four warps of 32-key tiles) sized so that the
  engines' rows leave about as many live blocks as fit the card at once,
  each warp taking every 4th tile of its split with its own (m, l, acc),
  the warps merged in order, and at a group of at most 8 P's high and
  middle parts in one 16-row fragment. Its emulation repeats that order.
"""

import numpy as np
import pytest
import torch

from tpu_voice_agent_torch.ops.decode_attention import (
    KEY_SETS,
    MAX_SPLITS,
    MERGE_GROUP,
    H100_SMS,
    PAGED_KEY_SETS,
    PAGED_LIVE_BLOCKS,
    PAGED_T1_TILE,
    PAGED_TILE,
    SPLIT_BLOCKS,
    decode_attention_reference,
    key_chunk,
    key_sets,
    paged_key_chunk,
    paged_t1_blocks_per_sm,
    paged_t1_chunk,
)
from tpu_voice_agent_torch.ops.grammar_mask import (
    ARGMAX_MAX_PER_LANE,
    ARGMAX_MAX_ROWS,
    SMEM_PER_BLOCK,
    argmax_geometry,
    masked_argmax_advance_reference,
    masked_argmax_reference,
)
from tpu_voice_agent_torch.ops.grouped_matmul import MAX_SPLITK, STAGE_DEPTH, split_depth

# chip_smoke.py's bf16 attention tolerance: |out - ref| <= 2^-6 |ref| + 1e-4
ATTN_RTOL, ATTN_ATOL = 2.0 ** -6, 1e-4


@pytest.mark.parametrize("B,S,nkv", [(1, 2048, 4), (1, 2048, 8), (8, 2048, 4), (2, 300, 2),
                                     (1, 96, 2), (3, 700, 2), (1, 1, 1), (1, 100_000, 1),
                                     (32, 2048, 8), (1, 500, 20), (1, 448, 20), (1, 1500, 20)])
def test_key_chunk_is_whole_tiles_and_bounded_splits(B, S, nkv):
    chunk = key_chunk(B, S, nkv)
    splits = -(-S // chunk)
    assert chunk % 32 == 0 and 1 <= splits <= MAX_SPLITS
    # no more blocks than the budget, unless one 32-key tile per split is
    # already the finest split
    assert B * nkv * splits <= SPLIT_BLOCKS or chunk == 32


@pytest.mark.parametrize("nkv,chunk,live", [(4, 32, 120), (8, 64, 120)])
def test_key_chunk_fills_the_card_at_the_main_path_frontier(nkv, chunk, live):
    """One row of tinyllama-1.1b (4 kv heads) or mixtral-8x7b (8) over the
    2048 cache at the parse's frontier (~943): at least 100 live blocks."""
    assert key_chunk(1, 2048, nkv) == chunk
    assert -(-944 // chunk) * nkv == live >= 100


@pytest.mark.parametrize("B,nkv,kv_len,chunk,live", [
    (1, 4, 944, 32, 120),  # tinyllama-1.1b's T = 1 step at the parse's frontier
    (1, 8, 944, 64, 120),  # mixtral-8x7b's
    (8, 4, 2048, 256, 256),  # the dense batcher's 8 rows, every key live
])
def test_key_chunk_at_t1_fills_the_card(B, nkv, kv_len, chunk, live):
    """K2 takes K3's chunk at T = 1: whole tiles, and the live blocks
    (splits holding a key below kv_len, times kv heads and rows) number at
    least 100 on the main path's shapes."""
    assert key_chunk(B, 2048, nkv) == chunk
    assert -(-kv_len // chunk) * nkv * B == live >= 100


@pytest.mark.parametrize("S,nkv,kv_len,chunk,live", [
    (500, 20, 500, 64, 160),  # whisper-large-v3's cross-attention, 20 heads of 64
    (2048, 4, 944, 32, 120),  # K10 at tinyllama-1.1b's dense cache, kv_len 944
])
def test_key_chunk_fills_the_card_at_k5_and_k10(S, nkv, kv_len, chunk, live):
    """K5 and K10 take K2's chunk: at least 100 live blocks at large-v3's
    cross-attention and at K10's tinyllama shape."""
    assert key_chunk(1, S, nkv) == chunk
    assert -(-kv_len // chunk) * nkv == live >= 100


@pytest.mark.parametrize("S,kv_len,chunk,sets", [
    (500, 500, 64, KEY_SETS),  # cross-attention: 8 splits of 2 tiles
    (448, 33, 64, KEY_SETS),  # self-attention, the prompt and 32 tokens: 1 split of 2 tiles
    (1500, 75, 128, KEY_SETS),  # the incremental buffer after three blocks: 1 split of 3 tiles
])
def test_whisper_shapes_take_the_warps_on_keys_body(S, kv_len, chunk, sets):
    """Whisper's group of 1 at hd 64: a split holds more than one tile, so
    the warps take key tiles; the self and incremental shapes' keys lie in
    one split a head, which writes its output itself."""
    assert key_chunk(1, S, 20) == chunk and key_sets(1, chunk, 64) == sets
    assert (kv_len > chunk) == (S == 500)


@pytest.mark.parametrize("group,chunk,hd,sets", [
    (8, 32, 64, 1),  # K10 at tinyllama: one tile a split, 8 rows
    (8, 256, 64, 1),  # 8 rows: one per warp
    (2, 64, 64, KEY_SETS), (4, 64, 64, 1), (1, 64, 16, KEY_SETS), (1, 64, 128, 1),
    (1, 32, 64, 1),
])
def test_key_sets_only_where_warps_idle(group, chunk, hd, sets):
    assert key_sets(group, chunk, hd) == sets


def _merge(entries):
    """The kernels' merge of (m, l, acc) entries in order, float32:
    M = max m, L = sum e^(m - M) l, A = sum e^(m - M) acc."""
    M = np.float32(max((m for m, _, _ in entries), default=np.float32(-1e30)))
    L, A = np.float32(0), np.zeros_like(entries[0][2]) if entries else None
    for m, l, acc in entries:
        e = np.exp(np.float32(m - M), dtype=np.float32)
        L = np.float32(e * l + L)
        A = (e * acc + A).astype(np.float32)
    return M, L, A


def _split_attention(q, k, v, kv_len: int, order_seed: int):
    """One row, MHA (q (H, hd), k / v (S, H, hd), float32) as the split body
    computes it: per split and key set, 32-key tiles with the online
    softmax; the sets merged in set order; one live split writes the
    output, else the last split of each group of 8 to arrive (in an order
    drawn from ``order_seed``) merges its group and the last group merger
    merges the groups, each in index order."""
    H, hd = q.shape
    S = k.shape[0]
    chunk = key_chunk(1, S, H)
    ks = key_sets(1, chunk, hd)
    front = min(kv_len - 1, S - 1)
    live = max(front, 0) // chunk + 1
    scale = np.float32(hd ** -0.5)
    out = np.zeros((H, hd), np.float32)
    rng = np.random.default_rng(order_seed)
    for h in range(H):
        partials = {}
        for split in range(live):
            c0 = split * chunk
            kend = min(c0 + chunk, front + 1)
            sets = []
            for j in range(ks):
                m, l, acc = np.float32(-1e30), np.float32(0), np.zeros(hd, np.float32)
                s0 = c0 + 32 * j
                if front >= s0 and s0 < kend:
                    for t0 in range(s0, kend, 32 * ks):
                        keys = np.arange(t0, t0 + 32)
                        kt = np.where((keys < kend)[:, None], k[np.minimum(keys, S - 1), h], 0)
                        vt = np.where((keys < kend)[:, None], v[np.minimum(keys, S - 1), h], 0)
                        sc = np.where(keys <= front, (kt @ q[h]) * scale, np.float32(-1e30))
                        m_new = np.float32(max(m, sc.max()))
                        p = np.exp(sc - m_new, dtype=np.float32)
                        alpha = np.exp(np.float32(m - m_new), dtype=np.float32)
                        l = np.float32(alpha * l + p.sum(dtype=np.float32))
                        acc = (acc * alpha + p @ vt).astype(np.float32)
                        m = m_new
                sets.append((m, l, acc))
            partials[split] = _merge(sets) if ks > 1 else sets[0]
        if live == 1:
            _, L, A = partials[0]
            out[h] = A / (L if L != 0 else np.float32(1))
            continue
        groups, tickets = {}, {}
        ngroups = -(-live // MERGE_GROUP)
        for split in rng.permutation(live):  # arrival order
            g = split // MERGE_GROUP
            tickets[g] = tickets.get(g, 0) + 1
            if tickets[g] < min(MERGE_GROUP, live - g * MERGE_GROUP):
                continue
            members = range(g * MERGE_GROUP, min(live, (g + 1) * MERGE_GROUP))
            groups[g] = _merge([partials[c] for c in members])
            if len(groups) == ngroups:
                _, L, A = _merge([groups[i] for i in range(ngroups)])
                out[h] = A / (L if L != 0 else np.float32(1))
    return out


@pytest.mark.parametrize("S,kv_len", [(500, 500), (1500, 75), (448, 33), (448, 1), (448, 0)])
def test_split_merge_emulation_matches_plain(S, kv_len):
    """whisper-large-v3's 20 heads of 64: the split body's order of merges
    equals the plain version within chip_smoke.py's bf16 attention
    tolerance (in float32 it is far inside), gives zeros at kv_len 0, and
    gives the same bits for any arrival order of the splits."""
    rng = np.random.default_rng(S + kv_len)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((20, 64), (S, 20, 64), (S, 20, 64)))
    outs = [_split_attention(q, k, v, kv_len, seed) for seed in range(3)]
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
    ref = decode_attention_reference(torch.from_numpy(q)[None], torch.from_numpy(k)[None],
                                     torch.from_numpy(v)[None],
                                     torch.tensor([kv_len], dtype=torch.int32))[0].numpy()
    assert np.all(np.abs(outs[0] - ref) <= ATTN_RTOL * np.abs(ref) + ATTN_ATOL)
    if kv_len == 0:
        assert not outs[0].any()


@pytest.mark.parametrize("M,d,f,tm,E", [
    (72, 14336, 4096, 8, 8),  # mixtral-8x7b decode, down
    (72, 4096, 14336, 8, 8),  # decode, gate / up
    (288, 14336, 4096, 32, 8),  # an ff=8 block, down
    (3072, 4096, 14336, 128, 8),  # the prefix prefill
    (128, 256, 384, 8, 4), (64, 68, 100, 8, 4), (8, 1, 1, 8, 1), (72, 100_000, 128, 8, 8),
    (256, 256, 384, 16, 4),
])
def test_split_depth_is_whole_stages_and_bounded(M, d, f, tm, E):
    chunk = split_depth(M, d, f, tm, E)
    splits = -(-d // chunk)
    assert chunk % STAGE_DEPTH == 0 and chunk >= d / MAX_SPLITK
    assert 1 <= splits <= MAX_SPLITK and (tm == 8 or splits == 1)
    # no split is empty: every one starts below d
    assert (splits - 1) * chunk < d


def test_split_depth_on_the_mixtral_decode_step():
    """The down projection (32 column tiles, 2 live row tiles) runs 8
    splits of 1792: 512 live blocks; gate and up (112 column tiles) 2 of
    2048: 448."""
    assert split_depth(72, 14336, 4096, 8, 8) == 1792
    assert split_depth(72, 4096, 14336, 8, 8) == 2048
    assert split_depth(288, 14336, 4096, 32, 8) == 14336


def _split(p: torch.Tensor, parts: int) -> torch.Tensor:
    """p as the kernel hands it to the tensor cores: ``parts`` bf16 values,
    each the rounding of what the ones before it left (0: p itself)."""
    if parts == 0:
        return p.double()
    out, rest = torch.zeros_like(p, dtype=torch.float64), p
    for _ in range(parts):
        part = rest.bfloat16().float()
        out, rest = out + part.double(), rest - part
    return out


def _causal_head(rng, T: int, hd: int):
    """bf16-valued q, k, v of one head; the plain version's bf16 output;
    the fp32 scores' probabilities and their row sums."""
    q, k, v = (torch.from_numpy(rng.standard_normal((T, hd)).astype(np.float32))
               .bfloat16().float() for _ in range(3))
    s = (q @ k.T) * hd ** -0.5
    s = torch.where(torch.ones(T, T, dtype=torch.bool).tril(), s, torch.full_like(s, -1e30))
    ref = (torch.softmax(s, -1) @ v).bfloat16().float()
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    return v, ref, p, p.sum(-1, keepdim=True)


def test_flash_attention_p_in_three_bf16_parts():
    """Four causal heads of 512 tokens, hd 64. Each variant's output: the
    products of P's parts and bf16 V summed in float64, over the fp32 row
    sum, rounded to bf16; 0 parts is exact fp32 p (the first kernel's
    arithmetic)."""
    rng = np.random.default_rng(0)
    worst = dict.fromkeys(range(4), 0.0)
    off = dict.fromkeys(range(4), 0)  # bf16 outputs off the plain version's
    for _ in range(4):
        v, ref, p, rowsum = _causal_head(rng, 512, 64)
        for parts in worst:
            out = ((_split(p, parts) @ v.double()) / rowsum.double()).float().bfloat16().float()
            err = (out - ref).abs()
            worst[parts] = max(worst[parts],
                               float((err / (ATTN_RTOL * ref.abs() + ATTN_ATOL)).max()))
            off[parts] += int((out != ref).sum())
    # one bf16 rounding of p misses the tolerance; more parts hold it
    assert worst[1] > 1.0 and max(worst[2], worst[3]) <= 1.0
    # three parts leave no more outputs off the plain version's than exact
    # fp32 p does; two parts leave several times as many
    assert off[3] <= 1.5 * off[0] + 5 and off[2] > 3 * off[0]


# ------------------------------------------------- K7 / K9's paged split body

# frontiers of the paged engines' rows: the 879-token prompt prefix plus up to
# ~170 tokens of a parse, in tables of 2,048 positions (16 blocks of 128)
PAGED_FRONTIERS = (880, 1050)


@pytest.mark.parametrize("B,nkv", [
    (32, 4),  # the 32-slot batch drains (ff=8 and spec): tinyllama-1.1b
    (15, 4),  # the 15-slot paged spec engine
    (8, 8),  # mixtral-8x7b's 8-slot paged drain
])
def test_paged_key_chunk_fills_the_card_at_the_path_frontiers(B, nkv):
    """The paged picker, from the shapes alone: whole 64-key tiles, at most
    64 splits, and at least two live blocks an SM (splits holding a key the
    row sees, times kv heads and rows) wherever the rows' frontiers lie in
    the engines' range, the lowest frontier included."""
    S = 2048
    chunk = paged_key_chunk(B, S, nkv)
    splits = -(-S // chunk)
    assert chunk % PAGED_TILE == 0 and 1 <= splits <= MAX_SPLITS
    for front in PAGED_FRONTIERS:
        assert B * nkv * (front // chunk + 1) >= PAGED_LIVE_BLOCKS
    # the split-key picker of the dense bodies left 128 live blocks at the
    # batch's frontiers: one wave of 132 SMs
    if B == 32:
        assert B * nkv * (PAGED_FRONTIERS[0] // key_chunk(B, S, nkv) + 1) == 128
        assert chunk == 320 and splits == 7


@pytest.mark.parametrize("B,S,nkv", [(1, 32, 2), (4, 320, 2), (4, 1280, 2), (1, 100_000, 1),
                                     (8, 1, 1), (64, 2048, 4), (1, 2048, 4)])
def test_paged_key_chunk_is_whole_tiles_and_bounded(B, S, nkv):
    chunk = paged_key_chunk(B, S, nkv)
    assert chunk % PAGED_TILE == 0 and chunk >= PAGED_TILE
    assert -(-S // chunk) <= MAX_SPLITS


def _bf16_parts(x: np.ndarray, parts: int = 3) -> np.ndarray:
    """float32 ``x`` as the sum of ``parts`` bf16 values, each the rounding
    of what the ones before it left (csrc/mma.cuh split3_bf16), in float64."""
    out, rest = np.zeros(x.shape, np.float64), torch.from_numpy(x.astype(np.float32))
    for _ in range(parts):
        part = rest.bfloat16().float()
        out, rest = out + part.double().numpy(), rest - part
    return out


def _paged_split_emulation(q, k_rows, v_rows, k_scale, v_scale, tables, qpos, bs):
    """The paged split body's arithmetic (csrc/paged_split.cuh), one
    (batch row, kv head) at a time: q (B, T, nq, hd) bf16 values; k_rows /
    v_rows (N * bs, nkv, hd) the pool plane as the products take it (bf16
    values, or the stored integers of a quantized pool), k_scale / v_scale
    (N * bs, nkv) or None. Per split of ``paged_key_chunk`` keys and 64-key
    tile: S = Q K^T (exact products, float32 sum), times the key's scale
    after the sum and the softmax scale; the online softmax in float32; P (K9:
    p * vs) as three bf16 parts against V, the tile's P.V summed from 0 and
    added to the running output; the splits' partials merged in index order
    (groups of 8, then the groups), A / (L or 1)."""
    B, T, nq, hd = q.shape
    nkv = k_rows.shape[1]
    group, rows = nq // nkv, T * q.shape[2] // nkv
    S = tables.shape[1] * bs
    chunk = paged_key_chunk(B, S, nkv)
    scale = np.float32(hd ** -0.5)
    out = np.zeros((B, T, nq, hd), np.float32)
    for b in range(B):
        pool_row = [int(tables[b, s // bs]) * bs + s % bs for s in range(S)]
        for kvh in range(nkv):
            qh = np.stack([q[b, r // group, kvh * group + r % group] for r in range(rows)])
            fr = np.array([min(int(qpos[b, r // group]), S - 1) for r in range(rows)])
            max_pos = int(fr.max())
            live = max(max_pos, 0) // chunk + 1
            partials = []
            for split in range(live):
                c0 = split * chunk
                kend = min(c0 + chunk, S, max_pos + 1)
                m = np.full(rows, -1e30, np.float32)
                l = np.zeros(rows, np.float32)
                acc = np.zeros((rows, hd), np.float32)
                for k0 in range(c0, kend, 64):
                    keys = np.arange(k0, min(k0 + 64, kend))
                    pr = [pool_row[s] for s in keys]
                    kt, vt = k_rows[pr, kvh].astype(np.float64), v_rows[pr, kvh].astype(np.float64)
                    s = (qh.astype(np.float64) @ kt.T).astype(np.float32)
                    if k_scale is not None:
                        s = s * k_scale[pr, kvh][None, :]
                    s = np.where(keys[None, :] <= fr[:, None], s * scale, np.float32(-1e30))
                    m_new = np.maximum(m, s.max(axis=1))
                    p = np.exp(s - m_new[:, None], dtype=np.float32)
                    alpha = np.exp(m - m_new, dtype=np.float32)
                    l = (alpha * l + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
                    if v_scale is not None:
                        p = (p * v_scale[pr, kvh][None, :]).astype(np.float32)
                    tile = (_bf16_parts(p) @ vt).astype(np.float32)
                    acc = (acc.astype(np.float64) * alpha[:, None] + tile).astype(np.float32)
                    m = m_new
                partials.append((m, l, acc, fr >= c0))
            for r in range(rows):
                mine = [(pm[r], pl[r], pa[r]) for pm, pl, pa, act in partials if act[r]]
                if len(mine) > MERGE_GROUP:
                    mine = [_merge(mine[i:i + MERGE_GROUP])
                            for i in range(0, len(mine), MERGE_GROUP)]
                _, L, A = _merge(mine) if mine else (0, np.float32(0), np.zeros(hd, np.float32))
                out[b, r // group, kvh * group + r % group] = A / (L if L != 0 else np.float32(1))
    return out


def _paged_case(rng, bs: int, max_blocks: int, B: int = 4, T: int = 9):
    """A pool plane shared by B rows: a 64-key prefix every row shares, then
    ragged own blocks in a shuffled order; the positions [cur, chain...]
    padded with duplicates (chain_block), row 0 keyless (-1)."""
    S = max_blocks * bs
    fronts = rng.integers(70, S - 1, size=B)
    shared = 64 // bs if bs <= 64 else 0
    own = [-(-(int(f) + 1) // bs) - shared for f in fronts]
    ids = list(1 + shared + rng.permutation(sum(own)))
    tables = np.zeros((B, max_blocks), np.int32)
    for b in range(B):
        row = list(range(1, 1 + shared)) + ids[:own[b]]
        ids = ids[own[b]:]
        tables[b, :len(row)] = row
    n_blocks = 1 + shared + sum(own)
    chains = rng.integers(0, T, size=B)
    qpos = np.array([[f - chains[b] + min(i, chains[b]) for i in range(T)]
                     for b, f in enumerate(fronts)], np.int32)
    qpos[0] = -1
    return tables, qpos, n_blocks


@pytest.mark.parametrize("bs,max_blocks", [(16, 20), (128, 3), (128, 10)])
@pytest.mark.parametrize("tier", [None, "int8", "int4"])
def test_paged_split_emulation_matches_plain(bs, max_blocks, tier):
    """K7 (bf16 pool) and K9 (int8 / int4 pools) with bf16 queries: the
    split body's arithmetic, emulated in float32 with exact products, holds
    chip_smoke.py's bf16 tolerance against paged_block_attention_reference
    and paged_block_attention_quant_reference on small pools at bs 16 and
    128 (5 to 20 splits, so the two-level merge too), a shared prefix, ragged
    chains and a keyless row, which gets zeros."""
    from tpu_voice_agent_torch.ops import (
        paged_block_attention_quant_reference,
        paged_block_attention_reference,
    )
    from tpu_voice_agent_torch.ops.kvquant import dequantize_kv, quantize_kv

    rng = np.random.default_rng(bs + max_blocks + (0 if tier is None else len(tier)))
    B, T, nq, nkv, hd = 4, 9, 8, 2, 64
    tables, qpos, N = _paged_case(rng, bs, max_blocks, B, T)
    q = torch.from_numpy(rng.standard_normal((B, T, nq, hd)).astype(np.float32)).bfloat16()
    kv = [torch.from_numpy(rng.standard_normal((1, N, bs, nkv, hd)).astype(np.float32))
          for _ in range(2)]
    t_tables, t_qpos = torch.from_numpy(tables), torch.from_numpy(qpos)
    if tier is None:
        kp, vp = (x.bfloat16() for x in kv)
        ref = paged_block_attention_reference(q, kp, vp, t_tables, t_qpos, 0)
        rows = [x[0].reshape(N * bs, nkv, hd).float().numpy() for x in (kp, vp)]
        scales = [None, None]
    else:
        (kp, ks), (vp, vs) = (quantize_kv(x, tier) for x in kv)
        ref = paged_block_attention_quant_reference(q, kp, vp, ks, vs, t_tables, t_qpos, 0,
                                                    bits=8 if tier == "int8" else 4)
        # the products take the stored integers; the scales come after
        ones = torch.ones(1, N, bs, nkv)
        rows = [dequantize_kv(x, ones, tier, torch.float32)[0].reshape(N * bs, nkv, hd).numpy()
                for x in (kp, vp)]
        assert all(np.array_equal(r, np.round(r)) and np.abs(r).max() <= 127 for r in rows)
        scales = [x[0].reshape(N * bs, nkv).float().numpy() for x in (ks, vs)]
    out = _paged_split_emulation(q.float().numpy(), *rows, *scales, tables, qpos, bs)
    out = torch.from_numpy(out).bfloat16().float().numpy()
    ref = ref.float().numpy()
    assert not out[0].any() and not ref[0].any()
    assert np.all(np.abs(out - ref) <= ATTN_RTOL * np.abs(ref) + ATTN_ATOL)
    # far inside it: the emulation's float32 sums round a few bf16 outputs
    # one ulp off the plain version's, not more
    assert float(np.mean(out != ref)) < 0.02


# ------------------------------------------------- K6 / K8's T = 1 body


@pytest.mark.parametrize("B,nkv,hd", [
    (32, 4, 64),  # the 32-slot fast-forward-0 drains: tinyllama-1.1b
    (15, 4, 64),  # the 15-slot paged spec engine's T = 1 steps
    (8, 8, 128),  # mixtral-8x7b's 8-slot paged drain
])
def test_paged_t1_chunk_fills_the_card_at_the_path_frontiers(B, nkv, hd):
    """The T = 1 picker, from the shapes alone: whole block steps (four
    warps of 32-key tiles), at most 64 splits, and at the engines'
    frontiers at least one live block an SM; at half-full tables, and (at
    the 32-slot batch) at every frontier, no more blocks than fit the card
    at once at this head dim, so that a step runs in one wave."""
    S = 2048
    chunk = paged_t1_chunk(B, S, nkv, hd)
    assert chunk % (PAGED_KEY_SETS * PAGED_T1_TILE) == 0 and chunk % PAGED_TILE == 0
    assert -(-S // chunk) <= MAX_SPLITS
    fits = paged_t1_blocks_per_sm(hd) * H100_SMS
    assert B * nkv * ((S // 2 - 1) // chunk + 1) <= fits
    for front in PAGED_FRONTIERS:
        live = B * nkv * (front // chunk + 1)
        assert live >= H100_SMS
        if B == 32:
            assert live <= fits
    # the T = 1 step has 1/9 of the (32, 9) step's arithmetic: its splits
    # are wider than K7's at the batch, and far more blocks live than K6's
    # old one block a (row, kv head)
    if B == 32:
        assert chunk == 384 and chunk > paged_key_chunk(B, S, nkv)


@pytest.mark.parametrize("B,S,nkv,hd", [(1, 32, 2, 64), (4, 320, 2, 32), (4, 1280, 2, 48),
                                        (1, 100_000, 1, 64), (8, 1, 1, 16),
                                        (64, 2048, 4, 64), (32, 8192, 8, 128)])
def test_paged_t1_chunk_is_whole_steps_and_bounded(B, S, nkv, hd):
    chunk = paged_t1_chunk(B, S, nkv, hd)
    assert chunk % (PAGED_KEY_SETS * PAGED_T1_TILE) == 0 and chunk % PAGED_TILE == 0
    assert -(-S // chunk) <= MAX_SPLITS


def _paged_t1_emulation(q, k_rows, v_rows, k_scale, v_scale, tables, kv_len, bs):
    """The T = 1 body's arithmetic (csrc/paged_split.cuh paged_t1_kernel),
    one (batch row, kv head) at a time: q (B, nq, hd) bf16 values, the pool
    plane and scales as ``_paged_split_emulation`` takes them. Per split of
    ``paged_t1_chunk`` keys, warp w of PAGED_KEY_SETS takes the 32-key tiles
    w, w + 4, ... with its own online softmax (float32, exact products);
    a tile's P.V: at a group of at most 8 the low and high parts in one
    accumulator and the middle part in the other (the 16-row fragment's
    upper rows), the two summed after the last tile; otherwise the three
    parts in one. The warps merge in order, then the splits (groups of 8,
    then the groups), A / (L or 1); one live split writes the output."""
    B, nq, hd = q.shape
    nkv = k_rows.shape[1]
    group = nq // nkv
    pack = group <= 8
    S = tables.shape[1] * bs
    chunk = paged_t1_chunk(B, S, nkv, hd)
    scale = np.float32(hd ** -0.5)
    out = np.zeros((B, nq, hd), np.float32)
    for b in range(B):
        pool_row = [int(tables[b, s // bs]) * bs + s % bs for s in range(S)]
        fr = min(int(kv_len[b]) - 1, S - 1)
        live = max(fr, 0) // chunk + 1
        for kvh in range(nkv):
            qh = q[b, kvh * group:(kvh + 1) * group].astype(np.float64)
            splits = []
            for split in range(live):
                c0 = split * chunk
                kend = min(c0 + chunk, S, fr + 1)
                tiles = list(range(c0, kend, PAGED_T1_TILE))
                warps = []
                for w in range(PAGED_KEY_SETS):
                    m = np.full(group, -1e30, np.float32)
                    l = np.zeros(group, np.float32)
                    acc = [np.zeros((group, hd), np.float32) for _ in range(2)]
                    for k0 in tiles[w::PAGED_KEY_SETS]:
                        keys = np.arange(k0, min(k0 + PAGED_T1_TILE, kend))
                        pr = [pool_row[s] for s in keys]
                        kt, vt = (k_rows[pr, kvh].astype(np.float64),
                                  v_rows[pr, kvh].astype(np.float64))
                        s = (qh @ kt.T).astype(np.float32)
                        if k_scale is not None:
                            s = s * k_scale[pr, kvh][None, :]
                        s = (s * scale).astype(np.float32)
                        m_new = np.maximum(m, s.max(axis=1))
                        p = np.exp(s - m_new[:, None], dtype=np.float32)
                        alpha = np.exp(m - m_new, dtype=np.float32)
                        l = (alpha * l + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
                        if v_scale is not None:
                            p = (p * v_scale[pr, kvh][None, :]).astype(np.float32)
                        if pack:
                            hi = _bf16_parts(p, 1)
                            mid = _bf16_parts(p, 2) - hi
                            lo = _bf16_parts(p, 3) - hi - mid
                            tiles_pv = [((lo @ vt).astype(np.float32) + hi @ vt).astype(
                                np.float32), (mid @ vt).astype(np.float32)]
                        else:
                            tiles_pv = [(_bf16_parts(p) @ vt).astype(np.float32),
                                        np.zeros((group, hd), np.float32)]
                        acc = [(a.astype(np.float64) * alpha[:, None] + t).astype(np.float32)
                               for a, t in zip(acc, tiles_pv)]
                        m = m_new
                    warps.append((m, l, (acc[0] + acc[1]).astype(np.float32)))
                merged = [_merge([(wm[r], wl[r], wa[r]) for wm, wl, wa in warps])
                          for r in range(group)]
                splits.append(merged)
            for r in range(group):
                mine = [sp[r] for sp in splits]
                if len(mine) > MERGE_GROUP:
                    mine = [_merge(mine[i:i + MERGE_GROUP])
                            for i in range(0, len(mine), MERGE_GROUP)]
                _, L, A = _merge(mine) if len(mine) > 1 else mine[0]
                out[b, kvh * group + r] = A / (L if L != 0 else np.float32(1))
    return out


@pytest.mark.parametrize("bs,max_blocks,nq", [(16, 20, 8), (128, 10, 8), (16, 20, 32)])
@pytest.mark.parametrize("tier", [None, "int8", "int4"])
def test_paged_t1_emulation_matches_plain(bs, max_blocks, nq, tier):
    """K6 (bf16 pool) and K8 (int8 / int4 pools) with bf16 queries: the T = 1
    body's arithmetic, emulated in float32 with exact products, holds
    chip_smoke.py's bf16 tolerance against paged_attention_reference and
    paged_attention_quant_reference at bs 16 and 128 (up to 10 splits of
    128 keys, so the two-level merge too), groups of 4 (P's parts packed)
    and 16, a shared prefix, ragged kv_len, a row at kv_len 0 (zeros) and
    one at kv_len 1."""
    from tpu_voice_agent_torch.ops import (
        paged_attention_quant_reference,
        paged_attention_reference,
    )
    from tpu_voice_agent_torch.ops.kvquant import dequantize_kv, quantize_kv

    rng = np.random.default_rng(7 * bs + max_blocks + nq + (0 if tier is None else len(tier)))
    B, nkv, hd = 4, 2, 64
    tables, qpos, N = _paged_case(rng, bs, max_blocks, B, 1)
    kv_len = qpos[:, 0] + 1
    kv_len[0], kv_len[1] = 0, 1
    q = torch.from_numpy(rng.standard_normal((B, nq, hd)).astype(np.float32)).bfloat16()
    kv = [torch.from_numpy(rng.standard_normal((1, N, bs, nkv, hd)).astype(np.float32))
          for _ in range(2)]
    t_tables, t_len = torch.from_numpy(tables), torch.from_numpy(kv_len.astype(np.int32))
    if tier is None:
        kp, vp = (x.bfloat16() for x in kv)
        ref = paged_attention_reference(q, kp, vp, t_tables, t_len, 0)
        rows = [x[0].reshape(N * bs, nkv, hd).float().numpy() for x in (kp, vp)]
        scales = [None, None]
    else:
        (kp, ks), (vp, vs) = (quantize_kv(x, tier) for x in kv)
        ref = paged_attention_quant_reference(q, kp, vp, ks, vs, t_tables, t_len, 0,
                                              bits=8 if tier == "int8" else 4)
        ones = torch.ones(1, N, bs, nkv)
        rows = [dequantize_kv(x, ones, tier, torch.float32)[0].reshape(N * bs, nkv, hd).numpy()
                for x in (kp, vp)]
        scales = [x[0].reshape(N * bs, nkv).float().numpy() for x in (ks, vs)]
    out = _paged_t1_emulation(q.float().numpy(), *rows, *scales, tables, kv_len, bs)
    out = torch.from_numpy(out).bfloat16().float().numpy()
    ref = ref.float().numpy()
    assert not out[0].any() and not ref[0].any()
    assert np.all(np.abs(out - ref) <= ATTN_RTOL * np.abs(ref) + ATTN_ATOL)
    assert float(np.mean(out != ref)) < 0.02


# ------------------------------------------------- K4 / K11's warp-a-row body


@pytest.mark.parametrize("V", [1, 32, 33, 128, 129, 300, 619, 640, 768, 769, 1500, 4096])
@pytest.mark.parametrize("R", [1, 5, 8, 32, 160])
def test_argmax_geometry_covers_v_and_bounds_the_block(R, V):
    """Elements a lane: the least multiple of 4 whose 32 lanes cover V, or
    the strided loop (0) past the unrolled cap; rows a block within the
    kernel's 8 warps, and K4's table rows at the intent grammar's 310
    classes within a block's shared memory."""
    rows, per_lane = argmax_geometry(R, V)
    assert 1 <= rows <= ARGMAX_MAX_ROWS and 4 * 310 * rows <= SMEM_PER_BLOCK
    if V <= 32 * ARGMAX_MAX_PER_LANE:
        assert per_lane % 4 == 0 and 32 * (per_lane - 4) < V <= 32 * per_lane
    else:
        assert per_lane == 0


@pytest.mark.parametrize("R", [1, 5, 8, 32, 160])
def test_argmax_geometry_fills_the_card(R):
    """The path's row counts (the one-slot parse, the (1, 5) verify block,
    the MoE drain, the batch chunk, the (32, 5) verify block) at the intent
    grammar's V and C: every row its own warp in one wave, no SM given two
    blocks; 2 rows a block up to 8 rows, 4 above (the timed best)."""
    rows, per_lane = argmax_geometry(R, 619)
    blocks = -(-R // rows)
    assert per_lane == 20 and blocks * rows >= R and blocks <= H100_SMS
    assert rows == (2 if R <= 8 else 4)


def _warp_argmax_emulation(logits, state, mask, table, col_id, tie_by_lane=False):
    """The warp-a-row body (csrc/grammar_mask.cu argmax_warp_kernel) in
    numpy, over all rows at once: lane l takes elements l, l + 32, ... in
    index order and keeps its first best (strict >, from (-inf, INT_MAX));
    then the xor-shuffle tree on (value, index, class), a pair beating
    another by (value desc, index asc); lane 0's pick, token 0 with its
    class where nothing beat -inf; the next state from the state's table
    row. ``tie_by_lane`` breaks equal values by lane instead (a slip the
    tests must catch). Returns (tok, next)."""
    R, V = logits.shape
    st = np.maximum(state, 0)
    N = -(-V // 32)
    mrows = mask[st]
    lanes = np.arange(32)
    best = np.full((R, 32), -np.inf, np.float32)
    idx = np.full((R, 32), np.iinfo(np.int32).max, np.int64)
    cls = np.zeros((R, 32), np.int64)
    for k in range(N):
        v = lanes + 32 * k
        ok = v < V
        vc = np.minimum(v, V - 1)
        s = np.where(mrows[:, vc], logits[:, vc], np.float32(-1e30))
        take = ok & (s > best)
        best = np.where(take, s, best)
        idx = np.where(take, v, idx)
        cls = np.where(take, col_id[vc], cls)
    for o in (16, 8, 4, 2, 1):
        p = lanes ^ o
        ov, oi, oc = best[:, p], idx[:, p], cls[:, p]
        tie = (p < lanes) if tie_by_lane else (oi < idx)
        win = (ov > best) | ((ov == best) & tie)
        best, idx, cls = (np.where(win, a, b) for a, b in ((ov, best), (oi, idx), (oc, cls)))
    none = idx[:, 0] == np.iinfo(np.int32).max
    tok = np.where(none, 0, idx[:, 0])
    nxt = table[st, np.where(none, col_id[0], cls[:, 0])]
    return tok.astype(np.int32), nxt.astype(np.int32)


@pytest.fixture(scope="module")
def intent_tables():
    from tpu_voice_agent_torch.grammar import build_intent_fsm

    fsm = build_intent_fsm()[1]
    t = fsm.device_tables()
    return t.dense_mask.numpy(), t.table.numpy(), t.col_id.numpy()


def _intent_rows(mask, rng, states):
    """Seeded logits over the intent grammar's states, every 8th row a case:
    a tie of two legal tokens in different lanes, the later lane holding the
    lower index (a lane-order slip picks the other), a constant row, a row of
    -inf logits, a NaN row, a dead state (-1), an all-masked state."""
    R, V = len(states), mask.shape[1]
    logits = rng.standard_normal((R, V)).astype(np.float32)
    state = np.array(states, np.int32)
    nan = np.zeros(R, bool)
    empty = np.flatnonzero(~mask.any(axis=1))
    for i in range(0, R, 8):
        case = (i // 8) % 6
        legal = np.flatnonzero(mask[max(state[i], 0)])
        pair = [(a, b) for a in legal[:64] for b in legal[:64] if a < b and a % 32 > b % 32]
        if case == 0 and pair:
            logits[i, list(pair[0])] = 9.0
        elif case == 1:
            logits[i] = 0.5
        elif case == 2:
            logits[i] = -np.inf
        elif case == 3:
            logits[i, ::3] = np.nan
            nan[i] = True
        elif case == 4:
            state[i] = -1
        elif case == 5 and len(empty):
            state[i] = empty[0]
    return logits, state, nan


def test_warp_argmax_emulation_matches_plain_on_the_intent_grammar(intent_tables):
    """The warp-a-row order equals K4's and K11's plain versions on every
    state of the real grammar (35,449 states, V 619, C 310): ties, -inf, dead
    and all-masked rows included; on NaN rows it equals the plain version
    with NaN read as -inf (a NaN never wins)."""
    mask, table, col_id = intent_tables
    S = mask.shape[0]
    rng = np.random.default_rng(12)
    logits, state, nan = _intent_rows(mask, rng, range(S))
    tok, nxt = _warp_argmax_emulation(logits, state, mask, table, col_id)
    args = [torch.from_numpy(a) for a in (logits, state, mask, table, col_id)]
    rtok, rnxt = masked_argmax_advance_reference(*args)
    keep = ~nan
    np.testing.assert_array_equal(tok[keep], rtok.numpy()[keep])
    np.testing.assert_array_equal(nxt[keep], rnxt.numpy()[keep])
    np.testing.assert_array_equal(tok[keep], masked_argmax_reference(*args[:3]).numpy()[keep])
    args[0] = torch.from_numpy(np.where(np.isnan(logits), -np.inf, logits).astype(np.float32))
    ntok, nnxt = masked_argmax_advance_reference(*args)
    np.testing.assert_array_equal(tok[nan], ntok.numpy()[nan])
    np.testing.assert_array_equal(nxt[nan], nnxt.numpy()[nan])


def test_warp_argmax_emulation_catches_a_lane_order_tie_slip(intent_tables):
    """The tied rows above have the power to catch a tie broken by lane."""
    mask, table, col_id = intent_tables
    rng = np.random.default_rng(13)
    logits, state, _ = _intent_rows(mask, rng, range(0, 4096))
    tok, _ = _warp_argmax_emulation(logits, state, mask, table, col_id)
    slip, _ = _warp_argmax_emulation(logits, state, mask, table, col_id, tie_by_lane=True)
    assert (tok != slip).sum() > 0
