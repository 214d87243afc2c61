"""Design choices of the redesigned K1, K2, K3, K5, K10 and K13, checked on
the CPU.

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
"""

import numpy as np
import pytest
import torch

from tpu_voice_agent_torch.ops.decode_attention import (
    KEY_SETS,
    MAX_SPLITS,
    MERGE_GROUP,
    SPLIT_BLOCKS,
    decode_attention_reference,
    key_chunk,
    key_sets,
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
