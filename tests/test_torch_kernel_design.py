"""Design choices of the redesigned K1, K2, K3 and K13, checked on the CPU.

- K3 (``decode_block_attention_layer``) and K2 (``decode_attention_layer``,
  the same body at T = 1) split the key range into chunks picked on the
  host from the shapes alone (``key_chunk``): whole 32-key tiles, at most
  64 splits, and about two blocks per SM of the H100's 132 when every key
  is live.
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
    MAX_SPLITS,
    SPLIT_BLOCKS,
    key_chunk,
)
from tpu_voice_agent_torch.ops.grouped_matmul import MAX_SPLITK, STAGE_DEPTH, split_depth

# chip_smoke.py's bf16 attention tolerance: |out - ref| <= 2^-6 |ref| + 1e-4
ATTN_RTOL, ATTN_ATOL = 2.0 ** -6, 1e-4


@pytest.mark.parametrize("B,S,nkv", [(1, 2048, 4), (1, 2048, 8), (8, 2048, 4), (2, 300, 2),
                                     (1, 96, 2), (3, 700, 2), (1, 1, 1), (1, 100_000, 1),
                                     (32, 2048, 8)])
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
