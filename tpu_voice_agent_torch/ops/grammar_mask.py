"""K4: fused grammar mask -> argmax -> FSM advance, and K11: grammar mask ->
argmax (CUDA, ``csrc/grammar_mask.cu``).

Port of ``masked_argmax_advance``, ``masked_argmax`` and
``masked_argmax_block`` from ``tpu_voice_agent/ops/grammar_mask.py``: for
each row, mask the logits with its FSM state's row of the dense (S, V) mask
and take the argmax (ties to the first index); K4 also advances the state
through the compressed table. Nothing V-sized is written back.
``masked_argmax_block`` is the speculative verify tail: a (B, T) block of
positions, each at its own state, folded into B * T kernel rows of one K11
launch. Both kernels run one warp a row; ``argmax_geometry`` picks the rows
a block and the elements a lane on the host.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(``*_reference``) for CPU tensors, and only then.
"""

from __future__ import annotations

import torch

from ._lib import check, library, require, require_cuda, stream_of

_NEG_INF = -1e30
# the kernel's geometry (csrc/grammar_mask.cu): at most 8 warps (rows) a
# block; up to 24 elements a lane (V <= 768) unrolled, in steps of 4
ARGMAX_MAX_ROWS = 8
ARGMAX_MAX_PER_LANE = 24
# the H100's shared memory a block (K4 keeps one C-int table row a warp)
SMEM_PER_BLOCK = 232_448


def argmax_geometry(R: int, V: int) -> tuple[int, int]:
    """(rows a block, elements a lane) of K4 / K11 over R rows of V logits.

    Rows a block from R alone: 2 up to 8 rows, 4 above (the batch chunk's
    32 rows: 8 blocks; the (32, 5) verify block's 160: 40), so every row
    runs at once, one block an SM. Timed on the H100 at 5,
    8, 32 and 160 rows (``chip_smoke.py``'s ``rows_per_block_ms``): 1, 2
    and 4 rows a block lie within a few percent of each other, 2 best up
    to 8 rows and 4 at 32; 8 was the slowest everywhere. Elements a lane:
    the least multiple of 4 with 32 of them covering V, or 0 (the strided
    loop) past ARGMAX_MAX_PER_LANE."""
    rows = 2 if R <= 8 else 4
    per_lane = -(-V // 128) * 4
    return rows, (per_lane if per_lane <= ARGMAX_MAX_PER_LANE else 0)


def masked_argmax_advance(
    logits: torch.Tensor,  # (B, V) float32
    fsm_state: torch.Tensor,  # (B,) int32
    mask_table: torch.Tensor,  # (n_states, V) bool
    table: torch.Tensor,  # (n_states, C) int32 compressed transitions; -1 dead
    col_id: torch.Tensor,  # (V,) int32 token -> class
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tok, next_state), both (B,) int32. Negative (dead) states
    are clamped to 0; the engine's poison gate fences their results."""
    if logits.device.type == "cpu":
        return masked_argmax_advance_reference(logits, fsm_state, mask_table, table, col_id)
    name = "masked_argmax_advance"
    require_cuda(name, logits, fsm_state, mask_table, table, col_id)
    B, V = logits.shape
    S, C = table.shape
    require(logits.dtype == torch.float32, name, "logits must be float32")
    require(fsm_state.dtype == table.dtype == col_id.dtype == torch.int32, name,
            "state, table and col_id must be int32")
    require(mask_table.dtype == torch.bool and mask_table.shape == (S, V), name,
            f"mask must be ({S}, {V}) bool, got {tuple(mask_table.shape)}")
    require(fsm_state.shape == (B,) and col_id.shape == (V,), name,
            "state must be (B,) and col_id (V,)")
    rows, per_lane = argmax_geometry(B, V)
    require(4 * C * rows <= SMEM_PER_BLOCK, name,
            f"{C} classes: {rows} table rows exceed a block's shared memory")
    tok = torch.empty((B,), dtype=torch.int32, device=logits.device)
    nxt = torch.empty_like(tok)
    err = library().tva_masked_argmax_advance(
        logits.data_ptr(), fsm_state.data_ptr(), mask_table.data_ptr(), table.data_ptr(),
        col_id.data_ptr(), tok.data_ptr(), nxt.data_ptr(), B, V, C, rows, per_lane,
        stream_of(logits))
    check(err, name)
    masked_argmax_advance.launches += 1
    return tok, nxt


masked_argmax_advance.launches = 0


def masked_argmax_advance_reference(logits, fsm_state, mask_table, table, col_id):
    """Plain PyTorch version of ``masked_argmax_advance``: masked entries
    score -1e30 as in the kernel, so a fully masked row yields token 0 and
    ``table[state, col_id[0]]``."""
    state = torch.clamp(fsm_state, min=0).long()
    masked = torch.where(mask_table[state], logits.float(),
                         torch.full_like(logits, _NEG_INF, dtype=torch.float32))
    tok = torch.argmax(masked, dim=-1)  # first index among ties
    nxt = table[state, col_id[tok].long()]
    return tok.to(torch.int32), nxt.to(torch.int32)


def masked_argmax(
    logits: torch.Tensor,  # (R, V) float32
    fsm_state: torch.Tensor,  # (R,) int32
    mask_table: torch.Tensor,  # (n_states, V) bool
) -> torch.Tensor:
    """Returns (R,) int32: argmax of each row's logits where its state's mask
    row allows, masked entries scoring -1e30. Negative states are clamped
    to 0."""
    if logits.device.type == "cpu":
        return masked_argmax_reference(logits, fsm_state, mask_table)
    name = "masked_argmax"
    require_cuda(name, logits, fsm_state, mask_table)
    R, V = logits.shape
    require(logits.dtype == torch.float32, name, "logits must be float32")
    require(fsm_state.dtype == torch.int32 and fsm_state.shape == (R,), name,
            "state must be (R,) int32")
    require(mask_table.dtype == torch.bool and mask_table.dim() == 2
            and mask_table.shape[1] == V, name,
            f"mask must be (S, {V}) bool, got {tuple(mask_table.shape)}")
    tok = torch.empty((R,), dtype=torch.int32, device=logits.device)
    err = library().tva_masked_argmax(logits.data_ptr(), fsm_state.data_ptr(),
                                      mask_table.data_ptr(), tok.data_ptr(), R, V,
                                      *argmax_geometry(R, V), stream_of(logits))
    check(err, name)
    masked_argmax.launches += 1
    return tok


masked_argmax.launches = 0


def masked_argmax_reference(logits, fsm_state, mask_table):
    """Plain PyTorch version of ``masked_argmax``: K4's pick without the
    advance (the same -1e30 masking and first-index ties)."""
    state = torch.clamp(fsm_state, min=0).long()
    masked = torch.where(mask_table[state], logits.float(),
                         torch.full_like(logits, _NEG_INF, dtype=torch.float32))
    return torch.argmax(masked, dim=-1).to(torch.int32)


def masked_argmax_block(
    logits: torch.Tensor,  # (B, T, V) float32: one verify block per row
    fsm_state: torch.Tensor,  # (B, T) int32: each position's own state
    mask_table: torch.Tensor,  # (n_states, V) bool
) -> torch.Tensor:
    """Per-position masked argmax of a whole verify block in ONE K11 launch
    (positions fold into rows). Returns (B, T) int32. Dead (negative)
    states are clamped to 0 (by the kernel, or its plain version):
    ``serve.spec._verify_commit`` discards their picks."""
    B, T, V = logits.shape
    return masked_argmax(logits.reshape(B * T, V), fsm_state.reshape(B * T),
                         mask_table).reshape(B, T)
