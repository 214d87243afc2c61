"""Token-level FSM: lift a byte DFA to (state, token) transitions, compressed.

``TokenFSM`` is numpy and builds the same tables as the JAX package's
``grammar/fsm.py``:

  - ``col_id``  (V,) int32 — token → equivalence class (class 0: dead everywhere)
  - ``table``   (S, C) int32 — next state per (state, class); -1 = dead

``DeviceFSM`` holds those tables as torch tensors on the engine's device. A
vocab row is recovered with two gathers, ``row = table[state][:, col_id]``;
the dense ``(S, V)`` bool mask is shipped only for small vocabs, where the
fused grammar-mask kernel (``ops.grammar_mask``) streams it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .regexlang import DFA


class DeviceFSM(NamedTuple):
    """Device-resident FSM tables.

    ``dense_mask`` exists only while S·V stays under the dense limit; None
    sends the engine down the compressed two-gather path. ``ff_tokens`` /
    ``ff_len`` (grammar fast-forward): per state, the canonical tokenization
    of its forced byte run, appended by the decode loop without sampling."""

    table: torch.Tensor  # (S, C) int32; -1 = dead
    col_id: torch.Tensor  # (V,) int32 token -> class
    dense_mask: Optional[torch.Tensor]  # (S, V) bool or None
    ff_tokens: Optional[torch.Tensor] = None  # (S, W) int32; -1 pad
    ff_len: Optional[torch.Tensor] = None  # (S,) int32 0..W


def fsm_row(t: DeviceFSM, state: torch.Tensor) -> torch.Tensor:
    """(B,) states -> (B, V) int32 next-state row (-1 = disallowed)."""
    return t.table[state.long()][:, t.col_id.long()]


def fsm_advance(t: DeviceFSM, state: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """(B,) states, (B,) sampled tokens -> (B,) next states."""
    return t.table[state.long(), t.col_id[tok.long()].long()]


class TokenFSM:
    """Column-compressed (state, token) transition relation.

    Built by a vectorized DFS over the vocab byte trie: each trie node
    carries the (S,) vector of DFA states reached from every start state by
    the node's byte prefix; a token's column is the vector at its leaf,
    interned into the class table by content. Tokens never reached share
    class 0, the all-dead column."""

    def __init__(self, dfa: DFA, tokenizer, vocab_size: int | None = None):
        S = dfa.num_states
        V = int(vocab_size or tokenizer.vocab_size)
        if V < tokenizer.vocab_size:
            raise ValueError(
                f"vocab_size {V} smaller than tokenizer vocab {tokenizer.vocab_size}"
            )
        trans_b = dfa.trans[:, dfa.class_of]  # (S, 256) byte-expanded
        identity = np.arange(S, dtype=np.int32)

        # trie over token byte pieces; distinct ids may share bytes, so
        # leaves hold id lists
        trie: dict = {}
        for tid, piece in enumerate(tokenizer.byte_pieces()):
            if not piece:  # None or b"": specials / non-emitting tokens
                continue
            node = trie
            for b in piece:
                node = node.setdefault(b, {})
            node.setdefault(-1, []).append(tid)

        dead = np.full((S,), -1, dtype=np.int32)
        columns: list[np.ndarray] = [dead]
        col_of: dict[bytes, int] = {dead.tobytes(): 0}
        col_id = np.zeros((V,), dtype=np.int32)

        def intern(vec: np.ndarray) -> int:
            key = vec.tobytes()
            idx = col_of.get(key)
            if idx is None:
                idx = len(columns)
                col_of[key] = idx
                columns.append(vec)
            return idx

        # byte-major next-state rows with a dead column at index S: a dead
        # entry (-1) of a state vector indexes that column, so one gather
        # per trie edge advances every start state (the JAX package's
        # where / maximum / astype over the (S, 256) table computes the
        # same vectors in the same order, 2.4x slower at V = 32,000)
        next_by_byte = np.concatenate(
            [np.ascontiguousarray(trans_b.T), np.full((256, 1), -1, dtype=trans_b.dtype)],
            axis=1).astype(np.int32)
        stack: list[tuple[dict, np.ndarray]] = [(trie, identity)]
        while stack:
            node, vec = stack.pop()
            for key, child in node.items():
                if key == -1:
                    c = intern(vec)
                    for tid in child:
                        col_id[tid] = c
                else:
                    nvec = next_by_byte[key].take(vec)
                    if nvec.max() >= 0:
                        stack.append((child, nvec))

        # EOS is allowed exactly on accepting states and keeps the state
        eos_vec = np.where(dfa.accepting, identity, -1).astype(np.int32)
        col_id[tokenizer.eos_id] = intern(eos_vec)

        self.table = np.stack(columns, axis=1)  # (S, C)
        self.col_id = col_id
        self.start = dfa.start
        self.num_states = S
        self.num_classes = len(columns)
        self.vocab_size = V
        self.accepting = dfa.accepting.copy()
        self._trans_b = trans_b
        self._trie = trie
        # lookahead(): canonical forced chain per state, tiled on demand
        self._lookahead_cache: dict[int, list[int]] = {}
        self._forced_arr: tuple[np.ndarray, np.ndarray] | None = None

    @property
    def next_state(self) -> np.ndarray:
        """Dense (S, V) int32 view — O(S·V); tests and toy vocabs only."""
        return self.table[:, self.col_id]

    @property
    def mask(self) -> np.ndarray:
        """Dense (S, V) bool view — O(S·V); tests and toy vocabs only."""
        return self.next_state >= 0

    def allowed(self, state: int) -> np.ndarray:
        """(V,) bool: the tokens legal in ``state``."""
        return self.table[state][self.col_id] >= 0

    def step(self, state: int, token_id: int) -> int:
        return int(self.table[state, self.col_id[token_id]])

    def walk(self, token_ids: list[int]) -> int:
        s = self.start
        for t in token_ids:
            s = self.step(s, t)
            if s < 0:
                return s
        return s

    # ------------------------------------------------------------ fast-forward

    def _forced_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(forced (S,) bool, fbyte (S,) int): a state is forced when the
        byte DFA admits exactly one byte and is not accepting."""
        if self._forced_arr is None:
            legal = self._trans_b >= 0  # (S, 256)
            forced = (legal.sum(axis=1) == 1) & ~self.accepting
            self._forced_arr = (forced, np.argmax(legal, axis=1))
        return self._forced_arr

    def _forced_run(self, state: int) -> list[int]:
        """The unique forced byte path from ``state``."""
        forced, fbyte = self._forced_arrays()
        run, st = [], state
        while forced[st] and len(run) < 4096:
            b = int(fbyte[st])
            run.append(b)
            st = int(self._trans_b[st, b])
        return run

    def _tile_run(self, run: list[int], width: int) -> list[int]:
        """Greedy-longest canonical tokenization of a byte run over the
        vocab trie (first id of a piece = canonical)."""
        toks, i = [], 0
        while i < len(run) and len(toks) < width:
            node, best, j = self._trie, None, i
            while j < len(run) and run[j] in node:
                node = node[run[j]]
                j += 1
                if -1 in node:
                    best = (j, node[-1][0])
            if best is None:
                break
            i = best[0]
            toks.append(best[1])
        return toks

    def forced_tables(self, width: int) -> tuple[np.ndarray, np.ndarray]:
        """(ff_tokens (S, width) int32, ff_len (S,) int32): per state, the
        canonical tokenization of its forced byte run. Chains never contain
        EOS (runs stop before accepting states)."""
        S = self.num_states
        forced, _ = self._forced_arrays()
        ff_tokens = np.full((S, width), -1, dtype=np.int32)
        ff_len = np.zeros((S,), dtype=np.int32)
        for s in range(S):
            if not forced[s]:
                continue
            toks = self._tile_run(self._forced_run(s), width)
            ff_tokens[s, : len(toks)] = toks
            ff_len[s] = len(toks)
        return ff_tokens, ff_len

    def lookahead(self, state: int, width: int) -> list[int]:
        """Up to ``width`` draft tokens along the forced byte path from
        ``state`` (speculative decoding's ``FSMDrafter``): the same canonical
        tiling as ``forced_tables``, but only proposed, so the verify pass may
        reject it for another tiling of the same bytes. [] when ``state`` is
        not byte-forced, dead or accepting. The whole run's tiling is cached
        per state and sliced per call."""
        if state < 0 or state >= self.num_states or width <= 0:
            return []
        chain = self._lookahead_cache.get(state)
        if chain is None:
            run = self._forced_run(state)
            chain = self._tile_run(run, len(run))
            self._lookahead_cache[state] = chain
        return chain[:width]

    # ------------------------------------------------------------ device tables

    def device_tables(self, dense_limit: int = 1 << 25, ff_width: int = 0,
                      device: str | torch.device = "cpu") -> DeviceFSM:
        """Tables as tensors on ``device``. The dense bool mask (the grammar
        kernel's input) is included only while S·V stays under
        ``dense_limit`` entries; ``ff_width > 0`` attaches the fast-forward
        chains (``forced_tables``)."""
        dense = None
        if self.num_states * self.vocab_size <= dense_limit:
            # the (S, V) view comes out column-major; the kernel reads rows
            dense = torch.from_numpy(np.ascontiguousarray(self.mask)).to(device)
        ff_tok = ff_len = None
        if ff_width > 0:
            t, l = self.forced_tables(ff_width)
            ff_tok, ff_len = torch.from_numpy(t).to(device), torch.from_numpy(l).to(device)
        return DeviceFSM(
            table=torch.from_numpy(self.table).to(device),
            col_id=torch.from_numpy(self.col_id).to(device),
            dense_mask=dense,
            ff_tokens=ff_tok,
            ff_len=ff_len,
        )
