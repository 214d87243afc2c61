"""Paged KV serving: block pool + allocator + paged decode engine.

Port of ``tpu_voice_agent/serve/paged.py`` on one device (dp = 1).
Sequences own fixed-size blocks of one global pool ``(L, N, bs, nkv, hd)``
through per-slot block tables, so the card holds the context each request
actually has, and the shared prompt prefix is ONE set of refcounted blocks
referenced by every slot's table: admission writes only the sub-block tail
of the prefix and the user suffix. Decode attends through K6 / K7
(``ops.paged_attention`` / ``ops.paged_block_attention``), which resolve the
block tables themselves; tables grow at chunk boundaries. With
``radix_enable`` (``RADIX_ENABLE=1``) released chains are cached in a
``RadixCache`` (``RADIX_MAX_NODES`` nodes, default 4096; none adopted for
``RADIX_PRESSURE_S``, default 2.0, after the pool ran out) and admission
reuses the longest cached block chain; under tenancy the batcher names each
slot's tenant namespace (``set_slot_ns``) and the chains are salted with
it. With
``kv_quant`` (``KV_QUANT=int8|int4``) the pool stores ``ops.kvquant``'s int8
or packed int4 values beside two bf16 scale planes indexed like it, so a
block's scales travel with it through radix chains; decode reads it through
K8 / K9.

``PagedDecodeEngine`` serves through the continuous batcher
(``serve.scheduler``) via ``prefill_slot`` / ``decode_chunk`` /
``release_slot``; ``generate`` is refused. The pool is updated in place.
With ``spec`` greedy chunks are ``serve.spec`` verify steps, each growing
the tables by its own worst case (``_claim``). The paged chunk shares the
dense engine's ``decode_loop``, quality lanes included; the batcher exports
the pool's occupancy each chunk (``record_pool_gauges``: ``paged.kv_*``,
bytes per block under ``KV_QUANT``).

Chunked prefill (``PREFILL_CHUNK_TOKENS``, driven by the scheduler):
``begin_chunked_prefill`` takes ``prefill_slot``'s decision tree (radix
chain, static-prefix tail) and allocates every block up front;
``chunked_prefill_step`` runs one (1, C) piece a step through the slot's
table: K7 / K9 at C <= 16, the plain gathered attention past that, and K1
for a first piece with nothing cached before it. The chain becomes
insertable only at the final piece. The chaos point ``alloc_fail`` fires in
``BlockAllocator.alloc``.

Warm state (``serve.handoff``): ``slot_chain_blocks`` lists a slot's block
chain, ``gather_chain_kv`` copies blocks to the host in the stored format
(bf16 values, or int8 / packed int4 bytes with their bf16 scale planes) and
``adopt_chain_kv`` installs such bytes verbatim into fresh blocks (no
re-quantize). ``warm_restart`` (the serving loop's stall watchdog) throws
away the slot and allocator bookkeeping and keeps the pool tensors, the
static prefix's blocks and the weights. Left for later: meshes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..models.llama import forward_paged
from ..ops._lib import QUANT_HEAD_DIMS
from ..ops.kvquant import (
    kv_block_bytes,
    kv_quant_bits,
    kv_store_dim,
    kv_store_dtype,
    quantize_kv,
)
from ..utils.chaos import chaos_fire
from ..utils.tracing import get_metrics
from .engine import DecodeEngine, _sync
from .radix import RadixCache

# the radix tree's node cap (one node per cached block): RADIX_MAX_NODES
RADIX_MAX_NODES = 4096
# after a PoolExhausted, released chains stay out of the tree this long:
# RADIX_PRESSURE_S
PRESSURE_WINDOW_S = 2.0


class PoolExhausted(RuntimeError):
    """The KV pool has no free blocks. Its own class, so the scheduler can
    fail or requeue one request without swallowing device faults."""


class _ChunkedPrefill:
    """Cursor of one chunked admission between ``begin_chunked_prefill``
    and its final ``chunked_prefill_step``: every block is allocated and the
    slot's table set; only the suffix pieces remain, one per step."""

    __slots__ = ("slot", "ids", "suffix", "P", "C", "n_chunks", "j", "step_ms", "total_ms")

    def __init__(self, slot: int, ids: list[int], suffix: list[int], P: int, C: int,
                 n_chunks: int):
        self.slot = slot
        self.ids = ids
        self.suffix = suffix
        self.P = P  # tokens served from cached KV (chain / prefix)
        self.C = C  # PREFILL_CHUNK_TOKENS
        self.n_chunks = n_chunks
        self.j = 0  # pieces done
        self.step_ms = 0.0  # the last piece's dispatch wall (the step ledger's carve)
        self.total_ms = 0.0  # summed (prefill_ms at the finish)


class BlockAllocator:
    """Host-side free-list allocator with refcounts (prefix blocks are
    shared across slots). Block 0 is the trash block (idle batcher rows
    park their writes there) and is never handed out. One device, so one
    group: the JAX allocator's per-dp-shard groups are not ported."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("the pool needs >= 2 blocks (block 0 is reserved)")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))
        self._refs: dict[int, int] = {}

    def alloc(self, k: int) -> list[int]:
        if chaos_fire("alloc_fail"):
            # the pool-pressure ladder's drill: the type a full pool raises
            raise PoolExhausted("chaos: injected allocation failure")
        if len(self._free) < k:
            raise PoolExhausted(
                f"KV pool exhausted: need {k} blocks, {len(self._free)} free of "
                f"{self.usable_blocks} (size the pool to the live-token working set, not "
                "per-slot budgets)")
        out = [self._free.pop() for _ in range(k)]
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, blocks: list[int]) -> None:
        """One more ref on each block; all-or-nothing."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"ref of untracked block {b}: not allocated, or already "
                                 "fully freed (use-after-free)")
        for b in blocks:
            self._refs[b] += 1

    def free(self, blocks: list[int]) -> None:
        """Drop one ref per listed block (a block listed twice drops two);
        all-or-nothing."""
        need: dict[int, int] = {}
        for b in blocks:
            need[b] = need.get(b, 0) + 1
        for b, k in need.items():
            if self._refs.get(b, 0) < k:
                raise ValueError(f"double free of block {b}: no live refcount (freed more "
                                 "times than alloc'd + ref'd)")
        for b in blocks:
            r = self._refs[b] - 1
            if r == 0:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = r

    def reserve(self, blocks: list[int]) -> None:
        """Take specific free blocks as allocated (refcount 1): a warm
        restart's fresh allocator keeps the static prefix's blocks, whose
        pool KV survives, where they are. All-or-nothing."""
        for b in blocks:
            if b in self._refs or b not in self._free:
                raise ValueError(f"reserve of unavailable block {b}")
        for b in blocks:
            self._free.remove(b)
            self._refs[b] = 1

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def usable_blocks(self) -> int:
        return self.n_blocks - 1

    @property
    def blocks_in_use(self) -> int:
        return self.usable_blocks - len(self._free)

    @property
    def blocks_shared(self) -> int:
        """Blocks with more than one live ref."""
        return sum(1 for r in self._refs.values() if r > 1)

    @property
    def utilization(self) -> float:
        return self.blocks_in_use / self.usable_blocks


def record_pool_gauges(alloc: BlockAllocator, engine=None) -> None:
    """Export one allocator's occupancy as runtime gauges (the batcher calls
    it each chunk). With ``engine`` the bytes view rides along: under
    KV_QUANT a block is fewer bytes, so block counts alone are no unit of
    device memory."""
    m = get_metrics()
    m.set_gauge("paged.kv_blocks_used", float(alloc.blocks_in_use))
    m.set_gauge("paged.kv_blocks_total", float(alloc.usable_blocks))
    m.set_gauge("paged.kv_utilization", alloc.utilization)
    m.set_gauge("paged.kv_blocks_shared", float(alloc.blocks_shared))
    if engine is not None:
        bpb = engine.kv_bytes_per_block
        m.set_gauge("paged.kv_quant_bits", float(engine.kv_quant_bits))
        m.set_gauge("paged.kv_bytes_per_block", float(bpb))
        m.set_gauge("paged.kv_bytes_used", float(alloc.blocks_in_use * bpb))
        m.set_gauge("paged.kv_bytes_total", float(alloc.usable_blocks * bpb))


def check_kv_quant_head_dim(kv_quant: str | None, head_dim: int, device: torch.device) -> None:
    """Refuse at boot a quantized pool that the card's kernels cannot read:
    K8 / K9 are built for ``QUANT_HEAD_DIMS`` only (their plain versions on
    the CPU take any head dim)."""
    if kv_quant is not None and device.type == "cuda" and head_dim not in QUANT_HEAD_DIMS:
        raise ValueError(f"KV_QUANT={kv_quant} on the card needs a head dim in "
                         f"{QUANT_HEAD_DIMS}, got {head_dim}")


class PagedDecodeEngine(DecodeEngine):
    """``DecodeEngine`` with a paged KV pool in place of dense per-slot
    lines. ``pool_blocks`` sizes device memory to the expected LIVE token
    count (default: the dense worst case, ``batch_slots * max_blocks``,
    plus the trash block). On a CUDA device the pool is read by K6 / K7,
    which take any block size, or under ``kv_quant`` by K8 / K9.
    ``kv_quant`` None reads ``KV_QUANT``; "" and "off" mean the bf16 pool."""

    def __init__(self, *args, block_size: int = 128, pool_blocks: int | None = None,
                 radix_enable: bool | None = None, kv_quant: str | None = None, **kw):
        if kv_quant is None:
            kv_quant = os.environ.get("KV_QUANT") or None
        if kv_quant in ("", "off"):
            kv_quant = None
        if kv_quant not in (None, "int8", "int4"):
            raise ValueError(f"KV_QUANT must be int8 or int4, got {kv_quant!r}")
        self.kv_quant = kv_quant
        super().__init__(*args, **kw)
        check_kv_quant_head_dim(kv_quant, self.cfg.head_dim, self.device)
        bs = block_size
        self.block_size = bs
        self.max_blocks = -(-self.max_len // bs)
        if pool_blocks is None:
            pool_blocks = self.batch_slots * self.max_blocks + 1
        L, nkv = self.cfg.n_layers, self.cfg.n_kv_heads
        shape = (L, pool_blocks, bs, nkv, kv_store_dim(self.cfg.head_dim, kv_quant))
        dtype = kv_store_dtype(kv_quant)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.k_scale = self.v_scale = None
        if kv_quant is not None:
            sshape = (L, pool_blocks, bs, nkv)
            self.k_scale = torch.zeros(sshape, dtype=torch.bfloat16, device=self.device)
            self.v_scale = torch.zeros(sshape, dtype=torch.bfloat16, device=self.device)
        self.allocator = BlockAllocator(pool_blocks)
        self.block_tables = torch.zeros((self.batch_slots, self.max_blocks), dtype=torch.int32,
                                        device=self.device)
        self._slot_shared: list[list[int]] = [[] for _ in range(self.batch_slots)]
        self._slot_owned: list[list[int]] = [[] for _ in range(self.batch_slots)]
        self._covered = [0] * self.batch_slots  # positions with blocks
        self._next_pos = [0] * self.batch_slots  # growth target (upper bound)
        # parked writes land in block 0, the allocator's reserved trash block
        self._trash_idx = torch.zeros((self.batch_slots,), dtype=torch.int32,
                                      device=self.device)
        self._prefix_blocks: list[int] = []
        self._prefix_tail: dict | None = None  # (L, R, nkv, hd) sub-block rest
        if radix_enable is None:
            radix_enable = os.environ.get("RADIX_ENABLE") == "1"
        max_nodes = int(os.environ.get("RADIX_MAX_NODES", str(RADIX_MAX_NODES)))
        self.radix: RadixCache | None = (
            RadixCache(self.allocator, bs, max_nodes=max_nodes) if radix_enable else None)
        # pool-pressure gate on caching released chains: while a recent
        # allocation hit PoolExhausted, release does not adopt into the tree
        self._pressure_window_s = float(os.environ.get("RADIX_PRESSURE_S",
                                                       str(PRESSURE_WINDOW_S)))
        self._pressure_until = 0.0
        # the tenant radix namespace of each slot's next admission (the
        # batcher sets it under tenancy; empty keeps every path unsalted)
        self._slot_ns: dict[int, str] = {}
        # host token ids of each slot's request (the radix insert at release)
        self._slot_ids: list[list[int] | None] = [None] * self.batch_slots
        # slots of a chunked admission underway: not decoding, fully covered
        self._mid_prefill: set[int] = set()
        # speculative decoding, deferred from the parent: the decoder reads
        # the pool, tables and trash index that exist only now
        if self._spec_cfg is not None:
            self._build_spec()

    def _init_kv_cache(self):
        return None  # the block pool, built in __init__, holds the KV

    @property
    def kv_quant_bits(self) -> int:
        """Stored bits per KV element (16 bf16 / 8 / 4)."""
        return kv_quant_bits(self.kv_quant)

    @property
    def kv_bytes_per_block(self) -> int:
        """Device bytes one pool block occupies under the engine's KV tier
        (values and scale planes; ``ops.kvquant.kv_block_bytes``)."""
        return kv_block_bytes(self.cfg.n_layers, self.block_size, self.cfg.n_kv_heads,
                              self.cfg.head_dim, self.kv_quant)

    def _scatter_pool(self, src_k, src_v, dst_idx) -> None:
        """Write (L, n, nkv, hd) rows into the flat pool at ``dst_idx`` (n,):
        as they are, or under KV_QUANT quantized on write with their scales
        at the same flat indices (the prefix install and the per-slot tail
        go through here, so they store what a decode write would)."""
        L, N, bs = self.k_pool.shape[:3]
        idx = torch.as_tensor(dst_idx, dtype=torch.long, device=self.device)
        kflat = self.k_pool.view(L, N * bs, *self.k_pool.shape[3:])
        vflat = self.v_pool.view(L, N * bs, *self.v_pool.shape[3:])
        if self.kv_quant is None:
            kflat[:, idx] = src_k.to(self.k_pool.dtype)
            vflat[:, idx] = src_v.to(self.v_pool.dtype)
            return
        (qk, sk), (qv, sv) = quantize_kv(src_k, self.kv_quant), quantize_kv(src_v, self.kv_quant)
        kflat[:, idx] = qk
        vflat[:, idx] = qv
        self.k_scale.view(L, N * bs, -1)[:, idx] = sk
        self.v_scale.view(L, N * bs, -1)[:, idx] = sv

    def _forward(self, tokens, positions, tables, **kw):
        """``forward_paged`` on this engine's pool, scale planes and tier."""
        return forward_paged(self.params, self.cfg, tokens, positions, self.k_pool, self.v_pool,
                             tables, k_scale=self.k_scale, v_scale=self.v_scale,
                             kv_quant=self.kv_quant, **kw)

    # ------------------------------------------------------------ prefix

    def set_prompt_prefix(self, *sample_prompts: str) -> int:
        """Install the shared prefix: its FULL blocks into the pool once
        (and, with radix on, as the tree's pinned root chain), its
        sub-block remainder kept aside to be scattered into each slot's
        first owned block."""
        P = super().set_prompt_prefix(*sample_prompts)
        if self.radix is not None:  # cached chains over the old prefix never match again
            self.radix.clear()
        if self._prefix_blocks:
            self.allocator.free(self._prefix_blocks)
            self._prefix_blocks = []
        self._prefix_tail = None
        if P == 0:
            return 0
        bs = self.block_size
        full = P // bs
        pk = self.prefix_kv["k"][:, 0]  # (L, P, nkv, hd)
        pv = self.prefix_kv["v"][:, 0]
        if full:
            self._prefix_blocks = self.allocator.alloc(full)
            blocks = np.asarray(self._prefix_blocks, np.int64)
            dst = (blocks[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
            self._scatter_pool(pk[:, :full * bs], pv[:, :full * bs], dst)
        if P % bs:
            self._prefix_tail = {"k": pk[:, full * bs:], "v": pv[:, full * bs:]}
        if full and self.radix is not None:
            self.radix.pin_root_chain(self.prefix_ids[:full * bs], self._prefix_blocks)
        # the prefix KV now lives in the pool + the tail; _split_prefix only
        # needs a non-None sentinel
        self.prefix_kv = {}
        return P

    # ------------------------------------------------------------ admission

    def _set_table_row(self, slot: int, blocks: list[int]) -> None:
        row = np.zeros(self.max_blocks, np.int32)  # unused entries: block 0
        row[:len(blocks)] = blocks
        self.block_tables[slot] = torch.from_numpy(row).to(self.device)

    def _alloc(self, k: int) -> list[int]:
        """``allocator.alloc`` with radix backpressure: when the pool is
        out, evict LRU unreferenced radix leaves and retry once. Either way
        the PoolExhausted marks pool pressure, which stops caching released
        chains for ``RADIX_PRESSURE_S``. Without a tree, or with nothing
        evictable, PoolExhausted propagates to the scheduler."""
        try:
            return self.allocator.alloc(k)
        except PoolExhausted:
            self._pressure_until = time.monotonic() + self._pressure_window_s
            if self.radix is None:
                raise
            need = k - self.allocator.free_blocks()
            if self.radix.evict(need) < need:
                raise
            return self.allocator.alloc(k)

    def _prefix_chain(self) -> list[int]:
        """The static prefix's full blocks, ref'd for one more slot (its
        sub-block remainder is ``_prefix_tail``)."""
        chain = list(self._prefix_blocks[:len(self.prefix_ids) // self.block_size])
        self.allocator.ref(chain)
        return chain

    def _match_cached(self, ids: list[int], ns: str | None = None):
        """The radix tree's longest cached chain for ``ids`` (its blocks
        ref'd for the caller) and where the computed suffix starts: at the
        match, or at the whole static prefix when the match stopped at the
        pinned root chain and the prompt extends the prefix (the prefix's
        sub-block tail is then scattered). Returns (chain, P, tail); P is 0
        on a miss. ``ns``: the slot's tenant namespace."""
        chain, matched = self.radix.match(ids, ns=ns)
        P, tail = matched, None
        P0 = len(self.prefix_ids)
        if (matched and self._prefix_tail is not None and P0 > matched and len(ids) > P0
                and chain == self._prefix_blocks[:len(chain)] and ids[:P0] == self.prefix_ids):
            P, tail = P0, self._prefix_tail
        return chain, P, tail

    def _seat(self, slot: int, chain: list[int], P: int, span: int,
              tail: dict | None = None) -> None:
        """Lay ``slot`` out for a chain admission: ``chain`` blocks, already
        ref'd for this slot, cover positions [0, len(chain) * bs) read-only;
        ``tail`` supplies KV for [len(chain) * bs, P); freshly allocated
        owned blocks take [P, P + span). On PoolExhausted the chain's refs
        are dropped."""
        bs = self.block_size
        full = len(chain)
        n_owned = -(-(P + span) // bs) - full
        try:
            owned = self._alloc(n_owned)
        except PoolExhausted:
            self.allocator.free(chain)  # don't leak the chain refs
            raise
        self._slot_shared[slot], self._slot_owned[slot] = list(chain), owned
        self._set_table_row(slot, list(chain) + owned)
        self._covered[slot] = (full + n_owned) * bs
        if tail is not None:
            self._scatter_pool(tail["k"], tail["v"], owned[0] * bs + np.arange(P - full * bs))

    def _prefill_suffix(self, tokens, positions, slot: int, P: int, bucket: int, n: int):
        """The static-prefix case of ``_prefill_chain``: the chain is the
        prefix's full blocks, the tail its sub-block remainder."""
        return self._prefill_chain(tokens, positions, slot, self._prefix_chain(), P, bucket, n,
                                   tail=self._prefix_tail)

    def _prefill_chain(self, tokens, positions, slot: int, chain: list[int], P: int,
                       bucket: int, n: int, tail: dict | None = None):
        """Chain admission (static prefix AND radix hits): ``chain`` blocks,
        already ref'd for this slot, cover positions [0, len(chain) * bs)
        read-only; ``tail`` supplies KV for [len(chain) * bs, P); the
        (1, bucket) suffix forward computes [P, n). New tokens land only in
        freshly allocated owned blocks (the suffix starts at P >= the
        chain's end)."""
        self._seat(slot, chain, P, bucket, tail)
        bs = self.block_size
        # gather only the covered blocks, bucketed to a power of two (with
        # radix on also 3/4 of one), exactly as the JAX engine does
        need = -(-(P + bucket) // bs)
        gb = 1
        while gb < need:
            gb *= 2
        if self.radix is not None and gb >= 4 and need <= gb * 3 // 4:
            gb = gb * 3 // 4
        gb = min(gb, self.max_blocks)
        self._next_pos[slot] = n
        return self._forward(tokens, positions, self.block_tables[slot:slot + 1],
                             attn_impl="torch", fresh_block=False, gather_blocks=gb)

    def prefill_slot(self, ids: list[int], slot: int):
        """Radix-aware admission: the longest cached block chain first, else
        the static-prefix / full-prefill decision tree. With radix off this
        is the parent's path."""
        self._fence()
        if self.radix is None:
            return super().prefill_slot(ids, slot)
        ns = self._slot_ns.get(slot)  # this occupant's; the release pops it
        self.release_slot(slot)
        self.set_slot_ns(slot, ns)
        ids = list(ids)
        chain, P, tail = self._match_cached(ids, ns)
        if P:
            suffix = ids[P:]
            bucket = self._suffix_bucket(len(suffix), self.max_len - P)
            if bucket is None:
                self.allocator.free(chain)  # no suffix bucket fits: cold path
                P = 0
        if not P:
            logits = super().prefill_slot(ids, slot)
            self.set_slot_ns(slot, ns)  # the parent released the slot again
            self._slot_ids[slot] = ids
            return logits
        self.radix.record_hit(P)
        if self.spec is not None:
            # the warm path seeds the drafters with the FULL cached ids (the
            # cold path does so inside the parent's prefill_slot)
            self.spec.on_admit(slot, ids)
        m = len(suffix)
        tokens = np.full((1, bucket), self.pad_id, dtype=np.int32)
        tokens[0, :m] = suffix
        positions = (P + np.arange(bucket, dtype=np.int32))[None, :]
        t0 = time.perf_counter()
        logits = self._prefill_chain(self._ids(tokens), self._ids(positions), slot, chain, P,
                                     bucket, len(ids), tail=tail)
        _sync(self.device)
        self._last_prefill_compute_ms = (time.perf_counter() - t0) * 1e3
        self._last_cached_tokens = P
        self._slot_ids[slot] = ids
        return logits[:, m - 1, :].contiguous()

    def _prefill_full(self, tokens, positions, slot: int, bucket: int, n: int):
        """A fresh prompt from position 0: block-local attention (K1), no
        pool gather."""
        bs = self.block_size
        owned = self._alloc(-(-bucket // bs))
        self._slot_shared[slot], self._slot_owned[slot] = [], owned
        self._set_table_row(slot, owned)
        self._covered[slot] = len(owned) * bs
        self._next_pos[slot] = n
        return self._forward(tokens, positions, self.block_tables[slot:slot + 1],
                             attn_impl=self.kernels, fresh_block=True)

    # ------------------------------------------------------------ chunked prefill

    def begin_chunked_prefill(self, ids: list[int], slot: int,
                              chunk_tokens: int) -> _ChunkedPrefill | None:
        """Start a chunked admission: ``prefill_slot``'s decision tree (radix
        chain, static-prefix tail, block layout), but the suffix is split
        into ``chunk_tokens`` pieces the scheduler runs one a step
        (``chunked_prefill_step``). Every block is allocated here, so no
        piece raises PoolExhausted; an evicted slot frees them through
        ``release_slot(ok=False)``, and no half-computed chain is inserted
        (``_slot_ids`` is set at the final piece only). None when chunking
        cannot represent the prompt (nothing to compute, or the padded span
        past ``max_len``): the caller takes ``prefill_slot``."""
        self._fence()
        ns = self._slot_ns.get(slot)
        self.release_slot(slot, ok=False)
        self.set_slot_ns(slot, ns)
        ids = list(ids)
        chain, P, tail = (self._match_cached(ids, ns) if self.radix is not None
                          else ([], 0, None))
        radix_hit = P > 0
        if not P and self._split_prefix(ids) is not None and self.prefix_ids:
            # the static prefix without a radix chain: _prefill_suffix's layout
            P, tail, chain = len(self.prefix_ids), self._prefix_tail, self._prefix_chain()
        suffix = ids[P:]
        m, C = len(suffix), int(chunk_tokens)
        n_chunks = -(-m // C) if C > 0 else 0
        if m <= 0 or C <= 0 or P + n_chunks * C > self.max_len:
            self.allocator.free(chain)
            return None
        self._seat(slot, chain, P, n_chunks * C, tail)
        if radix_hit:
            self.radix.record_hit(P)  # committed to the cached chain only now
        self._next_pos[slot] = len(ids)
        self._mid_prefill.add(slot)
        return _ChunkedPrefill(slot, ids, suffix, P, C, n_chunks)

    def chunked_prefill_step(self, cur: _ChunkedPrefill):
        """Run ONE (1, C) piece of a chunked admission. Returns the last
        prompt token's logits (1, V) when the final piece lands, else None.
        Earlier pieces' KV is read through the slot's table, with
        ``prefill_slot``'s pow2-bucketed gather past K7's 16 positions."""
        self._fence()
        slot, C, bs = cur.slot, cur.C, self.block_size
        start = cur.j * C
        seg = cur.suffix[start:start + C]
        tokens = np.full((1, C), self.pad_id, dtype=np.int32)
        tokens[0, :len(seg)] = seg
        positions = (cur.P + start + np.arange(C, dtype=np.int32))[None, :]
        need = -(-(cur.P + start + C) // bs)
        gb = 1
        while gb < need:
            gb *= 2
        fresh = cur.P + start == 0  # nothing before it: a fresh block (K1)
        t0 = time.perf_counter()
        logits = self._forward(self._ids(tokens), self._ids(positions),
                               self.block_tables[slot:slot + 1], attn_impl=self.kernels,
                               fresh_block=fresh,
                               gather_blocks=None if fresh else min(gb, self.max_blocks))
        cur.step_ms = (time.perf_counter() - t0) * 1e3
        cur.total_ms += cur.step_ms
        cur.j += 1
        if cur.j < cur.n_chunks:
            return None
        self._mid_prefill.discard(slot)
        self._last_prefill_compute_ms = cur.total_ms
        self._last_cached_tokens = cur.P
        self._slot_ids[slot] = cur.ids
        if self.spec is not None:
            self.spec.on_admit(slot, cur.ids)  # the one-shot paths' drafter hook
        return logits[:, len(cur.suffix) - start - 1, :].contiguous()

    # ------------------------------------------------------------ decode

    def reconcile_coverage(self, pos_h) -> None:
        """Post-chunk hook (the scheduler calls it with the chunk's host
        positions): clamp each live slot's growth target to its ACTUAL
        frontier, so the worst-case claims of ``_claim`` never compound. A
        slot mid chunked admission is not decoding: its target stays."""
        for b in range(self.batch_slots):
            if self._slot_owned[b] and b not in self._mid_prefill:
                self._next_pos[b] = min(self._next_pos[b], int(pos_h[b]))

    def _grow(self, slot: int, upto: int) -> None:
        """Extend a slot's table so positions < upto have blocks."""
        bs = self.block_size
        upto = min(upto, self.max_len)
        if upto <= self._covered[slot]:
            return
        extra = self._alloc(-(-(upto - self._covered[slot]) // bs))
        self._slot_owned[slot].extend(extra)
        self._set_table_row(slot, self._slot_shared[slot] + self._slot_owned[slot])
        self._covered[slot] += len(extra) * bs

    def _decode_step(self, tokens, positions, active):
        """One decode forward through the block tables; idle rows' writes
        park at the trash block via the write mask."""
        self._fence()
        return self._forward(tokens, positions, self.block_tables, attn_impl=self.kernels,
                             write_mask=active, trash_idx=self._trash_idx)

    def _claim(self, span: int, active=None) -> list[int]:
        """Grow every live table (``active``: host bools; default every slot
        in use) to cover ``span`` positions past the row's growth target: a
        write past the covered blocks would land in another sequence's
        block. A plain chunk claims its worst case, ``chunk_steps * (1 +
        W)``, before dispatch; a speculative verify step claims its own 1 +
        K. Returns the slots whose claim failed: each truncates alone at its
        covered frontier. ``reconcile_coverage`` clamps the targets back to
        the actual frontiers after the dispatch."""
        self._fence()
        starved = []
        for b in range(self.batch_slots):
            # a slot mid chunked admission holds every block it needs
            if (self._slot_owned[b] and b not in self._mid_prefill
                    and (active is None or active[b])):
                try:
                    self._grow(b, self._next_pos[b] + span + 1)
                except PoolExhausted:
                    starved.append(b)
                    continue
                self._next_pos[b] = min(self._next_pos[b] + span, self.max_len)
        return starved

    def release_slot(self, slot: int, generated_ids: list[int] | None = None,
                     ok: bool = True) -> None:
        """Return the slot's blocks. With radix on, a finished request
        (``ok``, ``generated_ids`` given, no recent pool pressure) first has
        its prompt + generated chain adopted by the tree, whose own refs
        keep those blocks alive. An errored request never inserts, nor does
        a chunked admission evicted before its final piece. The inserted ids
        are the accepted stream: a rejected draft's KV lies past it, in the
        partial tail block the tree does not adopt."""
        self._mid_prefill.discard(slot)
        ns = self._slot_ns.pop(slot, None)
        if self._slot_owned[slot] or self._slot_shared[slot]:
            if (ok and self.radix is not None and generated_ids is not None
                    and self._slot_ids[slot] is not None and self._radix_may_admit()):
                ids = self._slot_ids[slot] + [int(t) for t in generated_ids]
                self.radix.insert(ids, self._slot_shared[slot] + self._slot_owned[slot], ns=ns)
            self.allocator.free(self._slot_owned[slot])
            self.allocator.free(self._slot_shared[slot])
            self._slot_owned[slot] = []
            self._slot_shared[slot] = []
            self._covered[slot] = 0
            self._next_pos[slot] = 0
        self._slot_ids[slot] = None
        super().release_slot(slot, generated_ids, ok=ok)

    def set_slot_ns(self, slot: int, ns: str | None) -> None:
        """The tenant radix namespace of the slot's NEXT admission: its
        chains are matched and, at release, inserted salted with ``ns``
        (None: unsalted). The release pops it."""
        if ns is None:
            self._slot_ns.pop(slot, None)
        else:
            self._slot_ns[slot] = ns

    def _radix_may_admit(self) -> bool:
        """False while a recent allocation hit PoolExhausted: caching yields
        to live admissions before live admissions shed."""
        if time.monotonic() >= self._pressure_until:
            return True
        get_metrics().inc("radix.admission_denied")
        return False

    # ------------------------------------------------------------ warm state

    def slot_chain_blocks(self, slot: int) -> list[int]:
        """The in-order block chain covering ``slot``'s context: shared
        (prefix / radix-matched) blocks first, then owned ones. Valid mid
        chunked admission too: a block is fully written only once the
        compute frontier has passed it, which the disagg exporter tracks.
        Serving-loop thread only."""
        return list(self._slot_shared[slot]) + list(self._slot_owned[slot])

    def gather_chain_kv(self, blocks: list[int]):
        """Host copies of ``blocks``' KV in the stored format: bf16 values,
        or under ``KV_QUANT`` the int8 / packed int4 bytes and their bf16
        scale planes (a block's scales travel with it). Returns CPU tensors
        ``(k, v, k_scale | None, v_scale | None)`` shaped ``(L, n, bs, nkv,
        hd_store)`` / ``(L, n, bs, nkv)``. Serving-loop thread only."""
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        k = self.k_pool[:, idx].cpu()
        v = self.v_pool[:, idx].cpu()
        if self.kv_quant is None:
            return k, v, None, None
        return k, v, self.k_scale[:, idx].cpu(), self.v_scale[:, idx].cpu()

    def adopt_chain_kv(self, k, v, k_scale=None, v_scale=None) -> list[int]:
        """Allocate ``k.shape[1]`` blocks and write already-stored KV into
        them verbatim: the values by a plain scatter (re-quantizing
        quantized bytes would change them), the scale planes by their own.
        ``PoolExhausted`` propagates after ``_alloc``'s eviction retry; any
        fault frees the claim before it propagates. Serving-loop thread
        only."""
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        n = int(k.shape[1])
        if self.kv_quant is not None and (k_scale is None or v_scale is None):
            raise ValueError("quantized pool adoption needs scale planes")
        if tuple(v.shape) != tuple(k.shape):
            raise ValueError("adopted v shape disagrees with k")
        if k.dtype != self.k_pool.dtype or v.dtype != self.v_pool.dtype:
            raise ValueError(f"adopted KV is {k.dtype}, the pool stores {self.k_pool.dtype}")
        blocks = self._alloc(n)
        try:
            L, N, bs = self.k_pool.shape[:3]
            arr = np.asarray(blocks, np.int64)
            dst = torch.from_numpy((arr[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
                                   ).to(self.device)
            tail = tuple(self.k_pool.shape[3:])
            self.k_pool.view(L, N * bs, *tail)[:, dst] = k.reshape(L, n * bs, *tail).to(
                self.device)
            self.v_pool.view(L, N * bs, *tail)[:, dst] = v.reshape(L, n * bs, *tail).to(
                self.device)
            if self.kv_quant is not None:
                nkv = self.k_scale.shape[3]
                self.k_scale.view(L, N * bs, nkv)[:, dst] = torch.as_tensor(k_scale).reshape(
                    L, n * bs, nkv).to(self.device, torch.bfloat16)
                self.v_scale.view(L, N * bs, nkv)[:, dst] = torch.as_tensor(v_scale).reshape(
                    L, n * bs, nkv).to(self.device, torch.bfloat16)
        except Exception:
            # a skewed payload must not shrink the pool for good
            self.allocator.free(blocks)
            raise
        return blocks

    def warm_restart(self) -> None:
        """Throw away every slot's state and the allocator and radix
        bookkeeping after a wedged step, keeping the weights, the pool
        tensors and the static prefix: its blocks are re-reserved in a fresh
        allocator and re-pinned as the radix root (the pool's bytes were
        never suspect, only the bookkeeping). The tree keeps its
        ``max_nodes`` and tenant quotas. In-flight requests are the
        caller's to fail."""
        self.allocator = BlockAllocator(self.allocator.n_blocks)
        if self._prefix_blocks:
            self.allocator.reserve(self._prefix_blocks)
        if self.radix is not None:
            old = self.radix
            self.radix = RadixCache(self.allocator, self.block_size, max_nodes=old.max_nodes)
            self.radix.ns_quota = old.ns_quota
            full = len(self.prefix_ids) // self.block_size
            if full:
                self.radix.pin_root_chain(self.prefix_ids[:full * self.block_size],
                                          self._prefix_blocks)
        self._slot_shared = [[] for _ in range(self.batch_slots)]
        self._slot_owned = [[] for _ in range(self.batch_slots)]
        self._covered = [0] * self.batch_slots
        self._next_pos = [0] * self.batch_slots
        self._slot_ids = [None] * self.batch_slots
        self._slot_ns.clear()
        self._mid_prefill.clear()
        self.block_tables = torch.zeros_like(self.block_tables)
        self._pressure_until = 0.0
        self._nan_inject = None
        if self.spec is not None:
            # the generation fence: a verify loop wedged mid-chunk stops
            # dispatching against the fresh tables
            self.spec.reset()
        self._superseded = False
        # JAX re-arms its recompilation sentinel here; the port compiles no
        # XLA programs, so there is nothing to re-arm

    def generate(self, *a, **kw):
        raise ValueError("PagedDecodeEngine serves through the continuous batcher "
                         "(serve.scheduler.ContinuousBatcher); use the dense DecodeEngine "
                         "for single-request generate()")
