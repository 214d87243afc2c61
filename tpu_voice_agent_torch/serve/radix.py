"""Radix-tree KV reuse over the paged block pool (session prefix caching).

Port of ``tpu_voice_agent/serve/radix.py``. Every released request inserts
its prompt + generated chain into a tree keyed by token ids (one node per
FULL pool block, key = that block's ``block_size`` ids); admission runs a
longest-prefix match at block granularity and shares the matched blocks
read-only into the new slot's table, so only the partial-block tail and the
new utterance re-prefill. The static prompt prefix is the permanently pinned
root chain. When the pool runs out, LRU eviction frees leaves the tree alone
references (the allocator's refcounts are the single source of truth).

Plain host code, no tensors. Tenant namespaces (``TENANT_CLASSES``): with
``ns`` set, keys are salted ``(ns, ids)`` and the pinned static prefix stays
one shared chain; ``ns_quota`` (the tenancy plane's ``block_quota``,
installed by the batcher) caps a namespace's nodes, and a tenant over its
quota evicts its own least-recent leaves first. With no namespace in play
every path is the single-tenant one. The ``radix.cached_tokens`` and
``radix.evictions`` counters count as JAX's do; the batcher exports
``radix.nodes`` and ``radix.hit_rate`` each chunk
(``record_radix_gauges``). ``cached_tokens`` is the ref-free probe the
disagg stream adopter (``serve.handoff.StreamAdopter``) verifies its commit
with.
"""

from __future__ import annotations

import heapq
import itertools

from ..utils.tracing import get_metrics


class RadixNode:
    """One pool block's worth of cached context. ``key`` is the tuple of
    ``block_size`` token ids whose KV the block holds (``(ns, ids)`` in a
    namespace); the path from the root spells the full token prefix."""

    __slots__ = ("key", "block", "children", "parent", "last_use", "pinned", "ns")

    def __init__(self, key, block, parent, pinned: bool = False):
        self.key = key
        self.block = block  # pool block id | None (root)
        self.children: dict[tuple, RadixNode] = {}
        self.parent = parent
        self.last_use = 0
        self.pinned = pinned
        self.ns: str | None = None


class RadixCache:
    """Token-id-keyed radix tree of refcounted block chains over one
    allocator. Every owner holds exactly one ref per block:

    - the tree takes its own ref when it adopts a block (``insert`` /
      ``pin_root_chain``) and drops it at eviction / ``clear``;
    - ``match`` takes one ref per matched block FOR THE CALLER (the slot's
      release frees it like any other shared block);
    - eviction frees only unpinned leaves whose block the tree solely owns
      (refcount 1): a live slot's chain or the static prefix never goes.
    """

    def __init__(self, allocator, block_size: int, max_nodes: int = 4096):
        self.allocator = allocator
        self.block_size = block_size
        self.max_nodes = max_nodes
        self.root = RadixNode(None, None, None, pinned=True)
        self._n_nodes = 0
        self._clock = itertools.count(1)
        # tenant namespaces: adopted nodes per namespace, and the quota
        # lookup ns -> blocks (0: none) the batcher installs under tenancy
        self.ns_quota = None
        self._ns_nodes: dict[str, int] = {}
        self.lookups = 0
        self.hits = 0
        self.matched_tokens = 0
        self.evictions = 0
        self.inserts = 0

    # ------------------------------------------------------------ admission

    def _child(self, node: RadixNode, kt: tuple, ns: str | None) -> RadixNode | None:
        """The walk's next node: the namespace's salted node first, else a
        plain node (only a pinned one from inside a namespace)."""
        child = node.children.get((ns, kt)) if ns is not None else None
        if child is None:
            c = node.children.get(kt)
            if c is not None and (ns is None or c.pinned):
                child = c
        return child

    def match(self, ids: list[int], ns: str | None = None) -> tuple[list[int], int]:
        """Longest-prefix match at block granularity: (the matched chain,
        every block ref'd for the caller; the matched token count). Always
        leaves >= 1 token unmatched, so admission has a last real token to
        take first-sample logits from. Counts a lookup; the caller reports
        the hit with ``record_hit`` once it commits to the chain."""
        bs = self.block_size
        t = next(self._clock)
        self.lookups += 1
        node, blocks = self.root, []
        for i in range(max(0, (len(ids) - 1) // bs)):
            child = self._child(node, tuple(ids[i * bs:(i + 1) * bs]), ns)
            if child is None:
                break
            child.last_use = t
            blocks.append(child.block)
            node = child
        if blocks:
            self.allocator.ref(blocks)
        return blocks, len(blocks) * bs

    def cached_tokens(self, ids: list[int], ns: str | None = None) -> int:
        """How many leading tokens of ``ids`` a ``match`` would serve now,
        without its side effects: no allocator refs, no LRU clock, no
        lookup counted (a probe must not perturb eviction order)."""
        bs = self.block_size
        node, matched = self.root, 0
        for i in range(max(0, (len(ids) - 1) // bs)):
            node = self._child(node, tuple(ids[i * bs:(i + 1) * bs]), ns)
            if node is None:
                break
            matched += bs
        return matched

    def record_hit(self, matched: int) -> None:
        """Account a matched chain the engine committed to."""
        self.hits += 1
        self.matched_tokens += matched
        get_metrics().inc("radix.cached_tokens", float(matched))

    # ------------------------------------------------------------ insertion

    def insert(self, ids: list[int], blocks: list[int], ns: str | None = None) -> int:
        """Adopt a released request's chain: ``ids`` its full token history
        (prompt + generated), ``blocks`` the in-order pool blocks covering
        it. Only FULL blocks go in (a partial tail block is rewritten by
        whoever re-prefills past it). Existing nodes are kept; new nodes
        take one tree ref. With ``ns`` new nodes are salted into that
        namespace and an overlap with the pinned static chain rides the
        shared nodes, and a namespace at its ``ns_quota`` evicts its own
        least-recent leaf for each new node (nothing of its own evictable:
        adoption stops). At ``max_nodes`` one batched eviction makes room,
        or adoption stops. Returns the adopted count."""
        bs = self.block_size
        t = next(self._clock)
        node = self.root
        full = min(len(ids) // bs, len(blocks))
        adopted = 0
        evicted_for_capacity = False
        for i in range(full):
            kt = tuple(ids[i * bs:(i + 1) * bs])
            if ns is not None:
                plain = node.children.get(kt)
                if plain is not None and plain.pinned:
                    plain.last_use = t
                    node = plain
                    continue
                key = (ns, kt)
            else:
                key = kt
            child = node.children.get(key)
            if child is None:
                if ns is not None and self.ns_quota is not None:
                    q = self.ns_quota(ns)
                    if q > 0 and self._ns_nodes.get(ns, 0) >= q and not self.evict(1, ns=ns):
                        break  # over quota with nothing of its own evictable
                if self._n_nodes >= self.max_nodes:
                    if evicted_for_capacity or not self.evict(full - i):
                        break  # at capacity with nothing evictable
                    evicted_for_capacity = True
                child = RadixNode(key, blocks[i], node)
                child.ns = ns
                self.allocator.ref([blocks[i]])
                node.children[key] = child
                self._n_nodes += 1
                if ns is not None:
                    self._ns_nodes[ns] = self._ns_nodes.get(ns, 0) + 1
                self.inserts += 1
                adopted += 1
            child.last_use = t
            node = child
        return adopted

    def pin_root_chain(self, ids: list[int], blocks: list[int]) -> None:
        """Install the static prompt prefix's FULL blocks as the permanently
        pinned root chain."""
        bs = self.block_size
        t = next(self._clock)
        node = self.root
        for i in range(min(len(ids) // bs, len(blocks))):
            key = tuple(ids[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, blocks[i], node, pinned=True)
                self.allocator.ref([blocks[i]])
                node.children[key] = child
                self._n_nodes += 1
            else:
                child.pinned = True
            child.last_use = t
            node = child

    # ------------------------------------------------------------ eviction

    def _evictable(self, node: RadixNode) -> bool:
        return (node is not self.root and not node.children and not node.pinned
                and self.allocator.refcount(node.block) == 1)

    def _nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def evict(self, need: int, ns: str | None = None) -> int:
        """Free up to ``need`` blocks from least-recently-used unreferenced
        leaves (cascading: a parent whose last child left becomes a
        candidate); with ``ns`` only that namespace's nodes. Returns how
        many blocks were freed."""
        heap = [(n.last_use, id(n), n) for n in self._nodes()
                if self._evictable(n) and (ns is None or n.ns == ns)]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < need:
            _, _, n = heapq.heappop(heap)
            if (not self._evictable(n) or n.parent is None
                    or n.parent.children.get(n.key) is not n):
                continue  # stale entry
            parent = n.parent
            del parent.children[n.key]
            self.allocator.free([n.block])
            self._n_nodes -= 1
            if n.ns is not None:
                self._ns_nodes[n.ns] = max(0, self._ns_nodes.get(n.ns, 1) - 1)
            self.evictions += 1
            freed += 1
            if self._evictable(parent) and (ns is None or parent.ns == ns):
                heapq.heappush(heap, (parent.last_use, id(parent), parent))
        if freed:
            get_metrics().inc("radix.evictions", float(freed))
        return freed

    def clear(self) -> None:
        """Drop every node (pinned included) and free the tree's refs."""
        for n in list(self._nodes()):
            self.allocator.free([n.block])
        self.root.children.clear()
        self._n_nodes = 0
        self._ns_nodes.clear()

    # ------------------------------------------------------------ stats

    def chains(self) -> list[list[int]]:
        """Every root-to-leaf token-id chain currently cached."""
        out: list[list[int]] = []

        def walk(node: RadixNode, ids: list[int]) -> None:
            if not node.children:
                if ids:
                    out.append(list(ids))
                return
            for child in node.children.values():
                kt = child.key[1] if child.ns is not None else child.key
                walk(child, ids + list(kt))

        walk(self.root, [])
        return out

    def reclaimable_blocks(self) -> int:
        """Unpinned nodes whose block the tree solely owns: what eviction
        could hand back (a slight overcount when a sole-owned mid-chain node
        has a live-referenced descendant)."""
        return sum(1 for n in self._nodes()
                   if not n.pinned and self.allocator.refcount(n.block) == 1)

    @property
    def nodes(self) -> int:
        return self._n_nodes

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


def record_radix_gauges(trees: list[RadixCache]) -> None:
    """Export the radix plane's occupancy and hit rate (summed over trees)."""
    m = get_metrics()
    lookups = sum(t.lookups for t in trees)
    hits = sum(t.hits for t in trees)
    m.set_gauge("radix.nodes", float(sum(t.nodes for t in trees)))
    m.set_gauge("radix.hit_rate", hits / lookups if lookups else 0.0)
