"""Radix-tree prefix cache over the paged KV allocator (port of
`paddle_tpu/serving/radix_cache.py`, device tier only: the host spill
hooks are not ported).

SGLang's RadixAttention: completed (or evicted) sequences donate their
KV pages into a radix tree keyed by token content; a new request walks
the tree at intake, reuses the longest cached block-aligned prefix
through the allocator's ref-counted sharing, and only prefills the
remainder. Zero-active-ref cached nodes are LRU-evicted when the
allocator runs dry — BEFORE any running request is preempted.

Granularity is the allocator's page: every edge covers a whole number
of pages (len(node.key) == len(node.pages) * page_size), children are
keyed by their edge's FIRST PAGE of tokens, and node splits only happen
at page boundaries.

Reference-count contract: the tree holds exactly ONE allocator ref for
every page it stores (taken at `insert`, released at eviction/`clear`).
Matching never mutates refcounts. LRU ordering uses a monotonic
use-counter, not wall-clock, so scheduling stays replayable.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..utils import faults
from .kv_cache import BlockAllocator

__all__ = ["RadixCache", "RadixNode"]

# Donation failure: the scheduler's finish/preempt paths must treat a
# failed insert as "nothing cached" — the donor still frees normally.
FAULT_INSERT = faults.register_point("serving.radix.insert")


class RadixNode:
    """One edge+node of the tree: `key` is the token run along the edge
    into this node, `pages` the KV pages holding those tokens."""

    __slots__ = ("key", "pages", "children", "parent", "last_use")

    def __init__(self, key=(), pages=None, parent=None):
        self.key: Tuple[int, ...] = tuple(key)
        self.pages: List[int] = list(pages or [])
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.parent: Optional["RadixNode"] = parent

    def __repr__(self):
        return (f"RadixNode(tokens={len(self.key)}, pages={self.pages}, "
                f"children={len(self.children)})")


def _lcp(a, b):
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class RadixCache:
    """Prefix cache: token sequences -> KV pages, page-granular."""

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self.page_size = allocator.page_size
        self.root = RadixNode()
        self.root.last_use = 0
        self._tick = 0
        self.num_evicted_pages = 0
        self.num_inserted_pages = 0
        # incremental size counters: the engine reads these as gauges
        # every step, so they must not cost a tree walk
        self._cached_pages = 0
        self._nodes = 0

    def _bump(self, node):
        self._tick += 1
        node.last_use = self._tick

    def _edge_key(self, tokens):
        return tuple(tokens[:self.page_size])

    # ---- lookup ----------------------------------------------------------
    def _walk_prefix(self, tokens):
        """Yield (child, full_pages_matched_on_edge) down the longest
        cached prefix of `tokens`, stopping at a missing child or a
        mid-edge divergence."""
        tokens = tuple(tokens)
        node = self.root
        while len(tokens) >= self.page_size:
            child = node.children.get(self._edge_key(tokens))
            if child is None:
                return
            n = _lcp(child.key, tokens)
            yield child, n // self.page_size
            if n < len(child.key):
                return                     # diverged (or ran out) mid-edge
            node = child
            tokens = tokens[n:]

    def match(self, tokens) -> Tuple[List[int], int]:
        """Longest cached block-aligned prefix of `tokens`: (pages,
        num_matched_tokens) with num_matched == len(pages) * page_size.
        Read-only except for the LRU bump on every node touched; the
        caller converts the match into sequence refs
        (alloc_sequence_with_prefix) before anything else can evict."""
        pages: List[int] = []
        for child, full in self._walk_prefix(tokens):
            pages.extend(child.pages[:full])
            self._bump(child)
        return pages, len(pages) * self.page_size

    # ---- insertion (donation) -------------------------------------------
    def insert(self, tokens, pages) -> int:
        """Donate `pages` holding the KV of `tokens` (len(tokens) ==
        len(pages) * page_size). The tree takes its own allocator ref on
        every page it ADOPTS; spans already cached keep the existing
        pages. Returns the number of newly adopted pages."""
        faults.fire(FAULT_INSERT)
        tokens = tuple(tokens)
        if len(tokens) != len(pages) * self.page_size:
            raise ValueError(
                f"insert needs page-aligned tokens: {len(tokens)} tokens "
                f"vs {len(pages)} pages of {self.page_size}")
        node = self.root
        adopted = 0
        while tokens:
            child = node.children.get(self._edge_key(tokens))
            if child is None:
                new = RadixNode(tokens, pages, parent=node)
                for pid in new.pages:
                    self.allocator._incref(pid)
                adopted += len(new.pages)
                node.children[self._edge_key(tokens)] = new
                self._nodes += 1
                self._cached_pages += len(new.pages)
                self._bump(new)
                break
            n = _lcp(child.key, tokens)
            aligned = (n // self.page_size) * self.page_size
            # the dict hit guarantees the first page matched in full
            assert aligned >= self.page_size
            self._bump(child)
            if n == len(child.key):
                node = child
                tokens = tokens[n:]
                pages = pages[n // self.page_size:]
                continue
            # diverged (or ran out of tokens) inside the edge: split at
            # the last shared page boundary and continue under the upper
            # half
            self._split(child, aligned)
            node = child
            tokens = tokens[aligned:]
            pages = pages[aligned // self.page_size:]
        self.num_inserted_pages += adopted
        return adopted

    def _split(self, child, at):
        """Split `child`'s edge at token offset `at` (a page multiple):
        child becomes the upper node; a new node takes the tail."""
        assert at % self.page_size == 0 and 0 < at < len(child.key)
        cut = at // self.page_size
        tail = RadixNode(child.key[at:], child.pages[cut:], parent=child)
        tail.children = child.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_use = child.last_use
        child.key = child.key[:at]
        child.pages = child.pages[:cut]
        child.children = {self._edge_key(tail.key): tail}
        self._nodes += 1               # pages just moved between nodes

    # ---- eviction --------------------------------------------------------
    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def evict(self, need_pages: int, protect=()) -> int:
        """LRU-evict leaf nodes until >= `need_pages` pages actually hit
        the free list (or nothing evictable remains). Leaves whose pages
        are ALL still shared with live sequences are skipped — evicting
        them frees nothing. `protect` pages are never evicted. Returns
        pages freed."""
        protect = set(protect)
        freed = 0
        while freed < need_pages:
            best = None
            for n in self._iter_nodes():
                if n.children or (protect & set(n.pages)):
                    continue
                if not any(self.allocator._refs.get(p) == 1
                           for p in n.pages):
                    continue               # all shared: frees nothing
                if best is None or n.last_use < best.last_use:
                    best = n
            if best is None:
                break
            freed += self._drop_node(best)
        return freed

    def _drop_node(self, node) -> int:
        before = self.allocator.num_free
        for pid in node.pages:
            self.allocator._decref(pid)
        del node.parent.children[self._edge_key(node.key)]
        self._nodes -= 1
        self._cached_pages -= len(node.pages)
        freed = self.allocator.num_free - before
        self.num_evicted_pages += freed
        return freed

    def clear(self) -> int:
        """Drop every cached node (releases the tree's refs); returns
        pages returned to the free list."""
        before = self.allocator.num_free
        for node in list(self._iter_nodes()):
            for pid in node.pages:
                self.allocator._decref(pid)
        self.root = RadixNode()
        self.root.last_use = self._tick
        self._cached_pages = 0
        self._nodes = 0
        return self.allocator.num_free - before

    # ---- introspection ---------------------------------------------------
    @property
    def num_cached_pages(self) -> int:
        return self._cached_pages

    @property
    def num_nodes(self) -> int:
        return self._nodes

    def check_invariants(self):
        """Test hook: page-aligned edges, child keys match edge heads,
        every stored page holds a live ref, size counters agree with a
        full recount."""
        assert self._cached_pages == \
            sum(len(n.pages) for n in self._iter_nodes())
        assert self._nodes == sum(1 for _ in self._iter_nodes())
        for node in self._iter_nodes():
            assert len(node.key) == len(node.pages) * self.page_size
            assert node.key, "empty edge"
            assert node.parent.children[self._edge_key(node.key)] is node
            for k, c in node.children.items():
                assert k == self._edge_key(c.key)
            for pid in node.pages:
                assert self.allocator._refs.get(pid, 0) >= 1, \
                    f"tree page {pid} has no allocator ref"
