"""Radix-tree prefix cache over the paged KV allocator, with the host
spill tier's residency rungs (port of `paddle_tpu/serving/radix_cache.py`).

SGLang's RadixAttention: completed (or evicted) sequences donate their
KV pages into a radix tree keyed by token content; a new request walks
the tree at intake, reuses the longest cached block-aligned prefix
through the allocator's ref-counted sharing, and only prefills the
remainder. Zero-active-ref cached nodes are LRU-evicted when the
allocator runs dry — BEFORE any running request is preempted. With a
spill bridge attached (`set_spill`), eviction first DEMOTES a node's
pages to host RAM and a later match PROMOTES them back.

Granularity is the allocator's page: every edge covers a whole number
of pages (len(node.key) == len(node.pages) * page_size), children are
keyed by their edge's FIRST PAGE of tokens, and node splits only happen
at page boundaries.

Reference-count contract: the tree holds exactly ONE allocator ref for
every device page it stores (taken at `insert`, released at
eviction/`clear`), and one store ref for every host page. A request
that matches a prefix takes its own refs via
`BlockAllocator.alloc_sequence_with_prefix`; eviction of a node whose
pages live sequences still hold only forgets the cached entry. Matching
never mutates refcounts. LRU ordering uses a monotonic use-counter, not
wall-clock, so scheduling stays replayable.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..utils import faults
from .kv_cache import (BlockAllocator, HostPageCorrupt, HostPageLost,
                       HostPageSlow)

__all__ = ["RadixCache", "RadixNode"]

# Donation failure: the scheduler's finish/preempt paths must treat a
# failed insert as "nothing cached" — the donor still frees normally.
FAULT_INSERT = faults.register_point("serving.radix.insert")


class RadixNode:
    """One edge+node of the tree: `key` is the token run along the edge
    into this node, `pages` the KV pages holding those tokens.

    Residency: a non-root node is either DEVICE-resident
    (`pages` holds device ids, each carrying one tree ref on the
    BlockAllocator) or HOST-resident (`host_pages` holds HostPageStore
    ids, each carrying one tree ref there; `pages` is empty) — never
    both. The in-flight window of a promotion is device-side only: the
    host bookkeeping flips host->device atomically when the async copy
    is enqueued, and the device stream orders the copy before any
    kernel that reads the page."""

    __slots__ = ("key", "pages", "host_pages", "children", "parent",
                 "last_use")

    def __init__(self, key=(), pages=None, parent=None):
        self.key: Tuple[int, ...] = tuple(key)
        self.pages: List[int] = list(pages or [])
        self.host_pages: List[int] = []
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.parent: Optional["RadixNode"] = parent

    def __repr__(self):
        where = f"host_pages={self.host_pages}" if self.host_pages \
            else f"pages={self.pages}"
        return (f"RadixNode(tokens={len(self.key)}, {where}, "
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
        # host spill tier: None = device-only. The bridge is
        # engine-owned (the tree has no device access) and provides:
        #   host_free() -> int                free host pages
        #   demote(pids) -> hids | None       device gather -> host store
        #   promote(hids) -> pids | None      host -> device async scatter
        #                                     (raises HostPageError kinds)
        #   release(hids)                     drop the tree's host refs
        #   holds(hid) -> bool                store still holds the id
        self.spill = None
        # counters the metrics provider reads
        self.num_evicted_pages = 0
        self.num_inserted_pages = 0
        # eviction rungs: which rung each eviction took — demote to host
        # or drop — so spill hit-rate claims audit from counters alone
        self.num_evict_demoted = 0
        self.num_evict_dropped = 0
        # spill traffic counters
        self.num_demoted_pages = 0
        self.num_promoted_pages = 0
        self.num_host_hits = 0
        self.num_host_dropped_pages = 0
        # incremental size counters: the engine reads these as gauges
        # every step, so they must not cost a tree walk
        self._cached_pages = 0
        self._nodes = 0
        self._host_pages = 0

    def set_spill(self, bridge):
        """Attach the engine's host-spill bridge (see __init__)."""
        self.spill = bridge

    def _bump(self, node):
        self._tick += 1
        node.last_use = self._tick

    def _edge_key(self, tokens):
        return tuple(tokens[:self.page_size])

    # ---- lookup ----------------------------------------------------------
    def _walk_prefix(self, tokens):
        """Shared edge-walk under both lookups: yield (child,
        full_pages_matched_on_edge) down the longest cached prefix of
        `tokens`, stopping at a missing child or a mid-edge divergence.
        Pure traversal — bumping (or not) is the caller's policy, which
        is the whole difference between `match` and `match_len`."""
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

    def match(self, tokens, promote_budget=None) -> Tuple[List[int], int]:
        """Longest cached block-aligned prefix of `tokens`.

        Returns (pages, num_matched_tokens) with num_matched ==
        len(pages) * page_size. Read-only except for the LRU bump on
        every node touched; the caller must convert the match into
        sequence refs (alloc_sequence_with_prefix) before anything else
        can evict — matched pages are also the freshest LRU entries, and
        `evict(protect=...)` exists for the admission retry path.

        Host-resident nodes on the walk are PROMOTED back to device
        pages (async host->device copy, enqueued here and overlapped
        with the prefill launch the scheduler is about to build).
        `promote_budget` is the scheduler's remaining chunked-prefill
        token budget: a promotion moves the same bytes a prefill of
        those tokens would write, so it is charged against the same
        budget (whole nodes only — a node that does not fit waits for a
        later step). Any promotion failure — budget, device pages dry,
        or a host_spill fault — STOPS the match at the last device-
        resident token: the remainder recomputes through normal chunked
        prefill, which preserves bit-identity by construction.
        """
        pages: List[int] = []
        for child, full in self._walk_prefix(tokens):
            if child.host_pages:
                if self.spill is None:
                    break
                need_tokens = len(child.host_pages) * self.page_size
                if promote_budget is not None \
                        and promote_budget < need_tokens:
                    break
                if not self._promote_node(child):
                    break
                if promote_budget is not None:
                    promote_budget -= need_tokens
                self.num_host_hits += 1
            pages.extend(child.pages[:full])
            self._bump(child)
        return pages, len(pages) * self.page_size

    def match_len(self, tokens) -> int:
        """READ-ONLY longest-prefix probe: the token count `match()`
        would report (same walk by construction), with NO LRU bump
        (eviction order untouched) and no refcount change. The fleet
        router scores every replica's cache with this on every
        submission — a probe that bumped LRU entries would let routing
        traffic (including for requests that land elsewhere) distort
        each replica's eviction order. Host-resident spans COUNT (they
        are servable without recompute — exactly what the router wants
        to know) but are NOT promoted."""
        return sum(full for _, full in self._walk_prefix(tokens)) \
            * self.page_size

    def _promote_node(self, node) -> bool:
        """Host -> device for one node. True iff the node is device-
        resident on return. Failure handling mirrors the fault points:
        slow keeps the node (the payload is intact — a later match
        retries), corrupt/lost drop the node AND its subtree (the
        prefix chain through it is broken, so descendants are
        unreachable by any match)."""
        try:
            pids = self.spill.promote(node.host_pages)
        except HostPageSlow:
            return False
        except (HostPageCorrupt, HostPageLost):
            self._drop_subtree(node)
            return False
        if pids is None:                   # device pool dry: recompute
            return False
        self.spill.release(node.host_pages)
        self._host_pages -= len(node.host_pages)
        self._cached_pages += len(pids)
        self.num_promoted_pages += len(pids)
        node.pages = list(pids)
        node.host_pages = []
        return True

    # ---- insertion (donation) -------------------------------------------
    def insert(self, tokens, pages) -> int:
        """Donate `pages` holding the KV of `tokens` (len(tokens) ==
        len(pages) * page_size; the caller truncates to full pages).

        The tree takes its own allocator ref on every page it ADOPTS;
        spans already cached keep the existing pages (the donor's
        duplicates are simply not adopted). The caller retains its refs
        and frees its sequence normally afterwards. Returns the number
        of newly adopted pages."""
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
                adopted += self._readopt(child, pages)
                node = child
                tokens = tokens[n:]
                pages = pages[n // self.page_size:]
                continue
            # diverged (or ran out of tokens) inside the edge: split at
            # the last shared page boundary and continue under the upper
            # half (aligned <= n < len(child.key), so the split is real)
            self._split(child, aligned)
            adopted += self._readopt(child, pages)
            node = child
            tokens = tokens[aligned:]
            pages = pages[aligned // self.page_size:]
        self.num_inserted_pages += adopted
        return adopted

    def _readopt(self, node, donor_pages) -> int:
        """Insert walked onto a HOST-resident span the donor holds
        device pages for: adopt the donor's pages (residency repair for
        free — no host->device copy) and release the host copies. The
        node's span is fully covered by the donor here (callers only
        reach this after matching the whole — possibly just-split —
        edge). No-op for device-resident nodes."""
        if not node.host_pages:
            return 0
        k = len(node.key) // self.page_size
        fresh = list(donor_pages[:k])
        assert len(fresh) == k
        for pid in fresh:
            self.allocator._incref(pid)
        if self.spill is not None:
            self.spill.release(node.host_pages)
        self._host_pages -= len(node.host_pages)
        self._cached_pages += k
        node.pages = fresh
        node.host_pages = []
        return k

    def _split(self, child, at):
        """Split `child`'s edge at token offset `at` (a page multiple):
        child becomes the upper node; a new node takes the tail."""
        assert at % self.page_size == 0 and 0 < at < len(child.key)
        cut = at // self.page_size
        tail = RadixNode(child.key[at:], child.pages[cut:], parent=child)
        tail.host_pages = child.host_pages[cut:]
        tail.children = child.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_use = child.last_use
        child.key = child.key[:at]
        child.pages = child.pages[:cut]
        child.host_pages = child.host_pages[:cut]
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
        """LRU-evict device-resident leaf-rung nodes until >=
        `need_pages` pages actually hit the free list (or nothing
        evictable remains). Leaves whose pages are ALL still shared with
        live sequences are skipped — evicting them frees nothing and
        throws away a reusable prefix. `protect` pages (e.g. a match the
        scheduler is about to take refs on) are never evicted. Returns
        pages freed.

        Eviction rungs: with a spill bridge attached each
        victim is DEMOTED to host RAM first (KV bytes survive; the
        device pages free) and only DROPPED when the host pool cannot
        take it even after LRU-dropping host leaves. The rung taken is
        counted (num_evict_demoted / num_evict_dropped) so hit-rate
        claims audit from counters alone. Host-resident children do not
        shield a node from the rung (they hold no device pages), but a
        drop beneath them severs their prefix, so the drop rung drops
        that subtree too."""
        protect = set(protect)
        freed = 0
        while freed < need_pages:
            best = None
            for n in self._iter_nodes():
                if not n.pages or (protect & set(n.pages)):
                    continue               # host-resident or protected
                if any(c.pages for c in n.children.values()):
                    continue               # a device child: not the rung
                if not any(self.allocator._refs.get(p) == 1
                           for p in n.pages):
                    continue               # all shared: frees nothing
                if best is None or n.last_use < best.last_use:
                    best = n
            if best is None:
                break
            got = self._demote_node(best) if self.spill is not None \
                else None
            if got is None:
                for c in list(best.children.values()):
                    self._drop_subtree(c)  # orphaned host descendants
                freed += self._drop_node(best)
                self.num_evict_dropped += 1
            else:
                freed += got
                self.num_evict_demoted += 1
        return freed

    def _demote_node(self, node):
        """Device -> host for one node: gather the pages' bytes into the
        host store (making room by LRU-dropping host leaves if needed),
        then release the tree's device refs. Returns pages actually
        freed to the device free list, or None when the host tier cannot
        take the node (caller falls through to the drop rung)."""
        need = len(node.pages)
        if self.spill.host_free() < need:
            self._evict_host(need - self.spill.host_free(), keep=node)
        if self.spill.host_free() < need:
            return None
        hids = self.spill.demote(node.pages)
        if hids is None:
            return None
        before = self.allocator.num_free
        for pid in node.pages:
            self.allocator._decref(pid)
        freed = self.allocator.num_free - before
        self.num_evicted_pages += freed
        self.num_demoted_pages += len(hids)
        self._cached_pages -= len(node.pages)
        self._host_pages += len(hids)
        node.host_pages = list(hids)
        node.pages = []
        return freed

    def _evict_host(self, need: int, keep=None) -> int:
        """LRU-drop childless host-resident nodes until `need` host
        pages are free (or none remain). `keep` shields the node a
        demotion is making room for."""
        freed = 0
        while freed < need:
            best = None
            for n in self._iter_nodes():
                if n is keep or not n.host_pages or n.children:
                    continue
                if best is None or n.last_use < best.last_use:
                    best = n
            if best is None:
                break
            freed += len(best.host_pages)
            self._drop_host_node(best)
        return freed

    def _drop_host_node(self, node):
        """Remove a host-resident node, releasing its host refs. (After
        a host_spill.lost fault the store has already forgotten the lost
        id; the bridge's release tolerates exactly that.)"""
        if self.spill is not None:
            self.spill.release(node.host_pages)
        self.num_host_dropped_pages += len(node.host_pages)
        del node.parent.children[self._edge_key(node.key)]
        self._nodes -= 1
        self._host_pages -= len(node.host_pages)

    def _drop_subtree(self, node):
        """Drop `node` and every descendant, whatever their residency."""
        for c in list(node.children.values()):
            self._drop_subtree(c)
        if node.host_pages:
            self._drop_host_node(node)
        else:
            self._drop_node(node)

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
        """Drop every cached node (releases the tree's refs on BOTH
        tiers); returns device pages returned to the free list."""
        before = self.allocator.num_free
        for node in list(self._iter_nodes()):
            for pid in node.pages:
                self.allocator._decref(pid)
            if node.host_pages and self.spill is not None:
                self.spill.release(node.host_pages)
            self.num_host_dropped_pages += len(node.host_pages)
        self.root = RadixNode()
        self.root.last_use = self._tick
        self._cached_pages = 0
        self._nodes = 0
        self._host_pages = 0
        return self.allocator.num_free - before

    # ---- introspection ---------------------------------------------------
    @property
    def num_cached_pages(self) -> int:
        return self._cached_pages

    @property
    def num_host_pages(self) -> int:
        return self._host_pages

    @property
    def num_nodes(self) -> int:
        return self._nodes

    def check_invariants(self):
        """Test hook: page-aligned edges, child keys match edge heads,
        every stored page holds a live ref on its tier, exactly one
        residency per node, size counters agree with a full recount."""
        assert self._cached_pages == \
            sum(len(n.pages) for n in self._iter_nodes())
        assert self._host_pages == \
            sum(len(n.host_pages) for n in self._iter_nodes())
        assert self._nodes == sum(1 for _ in self._iter_nodes())
        for node in self._iter_nodes():
            assert not (node.pages and node.host_pages), \
                "node on both residency tiers"
            held = node.host_pages or node.pages
            assert len(node.key) == len(held) * self.page_size
            assert node.key, "empty edge"
            assert node.parent.children[self._edge_key(node.key)] is node
            for k, c in node.children.items():
                assert k == self._edge_key(c.key)
            for pid in node.pages:
                assert self.allocator._refs.get(pid, 0) >= 1, \
                    f"tree page {pid} has no allocator ref"
            if node.host_pages:
                assert self.spill is not None, \
                    "host-resident node with no spill bridge"
                for hid in node.host_pages:
                    assert self.spill.holds(hid), \
                        f"tree host page {hid} has no store ref"
