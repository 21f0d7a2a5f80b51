"""Paged KV-cache block management for the serving engine (port of
`paddle_tpu/serving/kv_cache.py`; the host spill tier is not ported).

Host-side bookkeeping only: pages are integer ids into the device-side
(num_pages, KVH, page_size, D) cache tensors owned by the engine; this
module decides WHICH page holds WHICH tokens. Fixed-size pages, a free
list, per-page reference counts so a forked prefix shares pages
copy-on-write (vLLM's PagedAttention block manager).

Kernel contract (kernels/paged_attention.py): page 0 is the reserved pad
page — block-table slots past a sequence's live pages hold it, and
reads of it are masked by seq_lens. The allocator never hands it out.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np

from ..utils import faults

__all__ = ["BlockAllocator", "KVSequence", "BlocksExhausted", "PAD_PAGE"]

PAD_PAGE = 0

# An armed spec makes _alloc_page raise BlocksExhausted as if the pool
# were dry — the scheduler must degrade through its reclamation ladder
# (radix LRU eviction, then preempt-by-eviction), never crash or leak.
FAULT_ALLOC = faults.register_point("serving.kv.alloc_page")


class BlocksExhausted(Exception):
    """No free page — the scheduler turns this into a preemption."""


class KVSequence:
    """One sequence's view of the cache: ordered page ids + token count.
    Page j covers token positions [j*page_size, (j+1)*page_size)."""

    __slots__ = ("pages", "num_tokens", "freed")

    def __init__(self):
        self.pages: List[int] = []
        self.num_tokens = 0
        self.freed = False

    def num_pages(self):
        return len(self.pages)


class BlockAllocator:
    """Ref-counted page allocator over `num_pages` fixed-size pages.

    Invariant: every page is either in the free list with refcount 0 or
    held by >= 1 sequences with a positive refcount — never both, never
    negative.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the pad page)")
        if page_size <= 0 or page_size % 8 != 0:
            raise ValueError(f"page_size {page_size} must be a positive "
                             "multiple of 8")
        self.num_pages = num_pages
        self.page_size = page_size
        # FIFO free list: steady-state serving cycles through the pages
        # instead of hammering the most recently freed ones
        self._free = deque(range(1, num_pages))
        self._refs: Dict[int, int] = {}

    # ---- low-level page ops ---------------------------------------------
    def _alloc_page(self) -> int:
        if faults.fire(FAULT_ALLOC) is not None:
            raise BlocksExhausted("injected allocator OOM")
        if not self._free:
            raise BlocksExhausted(
                f"all {self.num_pages - 1} KV pages in use")
        pid = self._free.popleft()
        self._refs[pid] = 1
        return pid

    def _incref(self, pid: int):
        self._refs[pid] += 1

    def _decref(self, pid: int):
        r = self._refs.get(pid)
        if r is None or r <= 0:
            raise RuntimeError(f"double free of page {pid}")
        if r == 1:
            del self._refs[pid]
            self._free.append(pid)
        else:
            self._refs[pid] = r - 1

    # ---- occupancy -------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def occupancy(self) -> float:
        return self.num_used / float(self.num_pages - 1)

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def can_allocate(self, num_tokens: int) -> bool:
        return self.pages_needed(num_tokens) <= self.num_free

    # ---- sequence API ----------------------------------------------------
    def _alloc_pages(self, n: int) -> List[int]:
        """n fresh pages, all-or-nothing: a mid-loop BlocksExhausted
        (possible via the injected-OOM fault even after a num_free
        pre-check) rolls the partial allocation back before re-raising."""
        got: List[int] = []
        try:
            for _ in range(n):
                got.append(self._alloc_page())
        except BlocksExhausted:
            for pid in got:
                self._decref(pid)
            raise
        return got

    def alloc_sequence(self, num_tokens: int) -> KVSequence:
        """Pages for `num_tokens` tokens (a prompt about to prefill).
        All-or-nothing: on exhaustion nothing is held."""
        need = self.pages_needed(num_tokens)
        if need > self.num_free:
            raise BlocksExhausted(
                f"need {need} pages, {self.num_free} free")
        seq = KVSequence()
        seq.pages = self._alloc_pages(need)
        seq.num_tokens = num_tokens
        return seq

    def alloc_sequence_with_prefix(self, num_tokens,
                                   prefix_pages) -> KVSequence:
        """Pages for `num_tokens` tokens whose first
        len(prefix_pages) * page_size tokens are already cached: the
        prefix pages are SHARED (refcounts bumped) and only the
        remainder is freshly allocated. All-or-nothing."""
        need = self.pages_needed(num_tokens)
        if len(prefix_pages) > need:
            raise ValueError(
                f"prefix of {len(prefix_pages)} pages exceeds the "
                f"{need} pages {num_tokens} tokens need")
        fresh = need - len(prefix_pages)
        if fresh > self.num_free:
            raise BlocksExhausted(
                f"need {fresh} fresh pages, {self.num_free} free")
        seq = KVSequence()
        for pid in prefix_pages:
            self._incref(pid)
        try:
            fresh_pages = self._alloc_pages(fresh)
        except BlocksExhausted:
            for pid in prefix_pages:   # all-or-nothing: drop shared refs
                self._decref(pid)
            raise
        seq.pages = list(prefix_pages) + fresh_pages
        seq.num_tokens = num_tokens
        return seq

    def append_token(self, seq: KVSequence) -> List[Tuple[int, int]]:
        """Grow `seq` by one token, returning the (src_page, dst_page)
        device copies the caller must perform (copy-on-write when the
        written page is shared with a fork; empty list otherwise)."""
        if seq.freed:
            raise RuntimeError("append to a freed sequence")
        copies: List[Tuple[int, int]] = []
        pos = seq.num_tokens
        j = pos // self.page_size
        if j == len(seq.pages):            # crossing into a new page
            seq.pages.append(self._alloc_page())
        else:
            pid = seq.pages[j]
            if self._refs[pid] > 1:        # shared with a fork: CoW
                new = self._alloc_page()
                self._decref(pid)
                seq.pages[j] = new
                copies.append((pid, new))
        seq.num_tokens = pos + 1
        return copies

    def truncate_sequence(self, seq: KVSequence, num_tokens: int):
        """Shrink `seq` to its first `num_tokens` tokens, releasing the
        pages that covered only the dropped tail (through `_decref`, so
        shared pages merely lose this sequence's ref)."""
        if seq.freed:
            raise RuntimeError("truncate of a freed sequence")
        num_tokens = int(num_tokens)
        if not 0 <= num_tokens <= seq.num_tokens:
            raise ValueError(
                f"truncate to {num_tokens} outside [0, {seq.num_tokens}]")
        keep = self.pages_needed(num_tokens)
        dropped = seq.pages[keep:]
        del seq.pages[keep:]
        for pid in dropped:
            self._decref(pid)
        seq.num_tokens = num_tokens

    def fork_sequence(self, seq: KVSequence) -> KVSequence:
        """Prefix fork: the child shares every page (refcounts bumped);
        the first divergent append to a shared page triggers CoW."""
        if seq.freed:
            raise RuntimeError("fork of a freed sequence")
        child = KVSequence()
        child.pages = list(seq.pages)
        child.num_tokens = seq.num_tokens
        for pid in child.pages:
            self._incref(pid)
        return child

    def free_sequence(self, seq: KVSequence):
        if seq.freed:
            raise RuntimeError("double free of sequence")
        for pid in seq.pages:
            self._decref(pid)
        seq.pages = []
        seq.num_tokens = 0
        seq.freed = True

    # ---- kernel-facing tensors ------------------------------------------
    def block_table(self, seqs, max_pages: int) -> np.ndarray:
        """(B, max_pages) int32 block table; unused slots hold PAD_PAGE
        (the `paged_attention_decode` padding contract)."""
        bt = np.full((len(seqs), max_pages), PAD_PAGE, np.int32)
        for i, s in enumerate(seqs):
            if len(s.pages) > max_pages:
                raise ValueError(
                    f"sequence holds {len(s.pages)} pages > table width "
                    f"{max_pages}")
            bt[i, :len(s.pages)] = s.pages
        return bt

    def seq_lens(self, seqs) -> np.ndarray:
        return np.asarray([s.num_tokens for s in seqs], np.int32)

    def check_invariants(self):
        """Test hook: free list and refcounts partition the pages."""
        free = set(self._free)
        held = set(self._refs)
        assert not (free & held), f"pages both free and held: {free & held}"
        assert all(r > 0 for r in self._refs.values())
        assert PAD_PAGE not in free and PAD_PAGE not in held
        assert len(free) + len(held) == self.num_pages - 1
