"""Draft-model proposer: a smaller causal LM drafts K tokens per step
(port of `paddle_tpu/serving/spec/draft_model.py`).

The two-model speculative setup: a cheap `LlamaForCausalLM`-protocol
model proposes K continuation tokens greedily, which the target then
scores in one verify launch. The draft model owns its OWN
`BlockAllocator` and paged K/V caches in the layout the paged-decode
kernel reads, and its device work is two kinds of bucketed launches: a
per-sequence catch-up CHUNK (`forward_paged_prefill`) and a BATCHED
greedy decode step (`forward_paged_decode`, the paged-decode kernel on
the card).

Each step the draft's cache is synced to the target's accepted history
(`_sync`: truncated to the longest still-valid prefix, then the gap is
re-prefilled), so rejected drafts never linger.

Drafting is advisory: a draft pool too full to hold a request skips
that request (counted in `num_pool_skips`). On the CPU, as in the
reference, any other error skips the round (counted in
`num_propose_failures`) and, after 3 consecutive failures, disables the
proposer for the engine's life — never silently: `disabled_reason`
records why and a RuntimeWarning fires; the engine then verifies
without drafts. On the card any such error propagates, so a draft
launch that fails fails the engine step (to a snapshot): the paged
kernel launches or raises, and its work is never handed to the verify
launch's dense attention.
"""
from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
import torch

from ...kernels.paged_attention import alloc_paged_cache, check_supported_paged
from ..kv_cache import PAD_PAGE, BlockAllocator, BlocksExhausted
from .proposer import Proposer

__all__ = ["DraftModelProposer"]


class _DraftSeq:
    """Per-request draft cache state: the tokens whose K/V live in the
    draft pool, and the pages holding them."""

    __slots__ = ("seq", "tokens")

    def __init__(self, seq):
        self.seq = seq
        self.tokens: List[int] = []


class DraftModelProposer(Proposer):
    """Greedy drafts from `draft_model` (on its parameters' device) over
    a pool of `num_pages` pages of `page_size` tokens in the model's
    dtype; the bucket grids default as the engine's do."""

    def __init__(self, draft_model, *, num_pages: int = 128,
                 page_size: int = 16, prefill_buckets=None,
                 batch_buckets=None, pages_buckets=None):
        # no import cycle: the engine never imports serving.spec
        from ..engine import _bucket_for, _pow2_buckets
        self._bucket_for = _bucket_for
        cfg = draft_model.cfg
        self.model = draft_model
        self.num_layers = cfg.num_hidden_layers
        self.num_kv = cfg.num_key_value_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        first = next(p for p in draft_model.parameters()
                     if p.is_floating_point())
        self.device = first.device
        check_supported_paged(
            (1, cfg.num_attention_heads, self.head_dim),
            (self.num_pages, self.num_kv, self.page_size, self.head_dim),
            first.dtype)
        self.max_seq_len = min(int(cfg.max_position_embeddings),
                               (self.num_pages - 1) * self.page_size)
        max_pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.prefill_buckets = sorted(
            prefill_buckets or _pow2_buckets(
                min(16, self.max_seq_len), self.max_seq_len))
        self.batch_buckets = sorted(batch_buckets or _pow2_buckets(1, 8))
        self.pages_buckets = sorted(
            pages_buckets or _pow2_buckets(
                min(2, max_pages_per_seq), max_pages_per_seq))
        self.max_seq_len = min(self.max_seq_len,
                               self.pages_buckets[-1] * self.page_size)

        self.allocator = BlockAllocator(self.num_pages, self.page_size)
        self._kv = [alloc_paged_cache(self.num_kv, self.num_pages,
                                      self.page_size, self.head_dim,
                                      dtype=first.dtype, device=self.device)
                    for _ in range(self.num_layers)]
        self._states: Dict[int, _DraftSeq] = {}
        self.disabled = False
        self.disabled_reason: str = ""
        self.num_draft_launches = 0
        self.num_propose_failures = 0
        self.num_pool_skips = 0
        self._consecutive_failures = 0

    # ------------------------------------------------------------- helpers
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _state_of(self, req) -> _DraftSeq:
        st = self._states.get(req.request_id)
        if st is None:
            st = _DraftSeq(self.allocator.alloc_sequence(0))
            self._states[req.request_id] = st
        return st

    def _extend(self, st: _DraftSeq, n: int) -> bool:
        """Grow the draft sequence by n token slots, all or nothing (a
        pool running dry mid-way rolls back to the entry length)."""
        base = st.seq.num_tokens
        try:
            for _ in range(n):
                # no forks in the draft pool: never any CoW copies
                self.allocator.append_token(st.seq)
        except BlocksExhausted:
            self.allocator.truncate_sequence(st.seq, base)
            return False
        return True

    def _sync(self, st: _DraftSeq, hist: List[int]):
        """Roll the draft cache back to its longest still-valid prefix
        of `hist` (stale tokens: rejected drafts or divergence), capped
        at len(hist)-1 so the catch-up chunk always has the newest token
        to process (its logits give the first draft)."""
        lcp = 0
        for a, b in zip(st.tokens, hist):
            if a != b:
                break
            lcp += 1
        lcp = min(lcp, len(hist) - 1)
        if lcp < st.seq.num_tokens:
            self.allocator.truncate_sequence(st.seq, lcp)
        del st.tokens[lcp:]

    # ------------------------------------------------------------- propose
    def propose(self, reqs, k: int) -> List[List[int]]:
        if self.disabled or k <= 0:
            return [[] for _ in reqs]
        try:
            out = self._propose(reqs, k)
            self._consecutive_failures = 0
            return out
        except Exception as exc:                         # noqa: BLE001
            if self.device.type == "cuda":
                raise
            self.num_propose_failures += 1
            self._consecutive_failures += 1
            if self._consecutive_failures >= 3:
                self._disable(f"3 consecutive propose failures, "
                              f"last: {exc!r}")
            return [[] for _ in reqs]

    def _disable(self, reason: str):
        self.disabled = True
        self.disabled_reason = reason
        warnings.warn(f"DraftModelProposer disabled ({reason}); the "
                      "engine continues with verify launches that carry "
                      "no drafts",
                      RuntimeWarning, stacklevel=3)

    def _propose(self, reqs, k: int) -> List[List[int]]:
        drafts: List[List[int]] = [[] for _ in reqs]
        # --- per-request catch-up: prefill the history gap -----------------
        active = []                      # (row index, draft state)
        for i, req in enumerate(reqs):
            hist = [int(t) for t in req.resume_ids]
            if len(hist) + k - 1 > self.max_seq_len:
                continue                 # outgrew the draft pool's tables
            st = self._state_of(req)
            self._sync(st, hist)
            need = hist[len(st.tokens):]
            if not self._extend(st, len(need)):
                self.num_pool_skips += 1
                continue                 # draft pool dry: skip this one
            pos = len(st.tokens)
            tok = None
            while need:
                span = need[:self.prefill_buckets[-1]]
                S = self._bucket_for(len(span), self.prefill_buckets)
                P = self._bucket_for(
                    self.allocator.pages_needed(pos + len(span)),
                    self.pages_buckets)
                bt = np.full((P,), PAD_PAGE, np.int32)
                npages = min(len(st.seq.pages), P)
                bt[:npages] = st.seq.pages[:npages]
                padded = np.zeros((1, S), np.int64)
                padded[0, :len(span)] = span
                self.num_draft_launches += 1
                with torch.inference_mode():
                    logits, _ = self.model.forward_paged_prefill(
                        self._to_device(padded), self._kv,
                        self._to_device(bt), pos, len(span))
                    tok = torch.argmax(logits[0, 0])
                st.tokens.extend(span)
                pos += len(span)
                need = need[len(span):]
            drafts[i] = [int(tok)]
            active.append((i, st))

        # --- batched greedy decode for drafts 2..k -------------------------
        for _ in range(1, k):
            step = [(i, st) for i, st in active if self._extend(st, 1)]
            if not step:
                break
            B = self._bucket_for(len(step), self.batch_buckets)
            P = self._bucket_for(max(len(st.seq.pages) for _, st in step),
                                 self.pages_buckets)
            ids = np.zeros((B, 1), np.int64)
            sl = np.zeros((B,), np.int32)
            bt = np.full((B, P), PAD_PAGE, np.int32)
            for row, (i, st) in enumerate(step):
                ids[row, 0] = drafts[i][-1]
                sl[row] = st.seq.num_tokens
                bt[row, :len(st.seq.pages)] = st.seq.pages
            self.num_draft_launches += 1
            with torch.inference_mode():
                logits, _ = self.model.forward_paged_decode(
                    self._to_device(ids), self._kv, self._to_device(bt),
                    self._to_device(sl))
                toks = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            for row, (i, st) in enumerate(step):
                st.tokens.append(int(ids[row, 0]))   # its K/V just landed
                drafts[i].append(int(toks[row]))
            active = step
        return drafts

    # ------------------------------------------------------------ cleanup
    def on_finished(self, req):
        st = self._states.pop(req.request_id, None)
        if st is not None:
            self.allocator.free_sequence(st.seq)

    def reset(self):
        for st in self._states.values():
            self.allocator.free_sequence(st.seq)
        self._states.clear()
