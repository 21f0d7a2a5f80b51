"""Draft-token proposers for speculative decoding (port of
`paddle_tpu/serving/spec/proposer.py`).

A Proposer suggests up to K continuation tokens per decoding request
each engine step; the engine's verify launch scores them all and keeps
the longest accepted prefix. Proposals are advisory: a proposer may
return fewer than K tokens, or none (the step then verifies the last
token alone, which emits what a decode step would), and under greedy
acceptance nothing it returns changes the emitted tokens — only how
many launches they take.

Proposers see the engine's host-side request state only (token
histories); a KV-owning proposer (the draft model) manages its own pool
and is told about terminal requests through `on_finished`.
"""
from __future__ import annotations

from typing import List

__all__ = ["Proposer", "NgramProposer"]


class Proposer:
    """Interface: `propose(reqs, k)` returns one draft list (<= k
    tokens, possibly empty) per request, aligned with `reqs`."""

    def propose(self, reqs, k: int) -> List[List[int]]:
        raise NotImplementedError

    def on_finished(self, req):
        """Request reached a terminal state (finished, aborted, expired,
        quarantined, vacated): release any per-request state."""

    def reset(self):
        """Drop all per-request state (engine shutdown)."""


class NgramProposer(Proposer):
    """Prompt-lookup drafting: the draft is read out of the request's
    OWN token history — the tokens that followed the most recent earlier
    occurrence of the current suffix n-gram. No weights, host only.

    `max_ngram` / `min_ngram` bound the suffix lengths tried, longest
    first. Among matches of the chosen n-gram the scan runs
    most-recent-first and stops at the first whose continuation fills
    all k slots; when every continuation is cut short by the history end
    (a suffix-overlapping cycle like "a b a b a"), the longest wins,
    recency breaking ties.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= int(min_ngram) <= int(max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}/{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose_for(self, tokens, k: int) -> List[int]:
        """Draft up to `k` tokens continuing `tokens` by suffix lookup;
        [] when no suffix n-gram recurs earlier in the history."""
        tokens = list(tokens)
        n_hist = len(tokens)
        if k <= 0 or n_hist < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            suffix = tokens[n_hist - n:]
            best: List[int] = []
            # most recent prior occurrence first; the continuation may
            # run into the suffix itself (the self-repetition case)
            for start in range(n_hist - n - 1, -1, -1):
                if tokens[start:start + n] == suffix:
                    cont = tokens[start + n:start + n + k]
                    if len(cont) == k:
                        return [int(t) for t in cont]
                    if len(cont) > len(best):
                        best = cont
            if best:
                return [int(t) for t in best]
        return []

    def propose(self, reqs, k: int) -> List[List[int]]:
        return [self.propose_for(r.resume_ids, k) for r in reqs]
