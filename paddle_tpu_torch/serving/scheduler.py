"""Iteration-level continuous-batching scheduler (port of
`paddle_tpu/serving/scheduler.py`).

Orca's iteration-level scheduling: every engine step re-forms the batch
from whatever is in flight, so a finishing request's slot is reused
immediately. Admission is FCFS under a per-step token budget; memory
pressure is resolved by cached-prefix LRU eviction first (radix tree,
when enabled), then preempt-by-eviction (the victim's pages are freed
and it re-enters the waiting queue with its generated tokens folded
into the prompt). Prompts are processed in token-budget-sized CHUNKS
interleaved with decode steps (Sarathi-Serve chunked prefill), and
intake reuses the longest cached block-aligned prefix (SGLang); a
prefix spilled to host RAM is promoted back at intake, charged to the
same chunked-prefill budget its recompute would draw from.

Per-request state machine:

    WAITING --admit--> PREFILL --last chunk + first token--> DECODE
       ^               (1..k chunk steps)                      |
       +---------------------- preempt ------------------------+
                                                  --eos/len--> FINISHED

`cancel()` exits any live state into FINISHED at an iteration boundary
("abort" / "expired" / "quarantined"); aborted and expired requests
donate their computed pages to the radix cache, quarantined ones never
do. The scheduler is pure host logic and deterministic.
"""
from __future__ import annotations

import enum
import itertools
from collections import deque
from typing import List, Optional

from .errors import EngineOverloaded
from .kv_cache import BlockAllocator, BlocksExhausted

__all__ = ["RequestState", "Request", "PrefillChunk", "ScheduleStep",
           "Scheduler", "adapter_prefix_key", "bump_request_counter"]


def adapter_prefix_key(ids, adapter):
    """Radix-cache key of a (possibly adapter'd) token sequence: a request
    served under a LoRA adapter namespaces every token with the adapter
    key, so identical token prefixes under different adapters (or adapter
    and base) never share cached KV pages, whose K/V differ by the
    adapter delta. Length-preserving, so the page-alignment math is
    untouched; the tree compares tokens by equality only, so tuple
    tokens slot straight in."""
    if adapter is None:
        return ids
    return [(adapter, t) for t in ids]


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


_req_counter = itertools.count()


def bump_request_counter(beyond: int):
    """Advance the global request-id counter past `beyond`: a resumed
    snapshot restores requests under their original ids, and requests
    added afterwards must not collide with them."""
    global _req_counter
    nxt = next(_req_counter)
    if nxt <= beyond:
        _req_counter = itertools.count(beyond + 1)
    else:
        _req_counter = itertools.count(nxt)


class Request:
    """One generation request tracked through the state machine."""

    def __init__(self, prompt_ids, max_new_tokens: int,
                 eos_token_id: Optional[int] = None,
                 request_id: Optional[int] = None,
                 adapter: Optional[str] = None):
        self.request_id = (next(_req_counter) if request_id is None
                           else request_id)
        self.prompt_ids = [int(t) for t in prompt_ids]
        if not self.prompt_ids:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_token_id = eos_token_id
        self.state = RequestState.WAITING
        self.output_ids: List[int] = []
        self.seq = None                 # KVSequence while holding pages
        self.pending_copies = []        # CoW copies due before this step
        self.num_preemptions = 0
        self.finish_reason: Optional[str] = None
        self.arrival = self.request_id  # FCFS key (monotonic ids)
        # tokens whose K/V is valid in the paged cache (cached-prefix
        # match at admission + every chunk/decode write)
        self.num_computed = 0
        # cached-prefix tokens matched at the LAST admission
        self.cached_tokens = 0
        # absolute engine-clock deadline (None = no TTL)
        self.deadline: Optional[float] = None
        # set by ServingEngine.abort(); honored at the next boundary
        self.aborted = False
        # LoRA adapter name (None = base model), mapped to a launch slot
        # per launch. `adapter_key` namespaces the radix keys; the engine
        # sets it to the registry's versioned (name, load generation)
        self.adapter = adapter
        self.adapter_key = adapter
        # colocate pins the request to local decode even on a
        # prefill-role engine; handoff_prefix_len is the block-aligned
        # token span `finish_handoff` donated (what a decode-role engine
        # can adopt)
        self.colocate = False
        self.handoff_prefix_len = 0
        # generated tokens the next admission recomputes through decode
        # launches instead of the prefill (an adopted request): each is
        # fed as a decode input and not emitted again
        self.replay_tokens = 0

    # prompt the next prefill must process (original prompt + anything
    # generated before a preemption — recompute-style resume — less the
    # tokens an adopted request replays through decode)
    @property
    def resume_ids(self) -> List[int]:
        return self.prompt_ids + self.output_ids[
            :len(self.output_ids) - self.replay_tokens]

    def token_at(self, pos: int) -> int:
        """The token at sequence position `pos` (prompt, then output)."""
        n = len(self.prompt_ids)
        return self.prompt_ids[pos] if pos < n else self.output_ids[pos - n]

    @property
    def replaying(self) -> bool:
        """True while a decode step's next token is already known: the
        sequence (this step's input token included) is shorter than
        prompt + output."""
        return (self.seq is not None and self.seq.num_tokens
                < len(self.prompt_ids) + len(self.output_ids))

    @property
    def num_generated(self) -> int:
        return len(self.output_ids)

    def remaining_new_tokens(self) -> int:
        return self.max_new_tokens - self.num_generated

    def __repr__(self):
        return (f"Request({self.request_id}, {self.state.name}, "
                f"prompt={len(self.prompt_ids)}, out={len(self.output_ids)})")


class PrefillChunk:
    """One scheduled prefill chunk: process resume_ids[start:start+length]
    (is_last == the chunk reaches the prompt end, so the engine samples
    the first token from its final live position)."""

    __slots__ = ("request", "start", "length", "is_last", "is_first")

    def __init__(self, request, start, length, is_last, is_first):
        self.request = request
        self.start = start
        self.length = length
        self.is_last = is_last
        self.is_first = is_first

    @property
    def request_id(self):
        return self.request.request_id

    def __repr__(self):
        return (f"PrefillChunk(req={self.request_id}, "
                f"[{self.start}:{self.start + self.length}]"
                f"{' last' if self.is_last else ''})")


class ScheduleStep:
    """One engine step's worth of work: prefill chunks (each runs as its
    own bucketed launch) + the decode batch."""

    __slots__ = ("prefills", "decodes", "preempted")

    def __init__(self, prefills, decodes, preempted):
        self.prefills = prefills
        self.decodes = decodes
        self.preempted = preempted

    def is_empty(self):
        return not (self.prefills or self.decodes)


class Scheduler:
    """FCFS continuous-batching scheduler over a BlockAllocator.

    token_budget caps the tokens processed per step (each decode request
    costs 1, a prefill chunk costs its length). max_batch_size caps
    concurrent in-flight (PREFILL/DECODE) requests, which bounds the
    decode batch bucket. prefix_cache (a RadixCache over the same
    allocator, or None) enables cached-prefix reuse + donation.
    """

    def __init__(self, allocator: BlockAllocator, max_batch_size: int = 8,
                 token_budget: int = 512,
                 max_prompt_len: Optional[int] = None,
                 prefix_cache=None,
                 max_queue_len: Optional[int] = None):
        self.allocator = allocator
        self.max_batch_size = int(max_batch_size)
        self.token_budget = int(token_budget)
        self.max_prompt_len = max_prompt_len
        self.prefix_cache = prefix_cache
        # admission control: bound on len(waiting). A preempted request
        # re-entering the queue is NOT subject to it.
        self.max_queue_len = (None if max_queue_len is None
                              else int(max_queue_len))
        self.decode_token_cost = 1
        self.waiting: deque = deque()
        self.prefilling: List[Request] = []   # admitted, chunks pending
        self.running: List[Request] = []      # decoding, arrival order
        self.num_preemptions = 0

    # ---- intake ----------------------------------------------------------
    def add_request(self, req: Request, force: bool = False):
        """Queue `req` (FCFS). `force=True` bypasses the admission bound."""
        if self.max_prompt_len is not None and \
                len(req.prompt_ids) > self.max_prompt_len:
            raise ValueError(
                f"prompt length {len(req.prompt_ids)} exceeds engine "
                f"max_prompt_len {self.max_prompt_len}")
        cap = (self.allocator.num_pages - 1) * self.allocator.page_size
        if len(req.prompt_ids) + req.max_new_tokens > cap:
            raise ValueError(
                f"request needs {len(req.prompt_ids) + req.max_new_tokens} "
                f"tokens of KV > total capacity {cap}")
        if not force and self.max_queue_len is not None and \
                len(self.waiting) >= self.max_queue_len:
            raise EngineOverloaded(
                f"waiting queue full ({len(self.waiting)} >= "
                f"max_queue_len {self.max_queue_len})",
                queue_depth=len(self.waiting),
                max_queue_len=self.max_queue_len)
        req.state = RequestState.WAITING
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def num_in_flight(self) -> int:
        return len(self.running) + len(self.prefilling)

    # ---- prefix cache plumbing ------------------------------------------
    def _donate(self, req: Request):
        """Hand the request's computed full pages to the radix tree
        (finish AND preemption both donate)."""
        if self.prefix_cache is None or req.seq is None:
            return
        # adapter-namespaced key: an adapter'd request's KV holds the
        # adapter delta, so it never serves another adapter's (or the
        # base model's, or a reloaded same-name adapter's) prefix
        ids = adapter_prefix_key(req.prompt_ids + req.output_ids,
                                 req.adapter_key)
        n = min(req.num_computed, len(ids), req.seq.num_tokens)
        ps = self.allocator.page_size
        full = (n // ps) * ps
        if full:
            try:
                self.prefix_cache.insert(ids[:full],
                                         req.seq.pages[:full // ps])
            except Exception:
                # a failed donation (e.g. injected fault) only costs a
                # future cache hit; the donor still frees normally and
                # the tree was not mutated (insert raises before any
                # adoption)
                pass

    def _reclaim(self, need_pages: int, protect=()) -> bool:
        """Cached-prefix LRU eviction — ALWAYS tried before preempting a
        live request."""
        if self.prefix_cache is None or need_pages <= 0:
            return False
        return self.prefix_cache.evict(need_pages, protect) >= need_pages

    # ---- preemption ------------------------------------------------------
    def _preempt_one(self, keep: Request) -> Optional[Request]:
        """Evict the LAST-arrived in-flight request (decoding OR
        mid-prefill) — possibly `keep` itself when IT is the newest.
        The victim donates its computed pages to the prefix cache, frees
        the rest, and resumes by re-prefilling prompt+generated."""
        pool = self.running + self.prefilling
        victim = max(pool, key=lambda r: r.arrival)
        if victim in self.running:
            self.running.remove(victim)
        else:
            self.prefilling.remove(victim)
        self._donate(victim)
        self.allocator.free_sequence(victim.seq)
        victim.seq = None
        victim.state = RequestState.WAITING
        victim.num_computed = 0
        victim.cached_tokens = 0
        victim.replay_tokens = 0       # recompute prompt + generated
        victim.num_preemptions += 1
        self.num_preemptions += 1
        # preempted requests head the queue: FCFS by original arrival
        self.waiting.appendleft(victim)
        return victim

    # ---- the per-step decision ------------------------------------------
    def schedule(self) -> ScheduleStep:
        preempted: List[Request] = []

        # 1. guarantee every decoding request can append this step's
        #    token (may cross a page boundary); on pressure evict cached
        #    prefixes first, then the newest in-flight request.
        survivors: List[Request] = []
        for req in list(self.running):
            if req not in self.running:
                continue               # evicted by an earlier iteration
            while True:
                try:
                    copies = self.allocator.append_token(req.seq)
                    req.pending_copies = copies
                    survivors.append(req)
                    break
                except BlocksExhausted:
                    if self._reclaim(1):
                        continue
                    victim = self._preempt_one(keep=req)
                    preempted.append(victim)
                    if victim is req:
                        break
        decodes = [r for r in survivors if r in self.running]
        budget = self.token_budget - len(decodes) * self.decode_token_cost

        # 2. continue in-flight prefills FCFS: each gets at most one
        #    chunk per step, sized to the remaining budget.
        chunks: List[PrefillChunk] = []
        for req in sorted(self.prefilling, key=lambda r: r.arrival):
            if budget <= 0:
                break
            n = len(req.resume_ids)
            take = min(budget, n - req.num_computed)
            if take <= 0:
                continue
            chunks.append(PrefillChunk(req, req.num_computed, take,
                                       req.num_computed + take == n,
                                       is_first=False))
            budget -= take

        # 3. admit waiting prompts FCFS while budget/slots/pages allow.
        #    A cached-prefix match shares its pages and shrinks what
        #    must be prefilled; the first chunk takes whatever budget is
        #    left. Headroom check only: a prompt must see pages for
        #    prompt tokens + 1 free, without reserving the extra page.
        while self.waiting and budget > 0 and \
                self.num_in_flight < self.max_batch_size:
            req = self.waiting[0]
            ids = req.resume_ids
            n = len(ids)
            mpages, m = [], 0
            if self.prefix_cache is not None:
                # host-tier promotion moves the bytes a prefill of those
                # tokens would write, so it is charged to the same
                # budget; one token is held back so the admitted request
                # can always take a non-empty first chunk this step
                promoted_before = self.prefix_cache.num_promoted_pages
                mpages, m = self.prefix_cache.match(
                    adapter_prefix_key(ids, req.adapter_key),
                    promote_budget=budget - 1)
                budget -= ((self.prefix_cache.num_promoted_pages
                            - promoted_before)
                           * self.allocator.page_size)
                if m >= n:
                    # full hit: the LAST token must still run through
                    # the model to produce the next-token logits
                    keep = (n - 1) // self.allocator.page_size
                    mpages, m = mpages[:keep], \
                        keep * self.allocator.page_size
            short = (self.allocator.pages_needed(n + 1) - len(mpages)
                     - self.allocator.num_free)
            if short > 0 and not self._reclaim(short, protect=mpages):
                break                  # no pages — decodes will drain/free
            try:
                req.seq = self.allocator.alloc_sequence_with_prefix(
                    n, mpages)
            except BlocksExhausted:
                break
            self.waiting.popleft()
            req.state = RequestState.PREFILL
            req.num_computed = m
            req.cached_tokens = m
            self.prefilling.append(req)
            take = min(budget, n - m)
            chunks.append(PrefillChunk(req, m, take, m + take == n,
                                       is_first=True))
            budget -= take
        return ScheduleStep(chunks, decodes, preempted)

    # ---- completion hooks (engine calls these) ---------------------------
    def on_prefilled(self, req: Request):
        """Last chunk processed and first token sampled: request joins
        the decode batch."""
        if req in self.prefilling:
            self.prefilling.remove(req)
        req.state = RequestState.DECODE
        self.running.append(req)
        self.running.sort(key=lambda r: r.arrival)

    def finish_handoff(self, req: Request) -> int:
        """Finish a just-prefilled request for hand-off to a decode-role
        engine: its computed pages donate to the radix tree like any
        finish, and the return value is the block-aligned token count of
        the donated span (0 without a prefix cache or for a sub-page
        prompt: the decode side then prefills it)."""
        ids = req.prompt_ids + req.output_ids
        n = min(req.num_computed, len(ids),
                req.seq.num_tokens if req.seq is not None else 0)
        full = (n // self.allocator.page_size) * self.allocator.page_size
        if self.prefix_cache is None:
            full = 0
        self.finish(req, "handoff", donate=True)
        return full

    def finish(self, req: Request, reason: str, donate: bool = True):
        if req in self.running:
            self.running.remove(req)
        if req in self.prefilling:
            self.prefilling.remove(req)
        if req.seq is not None:
            if donate:
                self._donate(req)
            self.allocator.free_sequence(req.seq)
            req.seq = None
        req.state = RequestState.FINISHED
        req.finish_reason = reason

    def cancel(self, req: Request, reason: str,
               donate: bool = True) -> bool:
        """Cancel a request in ANY live state. Pages are donated to the
        prefix cache (`donate=False` for quarantine — poisoned KV must
        never enter the tree) and freed. Returns False when the request
        already finished."""
        if req.state is RequestState.FINISHED:
            return False
        try:
            self.waiting.remove(req)
        except ValueError:
            pass
        self.finish(req, reason, donate=donate)
        return True
