"""Asyncio streaming front-end over a Fleet (port of
`paddle_tpu/serving/fleet/server.py`).

`FleetServer` drives every replica on ITS OWN stepping loop (one
asyncio task per replica — a dead replica's loop exits; the survivors
keep stepping and absorb its migrated work) plus a monitor task for
stall detection and parked-work pickup, and exposes the client-facing
streaming API:

    async with FleetServer(fleet) as server:
        stream = await server.submit(prompt_ids, max_new_tokens=16)
        async for event in stream:          # OpenAI-style event shapes
            ...  # {"type": "token", "token": t, "index": i, ...}
                 # then one {"type": "finish", "finish_reason": ...}

Events are token DELTAS followed by exactly one finish event — the
streamed shape of an OpenAI-style completions response (token-id
level; tokenization lives outside this repo). `TokenStream.collect()`
is the non-streaming convenience.

Concurrency model: everything runs on the event loop thread — engine
steps are synchronous calls from the replica tasks (an engine step on
CPU blocks the loop for its duration, which is fine for the in-process
replicas this serves), and handle listeners enqueue into per-stream
asyncio queues, so no locks are needed anywhere. Failover is inherited
wholesale from the Fleet: a crash inside `step_replica` parks and
re-lands work without the streaming layer noticing beyond the tokens
continuing to arrive — the zero-loss contract is the Fleet's, the
server just never drops an event.
"""
from __future__ import annotations

import asyncio
import traceback
import warnings
from typing import List, Optional, Tuple

from .fleet import Fleet, FleetHandle, finish_event, token_event
from .replica import ReplicaState

__all__ = ["FleetServer", "TokenStream"]


class TokenStream:
    """Async iterator over one request's events. Attaching replays any
    tokens delivered before the stream existed (e.g. a handle obtained
    synchronously and streamed later), then subscribes to the handle —
    both on the event-loop thread, so no event can fall in between."""

    def __init__(self, handle: FleetHandle):
        self.handle = handle
        self._q: asyncio.Queue = asyncio.Queue()
        self._done = False
        for i, tok in enumerate(handle.tokens):
            self._q.put_nowait(token_event(handle, tok, i))
        if handle.finished:
            self._q.put_nowait(finish_event(handle,
                                            handle.finish_reason))
        handle.subscribe(self._q.put_nowait)

    @property
    def request_id(self) -> int:
        return self.handle.request_id

    def __aiter__(self):
        return self

    async def __anext__(self) -> dict:
        if self._done:
            raise StopAsyncIteration
        event = await self._q.get()
        if event["type"] == "finish":
            self._done = True
        return event

    def close(self):
        """Detach from a LIVE handle early (an abandoned stream's queue
        would otherwise keep accumulating events until the request
        finishes; at finish the handle drops its listeners itself).
        A consumer already blocked in `__anext__` is woken with a
        synthetic finish event (`finish_reason="closed"`)."""
        self.handle.unsubscribe(self._q.put_nowait)
        if self._done:
            return
        self._done = True
        self._q.put_nowait(finish_event(self.handle, "closed"))

    async def collect(self) -> Tuple[List[int], Optional[str]]:
        """Drain the stream; returns (tokens, finish_reason)."""
        async for _ in self:
            pass
        return list(self.handle.tokens), self.handle.finish_reason


class FleetServer:
    """The asyncio shell: per-replica stepping tasks + health monitor
    over a synchronous Fleet. `idle_sleep_s` is how long an idle
    replica loop naps (0 still yields to the loop each step);
    `health_interval_s` paces stall detection and the parked-work
    sweep that keeps migration moving even if every replica loop has
    exited."""

    def __init__(self, fleet: Fleet, *, idle_sleep_s: float = 1e-3,
                 health_interval_s: float = 1e-2):
        self.fleet = fleet
        self.idle_sleep_s = float(idle_sleep_s)
        self.health_interval_s = float(health_interval_s)
        self._running = False
        self._tasks: List[asyncio.Task] = []
        # unexpected exceptions from the loop bodies: counted, first few
        # warned with tracebacks, loop kept ALIVE — a monitor that died
        # silently would stop stall detection and parked-work pickup
        # while the server kept accepting work
        self.loop_errors = 0

    def _on_loop_error(self, where: str):
        self.loop_errors += 1
        if self.loop_errors <= 3:
            warnings.warn(
                f"FleetServer {where} error (#{self.loop_errors}, "
                f"loop continues):\n{traceback.format_exc()}",
                RuntimeWarning, stacklevel=2)

    # ---- lifecycle -------------------------------------------------------
    async def start(self):
        if self._running:
            return
        self._running = True
        self._tasks = [asyncio.ensure_future(self._replica_loop(r))
                       for r in self.fleet.replicas]
        self._tasks.append(asyncio.ensure_future(self._monitor()))

    async def stop(self):
        self._running = False
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop()

    # ---- the loops -------------------------------------------------------
    async def _replica_loop(self, replica):
        while self._running and replica.state is ReplicaState.HEALTHY:
            try:
                emitted = self.fleet.step_replica(replica)
                busy = bool(emitted) or replica.engine.has_work() \
                    or bool(self.fleet._parked)
            except asyncio.CancelledError:
                raise
            except Exception:                         # noqa: BLE001
                self._on_loop_error(f"replica_loop[{replica.name}]")
                busy = False
            await asyncio.sleep(0 if busy else self.idle_sleep_s)

    async def _monitor(self):
        while self._running:
            try:
                self.fleet.check_health()
                self.fleet._process_parked()
            except asyncio.CancelledError:
                raise
            except Exception:                         # noqa: BLE001
                self._on_loop_error("monitor")
            await asyncio.sleep(self.health_interval_s)

    # ---- client API ------------------------------------------------------
    async def submit(self, prompt_ids, **kw) -> TokenStream:
        """Admit one request (Fleet.submit semantics and typed sheds)
        and return its event stream."""
        return TokenStream(self.fleet.submit(prompt_ids, **kw))

    async def generate(self, prompt_ids,
                       **kw) -> Tuple[List[int], Optional[str]]:
        """Non-streaming convenience: submit and await completion."""
        stream = await self.submit(prompt_ids, **kw)
        return await stream.collect()

    async def abort(self, request_id: int) -> bool:
        return self.fleet.abort(request_id)

    async def drain(self, name: str) -> int:
        """Deliberately drain one replica; its stepping task exits on
        its own (the state flips out of HEALTHY) and in-flight work
        migrates with the zero-loss contract."""
        return self.fleet.drain(name)

    # ---- observability ----------------------------------------------------
    def metrics_text(self, *, prefix: str = "paddle_serving") -> str:
        """The Prometheus scrape body for this server — what
        `HttpFrontend` serves at /metrics (synchronous on
        purpose: it reads host-side counters only, no engine step). One
        call renders the merged fleet view plus per-replica labeled
        series via `Fleet.prometheus_text`."""
        return self.fleet.prometheus_text(prefix=prefix)
