"""Request routing across replicas (port of
`paddle_tpu/serving/fleet/router.py`).

The production policy is PREFIX AFFINITY (`PrefixAffinityRouter`):
score every healthy replica by the longest prefix of the request its
radix cache already holds (the read-only `match_len` probe — scoring
must not perturb any replica's LRU order), and break ties by load
(in-flight + queue depth), then by name for determinism. This makes the
radix hit rate a FLEET property: requests sharing a prompt prefix keep
landing on the replica that already holds its KV, instead of
prefilling the same prefix into every replica's cache (which is what
random spraying does).

`RandomRouter` (seeded) and `RoundRobinRouter` exist as baselines for
that comparison and for workloads with no shared prefixes.

Routers are pure functions of (tokens, candidate list) plus their own
private state; the FLEET owns candidacy (health states, the route-race
retry) — a router never sees a dead replica.
"""
from __future__ import annotations

import random
from typing import List

from .errors import NoHealthyReplica
from .replica import Replica

__all__ = ["Router", "PrefixAffinityRouter", "RandomRouter",
           "RoundRobinRouter", "role_candidates"]

# Which worker roles may serve each phase of a request's life
# (disaggregated prefill and decode). "both" workers serve either phase;
# a co-located fleet (all roles "both") matches every filter, so the
# helper is a no-op there.
_PHASE_ROLES = {
    "prefill": ("prefill", "both"),
    "decode": ("decode", "both"),
}


def role_candidates(candidates, phase: str):
    """Filter `candidates` (anything with a `.role` attribute) down to
    the ones whose role may serve `phase` ("prefill" or "decode").

    Role-aware routing FALLS BACK rather than sheds: when no candidate
    matches the phase (role-starved fleet — e.g. every decode worker is
    dead), the full candidate list is returned and the caller degrades
    to co-located execution on whatever is healthy."""
    want = _PHASE_ROLES[phase]
    matched = [c for c in candidates
               if getattr(c, "role", "both") in want]
    return matched or list(candidates)


class Router:
    """Strategy interface: pick one replica from the candidates.
    `adapter` is the request's LoRA adapter name (None for
    base-model traffic) — policies may use it for placement; the
    baselines ignore it."""

    def route(self, tokens, replicas: List[Replica],
              adapter=None) -> Replica:
        raise NotImplementedError

    @staticmethod
    def _require(replicas: List[Replica]):
        if not replicas:
            raise NoHealthyReplica("no healthy replica to route to")


class PrefixAffinityRouter(Router):
    """Loaded-adapter match first, longest cached prefix second; least
    load, then name, break ties.

    The adapter score dominates: landing an adapter'd
    request on a replica that already HOLDS the adapter avoids a
    load/evict churn (or a typed refusal) entirely, and prefix
    affinity is worthless across adapters anyway — the radix key is
    adapter-namespaced, so only same-adapter replicas can have a
    matching prefix to begin with. The prefix probe uses the same
    namespaced key the scheduler matches with (read-only, no LRU
    perturbation). With cold caches and base-model traffic every score
    is 0 and the policy degrades to pure least-loaded."""

    def route(self, tokens, replicas: List[Replica],
              adapter=None) -> Replica:
        self._require(replicas)
        tokens = list(tokens)
        return min(replicas,
                   key=lambda r: (-int(r.has_adapter(adapter)),
                                  -r.match_len(tokens, adapter=adapter),
                                  r.load, r.name))


class RandomRouter(Router):
    """Seeded uniform spray — the routing-criterion baseline."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def route(self, tokens, replicas: List[Replica],
              adapter=None) -> Replica:
        self._require(replicas)
        return replicas[self._rng.randrange(len(replicas))]


class RoundRobinRouter(Router):
    """Strict rotation over whoever is currently healthy."""

    def __init__(self):
        self._i = 0

    def route(self, tokens, replicas: List[Replica],
              adapter=None) -> Replica:
        self._require(replicas)
        r = replicas[self._i % len(replicas)]
        self._i += 1
        return r
