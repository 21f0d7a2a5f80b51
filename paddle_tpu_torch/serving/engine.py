"""ServingEngine: continuous-batching inference over the paged-KV kernel
(port of `paddle_tpu/serving/engine.py`, single card).

Scheduling, block-based KV management and the radix prefix cache run on
the host (scheduler.py / kv_cache.py / radix_cache.py); device work is
four kinds of eager launches, each padded to a shape bucket exactly as
the reference pads its compiled programs, so shapes match the reference
and a bucket can later be captured as one CUDA graph:

  * prefill CHUNK, bucketed by (chunk length S, block-table width P):
    one span of ONE padded prompt through `model.forward_paged_prefill`
    — rope at absolute positions, `paged_cache_write_range` at the
    chunk's offset, attention over the gathered paged prefix — and a
    token drawn from the chunk's last live position (used only when the
    chunk completes the prompt). Whole-prompt prefill, chunked prefill
    and radix prefix-cache hits are all this one launch.
  * DECODE, bucketed by (batch B, block-table width P): one batched
    step through `model.forward_paged_decode` — per-row rope, the
    current token's `paged_cache_write`, the paged-decode CUDA kernel
    over the block tables — plus sampling of the live rows.
  * MULTI_DECODE (`decode_steps=K`), bucketed by (B, K, P): K decode
    steps in one launch (`model.forward_paged_decode_multi`) with
    sampling on the device and per-row EOS / cap / finiteness freeze
    masks; the seq_lens advance on the device and nothing is read back
    until the launch's one copy of (tokens, counts, flags). Greedy
    output equals K=1's; the scheduler charges the token budget xK;
    abort/TTL take effect at the next K boundary with the launch's
    tokens delivered; NaN quarantine is per launch (a poisoned row
    delivers none of the launch's tokens).
  * VERIFY (`proposer=`), bucketed by (B, K, P): each row scores its
    last emitted token plus up to K drafted tokens in one
    `model.forward_paged_verify` (attention over the gathered paged
    prefix, as in the chunked prefill); acceptance is resolved on the
    device — greedy longest-prefix match, or for temperature > 0 the
    reference's rule for a one-hot proposal (accept draft d iff
    u < p(d), else sample p with d removed) — and rejected drafts' pages
    roll back through `BlockAllocator.truncate_sequence`. Greedy output
    equals plain decode's. Proposers: `serving.spec.NgramProposer` and
    `DraftModelProposer` (its own paged pool, driven through the same
    prefill-chunk and paged-decode forwards).

Resilience: per-request deadlines and `abort()` take effect at the next
iteration boundary in any state; the waiting queue is bounded
(`EngineOverloaded`); every launch runs under a `StepSupervisor` that
retries transient device errors, NaN/Inf logits quarantine only their
own request, and anything else drains the engine to a JSON-safe
snapshot and raises `EngineFailure(snapshot=...)`. `snapshot()` /
`vacate()` / `ServingEngine.from_snapshot()` / `adopt_requests()` move
the live requests (queued, mid-prefill, decoding, preempted, with drafts
in flight) to a fresh engine: a resumed request re-prefills its prompt
and replays what it generated through decode launches (each known token
fed as the input, none emitted again), so every token's K/V and the
next logits are computed as the uninterrupted run computed them and
greedy continuations equal it under the same buckets, bitwise on the
card too. (The reference re-prefills prompt + generated tokens, which
on the card rounds those tokens through the prefill's launches instead
of the decode's; a preempted request still does.) The snapshot records
use the reference's keys and types, with one difference: `rng_key`
holds the engine's `torch.Generator` state (`get_state()`, as a list of
byte values) and `from_snapshot` restores it (a generator of the same
device type).

Tracing: `trace=True` builds a private `RequestTracer` (`trace_ring`
completed traces), a tracer object is shared; with `trace=None` every
hook is one `is None` check and nothing trace-related is allocated.
The flight recorder (`flight_recorder_steps` non-idle step records)
is always on and rides every snapshot.

Determinism: greedy decode is deterministic and, given the same shape
buckets, a request's tokens do not depend on what it is batched with
(rows are independent), on the CPU and on the card: the paged-decode
kernel splits each row's KV by that row's length and the launch's
shapes alone (`kernels.paged_attention.paged_decode_splits`) and merges
the splits in order, so a row's rounding is the same alone or batched.
Random numbers for sampling are drawn from the engine's
`torch.Generator` once per launch, BEFORE the supervised call, so a
retried launch replays bit-identically.

Quantized serving: `kv_dtype="int8"` keeps every layer's K/V pages as
int8 with fp32 per-slot scale pages (quantized on write, dequantized by
the paged-decode kernel's int8 variant and by the prefill and verify
gathers), so a `kv_pool_bytes` budget holds ~1.94x the pages;
`wq="int8"` / `"int4"` converts the model's MLP and LM-head linears in
place to weight-only quantized ones before the first launch
(`nn.quant.quantize_for_serving`; int8 runs the dequant-matmul kernel).

Multi-LoRA serving: pass `lora` (a `serving.lora.AdapterRegistry` built
for this model's dims on the engine's device) and tag requests with
`add_request(adapter=...)`. Adapter A/B factors live paged in the
registry's pools (refcount pinning, LRU eviction of idle adapters); each
launch gathers the loaded adapters into per-rank-bucket slot stacks and
the model's projection hooks add every row's OWN adapter delta through
the LoRA kernels, so rows of one launch may mix adapters (multi-step
decode included: the scope spans the whole K-step launch). Radix keys
are namespaced by (adapter, load generation): prefixes never cross
adapters. Snapshot records carry the adapter.

Tiered KV: `host_spill_pages=N` puts a `HostPageStore` of N host pages
under the radix cache. LRU eviction DEMOTES a cached node's pages (K
and V of every layer, int8 scale rows included) to CRC-protected host
payloads, gathered on the card in one batch and brought over in one
copy; a later match PROMOTES them back, every payload decoded and
checked before any device page is claimed, then one host-to-device copy
from pinned memory and one `index_copy_` per cache tensor, with no host
sync (the stream orders the writes before the prefill that reads
them). Promotion is charged to the chunked-prefill budget; a corrupt,
slow or lost host page degrades to recompute. Bytes move exactly, so
outputs equal the spill-off engine's under the same buckets.

Disaggregated roles: `role="prefill"` finishes every request whose
prefill completes with reason "handoff" (its pages donated to the radix
tree, `handoff_prefix_len` the span) unless it is pinned `colocate`;
`role="decode"` is a routing tag. `export_prefix` / `adopt_prefix` /
`release_prefix` move a cached prefix between engines as the same page
payloads the spill tier uses.

Tensor parallelism: `mesh=tp_serving_mesh(tp)` serves one model over
tp rank processes (`distributed.init_parallel_env`, one rank each).
Every rank runs the same engine with the same requests in the same
order; the scheduler, `BlockAllocator` and `RadixCache` are replicated,
so every paging, refcount and radix decision is the same on each rank by
construction (page ids are global, page contents head-split). The
engine splits the model in place (`LlamaForCausalLM.shard_`, after the
`wq` quantization), so each rank keeps its H/tp query heads, its KVH/tp
KV heads in the paged pool (int8 scale pages too) and its share of the
MLP, embedding and head; the model's layers sum over the mesh's group,
and the head's logits are gathered whole on every rank, so each rank
samples the same token from the same random stream. `kv_pool_bytes` is
a per-rank budget: a page costs `kv_page_bytes_shard` there. After every
step the ranks compare a fingerprint of the step (launch buckets, rows,
emitted tokens, pages in use) on the mesh's host group, and a mismatch
fails the engine on every rank.

Feature pairs the reference refuses raise `UnsupportedFeature` with the
reference's reasons (`errors.FEATURE_CONFLICTS`). Not ported yet
(`UnsupportedFeature`): the persistent compile cache (`compile_cache`).
"""
from __future__ import annotations

import contextlib
import hashlib
import itertools
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..distributed.env import current_device
from ..distributed.fleet.mpu import ModelParallelMesh
from ..kernels.paged_attention import (alloc_paged_cache,
                                       check_supported_paged,
                                       paged_page_bytes)
from ..models.generation import _filter_logits, _sample, sample_noise
from ..nn.quant import quantize_for_serving
from ..utils import faults
from .errors import (EngineFailure, EngineOverloaded, SnapshotVersionError,
                     UnsupportedFeature, check_feature_conflicts)
from .kv_cache import (PAD_PAGE, BlockAllocator, BlocksExhausted,
                       HostPageCorrupt, HostPageLost, HostPagesExhausted,
                       HostPageSlow, HostPageStore, decode_page_records,
                       pack_page_payload, record_head)
from .metrics import ServingMetrics
from .lora.adapter import AdapterNotLoaded
from .lora.runtime import build_context, lora_scope
from .lora.store import AdapterRegistry
from .radix_cache import RadixCache
from .scheduler import (Request, RequestState, Scheduler,
                        bump_request_counter)
from .supervisor import POISON, RetryPolicy, StepSupervisor, classify_failure
from .trace import FlightRecorder, RequestTracer

__all__ = ["ServingEngine", "SNAPSHOT_VERSION", "SNAPSHOT_MINOR",
           "check_snapshot_version", "MAX_DECODE_STEPS", "tp_serving_mesh"]


def tp_serving_mesh(tp: int, devices=None) -> ModelParallelMesh:
    """This rank's mesh of model degree `tp` over the default process
    group (`distributed.init_parallel_env`): the world's ranks in
    consecutive groups of tp, one serving replica a group (a world of
    tp ranks is one group). Collective: every rank of the world calls
    it, in the same order as its other group calls. `devices`: the
    device of each rank of a group, by its index there (default: the
    device init_parallel_env chose for this rank). tp 1 needs no group.
    Raises unless an initialized group whose size tp divides exists."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1 and not dist.is_initialized():
        dev = devices[0] if devices else current_device()
        return ModelParallelMesh(1, 0, None, None, resolve_device(dev))
    if not dist.is_initialized():
        raise RuntimeError(f"tp_serving_mesh({tp}) needs a process group "
                           f"of tp ranks: call "
                           f"distributed.init_parallel_env() in each rank "
                           f"first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tp:
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"model groups of tp={tp}")
    mine = None
    for first in range(0, world, tp):
        ranks = list(range(first, first + tp))
        group = dist.new_group(ranks)
        host = dist.new_group(ranks, backend="gloo")
        if rank in ranks:
            mine = (rank - first, group, host)
    local, group, host = mine
    dev = devices[local] if devices else current_device()
    return ModelParallelMesh(tp, local, group, host, resolve_device(dev))

_engine_counter = itertools.count()

# the timer of the per-launch TPOT samples; tests pin launch durations
# by replacing this module attribute
_perf_counter = time.perf_counter

# Snapshot schema: a MAJOR `version` this build would misread is refused
# (SnapshotVersionError); a same-major snapshot from a newer `minor`
# (extra keys) is accepted with a warning. Minor 2 added the request
# records' "adapter", minor 3 their "colocate" flag (the reference's).
SNAPSHOT_VERSION = 1
SNAPSHOT_MINOR = 3
_SNAPSHOT_KNOWN_KEYS = frozenset(
    {"version", "minor", "reason", "rng_key", "requests",
     "flight_recorder"})


def check_snapshot_version(snapshot: dict):
    """Refuse a snapshot whose schema `version` is not the one this
    build writes (`SnapshotVersionError`); warn and ignore unknown keys
    of a same-major snapshot from a newer minor."""
    found = snapshot.get("version")
    if found != SNAPSHOT_VERSION:
        raise SnapshotVersionError(
            f"unsupported snapshot version {found!r} (this build "
            f"writes {SNAPSHOT_VERSION})",
            found=found, expected=SNAPSHOT_VERSION)
    minor = snapshot.get("minor", 0)
    extra = sorted(set(snapshot) - _SNAPSHOT_KNOWN_KEYS)
    if extra or (isinstance(minor, int) and minor > SNAPSHOT_MINOR):
        warnings.warn(
            f"snapshot from a newer same-major build (minor {minor!r} "
            f"vs {SNAPSHOT_MINOR}); ignoring unknown keys {extra}",
            RuntimeWarning, stacklevel=2)


# Fault-injection points. The step-exception points fire BEFORE the
# launch, so an injected transient retries the identical launch;
# nan_logits poisons the per-row finiteness flags AFTER the launch (the
# decode, multi-step decode and verify launches alike); deadline_storm
# returns seconds of forward clock skew applied at the next boundary;
# draft_storm replaces the proposer's drafts with its payload
# (callable(reqs, k) -> drafts, or True for seeded garbage), which must
# leave greedy output unchanged.
FAULT_CHUNK = faults.register_point("serving.engine.prefill_chunk")
FAULT_DECODE = faults.register_point("serving.engine.decode_step")
FAULT_NAN = faults.register_point("serving.engine.nan_logits")
FAULT_STORM = faults.register_point("serving.engine.deadline_storm")
FAULT_VERIFY = faults.register_point("serving.engine.verify_step")
FAULT_DRAFT = faults.register_point("serving.spec.draft_storm")
FAULT_MULTI = faults.register_point("serving.engine.multi_decode_step")

# Ceiling on decode_steps (K), the reference's: a launch runs K decode
# steps back to back with nothing read back in between
MAX_DECODE_STEPS = 64


def _bucket_for(value: int, buckets: List[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"{value} exceeds largest bucket {buckets[-1]}")


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


def _refuse_unported(*, compile_cache):
    """Raise UnsupportedFeature for a requested feature this port does
    not have yet: the persistent compile cache."""
    if compile_cache is not None:
        # not a capability conflict between two features: a feature the
        # port lacks, so FEATURE_CONFLICTS has no pair for it
        raise UnsupportedFeature(  # tpu-lint: refusal-ok
            "not ported to paddle_tpu_torch yet: compile_cache",
            features=["compile_cache"])


def _verify_accept(lg, ids, dl, temperature, top_k, top_p, rnd):
    """Acceptance of one verify launch, on the device. lg (B, S, V)
    logits; ids (B, S) [last token, drafts]; dl (B,) draft lengths; rnd
    = (u (B, K) uniforms, g (B, S, V) Gumbel noise) when temperature > 0.
    Greedy: the longest prefix of drafts equal to the argmax of the
    position before, then that argmax (correction or bonus). Sampled
    (a one-hot proposal): draft d at position j accepts iff u_j < p_j(d),
    p the filtered, tempered distribution; a rejected position samples p
    with d removed and renormalized, the bonus position p itself.
    Returns (tokens (B, S), accepted (B,), ok (B,)): ok over the live
    positions only (padding runs on clamped positions)."""
    B, S, V = lg.shape
    K = S - 1
    jpos = torch.arange(S, device=lg.device)[None, :]
    live_q = jpos <= dl[:, None]
    fin = torch.isfinite(lg).all(dim=-1)
    ok = torch.where(live_q, fin, torch.ones_like(fin)).all(dim=-1)
    drafts = ids[:, 1:]
    # position j's logits score draft j+1: live iff j < dl
    has_draft = jpos[:, :K] < dl[:, None]
    idsn = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    if temperature <= 0.0:
        pred = torch.argmax(lg, dim=-1)
        acc = (pred[:, :K] == drafts) & has_draft
        n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        return torch.where(jpos < n_acc[:, None], idsn, pred), n_acc, ok
    u, g = rnd
    p = torch.softmax(_filter_logits(lg, temperature, top_k, top_p), dim=-1)
    p_draft = p[:, :K].gather(-1, drafts[..., None])[..., 0]
    acc = (u < p_draft) & has_draft
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    onehot = torch.nn.functional.one_hot(idsn, V).to(p.dtype)
    res = p * (1.0 - torch.where((jpos < dl[:, None])[..., None], onehot,
                                 torch.zeros_like(onehot)))
    res = res / res.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    sampled = torch.argmax(torch.log(res + 1e-30) + g, dim=-1)
    return torch.where(jpos < n_acc[:, None], idsn, sampled), n_acc, ok


class _HostSpillBridge:
    """RadixCache.spill over ONE engine's device caches and its
    HostPageStore (protocol: RadixCache.__init__). The tree stays
    device-blind; every byte moves through here.

    demote() gathers the pages on the card in one batch and brings them
    over in one copy, then cuts one encoded payload per page; promote()
    decodes and checks every payload FIRST (a corrupt page fails before
    any device page is claimed), then claims the device pages and
    enqueues one host-to-device copy and the cache writes without a
    host sync."""

    def __init__(self, engine: "ServingEngine"):
        self.eng = engine

    def host_free(self) -> int:
        return self.eng.host_store.num_free

    def holds(self, hid: int) -> bool:
        return self.eng.host_store.holds(hid)

    def demote(self, pids):
        """Device pages -> host payloads. Returns the host ids, or None
        when the host pool ran out mid-batch (partial puts roll back, so
        a refused demotion leaks nothing — the caller drops instead)."""
        store = self.eng.host_store
        hids = []
        try:
            for payload in self.eng._gather_page_payloads(pids):
                hids.append(store.put(payload))
        except HostPagesExhausted:
            for hid in hids:
                store.decref(hid)
            return None
        return hids

    def promote(self, hids):
        """Host payloads -> fresh device pages (refcount 1 each — the
        tree's ref). Returns None when the device pool is dry (recompute
        beats evicting for a maybe-hit); HostPageError kinds propagate
        after their fault counter is bumped, with no device page
        claimed."""
        eng = self.eng
        c = eng.metrics.counters
        try:
            records = [eng._page_records(eng.host_store.get(hid))
                       for hid in hids]
        except HostPageSlow:
            c["host_spill_slow"] += 1
            raise
        except HostPageCorrupt:
            c["host_spill_corrupt"] += 1
            raise
        except HostPageLost:
            c["host_spill_lost"] += 1
            raise
        try:
            pids = eng.allocator._alloc_pages(len(hids))
        except BlocksExhausted:
            return None
        eng._scatter_page_records(pids, records)
        return pids

    def release(self, hids):
        """Drop the tree's host refs. Tolerates ids the store forgot
        after a host_spill.lost fault — the lost slot is already free,
        and a decref there would double-free a reused slot."""
        store = self.eng.host_store
        for hid in hids:
            if store.holds(hid):
                store.decref(hid)


class ServingEngine:
    """Continuous-batching engine over a causal LM with paged-KV decode.

    model: a LlamaForCausalLM-protocol module (`forward_paged_prefill`,
    `forward_paged_decode`, and `forward_paged_decode_multi` /
    `forward_paged_verify` for multi-step and speculative decode) whose
    parameters live on `device` — the card unless `device="cpu"` is
    passed. The engine owns the per-layer paged caches (in the model's
    dtype, or int8 with scale pages for kv_dtype="int8") on the same
    device. wq="int8"/"int4" quantizes the model's MLP and LM-head
    weights IN PLACE at construction, as the reference does. lora (an
    AdapterRegistry on the same device) turns on multi-LoRA serving.

    proposer (a serving.spec.Proposer) turns on speculative decoding:
    up to `spec_k` drafts a decoding request are verified per step,
    `spec_buckets` the K axis of the verify grid. decode_steps=K runs K
    decode steps per launch, `multi_buckets` the K axis of its grid;
    the two are mutually exclusive. trace=True (or a shared
    RequestTracer) turns on per-request tracing. host_spill_pages > 0
    adds the host spill tier under the radix cache; role="prefill"
    hands requests off after their prefill.
    """

    def __init__(self, model, *, device=None, num_pages: int = 128,
                 page_size: int = 16, max_batch_size: int = 8,
                 token_budget: int = 512,
                 batch_buckets: Optional[List[int]] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 pages_buckets: Optional[List[int]] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 max_retained_finished: int = 1024,
                 enable_prefix_cache: bool = True,
                 max_queue_len: Optional[int] = None,
                 default_ttl_s: Optional[float] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 clock=None,
                 proposer=None, spec_k: int = 4,
                 spec_buckets: Optional[List[int]] = None,
                 decode_steps: int = 1,
                 multi_buckets: Optional[List[int]] = None,
                 kv_dtype: Optional[str] = None, wq: Optional[str] = None,
                 kv_pool_bytes: Optional[int] = None,
                 host_spill_pages: int = 0, mesh=None, lora=None,
                 role: str = "both", compile_cache=None,
                 trace=None, trace_ring: int = 512,
                 flight_recorder_steps: int = 128):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got "
                             f"{kv_dtype!r}")
        if wq not in (None, "int8", "int4"):
            raise ValueError(f"wq must be None, 'int8' or 'int4', got "
                             f"{wq!r}")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be 'both', 'prefill' or "
                             f"'decode', got {role!r}")
        if int(host_spill_pages) < 0:
            raise ValueError("host_spill_pages must be >= 0")
        self.decode_steps = int(decode_steps)
        if self.decode_steps < 1:
            raise ValueError("decode_steps must be >= 1")
        if self.decode_steps > MAX_DECODE_STEPS:
            raise ValueError(
                f"decode_steps {self.decode_steps} exceeds "
                f"MAX_DECODE_STEPS {MAX_DECODE_STEPS}")
        self.spec_k = int(spec_k)
        if proposer is not None and self.spec_k < 1:
            raise ValueError("spec_k must be >= 1 with a proposer")
        # the head split, the capability table on the features asked
        # for, then what the port does not have yet — all before the
        # model is touched
        if mesh is not None and not isinstance(mesh, ModelParallelMesh):
            raise TypeError(f"mesh must be a serving.tp_serving_mesh(tp), "
                            f"got {type(mesh).__name__}")
        tp = mesh.tp if mesh is not None else 1
        if tp > 1:
            cfg = model.cfg
            if cfg.num_key_value_heads % tp:
                raise ValueError(
                    f"num_key_value_heads {cfg.num_key_value_heads} not "
                    f"divisible by model-axis degree {tp}")
            if cfg.num_attention_heads % tp:
                raise ValueError(
                    f"num_attention_heads {cfg.num_attention_heads} not "
                    f"divisible by model-axis degree {tp}")
        active = {name for name, on in (
            ("proposer", proposer is not None),
            ("multi_step_decode", self.decode_steps > 1),
            ("lora", lora is not None),
            ("tensor_parallel", tp > 1),
            ("host_spill", int(host_spill_pages) > 0),
            ("no_prefix_cache", not enable_prefix_cache),
            ("prefill_role", role == "prefill")) if on}
        check_feature_conflicts(active)
        _refuse_unported(compile_cache=compile_cache)
        # a mesh of degree 1 is no mesh: nothing is split
        self.tp = tp
        self.mesh = mesh if tp > 1 else None
        if self.mesh is not None and device is None:
            device = self.mesh.device
        if lora is not None and not isinstance(lora, AdapterRegistry):
            raise TypeError(f"lora must be a serving.lora.AdapterRegistry, "
                            f"got {type(lora).__name__}")
        self.spec_buckets = (sorted(spec_buckets or
                                    _pow2_buckets(1, self.spec_k))
                             if proposer is not None else [])
        if self.spec_buckets and self.spec_buckets[-1] != self.spec_k:
            raise ValueError(
                f"largest spec bucket {self.spec_buckets[-1]} must equal "
                f"spec_k {self.spec_k}")
        self.multi_buckets = (sorted(multi_buckets or
                                     _pow2_buckets(1, self.decode_steps))
                              if self.decode_steps > 1 else [])
        if self.multi_buckets and \
                self.multi_buckets[-1] != self.decode_steps:
            raise ValueError(
                f"largest multi bucket {self.multi_buckets[-1]} must "
                f"equal decode_steps {self.decode_steps}")
        self.proposer = proposer
        # "prefill": a request whose prefill completes finishes
        # "handoff" (pages donated for a decode-role engine to adopt)
        # unless pinned colocate; "decode" behaves like "both"
        self.role = role
        self.device = resolve_device(device)
        if self.mesh is not None and self.device != self.mesh.device:
            raise ValueError(f"the engine's device {self.device} is not "
                             f"its mesh rank's {self.mesh.device}")
        if getattr(model, "mesh", None) not in (None, self.mesh):
            raise ValueError(f"the model is split over {model.mesh}, the "
                             f"engine's mesh is {self.mesh}")
        first = next(model.parameters())
        if first.device != self.device:
            raise ValueError(f"model parameters live on {first.device}, "
                             f"the engine on {self.device}: build the "
                             f"model on the engine's device")
        if lora is not None and lora.device != self.device:
            raise ValueError(f"the adapter registry's pools live on "
                             f"{lora.device}, the engine on {self.device}: "
                             f"build the registry with the engine's device")
        # adapter pools, page tables and per-row slots reach every launch
        # as device tensors; request refs pin adapters until terminal
        self.lora = lora
        # in place, before the first launch: the MLP and LM-head weights
        # become int8/int4 buffers read by every launch
        self.num_wq_layers = (quantize_for_serving(
            model, algo=f"weight_only_{wq}") if wq is not None else 0)
        if self.mesh is not None and model.mesh is None:
            # in place, after the quantization: each rank keeps its
            # shard of every split weight
            model.shard_(self.mesh)
        params = list(model.parameters())
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        self.num_layers = cfg.num_hidden_layers
        self.num_heads = cfg.num_attention_heads
        self.num_kv = cfg.num_key_value_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.page_size = int(page_size)
        self.dtype = next(p.dtype for p in params if p.is_floating_point())
        dtype_name = str(self.dtype).replace("torch.", "")
        # what one page costs in THIS engine (int8 values + fp32 scales,
        # or the model dtype's full-width pages): the pool sizing, the
        # capacity gauge and the bytes-moved counters hang off it. Under
        # TP a rank holds KVH/tp heads of every page and pays the shard's
        # bytes; kv_pool_bytes is a per-rank budget
        kv_name = kv_dtype or dtype_name
        self.kv_heads_shard = self.num_kv // self.tp
        self.kv_page_bytes = paged_page_bytes(
            self.num_kv, self.page_size, self.head_dim, kv_name)
        self.kv_page_bytes_shard = paged_page_bytes(
            self.kv_heads_shard, self.page_size, self.head_dim, kv_name)
        if kv_pool_bytes is not None:
            num_pages = max(2, int(kv_pool_bytes)
                            // self.kv_page_bytes_shard)
        self.num_pages = int(num_pages)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # fail at construction, not at the first decode launch: the
        # kernel sees a rank's geometry (H/tp query heads over KVH/tp)
        check_supported_paged(
            (1, self.num_heads // self.tp, self.head_dim),
            (self.num_pages, self.kv_heads_shard, self.page_size,
             self.head_dim),
            self.dtype, kv_dtype=kv_dtype)

        # longest sequence a request may ever reach (rope table and page
        # supply both bound it)
        self.max_seq_len = min(int(cfg.max_position_embeddings),
                               (self.num_pages - 1) * self.page_size)
        max_pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.batch_buckets = sorted(batch_buckets or
                                    _pow2_buckets(1, int(max_batch_size)))
        self.prefill_buckets = sorted(
            prefill_buckets or _pow2_buckets(
                min(16, self.max_seq_len), self.max_seq_len))
        self.pages_buckets = sorted(
            pages_buckets or _pow2_buckets(
                min(2, max_pages_per_seq), max_pages_per_seq))
        # the widest block table a decode launch supports also bounds
        # how long any sequence may grow
        self.max_seq_len = min(self.max_seq_len,
                               self.pages_buckets[-1] * self.page_size)
        if self.prefill_buckets[-1] > self.max_seq_len:
            raise ValueError("prefill bucket exceeds max sequence length")

        self.allocator = BlockAllocator(self.num_pages, self.page_size)
        self.radix = (RadixCache(self.allocator)
                      if enable_prefix_cache else None)
        self.scheduler = Scheduler(
            self.allocator, max_batch_size=self.batch_buckets[-1],
            token_budget=min(token_budget, self.prefill_buckets[-1]),
            max_prompt_len=self.max_seq_len,
            prefix_cache=self.radix,
            max_queue_len=max_queue_len)
        if proposer is not None:
            # verify tokens draw from the per-step token budget prefill
            # chunks compete for
            self.scheduler.decode_token_cost = 1 + self.spec_k
        elif self.decode_steps > 1:
            # a decoding request may emit up to K tokens a launch
            self.scheduler.decode_token_cost = self.decode_steps
        # deadlines use an injectable clock so expiry stays deterministic
        self._clock = clock if clock is not None else time.monotonic
        self._clock_skew = 0.0
        self.default_ttl_s = default_ttl_s
        self.supervisor = StepSupervisor(policy=retry_policy,
                                         on_retry=self._on_step_retry)
        self.failed = False
        self.last_snapshot: Optional[dict] = None
        self.metrics = ServingMetrics(name=f"serving-{next(_engine_counter)}")
        if self.lora is not None:
            # registry lifecycle counters land in this engine's metrics
            # (loads done before the engine existed carry in)
            self.lora.bind_counters(self.metrics.counters)
        # per-request tracing is off by default and free when off: every
        # hook is guarded by one `self.tracer is None` check
        if trace is True:
            self.tracer: Optional[RequestTracer] = RequestTracer(
                max_completed=trace_ring)
        elif trace:
            self.tracer = trace
        else:
            self.tracer = None
        self.recorder = FlightRecorder(flight_recorder_steps)
        self._cur_rids = ()          # requests of the launch being run
        self._step_ev = {"programs": []}
        self._step_t0: Optional[float] = None
        self._last_launch_s: Optional[float] = None

        # one (k, v) pair per layer — (k, v, k_scale, v_scale) for int8 —
        # written in place by the launches
        self._kv = [alloc_paged_cache(self.kv_heads_shard, self.num_pages,
                                      self.page_size, self.head_dim,
                                      dtype=self.dtype, device=self.device,
                                      kv_dtype=kv_dtype)
                    for _ in range(self.num_layers)]
        # one token's K+V across every layer, scales included
        # (bytes-moved accounting)
        self.kv_bytes_per_token = (self.num_layers * self.kv_page_bytes
                                   // self.page_size)
        self.metrics.set_kv_info(
            kv_dtype=kv_name, page_bytes=self.kv_page_bytes,
            pool_bytes=self.kv_page_bytes * self.num_pages,
            bytes_per_token=self.kv_bytes_per_token, tp_degree=self.tp,
            page_bytes_shard=self.kv_page_bytes_shard,
            pool_bytes_shard=self.kv_page_bytes_shard * self.num_pages)

        # a page's payload records, in the reference's order: K and V of
        # every layer, then (int8 KV) K and V scale rows of every layer;
        # one host page carries all of them
        self._page_tensors = ([t for layer in self._kv for t in layer[:2]]
                              + [t for layer in self._kv
                                 for t in layer[2:]])
        self._page_heads, self._page_bases, self._page_nbytes = [], [], []
        base = 0
        for t in self._page_tensors:
            nb = t[0].numel() * t.element_size()
            self._page_heads.append(record_head(
                str(t.dtype).replace("torch.", ""), tuple(t.shape[1:]), nb))
            self._page_bases.append(base)
            self._page_nbytes.append(nb)
            base += nb
        self._page_raw_bytes = base
        self.host_spill_pages = int(host_spill_pages)
        self.host_page_bytes = self.num_layers * self.kv_page_bytes
        if self.host_spill_pages:
            self.host_store: Optional[HostPageStore] = HostPageStore(
                self.host_spill_pages)
            self.radix.set_spill(_HostSpillBridge(self))
            self.metrics.set_host_info(pool_pages=self.host_spill_pages,
                                       page_bytes=self.host_page_bytes)
        else:
            self.host_store = None

        self.requests: Dict[int, Request] = {}
        self._finished_order: List[int] = []
        # only the most recent `max_retained_finished` stay readable
        self.max_retained_finished = int(max_retained_finished)
        self.num_evicted_finished = 0

    @property
    def kv_caches(self):
        """The per-layer paged caches: (k_cache, v_cache), each
        (num_pages, KVH, page_size, D) — plus (k_scale, v_scale), each
        (num_pages, KVH, page_size) fp32, for int8 KV; page ids come from
        the allocator."""
        return self._kv

    # --------------------------------------------------- request tracing
    # Every hook returns at once when `self.tracer is None`: the one check
    # the default hot path pays; nothing below it allocates.
    def _on_step_retry(self, label: str, attempt: int):
        self.metrics.on_step_retry()
        if self.tracer is not None:
            for rid in self._cur_rids:
                self.tracer.mark(rid, "retry", label=label,
                                 attempt=attempt, engine=self.metrics.name)

    def _tr_begin(self, req: Request):
        if self.tracer is None:
            return
        self.tracer.begin(req.request_id, engine=self.metrics.name,
                          prompt_len=len(req.prompt_ids),
                          max_new_tokens=req.max_new_tokens)

    def _tr_shed(self, req: Request):
        """Admission shed: the trace begins and ends at the door, so
        sheds show in the completed ring."""
        if self.tracer is None:
            return
        self._tr_begin(req)
        self.tracer.mark(req.request_id, "shed", engine=self.metrics.name,
                         queue_depth=self.scheduler.queue_depth)
        self.tracer.finish(req.request_id, "shed")

    def _tr_admit(self, req: Request, resumed: bool):
        if self.tracer is None:
            return
        tr = self.tracer.get(req.request_id)
        if tr is None:
            return
        now = self.tracer.now_ns()
        tr.span("queue_wait", tr.t_queue, now, resumed=resumed)
        tr.mark("admitted", now, cached_tokens=req.cached_tokens,
                resumed=resumed, engine=self.metrics.name)

    def _tr_launch(self, rids, name: str, t0: int, **args):
        """One span per participating request of a batched launch; the
        record is built once (`span_many`)."""
        if self.tracer is None:
            return
        self.tracer.span_many(rids, name, t0, self.tracer.now_ns(),
                              engine=self.metrics.name, **args)

    def _tr_mark(self, rid: int, name: str, **args):
        if self.tracer is None:
            return
        self.tracer.mark(rid, name, engine=self.metrics.name, **args)

    def _tr_finish(self, rid: int, reason: str):
        if self.tracer is None:
            return
        self.tracer.finish(rid, reason)

    def _tr_preempt(self, req: Request):
        if self.tracer is None:
            return
        tr = self.tracer.get(req.request_id)
        if tr is None:
            return
        now = self.tracer.now_ns()
        tr.mark("preempted", now, engine=self.metrics.name)
        tr.t_queue = now     # the next admission's queue_wait anchor

    def _tr_now(self) -> int:
        return self.tracer.now_ns() if self.tracer is not None else 0

    # ------------------------------------------------------------- intake
    def _now(self) -> float:
        return self._clock() + self._clock_skew

    def _refuse_if_failed(self):
        if self.failed:
            raise EngineFailure("engine has failed; resume from "
                                "last_snapshot", snapshot=self.last_snapshot)

    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None,
                    ttl_s: Optional[float] = None,
                    deadline: Optional[float] = None,
                    adapter: Optional[str] = None) -> int:
        """Queue one request. `ttl_s` (or an absolute engine-clock
        `deadline`) bounds its total lifetime. Raises `EngineOverloaded`
        when the bounded waiting queue is full.

        `adapter` names a LoRA adapter the registry must currently hold:
        an unknown one is shed typed (`AdapterNotLoaded`) at the door,
        never served with base weights. An admitted request pins its
        adapter until it reaches a terminal state."""
        self._refuse_if_failed()
        if adapter is not None:
            if self.lora is None:
                raise AdapterNotLoaded(
                    f"request names adapter {adapter!r} but this engine "
                    f"has no adapter registry (lora=None)",
                    adapter=adapter)
            if not self.lora.has(adapter):
                self.metrics.counters["adapter_rejects"] += 1
                raise AdapterNotLoaded(
                    f"adapter {adapter!r} is not loaded "
                    f"(loaded: {self.lora.adapter_names()})",
                    adapter=adapter)
        req = Request(prompt_ids, max_new_tokens, eos_token_id,
                      adapter=adapter)
        if len(req.prompt_ids) + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {len(req.prompt_ids)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_seq_len "
                f"{self.max_seq_len}")
        if ttl_s is None and deadline is None and \
                self.default_ttl_s is not None:
            ttl_s = self.default_ttl_s
        if ttl_s is not None and deadline is not None:
            raise ValueError("pass ttl_s or deadline, not both")
        if ttl_s is not None:
            deadline = self._now() + float(ttl_s)
        req.deadline = deadline
        try:
            self.scheduler.add_request(req)
        except EngineOverloaded:
            self.metrics.on_shed()
            self._tr_shed(req)
            raise
        if adapter is not None:
            self.lora.acquire(adapter)     # pinned until terminal
            # versioned radix namespace: a reload of the same name never
            # matches KV cached under the replaced weights
            req.adapter_key = self.lora.namespace_of(adapter)
        self.requests[req.request_id] = req
        self.metrics.on_add(req.request_id)
        self._tr_begin(req)
        return req.request_id

    def abort(self, request_id: int) -> bool:
        """Client abort, honored at the next iteration boundary in any
        state (valid KV donated to the radix cache). False when the
        request is unknown or already finished."""
        req = self.requests.get(request_id)
        if req is None or req.state is RequestState.FINISHED:
            return False
        req.aborted = True
        return True

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # -------------------------------------------------------- multi-LoRA
    def load_adapter(self, adapter, quant: Optional[str] = None) -> int:
        """Load a LoRAAdapter into the registry at runtime (only page and
        table values change). Returns the global launch slot;
        quant="int8" stores the payload quantized."""
        if self.lora is None:
            raise AdapterNotLoaded("engine has no adapter registry "
                                   "(construct with lora=...)")
        return self.lora.load(adapter, quant=quant)

    def unload_adapter(self, name: str):
        """Unload an IDLE adapter (typed AdapterBusy while live requests
        still pin it)."""
        if self.lora is None:
            raise AdapterNotLoaded("engine has no adapter registry "
                                   "(construct with lora=...)")
        self.lora.unload(name)

    def _lora_launch_args(self, reqs, B: int) -> tuple:
        """One launch's LoRA inputs: (row_slots (B,), *registry flat
        args), on the device; empty when lora is off. Padded batch rows
        map to global slot 0 (every bucket's null adapter: an exact zero
        delta)."""
        if self.lora is None:
            return ()
        rows = np.zeros((B,), np.int32)
        for i, r in enumerate(reqs):
            if r.adapter is not None:
                rows[i] = self.lora.slot_of(r.adapter)
        return (self._to_device(rows),) + self.lora.flat_args()

    def _lora_scope(self, largs):
        """Scope around a launch's model call: builds the launch's
        LoRAContext and activates the projection hooks (a null context
        when lora is off)."""
        if not largs:
            return contextlib.nullcontext()
        return lora_scope(build_context(self.lora.layout, largs[1:],
                                        largs[0]))

    # ----------------------------------------------------------- launches
    def _noise(self, *rows: int) -> Optional[torch.Tensor]:
        """Gumbel sampling noise of shape (*rows, V) for one launch,
        drawn before the supervised call (None for greedy)."""
        if self.temperature <= 0.0:
            return None
        return sample_noise(tuple(rows) + (self.cfg.vocab_size,), self._gen,
                            self.device)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _run_chunk(self, chunk):
        req = chunk.request
        ids = req.resume_ids[chunk.start:chunk.start + chunk.length]
        S = _bucket_for(chunk.length, self.prefill_buckets)
        P = _bucket_for(
            self.allocator.pages_needed(chunk.start + chunk.length),
            self.pages_buckets)
        bt = np.full((P,), PAD_PAGE, np.int32)
        npages = min(len(req.seq.pages), P)
        bt[:npages] = req.seq.pages[:npages]
        padded = np.zeros((1, S), np.int64)
        padded[0, :chunk.length] = ids
        ids_t, bt_t = self._to_device(padded), self._to_device(bt)
        # non-final chunks draw nothing: the engine's random stream
        # advances once per token actually emitted
        noise = self._noise(1) if chunk.is_last else None
        largs = self._lora_launch_args([req], 1)

        def launch():
            faults.fire(FAULT_CHUNK)
            with torch.inference_mode(), self._lora_scope(largs):
                logits, _ = self.model.forward_paged_prefill(
                    ids_t, self._kv, bt_t, chunk.start, chunk.length)
                last = logits[0, 0]      # head ran at the chunk end only
                ok = torch.isfinite(last).all()
                if chunk.is_last:
                    tok = _sample(last[None], self.temperature, self.top_k,
                                  self.top_p, noise)[0]
                else:                    # a non-final chunk emits nothing
                    tok = torch.zeros_like(ok, dtype=torch.long)
                res = torch.stack([tok, ok.long()]).cpu()
            return int(res[0]), bool(res[1])

        self._cur_rids = (req.request_id,)
        self._step_ev["programs"].append(f"chunk:S{S}:P{P}")
        t_tr = self._tr_now()
        tok, ok = self.supervisor.run(launch, label="prefill_chunk")
        self._tr_launch((req.request_id,), "prefill_chunk", t_tr,
                        start=chunk.start, length=chunk.length,
                        bucket=[S, P], last=chunk.is_last)
        if faults.fire(FAULT_NAN) is not None:
            ok = False
        self.metrics.on_prefill(chunk.length)
        # the chunk wrote its own tokens' K/V and its attention gathered
        # the whole live prefix (cached tokens + this chunk) per layer
        self.metrics.on_kv_bytes(
            written=chunk.length * self.kv_bytes_per_token,
            read=(chunk.start + chunk.length) * self.kv_bytes_per_token)
        return tok, ok

    def _run_decode(self, reqs: List[Request]):
        n = len(reqs)
        B = _bucket_for(n, self.batch_buckets)
        P = _bucket_for(max(len(r.seq.pages) for r in reqs),
                        self.pages_buckets)
        ids = np.zeros((B, 1), np.int64)
        sl = np.zeros((B,), np.int32)
        bt = np.full((B, P), PAD_PAGE, np.int32)
        bt[:n] = self.allocator.block_table([r.seq for r in reqs], P)
        for i, r in enumerate(reqs):
            # the input token at the row's last position: its newest
            # output, or a known one it replays
            ids[i, 0] = r.token_at(r.seq.num_tokens - 1)
            sl[i] = r.seq.num_tokens
        ids_t, bt_t, sl_t = (self._to_device(a) for a in (ids, bt, sl))
        noise = self._noise(n)    # drawn once: retries re-run identically
        largs = self._lora_launch_args(reqs, B)
        if self.lora is not None:
            self.metrics.on_adapter_mix(
                len({r.adapter for r in reqs if r.adapter is not None}))
        rids = tuple(r.request_id for r in reqs)

        def launch():
            faults.fire(FAULT_DECODE)
            with torch.inference_mode(), self._lora_scope(largs):
                logits, _ = self.model.forward_paged_decode(
                    ids_t, self._kv, bt_t, sl_t)
                # finiteness and sampling look at the live rows only;
                # rows are independent, so a poisoned request flags only
                # its own row
                rows = logits[:n, 0]
                oks = torch.isfinite(rows).all(dim=-1)
                toks = _sample(rows, self.temperature, self.top_k,
                               self.top_p, noise)
                res = torch.stack([toks, oks.long()]).cpu().numpy()
            return res[0], res[1].astype(bool)

        self._cur_rids = rids
        self._step_ev["programs"].append(f"decode:B{B}:P{P}")
        self._step_ev["decode_k"] = 1
        t_tr = self._tr_now()
        t0 = _perf_counter()
        toks, oks = self.supervisor.run(launch, label="decode_step")
        self._last_launch_s = _perf_counter() - t0
        self._tr_launch(rids, "decode_step", t_tr, batch=n, bucket=[B, P],
                        k=1)
        # this step wrote one token per live row and the attention
        # kernel read every live token's K/V
        self.metrics.on_kv_bytes(
            written=n * self.kv_bytes_per_token,
            read=sum(r.seq.num_tokens for r in reqs)
            * self.kv_bytes_per_token)
        oks = oks.copy()
        poison = faults.fire(FAULT_NAN)
        if poison is not None:
            for i in self._poison_rows(poison, reqs):
                oks[i] = False
        for r in reqs:
            # this step wrote the K/V of each row's input token
            r.num_computed = r.seq.num_tokens
        self.metrics.on_decode(n)
        return toks, oks

    @staticmethod
    def _poison_rows(poison, reqs) -> List[int]:
        """Normalize a nan_logits fault payload into row indices:
        callable(reqs) -> rows, True/'all' -> every row, int or list of
        ints -> those rows (out-of-range ignored)."""
        if callable(poison):
            rows = poison(reqs)
        elif poison is True or poison == "all":
            rows = range(len(reqs))
        elif isinstance(poison, int):
            rows = [poison]
        else:
            rows = poison
        return [int(i) for i in rows if 0 <= int(i) < len(reqs)]

    # ----------------------------------------------- multi-step decode
    def _run_multi_decode(self, reqs: List[Request], caps: List[int],
                          K: int):
        """One supervised (B, K, P) multi-step launch. `reqs[i]`'s
        sequence is already extended by caps[i] - 1 slots; returns
        (toks (B, K), n_emit (B,), oks (n,), launch seconds)."""
        n = len(reqs)
        B = _bucket_for(n, self.batch_buckets)
        P = _bucket_for(max(len(r.seq.pages) for r in reqs),
                        self.pages_buckets)
        ids = np.zeros((B,), np.int64)
        sl = np.zeros((B,), np.int32)
        cp = np.zeros((B,), np.int32)
        eos = np.full((B,), -1, np.int64)
        bt = np.full((B, P), PAD_PAGE, np.int32)
        bt[:n] = self.allocator.block_table([r.seq for r in reqs], P)
        for i, (r, c) in enumerate(zip(reqs, caps)):
            ids[i] = r.output_ids[-1]
            # seq_lens counts through the FIRST input token; the
            # extension slots grew num_tokens past it
            sl[i] = r.seq.num_tokens - (c - 1)
            cp[i] = c
            if r.eos_token_id is not None:
                eos[i] = r.eos_token_id
        ids_t, bt_t, sl_t, cp_t, eos_t = (self._to_device(a)
                                          for a in (ids, bt, sl, cp, eos))
        noise = self._noise(K, B)   # every step's, drawn once per launch
        largs = self._lora_launch_args(reqs, B)
        if self.lora is not None:
            self.metrics.on_adapter_mix(
                len({r.adapter for r in reqs if r.adapter is not None}))
        rids = tuple(r.request_id for r in reqs)

        def launch():
            faults.fire(FAULT_MULTI)
            # the LoRA scope spans the whole launch: the slot stacks are
            # gathered once, not once per step
            with torch.inference_mode(), self._lora_scope(largs):
                toks, n_emit, ok, _ = self.model.forward_paged_decode_multi(
                    ids_t, self._kv, bt_t, sl_t, cp_t, eos_t, noise,
                    k_steps=K, temperature=self.temperature,
                    top_k=self.top_k, top_p=self.top_p)
                # the launch's one read-back
                return torch.cat([toks, n_emit[:, None].long(),
                                  ok[:, None].long()], dim=1).cpu().numpy()

        self._cur_rids = rids
        self._step_ev["programs"].append(f"multi_decode:B{B}:K{K}:P{P}")
        self._step_ev["decode_k"] = K
        t_tr = self._tr_now()
        t0 = _perf_counter()
        res = self.supervisor.run(launch, label="multi_decode_step")
        dt = _perf_counter() - t0
        toks, n_emit = res[:, :K], res[:, K].astype(int)
        oks = res[:n, K + 1].astype(bool)
        self._tr_launch(rids, "multi_decode_step", t_tr, batch=n,
                        bucket=[B, K, P], k=K)
        # every live row writes one token's K/V a step (frozen steps
        # rewrite the same slot) and each step's attention reads the
        # row's then-current prefix (frozen rows at their frozen length)
        reads = sum(int(b0) * K + sum(min(j, int(e)) for j in range(K))
                    for b0, e in zip(sl[:n], n_emit[:n]))
        self.metrics.on_kv_bytes(
            written=n * K * self.kv_bytes_per_token,
            read=reads * self.kv_bytes_per_token)
        for r in reqs:
            r.num_computed = r.seq.num_tokens
        poison = faults.fire(FAULT_NAN)
        if poison is not None:
            for i in self._poison_rows(poison, reqs):
                oks[i] = False
        return toks, n_emit, oks, dt

    def _multi_decode_step(self, decodes: List[Request], emitted):
        """Extend each sequence by up to K-1 slots -> ONE K-step launch
        -> emit each row's tokens up to its freeze point -> roll unused
        slots back.

        Transients retry (writes idempotent, noise pre-drawn); a row
        whose per-launch finiteness flag is down is quarantined alone
        and delivers no token of the launch; unattributed poison rolls
        the extension slots back and isolates through solo plain-decode
        launches; anything else fails the engine to a snapshot."""
        caps = []
        for req in decodes:
            want = min(self.decode_steps, req.remaining_new_tokens())
            granted, copies = self._extend_slots(req, want - 1)
            if granted < want - 1:
                self.metrics.counters["multi_decode_slot_shortfall"] += \
                    (want - 1) - granted
            if copies:
                self._apply_copies(copies)
            caps.append(1 + granted)
        K = _bucket_for(max(caps), self.multi_buckets)
        try:
            toks, n_emit, oks, dt = self._run_multi_decode(decodes, caps, K)
        except Exception as exc:   # noqa: BLE001
            toks1, oks = self._rollback_and_isolate(
                exc, decodes, [c - 1 for c in caps])
            self._emit_rows(decodes, toks1[:, None], [1] * len(decodes),
                            [0] * len(decodes), oks, emitted)
            # the solo launches counted their tokens in _run_decode; the
            # rows keep the tokens-per-launch denominator honest
            self.metrics.on_decode_launch(1, len(decodes), 0, None)
            return
        total_emitted, _, _ = self._emit_rows(
            decodes, toks, n_emit, [c - 1 for c in caps], oks, emitted)
        self.metrics.on_decode(total_emitted)
        self.metrics.on_decode_launch(K, len(decodes), total_emitted, dt)

    def _rollback_and_isolate(self, exc, decodes: List[Request],
                              extended: List[int]):
        """A decode-side launch over `decodes` failed. Anything but
        poison fails the engine to a snapshot. Unattributed poison rolls
        back each row's `extended[i]` slots past its input token (their
        K/V is suspect) and isolates through solo plain-decode launches;
        returns their (tokens (n,), oks (n,))."""
        if classify_failure(exc) != POISON:
            self._fail(exc)
        for req, e in zip(decodes, extended):
            if e:
                self.allocator.truncate_sequence(req.seq,
                                                 req.seq.num_tokens - e)
        return self._isolate_poisoned(decodes)

    def _emit_rows(self, decodes: List[Request], toks, counts,
                   extended: List[int], oks, emitted):
        """Deliver a decode-side launch's tokens: row i's sequence holds
        `extended[i]` slots past its input token; a row whose flag in
        `oks` is down is quarantined (pages, extension slots included,
        freed WITHOUT donation, no token delivered); the others emit up
        to counts[i] of toks[i] until a finish reason. The valid K/V is
        the input token + the emitted tokens consumed as later inputs;
        every slot past it rolls back, so donation and resume never see
        it. Returns (tokens emitted, slots rolled back, rows kept)."""
        total_emitted = total_rolled = rows = 0
        for i, req in enumerate(decodes):
            base = req.seq.num_tokens - extended[i]   # through input tok
            if not oks[i]:
                self._quarantine(req)
                continue
            reason = None
            n_done = 0
            for j in range(int(counts[i])):
                reason = self._emit(req, int(toks[i, j]), emitted)
                n_done += 1
                if reason is not None:
                    break
            valid = base + max(n_done, 1) - 1
            rolled = req.seq.num_tokens - valid
            if rolled:
                self.allocator.truncate_sequence(req.seq, valid)
            req.num_computed = valid
            total_emitted += n_done
            total_rolled += rolled
            rows += 1
            if reason is not None:
                self.scheduler.finish(req, reason)
                self._on_finished(req)
        return total_emitted, total_rolled, rows

    # ------------------------------------------------ speculative verify
    def _extend_slots(self, req: Request, want: int):
        """Grow the request's sequence by up to `want` token slots (the
        scheduler already reserved this launch's input-token slot). On
        pool exhaustion the reclamation ladder stops at radix eviction
        of unreferenced cached prefixes — it never preempts live work
        for these advisory slots. Degrades, never fails: a dry pool
        grants fewer (zero means a single-step launch). Returns
        (granted, CoW copies due)."""
        base = req.seq.num_tokens
        copies, granted = [], 0
        for _ in range(want):
            try:
                copies.extend(self.allocator.append_token(req.seq))
            except BlocksExhausted:
                if not self.scheduler._reclaim(1):
                    break
                try:
                    copies.extend(self.allocator.append_token(req.seq))
                except BlocksExhausted:
                    break
            granted += 1
        assert req.seq.num_tokens == base + granted
        return granted, copies

    def _extend_for_drafts(self, req: Request, draft: List[int]):
        """Grow by up to len(draft) slots, shortening the draft to what
        the pool granted. Returns (granted draft, CoW copies due)."""
        granted, copies = self._extend_slots(req, len(draft))
        if granted < len(draft):
            self.metrics.on_spec_draft_oom(len(draft) - granted)
        del draft[granted:]
        return draft, copies

    def _run_verify(self, reqs: List[Request], drafts: List[List[int]]):
        """One supervised (B, K, P) verify launch. `reqs[i]`'s sequence
        is already extended by len(drafts[i]); returns (toks (B, K+1),
        n_acc (B,), oks (n,))."""
        n = len(reqs)
        B = _bucket_for(n, self.batch_buckets)
        K = _bucket_for(max((len(d) for d in drafts), default=0) or 1,
                        self.spec_buckets)
        P = _bucket_for(max(len(r.seq.pages) for r in reqs),
                        self.pages_buckets)
        S = K + 1
        ids = np.zeros((B, S), np.int64)
        sl = np.zeros((B,), np.int32)
        dl = np.zeros((B,), np.int64)
        bt = np.full((B, P), PAD_PAGE, np.int32)
        bt[:n] = self.allocator.block_table([r.seq for r in reqs], P)
        for i, (r, d) in enumerate(zip(reqs, drafts)):
            ids[i, 0] = r.output_ids[-1]
            ids[i, 1:1 + len(d)] = d
            dl[i] = len(d)
            # seq_lens counts through the FIRST input token; the drafts
            # extended num_tokens past it
            sl[i] = r.seq.num_tokens - len(d)
        ids_t, bt_t, sl_t, dl_t = (self._to_device(a)
                                   for a in (ids, bt, sl, dl))
        # drawn once: retries re-run identically
        rnd = None
        if self.temperature > 0.0:
            rnd = (torch.rand((B, K), generator=self._gen,
                              device=self.device), self._noise(B, S))
        rids = tuple(r.request_id for r in reqs)

        def launch():
            faults.fire(FAULT_VERIFY)
            with torch.inference_mode():
                logits, _ = self.model.forward_paged_verify(
                    ids_t, self._kv, bt_t, sl_t, dl_t)
                toks, n_acc, ok = _verify_accept(
                    logits, ids_t, dl_t, self.temperature, self.top_k,
                    self.top_p, rnd)
                # the launch's one read-back
                return torch.cat([toks, n_acc[:, None], ok[:, None].long()],
                                 dim=1).cpu().numpy()

        self._cur_rids = rids
        self._step_ev["programs"].append(f"verify:B{B}:K{K}:P{P}")
        # a verify launch can emit up to K drafts + 1 correction/bonus
        self._step_ev["decode_k"] = K + 1
        t_tr = self._tr_now()
        res = self.supervisor.run(launch, label="verify_step")
        if self.tracer is not None:
            t1 = self.tracer.now_ns()
            for rid, d in zip(rids, drafts):
                self.tracer.span(rid, "verify_step", t_tr, t1,
                                 engine=self.metrics.name, batch=n,
                                 drafted=len(d), bucket=[B, K, P])
        self.metrics.on_kv_bytes(
            written=int(sum(1 + len(d) for d in drafts))
            * self.kv_bytes_per_token,
            read=sum(r.seq.num_tokens for r in reqs)
            * self.kv_bytes_per_token)
        oks = res[:n, S + 1].astype(bool)
        poison = faults.fire(FAULT_NAN)
        if poison is not None:
            for i in self._poison_rows(poison, reqs):
                oks[i] = False
        return res[:, :S], res[:, S].astype(int), oks

    def _spec_decode_step(self, decodes: List[Request], emitted):
        """propose -> extend KV -> ONE verify launch -> emit the accepted
        prefix + correction/bonus -> roll rejected drafts' pages back.

        Transients retry (the verify write is idempotent, its random
        numbers pre-drawn); per-row poison quarantines alone;
        unattributed poison rolls every draft back and isolates through
        solo plain-decode launches; anything else, and a proposer that
        raises (a draft model's launch on the card), fails the engine to
        a snapshot."""
        # drafts are advisory and capped so the emitted tokens never
        # overshoot max_new_tokens: r remaining tokens use at most r - 1
        # accepted drafts (+1 correction/bonus)
        try:
            proposals = self.proposer.propose(decodes, self.spec_k)
        except Exception as exc:   # noqa: BLE001
            self._fail(exc)
        storm = faults.fire(FAULT_DRAFT)
        if storm is not None:
            proposals = (storm(decodes, self.spec_k) if callable(storm)
                         else [[(i * 7 + j * 13 + 1) %
                                max(2, self.cfg.vocab_size)
                                for j in range(self.spec_k)]
                               for i in range(len(decodes))])
        drafts = []
        for req, prop in zip(decodes, proposals):
            cap = max(0, min(self.spec_k, req.remaining_new_tokens() - 1))
            d = [int(t) for t in list(prop)[:cap]]
            d, copies = self._extend_for_drafts(req, d)
            if copies:
                self._apply_copies(copies)
            drafts.append(d)

        try:
            toks, n_accs, oks = self._run_verify(decodes, drafts)
        except Exception as exc:   # noqa: BLE001
            toks1, oks = self._rollback_and_isolate(
                exc, decodes, [len(d) for d in drafts])
            # real rollback work even though no verify step completed
            self.metrics.counters["spec_rollback_tokens"] += sum(
                len(d) for d in drafts)
            # the solo launches counted their own tokens and verified
            # nothing
            self._emit_rows(decodes, toks1[:, None], [1] * len(decodes),
                            [0] * len(decodes), oks, emitted)
            return
        drafted = sum(len(d) for d, ok in zip(drafts, oks) if ok)
        total_emitted, total_rb, rows = self._emit_rows(
            decodes, toks, n_accs + 1, [len(d) for d in drafts], oks,
            emitted)
        # decode_tokens counts tokens emitted by decode-side launches
        self.metrics.on_decode(total_emitted)
        self.metrics.on_spec_step(drafted, total_emitted - rows,
                                  total_emitted, total_rb, rows)

    def _apply_copies(self, copies):
        """Device-side copy-on-write: copy a page's rows to a fresh page
        in every layer's K and V — and, for int8 KV, its scale rows,
        which are part of the page: a fork that copied only the values
        would dequantize them with another page's scales."""
        for src, dst in copies:
            for layer in self._kv:
                for t in layer:
                    t[dst].copy_(t[src])

    # ----------------------------------------------- tiered KV page I/O
    def _gather_page_payloads(self, pids) -> List[bytes]:
        """The encoded payloads of device pages `pids`: every cache
        tensor's rows of all the pages are gathered on the device into
        one record-major byte buffer (record j of every page in one
        block), which crosses to pinned host memory in ONE copy; each
        page's payload is then cut from it. The raw rows move exactly,
        so a promoted page is bitwise the page that was demoted."""
        n = len(pids)
        idx = self._to_device(np.asarray(pids, np.int64))
        flat = torch.empty(n * self._page_raw_bytes, dtype=torch.uint8,
                           device=self.device)
        for t, base, nb in zip(self._page_tensors, self._page_bases,
                               self._page_nbytes):
            dst = flat[n * base:n * (base + nb)].view(t.dtype)
            torch.index_select(t, 0, idx, out=dst.view(n, *t.shape[1:]))
        staged = torch.empty(flat.shape, dtype=torch.uint8,
                             pin_memory=self.device.type == "cuda")
        staged.copy_(flat)              # the one copy; returns when done
        host = memoryview(staged.numpy())
        return [pack_page_payload(
            self._page_heads,
            [host[n * base + i * nb:n * base + (i + 1) * nb]
             for base, nb in zip(self._page_bases, self._page_nbytes)])
            for i in range(n)]

    def _page_records(self, payload):
        """A payload's raw record bytes, after its CRC and its geometry
        (record count, dtypes, shapes) are checked against this engine's
        pages: HostPageCorrupt otherwise, before anything lands."""
        recs = decode_page_records(payload)
        if len(recs) != len(self._page_heads) or any(
                record_head(name, shape, len(raw)) != head
                for (name, shape, raw), head in zip(recs,
                                                    self._page_heads)):
            raise HostPageCorrupt(
                f"page payload of {len(recs)} records does not match "
                f"this engine's {len(self._page_heads)}-record pages")
        return [raw for _, _, raw in recs]

    def _scatter_page_records(self, pids, records):
        """Write checked payload records (`_page_records`) into device
        pages `pids`: the page ids and every record go into one pinned
        host buffer, cross in ONE non-blocking copy, and land with one
        `index_copy_` per cache tensor — no host sync, the stream orders
        the writes before any launch that reads the pages. The pinned
        buffer may be dropped at once: PyTorch's caching host allocator
        does not reuse it until the copy that reads it has completed."""
        n = len(pids)
        head = 8 * n                       # the page ids, int64
        buf = torch.empty(head + n * self._page_raw_bytes,
                          dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        host = buf.numpy()
        host[:head] = np.asarray(pids, np.int64).view(np.uint8)
        for i, raws in enumerate(records):
            for raw, base, nb in zip(raws, self._page_bases,
                                     self._page_nbytes):
                at = head + n * base + i * nb
                host[at:at + nb] = np.frombuffer(raw, np.uint8)
        dev = buf.to(self.device, non_blocking=True)
        idx = dev[:head].view(torch.int64)
        for t, base, nb in zip(self._page_tensors, self._page_bases,
                               self._page_nbytes):
            src = dev[head + n * base:head + n * (base + nb)].view(t.dtype)
            t.index_copy_(0, idx, src.view(n, *t.shape[1:]))

    def _spill_gauges(self) -> dict:
        """update_gauges kwargs of the radix eviction rungs and the host
        spill tier; fields the engine does not own stay None
        (untouched)."""
        out = {}
        if self.radix is not None:
            out.update(radix_evict_demoted=self.radix.num_evict_demoted,
                       radix_evict_dropped=self.radix.num_evict_dropped)
        if self.host_store is not None:
            out.update(
                host_pages_used=self.host_store.num_used,
                host_occupancy=self.host_store.occupancy(),
                kv_pages_demoted=self.radix.num_demoted_pages,
                kv_pages_promoted=self.radix.num_promoted_pages,
                host_prefix_hits=self.radix.num_host_hits,
                host_pages_dropped=self.radix.num_host_dropped_pages)
        return out

    # ------------------------------------------------------------- step
    def _emit(self, req: Request, tok: int, emitted):
        """Record one generated token + run the finish checks."""
        first = req.num_generated == 0
        req.output_ids.append(tok)
        if first:
            self.metrics.on_first_token(req.request_id)
            self._tr_mark(req.request_id, "first_token")
        emitted.append((req.request_id, tok))
        if req.eos_token_id is not None and tok == req.eos_token_id:
            return "stop"
        if req.remaining_new_tokens() <= 0:
            return "length"
        return None

    def _cancel_boundary(self):
        """Iteration-boundary sweep: apply any injected clock skew, then
        cancel aborted and past-deadline requests in ANY state."""
        skew = faults.fire(FAULT_STORM)
        if skew is not None:
            self._clock_skew += float(skew)
        now = self._now()
        for req in list(self.requests.values()):
            if req.state is RequestState.FINISHED:
                continue
            if req.aborted:
                if self.scheduler.cancel(req, "abort"):
                    self.metrics.on_abort(req.request_id)
                    self._tr_finish(req.request_id, "abort")
                    self._retain(req)
            elif req.deadline is not None and now >= req.deadline:
                if self.scheduler.cancel(req, "expired"):
                    self.metrics.on_expire(req.request_id)
                    self._tr_finish(req.request_id, "expired")
                    self._retain(req)

    def _quarantine(self, req: Request):
        """Fail ONE poisoned request, not the engine: no token is
        emitted, its pages are freed WITHOUT donation (they may hold
        NaN K/V — the radix tree must never serve them)."""
        if self.scheduler.cancel(req, "quarantined", donate=False):
            self.metrics.on_quarantine(req.request_id)
            self._tr_mark(req.request_id, "quarantined")
            self._tr_finish(req.request_id, "quarantined")
            self._retain(req)

    def _fail(self, exc: BaseException):
        """Unrecoverable: stamp the failing step into the flight
        recorder, drain to a serializable snapshot and raise
        EngineFailure. The engine refuses further work afterwards."""
        self.metrics.on_engine_failure()
        self.recorder.record({
            "step": int(self.metrics.counters["engine_steps"]) + 1,
            "failed": repr(exc),
            "programs": list(self._step_ev.get("programs", ())),
            "t_wall_ms": (round((time.perf_counter()
                                 - self._step_t0) * 1e3, 3)
                          if self._step_t0 is not None else None),
            "queue_depth": int(self.scheduler.queue_depth),
            "running": len(self.scheduler.running),
            "kv_used_pages": int(self.allocator.num_used),
            "kv_occupancy": round(float(self.allocator.occupancy()), 4),
        })
        self.last_snapshot = self.snapshot(reason=repr(exc))
        self.failed = True
        raise EngineFailure(
            f"unrecoverable engine error: {exc!r}; state drained to "
            f"snapshot ({len(self.last_snapshot['requests'])} requests)",
            snapshot=self.last_snapshot, cause=exc) from exc

    def step(self):
        """One engine iteration: cancellation sweep, schedule, run
        prefill chunks, run the batched decode-side launch (plain,
        multi-step or verify). Returns [(request_id, token)] in emission
        order (empty when idle).

        Failure semantics per launch: transients retried by the
        supervisor; a poison failure quarantines the offending
        request(s) and the step continues; anything else drains to a
        snapshot and raises EngineFailure."""
        self._refuse_if_failed()
        emitted = []
        self._step_t0 = time.perf_counter()
        self._step_ev = {"programs": []}
        c = self.metrics.counters
        pre = {k: c[k] for k in (
            "prefill_tokens", "requests_preempted", "step_retries",
            "requests_quarantined", "requests_aborted",
            "deadline_expired", "prefix_hits", "spec_drafted_tokens",
            "spec_accepted_tokens")}
        self._cancel_boundary()
        sched = self.scheduler.schedule()
        for req in sched.preempted:
            self.metrics.on_preempt()
            self._tr_preempt(req)

        for chunk in sched.prefills:
            req = chunk.request
            if req.state is RequestState.FINISHED:
                continue               # quarantined earlier this step
            if chunk.is_first:
                resumed = req.num_preemptions > 0
                self.metrics.on_admission(req.request_id,
                                          req.cached_tokens,
                                          resumed=resumed)
                self._tr_admit(req, resumed=resumed)
            try:
                tok, ok = self._run_chunk(chunk)
            except Exception as exc:   # noqa: BLE001
                if classify_failure(exc) == POISON:
                    self._quarantine(req)
                    continue
                self._fail(exc)
            if not ok:
                self._quarantine(req)
                continue
            req.num_computed = chunk.start + chunk.length
            if chunk.is_last and req.replay_tokens:
                # an adopted request: its next token is known; the
                # tokens it generated replay through decode launches
                req.replay_tokens = 0
                self.scheduler.on_prefilled(req)
            elif chunk.is_last:
                reason = self._emit(req, tok, emitted)
                if reason is not None:
                    self.scheduler.finish(req, reason)
                    self._on_finished(req)
                elif self.role == "prefill" and not req.colocate:
                    # disaggregated prefill: the pages donate to the
                    # radix tree and the request finishes "handoff"; the
                    # first token is already emitted, so a decode-role
                    # engine resumes from the next one
                    req.handoff_prefix_len = \
                        self.scheduler.finish_handoff(req)
                    self.metrics.counters["prefill_handoffs"] += 1
                    self._on_finished(req)
                else:
                    self.scheduler.on_prefilled(req)

        decodes = [r for r in sched.decodes
                   if r.state is not RequestState.FINISHED]
        if decodes:
            for req in decodes:
                self._apply_copies(req.pending_copies)
                req.pending_copies = []
            if any(r.replaying for r in decodes):
                # a known token is fed this step: one plain decode
                # launch, as the uninterrupted run decoded it
                self._plain_decode_step(decodes, emitted)
            elif self.proposer is not None:
                self._spec_decode_step(decodes, emitted)
            elif self.decode_steps > 1:
                self._multi_decode_step(decodes, emitted)
            else:
                self._plain_decode_step(decodes, emitted)

        self.metrics.on_step()
        self._update_gauges()
        self._record_step(pre, n_chunks=len(sched.prefills),
                          n_decode=len(decodes), n_emitted=len(emitted))
        if self.mesh is not None:
            self._check_ranks_agree(len(sched.prefills), len(decodes),
                                    emitted)
        return emitted

    def _check_ranks_agree(self, n_chunks: int, n_decode: int, emitted):
        """Tensor parallelism: every rank must have taken this step
        alike, or their next collectives would not match. The ranks
        compare a fingerprint of the step (launch buckets, rows, emitted
        tokens, pages in use) by one max-reduce of (h, -h) on the mesh's
        host group; a rank that differs fails the engine on every
        rank."""
        key = repr((self._step_ev["programs"], n_chunks, n_decode, emitted,
                    self.allocator.num_used)).encode()
        h = int.from_bytes(hashlib.blake2b(key, digest_size=7).digest(),
                           "little")
        t = torch.tensor([h, -h], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.host_group)
        if int(t[0]) != h or int(t[1]) != -h:
            self._fail(RuntimeError(
                f"tensor-parallel ranks diverged at engine step "
                f"{self.metrics.counters['engine_steps']}: rank "
                f"{self.mesh.rank} of {self.mesh.tp} took another step"))

    def _update_gauges(self):
        self.metrics.update_gauges(
            queue_depth=self.scheduler.queue_depth,
            running=len(self.scheduler.running),
            kv_used_pages=self.allocator.num_used,
            kv_occupancy=self.allocator.occupancy(),
            cached_pages=self.radix.num_cached_pages if self.radix else 0,
            radix_nodes=self.radix.num_nodes if self.radix else 0,
            radix_evicted_pages=(self.radix.num_evicted_pages
                                 if self.radix else None),
            **self._spill_gauges())

    def _record_step(self, pre: Dict[str, int], *, n_chunks: int,
                     n_decode: int, n_emitted: int):
        """Append this iteration's step record to the flight recorder;
        idle steps (nothing scheduled, nothing cancelled) are skipped
        before any record is built."""
        c = self.metrics.counters
        programs = self._step_ev["programs"]
        events = {k: int(c[k] - pre[k]) for k in (
            "requests_preempted", "requests_aborted", "deadline_expired",
            "requests_quarantined")}
        if not (programs or n_chunks or n_decode or n_emitted
                or any(events.values())):
            return
        self.recorder.record({
            "step": int(c["engine_steps"]),
            "t_wall_ms": round((time.perf_counter()
                                - self._step_t0) * 1e3, 3),
            "programs": list(programs),
            "prefill_chunks": int(n_chunks),
            "prefill_tokens": int(c["prefill_tokens"]
                                  - pre["prefill_tokens"]),
            "decode_batch": int(n_decode),
            # tokens-per-launch context: 1 for plain decode, the K bucket
            # for multi-step decode, K+1 for a verify launch, 0 for no
            # decode-side launch this step
            "decode_k": int(self._step_ev.get("decode_k", 0))
            if n_decode else 0,
            "tokens_out": int(n_emitted),
            "preempted": events["requests_preempted"],
            "retries": int(c["step_retries"] - pre["step_retries"]),
            "quarantined": events["requests_quarantined"],
            "aborted": events["requests_aborted"],
            "expired": events["deadline_expired"],
            "prefix_hits": int(c["prefix_hits"] - pre["prefix_hits"]),
            "spec_drafted": int(c["spec_drafted_tokens"]
                                - pre["spec_drafted_tokens"]),
            "spec_accepted": int(c["spec_accepted_tokens"]
                                 - pre["spec_accepted_tokens"]),
            "queue_depth": int(self.scheduler.queue_depth),
            "running": len(self.scheduler.running),
            "kv_used_pages": int(self.allocator.num_used),
            "kv_occupancy": round(float(self.allocator.occupancy()), 4),
            "cached_pages": int(self.radix.num_cached_pages
                                if self.radix else 0),
        })

    def timeline(self) -> List[dict]:
        """Flight-recorder view: the last N non-idle step records,
        oldest first (the same list rides every snapshot)."""
        return self.recorder.records()

    def _plain_decode_step(self, decodes: List[Request], emitted):
        """One batched single-token decode launch + emission."""
        degraded = False
        try:
            toks, oks = self._run_decode(decodes)
        except Exception as exc:   # noqa: BLE001
            if classify_failure(exc) == POISON:
                # unattributed poison: isolate by running rows solo
                toks, oks = self._isolate_poisoned(decodes)
                degraded = True
            else:
                self._fail(exc)
        n0 = len(emitted)
        for i, req in enumerate(decodes):
            if not oks[i]:
                self._quarantine(req)
                continue
            if req.replaying:
                continue               # its next token is already out
            reason = self._emit(req, int(toks[i]), emitted)
            if reason is not None:
                self.scheduler.finish(req, reason)
                self._on_finished(req)
        # TPOT sample: launch wall seconds / tokens emitted (none for
        # the solo isolation launches — they are not a batch launch)
        self.metrics.on_decode_launch(
            1, len(decodes), 0 if degraded else len(emitted) - n0,
            None if degraded else self._last_launch_s)

    def _isolate_poisoned(self, reqs: List[Request]):
        """Degraded mode for an UNATTRIBUTED poison failure of a decode
        batch: re-run each row solo to find the poisoned request(s).
        Solo launches rewrite the same K/V at the same positions but use
        the B=1 bucket — a different launch shape."""
        toks = np.zeros((len(reqs),), np.int64)
        oks = np.ones((len(reqs),), bool)
        for i, req in enumerate(reqs):
            try:
                t, o = self._run_decode([req])
            except Exception as exc:   # noqa: BLE001
                if classify_failure(exc) == POISON:
                    oks[i] = False
                    continue
                self._fail(exc)
            toks[i] = int(t[0])
            oks[i] = bool(o[0])
        return toks, oks

    def _retain(self, req: Request):
        """Terminal-request retention (bounded window). Every terminal
        path funnels here, so it also releases the proposer's state of
        the request (a draft model's pages) and unpins its adapter."""
        if self.proposer is not None:
            self.proposer.on_finished(req)
        if self.lora is not None and req.adapter is not None:
            self.lora.release(req.adapter)
        self._finished_order.append(req.request_id)
        while len(self._finished_order) > self.max_retained_finished:
            self.requests.pop(self._finished_order.pop(0), None)
            self.num_evicted_finished += 1

    def _on_finished(self, req: Request):
        self.metrics.on_finish(req.request_id)
        self._tr_finish(req.request_id, req.finish_reason or "stop")
        self._retain(req)

    # --------------------------------------------------- snapshot/resume
    def snapshot(self, reason: str = "requested", *,
                 include_recorder: bool = True) -> dict:
        """Serializable drain state: every non-finished request (queued,
        mid-prefill, decoding, preempted) with its prompt, the tokens
        generated so far and its remaining deadline. KV pages are not
        captured: a resumed request re-prefills prompt + generated
        tokens like a preemption resume, so greedy outputs complete
        identically under the same buckets. JSON-safe by construction;
        `include_recorder=False` leaves out the flight recorder."""
        now = self._now()
        recs = []
        for req in self.requests.values():
            if req.state is RequestState.FINISHED:
                continue
            recs.append({
                "request_id": int(req.request_id),
                "prompt_ids": [int(t) for t in req.prompt_ids],
                "output_ids": [int(t) for t in req.output_ids],
                "max_new_tokens": int(req.max_new_tokens),
                "eos_token_id": (None if req.eos_token_id is None
                                 else int(req.eos_token_id)),
                "num_preemptions": int(req.num_preemptions),
                "aborted": bool(req.aborted),
                "deadline_remaining_s": (
                    None if req.deadline is None
                    else float(req.deadline - now)),
                "adapter": req.adapter,
                "colocate": bool(req.colocate),
            })
        recs.sort(key=lambda r: r["request_id"])   # FCFS order on resume
        snap = {"version": SNAPSHOT_VERSION, "minor": SNAPSHOT_MINOR,
                "reason": str(reason),
                "rng_key": self._gen.get_state().tolist(),
                "requests": recs}
        if include_recorder:
            snap["flight_recorder"] = self.recorder.records()
        return snap

    def _restore_request(self, rec: dict) -> Request:
        """Rebuild one snapshot record into THIS engine under its
        original id: its prompt re-prefills and its generated tokens
        replay through decode launches (`Request.replay_tokens`), the
        remaining deadline is re-anchored on this engine's clock, and
        the admission bound is bypassed
        (restored work was admitted once already). A record naming an
        adapter needs it loaded here (typed AdapterNotLoaded
        otherwise)."""
        adapter = rec.get("adapter")
        if adapter is not None and (self.lora is None
                                    or not self.lora.has(adapter)):
            self.metrics.counters["adapter_rejects"] += 1
            raise AdapterNotLoaded(
                f"snapshot request {rec['request_id']} needs adapter "
                f"{adapter!r}, which this engine does not hold",
                adapter=adapter)
        req = Request(rec["prompt_ids"], rec["max_new_tokens"],
                      rec.get("eos_token_id"),
                      request_id=rec["request_id"], adapter=adapter)
        if len(req.prompt_ids) + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"snapshot request {req.request_id} needs "
                f"{len(req.prompt_ids) + req.max_new_tokens} tokens "
                f"> resumed engine max_seq_len {self.max_seq_len}")
        req.output_ids = [int(t) for t in rec.get("output_ids", [])]
        req.replay_tokens = len(req.output_ids)
        req.num_preemptions = int(rec.get("num_preemptions", 0))
        req.aborted = bool(rec.get("aborted", False))
        req.colocate = bool(rec.get("colocate", False))
        rem = rec.get("deadline_remaining_s")
        if rem is not None:
            req.deadline = self._now() + float(rem)
        self.scheduler.add_request(req, force=True)
        if adapter is not None:
            self.lora.acquire(adapter)     # pinned until terminal
            req.adapter_key = self.lora.namespace_of(adapter)
        self.requests[req.request_id] = req
        # adopted, not added: it counted as an arrival where it began
        self.metrics.on_adopt(req.request_id)
        if self.tracer is not None:
            # with a shared tracer the request's live trace continues
            # here (begin is idempotent); otherwise one starts at adopt
            tr = self.tracer.begin(req.request_id,
                                   engine=self.metrics.name,
                                   prompt_len=len(req.prompt_ids),
                                   max_new_tokens=req.max_new_tokens)
            now = self.tracer.now_ns()
            tr.mark("adopt", now, engine=self.metrics.name,
                    tokens_so_far=len(req.output_ids))
            tr.t_queue = now      # re-queued on the adopting engine
        return req

    def adopt_requests(self, recs) -> List[int]:
        """Restore snapshot request records into this RUNNING engine
        (`from_snapshot` minus the construction). Requests keep their
        original ids; the global id counter is bumped past them. Greedy
        continuations equal an uninterrupted run under the same
        buckets; this engine's own random stream serves sampled ones.
        Returns the adopted request ids."""
        self._refuse_if_failed()
        ids = [self._restore_request(rec).request_id for rec in recs]
        if ids:
            bump_request_counter(max(ids))
        return ids

    def vacate(self, reason: str = "migrated") -> int:
        """Release every KV page this engine holds: cancel all
        non-finished requests locally (no donation and no abort/expiry
        metrics — the work re-lands elsewhere through `adopt_requests`)
        and drop the radix tree. Host bookkeeping only, so it works on a
        FAILED engine. Returns the pages freed."""
        before = self.allocator.num_free
        for req in list(self.requests.values()):
            if req.state is not RequestState.FINISHED:
                if self.scheduler.cancel(req, reason, donate=False):
                    self._retain(req)
        self.reset_prefix_cache()
        # a vacated engine usually never steps again: refresh the gauges
        # now, or they keep its last mid-flight values
        self._update_gauges()
        return self.allocator.num_free - before

    @classmethod
    def from_snapshot(cls, model, snapshot: dict, **engine_kw):
        """A fresh engine resuming a drained one. Restored requests keep
        their original ids and re-enter WAITING with their generated
        tokens folded into the resume prompt. Greedy outputs complete
        identically under the same buckets; the random stream is
        restored (`rng_key`), but its position reflects the resume's
        launches, so sampled continuations are reproducible per
        snapshot, not equal to the uninterrupted run. Raises
        `SnapshotVersionError` on a schema-version mismatch."""
        check_snapshot_version(snapshot)
        eng = cls(model, **engine_kw)
        eng._gen.set_state(torch.tensor(snapshot["rng_key"],
                                        dtype=torch.uint8))
        eng.adopt_requests(snapshot["requests"])
        return eng

    # --------------------------------------------------- prefix cache ops
    def reset_prefix_cache(self) -> int:
        """Drop every cached prefix; returns the number of pages
        returned to the free list. With no live requests this brings
        allocator occupancy back to zero."""
        if self.radix is None:
            return 0
        return self.radix.clear()

    # ------------------------------------------- prefix sharing between
    # engines: the donor exports page payloads, the receiver adopts them
    def export_prefix(self, tokens) -> tuple:
        """Donor side: the longest DEVICE-resident cached prefix of
        `tokens` as (num_tokens, [payload bytes, one per page]), the
        spill tier's CRC-protected codec. promote_budget=0 keeps the walk
        on the device tier: an export never charges this engine's
        prefill budget or device pool. The LRU bump is deliberate: a
        pulled prefix is hot."""
        if self.radix is None:
            return 0, []
        pages, m = self.radix.match(tokens, promote_budget=0)
        if not pages:
            return 0, []
        payloads = self._gather_page_payloads(pages)
        self.metrics.counters["kv_pages_exported"] += len(payloads)
        return m, payloads

    def adopt_prefix(self, tokens, payloads) -> int:
        """Receiver side: land a sibling's exported prefix pages in this
        engine's caches and donate them to the radix tree, so the next
        admission matches them like a local prefix. Degrades to 0 —
        never raises — on a corrupt payload, a dry device pool, or a
        span the tree already holds: the prefix then recomputes, the
        spill tier's fallback. Returns pages newly adopted."""
        if self.radix is None or not payloads:
            return 0
        n = min(len(payloads) * self.page_size,
                (len(tokens) // self.page_size) * self.page_size)
        payloads = payloads[:n // self.page_size]
        if not payloads:
            return 0
        try:
            records = [self._page_records(p) for p in payloads]
        except HostPageCorrupt:
            self.metrics.counters["host_spill_corrupt"] += 1
            return 0
        try:
            pids = self.allocator._alloc_pages(len(records))
        except BlocksExhausted:
            return 0
        self._scatter_page_records(pids, records)
        adopted = self.radix.insert(tuple(tokens[:n]), pids)
        # the tree took its own refs on the pages it adopted; drop the
        # intake refs — duplicate pages (spans already cached) free here
        for pid in pids:
            self.allocator._decref(pid)
        self.metrics.counters["kv_pages_adopted"] += adopted
        return adopted

    def release_prefix(self, tokens, *, drop: bool = False) -> int:
        """After a hand-off: once a decode-role sibling adopted this
        engine's pages for `tokens`, the local copy stops earning its
        pool space. Default: make the cached span the coldest LRU entry
        — still matchable, but the first eviction victim, so a
        prefill-role pool never fills with spans that live elsewhere.
        `drop=True` frees the deepest childless device-resident nodes of
        the span outright. Returns pages made cold or freed."""
        if self.radix is None:
            return 0
        chain = [child for child, _ in self.radix._walk_prefix(tokens)]
        released = 0
        if drop:
            before = self.allocator.num_free
            for node in reversed(chain):
                # only childless device-resident tails: dropping an
                # interior node would orphan other prefixes
                if node.children or node.host_pages:
                    break
                self.radix._drop_node(node)
            released = self.allocator.num_free - before
        else:
            for node in chain:
                node.last_use = 0
                released += len(node.pages)
        self.metrics.counters["kv_pages_released"] += released
        return released

    # ------------------------------------------------------- convenience
    def stream(self):
        """Generator over (request_id, token) until all work drains."""
        while self.has_work():
            yield from self.step()

    def run(self) -> Dict[int, List[int]]:
        """Drain everything; returns {request_id: generated tokens} for
        every request alive when run() was called."""
        out = {rid: list(r.output_ids) for rid, r in self.requests.items()}
        guard = 0
        limit = 16 * (self.max_seq_len + 2) * max(1, len(self.requests))
        while self.has_work():
            for rid, tok in self.step():
                out.setdefault(rid, []).append(tok)
            guard += 1
            if guard > limit:
                raise RuntimeError("serving engine failed to drain "
                                   f"after {guard} steps")
        return out

    def shutdown(self):
        """Release the proposer's per-request state (a draft model's
        pages)."""
        if self.proposer is not None:
            self.proposer.reset()
