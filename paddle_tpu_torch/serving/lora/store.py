"""Paged adapter-weight store and registry (port of
`paddle_tpu/serving/lora/store.py`).

Adapter weights are more device pages: `AdapterRegistry` owns a flat
fp32 pool `(num_pages, page_size * 128)` on its device, managed by the
same `BlockAllocator` discipline the KV cache uses (ref-counted pages, a
FIFO free list, all-or-nothing allocation, page 0 reserved as the
all-zero PAD page), and packs each adapter's padded A/B factors for
every target module into a fixed per-rank-bucket number of pages. One
(A, B) per target module, shared by every layer (`llama_lora_dims`).

Slot discipline: every rank bucket has a fixed number of launch slots
(slot 0 is the null adapter, all zeros). Loading takes a free slot,
unloading frees it, LRU eviction of IDLE adapters (no live request refs)
makes room. Launches take the (pool, page-table, scales) tensors of
`flat_args()` and gather each slot's pages (`runtime.build_context`), so
a row's delta reads only its own slot's values: per-adapter outputs are
the same bits whether the adapter is served alone or mixed with others.

Per-adapter int8 (`load(..., quant="int8")`) stores the payload in a
separate int8 pool (its own allocator) with per-column fp32 scales in a
dense per-bucket host array; the gather dequantizes, and the two pools
SUM (an adapter lives in exactly one; the other gives the PAD page's
exact zeros).

Fault points (`utils/faults.py`): `serving.lora.load_fail` makes `load`
raise the typed AdapterLoadError; `serving.lora.evict_race` makes the
LRU evictor attempt a busy (live-ref) victim, which the refcount guard
refuses, counted in `lora_evict_refusals`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...utils import faults
from ..kv_cache import BlockAllocator, BlocksExhausted
from .adapter import (AdapterBusy, AdapterLoadError, AdapterNotLoaded,
                      LoRAAdapter)

__all__ = ["LoRALayout", "AdapterRegistry", "llama_lora_dims",
           "FAULT_LOAD", "FAULT_EVICT"]

FAULT_LOAD = faults.register_point("serving.lora.load_fail")
FAULT_EVICT = faults.register_point("serving.lora.evict_race")

LANES = 128          # payload lane width: one allocator "token" = 128 elems
_DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                    "gate_proj", "up_proj", "down_proj")


def llama_lora_dims(cfg, targets=_DEFAULT_TARGETS) -> Dict[str, Tuple[int, int]]:
    """{module: (in_dim, out_dim)} for a Llama-family config: the
    attention q/k/v/o and MLP gate/up/down projections."""
    h = cfg.hidden_size
    i = cfg.intermediate_size
    hd = h // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * hd
    all_dims = {"q_proj": (h, h), "k_proj": (h, kv), "v_proj": (h, kv),
                "o_proj": (h, h), "gate_proj": (h, i), "up_proj": (h, i),
                "down_proj": (i, h)}
    unknown = [t for t in targets if t not in all_dims]
    if unknown:
        raise ValueError(f"unknown LoRA targets {unknown}")
    return {t: all_dims[t] for t in targets}


class LoRALayout:
    """Static payload geometry: per rank bucket, module offsets into the
    flat paged payload, page counts and scale-row offsets. Shape-only;
    `signature()` names it."""

    def __init__(self, dims: Dict[str, Tuple[int, int]],
                 rank_buckets=(8,), slots: int = 8, page_size: int = 8):
        if slots < 2:
            raise ValueError("need >= 2 slots (slot 0 is the null adapter)")
        self.dims = dict(dims)
        self.targets = tuple(dims)
        self.rank_buckets = tuple(sorted(int(r) for r in rank_buckets))
        if len(set(self.rank_buckets)) != len(self.rank_buckets):
            raise ValueError("duplicate rank buckets")
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.page_elems = self.page_size * LANES
        # per-bucket payload layout: [A_m0 | B_m0 | A_m1 | B_m1 | ...]
        self.offsets: Dict[int, Dict[str, Tuple[int, int]]] = {}
        self.scale_offsets: Dict[int, Dict[str, Tuple[int, int]]] = {}
        self.payload_elems: Dict[int, int] = {}
        self.scale_elems: Dict[int, int] = {}
        self.pages_per_adapter: Dict[int, int] = {}
        for r in self.rank_buckets:
            off, soff = 0, 0
            offs, soffs = {}, {}
            for m, (di, do) in self.dims.items():
                offs[m] = (off, off + di * r)            # A span
                off += di * r
                offs[m + "#B"] = (off, off + r * do)     # B span
                off += r * do
                soffs[m] = (soff, soff + r)              # A scales (r,)
                soff += r
                soffs[m + "#B"] = (soff, soff + do)      # B scales (do,)
                soff += do
            self.offsets[r] = offs
            self.scale_offsets[r] = soffs
            self.payload_elems[r] = off
            self.scale_elems[r] = soff
            tokens = -(-off // LANES)
            self.pages_per_adapter[r] = -(-tokens // self.page_size)

    def bucket_for(self, rank: int) -> int:
        for r in self.rank_buckets:
            if rank <= r:
                return r
        raise AdapterLoadError(
            f"rank {rank} exceeds largest rank bucket "
            f"{self.rank_buckets[-1]}")

    def payload_tokens(self, bucket: int) -> int:
        return -(-self.payload_elems[bucket] // LANES)

    def global_slot(self, bucket: int, local: int) -> int:
        return self.rank_buckets.index(bucket) * self.slots + local

    def signature(self) -> tuple:
        """Static shape identity: adapters load and unload without ever
        changing it."""
        return ("lora", self.slots, self.rank_buckets, self.page_size,
                tuple(sorted((m, d) for m, d in self.dims.items())))


class _Entry:
    __slots__ = ("name", "rank", "bucket", "local", "quant", "seq",
                 "scaling", "refs", "last_use", "gen")

    def __init__(self, name, rank, bucket, local, quant, seq, scaling,
                 gen):
        self.name = name
        self.rank = rank
        self.bucket = bucket
        self.local = local
        self.quant = quant
        self.seq = seq
        self.scaling = float(scaling)
        self.refs = 0
        self.last_use = 0
        # monotonic LOAD generation, the radix-namespace version: a
        # reload under the same name gets a new one, so KV cached under
        # the old weights never matches a request served with the new
        self.gen = gen


class AdapterRegistry:
    """Adapter store for ONE engine: paged pools on `device` (the card
    unless told otherwise), per-bucket slot tables, LRU eviction of idle
    adapters, live-request refcounts. Every mutation is host bookkeeping
    plus an index write of the adapter's pages."""

    def __init__(self, dims: Dict[str, Tuple[int, int]], *,
                 rank_buckets=(8,), slots: int = 8, page_size: int = 8,
                 num_pages: Optional[int] = None,
                 num_quant_pages: Optional[int] = None,
                 counters: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.layout = LoRALayout(dims, rank_buckets=rank_buckets,
                                 slots=slots, page_size=page_size)
        lay = self.layout
        # default pool sizing: every slot of every bucket can be resident
        # at once (pressure/eviction tests pass smaller pools)
        full = sum((lay.slots - 1) * lay.pages_per_adapter[r]
                   for r in lay.rank_buckets) + 1
        self.num_pages = int(num_pages) if num_pages is not None else full
        self.num_quant_pages = (int(num_quant_pages)
                                if num_quant_pages is not None else full)
        self.allocator = BlockAllocator(self.num_pages, lay.page_size)
        self.quant_allocator = BlockAllocator(self.num_quant_pages,
                                              lay.page_size)
        # page 0 of each pool is the PAD page and stays all-zero: a
        # freed/never-loaded slot's table gathers exact zeros
        self.pool = torch.zeros((self.num_pages, lay.page_elems),
                                dtype=torch.float32, device=self.device)
        self.quant_pool = torch.zeros((self.num_quant_pages, lay.page_elems),
                                      dtype=torch.int8, device=self.device)
        # host per-bucket launch tables (tiny; copied to the device once
        # per launch by flat_args)
        self._tables_f = {r: np.zeros((lay.slots, lay.pages_per_adapter[r]),
                                      np.int32) for r in lay.rank_buckets}
        self._tables_q = {r: np.zeros((lay.slots, lay.pages_per_adapter[r]),
                                      np.int32) for r in lay.rank_buckets}
        self._scales = {r: np.zeros((lay.slots, lay.scale_elems[r]),
                                    np.float32) for r in lay.rank_buckets}
        self._scaling = {r: np.zeros((lay.slots,), np.float32)
                         for r in lay.rank_buckets}
        self._free_slots = {r: list(range(1, lay.slots))
                            for r in lay.rank_buckets}
        self.entries: Dict[str, _Entry] = {}
        self._tick = 0
        self._load_gen = 0
        self.counters = counters if counters is not None else {}

    @classmethod
    def for_model(cls, model, *, targets=_DEFAULT_TARGETS, **kw):
        return cls(llama_lora_dims(model.cfg, targets), **kw)

    # ------------------------------------------------------------ helpers
    def _count(self, key: str, n: int = 1):
        self.counters[key] = self.counters.get(key, 0) + n

    def bind_counters(self, counters: dict):
        """Re-home the registry counters into an engine's metrics
        counters dict (existing counts carry over)."""
        for k, v in self.counters.items():
            counters[k] = counters.get(k, 0) + v
        self.counters = counters

    def _touch(self, entry: _Entry):
        self._tick += 1
        entry.last_use = self._tick

    # ------------------------------------------------------------ queries
    def has(self, name: str) -> bool:
        return name in self.entries

    def adapter_names(self) -> List[str]:
        return sorted(self.entries)

    def _entry(self, name: str) -> _Entry:
        e = self.entries.get(name)
        if e is None:
            raise AdapterNotLoaded(f"adapter {name!r} is not loaded",
                                   adapter=name)
        return e

    def slot_of(self, name: str) -> int:
        """Global launch-slot id of a LOADED adapter (0 is the null
        adapter and never names a real one)."""
        e = self._entry(name)
        return self.layout.global_slot(e.bucket, e.local)

    def refs_of(self, name: str) -> int:
        e = self.entries.get(name)
        return 0 if e is None else e.refs

    def namespace_of(self, name: str):
        """(name, load generation): the radix-cache namespace of requests
        served under this adapter. The generation changes on every
        (re)load, so prefixes cached under replaced weights of the same
        name are never served again."""
        e = self._entry(name)
        return (e.name, e.gen)

    # ------------------------------------------------------------ refs
    def acquire(self, name: str):
        """Pin `name` for one live request: a pinned adapter is never
        evicted (slot and pages stay put until release)."""
        e = self._entry(name)
        e.refs += 1
        self._touch(e)

    def release(self, name: str):
        e = self.entries.get(name)
        if e is None:       # unloaded out from under a ref is a bug
            raise AdapterNotLoaded(f"release of unknown adapter {name!r}",
                                   adapter=name)
        if e.refs <= 0:
            raise RuntimeError(f"double release of adapter {name!r}")
        e.refs -= 1

    # ------------------------------------------------------------ load
    def load(self, adapter: LoRAAdapter, quant: Optional[str] = None):
        """Place `adapter` into a slot and pool pages; returns its global
        slot id. Evicts LRU IDLE adapters on slot/page pressure; raises
        the typed AdapterLoadError when nothing evictable remains (or the
        `serving.lora.load_fail` fault fires). Busy adapters are never
        eviction candidates."""
        if faults.fire(FAULT_LOAD) is not None:
            self._count("adapter_load_failures")
            raise AdapterLoadError(
                f"injected load failure for {adapter.name!r}",
                adapter=adapter.name)
        if quant not in (None, "int8"):
            raise ValueError(f"quant must be None or 'int8', got {quant!r}")
        if adapter.name in self.entries:
            self.unload(adapter.name)      # replace (refuses if busy)
        lay = self.layout
        for m, (a, b) in adapter.weights.items():
            if m not in lay.dims:
                raise AdapterLoadError(
                    f"adapter {adapter.name!r} targets {m!r} which is "
                    f"not in the registry layout {lay.targets}",
                    adapter=adapter.name)
            di, do = lay.dims[m]
            if a.shape[0] != di or b.shape[1] != do:
                raise AdapterLoadError(
                    f"adapter {adapter.name!r} module {m!r}: "
                    f"A {a.shape} / B {b.shape} vs layout ({di}, {do})",
                    adapter=adapter.name)
        bucket = lay.bucket_for(adapter.rank)
        if not self._free_slots[bucket] and \
                not self._evict_lru(bucket=bucket):
            self._count("adapter_load_failures")
            raise AdapterLoadError(
                f"no free slot in rank bucket {bucket} and nothing "
                f"idle to evict", adapter=adapter.name)
        alloc = self.quant_allocator if quant == "int8" else self.allocator
        tokens = lay.payload_tokens(bucket)
        while True:
            try:
                seq = alloc.alloc_sequence(tokens)
                break
            except BlocksExhausted:
                if not self._evict_lru(pool=alloc):
                    self._count("adapter_load_failures")
                    raise AdapterLoadError(
                        f"adapter pool exhausted loading "
                        f"{adapter.name!r} ({tokens} tokens needed) and "
                        f"nothing idle to evict", adapter=adapter.name)
        local = self._free_slots[bucket].pop(0)
        payload, scales = self._pack(adapter, bucket, quant)
        self._write_pages(seq.pages, payload, quant)
        table = self._tables_q if quant == "int8" else self._tables_f
        table[bucket][local, :len(seq.pages)] = seq.pages
        self._scales[bucket][local] = scales
        self._scaling[bucket][local] = adapter.scaling
        self._load_gen += 1
        entry = _Entry(adapter.name, adapter.rank, bucket, local, quant,
                       seq, adapter.scaling, self._load_gen)
        self.entries[adapter.name] = entry
        self._touch(entry)
        self._count("adapters_loaded")
        return lay.global_slot(bucket, local)

    def _pack(self, adapter: LoRAAdapter, bucket: int,
              quant: Optional[str]):
        """Flat payload (pages * page_elems,) and dense scale row of one
        adapter: A/B padded to the bucket rank (zero columns/rows, an
        exact no-op on the delta), int8 quantized per out-channel."""
        lay = self.layout
        r = bucket
        n_pages = lay.pages_per_adapter[r]
        dtype = np.int8 if quant == "int8" else np.float32
        payload = np.zeros((n_pages * lay.page_elems,), dtype)
        scales = np.zeros((lay.scale_elems[r],), np.float32)
        for m, (di, do) in lay.dims.items():
            got = adapter.weights.get(m)
            if got is None:
                continue                  # module not targeted: zeros
            a, b = got
            ap = np.zeros((di, r), np.float32)
            ap[:, :adapter.rank] = a
            bp = np.zeros((r, do), np.float32)
            bp[:adapter.rank, :] = b
            mats = {m: ap, m + "#B": bp}
            for key, w in mats.items():
                o0, o1 = lay.offsets[r][key]
                if quant == "int8":
                    wq, sc = _quantize_int8(w)
                    payload[o0:o1] = wq.ravel()
                    s0, s1 = lay.scale_offsets[r][key]
                    scales[s0:s1] = sc
                else:
                    payload[o0:o1] = w.ravel()
        return payload, scales

    def _write_pages(self, pages: List[int], payload: np.ndarray,
                     quant: Optional[str]):
        chunks = torch.from_numpy(
            payload.reshape(len(pages), self.layout.page_elems))
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        pool = self.quant_pool if quant == "int8" else self.pool
        pool[idx] = chunks.to(self.device)

    # ------------------------------------------------------------ unload
    def unload(self, name: str):
        """Explicit unload; refuses (typed AdapterBusy) while live
        requests still pin the adapter."""
        e = self._entry(name)
        if e.refs > 0:
            raise AdapterBusy(
                f"adapter {name!r} has {e.refs} live request refs",
                adapter=name, refs=e.refs)
        self._drop(e)
        self._count("adapters_unloaded")

    def _drop(self, e: _Entry):
        alloc = self.quant_allocator if e.quant == "int8" \
            else self.allocator
        alloc.free_sequence(e.seq)
        table = self._tables_q if e.quant == "int8" else self._tables_f
        table[e.bucket][e.local, :] = 0        # gather the PAD page
        self._scales[e.bucket][e.local, :] = 0.0
        self._scaling[e.bucket][e.local] = 0.0
        self._free_slots[e.bucket].append(e.local)
        self._free_slots[e.bucket].sort()
        del self.entries[e.name]

    def _evict_lru(self, bucket: Optional[int] = None, pool=None) -> bool:
        """Evict ONE least-recently-used IDLE adapter (optionally only
        from one bucket or one pool's allocator). The
        `serving.lora.evict_race` fault makes it attempt a BUSY victim
        first: the refcount guard refuses it (counted)."""
        if faults.fire(FAULT_EVICT) is not None:
            if any(e.refs > 0 for e in self.entries.values()):
                self._count("lora_evict_refusals")
        cands = [e for e in self.entries.values() if e.refs == 0]
        if bucket is not None:
            cands = [e for e in cands if e.bucket == bucket]
        if pool is not None:
            want_q = pool is self.quant_allocator
            cands = [e for e in cands if (e.quant == "int8") == want_q]
        if not cands:
            return False
        victim = min(cands, key=lambda e: e.last_use)
        self._drop(victim)
        self._count("adapters_evicted")
        return True

    # ------------------------------------------------------------ launch
    def flat_args(self) -> tuple:
        """One launch's inputs, in the reference's order: (pool_f32,
        pool_int8) and per rank bucket (table_f32, table_int8, scales,
        scaling), all on the registry's device (the host tables are
        copied here). Shapes are layout-static; only values change
        across load/unload."""
        out = [self.pool, self.quant_pool]
        for r in self.layout.rank_buckets:
            for host in (self._tables_f[r], self._tables_q[r],
                         self._scales[r], self._scaling[r]):
                out.append(torch.tensor(host, device=self.device))
        return tuple(out)

    def signature(self) -> tuple:
        return self.layout.signature() + (self.num_pages,
                                          self.num_quant_pages)

    def check_invariants(self):
        self.allocator.check_invariants()
        self.quant_allocator.check_invariants()
        for e in self.entries.values():
            assert e.refs >= 0
            assert e.local not in self._free_slots[e.bucket]


def _quantize_int8(w: np.ndarray):
    """(in, out) fp32 -> (int8, per-out-channel fp32 scale): the
    reference's numpy copy of weight_only_int8 quantization."""
    absmax = np.maximum(np.abs(w).max(axis=0), 1e-10)
    scale = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale
