"""The port's host spill tier against the reference's on the CPU.

Codec: the port's page payloads are the reference's byte for byte for
fp32, bf16 (the reference's through ml_dtypes) and int8 + fp32 scale
records, each side decodes the other's, and a corrupt payload is refused.
`HostPageStore` and the radix spill rungs (demote, drop when the host
pool is full, budgeted promotion, the per-fault policy, the re-adoption
of a host span by a donor) run the same operations as the reference's,
each over a device-free fake bridge, and end with the same page ids,
host ids and counters.

Engine: the reference test's 16-request shared-prefix workload through a
device pool too small for its working set (the reference test's pinned
single buckets, greedy at fp32, same seeded weights through
models/convert.py) gives the reference engine's tokens and spill
counters with the spill tier on, plain and with int8 KV; on equals off,
at K=1 and at K=4; each host_spill fault degrades to recompute. The
prefix export / adopt of the reference test runs on both sides, and the
port adopts the reference's exported payloads.

The reference engine drains once per variant, in module fixtures.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import kv_cache as ref_kv
from paddle_tpu.serving.radix_cache import RadixCache as JaxRadix
from paddle_tpu.utils import faults as ref_faults
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.kv_cache import (
    BlockAllocator, BlocksExhausted, HostPageCorrupt, HostPageLost,
    HostPagesExhausted, HostPageSlow, HostPageStore, decode_page_payload,
    encode_page_payload)
from paddle_tpu_torch.serving.radix_cache import RadixCache
from paddle_tpu_torch.utils import faults

from _torch_parity import model_pair

# the reference test's grid: a device pool too small for the working set
# (16 pages against a shared 3-page prefix + 8 distinct 3-page tails +
# decode growth), one bucket per axis so that spill on and off run the
# same launch shapes
SPILL_KW = dict(num_pages=16, page_size=8, token_budget=64,
                batch_buckets=[4], prefill_buckets=[64],
                pages_buckets=[8], temperature=0.0, max_batch_size=4)
HOST_PAGES = 64
SPILL_COUNTERS = ("kv_pages_demoted", "kv_pages_promoted",
                  "host_prefix_hits", "host_pages_dropped",
                  "radix_evict_demoted", "radix_evict_dropped",
                  "cached_tokens_served", "prefill_tokens", "prefix_hits",
                  "host_spill_corrupt", "host_spill_slow",
                  "host_spill_lost")


# ---------------------------------------------------------------- codec
def _page_arrays(seed=0):
    """One int8 page's records (values, then scales) and a bf16 and an
    fp32 array, as numpy (bf16 through ml_dtypes)."""
    rng = np.random.RandomState(seed)
    return {
        "float32": [rng.randn(1, 8, 16).astype(np.float32),
                    rng.randn(1, 8, 16).astype(np.float32)],
        "bfloat16": [rng.randn(1, 8, 16).astype(ml_dtypes.bfloat16),
                     rng.randn(2, 8, 64).astype(ml_dtypes.bfloat16)],
        "int8": [rng.randint(-128, 128, (1, 8, 16)).astype(np.int8),
                 rng.randint(-128, 128, (1, 8, 16)).astype(np.int8),
                 rng.rand(1, 8).astype(np.float32),
                 rng.rand(1, 8).astype(np.float32)],
    }


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_payload_bytes_equal_the_reference(kind):
    """Same arrays, same payload bytes — from numpy arrays and from torch
    tensors; each side decodes the other's to the same bytes."""
    arrays = _page_arrays()[kind]
    ref = ref_kv.encode_page_payload(arrays)
    assert encode_page_payload([_as_torch(a) for a in arrays]) == ref
    if kind != "bfloat16":         # numpy has no bf16 of its own
        assert encode_page_payload(arrays) == ref
    for a, t in zip(arrays, decode_page_payload(ref)):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype) == "torch." + str(a.dtype)
        assert t.view(torch.uint8).numpy().tobytes() == a.tobytes()
    back = ref_kv.decode_page_payload(
        encode_page_payload([_as_torch(a) for a in arrays]))
    assert [b.tobytes() for b in back] == [a.tobytes() for a in arrays]


def test_payload_codec_rejects_corruption():
    buf = encode_page_payload([torch.arange(32, dtype=torch.float32)])
    with pytest.raises(HostPageCorrupt):
        decode_page_payload(buf[:-1] + bytes([buf[-1] ^ 0xFF]))
    with pytest.raises(HostPageCorrupt):
        decode_page_payload(buf[:10])               # truncated header
    with pytest.raises(HostPageCorrupt):
        decode_page_payload(b"NOPE" + buf[4:])      # bad magic
    with pytest.raises(HostPageCorrupt):
        decode_page_payload(buf + b"\0")            # CRC over the tail
    # a record naming no dtype the codec knows, under a valid CRC
    bad = ref_kv.encode_page_payload([np.zeros(4, np.complex64)])
    with pytest.raises(HostPageCorrupt):
        decode_page_payload(bad.replace(b"complex64", b"complexXY"))


# ----------------------------------------------------------- host store
def _store_trace(store_cls, kv, flt):
    """One sequence of store operations and faults; returns what each
    step saw."""
    out = []
    st = store_cls(3)
    a = st.put(b"aaaa")
    b = st.put(b"bb")
    out += [a, b, st.num_used, st.num_free, st.bytes_stored, st.get(a)]
    st.incref(a)
    st.decref(a)
    out.append(st.holds(a))
    st.decref(a)
    out += [st.holds(a), st.num_free]
    for call in (lambda: st.decref(a), lambda: st.get(a)):
        try:
            call()
        except (RuntimeError, KeyError) as e:
            out.append(type(e).__name__)
    out += [st.put(b"c"), st.put(b"d")]
    try:
        st.put(b"e")
    except kv.HostPagesExhausted:
        out.append("exhausted")
    with flt.injected("host_spill.slow", payload=True):
        try:
            st.get(b)
        except kv.HostPageSlow:
            out.append("slow")
    out.append(st.get(b))
    with flt.injected("host_spill.corrupt", payload=True):
        out.append(st.get(b))
    out.append(st.get(b))
    with flt.injected("host_spill.lost", payload=True):
        try:
            st.get(b)
        except kv.HostPageLost:
            out.append("lost")
    out += [st.holds(b), st.num_free, st.bytes_stored, list(st._free)]
    st.check_invariants()
    return out


def test_host_page_store_equals_the_reference():
    import paddle_tpu_torch.serving.kv_cache as port_kv
    got = _store_trace(HostPageStore, port_kv, faults)
    want = _store_trace(ref_kv.HostPageStore, ref_kv, ref_faults)
    assert got == want
    assert "slow" in got and "lost" in got and "exhausted" in got


# -------------------------------------------------------- radix + bridge
class _FakeBridge:
    """Device-free RadixCache.spill (the reference test's): payloads are
    marker bytes, the fault points fire in the store's get."""

    def __init__(self, allocator, store):
        self.alloc = allocator
        self.store = store

    def host_free(self):
        return self.store.num_free

    def holds(self, hid):
        return self.store.holds(hid)

    def demote(self, pids):
        hids = []
        try:
            for pid in pids:
                hids.append(self.store.put(b"page:%d" % pid))
        except (HostPagesExhausted, ref_kv.HostPagesExhausted):
            for hid in hids:
                self.store.decref(hid)
            return None
        return hids

    def promote(self, hids):
        for hid in hids:
            self.store.get(hid)
        try:
            return self.alloc._alloc_pages(len(hids))
        except (BlocksExhausted, ref_kv.BlocksExhausted):
            return None

    def release(self, hids):
        for hid in hids:
            if self.store.holds(hid):
                self.store.decref(hid)


SIDES = {
    "port": (BlockAllocator, RadixCache, HostPageStore, faults),
    "reference": (ref_kv.BlockAllocator, JaxRadix, ref_kv.HostPageStore,
                  ref_faults),
}


def _tree(side, num_pages, host_pages):
    alloc_cls, radix_cls, store_cls, _ = SIDES[side]
    alloc = alloc_cls(num_pages=num_pages, page_size=8)
    cache = radix_cls(alloc)
    bridge = _FakeBridge(alloc, store_cls(host_pages))
    cache.set_spill(bridge)
    return alloc, cache, bridge


def _donate(alloc, cache, tokens):
    seq = alloc.alloc_sequence_with_prefix(len(tokens), [])
    cache.insert(tokens, list(seq.pages))
    alloc.free_sequence(seq)


def _counters(alloc, cache, bridge):
    return {k: getattr(cache, k) for k in (
        "num_evict_demoted", "num_evict_dropped", "num_demoted_pages",
        "num_promoted_pages", "num_host_hits", "num_host_dropped_pages",
        "num_evicted_pages", "num_cached_pages", "num_host_pages",
        "num_nodes")} | {"alloc_used": alloc.num_used,
                         "host_used": bridge.store.num_used,
                         "free": list(alloc._free)}


def _rungs(side):
    """Demote, a budget too small, promotion, a drop when the host pool
    is full, two trees sharing a prefix, re-adoption by a donor."""
    seen = []
    alloc, cache, bridge = _tree(side, 17, 6)
    _donate(alloc, cache, tuple(range(32)))
    _donate(alloc, cache, tuple(range(16)) + tuple(range(100, 116)))
    seen.append(cache.evict(3))
    seen.append(_counters(alloc, cache, bridge))
    seen.append(cache.match(tuple(range(32)), promote_budget=8))
    seen.append(cache.match(tuple(range(32)), promote_budget=32))
    seen.append(cache.match_len(tuple(range(16)) + tuple(range(100, 116))))
    seen.append(cache.evict(16))            # host pool of 6 fills: drops
    seen.append(_counters(alloc, cache, bridge))
    seen.append(cache.clear())
    seen.append(_counters(alloc, cache, bridge))
    cache.check_invariants()
    # a donor that recomputed a host-resident span: the tree adopts its
    # device pages and releases the host copies, no promotion
    alloc, cache, bridge = _tree(side, 17, 8)
    _donate(alloc, cache, tuple(range(200, 232)))
    seen.append(cache.evict(4))
    seq = alloc.alloc_sequence_with_prefix(32, [])
    seen.append(cache.insert(tuple(range(200, 232)), list(seq.pages)))
    alloc.free_sequence(seq)
    seen.append(_counters(alloc, cache, bridge))
    cache.check_invariants()
    # a full host pool: LRU host leaves drop to make room, and a node
    # larger than the whole pool takes the drop rung
    alloc, cache, bridge = _tree(side, 17, 4)
    for toks, need in ((tuple(range(32)), 4), (tuple(range(300, 316)), 2),
                       (tuple(range(400, 440)), 5)):
        _donate(alloc, cache, toks)
        seen.append(cache.evict(need))
        seen.append(_counters(alloc, cache, bridge))
    cache.check_invariants()
    return seen


def test_radix_rungs_equal_the_reference():
    got, want = _rungs("port"), _rungs("reference")
    assert got == want
    assert want[1]["num_evict_demoted"] == 2
    assert want[10] == 4 and want[11]["num_host_pages"] == 0   # re-adopted
    assert want[-1]["num_evict_dropped"] == 1
    assert want[-1]["num_host_dropped_pages"] == 6


def _fault_policy(side):
    flt = SIDES[side][3]
    seen = []
    for point in ("host_spill.slow", "host_spill.lost", "host_spill.corrupt"):
        alloc, cache, bridge = _tree(side, 9, 8)
        _donate(alloc, cache, tuple(range(32)))
        cache.evict(4)
        with flt.injected(point, payload=True):
            seen.append(cache.match(tuple(range(32))))
        seen.append(_counters(alloc, cache, bridge))
        seen.append(cache.match(tuple(range(32))))
        seen.append(_counters(alloc, cache, bridge))
        cache.check_invariants()
    flt.clear()
    return seen


def test_radix_fault_policy_equals_the_reference():
    """slow keeps the node (a later match promotes it); lost drops the
    node and its subtree; the fake bridge never decodes, so corrupt
    bytes promote — as in the reference."""
    got, want = _fault_policy("port"), _fault_policy("reference")
    assert got == want
    assert want[2][1] == 32 and want[4][1] == 0 and want[5]["num_nodes"] == 0


# --------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def models():
    return model_pair(seed=0)


def _workload():
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 128, (24,)).tolist()      # 3 full pages
    tails = [rng.randint(0, 128, (24,)).tolist() for _ in range(8)]
    return shared, tails


def _spill_run(eng):
    """16 requests (8 shared-prefix prompts, two passes — pass 2 is where
    demoted tails promote back), one at a time so the tiny pool evicts
    between them. Returns (tokens per (pass, tail), metrics snapshot);
    both pools reclaim fully after reset_prefix_cache."""
    shared, tails = _workload()
    out = {}
    for p in range(2):
        for i, t in enumerate(tails):
            rid = eng.add_request(shared + t, max_new_tokens=4)
            out[(p, i)] = eng.run()[rid]
    snap = eng.metrics.snapshot()
    eng.radix.check_invariants()
    eng.allocator.check_invariants()
    if eng.host_store is not None:
        eng.host_store.check_invariants()
    assert eng.allocator.num_used == eng.radix.num_cached_pages
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0
    if eng.host_store is not None:
        assert eng.host_store.num_used == 0
    return out, snap


VARIANTS = {"plain": {}, "int8_kv": {"kv_dtype": "int8"}}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def reference_spill(request, models):
    extra = VARIANTS[request.param]
    eng = JaxEngine(models[0], host_spill_pages=HOST_PAGES,
                    **SPILL_KW, **extra)
    out, snap = _spill_run(eng)
    eng.shutdown()
    return request.param, out, snap


def _port(models, host_pages, **extra):
    return ServingEngine(models[1], device="cpu",
                         host_spill_pages=host_pages,
                         **{**SPILL_KW, **extra})


def test_spill_tokens_and_counters_equal_the_reference(models,
                                                       reference_spill):
    """Spill on: the reference engine's tokens and spill counters; spill
    off: the same tokens, every eviction a drop, and cached + prefilled
    tokens conserved."""
    variant, ref_out, ref_snap = reference_spill
    out_on, snap_on = _spill_run(_port(models, HOST_PAGES,
                                       **VARIANTS[variant]))
    assert out_on == ref_out
    assert {k: snap_on[k] for k in SPILL_COUNTERS} == \
        {k: ref_snap[k] for k in SPILL_COUNTERS}
    assert snap_on["kv_pages_demoted"] > 0
    assert snap_on["kv_pages_promoted"] > 0
    assert snap_on["host_prefix_hits"] > 0
    assert snap_on["radix_evict_dropped"] == 0
    out_off, snap_off = _spill_run(_port(models, 0, **VARIANTS[variant]))
    assert out_off == out_on
    assert snap_off["radix_evict_dropped"] > 0
    assert snap_off["radix_evict_demoted"] == 0
    assert snap_on["cached_tokens_served"] > snap_off["cached_tokens_served"]
    assert (snap_on["cached_tokens_served"] + snap_on["prefill_tokens"]
            == snap_off["cached_tokens_served"] + snap_off["prefill_tokens"])
    assert snap_on["host_pool_pages"] == HOST_PAGES
    assert snap_on["host_page_bytes"] == ref_snap["host_page_bytes"]


def test_spill_on_equals_off_at_k4(models):
    multi = dict(decode_steps=4, multi_buckets=[4])
    out_off, _ = _spill_run(_port(models, 0, **multi))
    out_on, snap = _spill_run(_port(models, HOST_PAGES, **multi))
    assert out_on == out_off and snap["kv_pages_promoted"] > 0


@pytest.mark.parametrize("point", ["host_spill.corrupt", "host_spill.slow",
                                   "host_spill.lost"])
def test_spill_faults_degrade_to_recompute(models, point):
    out_base, _ = _spill_run(_port(models, 0))
    with faults.injected(point, payload=True):
        out, snap = _spill_run(_port(models, HOST_PAGES))
    faults.clear()
    assert out == out_base
    assert snap[point.replace("host_spill.", "host_spill_")] == 1


def test_promoted_pages_are_the_demoted_bytes(models):
    """A demote -> promote round trip through the engine's batched page
    I/O moves every record bitwise, int8 scale rows included."""
    for extra in VARIANTS.values():
        eng = _port(models, 8, **extra)
        gen = torch.Generator().manual_seed(3)
        for t in eng._page_tensors:
            t.copy_(torch.randint(-100, 100, t.shape, generator=gen)
                    .to(t.dtype))
        before = [t[[3, 5, 9]].clone() for t in eng._page_tensors]
        payloads = eng._gather_page_payloads([3, 5, 9])
        assert all(len(p) == len(payloads[0]) for p in payloads)
        for t in eng._page_tensors:
            t.zero_()
        eng._scatter_page_records([3, 5, 9],
                                  [eng._page_records(p) for p in payloads])
        for b, t in zip(before, eng._page_tensors):
            assert torch.equal(t[[3, 5, 9]], b)
        # each payload is what the reference codec makes of the page
        recs = [t[5] for t in eng._page_tensors]
        assert payloads[1] == encode_page_payload(recs)


def test_spill_construction_rules(models):
    with pytest.raises(ValueError):
        _port(models, -1)
    with pytest.raises(ValueError):
        ServingEngine(models[1], device="cpu", host_spill_pages=8,
                      enable_prefix_cache=False, **SPILL_KW)


# ------------------------------------------------------ prefix transfer
def _export_adopt(make, prompt):
    """The reference test's export / adopt / corrupt adopt on engines
    from `make()`; returns the counts, the tokens and the payloads."""
    donor = make()
    rid = donor.add_request(prompt, max_new_tokens=4)
    base = donor.run()[rid]
    n, payloads = donor.export_prefix(prompt)
    sibling = make()
    adopted = sibling.adopt_prefix(prompt[:n], payloads)
    sibling.radix.check_invariants()
    used = sibling.allocator.num_used
    rid2 = sibling.add_request(prompt, max_new_tokens=4)
    out = sibling.run()[rid2]
    c = sibling.metrics.counters
    third = make()
    bad = payloads[0][:-1] + bytes([payloads[0][-1] ^ 0xFF])
    res = {"n": n, "pages": len(payloads), "adopted": adopted,
           "used_after_adopt": used,
           "exported": donor.metrics.counters["kv_pages_exported"],
           "counted_adopted": c["kv_pages_adopted"],
           "prefix_hits": c["prefix_hits"],
           "cached": c["cached_tokens_served"],
           "bad_adopt": third.adopt_prefix(prompt[:n], [bad] + payloads[1:]),
           "bad_counted": third.metrics.counters["host_spill_corrupt"],
           "third_used": third.allocator.num_used}
    for eng in (donor, sibling, third):
        eng.reset_prefix_cache()
        eng.shutdown()
    return res, base, out, payloads


def test_export_adopt_prefix_equals_the_reference(models):
    shared, tails = _workload()
    prompt = shared + tails[0]
    kw = dict(SPILL_KW, num_pages=32)
    ref, ref_base, ref_out, ref_payloads = _export_adopt(
        lambda: JaxEngine(models[0], **kw), prompt)
    got, base, out, payloads = _export_adopt(
        lambda: ServingEngine(models[1], device="cpu", **kw), prompt)
    assert got == ref
    assert ref["adopted"] == ref["pages"] == 6 and ref["bad_adopt"] == 0
    assert base == out == ref_base == ref_out
    assert [len(p) for p in payloads] == [len(p) for p in ref_payloads]
    # the reference's payloads land in a port engine and serve its prompt
    eng = ServingEngine(models[1], device="cpu", **kw)
    assert eng.adopt_prefix(prompt[:ref["n"]], ref_payloads) == 6
    rid = eng.add_request(prompt, max_new_tokens=4)
    assert eng.run()[rid] == ref_base
    assert eng.metrics.counters["prefix_hits"] == 1
    # a payload of another geometry (int8 KV) is refused, nothing held
    other = ServingEngine(models[1], device="cpu", kv_dtype="int8", **kw)
    assert other.adopt_prefix(prompt[:ref["n"]], payloads) == 0
    assert other.metrics.counters["host_spill_corrupt"] == 1
    assert other.allocator.num_used == 0
