"""Paged KV-cache block management for the serving engine (port of
`paddle_tpu/serving/kv_cache.py`), and the host spill tier's page codec
and page store.

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

import struct
import zlib
from collections import deque
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils import faults

__all__ = ["BlockAllocator", "KVSequence", "BlocksExhausted", "PAD_PAGE",
           "HostPageStore", "HostPagesExhausted", "HostPageError",
           "HostPageCorrupt", "HostPageSlow", "HostPageLost",
           "encode_page_payload", "decode_page_payload"]

PAD_PAGE = 0

# An armed spec makes _alloc_page raise BlocksExhausted as if the pool
# were dry — the scheduler must degrade through its reclamation ladder
# (radix LRU eviction, then preempt-by-eviction), never crash or leak.
FAULT_ALLOC = faults.register_point("serving.kv.alloc_page")

# The host spill tier's read path. Each degrades a promotion into
# recompute from the radix prefix: the engine's outputs stay the same in
# all three cases, only the cached-token accounting changes.
FAULT_HOST_CORRUPT = faults.register_point("host_spill.corrupt")
FAULT_HOST_SLOW = faults.register_point("host_spill.slow")
FAULT_HOST_LOST = faults.register_point("host_spill.lost")


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


# ---------------------------------------------------------------------------
# Host spill tier: host-RAM pages under the radix cache.
# ---------------------------------------------------------------------------

class HostPagesExhausted(Exception):
    """No free host page — the radix cache falls back to dropping."""


class HostPageError(Exception):
    """A host page read failed; promotion degrades to recompute."""


class HostPageCorrupt(HostPageError):
    """Payload failed its CRC — the stored bytes are untrustworthy."""


class HostPageSlow(HostPageError):
    """The host read missed its deadline; the page itself is intact."""


class HostPageLost(HostPageError):
    """The backing host buffer is gone (e.g. reclaimed by the OS)."""


# Page-payload wire format, the reference's byte for byte. One payload
# carries ONE radix page's KV bytes across every layer (k row, v row per
# layer, then the int8 scale rows when the cache is quantized); it is
# both the demote/promote unit and the unit a sibling engine adopts, so
# the header carries a CRC32 of the body and decode refuses anything
# that does not check out. Each array is a record: dtype name (u8 length
# + ascii), ndim (u8), shape (u32 each), byte count (u32), raw bytes.
# bfloat16 travels as its raw 2-byte pattern under the name "bfloat16"
# (numpy has no bf16; decode rebuilds it as a torch tensor).
PAYLOAD_MAGIC = b"KVPG"
PAYLOAD_VERSION = 1
_PAYLOAD_HEADER = struct.Struct(">4sBHI")   # magic, version, n_arrays, crc


def record_head(dtype_name: str, shape, nbytes: int) -> bytes:
    """The bytes that precede one array's raw bytes in a payload body."""
    dt = dtype_name.encode("ascii")
    return (struct.pack(">B", len(dt)) + dt
            + struct.pack(f">B{len(shape)}I", len(shape), *shape)
            + struct.pack(">I", nbytes))


def pack_page_payload(heads, raws) -> bytes:
    """A payload from per-array record heads (`record_head`) and raw
    byte buffers (anything `bytes.join` takes), in order."""
    parts: List = []
    for head, raw in zip(heads, raws):
        parts.append(head)
        parts.append(raw)
    body = b"".join(parts)
    return _PAYLOAD_HEADER.pack(PAYLOAD_MAGIC, PAYLOAD_VERSION, len(heads),
                                zlib.crc32(body) & 0xFFFFFFFF) + body


def _array_record(a):
    """(dtype name, shape, raw bytes) of a numpy array or torch tensor."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return str(t.dtype).replace("torch.", ""), tuple(t.shape), raw
    a = np.ascontiguousarray(a)
    return str(a.dtype), a.shape, a.tobytes()


def encode_page_payload(arrays) -> bytes:
    """Serialize a list of arrays (numpy arrays or torch tensors: one
    page's per-layer rows) into a self-describing CRC-protected byte
    string."""
    recs = [_array_record(a) for a in arrays]
    return pack_page_payload(
        [record_head(name, shape, len(memoryview(raw).cast("B")))
         for name, shape, raw in recs],
        [raw for _, _, raw in recs])


def decode_page_records(buf) -> List[Tuple[str, tuple, memoryview]]:
    """Check a payload's header and CRC and split its body into
    (dtype name, shape, raw bytes) records, the raw bytes a view into
    `buf`. Raises HostPageCorrupt on any structural or CRC mismatch — a
    corrupt page must never reach the device caches."""
    buf = memoryview(buf).cast("B")
    if len(buf) < _PAYLOAD_HEADER.size:
        raise HostPageCorrupt("payload truncated before header")
    magic, version, n_arrays, crc = _PAYLOAD_HEADER.unpack_from(buf)
    if magic != PAYLOAD_MAGIC or version != PAYLOAD_VERSION:
        raise HostPageCorrupt(f"bad payload header {magic!r} v{version}")
    body = buf[_PAYLOAD_HEADER.size:]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise HostPageCorrupt("payload CRC mismatch")
    records = []
    off = 0
    try:
        for _ in range(n_arrays):
            (dlen,) = struct.unpack_from(">B", body, off)
            off += 1
            name = bytes(body[off:off + dlen]).decode("ascii")
            off += dlen
            (ndim,) = struct.unpack_from(">B", body, off)
            off += 1
            shape = struct.unpack_from(f">{ndim}I", body, off)
            off += 4 * ndim
            (nbytes,) = struct.unpack_from(">I", body, off)
            off += 4
            raw = body[off:off + nbytes]
            off += nbytes
            if len(raw) != nbytes:
                raise HostPageCorrupt("payload truncated inside array")
            records.append((name, tuple(shape), raw))
    except (struct.error, UnicodeDecodeError) as e:
        raise HostPageCorrupt(f"payload structure invalid: {e}") from None
    if off != len(body):
        raise HostPageCorrupt(f"{len(body) - off} trailing payload bytes")
    return records


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a payload record names; HostPageCorrupt for a
    name that is not one."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise HostPageCorrupt(f"payload names unknown dtype {name!r}")
    return dt


def decode_page_payload(buf) -> List[torch.Tensor]:
    """Inverse of encode_page_payload: the payload's arrays as CPU torch
    tensors (bfloat16 included). Raises HostPageCorrupt on any structural
    or CRC mismatch."""
    out = []
    for name, shape, raw in decode_page_records(buf):
        dt = _torch_dtype(name)
        itemsize = torch.empty((), dtype=dt).element_size()
        if len(raw) != int(np.prod(shape, dtype=np.int64)) * itemsize:
            raise HostPageCorrupt(f"record of {len(raw)} bytes does not "
                                  f"hold a {name} array of shape {shape}")
        flat = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
        out.append(flat.view(dt).reshape(shape))
    return out


class HostPageStore:
    """Ref-counted host-RAM page pool: the spill tier's analogue of
    BlockAllocator, holding encoded page payloads instead of device
    rows. Ids are dense ints over `num_pages` slots with the same
    free-list/refcount discipline (no pad page — host ids never reach
    a device block table).

    The read path (`get`) is where the host_spill fault points live:
    `lost` fires before the lookup (the buffer is gone — the store
    forgets it too, so recovery matches reality), `slow` models a
    deadline miss on an intact page, and `corrupt` flips a body byte so
    that the codec's CRC check — not the injection site — detects it.
    """

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError("host spill pool needs >= 1 page")
        self.num_pages = num_pages
        self._free = deque(range(num_pages))
        self._refs: Dict[int, int] = {}
        self._payloads: Dict[int, bytes] = {}
        self.bytes_stored = 0

    # ---- page ops --------------------------------------------------------
    def put(self, payload: bytes) -> int:
        if not self._free:
            raise HostPagesExhausted(
                f"all {self.num_pages} host pages in use")
        hid = self._free.popleft()
        self._refs[hid] = 1
        self._payloads[hid] = bytes(payload)
        self.bytes_stored += len(payload)
        return hid

    def get(self, hid: int) -> bytes:
        if faults.fire(FAULT_HOST_LOST) is not None:
            self._forget(hid)
            raise HostPageLost(f"host page {hid} backing buffer gone")
        if self._refs.get(hid, 0) <= 0:
            raise KeyError(f"host page {hid} not held")
        if faults.fire(FAULT_HOST_SLOW) is not None:
            raise HostPageSlow(f"host page {hid} read missed deadline")
        payload = self._payloads[hid]
        if faults.fire(FAULT_HOST_CORRUPT) is not None:
            payload = payload[:-1] + bytes([payload[-1] ^ 0xFF])
        return payload

    def _forget(self, hid: int):
        """Lost-page recovery: drop the slot whatever its refcount (the
        holder's decref path is bypassed — the caller drops its radix
        node instead)."""
        if hid in self._refs:
            del self._refs[hid]
            self.bytes_stored -= len(self._payloads.pop(hid))
            self._free.append(hid)

    def incref(self, hid: int):
        self._refs[hid] += 1

    def decref(self, hid: int):
        r = self._refs.get(hid)
        if r is None or r <= 0:
            raise RuntimeError(f"double free of host page {hid}")
        if r == 1:
            del self._refs[hid]
            self.bytes_stored -= len(self._payloads.pop(hid))
            self._free.append(hid)
        else:
            self._refs[hid] = r - 1

    def holds(self, hid: int) -> bool:
        """True iff the store still holds `hid` (a lost-fault recovery
        may have forgotten it out from under its holders)."""
        return self._refs.get(hid, 0) > 0

    # ---- occupancy -------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_pages - len(self._free)

    def occupancy(self) -> float:
        return self.num_used / float(self.num_pages)

    def check_invariants(self):
        free = set(self._free)
        held = set(self._refs)
        assert not (free & held), f"host pages free AND held: {free & held}"
        assert all(r > 0 for r in self._refs.values())
        assert held == set(self._payloads), "payloads out of sync with refs"
        assert len(free) + len(held) == self.num_pages
        assert self.bytes_stored == \
            sum(len(p) for p in self._payloads.values())
