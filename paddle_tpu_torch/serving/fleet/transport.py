"""Framed, versioned mailbox transport for the cross-process fleet (the
port's own copy of `paddle_tpu/serving/fleet/transport.py`).

The wire is a `torch.distributed.TCPStore`: the supervisor binds it,
every worker connects as a client, and a **Channel** between two peers
is a pair of sequence-numbered key streams inside it —

    ptw/<session>/<src>><dst>/head   monotonically allocated via add()
    ptw/<session>/<src>><dst>/<seq>  one framed message per key

Ordered, at-most-once-per-seq delivery falls out of the store: send()
allocates the next seq with an atomic add and writes the frame; recv()
polls its next expected seq (capped exponential backoff between polls,
per-call timeout), deletes the key it consumed, and advances. Nothing
here blocks without a deadline: `TCPStore.get` waits for a missing key
until the store's timeout, so a read tests the key with `check` first.

**Framing.** Every message is one frame:

    MAGIC "PTW1" | u8 version | u32 body_len | u32 crc32(body) | body

with a JSON body (the envelope: type/src/dst/seq/payload) — the
reference's bytes for the same dict. A frame that fails the magic,
version, length or checksum raises a typed `TransportError`:
version/framing mismatches are FATAL (a rolling restart mixing
incompatible builds must fail loud), connect/timeout losses are
TRANSIENT. `failure_class` is what the supervisor's `classify_failure`
consults first.

**Fault points:**

* `transport.drop`      — recv reads a frame and DISCARDS it, as if the
  network ate the message (recovery = the heartbeat snapshot path);
* `transport.duplicate` — recv delivers the same message twice (the
  exactly-once token funnel must dedup);
* `transport.stall`     — the channel wedges for this call: recv reads
  nothing even when messages are pending, send silently writes nothing
  (returns -1). Armed with times=-1 it models a permanently wedged
  endpoint: no heartbeats out, no commands in, until the supervisor's
  hard-stall ladder kills and adopts. Finite specs consume firings at
  BOTH sites.

The store object is injected (duck-typed set/get/check/add/delete_key),
so tests may hand a Channel any store with those calls.
"""
from __future__ import annotations

import base64
import datetime
import json
import socket
import struct
import time
import zlib
from typing import Dict, List, Optional

from ...utils import faults

__all__ = ["TransportError", "Channel", "encode_frame", "decode_frame",
           "bind_store", "connect_store", "free_port",
           "TRANSPORT_VERSION", "FRAME_CAP", "chunk_payloads",
           "join_payloads", "FAULT_DROP", "FAULT_DUPLICATE",
           "FAULT_STALL"]

MAGIC = b"PTW1"
TRANSPORT_VERSION = 1
_HEADER = struct.Struct(">4sBII")          # magic, version, len, crc32

# Largest JSON body one frame may carry. A KV page payload (num_layers
# x the page's K and V, megabytes at real geometry) is split across
# frames below this, so one giant value never stalls every other
# mailbox key behind it.
FRAME_CAP = 256 * 1024

# sentinel: a seq was consumed without yielding a message
_CONSUMED = object()

# Fired at the RECV site (and stall also at send), so drop/duplicate/
# stall model the network without corrupting the seq stream.
FAULT_DROP = faults.register_point("transport.drop")
FAULT_DUPLICATE = faults.register_point("transport.duplicate")
FAULT_STALL = faults.register_point("transport.stall")


class TransportError(RuntimeError):
    """A transport failure with an explicit supervisor classification:
    `failure_class` is "transient" (connect/timeout/store loss — retry
    and backoff are sane) or "fatal" (framing/version mismatch —
    retrying re-reads the same garbage)."""

    def __init__(self, msg: str, failure_class: str = "transient"):
        super().__init__(msg)
        self.failure_class = failure_class


def encode_frame(msg: dict) -> bytes:
    body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    return _HEADER.pack(MAGIC, TRANSPORT_VERSION, len(body),
                        zlib.crc32(body)) + body


def decode_frame(data: bytes) -> dict:
    """Decode one frame; every rejection is typed and names what broke.
    Truncated/corrupt frames are TRANSIENT (a half-written store value
    may be re-sent); a magic or version mismatch is FATAL."""
    if len(data) < _HEADER.size:
        raise TransportError(
            f"short frame: {len(data)} < header {_HEADER.size}")
    magic, version, body_len, crc = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise TransportError(f"bad frame magic {magic!r}",
                             failure_class="fatal")
    if version != TRANSPORT_VERSION:
        raise TransportError(
            f"transport version {version} != {TRANSPORT_VERSION} "
            f"(mixed incompatible builds in one fleet)",
            failure_class="fatal")
    body = data[_HEADER.size:]
    if len(body) != body_len:
        raise TransportError(
            f"frame length {len(body)} != declared {body_len}")
    if zlib.crc32(body) != crc:
        raise TransportError("frame checksum mismatch")
    try:
        return json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise TransportError(f"frame body undecodable: {e}") from e


def chunk_payloads(payloads: List[bytes],
                   cap: int = FRAME_CAP) -> List[dict]:
    """Binary KV page payloads (the spill tier's CRC'd codec) ->
    JSON-safe chunk dicts, each frame body under `cap`. A chunk is
    {"idx": page, "part": j, "parts": n, "data": base64}: idx/part/parts
    let `join_payloads` reassemble each page independently and detect
    gaps, so a relayed stream may interleave pulls freely."""
    # base64 grows 3 -> 4; leave slack for the JSON envelope around it
    raw_cap = max(1, (int(cap) * 3) // 4 - 512)
    chunks = []
    for idx, blob in enumerate(payloads):
        blob = bytes(blob)
        parts = max(1, -(-len(blob) // raw_cap))
        for part in range(parts):
            piece = blob[part * raw_cap:(part + 1) * raw_cap]
            chunks.append({
                "idx": idx, "part": part, "parts": parts,
                "data": base64.b64encode(piece).decode("ascii")})
    return chunks


def join_payloads(chunks: List[dict]) -> List[bytes]:
    """Reassemble `chunk_payloads` output (any order). Missing pages or
    parts, duplicate parts, or inconsistent part counts raise a
    TRANSIENT TransportError — a re-pull heals; byte-level corruption
    is the payload codec's CRC to catch, not this one's."""
    pages: Dict[int, Dict[int, bytes]] = {}
    declared: Dict[int, int] = {}
    for ch in chunks:
        try:
            idx, part = int(ch["idx"]), int(ch["part"])
            parts = int(ch["parts"])
            data = base64.b64decode(ch["data"], validate=True)
        except (KeyError, TypeError, ValueError) as e:
            raise TransportError(f"undecodable kv chunk: {e}") from e
        if declared.setdefault(idx, parts) != parts:
            raise TransportError(
                f"kv page {idx}: inconsistent part counts "
                f"{declared[idx]} != {parts}")
        if part in pages.setdefault(idx, {}):
            raise TransportError(f"kv page {idx}: duplicate part {part}")
        pages[idx][part] = data
    if set(pages) != set(range(len(pages))):
        raise TransportError(
            f"kv pull missing pages: have {sorted(pages)}")
    out = []
    for idx in range(len(pages)):
        if set(pages[idx]) != set(range(declared[idx])):
            raise TransportError(
                f"kv page {idx}: missing parts "
                f"{sorted(set(range(declared[idx])) - set(pages[idx]))}")
        out.append(b"".join(pages[idx][p]
                            for p in range(declared[idx])))
    return out


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _host_port(endpoint: str):
    host, _, port = endpoint.rpartition(":")
    return host, int(port)


def bind_store(endpoint: str, timeout_ms: int = 120000):
    """The master TCPStore at `endpoint` ("host:port"; port 0 takes a
    free one, read back from `.port`). It does not wait for clients."""
    from torch.distributed import TCPStore
    host, port = _host_port(endpoint)
    return TCPStore(host, port, None, True,
                    datetime.timedelta(milliseconds=timeout_ms),
                    wait_for_workers=False)


def connect_store(endpoint: str, timeout_ms: int = 120000):
    """Connect to an existing store as a client (worker side)."""
    from torch.distributed import TCPStore
    host, port = _host_port(endpoint)
    return TCPStore(host, port, None, False,
                    datetime.timedelta(milliseconds=timeout_ms))


class Channel:
    """One directed pair of mailbox streams between `me` and `peer`.

    send(type, **payload) frames and writes one message on the
    me->peer stream. recv(timeout_s) returns the next message from the
    peer->me stream (None on timeout); recv_all() drains everything
    currently available without sleeping. Store losses surface as
    transient `TransportError`s after `max_attempts` capped-backoff
    retries of the failing store call."""

    def __init__(self, store, me: str, peer: str, *,
                 session: str = "s0", poll_s: float = 5e-4,
                 poll_cap_s: float = 0.02, max_attempts: int = 5,
                 backoff_s: float = 0.01, sleep=None):
        self.store = store
        self.me = str(me)
        self.peer = str(peer)
        self.session = str(session)
        self.poll_s = float(poll_s)
        self.poll_cap_s = float(poll_cap_s)
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self._sleep = sleep if sleep is not None else time.sleep
        self._next_recv = 1                 # next expected peer seq
        self._pending: List[dict] = []      # duplicate-fault replays
        # seq-hole repair: a sender that died (or exhausted its set()
        # retries) between allocating a seq and writing its frame
        # leaves a PERMANENT hole. When the peer's head counter is past
        # our cursor but the key stays absent for `hole_timeout_s`, the
        # seq is skipped and counted (a dropped frame; the snapshot and
        # recent-finished machinery heals the content).
        self.hole_timeout_s = 2.0
        self._hole_first_miss: Optional[float] = None
        self.counters: Dict[str, int] = {
            "sent": 0, "received": 0, "dropped": 0, "duplicated": 0,
            "stalls": 0, "undecodable": 0, "store_retries": 0,
            "holes_skipped": 0}

    # ---- key naming ------------------------------------------------------
    def _key(self, src: str, dst: str, seq: int) -> str:
        return f"ptw/{self.session}/{src}>{dst}/{seq}"

    def _head(self, src: str, dst: str) -> str:
        return f"ptw/{self.session}/{src}>{dst}/head"

    # ---- guarded store IO ------------------------------------------------
    def _store_call(self, what: str, fn, *args):
        """One store operation with capped exponential backoff over
        connection-class failures; exhaustion raises the TRANSIENT
        TransportError the supervisor machinery retries/classifies."""
        last = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args)
            except Exception as e:                        # noqa: BLE001
                last = e
                self.counters["store_retries"] += 1
                self._sleep(min(1.0, self.backoff_s * (2 ** attempt)))
        raise TransportError(
            f"store {what} failed after {self.max_attempts} attempts: "
            f"{last}") from last

    # ---- send/recv -------------------------------------------------------
    def send(self, type: str, **payload) -> int:
        """Frame and write one message; returns its sequence number
        (-1 when an armed `transport.stall` wedged the write — the
        message is silently lost, exactly like a hung sender)."""
        if faults.fire(FAULT_STALL) is not None:
            self.counters["stalls"] += 1
            return -1
        seq = int(self._store_call(
            "add", self.store.add, self._head(self.me, self.peer), 1))
        msg = {"type": str(type), "src": self.me, "dst": self.peer,
               "seq": seq, "payload": payload}
        self._store_call("set", self.store.set,
                         self._key(self.me, self.peer, seq),
                         encode_frame(msg))
        self.counters["sent"] += 1
        return seq

    def relay(self, msg: dict) -> int:
        """Re-send a RECEIVED message (same type + payload) down this
        channel verbatim — the supervisor forwarding a donor's
        `kv_prefix`/`kv_page` stream to the adopting decode worker. A
        fresh seq on this stream is allocated; src/dst are this
        channel's endpoints."""
        return self.send(msg["type"], **msg.get("payload", {}))

    def _get(self, key: str):
        """The key's bytes, or None when it is absent (never waits)."""
        if not self.store.check([key]):
            return None
        return self.store.get(key)

    def _read_next(self):
        """Non-blocking: the next pending message, None when the
        stream is empty (or stalled), or `_CONSUMED` when a seq was
        consumed without yielding a message (dropped by fault, or a
        corrupt frame skipped) — readers keep draining past those."""
        if self._pending:
            return self._pending.pop(0)
        if faults.fire(FAULT_STALL) is not None:
            self.counters["stalls"] += 1
            return None
        key = self._key(self.peer, self.me, self._next_recv)
        data = self._store_call("get", self._get, key)
        if data is None:
            head = int(self._store_call(
                "head", self.store.add,
                self._head(self.peer, self.me), 0))
            if head < self._next_recv:
                self._hole_first_miss = None    # truly nothing sent yet
                return None
            # the peer allocated this seq but its frame is missing: a
            # hole until proven otherwise (the write may simply be in
            # flight — give it hole_timeout_s)
            now = time.monotonic()
            if self._hole_first_miss is None:
                self._hole_first_miss = now
                return None
            if now - self._hole_first_miss < self.hole_timeout_s:
                return None
            self.counters["holes_skipped"] += 1
            self._hole_first_miss = None
            self._next_recv += 1
            return _CONSUMED
        self._hole_first_miss = None
        self._next_recv += 1
        try:
            self._store_call("delete", self.store.delete_key, key)
        except TransportError:
            pass   # losing the delete only leaves a stale key behind
        try:
            msg = decode_frame(bytes(data))
        except TransportError as e:
            if e.failure_class == "fatal":
                raise
            self.counters["undecodable"] += 1
            return _CONSUMED     # corrupt frame: count and skip it
        if faults.fire(FAULT_DROP) is not None:
            self.counters["dropped"] += 1
            return _CONSUMED
        if faults.fire(FAULT_DUPLICATE) is not None:
            self.counters["duplicated"] += 1
            self._pending.append(dict(msg))
        self.counters["received"] += 1
        return msg

    def recv(self, timeout_s: float = 0.0) -> Optional[dict]:
        """Next message, waiting up to `timeout_s` (0 = one poll).
        Returns None on timeout — callers own their liveness policy."""
        deadline = time.monotonic() + float(timeout_s)
        delay = self.poll_s
        while True:
            msg = self._read_next()
            if msg is _CONSUMED:
                continue            # a seq was eaten; look again now
            if msg is not None:
                return msg
            if time.monotonic() >= deadline:
                return None
            self._sleep(delay)
            delay = min(self.poll_cap_s, delay * 2)

    def recv_all(self, limit: int = 1024) -> List[dict]:
        """Drain every currently-available message (bounded)."""
        out = []
        n = 0
        while n < limit:
            msg = self._read_next()
            if msg is None:
                break
            n += 1
            if msg is not _CONSUMED:
                out.append(msg)
        return out

    def purge(self):
        """Best-effort deletion of every outstanding frame + both head
        keys of this channel (shutdown hygiene: frames a dead peer
        never consumed would otherwise sit in the store for its
        lifetime). Never raises — the store may already be gone."""
        for src, dst, start in ((self.me, self.peer, 1),
                                (self.peer, self.me, self._next_recv)):
            try:
                head = int(self.store.add(self._head(src, dst), 0))
                for seq in range(start, head + 1):
                    try:
                        self.store.delete_key(self._key(src, dst, seq))
                    except Exception:                     # noqa: BLE001
                        pass
                self.store.delete_key(self._head(src, dst))
            except Exception:                             # noqa: BLE001
                pass
