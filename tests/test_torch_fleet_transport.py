"""The port's fleet transport against the reference's on the CPU.

Framing: `encode_frame` writes the reference's bytes for the same dicts,
each side decodes the other's frames, and every rejection carries the
reference's `failure_class` and message; `chunk_payloads` cuts the
reference's chunks and `join_payloads` refuses what the reference's
refuses, with the same messages.

Channel: the reference test's scenarios (ordered delivery, a timeout
that returns None, the drop / duplicate / stall faults, store-failure
backoff, a seq hole skipped after its timeout, a corrupt frame skipped)
run as one script on the port's Channel over a loopback
`torch.distributed.TCPStore` and on the reference's Channel over its
native store: the same messages in the same order, the same counters.
"""
import base64

import pytest

from paddle_tpu.serving.fleet import transport as ref_tr
from paddle_tpu.utils import faults as ref_faults
from paddle_tpu_torch.serving.fleet import transport as tr
from paddle_tpu_torch.serving.supervisor import (FATAL, TRANSIENT,
                                                 classify_failure)
from paddle_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (faults, ref_faults):
        f.clear()
        f.reset_counts()
    yield
    for f in (faults, ref_faults):
        f.clear()
        f.reset_counts()


MSGS = [{"type": "events", "src": "w0", "dst": "host", "seq": 3,
         "payload": {"ev": [[1, 0, 42]]}},
        {"type": "heartbeat", "src": "d0", "dst": "host", "seq": 17,
         "payload": {"t": 0.25, "load": 2, "snapshot": {"requests": []},
                     "fired": {"transport.drop": 1}, "name": "ü"}},
        {}, {"a": [1.5, None, True, "x" * 300]}]


@pytest.mark.parametrize("i", range(len(MSGS)))
def test_frame_bytes_equal_the_reference(i):
    msg = MSGS[i]
    frame = tr.encode_frame(msg)
    assert frame == ref_tr.encode_frame(msg)
    assert tr.decode_frame(ref_tr.encode_frame(msg)) == msg
    assert ref_tr.decode_frame(frame) == msg


def _rejects(frame):
    """(failure_class, message) of every corrupted variant, per side."""
    bad_version = bytearray(frame)
    bad_version[4] = tr.TRANSPORT_VERSION + 1
    flipped = bytearray(frame)
    flipped[-1] ^= 0xFF
    body = b"{not json"
    undecodable = tr._HEADER.pack(tr.MAGIC, tr.TRANSPORT_VERSION,
                                  len(body), __import__("zlib").crc32(body))
    variants = [frame[:5], b"XXXX" + frame[4:], bytes(bad_version),
                bytes(flipped), frame[:-2], undecodable + body]
    out = {}
    for side, mod in (("port", tr), ("ref", ref_tr)):
        got = []
        for v in variants:
            with pytest.raises(mod.TransportError) as e:
                mod.decode_frame(v)
            got.append((e.value.failure_class, str(e.value)))
        out[side] = got
    return out


def test_frame_rejections_are_the_references():
    out = _rejects(tr.encode_frame({"a": 1}))
    assert out["port"] == out["ref"]
    assert [c for c, _ in out["port"]] == [
        "transient", "fatal", "fatal", "transient", "transient",
        "transient"]


def test_transport_error_routes_through_classify_failure():
    assert classify_failure(tr.TransportError("lost")) == TRANSIENT
    assert classify_failure(
        tr.TransportError("bad version", failure_class="fatal")) == FATAL
    weird = tr.TransportError("whatever")
    weird.failure_class = "nonsense"
    assert classify_failure(weird) == FATAL


def test_chunks_and_join_refusals_are_the_references():
    payloads = [bytes(range(256)) * 3000, b"", b"\x00" * 70000, b"tail"]
    for cap in (tr.FRAME_CAP, 4096, 900):
        chunks = tr.chunk_payloads(payloads, cap=cap)
        assert chunks == ref_tr.chunk_payloads(payloads, cap=cap)
        assert tr.join_payloads(chunks[::-1]) == payloads
    chunks = tr.chunk_payloads(payloads, cap=4096)
    dup = chunks + [dict(chunks[1])]
    wrong = [dict(c) for c in chunks]
    wrong[1]["parts"] += 1
    bad = [dict(c) for c in chunks]
    bad[0]["data"] = "%%%"
    cases = {"missing_page": [c for c in chunks if c["idx"] != 1],
             "missing_part": chunks[1:], "duplicate": dup,
             "inconsistent": wrong, "undecodable": bad,
             "no_key": [{"idx": 0}]}
    for name, case in cases.items():
        with pytest.raises(tr.TransportError) as got:
            tr.join_payloads(case)
        with pytest.raises(ref_tr.TransportError) as want:
            ref_tr.join_payloads(case)
        assert (str(got.value), got.value.failure_class) == \
            (str(want.value), want.value.failure_class), name
    assert base64.b64decode(chunks[0]["data"]) == payloads[0][:2560]


# ---------------------------------------------------------------- channel
@pytest.fixture(scope="module")
def stores():
    """A loopback TCPStore for the port, the native store for the
    reference."""
    port_store = tr.bind_store("127.0.0.1:0")
    ref_store = ref_tr.bind_store(f"127.0.0.1:{ref_tr.free_port()}")
    return {"port": (tr, faults, port_store),
            "ref": (ref_tr, ref_faults, ref_store)}


def _script(mod, fmod, store, session):
    """The reference test's channel scenarios as one script; returns
    what each step read and every channel's counters."""
    def pair(name):
        return (mod.Channel(store, me="host", peer="w0",
                            session=f"{session}_{name}"),
                mod.Channel(store, me="w0", peer="host",
                            session=f"{session}_{name}"))

    def view(msgs):
        return [(m["type"], m["seq"], m["payload"]) for m in msgs]

    out = []
    a, b = pair("order")
    for i in range(5):
        a.send("ping", i=i)
    out.append(view(b.recv_all()))
    out.append(b.recv(timeout_s=0.0))
    b.send("pong")
    out.append(view([a.recv(timeout_s=1.0)]))
    t, _ = pair("timeout")
    out.append(t.recv(timeout_s=0.02))
    f, g = pair("faults")
    with fmod.injected("transport.duplicate", payload=True, times=1):
        f.send("x", n=1)
        out.append(view(g.recv_all()))
    with fmod.injected("transport.drop", payload=True, times=1):
        f.send("x", n=2)
        f.send("x", n=3)
        out.append(view(g.recv_all()))
    f.send("x", n=4)
    with fmod.injected("transport.stall", payload=True, times=1):
        out.append(g.recv(timeout_s=0.0))
    out.append(view([g.recv(timeout_s=1.0)]))
    out.append(fmod.fired_counts())
    h, k = pair("hole")
    k.hole_timeout_s = 0.05
    store.add(f"ptw/{session}_hole/host>w0/head", 1)   # a torn send
    h.send("x", n=2)
    out.append(k.recv(timeout_s=0.02))
    out.append(view([k.recv(timeout_s=1.0)]))
    c, d = pair("corrupt")
    seq = c.send("x", n=1)
    key = f"ptw/{session}_corrupt/host>w0/{seq}"
    raw = bytearray(store.get(key))
    raw[-1] ^= 0xFF
    store.set(key, bytes(raw))
    c.send("x", n=2)
    out.append(view(d.recv_all()))
    c.purge()
    out.append([ch.counters for ch in (a, b, t, f, g, h, k, c, d)])
    return out


def test_channel_scenarios_equal_the_reference(stores):
    got = _script(*stores["port"], session="s")
    want = _script(*stores["ref"], session="s")
    assert got == want
    counters = got[-1]
    assert counters[4]["duplicated"] == counters[4]["dropped"] == 1
    assert counters[4]["stalls"] == 1
    assert counters[6]["holes_skipped"] == 1
    assert counters[8]["undecodable"] == 1


def test_channel_store_failure_backoff_and_typed_raise():
    """The same capped backoff over a store that always fails, on both
    sides; the port's Channel reads a key with `check` first."""
    def run(mod):
        calls = []

        class DeadStore:
            def add(self, key, delta):
                calls.append(key)
                raise ConnectionError("connection reset")

            def check(self, keys):
                calls.append(keys)
                raise ConnectionError("connection reset")

            get = check

        sleeps = []
        ch = mod.Channel(DeadStore(), me="a", peer="b", max_attempts=3,
                         backoff_s=0.01, sleep=sleeps.append)
        with pytest.raises(mod.TransportError) as e:
            ch.send("ping")
        return (e.value.failure_class, str(e.value), len(calls), sleeps,
                ch.counters["store_retries"])

    got, want = run(tr), run(ref_tr)
    assert got == want
    assert got[0] == "transient" and got[3] == [0.01, 0.02, 0.04]
