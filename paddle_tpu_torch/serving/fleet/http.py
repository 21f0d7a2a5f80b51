"""HTTP/SSE front door over a FleetServer (port of
`paddle_tpu/serving/fleet/http.py`).

A wire-level front end so clients outside this process can reach the
fleet — dependency-free (asyncio streams + hand-rolled HTTP/1.1) and
deliberately small: the protocol work
(streaming, failover, admission, metrics) all lives below, this module
only translates it onto sockets.

Routes:

* ``POST /v1/completions`` — body ``{"prompt_ids": [...],
  "max_new_tokens": N, "stream": true|false, "eos_token_id": ...,
  "ttl_s": ..., "tenant": ..., "adapter": ...,
  "ttft_slo_s": ..., "tpot_slo_s": ...}``.
  With ``stream`` (default true) the response is Server-Sent Events:
  one ``data: {token event}`` per token delta from the existing
  `TokenStream`, then one ``data: {finish event}``, then ``data:
  [DONE]`` — the OpenAI-style shape at token-id level. Without it, one
  JSON body ``{"request_id", "tokens", "finish_reason"}``. Typed
  admission sheds map to status codes: 429 (`EngineOverloaded` /
  tenant throttle / SLO shed), 503 (`NoHealthyReplica`),
  404 (`AdapterNotLoaded` — the named LoRA adapter is on no healthy
  replica), 400 for bad payloads.
* ``GET /metrics`` — the existing `FleetServer.metrics_text()`
  Prometheus body (merged fleet + per-replica labels).
* ``GET /healthz`` — JSON from replica heartbeats: per-replica state +
  heartbeat age on the fleet clock, 200 while any replica is healthy,
  503 otherwise.

Connection model: one asyncio task per connection on the same event
loop the replica stepping tasks share; SSE responses are
``Connection: close`` (no chunked framing needed). A client that
disconnects mid-stream closes its TokenStream — the request itself
keeps running (abort is an explicit API, not a hangup side effect).
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional, Tuple

__all__ = ["HttpFrontend"]

_MAX_HEADER = 64 * 1024
_MAX_BODY = 4 * 1024 * 1024


def _http_response(status: int, reason: str, body: bytes,
                   content_type: str = "application/json") -> bytes:
    return (f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode() + body


class HttpFrontend:
    """Serve a FleetServer over HTTP/SSE on (host, port).

    Use as an async context manager (starts the FleetServer too if it
    is not already running):

        async with FleetServer(fleet) as server, \\
                HttpFrontend(server, port=0) as front:
            ...  # front.port is the bound port
    """

    def __init__(self, server, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.server = server          # the FleetServer
        self.host = host
        self.port = int(port)         # 0 = ephemeral; real port after start
        self._srv: Optional[asyncio.AbstractServer] = None
        self.counters = {"requests": 0, "streams": 0, "errors": 0,
                         "bad_requests": 0, "sheds": 0}

    # ---- lifecycle -------------------------------------------------------
    async def start(self):
        if self._srv is not None:
            return self
        self._srv = await asyncio.start_server(
            self._serve_conn, self.host, self.port, limit=_MAX_HEADER)
        self.port = self._srv.sockets[0].getsockname()[1]
        return self

    async def stop(self):
        if self._srv is not None:
            self._srv.close()
            await self._srv.wait_closed()
            self._srv = None

    async def __aenter__(self):
        return await self.start()

    async def __aexit__(self, *exc):
        await self.stop()

    # ---- request plumbing ------------------------------------------------
    @staticmethod
    async def _read_request(reader) -> Optional[Tuple[str, str, dict,
                                                      bytes]]:
        try:
            # the stream limit (start_server limit=_MAX_HEADER) bounds
            # the header block: oversized headers surface here as
            # LimitOverrunError and become a 400, not a silent close
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, path, _ = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            return None     # malformed Content-Length: a 400, not a 500
        if length < 0 or length > _MAX_BODY:
            return None
        body = await reader.readexactly(length) if length else b""
        return method.upper(), path, headers, body

    async def _serve_conn(self, reader, writer):
        try:
            req = await self._read_request(reader)
            if req is None:
                self.counters["bad_requests"] += 1
                writer.write(_http_response(400, "Bad Request",
                                            b'{"error":"bad request"}'))
            else:
                method, path, _, body = req
                self.counters["requests"] += 1
                await self._route(method, path.split("?", 1)[0], body,
                                  writer)
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass                       # client went away; nothing owed
        except Exception:                                 # noqa: BLE001
            self.counters["errors"] += 1
            try:
                writer.write(_http_response(
                    500, "Internal Server Error",
                    b'{"error":"internal"}'))
                await writer.drain()
            except Exception:                             # noqa: BLE001
                pass
        finally:
            try:
                writer.close()
            except Exception:                             # noqa: BLE001
                pass

    async def _route(self, method: str, path: str, body: bytes, writer):
        if method == "GET" and path == "/metrics":
            text = self.server.metrics_text().encode()
            writer.write(_http_response(
                200, "OK", text,
                content_type="text/plain; version=0.0.4"))
        elif method == "GET" and path == "/healthz":
            writer.write(self._healthz())
        elif method == "POST" and path == "/v1/completions":
            await self._completions(body, writer)
        else:
            writer.write(_http_response(404, "Not Found",
                                        b'{"error":"not found"}'))

    # ---- endpoints -------------------------------------------------------
    def _healthz(self) -> bytes:
        from .replica import ReplicaState
        fleet = self.server.fleet
        now = fleet._clock()
        replicas = {
            r.name: {"state": r.state.value,
                     "heartbeat_age_s": round(max(
                         0.0, now - r.last_progress), 6),
                     "load": r.load}
            for r in fleet.replicas}
        healthy = any(r.state is ReplicaState.HEALTHY
                      for r in fleet.replicas)
        doc = {"status": "ok" if healthy else "unavailable",
               "replicas": replicas}
        return _http_response(200 if healthy else 503,
                              "OK" if healthy else "Service Unavailable",
                              json.dumps(doc).encode())

    async def _completions(self, body: bytes, writer):
        from ..errors import EngineOverloaded
        from ..lora.adapter import AdapterNotLoaded
        from .errors import NoHealthyReplica
        try:
            req = json.loads(body.decode("utf-8") or "{}")
            prompt_ids = [int(t) for t in req["prompt_ids"]]
            kw = {}
            for k in ("max_new_tokens", "eos_token_id", "ttl_s",
                      "tenant", "adapter", "ttft_slo_s", "tpot_slo_s"):
                if req.get(k) is not None:
                    kw[k] = req[k]
            stream_mode = bool(req.get("stream", True))
        except Exception:                                 # noqa: BLE001
            self.counters["bad_requests"] += 1
            writer.write(_http_response(
                400, "Bad Request",
                b'{"error":"body must be JSON with prompt_ids"}'))
            return
        try:
            stream = await self.server.submit(prompt_ids, **kw)
        except AdapterNotLoaded as e:
            # the named LoRA adapter is loaded on no healthy
            # replica — a resource the fleet does not currently hold
            self.counters["sheds"] += 1
            writer.write(_http_response(
                404, "Not Found",
                json.dumps({"error": type(e).__name__,
                            "detail": str(e)}).encode()))
            return
        except EngineOverloaded as e:
            self.counters["sheds"] += 1
            writer.write(_http_response(
                429, "Too Many Requests",
                json.dumps({"error": type(e).__name__,
                            "detail": str(e)}).encode()))
            return
        except NoHealthyReplica as e:
            self.counters["sheds"] += 1
            writer.write(_http_response(
                503, "Service Unavailable",
                json.dumps({"error": type(e).__name__,
                            "detail": str(e)}).encode()))
            return
        if not stream_mode:
            tokens, reason = await stream.collect()
            writer.write(_http_response(
                200, "OK",
                json.dumps({"request_id": stream.request_id,
                            "tokens": tokens,
                            "finish_reason": reason}).encode()))
            return
        self.counters["streams"] += 1
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        try:
            async for event in stream:
                writer.write(b"data: "
                             + json.dumps(event).encode() + b"\n\n")
                await writer.drain()
            writer.write(b"data: [DONE]\n\n")
        except (ConnectionError, asyncio.IncompleteReadError):
            raise
        except Exception:                                 # noqa: BLE001
            # the SSE preamble is already on the wire: a status line
            # appended mid-body would be protocol garbage, so an
            # unexpected failure ends the stream with a clean close
            # (counted) — never the outer handler's 500
            self.counters["errors"] += 1
        finally:
            # a gone client detaches its stream; the request lives on
            stream.close()
