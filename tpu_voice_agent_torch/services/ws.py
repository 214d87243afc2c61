"""WebSocket (RFC 6455) and HTTP/1.1 over ``asyncio`` streams, standard library only.

The JAX package's voice service stands on aiohttp (its WebSocket server) and
httpx (its client to the brain and the executor); the machine with the card
has neither, so the port carries the small part of both that the voice
service uses:

- ``serve(app, host, port)``: one listener for plain ``GET`` routes and the
  WebSocket upgrade. The handshake accepts a browser's ``Connection:
  keep-alive, Upgrade``; client frames must be masked (an unmasked one is
  closed with 1002); 7-, 16- and 64-bit lengths and continuation frames are
  read; a ping is answered with a pong; the peer's close code is echoed; a
  text message must be valid UTF-8 (1007); a message past ``MAX_MSG_SIZE``
  (aiohttp's 8 MiB in the voice service) is closed with 1009. Plain
  responses carry ``Connection: close``.
- ``connect(url)``: the client side, with masked frames.
- ``HTTPClient``: JSON ``POST`` / ``GET`` with ``Connection: close``, read to
  ``Content-Length`` or EOF. It raises ``ConnectError`` when no connection
  was made (the request never reached the server, so a retry is safe) and
  ``ReadError`` when the exchange failed after the request was sent.
  Cancelling the awaiting task closes the socket.

A ``WebSocket`` reads its peer on a task of its own, so pings and closes are
answered while the handler awaits something else, and a connection lost
without a close frame cancels the server's handler (aiohttp's
``handler_cancellation``). That task stops reading while more than
``INBOX_BYTES`` of received messages wait for ``receive()``, so a peer that
sends faster than the handler reads is pushed back by TCP, as aiohttp's flow
control does. Every send goes through one lock, so frames of concurrent
senders never interleave.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import hashlib
import json
import logging
import os
import struct
import threading
from dataclasses import dataclass, field
from urllib.parse import urlsplit

log = logging.getLogger("tpu_voice_agent_torch.ws")

WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_MSG_SIZE = 8 * 1024 * 1024  # aiohttp's WebSocketResponse(max_msg_size=...) in JAX
INBOX_BYTES = 64 * 1024  # aiohttp's read-queue limit: past it, reading pauses
MAX_HEAD = 64 * 1024  # request / response line and headers

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA

# Message types a WebSocket's receive() returns
TEXT, BINARY, CLOSE = "text", "binary", "close"

CLOSE_OK, CLOSE_PROTOCOL, CLOSE_NO_STATUS, CLOSE_ABNORMAL = 1000, 1002, 1005, 1006
CLOSE_BAD_DATA, CLOSE_TOO_BIG, CLOSE_INTERNAL = 1007, 1009, 1011

_REASONS = {200: "OK", 101: "Switching Protocols", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 426: "Upgrade Required", 500: "Internal Server Error",
            501: "Not Implemented"}


class Headers(dict):
    """Header names folded to lower case; ``get`` and ``[]`` take any case."""

    def __init__(self, items=()):
        super().__init__()
        for k, v in (items.items() if hasattr(items, "items") else items):
            self[k] = v

    def __setitem__(self, key: str, value) -> None:
        super().__setitem__(key.lower(), str(value))

    def __getitem__(self, key: str) -> str:
        return super().__getitem__(key.lower())

    def get(self, key: str, default=None):
        return super().get(key.lower(), default)


def _tokens(value: str | None) -> set[str]:
    return {t.strip().lower() for t in (value or "").split(",") if t.strip()}


def accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1(key.encode() + WS_GUID).digest()).decode()


async def _read_head(reader: asyncio.StreamReader) -> tuple[str, Headers]:
    """One request or status line and its headers."""
    raw = await reader.readuntil(b"\r\n\r\n")  # LimitOverrunError past MAX_HEAD
    lines = raw.decode("latin-1").split("\r\n")
    headers = Headers()
    for line in lines[1:]:
        if line:
            name, sep, value = line.partition(":")
            if not sep:
                raise ValueError(f"malformed header line {line!r}")
            headers[name.strip()] = value.strip()
    return lines[0], headers


def _head_bytes(first: str, headers: dict) -> bytes:
    return (first + "\r\n" + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
            + "\r\n").encode("latin-1")


# ------------------------------------------------------------------ frames


@dataclass
class Message:
    type: str  # TEXT | BINARY | CLOSE
    data: object = None  # str | bytes | the close code (int)
    extra: str = ""  # the close reason

    def json(self):
        return json.loads(self.data)


class ProtocolError(Exception):
    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code
        self.reason = reason


def _mask(payload: bytes, key: bytes) -> bytes:
    if not payload:
        return payload
    n = len(payload)
    k = int.from_bytes((key * (n // 4 + 1))[:n], "big")
    return (int.from_bytes(payload, "big") ^ k).to_bytes(n, "big")


def encode_frame(opcode: int, payload: bytes, *, mask: bool, fin: bool = True) -> bytes:
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    bit = 0x80 if mask else 0
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if mask:
        key = os.urandom(4)
        return bytes(head) + key + _mask(payload, key)
    return bytes(head) + payload


def close_payload(code: int, reason: str = "") -> bytes:
    return b"" if code == CLOSE_NO_STATUS else struct.pack("!H", code) + reason.encode()


class WebSocket:
    """One end of an open WebSocket. ``client=True`` masks what it sends and
    requires unmasked frames; the server side the reverse."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, *,
                 client: bool):
        self._reader, self._writer = reader, writer
        self._client = client
        self._lock = asyncio.Lock()
        # (message, payload bytes); the bytes of queued data messages are
        # held to INBOX_BYTES (plus one message) by pausing the reader
        self._inbox: asyncio.Queue[tuple[Message, int]] = asyncio.Queue()
        self._inbox_bytes = 0
        self._inbox_room = asyncio.Event()
        self._inbox_room.set()
        self.closed = False  # a close frame went out: nothing more may be sent
        self.close_code: int | None = None  # the peer's close code, or ours on a fault
        self.lost_abruptly = False  # the transport ended without a close frame
        self._peer_closed = asyncio.Event()
        self.on_abrupt_loss = None  # callable, set by the server: cancels its handler
        self._pump = asyncio.ensure_future(self._run_pump())

    # ------------------------------------------------------------- sending

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        frame = encode_frame(opcode, payload, mask=self._client)
        async with self._lock:
            self._writer.write(frame)
            await self._writer.drain()

    async def _send(self, opcode: int, payload: bytes) -> None:
        if self.closed:
            raise ConnectionResetError("Cannot write to closing transport")
        await self._send_frame(opcode, payload)

    async def send_str(self, text: str) -> None:
        await self._send(OP_TEXT, text.encode())

    async def send_bytes(self, data: bytes) -> None:
        await self._send(OP_BINARY, bytes(data))

    async def send_json(self, obj) -> None:
        await self.send_str(json.dumps(obj))

    async def ping(self, data: bytes = b"") -> None:
        await self._send(OP_PING, data)

    async def close(self, code: int = CLOSE_OK, reason: str = "", timeout: float = 10.0) -> None:
        """Send a close frame (once), wait for the peer's, then drop the
        transport."""
        if not self.closed:
            self.closed = True
            self._inbox_room.set()  # read on, to the peer's close frame
            with contextlib.suppress(ConnectionError, RuntimeError):
                await self._send_frame(OP_CLOSE, close_payload(code, reason))
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._peer_closed.wait(), timeout)
        self._writer.close()

    # ------------------------------------------------------------ receiving

    async def receive(self, timeout: float | None = None) -> Message:
        """The next text, binary or close message; ``asyncio.TimeoutError``
        when none comes within ``timeout`` seconds. After the close message,
        every call returns it again."""
        msg, n = await asyncio.wait_for(self._inbox.get(), timeout)
        if msg.type == CLOSE:
            self._inbox.put_nowait((msg, n))
        else:
            self._inbox_bytes -= n
            if self._inbox_bytes <= INBOX_BYTES:
                self._inbox_room.set()
        return msg

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        msg = await self.receive()
        if msg.type == CLOSE:
            raise StopAsyncIteration
        return msg

    async def _read_frame(self) -> tuple[bool, int, bytes]:
        b0, b1 = await self._reader.readexactly(2)
        fin, opcode, masked, n = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
        if b0 & 0x70:
            raise ProtocolError(CLOSE_PROTOCOL, "reserved bits set")
        if masked == self._client:
            raise ProtocolError(CLOSE_PROTOCOL, "a client frame must be masked"
                                if not self._client else "a server frame must not be masked")
        if opcode >= OP_CLOSE and (not fin or n > 125):
            raise ProtocolError(CLOSE_PROTOCOL, "fragmented or long control frame")
        if n == 126:
            (n,) = struct.unpack("!H", await self._reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await self._reader.readexactly(8))
        if n > MAX_MSG_SIZE:
            raise ProtocolError(CLOSE_TOO_BIG, f"message size {n} exceeds limit {MAX_MSG_SIZE}")
        key = await self._reader.readexactly(4) if masked else b""
        payload = await self._reader.readexactly(n)
        return fin, opcode, _mask(payload, key) if masked else payload

    async def _read_message(self) -> tuple[Message, int]:
        """The next data or close message and its payload's size; pings are
        answered here."""
        parts: list[bytes] = []
        size = 0
        kind = None
        while True:
            fin, opcode, payload = await self._read_frame()
            if opcode == OP_PING:
                if not self.closed:
                    await self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                if len(payload) == 1:
                    raise ProtocolError(CLOSE_PROTOCOL, "close payload of one byte")
                code = struct.unpack("!H", payload[:2])[0] if payload else CLOSE_NO_STATUS
                try:
                    reason = payload[2:].decode()
                except UnicodeDecodeError as e:
                    raise ProtocolError(CLOSE_BAD_DATA, "close reason is not UTF-8") from e
                return Message(CLOSE, code, reason), 0
            if opcode not in (OP_CONT, OP_TEXT, OP_BINARY):
                raise ProtocolError(CLOSE_PROTOCOL, f"unknown opcode {opcode}")
            if (opcode == OP_CONT) == (kind is None):
                raise ProtocolError(CLOSE_PROTOCOL, "unexpected continuation frame"
                                    if kind is None else "data frame inside a fragmented one")
            if kind is None:
                kind = TEXT if opcode == OP_TEXT else BINARY
            size += len(payload)
            if size > MAX_MSG_SIZE:
                raise ProtocolError(CLOSE_TOO_BIG,
                                    f"message size {size} exceeds limit {MAX_MSG_SIZE}")
            parts.append(payload)
            if fin:
                data = b"".join(parts)
                if kind == BINARY:
                    return Message(BINARY, data), size
                try:
                    return Message(TEXT, data.decode()), size
                except UnicodeDecodeError as e:
                    raise ProtocolError(CLOSE_BAD_DATA, "text message is not UTF-8") from e

    async def _discard(self) -> None:
        while await self._reader.read(1 << 16):
            pass

    async def _run_pump(self) -> None:
        closing = Message(CLOSE, CLOSE_ABNORMAL)
        try:
            while True:
                msg, n = await self._read_message()
                if msg.type == CLOSE:
                    self.close_code = msg.data
                    closing = msg
                    if not self.closed:  # echo the peer's code
                        self.closed = True
                        await self._send_frame(OP_CLOSE, close_payload(msg.data, msg.extra))
                    self._writer.close()
                    break
                self._inbox.put_nowait((msg, n))
                self._inbox_bytes += n
                if self._inbox_bytes > INBOX_BYTES and not self.closed:
                    # the handler is behind: read nothing more until it
                    # catches up, so the peer's sends back up into TCP
                    self._inbox_room.clear()
                    await self._inbox_room.wait()
        except ProtocolError as e:
            self.close_code = e.code
            closing = Message(CLOSE, e.code, e.reason)
            if not self.closed:
                self.closed = True
                with contextlib.suppress(ConnectionError, RuntimeError):
                    await self._send_frame(OP_CLOSE, close_payload(e.code, e.reason[:120]))
            # the peer may still be writing (the rest of a too-big message):
            # drop what it sends until it closes, so it reads our close frame
            # rather than a reset
            with contextlib.suppress(asyncio.TimeoutError, ConnectionError, OSError):
                await asyncio.wait_for(self._discard(), 10.0)
            self._writer.close()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self.lost_abruptly = not self.closed
            self.closed = True
            self._writer.close()
            if self.lost_abruptly and self.on_abrupt_loss is not None:
                self.on_abrupt_loss()
        finally:
            self._peer_closed.set()
            self._inbox.put_nowait((closing, 0))


# ------------------------------------------------------------------ server


@dataclass
class Request:
    method: str
    path: str
    query: str
    headers: Headers
    body: bytes = b""


@dataclass
class Response:
    """A plain response: a dict body goes out as JSON, a ``str`` body as
    text (``Content-Type`` from ``headers``, default ``text/plain``)."""

    status: int
    body: dict | str = field(default_factory=dict)
    headers: dict = field(default_factory=dict)


@dataclass
class App:
    """What ``serve`` serves: ``http(Request) -> Response`` for plain
    requests, and ``websockets[path](WebSocket, Request)`` for upgrades."""

    http: object
    websockets: dict


async def _respond(writer: asyncio.StreamWriter, resp: Response) -> None:
    if isinstance(resp.body, str):
        data, ctype = resp.body.encode(), "text/plain; charset=utf-8"
    else:
        data, ctype = json.dumps(resp.body).encode(), "application/json; charset=utf-8"
    headers = {"Content-Type": ctype, "Content-Length": str(len(data)), "Connection": "close",
               **resp.headers}
    writer.write(_head_bytes(f"HTTP/1.1 {resp.status} {_REASONS.get(resp.status, '')}",
                             headers) + data)
    await writer.drain()


def _handshake_error(req: Request) -> str | None:
    h = req.headers
    if req.method != "GET":
        return "the upgrade must be a GET"
    if "websocket" not in _tokens(h.get("upgrade")) or "upgrade" not in _tokens(
            h.get("connection")):
        return "not a WebSocket upgrade"
    if h.get("sec-websocket-version") != "13":
        return "Sec-WebSocket-Version must be 13"
    try:
        if len(base64.b64decode(h.get("sec-websocket-key", ""), validate=True)) != 16:
            raise ValueError
    except ValueError:
        return "bad Sec-WebSocket-Key"
    return None


async def _serve_connection(app: App, reader, writer) -> None:
    try:
        first, headers = await _read_head(reader)
        method, target, _version = first.split(" ", 2)
        path, _, query = target.partition("?")
        n = int(headers.get("content-length") or 0)
        body = await reader.readexactly(n) if n else b""
    except (ValueError, asyncio.IncompleteReadError, asyncio.LimitOverrunError,
            ConnectionError):
        writer.close()
        return
    req = Request(method, path, query, headers, body)
    try:
        handler = app.websockets.get(path)
        if handler is None:
            try:
                resp = await app.http(req)
            except Exception as e:  # noqa: BLE001 - the listener must keep serving
                log.exception("%s %s failed", method, path)
                resp = Response(500, {"error": "internal", "detail": str(e)[:300]})
            await _respond(writer, resp)
            return
        err = _handshake_error(req)
        if err is not None:
            await _respond(writer, Response(400, {"error": "bad_request", "detail": err}))
            return
        writer.write(_head_bytes("HTTP/1.1 101 Switching Protocols", {
            "Upgrade": "websocket", "Connection": "Upgrade",
            "Sec-WebSocket-Accept": accept_key(headers["sec-websocket-key"])}))
        await writer.drain()
        ws = WebSocket(reader, writer, client=False)
        task = asyncio.ensure_future(handler(ws, req))
        ws.on_abrupt_loss = task.cancel
        code = CLOSE_OK
        try:
            await task
        except asyncio.CancelledError:
            if not ws.lost_abruptly:
                raise  # the server is stopping
        except Exception:  # noqa: BLE001 - one session's fault must not reach the listener
            log.exception("WebSocket handler for %s failed", path)
            code = CLOSE_INTERNAL
        finally:
            if not ws.closed:
                await ws.close(code)
            ws._pump.cancel()
    except ConnectionError:
        pass
    finally:
        writer.close()


async def serve(app: App, host: str = "127.0.0.1", port: int = 0) -> asyncio.base_events.Server:
    """Start serving ``app``; ``port=0`` picks a free port
    (``server.sockets[0].getsockname()[1]``). Closing the server and
    cancelling the tasks in ``server.connections`` stops it."""
    conns: set[asyncio.Task] = set()

    async def on_connect(reader, writer):
        task = asyncio.current_task()
        conns.add(task)
        try:
            await _serve_connection(app, reader, writer)
        finally:
            conns.discard(task)

    server = await asyncio.start_server(on_connect, host, port, limit=MAX_HEAD)
    server.connections = conns
    return server


async def stop(server) -> None:
    server.close()
    tasks = list(server.connections)
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


class ServerThread:
    """Serve an ``App`` from an event loop on a daemon thread (tests, the
    smoke script): ``with ServerThread(app) as srv: srv.url``."""

    def __init__(self, app: App, host: str = "127.0.0.1", port: int = 0):
        self.app, self.host, self.port = app, host, port
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._server = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "ServerThread":
        self._thread.start()
        self._server = asyncio.run_coroutine_threadsafe(
            serve(self.app, self.host, self.port), self.loop).result(timeout=30)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    def __exit__(self, *exc) -> None:
        asyncio.run_coroutine_threadsafe(stop(self._server), self.loop).result(timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=30)
        self.loop.close()


# ------------------------------------------------------------------ clients


async def connect(url: str, timeout: float = 30.0) -> WebSocket:
    """Open a client WebSocket to ``ws://host:port/path`` (``http://`` is
    taken as ``ws://``)."""
    u = urlsplit(url)
    if u.scheme not in ("ws", "http"):
        raise ValueError(f"unsupported scheme {u.scheme!r} (ws:// only)")
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(u.hostname, u.port or 80, limit=MAX_HEAD), timeout)
    try:
        key = base64.b64encode(os.urandom(16)).decode()
        target = (u.path or "/") + (f"?{u.query}" if u.query else "")
        writer.write(_head_bytes(f"GET {target} HTTP/1.1", {
            "Host": u.netloc, "Upgrade": "websocket", "Connection": "Upgrade",
            "Sec-WebSocket-Key": key, "Sec-WebSocket-Version": "13"}))
        await writer.drain()
        first, headers = await asyncio.wait_for(_read_head(reader), timeout)
        if first.split(" ")[1:2] != ["101"]:
            raise ConnectionError(f"WebSocket upgrade refused: {first}")
        if headers.get("sec-websocket-accept") != accept_key(key):
            raise ConnectionError("bad Sec-WebSocket-Accept")
    except BaseException:
        writer.close()
        raise
    return WebSocket(reader, writer, client=True)


class HTTPError(Exception):
    """A transport failure of ``HTTPClient`` (httpx's ``HTTPError``)."""


class ConnectError(HTTPError):
    """No connection was made: the request never reached the server."""


class ConnectTimeout(ConnectError):
    pass


class ReadError(HTTPError):
    """The exchange failed after the request was sent: the server may have
    acted on it."""


class ReadTimeout(ReadError):
    pass


@dataclass
class HTTPResponse:
    status_code: int
    headers: Headers
    content: bytes

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.content)


class HTTPClient:
    """JSON over HTTP/1.1, one connection a request (``Connection: close``).
    ``timeout`` bounds the connect and, again, the exchange after it."""

    async def post(self, url: str, json=None, headers=None, timeout: float | None = None):
        return await self.request("POST", url, json=json, headers=headers, timeout=timeout)

    async def get(self, url: str, headers=None, timeout: float | None = None):
        return await self.request("GET", url, headers=headers, timeout=timeout)

    async def request(self, method: str, url: str, json=None, headers=None,
                      timeout: float | None = None) -> HTTPResponse:
        u = urlsplit(url)
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(u.hostname, u.port or 80, limit=MAX_HEAD), timeout)
        except asyncio.TimeoutError as e:
            raise ConnectTimeout("timed out connecting") from e
        except OSError as e:
            raise ConnectError("All connection attempts failed") from e
        try:
            return await asyncio.wait_for(
                self._exchange(reader, writer, method, u, json, headers), timeout)
        except asyncio.TimeoutError as e:
            raise ReadTimeout("timed out waiting for the response") from e
        except (OSError, ValueError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError) as e:
            raise ReadError(f"{type(e).__name__}: {e}") from e
        finally:
            writer.close()  # also when the awaiting task is cancelled

    @staticmethod
    async def _exchange(reader, writer, method, u, body, headers) -> HTTPResponse:
        data = b"" if body is None else json.dumps(body).encode()
        head = {"Host": u.netloc, "Accept": "*/*", "Connection": "close"}
        if body is not None:
            head["Content-Type"] = "application/json"
        if body is not None or method == "POST":
            head["Content-Length"] = str(len(data))
        head.update(headers or {})
        target = (u.path or "/") + (f"?{u.query}" if u.query else "")
        writer.write(_head_bytes(f"{method} {target} HTTP/1.1", head) + data)
        await writer.drain()
        first, rh = await _read_head(reader)
        status = int(first.split(" ")[1])
        if "chunked" in _tokens(rh.get("transfer-encoding")):
            raise ValueError("chunked responses are not read (Content-Length or EOF only)")
        n = rh.get("content-length")
        content = await reader.readexactly(int(n)) if n is not None else await reader.read()
        return HTTPResponse(status, rh, content)
