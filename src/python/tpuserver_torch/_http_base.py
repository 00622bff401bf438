"""Stdlib HTTP request framing for the fleet router.

The port's copy of ``tpuserver._http_base``: the framing the JAX
package's replica front end and its router share.  In the port it
serves the router only (``tpuserver_torch.fleet_router._RouterHandler``);
the port's replica server (``http_server.py``) keeps its own
``BaseHTTPRequestHandler``.  It speaks a hand-rolled HTTP/1.1 dialect:
request-line + header parsing with byte splits (the stdlib
``BaseHTTPRequestHandler`` parses headers through the email package at
~300us/request), one-``write`` responses, chunked streaming for SSE,
and gzip/deflate body decoding.  The router subclasses
:class:`BaseHttpHandler` and adds only its *dispatch* (forward to the
fleet).

Framing rules encoded here:

- Responses leave in one ``write`` (status + headers + body), with
  Nagle disabled — a multi-write response interacts with delayed ACKs
  for ~40ms stalls.
- A POST body is always drained before responding (an unconsumed body
  would be parsed as the next request on the keep-alive socket); a
  body that cannot be read (bad Content-Length / encoding) answers 400
  and drops the connection, whose stream position is undefined.
- Chunked transfer framing is HTTP/1.1; a 1.0 client gets streamed
  bodies raw, delimited by connection close.
- Streaming writes (``_send_stream_start`` / ``_send_chunk`` /
  ``_end_chunks``) convert a dead DOWNSTREAM socket into
  :class:`ClientGone` so relay/generate loops can distinguish "my
  client hung up" from an upstream failure.
"""

import gzip
import json
import selectors
import socket
import socketserver
import threading
import zlib

#: One status line per code either surface can emit.  This map is the
#: single source of truth for both tiers (R4 checks every ServerError
#: code appears here; R8 checks it stays a superset of the gRPC code
#: map): a code missing from it silently degrades to the blanket 500
#: line on the wire.
_STATUS_LINE = {
    200: b"HTTP/1.1 200 OK\r\n",
    400: b"HTTP/1.1 400 Bad Request\r\n",
    404: b"HTTP/1.1 404 Not Found\r\n",
    405: b"HTTP/1.1 405 Method Not Allowed\r\n",
    409: b"HTTP/1.1 409 Conflict\r\n",
    422: b"HTTP/1.1 422 Unprocessable Entity\r\n",
    429: b"HTTP/1.1 429 Too Many Requests\r\n",
    500: b"HTTP/1.1 500 Internal Server Error\r\n",
    501: b"HTTP/1.1 501 Not Implemented\r\n",
    502: b"HTTP/1.1 502 Bad Gateway\r\n",
    503: b"HTTP/1.1 503 Service Unavailable\r\n",
    504: b"HTTP/1.1 504 Gateway Timeout\r\n",
}


class ClientGone(Exception):
    """The downstream client hung up mid-stream.  Raised by the
    streaming writers instead of the raw ``ConnectionError`` so a relay
    loop cannot mistake its own dead client for an upstream failure
    (the router would otherwise mark a healthy replica unreachable)."""


class _Headers:
    """Case-insensitive header view over a plain dict of lowercased
    keys."""

    __slots__ = ("_d",)

    def __init__(self, d):
        self._d = d

    def get(self, key, default=None):
        return self._d.get(key.lower(), default)


class BaseHttpHandler(socketserver.StreamRequestHandler):
    """The shared request loop + response plumbing.  Subclasses provide
    ``_dispatch(method)`` (and ``server_token`` for the Server:
    header); everything on the wire below the route table lives here.
    """

    # Send responses in one TCP segment: without NODELAY the write
    # would interact with delayed ACKs for ~40ms stalls.
    disable_nagle_algorithm = True

    #: The Server: response header value.
    server_token = b"tpu-triton-server"

    # -- request loop ------------------------------------------------------

    def handle(self):
        rfile = self.rfile
        while True:
            try:
                line = rfile.readline(65537)
            except ConnectionResetError:
                # a client that closed with the last response's tail
                # unread resets the connection: it wants no more
                return
            if not line:
                return
            if line in (b"\r\n", b"\n"):
                continue
            try:
                method, target, version = (
                    line.decode("latin-1").rstrip("\r\n").split(" ", 2)
                )
            except ValueError:
                self._send(400, b'{"error": "malformed request line"}')
                return
            raw_headers = {}
            while True:
                h = rfile.readline(65537)
                if h in (b"\r\n", b"\n", b""):
                    break
                colon = h.find(b":")
                if colon > 0:
                    raw_headers[
                        h[:colon].decode("latin-1").strip().lower()
                    ] = h[colon + 1:].decode("latin-1").strip()
            self.headers = _Headers(raw_headers)
            self.path = target
            # chunked transfer framing is HTTP/1.1; a 1.0 client gets
            # streamed bodies raw, delimited by connection close
            self._chunked_ok = version != "HTTP/1.0"
            close = (
                raw_headers.get("connection", "").lower() == "close"
                or version == "HTTP/1.0"
            )
            self._body = None
            self._started = False
            self._detached = False
            try:
                if method == "POST":
                    try:
                        self._read_body()  # drain before any response
                    except (ValueError, OSError, EOFError, zlib.error) as e:
                        # body unreadable (bad Content-Length / encoding):
                        # respond, then drop the connection — the socket
                        # position is undefined for further requests
                        self._send_error_json(
                            "malformed request body: {}".format(e), 400
                        )
                        return
                    self._dispatch("POST")
                elif method == "GET":
                    self._dispatch("GET")
                else:
                    # unknown method: the body (if any) was not drained,
                    # so this connection cannot be reused
                    self._send(405, b'{"error": "unsupported method"}')
                    return
            except (BrokenPipeError, ConnectionResetError, ClientGone):
                return
            if self._detached or close:
                # detached: the connection's ownership moved to an
                # SseRelayLoop — reading more requests off it here
                # would race the relay's writes on the same socket
                return

    def _dispatch(self, method):
        raise NotImplementedError

    # -- body --------------------------------------------------------------

    def _read_body(self):
        """Read (once) and cache the request body.

        Always called before responding — an unconsumed body would be
        parsed as the start of the next request on this keep-alive
        socket.
        """
        if self._body is None:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            encoding = self.headers.get("Content-Encoding")
            if encoding == "gzip":
                body = gzip.decompress(body)
            elif encoding == "deflate":
                body = zlib.decompress(body)
            self._body = body
        return self._body

    # -- unary responses ---------------------------------------------------

    def _send(self, code, body=b"", headers=None,
              content_type="application/json"):
        head = (
            _STATUS_LINE.get(code, _STATUS_LINE[500])
            + b"Server: " + self.server_token
            + b"\r\nContent-Type: "
            + content_type.encode("latin-1")
            + b"\r\nContent-Length: "
            + str(len(body)).encode("latin-1")
            + b"\r\n"
        )
        for key, val in (headers or {}).items():
            head += (
                key.encode("latin-1")
                + b": "
                + str(val).encode("latin-1")
                + b"\r\n"
            )
        # single write: status + headers + body in one segment
        self.wfile.write(head + b"\r\n" + body)

    def _send_json(self, obj, code=200, headers=None):
        self._send(code, json.dumps(obj).encode("utf-8"), headers)

    def _send_error_json(self, msg, code=400, headers=None):
        self._send_json({"error": msg}, code, headers)

    # -- streaming responses -----------------------------------------------

    def _send_stream_start(self, content_type="text/event-stream"):
        """Open a streaming 200 response; the body follows as
        ``_send_chunk`` frames ended by ``_end_chunks``.  Used by
        ``/generate_stream`` — token count is data-dependent, so
        Content-Length cannot be known up front and each token must
        leave the socket as its decode step produces it."""
        head = (
            _STATUS_LINE[200]
            + b"Server: " + self.server_token
            + b"\r\nContent-Type: "
            + content_type.encode("latin-1")
        )
        if self._chunked_ok:
            head += b"\r\nTransfer-Encoding: chunked\r\n\r\n"
        else:
            head += b"\r\nConnection: close\r\n\r\n"
        try:
            self.wfile.write(head)
        except (BrokenPipeError, ConnectionResetError, OSError) as e:
            raise ClientGone() from e

    def _ensure_started(self, content_type="text/event-stream"):
        if not self._started:
            self._send_stream_start(content_type)
            self._started = True

    def _send_chunk(self, data):
        """One streamed frame to the client, flushed immediately; a
        dead client raises :class:`ClientGone` so streaming loops can
        stop generating (or park resume state) instead of spinning."""
        try:
            if self._chunked_ok:
                data = (("%x\r\n" % len(data)).encode("latin-1")
                        + data + b"\r\n")
            self.wfile.write(data)
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError) as e:
            raise ClientGone() from e

    def _end_chunks(self):
        """Terminal zero-length chunk: the connection stays reusable
        (no-op for HTTP/1.0, whose end-of-body is the close)."""
        if self._chunked_ok:
            try:
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError, OSError) as e:
                raise ClientGone() from e

    # -- socket detach (selector relay hand-off) ---------------------------

    def _detach_socket(self):
        """Dup the client socket out of the handler thread's ownership
        so an :class:`SseRelayLoop` can keep streaming on it after this
        handler returns.  Flushes any buffered response bytes first
        (the stream-start headers must hit the wire before the relay's
        frames), marks the request detached so ``handle()`` stops
        reading the shared connection, and returns the new socket
        object.  The caller's server must still skip the half-close in
        ``shutdown_request`` (a ``shutdown(SHUT_WR)`` on the original
        applies to the dup'd socket too)."""
        self.wfile.flush()
        sock = self.connection.dup()
        self._detached = True
        return sock


class _ChunkDecoder:
    """Incremental HTTP/1.1 chunked-transfer decoder: feed raw socket
    bytes, get body bytes back.  ``done`` latches once the terminal
    0-length chunk (and any trailers) has been consumed — a clean end
    of body, distinct from a connection drop mid-chunk."""

    __slots__ = ("_buf", "_remaining", "_state", "done")

    def __init__(self):
        self._buf = b""
        self._remaining = 0
        self._state = "size"
        self.done = False

    def feed(self, data):
        self._buf += data
        out = []
        while not self.done:
            if self._state == "size":
                i = self._buf.find(b"\r\n")
                if i < 0:
                    break
                line = self._buf[:i].split(b";", 1)[0].strip()
                self._buf = self._buf[i + 2:]
                size = int(line or b"0", 16)
                if size == 0:
                    self._state = "trailer"
                else:
                    self._remaining = size
                    self._state = "data"
            elif self._state == "data":
                if not self._buf:
                    break
                take = self._buf[:self._remaining]
                out.append(take)
                self._buf = self._buf[len(take):]
                self._remaining -= len(take)
                if self._remaining == 0:
                    self._state = "crlf"
            elif self._state == "crlf":
                if len(self._buf) < 2:
                    break
                self._buf = self._buf[2:]
                self._state = "size"
            else:  # trailer lines end at the first empty line
                i = self._buf.find(b"\r\n")
                if i < 0:
                    break
                line = self._buf[:i]
                self._buf = self._buf[i + 2:]
                if not line:
                    self.done = True
        return b"".join(out)


class RelayStream:
    """One detached SSE relay: an upstream socket already past its
    response headers, a client socket already past the stream-start
    headers, and the protocol adapter that turns upstream lines into
    client frames.  Every field is owned by the relay loop's single
    thread after :meth:`SseRelayLoop.adopt` — no locking.

    The adapter contract (``relay``):

    - ``on_line(line) -> (action, blocks)`` — one upstream SSE line
      (terminator stripped); ``blocks`` are pre-formatted SSE bytes to
      forward (the loop applies chunked framing), ``action`` is
      ``"continue"``, ``"final"`` or ``"error"`` (both terminal: the
      loop appends the chunked terminator and closes cleanly).
    - ``on_upstream_end()`` — upstream EOF/clean chunked end with no
      terminal event; the loop then closes the client WITHOUT the
      chunked terminator, which a resuming client reads as a dropped
      connection and reconnects through its resume path.
    - ``on_closed(reason)`` — exactly once, after both sockets are
      closed; releases the generation/replica/inflight accounting the
      detaching handler deferred.
    """

    __slots__ = ("upstream", "client", "relay", "chunked_out", "decoder",
                 "leftover", "linebuf", "outbuf", "closed", "terminal",
                 "paused", "writable_armed")

    def __init__(self, upstream, client, relay, leftover=b"",
                 chunked_in=True, chunked_out=True):
        self.upstream = upstream
        self.client = client
        self.relay = relay
        self.chunked_out = chunked_out
        self.decoder = _ChunkDecoder() if chunked_in else None
        self.leftover = leftover
        self.linebuf = b""
        self.outbuf = bytearray()
        self.closed = False
        self.terminal = None
        self.paused = False
        self.writable_armed = False


class SseRelayLoop:
    """A selector-driven relay for detached SSE streams: one daemon
    thread multiplexes thousands of idle token streams that would each
    pin a blocking thread under the stock ThreadingTCPServer relay
    (the thread-per-connection ceiling).  The relay hot path is
    enqueue-only (the journal writer takes no lock on it), so the
    writer side degrades naturally to an event loop.

    Streams enter through :meth:`adopt` from handler threads; all
    socket work happens on the loop thread.  Backpressure: a slow
    client's outbound buffer pauses upstream reads past
    ``HIGH_WATER`` and resumes below ``LOW_WATER``.
    """

    #: outbound buffer bounds for one stream: pause upstream reads at
    #: HIGH_WATER bytes queued, resume once the client drains below
    #: LOW_WATER — an unbounded buffer would let one dead-slow client
    #: hold token history for its whole generation in memory
    HIGH_WATER = 1 << 20
    LOW_WATER = 1 << 16

    def __init__(self, name="sse-relay"):
        self._name = name
        self._selector = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, None)
        self._lock = threading.Lock()
        self._pending = []       # guarded-by: _lock
        self._thread = None      # guarded-by: _lock
        self._stopping = False   # guarded-by: _lock
        self._active = 0         # guarded-by: _lock
        self._adopted_total = 0  # guarded-by: _lock
        self._closed_total = 0   # guarded-by: _lock

    # -- handler-thread surface --------------------------------------------

    def adopt(self, stream):
        """Hand a :class:`RelayStream` to the loop (lazy-starting the
        loop thread on first use).  Raises ``RuntimeError`` after
        :meth:`stop` — the caller falls back to its threaded relay."""
        with self._lock:
            if self._stopping:
                raise RuntimeError("relay loop is stopped")
            self._pending.append(stream)
            self._adopted_total += 1
            self._active += 1
            starter = None
            if self._thread is None:
                starter = threading.Thread(
                    target=self._run, name=self._name, daemon=True)
                self._thread = starter
        if starter is not None:
            starter.start()
        self._wake()

    def stats(self):
        with self._lock:
            return {
                "streams": self._active,
                "adopted_total": self._adopted_total,
                "closed_total": self._closed_total,
            }

    def stop(self):
        """Stop the loop and close every adopted stream (reason
        ``"stopped"``); joins the loop thread."""
        with self._lock:
            self._stopping = True
            thread = self._thread
        self._wake()
        if thread is not None:
            thread.join(timeout=5.0)
        else:
            # never started: release the selector + wake pipe here
            self._teardown()

    def _wake(self):
        try:
            self._wake_w.send(b"w")
        except OSError:
            pass  # loop already tore the wake pipe down

    # -- loop thread -------------------------------------------------------

    def _run(self):
        while True:
            with self._lock:
                stopping = self._stopping
                pending, self._pending = self._pending, []
            if stopping:
                for stream in pending:
                    self._close_stream(stream, "stopped")
                break
            for stream in pending:
                self._register(stream)
            for key, mask in self._selector.select(timeout=0.5):
                stream = key.data
                if stream is None:
                    try:
                        self._wake_r.recv(65536)
                    except OSError:
                        pass
                    continue
                if stream.closed:
                    continue
                try:
                    if mask & selectors.EVENT_WRITE:
                        self._flush_client(stream)
                    if (mask & selectors.EVENT_READ) and not stream.closed:
                        if key.fileobj is stream.client:
                            self._client_readable(stream)
                        else:
                            self._upstream_readable(stream)
                except (OSError, ValueError):
                    self._close_stream(stream, "relay-error")
        self._teardown()

    def _teardown(self):
        for key in list(self._selector.get_map().values()):
            if key.data is not None:
                self._close_stream(key.data, "stopped")
        try:
            self._wake_r.close()
            self._wake_w.close()
        except OSError:
            pass
        self._selector.close()

    def _register(self, stream):
        stream.upstream.setblocking(False)
        stream.client.setblocking(False)
        try:
            self._selector.register(
                stream.upstream, selectors.EVENT_READ, stream)
            self._selector.register(
                stream.client, selectors.EVENT_READ, stream)
        except (OSError, ValueError):
            self._close_stream(stream, "relay-error")
            return
        leftover, stream.leftover = stream.leftover, b""
        if leftover:
            try:
                self._feed(stream, leftover)
            except (OSError, ValueError):
                self._close_stream(stream, "relay-error")

    # -- upstream side -----------------------------------------------------

    def _upstream_readable(self, stream):
        while not stream.closed and not stream.paused:
            try:
                data = stream.upstream.recv(65536)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                data = b""
            if not data:
                self._upstream_end(stream)
                return
            if not self._feed(stream, data):
                return

    def _feed(self, stream, data):
        """Decode body framing, split SSE lines, drive the adapter.
        Returns False once the stream reached a terminal state."""
        payload = (stream.decoder.feed(data) if stream.decoder is not None
                   else data)
        stream.linebuf += payload
        while True:
            i = stream.linebuf.find(b"\n")
            if i < 0:
                break
            line = stream.linebuf[:i].rstrip(b"\r")
            stream.linebuf = stream.linebuf[i + 1:]
            action, blocks = stream.relay.on_line(line)
            for block in blocks:
                self._queue_out(stream, block)
            if stream.closed:
                return False  # queueing found the client gone
            if action != "continue":
                self._finish(stream, action)
                return False
        if stream.decoder is not None and stream.decoder.done:
            self._upstream_end(stream)
            return False
        if stream.paused:
            # mid-feed overflow: stash nothing — recv stops above; the
            # already-buffered linebuf waits for the drain to resume
            return not stream.closed
        return not stream.closed

    def _upstream_end(self, stream):
        """Upstream EOF with no terminal event: flush what the client
        is owed, then close WITHOUT the chunked terminator so the
        resuming client treats it as a dropped connection."""
        stream.relay.on_upstream_end()
        self._drop_upstream(stream)
        stream.terminal = "upstream-died"
        self._flush_client(stream)

    def _finish(self, stream, action):
        """Terminal event relayed: append the chunked terminator, drop
        the upstream leg now, and close the client once its buffer
        drains."""
        self._drop_upstream(stream)
        if stream.chunked_out:
            stream.outbuf += b"0\r\n\r\n"
        stream.terminal = action
        self._flush_client(stream)

    def _drop_upstream(self, stream):
        sock = stream.upstream
        stream.upstream = None
        if sock is None:
            return
        try:
            self._selector.unregister(sock)
        except (KeyError, ValueError):
            pass
        try:
            sock.close()
        except OSError:
            pass

    # -- client side -------------------------------------------------------

    def _client_readable(self, stream):
        """SSE clients never send mid-stream: readable means EOF/RST
        (hung up) or stray bytes we drain and ignore."""
        try:
            data = stream.client.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            self._close_stream(stream, "client-gone")

    def _queue_out(self, stream, block):
        if stream.chunked_out:
            stream.outbuf += ("%x\r\n" % len(block)).encode("latin-1")
            stream.outbuf += block
            stream.outbuf += b"\r\n"
        else:
            stream.outbuf += block
        self._flush_client(stream)

    def _flush_client(self, stream):
        if stream.closed:
            return
        while stream.outbuf:
            try:
                sent = stream.client.send(bytes(stream.outbuf[:65536]))
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close_stream(stream, "client-gone")
                return
            if sent == 0:
                self._close_stream(stream, "client-gone")
                return
            del stream.outbuf[:sent]
        if stream.outbuf:
            self._arm_writable(stream, True)
            if (len(stream.outbuf) >= self.HIGH_WATER
                    and not stream.paused):
                stream.paused = True
                self._arm_upstream(stream, False)
        else:
            self._arm_writable(stream, False)
            if stream.terminal is not None:
                self._close_stream(stream, stream.terminal)
                return
            if stream.paused and len(stream.outbuf) <= self.LOW_WATER:
                stream.paused = False
                self._arm_upstream(stream, True)

    def _arm_writable(self, stream, want):
        if want == stream.writable_armed or stream.closed:
            return
        mask = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if want else 0)
        try:
            self._selector.modify(stream.client, mask, stream)
            stream.writable_armed = want
        except (KeyError, ValueError, OSError):
            pass

    def _arm_upstream(self, stream, want):
        if stream.upstream is None:
            return
        try:
            if want:
                self._selector.register(
                    stream.upstream, selectors.EVENT_READ, stream)
            else:
                self._selector.unregister(stream.upstream)
        except (KeyError, ValueError, OSError):
            pass

    def _close_stream(self, stream, reason):
        if stream.closed:
            return
        stream.closed = True
        self._drop_upstream(stream)
        try:
            self._selector.unregister(stream.client)
        except (KeyError, ValueError):
            pass
        try:
            stream.client.close()
        except OSError:
            pass
        with self._lock:
            self._active -= 1
            self._closed_total += 1
        try:
            stream.relay.on_closed(reason)
        except Exception:  # noqa: BLE001 — adapter cleanup must never
            # take the shared loop (and every other stream) down
            pass
