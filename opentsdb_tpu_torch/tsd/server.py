"""Asyncio server: one port, telnet line protocol + HTTP/1.1, sniffed from
the first byte of each connection.

A slim port of opentsdb_tpu/tsd/server.py (OpenTSDB
src/tsd/PipelineFactory.java:44: ConnectionManager -> DetectHttpOrRpc
:134, the first-byte sniff: an ASCII letter 'A'-'Z' means an HTTP verb,
anything else the telnet line protocol -> framing -> RpcHandler; and
ConnectionManager.java :37-41, the connection limit).  HTTP/1.1 keeps the
connection alive unless the client asks to close; pipelined requests are
answered in order.  Handlers run on a bounded thread pool (the "OpenTSDB
Responder", RpcResponder.java) so device work never blocks the accept
loop.  Every HTTP request carries a cancellation handle
(tsd/admission.py CancellationHandle, the reference's server.py:455-475)
that rpc_manager binds to the request's deadline: while its handler runs,
a read on the idle connection watches for the client hanging up and, on
EOF, flips the token, so a queued query leaves the admission queue
without dispatching.  What a handler leaves to its request's
``after_write`` hooks (its admission permit's release) runs once the reply
is drained to the socket.  Shutdown stops accepting and drains the pool
(queued requests are dropped, running ones finish and their replies are
written); at ``tsd.network.drain_timeout_ms`` it cancels every request
still in flight, gives them ``POST_CANCEL_GRACE_S`` to unwind, and shuts
the TSDB down.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import threading
from concurrent.futures import ThreadPoolExecutor

from opentsdb_tpu_torch.tsd.admission import CancellationHandle, gate_for
from opentsdb_tpu_torch.tsd.http import (
    BadRequestError, HttpResponse, parse_http_head)
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager

LOG = logging.getLogger("tsd.server")

MAX_REQUEST_BYTES = 64 * 1024 * 1024   # HttpRequestDecoder aggregator cap
MAX_TELNET_LINE = 1024 * 1024
# After the drain timeout, cancelled handlers get this long to see their
# token and unwind before the TSDB is shut down regardless.
POST_CANCEL_GRACE_S = 5.0


def _after_write(request, fut) -> None:
    """Run the request's after-write hooks: now when its handler has
    ended (the reply written, or the write failed), else when the handler
    ends (the connection task was torn down under a running handler)."""
    def run(_=None):
        for hook in request.after_write:
            hook()
    if fut is None or fut.done():
        run()
    else:
        fut.add_done_callback(run)


class TelnetConn:
    """Handler-facing handle on one telnet connection."""

    def __init__(self):
        self.close_after_write = False


class TSDServer:
    """The daemon: TSDB + RpcManager + asyncio socket server.  With
    port=0 it serves on an ephemeral port (``port`` holds it once
    ``start`` returns)."""

    def __init__(self, tsdb, port: int = 4242, bind: str = "0.0.0.0",
                 worker_threads: int = 8):
        self.tsdb = tsdb
        self.port = port
        self.bind = bind
        self.rpc_manager = RpcManager(tsdb)
        self.max_connections = tsdb.config.get_int(
            "tsd.core.connections.limit")
        self.idle_timeout = tsdb.config.get_int(
            "tsd.network.keep_alive_timeout")
        self._conn_lock = threading.Lock()
        self._open_connections = 0  # guarded-by: _conn_lock
        # RPCs dispatched whose reply has not hit the socket yet, and the
        # cancellation handles of HTTP requests in flight; touched only
        # on the event-loop thread
        self._inflight_rpcs = 0
        self._active_handles: set = set()
        # the drain's patience before every in-flight token is flipped
        self.drain_grace_s = max(
            tsdb.config.get_int("tsd.network.drain_timeout_ms"), 0) / 1e3
        self._executor = ThreadPoolExecutor(
            max_workers=worker_threads, thread_name_prefix="tsd-responder")
        self._server: asyncio.AbstractServer | None = None
        self._shutdown_event: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

    # -- lifecycle --

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._shutdown_event = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle_connection, self.bind, self.port,
            limit=MAX_TELNET_LINE)
        self.port = self._server.sockets[0].getsockname()[1]
        LOG.info("Ready to serve on %s:%d", self.bind, self.port)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._shutdown_event.wait()
        await self.stop()

    async def stop(self) -> None:
        # stop accepting; the connections still open are waited for only
        # after the drain, and only as long as the replies are (a wedged
        # handler keeps its connection open, and wait_closed waits for
        # every connection)
        server, self._server = self._server, None
        if server is not None:
            server.close()
        # drain the responder pool off the loop, so that the draining
        # handlers' replies can still be written; past the drain timeout
        # cancel every request in flight, so that cooperative handlers
        # (deadline checks, admission waits) unwind, and wait a bounded
        # grace; then wait (bounded) for the last dispatched reply to
        # reach its socket
        loop = asyncio.get_running_loop()
        try:
            drain = loop.run_in_executor(None, functools.partial(
                self._executor.shutdown, wait=True, cancel_futures=True))
            try:
                await asyncio.wait_for(asyncio.shield(drain),
                                       timeout=self.drain_grace_s)
            except asyncio.TimeoutError:
                handles = list(self._active_handles)
                LOG.warning("responder drain exceeded %.1fs; cancelling "
                            "%d in-flight request(s)", self.drain_grace_s,
                            len(handles))
                gate = gate_for(self.tsdb)
                for handle in handles:
                    if handle.cancel("server drain timeout"):
                        gate.count_cancelled("drain_timeout")
                try:
                    await asyncio.wait_for(asyncio.shield(drain),
                                           timeout=POST_CANCEL_GRACE_S)
                except asyncio.TimeoutError:
                    LOG.warning("responder drain still wedged after the "
                                "cancel; shutting the TSDB down (a "
                                "handler ignores its cancellation token)")
            deadline = loop.time() + 5.0
            while self._inflight_rpcs and loop.time() < deadline:
                await asyncio.sleep(0.02)
            if server is not None:
                try:
                    await asyncio.wait_for(
                        server.wait_closed(),
                        timeout=max(deadline - loop.time(), 0.05))
                except asyncio.TimeoutError:
                    LOG.warning("connections still open at shutdown")
        finally:
            self.tsdb.shutdown()
            LOG.info("Server shut down")

    def request_shutdown(self) -> None:
        """Thread-safe shutdown trigger (a signal handler or any thread)."""
        if self._shutdown_event is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(self._shutdown_event.set)

    # -- connection handling --

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        with self._conn_lock:
            if self.max_connections and \
                    self._open_connections >= self.max_connections:
                writer.close()
                return
            self._open_connections += 1
        peer = writer.get_extra_info("peername")
        remote = "%s:%s" % (peer[0], peer[1]) if peer else "unknown"
        try:
            # First-byte sniff (DetectHttpOrRpc :134): HTTP verbs start with
            # an uppercase ASCII letter; telnet commands are lowercase.
            first = await asyncio.wait_for(reader.read(1),
                                           timeout=self.idle_timeout)
            if not first:
                return
            if b"A" <= first <= b"Z":
                await self._serve_http(first, reader, writer, remote)
            else:
                await self._serve_telnet(first, reader, writer)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionResetError, BrokenPipeError):
            pass
        except Exception:
            LOG.exception("Unhandled connection error from %s", remote)
        finally:
            with self._conn_lock:
                self._open_connections -= 1
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass          # the peer is gone: nothing left to close

    async def _dispatch(self, fn, *args):
        """Run a handler on the responder pool."""
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, fn, *args)

    # -- telnet path: one line, one handler call, one reply --

    async def _serve_telnet(self, first: bytes, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        conn = TelnetConn()
        buffer = first
        while True:
            try:
                line = await asyncio.wait_for(reader.readline(),
                                              timeout=self.idle_timeout)
            except ValueError:
                # StreamReader limit (MAX_TELNET_LINE) exceeded
                writer.write(b"error: line too long\n")
                await writer.drain()
                return
            data = buffer + line
            buffer = b""
            if len(data) > MAX_TELNET_LINE:
                writer.write(b"error: line too long\n")
                return
            text = data.decode("utf-8", "replace").strip("\r\n")
            if not text:
                if not line:
                    return
                continue
            self._inflight_rpcs += 1
            try:
                reply = await self._dispatch(self.rpc_manager.handle_telnet,
                                             conn, text)
                if reply:
                    writer.write(reply.encode())
                    await writer.drain()
            finally:
                self._inflight_rpcs -= 1
            if conn.close_after_write or not line:
                return

    # -- HTTP path --

    async def _serve_http(self, first: bytes, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter,
                          remote: str) -> None:
        buffer = first
        while True:
            try:
                head = parse_http_head(buffer)
                while head is None:
                    chunk = await asyncio.wait_for(reader.read(65536),
                                                   timeout=self.idle_timeout)
                    if not chunk:
                        return
                    buffer += chunk
                    if len(buffer) > MAX_REQUEST_BYTES:
                        writer.write(HttpResponse(status=413).to_bytes(False))
                        return
                    head = parse_http_head(buffer)
            except BadRequestError as e:
                # a malformed request line or header block answers 400
                # before the connection closes
                writer.write(HttpResponse(
                    status=e.status,
                    body=e.message.encode()).to_bytes(False))
                await writer.drain()
                return
            request, offset = head
            length = int(request.headers.get("content-length", "0") or 0)
            if length > MAX_REQUEST_BYTES:
                writer.write(HttpResponse(status=413).to_bytes(False))
                return
            body = buffer[offset:offset + length]
            if len(body) < length:
                body += await asyncio.wait_for(
                    reader.readexactly(length - len(body)),
                    timeout=self.idle_timeout)
            request.body = body[:length]
            # bytes past the body begin the next pipelined request
            buffer = buffer[offset + length:] + body[length:]

            self._inflight_rpcs += 1
            # the request's cancellation lever: made here (the loop sees
            # the client hang up), bound to its deadline by rpc_manager
            handle = CancellationHandle()
            request.cancel_handle = handle
            # what the handler leaves to run once its reply is written
            # (its admission permit's release)
            request.after_write = []
            self._active_handles.add(handle)
            watcher = fut = None
            try:
                fut = asyncio.get_running_loop().run_in_executor(
                    self._executor, self.rpc_manager.handle_http, request,
                    remote)
                if not buffer:
                    # while the handler runs, a read on the idle
                    # connection sees the client go away: EOF flips the
                    # token.  Skipped when pipelined bytes are buffered
                    # (the client is alive, and the read would race the
                    # next request).
                    watcher = asyncio.ensure_future(reader.read(65536))
                    await asyncio.wait({fut, watcher},
                                       return_when=asyncio.FIRST_COMPLETED)
                    if watcher.done():
                        try:
                            chunk = watcher.result()
                        except (ConnectionError, OSError):
                            chunk = b""
                        watcher = None
                        if not chunk:
                            if not fut.done() and handle.cancel(
                                    "client disconnected"):
                                gate_for(self.tsdb).count_cancelled(
                                    "client_disconnect")
                        else:
                            # the next pipelined request arrived while
                            # this one ran: keep its bytes
                            buffer = chunk
                query = await fut
                keep_alive = (request.version != "HTTP/1.0"
                              and (request.header("connection")
                                   or "").lower() != "close")
                response = query.response or HttpResponse(status=500)
                writer.write(response.to_bytes(keep_alive))
                await writer.drain()
            finally:
                _after_write(request, fut)
                if watcher is not None:
                    buffer = await self._drain_watcher(watcher, buffer)
                self._active_handles.discard(handle)
                self._inflight_rpcs -= 1
            if not keep_alive:
                return
            if not buffer:
                try:
                    chunk = await asyncio.wait_for(
                        reader.read(65536), timeout=self.idle_timeout)
                except asyncio.TimeoutError:
                    return
                if not chunk:
                    return
                buffer = chunk

    @staticmethod
    async def _drain_watcher(watcher, buffer: bytes) -> bytes:
        """Retire a pending disconnect watcher without losing bytes: a
        read that completed between the handler's end and this cancel
        holds the next pipelined request (the watcher only starts when
        `buffer` is empty, so appending keeps the order)."""
        if not watcher.done():
            watcher.cancel()
        try:
            chunk = await watcher
        except asyncio.CancelledError:
            return buffer
        except (ConnectionError, OSError):
            return buffer
        return buffer + chunk if chunk else buffer
