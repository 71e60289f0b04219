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
loop.  Shutdown stops accepting, drains the pool (queued requests are
dropped, running ones finish and their replies are written) and then shuts
the TSDB down; with no request deadline ported there is nothing to cancel
a running handler early.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import threading
from concurrent.futures import ThreadPoolExecutor

from opentsdb_tpu_torch.tsd.http import (
    BadRequestError, HttpResponse, parse_http_head)
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager

LOG = logging.getLogger("tsd.server")

MAX_REQUEST_BYTES = 64 * 1024 * 1024   # HttpRequestDecoder aggregator cap
MAX_TELNET_LINE = 1024 * 1024


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
        # RPCs dispatched whose reply has not hit the socket yet; touched
        # only on the event-loop thread
        self._inflight_rpcs = 0
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
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # drain the responder pool off the loop, so that the draining
        # handlers' replies can still be written, then wait (bounded)
        # for the last dispatched reply to reach its socket
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, functools.partial(
                self._executor.shutdown, wait=True, cancel_futures=True))
            deadline = loop.time() + 5.0
            while self._inflight_rpcs and loop.time() < deadline:
                await asyncio.sleep(0.02)
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
            try:
                query = await self._dispatch(self.rpc_manager.handle_http,
                                             request, remote)
                keep_alive = (request.version != "HTTP/1.0"
                              and (request.header("connection")
                                   or "").lower() != "close")
                response = query.response or HttpResponse(status=500)
                writer.write(response.to_bytes(keep_alive))
                await writer.drain()
            finally:
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
