"""RPC route table: command/path -> handler, per operation mode.

Port of opentsdb_tpu/tsd/rpc_manager.py (OpenTSDB
src/tsd/RpcManager.java :251-364 initializeBuiltinRpcs, the route list per
READWRITE / READONLY / WRITEONLY mode behind tsd.core.enable_api, and
RpcHandler.java dispatch) for the routes the port serves, with the
uniform error envelope and the 404 "Page not found".  Every HTTP request
gets one Deadline (``_mint_deadline``, the reference's :288): the smaller
of ``tsd.query.timeout`` and the client's ``X-TSDB-Deadline-Ms``, made the
responder thread's ambient deadline for the request and bound to the
server's cancellation handle, so a client that hangs up flips its token.
With ``tsd.trace.enable`` each request gets a span tree rooted here
(obs/trace.py; an ``X-TSDB-Trace-Id`` header names it), and with
``tsd.latattr.enable`` its phase stamps (obs/latattr.py, the reference's
:251), folded into the TSDB's latency profiles after the trailing
"flush" mark.  Not ported: authentication, CORS, plugins, the
query-stats registry, the flight recorder and the UI routes (ROADMAP A,
slices 8d and 10 on).
"""

from __future__ import annotations

import logging
import math

from opentsdb_tpu_torch.obs import latattr
from opentsdb_tpu_torch.obs import trace as obs_trace
from opentsdb_tpu_torch.query import limits
from opentsdb_tpu_torch.query.limits import QueryException
from opentsdb_tpu_torch.tsd import admin_rpcs, admission, rpcs
from opentsdb_tpu_torch.tsd.http import (BadRequestError, HttpQuery,
                                         HttpRequest, NotPortedError,
                                         error_status)
from opentsdb_tpu_torch.tsd.serializers import serializer_for

LOG = logging.getLogger("tsd.rpc")


class RpcManager:
    """Builds and owns the telnet + HTTP route tables."""

    def __init__(self, tsdb):
        self.tsdb = tsdb
        self.telnet_commands: dict[str, rpcs.TelnetRpc] = {}
        self.http_commands: dict[str, rpcs.HttpRpc] = {}
        self._initialize_builtin_rpcs()

    def _initialize_builtin_rpcs(self) -> None:
        cfg = self.tsdb.config
        mode = self.tsdb.mode             # rw / ro / wo
        enable_api = cfg.get_bool("tsd.core.enable_api")
        telnet = self.telnet_commands
        http = self.http_commands

        version = admin_rpcs.VersionRpc()
        telnet["version"] = version
        telnet["exit"] = admin_rpcs.ExitRpc()
        telnet["help"] = admin_rpcs.HelpRpc(lambda: self.telnet_commands)
        if enable_api:
            http["api/aggregators"] = admin_rpcs.ListAggregators()
            http["api/version"] = version

        if mode in ("rw", "wo"):
            put = rpcs.PutDataPointRpc()
            rollups = rpcs.RollupDataPointRpc()
            histos = rpcs.HistogramDataPointRpc()
            telnet["put"] = put
            telnet["rollup"] = rollups
            telnet["histogram"] = histos
            if enable_api:
                http["api/put"] = put
                http["api/rollup"] = rollups
                http["api/histogram"] = histos
        if mode in ("rw", "ro") and enable_api:
            http["api/query"] = rpcs.QueryRpc()
        if enable_api:
            http["api/diag"] = admin_rpcs.DiagRpc()

    # -- dispatch (RpcHandler.messageReceived :125) --

    def handle_telnet(self, conn, line: str) -> str | None:
        words = line.split()
        if not words:
            return None
        handler = self.telnet_commands.get(words[0])
        if handler is None:
            return "unknown command: %s.  Try `help'.\n" % words[0]
        return handler.execute_telnet(self.tsdb, conn, words)

    def handle_http(self, request: HttpRequest,
                    remote: str = "unknown") -> HttpQuery:
        """Route one request under its own Deadline, active for the
        request (``limits.active_deadline``) and bound to the server's
        cancellation handle when the request carries one; inside its
        trace and phase stamps when those are on."""
        cfg = self.tsdb.config
        trace = None
        if cfg.get_bool("tsd.trace.enable"):
            trace = obs_trace.Trace(
                "http", trace_id=request.header(obs_trace.TRACE_HEADER),
                device_time=cfg.get_bool("tsd.trace.device_time"))
            trace.root.tags["method"] = request.method
            trace.root.tags["path"] = request.path
            obs_trace.activate(trace)
        deadline = self._mint_deadline(request)
        limits.activate_deadline(deadline)
        handle = getattr(request, "cancel_handle", None)
        if handle is not None:
            handle.bind(deadline)
        stamps = None
        if self.tsdb.latattr is not None:
            stamps = latattr.PhaseStamps(
                trace_id=trace.trace_id if trace is not None else None)
            latattr.activate(stamps)
        try:
            query = self._dispatch_http(request, remote)
        finally:
            limits.deactivate_deadline()
            if stamps is not None:
                latattr.deactivate()
            if trace is not None:
                obs_trace.deactivate()
                trace.finish()
        if stamps is not None:
            # the trailing mark takes the handler's tail, so the phases
            # sum to the handler's wall time; the route label is clamped
            # to the route table
            stamps.mark("flush")
            route = query.base_route()
            stamps.route = route if route in self.http_commands else "other"
            self.tsdb.latattr.observe(stamps)
        return query

    def _mint_deadline(self, request: HttpRequest) -> limits.Deadline:
        """min(tsd.query.timeout, X-TSDB-Deadline-Ms); 0 or absent on both
        sides mints an unbounded deadline, still a cancellation token.  A
        header that does not parse, or parses to a non-finite number,
        counts as absent."""
        timeout_ms = float(self.tsdb.config.get_int("tsd.query.timeout"))
        raw = request.header(admission.DEADLINE_HEADER)
        if raw:
            try:
                client_ms = float(raw)
            except ValueError:
                client_ms = 0.0
            if not math.isfinite(client_ms):
                client_ms = 0.0
            if client_ms > 0:
                timeout_ms = (min(timeout_ms, client_ms)
                              if timeout_ms > 0 else client_ms)
        return limits.Deadline(max(timeout_ms, 0.0))

    def _dispatch_http(self, request: HttpRequest,
                       remote: str = "unknown") -> HttpQuery:
        """Route one request; every failure becomes the error envelope."""
        query = HttpQuery(self.tsdb, request, remote)
        try:
            query.serializer = serializer_for(query)
            handler = self.http_commands.get(query.base_route())
            if handler is None:
                raise BadRequestError(
                    "Page not found", status=404,
                    details="The requested page [%s] was not found"
                            % request.path)
            handler.execute_http(self.tsdb, query)
            if query.response is None:
                raise RuntimeError("handler sent no response")
        except Exception as e:  # uniform error envelope
            if error_status(e) >= 500 and not isinstance(
                    e, (QueryException, NotPortedError)):
                # an internal failure gets the full trace in the log;
                # client mistakes and deliberate verdicts (a 413, the
                # port's "not ported yet" 501s) stay quiet
                LOG.exception("handler for [%s] from %s failed with an "
                              "internal error", request.path, remote)
            query.send_error(e)
        return query
