"""The admin handlers the port serves: version, aggregators, the
latency report, and the telnet `help` and `exit` commands.

Port of those handlers of opentsdb_tpu/tsd/admin_rpcs.py (OpenTSDB
src/tsd/RpcManager.java :585-740: Version, ListAggregators, Help, Exit).
The version payload has the reference's keys (RpcManager.java:660-669,
the BuildData the reference generates at build time), filled for this
package: its name and version, and the git revision of the checkout it
runs from where there is one.  Of the reference's ``DiagRpc``
(admin_rpcs.py:238-260) the port serves ``/api/diag/latency``; the event
ring, the slow-query captures and the health verdicts (``/api/diag``,
``/api/diag/slow``, ``/api/diag/health``) answer 501 until the flight
recorder is ported (ROADMAP A, slice 8d).
"""

from __future__ import annotations

import functools
import os
import socket
import subprocess

from opentsdb_tpu_torch import __version__
from opentsdb_tpu_torch.ops.aggregators import agg_names
from opentsdb_tpu_torch.tsd.http import (BadRequestError, HttpQuery,
                                         NotPortedError)
from opentsdb_tpu_torch.tsd.rpcs import HttpRpc, TelnetRpc, allowed_methods

REPO = "opentsdb_tpu_torch"


@functools.lru_cache(maxsize=1)
def _revision() -> str:
    """The checkout's git revision, or "unknown" outside a checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        rev = subprocess.run(["git", "-C", root, "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=2)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return rev.stdout.strip() if rev.returncode == 0 else "unknown"


def version_map() -> dict[str, str]:
    """The /api/version payload."""
    full = _revision()
    return {
        "version": __version__,
        "short_revision": full[:7] if full != "unknown" else full,
        "full_revision": full,
        "timestamp": "0",
        "repo_status": "MODIFIED",
        "user": "tsdb",
        "host": socket.gethostname(),
        "repo": REPO,
        "branch": "main",
    }


def version_lines() -> str:
    """The telnet `version` answer (revision line, build line)."""
    v = version_map()
    return ("%s %s built from revision %s (%s)\nBuilt on %s by %s@%s\n"
            % (REPO, v["version"], v["short_revision"], v["repo_status"],
               v["timestamp"], v["user"], v["host"]))


class VersionRpc(TelnetRpc, HttpRpc):
    def execute_telnet(self, tsdb, conn, words) -> str:
        return version_lines()

    def execute_http(self, tsdb, query: HttpQuery) -> None:
        allowed_methods(query, "GET", "POST")
        version = version_map()
        if query.api_version > 0:
            query.send_reply(query.serializer.format_version_v1(version))
        elif query.request.uri.endswith("json"):
            query.send_reply(version)
        else:
            query.send_reply(version_lines(), content_type="text/plain")


class ListAggregators(HttpRpc):
    def execute_http(self, tsdb, query: HttpQuery) -> None:
        allowed_methods(query, "GET", "POST")
        names = agg_names()
        if query.api_version > 0:
            query.send_reply(query.serializer.format_aggregators_v1(names))
        else:
            query.send_reply(names)


class HelpRpc(TelnetRpc):
    def __init__(self, commands):
        self.commands = commands

    def execute_telnet(self, tsdb, conn, words) -> str:
        return ("available commands: "
                + " ".join(sorted(self.commands())) + "\n")


class ExitRpc(TelnetRpc):
    def execute_telnet(self, tsdb, conn, words) -> str | None:
        conn.close_after_write = True
        return "exiting\n"


class DiagRpc(HttpRpc):
    """``GET /api/diag/latency``: the always-on per-phase latency profiles
    (obs/latattr.py), ``?since=<seq>`` for the profiles touched after a
    sequence number, ``?fingerprint=`` and ``?tenant=`` to narrow to one
    key; 404 with ``tsd.latattr.enable`` off."""

    def execute_http(self, tsdb, query: HttpQuery) -> None:
        allowed_methods(query, "GET")
        sub = query.api_subpath()
        endpoint = sub[0] if sub else ""
        if endpoint != "latency":
            raise NotPortedError(
                "/api/diag%s is not ported yet (ROADMAP A, slice 8d "
                "(observability))" % ("/" + endpoint if endpoint else ""))
        engine = tsdb.latattr
        if engine is None:
            raise BadRequestError("Latency attribution is disabled",
                                  status=404,
                                  details="Set tsd.latattr.enable=true")
        raw = query.get_query_string_param("since")
        try:
            since = int(raw) if raw else 0
        except ValueError:
            raise BadRequestError("'since' must be an integer sequence "
                                  "number")
        query.send_reply(engine.report(
            since=since,
            fingerprint=query.get_query_string_param("fingerprint"),
            tenant=query.get_query_string_param("tenant")))
