"""The port's daemon front end against the reference's.

One request sequence goes to both packages' RpcManager.handle_http /
handle_telnet, each over its own TSDB (the port's on ``device="cpu"``);
every answer must have the same status and the same parsed JSON, apart
from statsSummary's queryTime (a wall clock).  Stack traces are off in
both configs: a trace names each package's own files.  Then the port's
TSDServer on an ephemeral port: HTTP keep-alive and pipelining, telnet
lines, and a 400 for a malformed request line, each socket with its own
timeout and each server stopped in ``finally``.
"""

import asyncio
import base64
import json
import socket
import threading

import pytest

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.histogram import SimpleHistogram as RefHistogram
from opentsdb_tpu.tsd import http as ref_http
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.tools import tsd_main
from opentsdb_tpu_torch.tsd import http as port_http
from opentsdb_tpu_torch.tsd.http import HttpRequest
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
from opentsdb_tpu_torch.tsd.server import TSDServer
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400
HIST_CONFIG = '{"SimpleHistogramDecoder": 0}'
PROPS = {"tsd.core.auto_create_metrics": True,
         "tsd.core.histograms.config": HIST_CONFIG,
         "tsd.http.show_stack_trace": False}


class _Conn:
    close_after_write = False


def _managers(**props):
    ref = RefTSDB(RefConfig({**PROPS, "tsd.query.mesh.enable": False,
                             **props}))
    port = TSDB(Config({**PROPS, **props}), device="cpu")
    return RefManager(ref), RpcManager(port)


def _b64(buckets: dict) -> str:
    h = RefHistogram(0)
    for (lo, hi), c in buckets.items():
        h.add_bucket(lo, hi, c)
    return base64.b64encode(h.to_bytes(include_id=False)).decode()


def _puts():
    out = []
    for i in range(12):
        for host in ("web01", "web02"):
            out.append({"metric": "sys.cpu", "timestamp": BASE + 30 * i,
                        "value": i * (2 if host == "web02" else 1),
                        "tags": {"host": host, "dc": "lga"}})
    return out


def _histograms():
    out = []
    for i in range(8):
        for host in ("a", "b", "c"):
            out.append({"metric": "svc.lat", "timestamp": BASE + 60 * i,
                        "buckets": {"0,10": 30 + i, "10,20": 50 - i,
                                    "20,100": 20 + (host == "c") * 7},
                        "tags": {"host": host}})
    return out


_Q = "start=%d&end=%d" % (BASE - 10, BASE + 600)
# (kind, method or telnet line, uri, JSON body)
SEQUENCE = [
    ("http", "POST", "/api/put?details", _puts()[:12]),
    ("http", "POST", "/api/put?summary", _puts()[12:]),
    ("http", "POST", "/api/put", [{"metric": "sys.cpu", "timestamp": BASE,
                                   "tags": {"host": "web01"}}]),
    ("http", "POST", "/api/put?details", [
        {"metric": "sys.cpu", "timestamp": BASE + 999, "value": 1,
         "tags": {"host": "web03"}},
        {"metric": "sys.cpu", "timestamp": BASE + 999, "value": "abc",
         "tags": {"host": "web03"}},
        {"metric": "sys.cpu", "timestamp": BASE + 999, "value": 2,
         "tags": {}}]),
    ("http", "POST", "/api/put", "{not json"),
    ("http", "GET", "/api/put", None),
    ("http", "POST", "/api/histogram", _histograms()),
    ("http", "POST", "/api/histogram?details", [
        {"metric": "svc.lat", "timestamp": BASE + 999,
         "tags": {"host": "a"}},
        {"metric": "svc.lat", "timestamp": BASE + 999,
         "buckets": {"0,10": 1}, "tags": {"host": "a"}}]),
    ("telnet", "histogram 0 svc.lat %d %s host=d" % (
        BASE + 60, _b64({(0.0, 10.0): 5, (20.0, 100.0): 9})), None, None),
    ("telnet", "histogram 0 svc.lat %d" % BASE, None, None),
    ("telnet", "put sys.cpu %d 7 host=web04 dc=lga" % (BASE + 30), None,
     None),
    ("telnet", "put sys.cpu %d x host=web04" % BASE, None, None),
    ("telnet", "put sys.cpu", None, None),
    ("telnet", "nosuchcommand 1 2", None, None),
    ("http", "GET", "/api/query?%s&m=sum:percentiles[50,99]:svc.lat{host=*}"
                    "&show_summary" % _Q, None),
    ("http", "GET", "/api/query?%s&m=sum:1m-sum:percentiles[90]:svc.lat"
                    % _Q, None),
    ("http", "GET", "/api/query?%s&m=sum:show-histogram-buckets:svc.lat"
                    "{host=a|d}" % _Q, None),
    ("http", "POST", "/api/query", {
        "start": BASE - 10, "end": BASE + 600, "showSummary": True,
        "queries": [
            {"aggregator": "sum", "metric": "svc.lat",
             "percentiles": [50, 99.9], "downsample": "2m-sum",
             "filters": [{"type": "wildcard", "tagk": "host",
                          "filter": "*", "groupBy": True}]},
            {"aggregator": "sum", "metric": "sys.cpu",
             "downsample": "1m-avg", "tags": {"host": "*"}},
            {"aggregator": "max", "metric": "sys.cpu"}]}),
    ("http", "GET", "/api/query?%s&m=sum:1m-avg:sys.cpu{host=*}" % _Q,
     None),
    ("http", "GET", "/api/query?%s&m=sum:sys.cpu{dc=lga}" % _Q, None),
    ("http", "GET", "/api/query?%s&m=sum:no.such.metric" % _Q, None),
    ("http", "GET", "/api/query?m=sum:sys.cpu", None),
    ("http", "GET", "/api/query?%s&m=bogus:sys.cpu" % _Q, None),
    ("http", "POST", "/api/query", {"start": BASE, "queries": []}),
    ("http", "DELETE", "/api/query?%s&m=sum:sys.cpu" % _Q, None),
    ("http", "POST", "/api/query", {
        "start": BASE - 10, "end": BASE + 600, "delete": True,
        "queries": [{"aggregator": "sum", "metric": "sys.cpu"}]}),
    ("http", "GET", "/api/aggregators", None),
    ("http", "GET", "/api/v1/aggregators", None),
    ("http", "GET", "/api/nosuch", None),
    ("http", "GET", "/api/query?%s&m=sum:sys.cpu&serializer=xml" % _Q, None),
]


def _send(manager, request_cls, step):
    kind, method, uri, body = step
    if kind == "telnet":
        return manager.handle_telnet(_Conn(), method)
    data = body.encode() if isinstance(body, str) else (
        json.dumps(body).encode() if body is not None else b"")
    q = manager.handle_http(request_cls(
        method=method, uri=uri, body=data,
        headers={"content-type": "application/json"}))
    r = q.response
    payload = json.loads(r.body) if r.body else None
    if isinstance(payload, list):
        for entry in payload:
            if isinstance(entry, dict):
                entry.get("statsSummary", {}).pop("queryTime", None)
    return r.status, payload


def test_request_sequence_answers_as_the_reference():
    ref, port = _managers()
    for step in SEQUENCE:
        want = _send(ref, RefRequest, step)
        got = _send(port, HttpRequest, step)
        assert got == want, step[:3]
    # every write landed in both, and both count them
    assert port.tsdb.datapoints_added == ref.tsdb.datapoints_added
    assert port.tsdb.histogram_store.num_series \
        == ref.tsdb.histogram_store.num_series == 4


def test_version_has_the_reference_keys():
    """/api/version: the reference's keys; the values that name the
    package (version, repo) are this package's, the rest agree."""
    ref, port = _managers()
    step = ("http", "GET", "/api/version", None)
    (rs, want), (ps, got) = _send(ref, RefRequest, step), \
        _send(port, HttpRequest, step)
    assert rs == ps == 200
    assert set(got) == set(want)
    assert got["repo"] == "opentsdb_tpu_torch"
    for key in set(want) - {"version", "repo"}:
        assert got[key] == want[key], key
    assert port.handle_telnet(_Conn(), "version").startswith(
        "opentsdb_tpu_torch ")


def test_not_ported_query_endpoints_answer_501():
    _, port = _managers(**{"tsd.http.query.allow_delete": True})
    for uri in ("/api/query/last?timeseries=sys.cpu",
                "/api/query/exp", "/api/query/gexp?start=1h-ago&exp=x"):
        status, body = _send(port, HttpRequest, ("http", "GET", uri, None))
        assert status == 501, uri
        assert "ROADMAP" in body["error"]["details"]
    # explain is served since slice 8c
    for step in SEQUENCE[:3]:
        _send(port, HttpRequest, step)
    status, body = _send(port, HttpRequest, (
        "http", "GET", "/api/query/explain?%s&m=sum:1m-avg:sys.cpu" % _Q,
        None))
    assert status == 200, body
    assert body["subQueries"][0]["segments"][0]["path"] in (
        "resident", "batched")
    # deleting through a query is allowed by the config, but not ported
    status, body = _send(port, HttpRequest, (
        "http", "DELETE", "/api/query?%s&m=sum:sys.cpu" % _Q, None))
    assert status == 501 and "ROADMAP A, slices 10 on (admin and data " \
        "endpoints)" in body["error"]["details"]


def _roadmap_slices() -> set[str]:
    """The queue-A slice headings of ROADMAP.md, as a 501 names them:
    "A, slice 8c", "A, slices 10 on"."""
    import os
    import re
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ROADMAP.md")
    with open(path) as fh:
        text = fh.read()
    return {"A, s" + m.group(1).lower()
            for m in re.finditer(r"^\d+\. \*\*S(lices? [0-9a-z]+(?: on)?)",
                                 text, re.M)}


def test_not_ported_501s_name_existing_roadmap_slices():
    """Fault C4: each 501 named a ROADMAP item (A4, A6, A9) from before
    queue A had numbered slices; every 501 now names a slice heading that
    ROADMAP.md has."""
    slices = _roadmap_slices()
    assert "A, slice 8c" in slices and "A, slices 10 on" in slices
    _, port = _managers(**{"tsd.http.query.allow_delete": True})
    sends = [("GET", uri) for uri in (
        "/api/query/last?timeseries=sys.cpu", "/api/query/exp",
        "/api/query/gexp?start=1h-ago&exp=x",
        "/api/diag", "/api/diag/slow", "/api/diag/health")]
    sends.append(("DELETE", "/api/query?%s&m=sum:sys.cpu" % _Q))
    for method, uri in sends:
        status, body = _send(port, HttpRequest, ("http", method, uri, None))
        assert status == 501, uri
        details = body["error"]["details"]
        named = details.split("ROADMAP ", 1)[1].split(" (", 1)[0]
        assert named in slices, (uri, details)


@pytest.mark.parametrize("mode", ["ro", "wo"])
def test_mode_route_tables_match_the_reference(mode):
    ref, port = _managers(**{"tsd.mode": mode})
    for uri, method in (("/api/put", "POST"), ("/api/histogram", "POST"),
                        ("/api/query?%s&m=sum:sys.cpu" % _Q, "GET")):
        step = ("http", method, uri, _puts()[:1])
        assert _send(port, HttpRequest, step)[0] \
            == _send(ref, RefRequest, step)[0], (mode, uri)
    for line in ("put sys.cpu %d 1 host=a" % BASE,
                 "histogram 0 svc.lat %d %s host=a"
                 % (BASE, _b64({(0.0, 1.0): 1}))):
        assert port.handle_telnet(_Conn(), line) \
            == ref.handle_telnet(_Conn(), line), (mode, line)


def test_read_only_tsdb_rejects_writes():
    """tsd.mode=ro: every write path refuses after validation, as the
    reference's TSDB does."""
    ref, port = _managers(**{"tsd.mode": "ro"})
    for tsdb in (ref.tsdb, port.tsdb):
        with pytest.raises(RuntimeError, match="read-only"):
            tsdb.add_point("sys.cpu", BASE, 1, {"host": "a"})
        with pytest.raises(RuntimeError, match="read-only"):
            tsdb.add_histogram_point_json("svc.lat", BASE,
                                          {"buckets": {"0,1": 1}},
                                          {"host": "a"})
        ok, errors = tsdb.add_points_bulk(_puts()[:2] + [{"metric": "x"}])
        assert ok == 0
        assert [type(e) for _, e in errors] \
            == [RuntimeError, RuntimeError, ValueError]


def test_malformed_request_line_is_a_400_in_both():
    for mod in (ref_http, port_http):
        with pytest.raises(mod.BadRequestError) as info:
            mod.parse_http_head(b"GARBAGE\r\n\r\n")
        assert info.value.status == 400
        assert "Malformed request line" in info.value.message
        assert mod.parse_http_head(b"GET / HTTP/1.1\r\nHost: x") is None


def test_tsd_main_needs_a_card_or_a_port(monkeypatch):
    assert tsd_main.main(["--mode", "ro"]) == 1     # no port configured
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsd_main.main(["--port", "0", "--auto-metric"])


# -- the port's server on a socket ---------------------------------------


class _Serving:
    """A TSDServer on 127.0.0.1:<ephemeral> in a thread of its own."""

    def __init__(self, tsdb):
        self.server = TSDServer(tsdb, port=0, bind="127.0.0.1",
                                worker_threads=2)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.server.start(),
                                         self.loop).result(timeout=10)
        return self.server

    def __exit__(self, *exc):
        try:
            asyncio.run_coroutine_threadsafe(self.server.stop(),
                                             self.loop).result(timeout=10)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.loop.close()


def _read_response(sock, buf: bytes):
    """One HTTP response from `sock` (status, JSON body), and the bytes
    after it."""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        assert chunk, "connection closed mid-response"
        buf += chunk
    head, rest = buf.split(b"\r\n\r\n", 1)
    lines = head.decode().split("\r\n")
    headers = dict(l.lower().split(": ", 1) for l in lines[1:])
    length = int(headers["content-length"])
    while len(rest) < length:
        chunk = sock.recv(65536)
        assert chunk, "connection closed mid-body"
        rest += chunk
    body = rest[:length]
    return (int(lines[0].split()[1]), headers,
            json.loads(body) if body else None), rest[length:]


def _port_tsdb():
    return TSDB(Config(PROPS), device="cpu")


def test_http_keep_alive_and_pipelining_on_the_socket():
    with _Serving(_port_tsdb()) as server:
        with socket.create_connection(("127.0.0.1", server.port)) as sock:
            sock.settimeout(10)
            put = json.dumps(_histograms()).encode()
            sock.sendall(b"POST /api/histogram HTTP/1.1\r\nContent-Length: "
                         + str(len(put)).encode() + b"\r\n\r\n" + put)
            (status, headers, _), rest = _read_response(sock, b"")
            assert status == 204 and headers["connection"] == "keep-alive"
            # two pipelined requests on the same connection, in one write
            uri = ("/api/query?%s&m=sum:percentiles[50]:svc.lat{host=*}"
                   % _Q).encode()
            sock.sendall(b"GET " + uri + b" HTTP/1.1\r\n\r\n"
                         b"GET /api/aggregators HTTP/1.1\r\n"
                         b"Connection: close\r\n\r\n")
            (status, _, body), rest = _read_response(sock, rest)
            assert status == 200
            assert [r["metric"] for r in body] == ["svc.lat_pct_50.0"] * 3
            assert body[0]["dps"][str(BASE)] == 15.0
            (status, headers, body), rest = _read_response(sock, rest)
            assert status == 200 and "sum" in body
            assert headers["connection"] == "close"
            assert rest == b"" and sock.recv(1) == b""


def test_telnet_lines_on_the_socket():
    tsdb = _port_tsdb()
    with _Serving(tsdb) as server:
        with socket.create_connection(("127.0.0.1", server.port)) as sock:
            sock.settimeout(10)
            sock.sendall(("put sys.cpu %d 5 host=a\n"
                          "histogram 0 svc.lat %d %s host=a\n"
                          "put sys.cpu %d x host=a\n"
                          "exit\n" % (BASE, BASE,
                                      _b64({(0.0, 10.0): 3}), BASE))
                         .encode())
            out = b""
            while True:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                out += chunk
    assert out.decode() == "put: Invalid value: 'x'\nexiting\n"
    assert tsdb.store.total_datapoints == 1
    assert tsdb.histogram_store.num_series == 1


def test_malformed_request_line_on_the_socket():
    with _Serving(_port_tsdb()) as server:
        with socket.create_connection(("127.0.0.1", server.port)) as sock:
            sock.settimeout(10)
            sock.sendall(b"GARBAGE\r\n\r\n")
            out = b""
            while True:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                out += chunk
    assert out.startswith(b"HTTP/1.1 400 Bad Request\r\n")
    assert out.endswith(b"Malformed request line: 'GARBAGE'")
