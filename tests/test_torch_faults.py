"""The port's repaired faults (ROADMAP C1-C3), each against what the
reference does.

C1: a reference key whose subsystem the port lacks, set away from its
default, is refused by TSDB(config) and by tools/tsd_main.py with the
ROADMAP item that ports it; keys that change no answer stay ignored, and
the rollup keys this port serves are accepted.  C2: a negative histogram
count, which SimpleHistogram.from_pojo stores in both packages, is added
by H1 as the reference's segment sum adds it, so later queries answer as
the reference's do, through both RpcManagers.  C3: the port's "not ported
yet" 501s are not logged as internal failures; a real internal failure
still is.
"""

import json
import logging
import re

import pytest

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.tools import tsd_main
from opentsdb_tpu_torch.tsd import rpcs as port_rpcs
from opentsdb_tpu_torch.tsd.http import HttpRequest
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400
HIST_CONFIG = '{"SimpleHistogramDecoder": 0}'


# -- C1: unported keys are refused, not ignored -----------------------------


@pytest.mark.parametrize("key, value, item", [
    ("tsd.storage.directory", "/var/lib/tsdb", "slice 7 (durability)"),
    ("tsd.query.limits.data_points.default", 5, "slice 7 (query budgets)"),
    ("tsd.query.limits.bytes.default", 1 << 20, "slice 7 (query budgets)"),
    ("tsd.query.limits.overrides.config", "/etc/limits.json",
     "slice 7 (query budgets)"),
    ("tsd.query.limits.data_points.allow_override", True,
     "slice 7 (query budgets)"),
    ("tsd.query.timeout", 1500, "slice 7 (query budgets)"),
    ("tsd.network.cluster.peers", "127.0.0.1:4243", "slice 9 (the cluster)"),
    ("tsd.network.cluster.shard.enable", "yes", "slice 9 (the cluster)"),
    ("tsd.network.cluster.breaker.threshold", 3, "slice 9 (the cluster)"),
])
def test_unported_keys_are_refused(key, value, item):
    with pytest.raises(ValueError,
                       match=re.escape("ROADMAP A, " + item)) as info:
        TSDB(Config({key: value}), device="cpu")
    assert key in str(info.value)


def test_the_two_reproduced_cases_are_refused():
    """The two cases ROADMAP C1 reproduced: the reference writes a WAL
    under tsd.storage.directory and answers 413 over a 5-point limit;
    the port refuses both configs rather than ignore them."""
    for props in ({"tsd.storage.directory": "/tmp/tsdb-wal"},
                  {"tsd.query.limits.data_points.default": "5"}):
        with pytest.raises(ValueError, match="not supported"):
            TSDB(Config({"tsd.core.auto_create_metrics": True, **props}),
                 device="cpu")


@pytest.mark.parametrize("props", [
    {"tsd.storage.directory": "", "tsd.query.timeout": "0"},
    {"tsd.query.limits.overrides.interval": "60000",
     "tsd.query.limits.bytes.allow_override": "false",
     "tsd.network.cluster.shard.enable": "0"},
    # TPU strategy keys and the aggregate cache change no answer
    {"tsd.query.mesh.enable": False, "tsd.query.mesh.min_series": 2,
     "tsd.query.kernel.scan_mode": "matmul", "tsd.query.cache.enable": True,
     "tsd.query.cache.mb": 4},
    # the rollup keys this port serves
    {"tsd.rollups.enable": True, "tsd.rollups.split_query.enable": True,
     "tsd.rollup.enable": True, "tsd.rollup.mb": 16},
])
def test_defaults_ignored_and_ported_keys_are_accepted(props):
    tsdb = TSDB(Config(props), device="cpu")
    if props.get("tsd.rollups.enable"):
        assert tsdb.rollup_store is not None
        assert tsdb.rollup_lanes is not None


def test_tsd_main_refuses_an_unported_key(tmp_path, capsys):
    conf = tmp_path / "tsd.conf"
    conf.write_text("tsd.network.port = 4242\n"
                    "tsd.query.limits.data_points.default = 5\n")
    assert tsd_main.main(["--config", str(conf)]) == 1
    assert "tsd.query.limits.data_points.default" in capsys.readouterr().err


# -- C2: a negative histogram count answers as the reference's --------------


def _managers():
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.core.histograms.config": HIST_CONFIG,
             "tsd.http.show_stack_trace": False}
    return (RefManager(RefTSDB(RefConfig({**props,
                                          "tsd.query.mesh.enable": False}))),
            RpcManager(TSDB(Config(props), device="cpu")))


def _http(manager, request_cls, method, uri, body=None):
    q = manager.handle_http(request_cls(
        method=method, uri=uri,
        body=json.dumps(body).encode() if body is not None else b"",
        headers={"content-type": "application/json"}))
    return q.response.status, (json.loads(q.response.body)
                               if q.response.body else None)


def test_negative_histogram_count_answers_as_the_reference():
    """POST /api/histogram with {"0,10": -1} answers 200 in both, and the
    percentile queries after it answer as the reference's, alone and
    beside other histograms of the metric."""
    steps = [
        ("POST", "/api/histogram?details", [
            {"metric": "svc.lat", "timestamp": BASE,
             "buckets": {"0,10": -1}, "tags": {"host": "a"}}]),
        ("GET", "/api/query?start=%d&end=%d&m=sum:percentiles[50,99]:"
                "svc.lat{host=*}" % (BASE - 10, BASE + 600), None),
        ("POST", "/api/histogram", [
            {"metric": "svc.lat", "timestamp": BASE + 60 * i,
             "buckets": {"0,10": 3 + i, "10,20": 5, "20,100": -2},
             "tags": {"host": h}} for i in range(4) for h in "ab"]),
        ("GET", "/api/query?start=%d&end=%d&m=sum:percentiles[50,99]:"
                "svc.lat{host=*}" % (BASE - 10, BASE + 600), None),
        ("GET", "/api/query?start=%d&end=%d&m=sum:2m-sum:percentiles[10,90]:"
                "svc.lat" % (BASE - 10, BASE + 600), None),
    ]
    ref, port = _managers()
    for method, uri, body in steps:
        want = _http(ref, RefRequest, method, uri, body)
        got = _http(port, HttpRequest, method, uri, body)
        assert got == want, uri
        assert got[0] in (200, 204), got


# -- C3: the 501s of unported endpoints are not internal failures ----------


def test_not_ported_501_is_not_logged_as_an_internal_error(caplog):
    _, port = _managers()
    with caplog.at_level(logging.DEBUG, logger="tsd.rpc"):
        for uri in ("/api/query/last?timeseries=svc.lat",
                    "/api/query/exp",
                    "/api/query/explain?start=1h-ago&m=sum:svc.lat"):
            status, body = _http(port, HttpRequest, "GET", uri)
            assert status == 501 and "ROADMAP" in body["error"]["details"]
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR]


def test_an_internal_failure_is_still_logged(caplog, monkeypatch):
    def broken(self, tsdb, query):
        raise RuntimeError("boom")

    monkeypatch.setattr(port_rpcs.QueryRpc, "handle_query", broken)
    _, port = _managers()
    with caplog.at_level(logging.DEBUG, logger="tsd.rpc"):
        status, _ = _http(port, HttpRequest, "GET",
                          "/api/query?start=1h-ago&m=sum:svc.lat")
    assert status == 500
    errors = [r for r in caplog.records if r.levelno >= logging.ERROR]
    assert len(errors) == 1 and errors[0].exc_info is not None
