"""The port's repaired faults (ROADMAP C1-C3) and its deliberate
differences, each against what the reference does.

C1: a reference key whose subsystem the port lacks, set away from its
default, is refused by TSDB(config) and by tools/tsd_main.py with the
ROADMAP item that ports it; the scan budget and timeout keys, ported
since, are honoured; keys that change no answer stay ignored, and the
rollup keys this port serves are accepted.  C2: a negative histogram
count, which SimpleHistogram.from_pojo stores in both packages, is added
by H1 as the reference's segment sum adds it, so later queries answer as
the reference's do, through both RpcManagers.  C3: the port's "not ported
yet" 501s are not logged as internal failures; a real internal failure
still is.  A grouped plan whose streaming state is over
tsd.query.streaming.state_mb is served by tiling in both packages (a
deliberate difference until slice 7b).
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


# -- C1: unported keys are refused, not ignored ---------------------------


@pytest.mark.parametrize("key, value, item", [
    ("tsd.storage.directory", "/var/lib/tsdb",
     "slice 9 (durability, with replication)"),
    ("tsd.query.limits.data_points.default", 5, None),
    ("tsd.query.limits.bytes.default", 1 << 20, None),
    ("tsd.query.limits.overrides.config", "/etc/limits.json", None),
    ("tsd.query.limits.data_points.allow_override", True, None),
    ("tsd.query.timeout", 1500, None),
    ("tsd.network.cluster.peers", "127.0.0.1:4243", "slice 9 (the cluster)"),
    ("tsd.network.cluster.shard.enable", "yes", "slice 9 (the cluster)"),
    ("tsd.network.cluster.breaker.threshold", 3, "slice 9 (the cluster)"),
])
def test_unported_keys_are_refused(key, value, item):
    """A key of a subsystem still to port is refused, naming its ROADMAP
    item (item); the budget keys (item None) are honoured now: the TSDB
    starts and its budget registry reads them."""
    if item is None:
        tsdb = TSDB(Config({key: value}), device="cpu")
        limits = tsdb.query_limits
        assert {
            "tsd.query.limits.data_points.default":
                limits.default_data_points_limit,
            "tsd.query.limits.bytes.default": limits.default_byte_limit,
            "tsd.query.limits.overrides.config": limits.file_location,
            "tsd.query.limits.data_points.allow_override": value,
            "tsd.query.timeout": tsdb.config.get_int("tsd.query.timeout"),
        }[key] == value
        return
    with pytest.raises(ValueError,
                       match=re.escape("ROADMAP A, " + item)) as info:
        TSDB(Config({key: value}), device="cpu")
    assert key in str(info.value)


def test_the_two_reproduced_cases_are_refused():
    """The two cases ROADMAP C1 reproduced: the reference writes a WAL
    under tsd.storage.directory, which the port still refuses; and it
    answers 413 over a 5-point limit, which the port now answers too,
    with the reference's message."""
    with pytest.raises(ValueError, match="not supported"):
        TSDB(Config({"tsd.core.auto_create_metrics": True,
                     "tsd.storage.directory": "/tmp/tsdb-wal"}),
             device="cpu")
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.query.limits.data_points.default": "5",
             "tsd.http.show_stack_trace": False}
    ref = RefManager(RefTSDB(RefConfig({**props,
                                        "tsd.query.mesh.enable": False})))
    port = RpcManager(TSDB(Config(props), device="cpu"))
    body = [{"metric": "m", "timestamp": BASE + i, "value": i,
             "tags": {"h": "a"}} for i in range(8)]
    uri = "/api/query?start=%d&end=%d&m=sum:1m-avg:m" % (BASE, BASE + 60)
    got = []
    for manager, request_cls in ((ref, RefRequest), (port, HttpRequest)):
        assert _http(manager, request_cls, "POST", "/api/put", body)[0] == 204
        got.append(_http(manager, request_cls, "GET", uri))
    assert got[0] == got[1]
    assert got[1][0] == 413 and "5 data points" in got[1][1]["error"][
        "message"]


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
    # admission, the request deadline's stance and the dispatch batcher
    {"tsd.query.batch.enable": True, "tsd.query.batch.hold_ms": 5,
     "tsd.query.batch.max_q": 8, "tsd.query.batch.max_mb": 32,
     "tsd.query.batch.amortize_factor": 2.5,
     "tsd.query.admission.enable": True, "tsd.query.admission.permits": 3,
     "tsd.query.admission.queue_limit": 7,
     "tsd.query.admission.max_wait_ms": 900,
     "tsd.query.tenant.fair_share": False,
     "tsd.query.tenant.weights": "a:2", "tsd.query.tenant.quantum_ms": 20,
     "tsd.query.tenant.max_inflight": 2, "tsd.query.degrade": "allow",
     "tsd.diag.tenants": "a,b", "tsd.diag.tenant_buckets": 4},
    # the host lane: accepted and ignored, every plan runs on the device
    {"tsd.query.host_lane.max_points": 1_000_000,
     "tsd.core.auto_create_metrics": True},
])
def test_defaults_ignored_and_ported_keys_are_accepted(props):
    tsdb = TSDB(Config(props), device="cpu")
    if props.get("tsd.rollups.enable"):
        assert tsdb.rollup_store is not None
        assert tsdb.rollup_lanes is not None
    if "tsd.query.batch.enable" in props:
        batcher, gate = tsdb.dispatch_batcher, tsdb.admission_gate
        assert (batcher.hold_ms, batcher.max_q, batcher.max_bytes) \
            == (5, 8, 32 * 2 ** 20)
        assert (gate.permits, gate.queue_limit, gate.max_wait_ms,
                gate.fair_share, gate.quantum_ms,
                gate.tenant_max_inflight) == (3, 7, 900, False, 20, 2)
        assert gate._weights == {"a": 2.0}
    if "tsd.query.host_lane.max_points" in props:
        # a plan far under the host lane's bound still routes on the
        # TSDB's device: no host lane
        from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
        for k in range(10):
            tsdb.add_point("hl.m", BASE + k, float(k), {"h": "a"})
        q = TSQuery(start=str(BASE), end=str(BASE + 60),
                    queries=[parse_m_subquery("sum:10s-avg:hl.m")])
        q.validate()
        runner = tsdb.new_query_runner()
        runner.run(q)
        assert runner.decisions[0].path == "batched"
        assert runner.decisions[0].fp_fields["hostSmall"] is False
        assert "hostLane" not in runner.exec_stats


def test_tsd_main_refuses_an_unported_key(tmp_path, capsys):
    conf = tmp_path / "tsd.conf"
    conf.write_text("tsd.network.port = 4242\n"
                    "tsd.storage.directory = /var/lib/tsdb\n")
    assert tsd_main.main(["--config", str(conf)]) == 1
    assert "tsd.storage.directory" in capsys.readouterr().err


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
                    "/api/query/exp"):
            status, body = _http(port, HttpRequest, "GET", uri)
            assert status == 501 and "ROADMAP" in body["error"]["details"]
        # explain is served since slice 8c: an unknown metric is the
        # client's 404, as /api/query answers it, not an internal error
        for uri in ("/api/query/explain?start=1h-ago&m=sum:svc.lat",
                    "/api/query?start=1h-ago&m=sum:svc.lat"):
            status, body = _http(port, HttpRequest, "GET", uri)
            assert status == 404, body
            assert "No such name" in body["error"]["message"]
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


# -- a closed deliberate difference: tiled execution (ROADMAP slice 7b) ------


def test_streaming_state_over_budget_is_refused_where_the_reference_tiles():
    """24 series x 4,097 10 s windows of sum lanes (~3 MB of streaming
    state at the padded window count) under a 1 MB budget: both packages
    serve the plan by tiling (tsd.query.spill.enable, on by default) in
    the same number of tiles and agree bit for bit on this integer data.
    Until slice 7b the port answered the streaming 413 here; the name is
    kept from then."""
    import numpy as np

    from opentsdb_tpu.models import TSQuery as RefTSQuery
    from opentsdb_tpu.models import parse_m_subquery as ref_parse
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery

    props = {"tsd.core.auto_create_metrics": True,
             "tsd.query.streaming.point_threshold": "10",
             "tsd.query.streaming.chunk_points": "20000",
             "tsd.query.device_cache.enable": "false",
             "tsd.query.streaming.state_mb": "1"}
    ref = RefTSDB(RefConfig({**props, "tsd.query.mesh.enable": False,
                             "tsd.query.cache.enable": False}))
    port = TSDB(Config(props), device="cpu")
    span = 40_960
    for t in (ref, port):
        rng = np.random.default_rng(7)
        for h in range(24):
            times = np.sort(rng.choice(span, size=60, replace=False))
            for i, ts in enumerate(times):
                t.add_point("til.m", BASE + int(ts), float((i * 7 + h * 13)
                                                           % 101),
                            {"h": "h%d" % h, "g": "g%d" % (h % 4)})
    m = "sum:10s-sum:til.m{g=*}"
    q = RefTSQuery(start=str(BASE), end=str(BASE + span),
                   queries=[ref_parse(m)])
    q.validate()
    runner = ref.new_query_runner()
    want = [r.to_json() for r in runner.run(q)]
    ref_stats = runner.exec_stats
    assert ref_stats.get("tiledExecution") == 1.0
    assert len(want) == 4
    q = TSQuery(start=str(BASE), end=str(BASE + span),
                queries=[parse_m_subquery(m)])
    q.validate()
    runner = port.new_query_runner()
    got = [r.to_json() for r in runner.run(q)]
    assert runner.exec_stats.get("tiledExecution") == 1.0
    assert runner.exec_stats["tiledTiles"] == ref_stats["tiledTiles"]
    assert got == want
