"""Scan budgets and the query timeout (query/limits.py, the planner's
charges) against the reference's, on the CPU.

The cases of tests/test_query_limits.py run on both packages:
QueryLimitOverride (the overrides file, first match, hot reload, load
errors) and QueryBudget answer alike; a query over a data-point, byte or
time budget raises the reference's QueryException on every arm (grouped,
union, histogram), and over HTTP both daemons answer the same 413 body.
The reference runs with the mesh off (conftest's 8 virtual CPU devices),
its batched arm off (its planner would otherwise route a small query
elsewhere) and its admission control off (not ported yet: it would
answer a query whose deadline has passed with its own 503).  Its request
deadline starts when the request arrives, the port's budget when the
planner starts the sub query, so a timeout body is compared with its
elapsed milliseconds masked.
"""

import json
import logging
import os
import re
import time

import pytest

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.query import limits as ref_limits
from opentsdb_tpu.storage import memstore as ref_memstore
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.query import limits
from opentsdb_tpu_torch.query.limits import (
    BYTES_PER_POINT, QueryBudget, QueryException, QueryLimitOverride)
from opentsdb_tpu_torch.storage import memstore
from opentsdb_tpu_torch.tsd.http import HttpRequest
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
from opentsdb_tpu_torch.utils import datetime_util as DT
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400
HIST_CONFIG = '{"SimpleHistogramDecoder": 0}'
# the budgets' cases run both packages off the batched route and the
# aggregate cache's rewrite, and without admission, whose deadline check
# would answer first
BOTH_OFF = {"tsd.query.batch.enable": False,
            "tsd.query.cache.enable": False,
            "tsd.query.admission.enable": False}
REF_OFF = {"tsd.query.mesh.enable": False, **BOTH_OFF}


def _both(**over):
    """(reference, port) QueryLimitOverride over the same properties."""
    props = {"tsd.core.auto_create_metrics": True, **over}
    return (ref_limits.QueryLimitOverride(RefConfig(props)),
            QueryLimitOverride(Config(props)))


def _loaded(ref: bool, **over):
    props = {"tsd.core.auto_create_metrics": True, **over}
    tsdb = (RefTSDB(RefConfig({**props, **REF_OFF})) if ref
            else TSDB(Config({**props, **BOTH_OFF}), device="cpu"))
    for h in range(4):
        for k in range(50):
            tsdb.add_point("sys.cpu.user", BASE + k * 10, k,
                           {"host": "web%d" % h})
    return tsdb


def _run(tsdb, m, ref: bool, start=BASE, end=BASE + 600):
    q = (RefTSQuery if ref else TSQuery)(
        start=str(start), end=str(end),
        queries=[(ref_parse if ref else parse_m_subquery)(m)])
    q.validate()
    return tsdb.new_query_runner().run(q)


def _raises_alike(m, **over):
    """The reference's and the port's QueryException for query `m`:
    (status, message) equal."""
    got = []
    for ref in (True, False):
        exc_type = ref_limits.QueryException if ref else QueryException
        with pytest.raises(exc_type) as info:
            _run(_loaded(ref, **over), m, ref)
        got.append((info.value.status, str(info.value)))
    assert got[0] == got[1]
    return got[1]


# -- the overrides registry --------------------------------------------------


def _limits_of(lims, metrics):
    return [[(lim.get_byte_limit(m), lim.get_data_points_limit(m))
             for m in metrics] for lim in lims]


def test_defaults_without_file():
    ref, port = _both()
    got = _limits_of((ref, port), ["any.metric"])
    assert got[0] == got[1] == [(0, 0)]


def test_negative_default_rejected():
    for cls, cfg in ((ref_limits.QueryLimitOverride, RefConfig),
                     (QueryLimitOverride, Config)):
        with pytest.raises(ValueError):
            cls(cfg({"tsd.query.limits.bytes.default": "-1"}))


@pytest.mark.parametrize("entries", [
    [{"regex": "^sys\\.cpu", "byteLimit": 1024, "dataPointsLimit": 10},
     {"regex": "cpu", "byteLimit": 2048, "dataPointsLimit": 20}],
    [{"regex": "x", "byte_limit": 5, "data_points_limit": 6}],
])
def test_file_load_and_first_match(tmp_path, entries):
    path = tmp_path / "limits.json"
    path.write_text(json.dumps(entries))
    lims = _both(**{"tsd.query.limits.overrides.config": str(path),
                    "tsd.query.limits.bytes.default": "999"})
    got = _limits_of(lims, ["sys.cpu.user", "proc.cpu", "disk.free", "xyz"])
    assert got[0] == got[1]


@pytest.mark.parametrize("new_text, want", [
    (json.dumps([{"regex": "a", "dataPointsLimit": 7}]), 7),
    ("{not json", 1),      # a bad reload keeps the last good limits
])
def test_hot_reload_on_mtime_change(tmp_path, new_text, want):
    path = tmp_path / "limits.json"
    path.write_text(json.dumps([{"regex": "a", "dataPointsLimit": 1}]))
    lims = _both(**{"tsd.query.limits.overrides.config": str(path),
                    "tsd.query.limits.overrides.interval": "1"})
    path.write_text(new_text)
    os.utime(path, (time.time() + 5, time.time() + 5))
    for lim in lims:
        lim._next_check = 0
        lim.maybe_reload()
        assert lim.get_data_points_limit("abc") == want


def test_reload_rate_limited_to_interval(tmp_path):
    path = tmp_path / "limits.json"
    path.write_text(json.dumps([{"regex": "a", "dataPointsLimit": 1}]))
    lims = _both(**{"tsd.query.limits.overrides.config": str(path),
                    "tsd.query.limits.overrides.interval": "3600"})
    for lim in lims:
        lim.maybe_reload()
    path.write_text(json.dumps([{"regex": "a", "dataPointsLimit": 9}]))
    os.utime(path, (time.time() + 5, time.time() + 5))
    seen = []
    for lim in lims:
        lim.maybe_reload()          # within the interval: not re-read
        seen.append(lim.get_data_points_limit("abc"))
        lim._next_check = 0
        lim.maybe_reload()
        seen.append(lim.get_data_points_limit("abc"))
    assert seen == [1, 9, 1, 9]


def test_reload_noop_without_file_or_interval():
    for lim in _both() + _both(**{
            "tsd.query.limits.overrides.interval": "0"}):
        lim.maybe_reload()


def test_unchanged_mtime_skips_reparse(tmp_path):
    path = tmp_path / "limits.json"
    path.write_text(json.dumps([{"regex": "a", "dataPointsLimit": 2}]))
    for lim in _both(**{"tsd.query.limits.overrides.config": str(path),
                        "tsd.query.limits.overrides.interval": "1"}):
        before = lim.overrides
        lim._next_check = 0
        lim.maybe_reload()
        assert lim.overrides is before


@pytest.mark.parametrize("content", ["{not json", None,
                                     json.dumps(["not-a-mapping"])])
def test_bad_file_does_not_crash_construction(tmp_path, content):
    """A corrupt file, a directory and a bad entry: both packages start
    from the defaults and count one load error."""
    path = tmp_path / "limits.json"
    if content is None:
        path = tmp_path                     # unreadable: a directory
    else:
        path.write_text(content)
    for lim in _both(**{"tsd.query.limits.overrides.config": str(path),
                        "tsd.query.limits.bytes.default": "777"}):
        assert lim.get_byte_limit("any.metric") == 777
        assert lim.overrides == []
        assert lim.reload_errors == 1


def test_reload_error_counted_and_logged_once(tmp_path, caplog):
    path = tmp_path / "limits.json"
    path.write_text(json.dumps([{"regex": "a", "dataPointsLimit": 3}]))
    lim = QueryLimitOverride(Config({
        "tsd.query.limits.overrides.config": str(path),
        "tsd.query.limits.overrides.interval": "1"}))
    path.write_text("{not json")
    with caplog.at_level(logging.ERROR, limits.__name__):
        for bump in (5, 10):        # the same bad bytes twice
            os.utime(path, (time.time() + bump, time.time() + bump))
            lim._next_check = 0
            lim.maybe_reload()
    assert lim.get_data_points_limit("abc") == 3
    assert lim.reload_errors == 2
    assert len([r for r in caplog.records
                if "overrides" in r.getMessage()]) == 1
    path.write_text(json.dumps([{"byteLimit": 5}]))     # missing regex
    os.utime(path, (time.time() + 15, time.time() + 15))
    with caplog.at_level(logging.ERROR, limits.__name__):
        lim._next_check = 0
        lim.maybe_reload()
    assert len([r for r in caplog.records
                if "overrides" in r.getMessage()]) == 2
    assert lim.reload_errors == 3


# -- the budget ----------------------------------------------------------------


def _budgets(timeout=0, **attrs):
    out = []
    for cls in (ref_limits.QueryBudget, QueryBudget):
        b = cls(None, "m", timeout)
        for k, v in attrs.items():
            setattr(b, k, v)
        out.append(b)
    return out


@pytest.mark.parametrize("attrs, charges", [
    ({"max_data_points": 100}, [99, 1]),
    ({"max_data_points": 100}, [100]),
    ({"max_data_points": 100}, [1] * 100),
    ({"max_bytes": 10 * BYTES_PER_POINT}, [11]),
    ({"max_bytes": 10 * BYTES_PER_POINT}, [5, 5, 1]),
    ({"max_bytes": 1024}, [2**62]),
    ({}, [10**9]),
])
def test_charges_raise_alike(attrs, charges):
    """Each budget takes the charges until it raises: both raise at the
    same charge with the same status and message (or neither does)."""
    seen = []
    for b in _budgets(**attrs):
        out = None
        for i, c in enumerate(charges):
            try:
                b.charge(c)
            except (ref_limits.QueryException, QueryException) as e:
                out = (i, e.status, str(e))
                break
        b.check_deadline()
        seen.append(out)
    assert seen[0] == seen[1]
    assert (seen[1] is None) == (not attrs)


def test_deadline():
    for b in _budgets(timeout=1):
        time.sleep(0.01)
        with pytest.raises(Exception) as info:
            b.check_deadline()
        assert info.value.status == 413
        assert "timed out" in str(info.value)


def test_budget_binds_per_metric_override(tmp_path):
    path = tmp_path / "limits.json"
    path.write_text(json.dumps([{"regex": "^sys\\.", "dataPointsLimit": 5}]))
    for lim, cls in zip(_both(**{
            "tsd.query.limits.overrides.config": str(path),
            "tsd.query.limits.data_points.default": "50"}),
            (ref_limits.QueryBudget, QueryBudget)):
        with pytest.raises(Exception):
            cls(lim, "sys.cpu.user", 0).charge(5)
        cls(lim, "disk.free", 0).charge(49)


# -- end to end ----------------------------------------------------------------


@pytest.mark.parametrize("m, over", [
    ("sum:1m-avg:sys.cpu.user{host=*}",
     {"tsd.query.limits.data_points.default": "100"}),
    ("sum:1m-avg:sys.cpu.user", {"tsd.query.limits.bytes.default": "1000"}),
    ("sum:sys.cpu.user{host=*}",
     {"tsd.query.limits.data_points.default": "100"}),
    ("sum:sys.cpu.user", {"tsd.query.limits.bytes.default": "800"}),
])
def test_over_budget_query_raises_alike(m, over):
    """The grouped and the union arm charge before any batch is built."""
    status, message = _raises_alike(m, **over)
    assert status == 413 and "Sorry" in message


def test_under_budget_query_passes():
    for ref in (True, False):
        tsdb = _loaded(ref, **{"tsd.query.limits.data_points.default":
                               "100000"})
        assert _run(tsdb, "sum:1m-avg:sys.cpu.user", ref)


def test_histogram_arm_charges_the_budget():
    """A percentile query over the data-point budget: 413 in both."""
    got = []
    for ref in (True, False):
        props = {"tsd.core.auto_create_metrics": True,
                 "tsd.core.histograms.config": HIST_CONFIG,
                 "tsd.query.limits.data_points.default": "5"}
        tsdb = (RefTSDB(RefConfig({**props, **REF_OFF})) if ref
                else TSDB(Config({**props, **BOTH_OFF}), device="cpu"))
        for k in range(8):
            tsdb.add_histogram_point_json(
                "lat", BASE + 60 * k, {"buckets": {"0,10": 3, "10,20": k}},
                {"h": "a"})
        exc = ref_limits.QueryException if ref else QueryException
        with pytest.raises(exc) as info:
            _run(tsdb, "sum:percentiles[50,99]:lat", ref)
        got.append((info.value.status, str(info.value)))
    assert got[0] == got[1]


def _http(manager, request_cls, uri):
    q = manager.handle_http(request_cls(method="GET", uri=uri, body=b"",
                                        headers={}), remote="127.0.0.1:55")
    return q.response.status, json.loads(q.response.body)


@pytest.mark.parametrize("over", [
    {"tsd.query.limits.data_points.default": "10"},
    {"tsd.query.limits.bytes.default": "160"},
    {"tsd.query.timeout": "1"},
])
@pytest.mark.parametrize("m", ["sum:1m-avg:sys.cpu.user",
                               "sum:sys.cpu.user{host=*}"])
def test_http_413_bodies_alike(monkeypatch, over, m):
    """The same GET /api/query over a budget answers the same 413 body
    from both daemons.  For the timeout every window count sleeps 2 ms,
    so that both packages pass the 1 ms limit before their check."""
    if "tsd.query.timeout" in over:
        for mod in (ref_memstore, memstore):
            orig = mod.Series.window_count

            def slow(self, *a, _orig=orig, **k):
                time.sleep(0.002)
                return _orig(self, *a, **k)
            monkeypatch.setattr(mod.Series, "window_count", slow)
            orig_stats = mod.Series.window_stats

            def slow_stats(self, *a, _orig=orig_stats, **k):
                time.sleep(0.002)
                return _orig(self, *a, **k)
            monkeypatch.setattr(mod.Series, "window_stats", slow_stats)
    props = {"tsd.http.show_stack_trace": False, **over}
    uri = "/api/query?start=%d&end=%d&m=%s" % (BASE, BASE + 600, m)
    got = []
    for ref in (True, False):
        tsdb = _loaded(ref, **props)
        manager = RefManager(tsdb) if ref else RpcManager(tsdb)
        status, body = _http(manager, RefRequest if ref else HttpRequest,
                             uri)
        err = body["error"]
        err["message"] = re.sub(r"elapsed: \d+ ms", "elapsed: N ms",
                                err["message"])
        got.append((status, err))
    assert got[0] == got[1]
    assert got[1][0] == 413


# -- the window plan is built only after the budget accepted the scan ------


def _spied_edges(monkeypatch):
    calls = []
    orig = DT.calendar_window_edges

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(DT, "calendar_window_edges", spy)
    return calls


def _calendar_query(start=BASE, end=BASE + 600):
    return "sum:1mc-avg:sys.cpu.user{host=*}", start, end


def test_over_budget_never_builds_the_edge_vector(monkeypatch):
    calls = _spied_edges(monkeypatch)
    tsdb = _loaded(False, **{"tsd.query.limits.data_points.default": "10"})
    m, start, end = _calendar_query()
    with pytest.raises(QueryException):
        _run(tsdb, m, False, start, end)
    assert calls == []


def test_empty_range_never_builds_the_edge_vector(monkeypatch):
    calls = _spied_edges(monkeypatch)
    m, start, end = _calendar_query(BASE + 50_000, BASE + 50_600)
    results = _run(_loaded(False), m, False, start, end)
    assert all(not r.dps for r in results)
    assert calls == []


def test_in_budget_calendar_query_still_serves(monkeypatch):
    calls = _spied_edges(monkeypatch)
    m, start, end = _calendar_query()
    ref = _run(_loaded(True, **{"tsd.query.limits.data_points.default":
                                "100000"}), m, True, start, end)
    port = _run(_loaded(False, **{"tsd.query.limits.data_points.default":
                                  "100000"}), m, False, start, end)
    assert port and any(r.dps for r in port) and calls
    assert [r.to_json() for r in port] == [r.to_json() for r in ref]


def test_exec_stats_recorded():
    """pointsScanned, seriesScanned and streamedChunks, as the
    reference's exec stats count them; a second run resets them."""
    stats = []
    for ref in (True, False):
        props = {"tsd.core.auto_create_metrics": True,
                 "tsd.query.streaming.point_threshold": "50",
                 "tsd.query.streaming.chunk_points": "64"}
        tsdb = (RefTSDB(RefConfig({**props, **REF_OFF})) if ref
                else TSDB(Config({**props, **BOTH_OFF}), device="cpu"))
        for h in range(2):
            for k in range(100):
                tsdb.add_point("es.m", BASE + k * 5 + h, k,
                               {"host": "h%d" % h})
        runner = tsdb.new_query_runner()
        q = (RefTSQuery if ref else TSQuery)(
            start=str(BASE), end=str(BASE + 1000),
            queries=[(ref_parse if ref else parse_m_subquery)(
                "sum:1m-avg:es.m")])
        q.validate()
        runner.run(q)
        runner.run(q)
        stats.append({k: runner.exec_stats.get(k) for k in
                      ("pointsScanned", "seriesScanned", "streamedChunks")})
    assert stats[0] == stats[1]
    assert stats[1] == {"pointsScanned": 200, "seriesScanned": 2,
                        "streamedChunks": 1}
