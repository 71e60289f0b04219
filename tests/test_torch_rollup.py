"""Written rollups and the rollup programs on both packages, on the CPU.

The cases of tests/test_rollup.py (the interval table, ingest of rollup
and pre-aggregate points, rollup-aware reads under every ROLLUP_USAGE,
the blackout split and the rollup job) run on the JAX reference (mesh
off) and on opentsdb_tpu_torch (``device="cpu"``, so L1 and L2 run their
plain versions), and the answers are held to each other: keys and
timestamps exactly, values at rtol 1e-9 (torch_parity.RTOL), integer
answers exactly.  POST /api/rollup and telnet `rollup` go through both
RpcManagers.  Then the programs: run_lane_partials (L1),
run_rollup_avg_pipeline and run_group_rollup_avg_pipeline (L2 and the
tail), run_downsample_grid and run_grid_tail against the reference's,
the reference's power-of-two window padding cut away.
"""

import json

import numpy as np
import pytest

import opentsdb_tpu.ops  # noqa: F401  (x64)
import opentsdb_tpu.rollup as ref_rollup
import opentsdb_tpu.utils.datetime_util as ref_dt
from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import pipeline as jpipe
from opentsdb_tpu.ops.rate import RateOptions as JRateOptions
from opentsdb_tpu.rollup.job import run_rollup_job as ref_job
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
import opentsdb_tpu_torch.rollup as port_rollup
import opentsdb_tpu_torch.utils.datetime_util as port_dt
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import lanes as tlanes
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.rollup.job import run_rollup_job
from opentsdb_tpu_torch.tsd.http import HttpRequest
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
from opentsdb_tpu_torch.utils.config import Config

from torch_parity import (RTOL, assert_exact, assert_values, sorted_batch,
                          t)

BASE = 1_356_998_400          # seconds, the top of an hour
BASE_MS = BASE * 1000
HOUR_MS = 3_600_000
ROLLUPS = {"tsd.core.auto_create_metrics": True, "tsd.rollups.enable": True}
PKGS = {"ref": ref_rollup, "port": port_rollup}


def make_pair(**extra):
    props = {**ROLLUPS, **extra}
    return (RefTSDB(RefConfig({**props, "tsd.query.mesh.enable": False})),
            TSDB(Config(props), device="cpu"))


def answers(tsdbs, m, start=BASE, end=BASE + 7200):
    """The JSON answers of both packages to one query."""
    out = []
    for tsdb, tsq, parse in zip(tsdbs, (RefTSQuery, TSQuery),
                                (ref_parse, parse_m_subquery)):
        q = tsq(start=str(start), end=str(end), queries=[parse(m)])
        q.validate()
        out.append([r.to_json(ms_resolution=True, show_tsuids=True)
                    for r in tsdb.new_query_runner().run(q)])
    return out


def assert_same_answers(port, ref):
    """Groups, tags and timestamps exactly; values at RTOL, integers
    exactly."""
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert {k: v for k, v in p.items() if k != "dps"} \
            == {k: v for k, v in r.items() if k != "dps"}
        assert list(p["dps"]) == list(r["dps"])
        for key, rv in r["dps"].items():
            pv = p["dps"][key]
            if isinstance(rv, int) and isinstance(pv, int):
                assert pv == rv, key
            else:
                assert pv == pytest.approx(rv, rel=RTOL, abs=1e-12,
                                           nan_ok=True), key


# -- the interval table (RollupConfig, RollupInterval, RollupQuery) ------


@pytest.mark.parametrize("pkg", list(PKGS))
def test_get_interval(pkg):
    mod = PKGS[pkg]
    cfg = mod.RollupConfig(intervals=[
        mod.RollupInterval("10m", "t-10m", "t-10m-agg")])
    assert cfg.get_rollup_interval("10m").table == "t-10m"
    with pytest.raises(mod.NoSuchRollupForInterval):
        cfg.get_rollup_interval("5m")


@pytest.mark.parametrize("pkg", list(PKGS))
def test_best_matches_order(pkg):
    mod = PKGS[pkg]
    cfg = mod.RollupConfig(intervals=[
        mod.RollupInterval("1m", "a", "a2"),
        mod.RollupInterval("10m", "b", "b2"),
        mod.RollupInterval("1h", "c", "c2")])
    assert [m.interval for m in cfg.get_best_matches(86400)] \
        == ["1h", "10m", "1m"]
    assert [m.interval for m in cfg.get_best_matches(1800)] == ["10m", "1m"]
    with pytest.raises(mod.NoSuchRollupForInterval):
        cfg.get_best_matches(7)
    sub = mod.RollupConfig(intervals=[mod.RollupInterval("500ms", "a", "a2"),
                                      mod.RollupInterval("1s", "b", "b2")])
    assert [m.interval for m in sub.get_best_matches_ms(1500)] == ["500ms"]
    assert [m.interval for m in sub.get_best_matches_ms(2000)] \
        == ["1s", "500ms"]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_aggregation_ids_and_json(pkg):
    mod = PKGS[pkg]
    cfg = mod.RollupConfig()
    assert cfg.get_id_for_aggregator("SUM") == 0
    assert cfg.get_aggregator_for_id(1) == "count"
    with pytest.raises(ValueError):
        cfg.get_id_for_aggregator("p99")
    cfg = mod.RollupConfig.from_json(
        '{"aggregationIds": {"sum": 0, "max": 1}, "intervals": '
        '[{"interval": "1h", "table": "tsdb-1h", '
        '"preAggregationTable": "tsdb-1h-agg", "delaySla": 3600000}]}')
    assert cfg.get_rollup_interval("1h").delay_sla_ms == 3_600_000
    assert cfg.get_id_for_aggregator("max") == 1
    with pytest.raises(ValueError, match="Duplicate"):
        mod.RollupConfig(aggregation_ids={"sum": 0, "max": 0})


@pytest.mark.parametrize("pkg", list(PKGS))
def test_blackout(pkg):
    mod = PKGS[pkg]
    ri = mod.RollupInterval("1h", "t", "t2", delay_sla_ms=3_600_000)
    rq = mod.RollupQuery(ri, "sum", 3_600_000)
    now = BASE_MS + 10 * HOUR_MS
    assert rq.is_in_blackout(now - 1000, now)
    assert not rq.is_in_blackout(now - 2 * HOUR_MS, now)
    assert not rq.is_lower_sampling_rate()


def test_default_table_and_json_round_trip():
    ref, port = make_pair()
    assert port.rollup_config.to_json() == ref.rollup_config.to_json()
    assert [i.interval for i in port.rollup_config.intervals] \
        == ["1m", "1h", "1d"]
    off = TSDB(Config({"tsd.core.auto_create_metrics": True}), device="cpu")
    assert off.rollup_config is None and off.rollup_store is None


# -- ingest (TSDB.addAggregatePoint) --------------------------------------


def test_add_aggregate_point_lands_in_its_lane():
    for tsdb in make_pair():
        tsdb.add_aggregate_point("sys.cpu", BASE, 42, {"host": "a"},
                                 False, "1h", "sum")
        lane = tsdb.rollup_store.peek_lane("1h", "sum")
        assert lane is not None and lane.total_datapoints == 1
        assert tsdb.rollup_store.lanes() == [("1h", "sum", False)]
        assert tsdb.store.total_datapoints == 0


@pytest.mark.parametrize("args, error", [
    (("sys.cpu", BASE, 1, {"h": "a"}, False, None, "sum"), ValueError),
    (("sys.cpu", BASE, 1, {"h": "a"}, False, "7m", "sum"), ValueError),
    (("sys.cpu", BASE, 1, {"h": "a"}, False, "1h", None), ValueError),
    (("sys.cpu", BASE, 1, {"h": "a"}, False, "1h", "p99"), ValueError),
    (("m", BASE, 1, {"h": "a"}, False, "1h", "avg"), ValueError),
    (("m", BASE, 1, {"h": "a"}, True, None, None, "dev"), ValueError),
    (("m", BASE, 1, {"h": "a"}, True, None, None, "bogus"), ValueError),
    (("m", BASE, "x", {"h": "a"}, False, "1h", "sum"), ValueError),
    (("m", BASE, 1, {}, False, "1h", "sum"), ValueError),
])
def test_add_aggregate_point_refusals_match(args, error):
    """Each refusal of the reference is the port's, with its message
    (NoSuchRollupForInterval is a ValueError in both)."""
    msgs = []
    for tsdb in make_pair():
        with pytest.raises(error) as info:
            tsdb.add_aggregate_point(*args)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_groupby_adds_the_agg_tag_and_block_derived_can_be_lifted():
    for tsdb in make_pair():
        tsdb.add_aggregate_point("sys.cpu", BASE, 5, {"host": "a"},
                                 True, None, None, "sum")
        series = tsdb.rollup_store.peek_lane("", "sum", True).all_series()
        assert len(series) == 1
        assert tsdb.resolve_key_tags(series[0].key)["_aggregate"] == "SUM"
    for tsdb in make_pair(**{"tsd.rollups.block_derived": False}):
        tsdb.add_aggregate_point("m", BASE, 1, {"h": "a"}, True, None, None,
                                 "dev")
        tsdb.add_aggregate_point("m", BASE, 1, {"h": "a"}, False, "1h",
                                 "sum")


def test_tag_raw_marks_raw_series():
    for tsdb in make_pair(**{"tsd.rollups.tag_raw": True}):
        tsdb.add_point("m", BASE, 1, {"host": "a"})
        tsdb.add_points_bulk([{"metric": "m", "timestamp": BASE + 1,
                               "value": 2, "tags": {"host": "b"}}])
        tags = sorted(tsdb.resolve_key_tags(s.key)["_aggregate"]
                      for s in tsdb.store.all_series())
        assert tags == ["RAW", "RAW"]


def test_disabled_rollups_raise():
    ref = RefTSDB(RefConfig({"tsd.core.auto_create_metrics": True,
                             "tsd.query.mesh.enable": False}))
    port = TSDB(Config({"tsd.core.auto_create_metrics": True}), device="cpu")
    for tsdb in (ref, port):
        with pytest.raises(RuntimeError, match="not enabled"):
            tsdb.add_aggregate_point("m", BASE, 1, {"h": "a"}, False, "1h",
                                     "sum")


# -- rollup-aware reads ---------------------------------------------------


def seed_rollups(tsdbs, hours=6):
    """1h and 1m cells for six series in two dc groups, from one seed:
    integer sums, min and max, float sums on `sys.f`, counts of 1-9 with
    holes in the count lane, and raw points that differ from the cells;
    pre-aggregated cells under the sum group-by aggregator."""
    rng = np.random.default_rng(7)
    rows = []
    for h in range(6):
        tags = {"host": "h%d" % h, "dc": "d%d" % (h % 2)}
        for i in range(hours):
            ts = BASE + i * 3600
            for agg, value in (("sum", int(rng.integers(-50, 500))),
                               ("count", int(rng.integers(1, 10))),
                               ("min", int(rng.integers(-80, 0))),
                               ("max", int(rng.integers(0, 900)))):
                if agg == "count" and rng.random() < 0.1:
                    continue
                rows.append(("sys.cpu", ts, value, tags, False, "1h", agg))
            rows.append(("sys.f", ts, float(rng.normal(100, 30)), tags,
                         False, "1h", "sum"))
            rows.append(("sys.f", ts, int(rng.integers(1, 5)), tags, False,
                         "1h", "count"))
            for m in range(0, 60, 15):
                rows.append(("sys.cpu", ts + m * 60, int(rng.integers(0, 9)),
                             tags, False, "1m", "sum"))
                rows.append(("sys.cpu", ts + m * 60, 1, tags, False, "1m",
                             "count"))
            rows.append(("sys.pre", ts, int(rng.integers(0, 99)),
                         {"dc": tags["dc"]}, True, None, None, "sum"))
    raw = [("sys.cpu", BASE + i * 600, int(rng.integers(1000, 2000)),
            {"host": "h%d" % h, "dc": "d%d" % (h % 2)})
           for h in range(6) for i in range(hours * 6)]
    for tsdb in tsdbs:
        for row in rows:
            tsdb.add_aggregate_point(*row)
        for metric, ts, value, tags in raw:
            tsdb.add_point(metric, ts, value, tags)
    return tsdbs


READ_QUERIES = [
    "sum:1h-sum:sys.cpu",
    "sum:1h-sum:sys.cpu{dc=*}",
    "sum:1h-avg:sys.cpu{dc=*}",
    "avg:1h-avg:sys.cpu{host=*}",
    "sum:1h-avg:sys.f{dc=*}",
    "sum:1h-sum:sys.f",
    "max:1h-max:sys.cpu{dc=*}",
    "min:1h-min:sys.cpu",
    "mimmin:1h-mimmin:sys.cpu{dc=*}",
    "sum:1h-count:sys.cpu{host=*}",
    "sum:1h-zimsum:sys.cpu",
    "sum:2h-sum:sys.cpu{dc=*}",
    "sum:4h-avg:sys.cpu{dc=*}",
    "sum:3h-max:sys.cpu",
    "sum:1h-avg-zero:sys.cpu{host=*}",
    "sum:rate:1h-sum:sys.cpu{dc=*}",
    "dev:1h-sum:sys.cpu{dc=*}",
    "p95:1h-avg:sys.cpu",
    "sum:30m-sum:sys.cpu{dc=*}",
    "sum:15m-avg:sys.cpu{dc=*}",
    "sum:1h-sum:rollup_raw:sys.cpu{dc=*}",
    "sum:1h-sum:rollup_fallback:sys.cpu",
    "sum:1h-avg:rollup_fallback_raw:sys.cpu{dc=*}",
    "sum:1h-dev:sys.cpu{dc=*}",
    "sum:1h-p50:sys.cpu",
    "sum:1h-sum:sys.pre",
    "sum:1h-sum:pre_agg:sys.pre{dc=*}",
    "sum:pre_agg:sys.pre{dc=*}",
]


@pytest.mark.parametrize("m", READ_QUERIES)
def test_rollup_reads_match_the_reference(m):
    """Every read answers as the reference's: from a lane (the widest
    configured interval dividing the downsample), from the sum and count
    lanes (avg), from the raw store (rollup_raw, functions no lane
    serves), from the pre-aggregate lane (pre_agg), or nothing."""
    tsdbs = seed_rollups(make_pair())
    ref, port = answers(tsdbs, m, BASE, BASE + 6 * 3600)
    assert_same_answers(port, ref)


def test_read_values_are_the_cells():
    """The lane cells themselves come back (test_rollup's golden values):
    a 1h sum is the cell, a 2h sum the pair's sum, an avg the sum over
    the count."""
    ref, port = make_pair()
    for tsdb in (ref, port):
        for i in range(4):
            ts = BASE + i * 3600
            for agg, value in (("sum", 10 * i), ("count", 5), ("min", i),
                               ("max", 100 + i)):
                tsdb.add_aggregate_point("sys.cpu", ts, value,
                                         {"host": "a"}, False, "1h", agg)
    for m, want in (("sum:1h-sum:sys.cpu", {BASE_MS + HOUR_MS: 10.0}),
                    ("sum:1h-avg:sys.cpu", {BASE_MS + 3 * HOUR_MS: 6.0}),
                    ("sum:1h-min:sys.cpu", {BASE_MS + 2 * HOUR_MS: 2.0}),
                    ("sum:1h-max:sys.cpu", {BASE_MS + 2 * HOUR_MS: 102.0}),
                    ("sum:2h-sum:sys.cpu", {BASE_MS: 10.0,
                                            BASE_MS + 2 * HOUR_MS: 50.0})):
        r, p = answers((ref, port), m, BASE, BASE + 4 * 3600)
        assert_same_answers(p, r)
        for ts_ms, value in want.items():
            assert p[0]["dps"][str(ts_ms)] == value


def test_nofallback_on_empty_lanes_answers_nothing():
    """ROLLUP_NOFALLBACK (the default usage) and ROLLUP_FALLBACK over
    lanes that hold nothing of the metric give the reference's empty
    result, never a silent raw scan; ROLLUP_FALLBACK_RAW scans raw."""
    ref, port = make_pair()
    for tsdb in (ref, port):
        for i in range(4):
            tsdb.add_point("sys.cpu", BASE + i * 3600, 7, {"host": "a"})
    for m in ("sum:1h-sum:sys.cpu", "sum:1h-sum:rollup_nofallback:sys.cpu",
              "sum:1h-sum:rollup_fallback:sys.cpu"):
        r, p = answers((ref, port), m, BASE, BASE + 4 * 3600)
        assert p == r == []
    r, p = answers((ref, port), "sum:1h-sum:rollup_fallback_raw:sys.cpu",
                   BASE, BASE + 4 * 3600)
    assert_same_answers(p, r)
    assert p[0]["dps"][str(BASE_MS)] == 7


def _split_config(delay_ms):
    return ('{"aggregationIds": {"sum": 0, "count": 1, "min": 2, '
            '"max": 3}, "intervals": [{"interval": "1h", "table": "r1h", '
            '"preAggregationTable": "r1hp", "delaySla": %d}]}' % delay_ms)


@pytest.mark.parametrize("m", ["sum:1h-sum:m", "sum:1h-avg:m{h=*}",
                               "max:2h-max:m"])
def test_split_serves_the_blackout_tail_from_raw(monkeypatch, m):
    """tsd.rollups.split_query.enable with a 2h SLA: the head from the
    lanes, the last two hours from raw points, stitched per group (the
    reference's SplitRollupQuery).  The clock is pinned in both
    packages."""
    now_ms = BASE_MS + 10 * HOUR_MS + 1_234_567
    cur_hour = now_ms - now_ms % HOUR_MS
    for mod in (ref_dt, port_dt):
        monkeypatch.setattr(mod, "current_time_millis", lambda: now_ms)
    tsdbs = make_pair(**{"tsd.rollups.config": _split_config(2 * HOUR_MS),
                         "tsd.rollups.split_query.enable": True})
    for tsdb in tsdbs:
        for i in range(6, 1, -1):
            ts = (cur_hour - i * HOUR_MS) // 1000
            for agg, value in (("sum", 50 + i), ("count", 5),
                               ("max", 9 * i)):
                tsdb.add_aggregate_point("m", ts, value, {"h": "a"}, False,
                                         "1h", agg)
        for i in range(2 * 3600 // 60 + 20):
            tsdb.add_point("m", (cur_hour - 2 * HOUR_MS) // 1000 + i * 60,
                           1 + i % 3, {"h": "a"})
    ref, port = answers(tsdbs, m, (cur_hour - 6 * HOUR_MS) // 1000,
                        now_ms // 1000)
    assert_same_answers(port, ref)
    # the raw tail is in the answer
    assert len(port) == 1
    assert max(map(int, port[0]["dps"])) >= cur_hour - 2 * HOUR_MS


# -- the rollup job -------------------------------------------------------


def _raw_fleet(tsdbs, hours=3, hosts=4, float_values=False):
    rng = np.random.default_rng(11)
    for h in range(hosts):
        tags = {"host": "x%d" % h, "g": "g%d" % (h % 2)}
        for i in range(hours * 60):
            value = (float(rng.normal(10, 3)) if float_values
                     else int(rng.integers(0, 60)))
            if rng.random() < 0.1:
                continue
            for tsdb in tsdbs:
                tsdb.add_point("job.metric", BASE + i * 60 + h, value, tags)


def _lanes_of(tsdb):
    out = {}
    for lane in tsdb.rollup_store.lanes():
        store = tsdb.rollup_store.peek_lane(*lane)
        for s in store.all_series():
            ts, fval, ival, isint = s.arrays()
            tags = tuple(sorted(tsdb.resolve_key_tags(s.key).items()))
            out[lane, tags] = (ts, np.where(isint, ival, fval))
    return out


@pytest.mark.parametrize("float_values", [False, True])
def test_job_writes_the_reference_lanes_and_serves(float_values):
    """run_rollup_job: the same cells in the same four lanes of every
    interval (sums at RTOL on floats, everything else exactly), the same
    counts written, and the lanes serve the reads."""
    tsdbs = make_pair()
    _raw_fleet(tsdbs, float_values=float_values)
    ref, port = tsdbs
    assert run_rollup_job(port, intervals=["1h", "1m"]) \
        == ref_job(ref, intervals=["1h", "1m"])
    want, got = _lanes_of(ref), _lanes_of(port)
    assert set(got) == set(want)
    for key, (ts, vals) in want.items():
        assert_exact(got[key][0], ts)
        assert_values(got[key][1], vals)
    for m in ("sum:1h-avg:job.metric{g=*}", "sum:1h-sum:job.metric",
              "max:1h-max:job.metric{host=*}", "sum:1h-count:job.metric",
              "sum:5m-min:job.metric{g=*}", "sum:2h-avg:job.metric"):
        r, p = answers(tsdbs, m, BASE, BASE + 3 * 3600)
        assert_same_answers(p, r)
        assert p


def test_job_on_an_empty_store_and_the_default_intervals():
    ref, port = make_pair()
    assert run_rollup_job(port) == ref_job(ref) == {"1m": 0, "1h": 0,
                                                    "1d": 0}
    _raw_fleet((ref, port), hours=1, hosts=2)
    assert run_rollup_job(port) == ref_job(ref)


# -- /api/rollup and telnet rollup ----------------------------------------


class _Conn:
    close_after_write = False


def _send(manager, request_cls, step):
    kind, method, uri, body = step
    if kind == "telnet":
        return manager.handle_telnet(_Conn(), method)
    data = json.dumps(body).encode() if body is not None else b""
    q = manager.handle_http(request_cls(
        method=method, uri=uri, body=data,
        headers={"content-type": "application/json"}))
    return q.response.status, (json.loads(q.response.body)
                                if q.response.body else None)


ROLLUP_SEQUENCE = [
    ("http", "POST", "/api/rollup", [
        {"metric": "r.m", "timestamp": BASE + 3600 * i, "value": 10 + i,
         "tags": {"host": "a"}, "interval": "1h", "aggregator": "sum"}
        for i in range(4)]),
    ("http", "POST", "/api/rollup?details", [
        {"metric": "r.m", "timestamp": BASE + 3600 * i, "value": 2,
         "tags": {"host": "a"}, "interval": "1h", "aggregator": "count"}
        for i in range(4)] + [
        {"metric": "r.m", "timestamp": BASE, "value": 1,
         "tags": {"host": "a"}, "interval": "7m", "aggregator": "sum"},
        {"metric": "r.m", "timestamp": BASE, "value": 1,
         "tags": {"host": "a"}, "interval": "1h", "aggregator": "avg"},
        {"metric": "r.m", "timestamp": BASE, "tags": {"host": "a"},
         "interval": "1h", "aggregator": "sum"},
        {"metric": "r.m", "timestamp": BASE, "value": 3,
         "tags": {"dc": "x"}, "groupbyAggregator": "sum"}]),
    ("http", "POST", "/api/rollup?summary", [
        {"metric": "r.m", "timestamp": BASE, "value": 1,
         "tags": {"host": "a"}}]),
    ("http", "GET", "/api/rollup", None),
    ("telnet", "rollup 1h-max r.m %d 77 host=a" % BASE, None, None),
    ("telnet", "rollup 1h-max:sum r.m %d 78 host=b" % (BASE + 3600), None,
     None),
    ("telnet", "rollup sum r.m %d 5 dc=y" % BASE, None, None),
    ("telnet", "rollup 1h-bogus r.m %d 5 host=a" % BASE, None, None),
    ("telnet", "rollup 7m-sum r.m %d 5 host=a" % BASE, None, None),
    ("telnet", "rollup 1h-sum r.m", None, None),
    ("http", "GET", "/api/query?start=%d&end=%d&m=sum:1h-avg:r.m"
                    % (BASE, BASE + 4 * 3600), None),
    ("http", "GET", "/api/query?start=%d&end=%d&m=sum:1h-max:r.m{host=*}"
                    % (BASE, BASE + 4 * 3600), None),
    ("http", "GET", "/api/query?start=%d&end=%d&m=sum:pre_agg:r.m{dc=*}"
                    % (BASE, BASE + 4 * 3600), None),
]


@pytest.mark.parametrize("enabled", [True, False])
def test_rollup_rpcs_answer_as_the_reference(enabled):
    """POST /api/rollup (details, summary and the 405) and telnet
    `rollup` (temporal, temporal with a group-by, pre-aggregate, and the
    refusals), then queries of what landed, through both RpcManagers:
    the same status and body at every step, with rollups on and off."""
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.rollups.enable": enabled,
             "tsd.rollups.block_derived": True,
             "tsd.http.show_stack_trace": False}
    ref = RefManager(RefTSDB(RefConfig({**props,
                                        "tsd.query.mesh.enable": False})))
    port = RpcManager(TSDB(Config(props), device="cpu"))
    for step in ROLLUP_SEQUENCE:
        want = _send(ref, RefRequest, step)
        got = _send(port, HttpRequest, step)
        assert got == want, step[:3]
    assert port.tsdb.datapoints_added == ref.tsdb.datapoints_added


# -- the programs: L1, L2, the downsample grid and the grid tail ----------


def _fixed(mod, interval_ms=300_000):
    return mod.FixedWindows.for_range(BASE_MS, BASE_MS + 3_600_000,
                                      interval_ms)


@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("interval_ms", [60_000, 300_000, 3_600_000])
def test_lane_partials_match_the_reference(interval_ms, int_values):
    """run_lane_partials (L1's plain version) against the reference's
    _lane_partials: sums at RTOL (exactly on integers), counts, minima
    and maxima exactly, empty cells (0, 0, +inf, -inf)."""
    ts, val, mask = sorted_batch(np.random.default_rng(interval_ms), 9, 200,
                                 int_values=int_values)
    plan = _fixed(jds, interval_ms)
    spec, wargs = plan.split()
    ref = [np.asarray(x)[:, :plan.count]
           for x in jpipe.run_lane_partials(spec, ts, val, mask, wargs)]
    port = [x.numpy() for x in tpipe.run_lane_partials(
        t(ts), t(val), t(mask), _fixed(tds, interval_ms).window_edges("cpu"))]
    assert [p.dtype for p in port] == [np.float64, np.int32, np.float64,
                                       np.float64]
    if int_values:
        assert_exact(port[0], ref[0])
    else:
        assert_values(port[0], ref[0])
    for p, r in zip(port[1:], ref[1:]):
        assert_exact(p, r)
    assert (port[1] == 0).any()
    empty = port[1] == 0
    assert (port[0][empty] == 0).all() and np.isinf(port[2][empty]).all()


def test_lane_partials_equal_window_moments_on_integers():
    """A lane cell's sum, count, min and max are K1's sum, count, min and
    max of that window, bit for bit, on integer data (plain versions)."""
    ts, val, mask = (t(x) for x in sorted_batch(np.random.default_rng(5),
                                                 12, 300, int_values=True))
    edges = _fixed(tds, 120_000).window_edges("cpu")
    sums, counts, mins, maxs = tlanes.lane_partials(ts, val, mask, edges)
    for agg, part in (("sum", sums), ("count", counts), ("min", mins),
                      ("max", maxs)):
        v, m = tds.window_moments(ts, val, mask, edges, agg)
        assert_exact(v[m].numpy(), part.double()[m].numpy())
        assert not (counts[~m] != 0).any()


def _lane_pair(rng, int_counts):
    """A sum lane and a count lane of nine series with their own
    timestamps (a cell may be missing from either)."""
    sl = sorted_batch(rng, 9, 60)
    cl = sorted_batch(rng, 9, 50, int_values=True)
    cl = (cl[0], np.abs(cl[1]) % 9 if int_counts
          else (np.abs(cl[1]) % 9).astype(np.float64), cl[2])
    return sl, cl


CASES = [
    # aggregator, fill, rate options, interval, int counts
    ("sum", "none", None, 300_000, True),
    ("avg", "zero", None, 600_000, False),
    ("max", "nan", (), 300_000, True),
    ("dev", "scalar", (True, 500), 900_000, True),
    ("p95", "none", None, 300_000, False),
    ("count", "none", None, 3_600_000, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_group_rollup_avg_pipeline_matches_the_reference(case):
    agg, fill, rate_args, interval, int_counts = case
    (ts_s, val_s, mask_s), (ts_c, val_c, mask_c) = _lane_pair(
        np.random.default_rng(interval), int_counts)
    gid = np.array([0, 0, 1, 1, 1, 2, 4, 4, 4], np.int64)  # group 3 empty
    plan = _fixed(jds, interval)
    spec, wargs = plan.split()
    ref = jpipe.run_group_rollup_avg_pipeline(
        jpipe.PipelineSpec(agg, jpipe.DownsampleStep("sum", spec, fill, 2.5),
                           None if rate_args is None
                           else JRateOptions(*rate_args)),
        ts_s, val_s, mask_s, ts_c, val_c, mask_c, gid, 5, wargs)
    port = tpipe.run_group_rollup_avg_pipeline(
        tpipe.PipelineSpec(agg, tpipe.DownsampleStep("avg", fill, 2.5),
                           None if rate_args is None
                           else RateOptions(*rate_args)),
        t(ts_s), t(val_s), t(mask_s), t(ts_c), t(val_c), t(mask_c), gid, 5,
        _fixed(tds, interval).window_edges("cpu"))
    ref = [np.asarray(x)[..., :plan.count] for x in ref]
    assert_exact(port[0].numpy(), ref[0])
    assert_exact(port[2].numpy(), ref[2][:5])
    assert_values(port[1].numpy(), ref[1][:5], where=ref[2][:5])


def test_rollup_avg_pipeline_matches_the_reference():
    """The one-group form and L2's plain version against the reference's
    quotient: every row in one group."""
    (ts_s, val_s, mask_s), (ts_c, val_c, mask_c) = _lane_pair(
        np.random.default_rng(2), True)
    plan = _fixed(jds)
    spec, wargs = plan.split()
    ref = jpipe.run_rollup_avg_pipeline(
        jpipe.PipelineSpec("sum", jpipe.DownsampleStep("sum", spec)),
        ts_s, val_s, mask_s, ts_c, val_c, mask_c, wargs)
    port = tpipe.run_rollup_avg_pipeline(
        tpipe.PipelineSpec("sum", tpipe.DownsampleStep("avg")), t(ts_s),
        t(val_s), t(mask_s), t(ts_c), t(val_c), t(mask_c),
        _fixed(tds).window_edges("cpu"))
    ref = [np.asarray(x)[:plan.count] for x in ref]
    assert_exact(port[0].numpy(), ref[0])
    assert_exact(port[2].numpy(), ref[2])
    assert_values(port[1].numpy(), ref[1], where=ref[2])
    edges = _fixed(tds).window_edges("cpu")
    _v, m = tlanes.rollup_avg(t(ts_s), t(val_s), t(mask_s), t(ts_c),
                              t(val_c), t(mask_c), edges)
    assert m.any() and (~m).any()
    with pytest.raises(ValueError, match="same series"):
        tlanes.rollup_avg(t(ts_s), t(val_s), t(mask_s), t(ts_c[:3]),
                          t(val_c[:3]), t(mask_c[:3]), edges)


GRID_CASES = [
    # aggregator, downsample fn, fill, rate options
    ("sum", "avg", "none", None),
    ("p99", "max", "zero", (True, 900)),
    ("movingAverage2", "sum", "none", None),
    ("avg", "p90", "scalar", ()),
    ("zimsum", "first", "nan", None),
]


@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_downsample_grid_and_grid_tail_match_the_reference(case):
    """run_downsample_grid, then run_grid_tail on its grid, against the
    reference's pair; and the composition is run_group_pipeline."""
    agg, fn, fill, rate_args = case
    ts, val, mask = sorted_batch(np.random.default_rng(31), 8, 128)
    gid = np.array([0, 0, 0, 1, 1, 3, 3, 3], np.int64)
    plan = _fixed(jds)
    spec, wargs = plan.split()
    jstep = jpipe.DownsampleStep(fn, spec, fill, 1.5)
    rwts, rv, rm = jpipe.run_downsample_grid(jstep, ts, val, mask, wargs)
    ref_grid = [np.asarray(x)[..., :plan.count] for x in (rwts, rv, rm)]
    jspec = jpipe.PipelineSpec(agg, jstep, None if rate_args is None
                               else JRateOptions(*rate_args))
    ref_tail = [np.asarray(x)[..., :plan.count] for x in jpipe.run_grid_tail(
        jspec, ref_grid[0], ref_grid[1], ref_grid[2], gid, 4)]

    edges = _fixed(tds).window_edges("cpu")
    step = tpipe.DownsampleStep(fn, fill, 1.5)
    pspec = tpipe.PipelineSpec(agg, step, None if rate_args is None
                               else RateOptions(*rate_args))
    wts, v, m = tpipe.run_downsample_grid(step, t(ts), t(val), t(mask),
                                          edges)
    assert_exact(wts.numpy(), ref_grid[0])
    assert_exact(m.numpy(), ref_grid[2])
    assert_values(v.numpy(), ref_grid[1], where=ref_grid[2])
    tail = tpipe.run_grid_tail(pspec, wts, v, m, gid, 4)
    assert_exact(tail[2].numpy(), ref_tail[2])
    assert_values(tail[1].numpy(), ref_tail[1], where=ref_tail[2])
    whole = tpipe.run_group_pipeline(pspec, t(ts), t(val), t(mask), gid, 4,
                                     edges)
    for a, b in zip(whole, tail):
        assert_exact(a.numpy(), b.numpy())
