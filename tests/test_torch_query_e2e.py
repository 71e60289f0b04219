"""Queries end to end on both packages: grouped downsample queries and
queries without a downsample (the union path).

The same ingest and the same TSQuery go through the JAX package's TSDB
and opentsdb_tpu_torch's (``device="cpu"``); every result's to_json()
must agree, values at rtol 1e-9 (torch_parity.RTOL), everything else
exactly.  The reference is built with the mesh off: under conftest's 8
virtual CPU devices a query of >= 8 series would route to the mesh path.
Also: load_state carries a reference TSDB's state over with its UIDs.
"""

import math

import numpy as np
import pytest

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.models import parse_tsuid_subquery as ref_parse_tsuid
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB, load_state
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.models import parse_tsuid_subquery
from opentsdb_tpu_torch.utils.config import Config

from torch_parity import RTOL, ATOL

BASE = 1_356_998_400


def _ref_tsdb():
    return RefTSDB(RefConfig({"tsd.core.auto_create_metrics": True,
                              "tsd.query.mesh.enable": False}))


def _port_tsdb():
    return TSDB(Config({"tsd.core.auto_create_metrics": True}),
                device="cpu")


def _ingest(tsdb):
    """test_query_e2e's two hosts, plus a denser metric over six series in
    three groups with gaps, float values, a counter that resets and one
    series in milliseconds."""
    for i in range(10):
        tsdb.add_point("sys.cpu.user", BASE + i * 10, i, {"host": "web01"})
        tsdb.add_point("sys.cpu.user", BASE + i * 10, i * 10,
                       {"host": "web02"})
    rng = np.random.default_rng(4)
    dps = []
    for h in range(6):
        tags = {"host": "h%d" % h, "dc": "dc%d" % (h % 3)}
        steps = np.sort(rng.choice(720, 90, replace=False))
        counter = np.cumsum(rng.integers(0, 50, 90))
        counter[45:] -= counter[44] if h == 2 else 0     # a counter reset
        for k, step in enumerate(steps):
            if h == 4 and 30 <= k < 50:
                continue                                  # a gap
            ts = BASE + int(step) * 5
            dps.append({"metric": "net.bytes", "timestamp": ts,
                        "value": int(counter[k]), "tags": tags})
            dps.append({"metric": "cpu.load",
                        "timestamp": ts * 1000 + 250 if h == 5 else ts,
                        "value": float(rng.normal(2.0, 0.5)), "tags": tags})
    # one metric whose groups differ in type: dc0 all integers, dc1 all
    # floats, dc2 an integer series beside a float one
    for h, (dc, kind) in enumerate([("dc0", int), ("dc0", int),
                                    ("dc1", float), ("dc1", float),
                                    ("dc2", int), ("dc2", float)]):
        for k in range(40):
            ts = BASE + 7 * k + 3 * h
            dps.append({"metric": "mix.val", "timestamp": ts,
                        "value": kind(2**53 + 1000 * h + k * (h + 1))
                        if kind is int else 0.5 * k + h,
                        "tags": {"host": "m%d" % h, "dc": dc}})
    ok, errors = tsdb.add_points_bulk(dps)
    assert errors == [] and ok == len(dps)
    return tsdb


@pytest.fixture(scope="module")
def both():
    return _ingest(_ref_tsdb()), _ingest(_port_tsdb())


def _query(mod_query, parse, m, start, end, **kw):
    q = mod_query(start=start, end=end, queries=[parse(m)], **kw)
    q.validate()
    return q


def _same_json(port, ref, path="$"):
    """Equal JSON trees; floats at RTOL/ATOL, NaN equal to NaN."""
    if isinstance(ref, float) or isinstance(port, float):
        assert isinstance(port, (int, float)) and isinstance(ref, (int, float)), path
        if math.isnan(ref):
            assert math.isnan(port), path
        else:
            assert math.isclose(port, ref, rel_tol=RTOL, abs_tol=ATOL), \
                (path, port, ref)
    elif isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), path
        for k in ref:
            _same_json(port[k], ref[k], "%s.%s" % (path, k))
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same_json(a, b, "%s[%d]" % (path, i))
    else:
        assert port == ref, (path, port, ref)


CASES = [
    # m, start, end
    ("sum:30s-avg:sys.cpu.user{host=web01}", "1356998400", "1356998500"),
    ("sum:30s-sum:sys.cpu.user", "1356998400", "1356998500"),
    ("sum:60s-sum-nan:sys.cpu.user{host=web01}", "1356998400",
     "1356998520"),
    ("sum:30s-avg:sys.cpu.user{host=*}", "1356998400", "1356998500"),
    ("avg:30s-max:sys.cpu.user{host=regexp(web0[2-9])}", "1356998400",
     "1356998500"),
    ("sum:1m-avg:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("dev:5m-dev:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("count:1m-count-zero:cpu.load{dc=*}", "1356998400",
     "1356998400+3600"),
    ("min:2m-mimmin-null:cpu.load{host=*}", "1356998400",
     "1356998400+3600"),
    ("mimmax:7m-squareSum:cpu.load", "1356998500", "1356998400+3000"),
    ("zimsum:0all-sum:cpu.load{dc=dc1|dc2}", "1356998400",
     "1356998400+3600"),
    ("pfsum:10mc-avg:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("sum:1m-avg:rate:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("sum:2m-max:rate{counter}:net.bytes{host=*}", "1356998400",
     "1356998400+3600"),
    ("avg:1m-sum:rate{counter,1000,10}:net.bytes", "1356998400",
     "1356998400+3600"),
    ("max:1m-avg:rate{dropcounter}:net.bytes{dc=*}", "1356998400",
     "1356998400+3600"),
    ("sum:1m-avg-scalar:cpu.load{host=h1|h4}", "1356998400",
     "1356998400+3600"),
    ("sum:explicit_tags:1m-avg:cpu.load{host=h1,dc=dc1}", "1356998400",
     "1356998400+3600"),
    # order and rank functions and movingAverage<N>, in either position
    ("median:1m-avg:cpu.load", "1356998400", "1356999000"),
    ("sum:1m-p99:cpu.load", "1356998400", "1356999000"),
    ("sum:1m-first:cpu.load", "1356998400", "1356999000"),
    ("movingAverage:1m-avg:cpu.load", "1356998400", "1356999000"),
    ("p95:1m-avg:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("ep99r7:2m-max:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("ep50r3:1m-avg:rate:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("last:1m-first:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("diff:1m-last:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("first:1m-diff:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("mult:5m-avg:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("none:1m-avg:cpu.load", "1356998400", "1356998400+3600"),
    ("sum:5m-mult:sys.cpu.user{host=*}", "1356998400", "1356998500"),
    ("first:1m-median-zero:cpu.load{dc=*}", "1356998400",
     "1356998400+3600"),
    ("sum:1m-ep90r7-null:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("sum:1m-p999-scalar:cpu.load{host=h1|h4}", "1356998400",
     "1356998400+3600"),
    ("max:10mc-p50:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("sum:0all-p99:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("avg:0all-median:cpu.load", "1356998400", "1356998400+3600"),
    ("ep75r3:0all-ep75r7:cpu.load{host=*}", "1356998400",
     "1356998400+3600"),
    ("median:1m-avg:rate{counter}:net.bytes{dc=*}", "1356998400",
     "1356998400+3600"),
    ("movingAverage3:1m-sum:cpu.load{dc=*}", "1356998400",
     "1356998400+3600"),
    ("sum:1m-movingAverage:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("sum:2m-movingAverage4-zero:cpu.load{dc=*}", "1356998400",
     "1356998400+3600"),
    ("movingAverage2:1m-avg:rate:net.bytes{dc=*}", "1356998400",
     "1356998400+3600"),
]


def _times(start, end):
    """'1356998400+3600' -> '1356999999' (a plain seconds string)."""
    def one(x):
        return str(sum(int(p) for p in x.split("+")))
    return one(start), one(end)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_grouped_downsample_query_matches_reference(both, case):
    ref_tsdb, port_tsdb = both
    m, start, end = case
    start, end = _times(start, end)
    ref_q = _query(RefTSQuery, ref_parse, m, start, end)
    port_q = _query(TSQuery, parse_m_subquery, m, start, end)
    ref = ref_tsdb.new_query_runner().run(ref_q)
    port = port_tsdb.new_query_runner().run(port_q)
    fill = ref_q.queries[0].fill_policy
    kw = dict(ms_resolution=True, show_tsuids=True, fill_policy=fill)
    assert len(port) == len(ref) > 0
    _same_json([r.to_json(**kw) for r in port],
               [r.to_json(**kw) for r in ref])


def test_tsuid_subquery_matches_reference(both):
    ref_tsdb, port_tsdb = both
    key = next(s.key for s in ref_tsdb.store.all_series()
               if ref_tsdb.resolve_key_tags(s.key) == {"host": "web02"})
    m = "sum:30s-avg:" + ref_tsdb.tsuid(key)
    ref = ref_tsdb.new_query_runner().run(
        _query(RefTSQuery, ref_parse_tsuid, m, "1356998400", "1356998500"))
    port = port_tsdb.new_query_runner().run(
        _query(TSQuery, parse_tsuid_subquery, m, "1356998400",
               "1356998500"))
    _same_json([r.to_json() for r in port], [r.to_json() for r in ref])


UNION_CASES = [
    # m, start, end: no downsample, so the union path
    ("sum:sys.cpu.user", "1356998400", "1356998500"),
    ("sum:sys.cpu.user{host=*}", "1356998400", "1356998500"),
    ("avg:sys.cpu.user", "1356998400", "1356998500"),
    ("sum:sys.cpu.user{host=web01}", "1356998400", "1356998430"),
    ("avg:cpu.load", "1356998400", "1356998400+3600"),
    ("dev:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("zimsum:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("mimmin:cpu.load{host=*}", "1356998400", "1356998400+3600"),
    ("mimmax:cpu.load", "1356998500", "1356998400+3000"),
    ("count:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("squareSum:cpu.load{dc=dc1|dc2}", "1356998400", "1356998400+3600"),
    ("pfsum:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("min:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("max:net.bytes", "1356998400", "1356998400+3600"),
    ("avg:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("dev:net.bytes", "1356998400", "1356998400+3600"),
    ("sum:rate:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("sum:rate{counter}:net.bytes{host=*}", "1356998400", "1356998400+3600"),
    ("avg:rate{counter,1000,10}:net.bytes", "1356998400", "1356998400+3600"),
    ("max:rate{dropcounter}:net.bytes{dc=*}", "1356998400",
     "1356998400+3600"),
    ("sum:rate:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("sum:mix.val{dc=*}", "1356998400", "1356998400+3600"),
    ("avg:mix.val", "1356998400", "1356998400+3600"),
    ("sum:rate:mix.val{dc=*}", "1356998400", "1356998400+3600"),
    ("sum:explicit_tags:cpu.load{host=h1,dc=dc1}", "1356998400",
     "1356998400+3600"),
    # order and rank functions and movingAverage<N>, float and int mode
    ("median:sys.cpu.user", "1356998400", "1356999000"),
    ("p99:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("ep95r3:cpu.load", "1356998400", "1356998400+3600"),
    ("ep75r7:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("first:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("last:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("diff:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("mult:sys.cpu.user", "1356998400", "1356998500"),
    ("none:cpu.load", "1356998400", "1356998400+3600"),
    ("median:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("p90:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("first:mix.val{dc=*}", "1356998400", "1356998400+3600"),
    ("last:mix.val{dc=*}", "1356998400", "1356998400+3600"),
    ("diff:mix.val{dc=*}", "1356998400", "1356998400+3600"),
    ("median:mix.val{dc=*}", "1356998400", "1356998400+3600"),
    ("ep99r7:mix.val", "1356998400", "1356998400+3600"),
    ("mult:mix.val{dc=*}", "1356998400", "1356998400+3600"),
    ("diff:rate:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("p99:rate{counter}:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("movingAverage:cpu.load{dc=*}", "1356998400", "1356998400+3600"),
    ("movingAverage3:net.bytes{dc=*}", "1356998400", "1356998400+3600"),
    ("movingAverage2:mix.val{dc=*}", "1356998400", "1356998400+3600"),
    ("movingAverage:rate:net.bytes", "1356998400", "1356998400+3600"),
]


@pytest.mark.parametrize("case", UNION_CASES, ids=[c[0] for c in UNION_CASES])
def test_union_query_matches_reference(both, case):
    ref_tsdb, port_tsdb = both
    m, start, end = case
    start, end = _times(start, end)
    ref = ref_tsdb.new_query_runner().run(
        _query(RefTSQuery, ref_parse, m, start, end))
    port = port_tsdb.new_query_runner().run(
        _query(TSQuery, parse_m_subquery, m, start, end))
    kw = dict(ms_resolution=True, show_tsuids=True)
    assert len(port) == len(ref) > 0
    port_js = [r.to_json(**kw) for r in port]
    ref_js = [r.to_json(**kw) for r in ref]
    _same_json(port_js, ref_js)
    # integer answers stay Java longs, exactly; float answers stay floats
    for a, b in zip(port_js, ref_js):
        assert [type(v) for v in a["dps"].values()] \
            == [type(v) for v in b["dps"].values()]


def test_union_query_mixes_int_and_float_groups(both):
    """One query, groups of both types: dc0 answers in longs above 2^53,
    dc1 and dc2 (an integer series beside a float one) in floats."""
    _, port_tsdb = both
    start, end = _times("1356998400", "1356998400+3600")
    res = port_tsdb.new_query_runner().run(
        _query(TSQuery, parse_m_subquery, "sum:mix.val{dc=*}", start, end))
    kinds = {r.tags["dc"]: {type(v) for _, v in r.dps} for r in res}
    assert kinds == {"dc0": {int}, "dc1": {float}, "dc2": {float}}
    assert max(v for r in res if r.tags["dc"] == "dc0"
               for _, v in r.dps) > 2**54


@pytest.mark.parametrize("m", [
    "sum:percentiles[99]:cpu.load",           # histograms
    "sum:1m-avg:percentiles[50,99]:cpu.load",
])
def test_unported_queries_raise(both, m):
    """Histogram sub queries on a TSDB without a histogram codec config
    raise the reference's "not configured" error in both packages."""
    ref_tsdb, port_tsdb = both
    for tsdb, tsq, parse in ((ref_tsdb, RefTSQuery, ref_parse),
                             (port_tsdb, TSQuery, parse_m_subquery)):
        q = _query(tsq, parse, m, "1356998400", "1356999000")
        with pytest.raises(ValueError, match="histograms are not configured"):
            tsdb.new_query_runner().run(q)


def test_load_state_round_trip():
    """A reference TSDB's UID dictionaries and series columns, loaded into
    the port: the same TSUIDs, and the same answers."""
    ref_tsdb = _ingest(_ref_tsdb())
    uid_maps = {kind: ref_tsdb.uid_table(kind).snapshot()
                for kind in ("metric", "tagk", "tagv")}
    series = [(s.key.metric, dict(s.key.tags), *s.arrays())
              for s in ref_tsdb.store.all_series()]
    port_tsdb = load_state(uid_maps, series, device="cpu")
    assert sorted(port_tsdb.tsuid(s.key)
                  for s in port_tsdb.store.all_series()) \
        == sorted(ref_tsdb.tsuid(s.key) for s in ref_tsdb.store.all_series())
    assert port_tsdb.store.total_datapoints \
        == ref_tsdb.store.total_datapoints
    m = "sum:1m-avg:rate:net.bytes{dc=*}"
    start, end = _times("1356998400", "1356998400+3600")
    ref = ref_tsdb.new_query_runner().run(
        _query(RefTSQuery, ref_parse, m, start, end))
    port = port_tsdb.new_query_runner().run(
        _query(TSQuery, parse_m_subquery, m, start, end))
    kw = dict(ms_resolution=True, show_tsuids=True)
    _same_json([r.to_json(**kw) for r in port],
               [r.to_json(**kw) for r in ref])


def test_load_state_rejects_unknown_uid():
    with pytest.raises(LookupError):
        load_state({"metric": {"m": 1}, "tagk": {"host": 1},
                    "tagv": {"a": 1}},
                   [(1, {1: 2}, np.array([1]), np.array([1.0]),
                     np.array([0]), np.array([False]))], device="cpu")
